"""GShard top-1/top-2 capacity gating and the MoE layer on one device (port
of ``internevo_tpu/models/moe/gshard.py``; reference
``internlm/model/moe/gshard_layer.py``: ``top1gating`` :138, ``top2gating``
:224, the ``GShardMOELayer`` dispatch and combine :445-498).

Each expert takes at most ``capacity`` tokens of a gating call; a token past
its expert's capacity is dropped (its combine weight is 0).  The dispatch,
the SwiGLU experts and the combine are the JAX function's dense products:
(s, E, C) x (s, H) -> (E, C, H), a batched matmul per expert, then (s, E, C)
x (E, C, H) -> (s, H).  They are plain matmuls outside any TPU kernel, so
cuBLAS runs them here.

Noise is JAX's, bit for bit in its bits (``core/random.py``): the top-2
gumbel on the second choice and RSample's on the first, the RTS priorities
and the Jitter of the gate input, each from the layer's key split as the
JAX function splits it.  ``_gumbel`` and ``_uniform`` are module-level seams
as in the JAX module, so a test can inject the same noise into both.

Everything stays on the device of the logits: routing reads no value on the
host.  The expert-parallel layouts (``manual_ep_axis``, the EP sharding
constraint) come with the multi-GPU slice; one device has none.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ...accelerator import get_device
from ...core import random as jrandom

NOISY_GATE_POLICIES = (None, "RSample", "Jitter")
JITTER_EPS = 1e-2  # reference gshard_layer.py:340-342 multiplicative_jitter


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int) -> int:
    """ceil((tokens / experts) * factor), at least ``min_capacity`` (the
    ceil after the multiply, reference gshard_layer.py:121-130)."""
    return int(max(math.ceil((num_tokens / num_experts) * capacity_factor), min_capacity))


def _gumbel(key: jrandom.Key, shape, device="cuda") -> torch.Tensor:
    """-log(-log(u + 1e-10) + 1e-10) for u of JAX's float32 uniform on
    [1e-10, 1 - 1e-10), whose maxval is 1.0 in float32."""
    u = jrandom.uniform(key, shape, 1e-10, 1.0 - 1e-10, device=get_device(device))
    return -torch.log(-torch.log(u + 1e-10) + 1e-10)


def _uniform(key: jrandom.Key, shape, lo: float = 0.0, hi: float = 1.0, device="cuda") -> torch.Tensor:
    """The uniform draw of the RTS priorities and the gate-input jitter."""
    return jrandom.uniform(key, shape, lo, hi, device=get_device(device))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot rows of ``idx`` (every index below ``n``)."""
    return torch.zeros(idx.shape[0], n, dtype=torch.float32, device=idx.device).scatter_(1, idx.long()[:, None], 1.0)


def _first_max(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` along dim 1: the first of equal maxima (documented
    for ``torch.argmax`` on both devices)."""
    return torch.argmax(x, dim=1)


def top1gating(logits: torch.Tensor, capacity_factor: float, min_capacity: int, rng: Optional[jrandom.Key] = None,
               noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True, use_rts: bool = True):
    """logits (s, E) fp32 -> (l_aux, combine_weights (s, E, C), dispatch_mask
    (s, E, C) bool, exp_counts (E,)), the JAX ``top1gating`` (:52-97).

    The capacity keeps, for each expert, its ``capacity`` tokens of highest
    priority: a uniform draw with RTS, else all ties, which ``jax.lax.top_k``
    breaks to the lower token index; a stable descending sort does the same.
    Slots then go in token order."""
    S, E = logits.shape
    dev = logits.device
    gates = torch.softmax(logits, dim=1)
    capacity = _capacity(S, E, capacity_factor, min_capacity) if drop_tokens else S

    if noisy_gate_policy == "RSample" and rng is not None:
        noise_rng, rng = jrandom.split(rng)
        indices1_s = _first_max(logits + _gumbel(noise_rng, logits.shape, dev))
    else:
        indices1_s = _first_max(gates)
    mask1 = _one_hot(indices1_s, E)
    exp_counts = mask1.sum(0)

    l_aux = (gates.mean(0) * mask1.mean(0)).sum() * E

    if use_rts and rng is not None:  # random token selection (ref :180-199)
        rts_rng, rng = jrandom.split(rng)
        mask1_rand = mask1 * _uniform(rts_rng, mask1.shape, device=dev)
    else:
        mask1_rand = mask1
    ncap = min(capacity, S)
    top_idx = torch.sort(mask1_rand.t(), dim=1, descending=True, stable=True).indices[:, :ncap]  # (E, ncap)
    keep = torch.zeros(S, E, dtype=torch.float32, device=dev).scatter_(0, top_idx.t(), 1.0)
    mask1 = mask1 * keep

    locations1 = torch.cumsum(mask1, dim=0) - 1
    locations1_s = (locations1 * mask1).sum(1).to(torch.int32)
    gates = gates * mask1
    combine_weights = gates[:, :, None] * _one_hot(locations1_s, capacity)[:, None, :]
    return l_aux, combine_weights, combine_weights > 0, exp_counts


def top2gating(logits: torch.Tensor, capacity_factor: float, min_capacity: int, rng: Optional[jrandom.Key] = None):
    """Top-2 gating, the JAX ``top2gating`` (:100-140): the first choice the
    largest gate, the second the largest of the other logits plus gumbel
    noise when ``rng`` is given; capacity ``_capacity(s, E, 2 *
    capacity_factor)``, expert e's second choices taking slots after all of
    its first choices; the two kept gates renormalised."""
    S, E = logits.shape
    gates = torch.softmax(logits, dim=1)
    capacity = _capacity(S, E, capacity_factor * 2, min_capacity)

    mask1 = _one_hot(_first_max(gates), E)
    logits_w_noise = logits + _gumbel(rng, logits.shape, logits.device) if rng is not None else logits
    logits_except1 = torch.where(mask1 > 0, torch.finfo(torch.float32).min, logits_w_noise)
    mask2 = _one_hot(_first_max(logits_except1), E)

    locations1 = torch.cumsum(mask1, dim=0) - 1
    locations2 = torch.cumsum(mask2, dim=0) - 1 + mask1.sum(0, keepdim=True)
    exp_counts = mask1.sum(0)

    l_aux = (gates.mean(0) * mask1.mean(0)).mean() * E * E

    mask1 = mask1 * (locations1 < capacity)
    mask2 = mask2 * (locations2 < capacity)
    locations1_s = (locations1 * mask1).sum(1).to(torch.int32)
    locations2_s = (locations2 * mask2).sum(1).to(torch.int32)

    gates1_s = (gates * mask1).sum(1)
    gates2_s = (gates * mask2).sum(1)
    denom = torch.clamp(gates1_s + gates2_s, min=torch.finfo(torch.float32).eps)
    gates1 = (gates1_s / denom)[:, None] * mask1
    gates2 = (gates2_s / denom)[:, None] * mask2
    combine = (gates1[:, :, None] * _one_hot(locations1_s, capacity)[:, None, :]
               + gates2[:, :, None] * _one_hot(locations2_s, capacity)[:, None, :])
    return l_aux, combine, combine > 0, exp_counts


def moe_layer_apply(layer: dict, x: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.0,
                    min_capacity: int = 4, drop_tokens: bool = True, use_rts: bool = True,
                    noisy_gate_policy: Optional[str] = None, rng: Optional[jrandom.Key] = None, train: bool = True):
    """GShard MoE FFN over (B, S, H) activations, one gating call over the
    B·S tokens (the JAX ``moe_layer_apply``, :143-227, on one device).

    layer: {"gate": (H, E), "experts": {"w1", "w3": (E, H, M), "w2": (E, M,
    H)}}.  Returns (out (B, S, H), l_aux, exp_counts).  The noise (``rng``)
    and RTS act only with ``train``; the gate runs in fp32."""
    if noisy_gate_policy not in NOISY_GATE_POLICIES:  # reference gshard_layer.py:403
        raise ValueError(f"unsupported noisy_gate_policy {noisy_gate_policy!r}; expected None, 'RSample' or 'Jitter'")
    B, S, H = x.shape
    tokens = x.reshape(B * S, H)
    gate_w = layer["gate"].float()
    gate_in = tokens.float()
    if noisy_gate_policy == "Jitter" and train and rng is not None:
        jit_rng, rng = jrandom.split(rng)
        gate_in = gate_in * _uniform(jit_rng, gate_in.shape, 1.0 - JITTER_EPS, 1.0 + JITTER_EPS, x.device)
    logits = gate_in @ gate_w
    if top_k == 1:
        l_aux, combine, dispatch, exp_counts = top1gating(
            logits, capacity_factor, min_capacity, rng=rng if train else None,
            noisy_gate_policy=noisy_gate_policy if train else None, drop_tokens=drop_tokens,
            use_rts=use_rts and train)
    else:
        l_aux, combine, dispatch, exp_counts = top2gating(logits, capacity_factor, min_capacity,
                                                          rng=rng if train else None)
    n, E, C = combine.shape
    # "sec,sh->ech", the SwiGLU experts, then "sec,ech->sh", each one matmul
    dispatched = (dispatch.reshape(n, E * C).to(x.dtype).t() @ tokens).reshape(E, C, H)
    w1, w2, w3 = layer["experts"]["w1"], layer["experts"]["w2"], layer["experts"]["w3"]
    hidden = F.silu(torch.bmm(dispatched, w1.to(x.dtype))) * torch.bmm(dispatched, w3.to(x.dtype))
    expert_out = torch.bmm(hidden, w2.to(x.dtype))
    combined = combine.reshape(n, E * C).to(x.dtype) @ expert_out.reshape(E * C, H)
    return combined.reshape(B, S, H), l_aux, exp_counts
