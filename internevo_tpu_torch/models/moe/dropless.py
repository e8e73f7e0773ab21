"""Dropless MoE: sort by expert, grouped matmul, combine (port of the
single-device parts of ``internevo_tpu/models/moe/dropless.py``).

Every token goes to its top-k experts; no token is dropped and no capacity
is padded.  The k copies of each token are sorted by expert (a stable sort),
each expert's rows meet its weights in one grouped matmul
(``ops/cuda/gmm.py``: the CUDA kernels on the card, the plain versions on the
CPU), and the inverse permutation gathers the scaled expert outputs back.
Dispatch and combine are autograd Functions whose backward passes are
gathers too, with the JAX ``custom_vjp``'s rounding points: no scatter-add
with duplicated indices anywhere.

Routing reads no value on the host: the sort, the inverse permutation and
the group sizes stay on the device, so a layer never waits for the card.
The expert-parallel layouts (``dropless_moe_apply_ep``, ``_gspmd_ep``) come
with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...ops.cuda.gmm import grouped_matmul


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """inv[order[s]] = s."""
    return torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=order.device,
                                                                     dtype=order.dtype))


class _ExpandSorted(torch.autograd.Function):
    """Dispatch: ``tokens[src]``, each token copied to its k sorted slots.
    The backward gathers by ``inv`` and sums the k copies in fp32
    (``dropless.py:60-70``)."""

    @staticmethod
    def forward(ctx, tokens, src, inv, k: int):
        ctx.save_for_backward(inv)
        ctx.k = k
        return tokens.index_select(0, src)

    @staticmethod
    def backward(ctx, dg):
        (inv,) = ctx.saved_tensors
        n = inv.numel() // ctx.k
        dt = dg.index_select(0, inv).reshape(n, ctx.k, dg.shape[-1])
        return dt.float().sum(1).to(dg.dtype), None, None, None


class _CombineSorted(torch.autograd.Function):
    """Combine: each token's k expert rows, scaled, summed in fp32
    (``dropless.py:76-102``).  The backward gathers by ``src``; it casts the
    gathered cotangent to the experts' dtype before both products, as the JAX
    ``_combine_bwd`` does, so ``dscale`` sees the bf16-rounded cotangent."""

    @staticmethod
    def forward(ctx, eo, scale_s, src, inv, k: int):
        ctx.save_for_backward(eo, scale_s, src)
        n = inv.numel() // k
        x = (eo * scale_s[:, None]).index_select(0, inv).reshape(n, k, eo.shape[-1])
        return x.float().sum(1).to(eo.dtype)

    @staticmethod
    def backward(ctx, dout):
        eo, scale_s, src = ctx.saved_tensors
        d_sorted = dout.index_select(0, src).to(eo.dtype)
        deo = d_sorted * scale_s[:, None].to(eo.dtype)
        dscale = (d_sorted.float() * eo.float()).sum(-1).to(scale_s.dtype)
        return deo, dscale, None, None, None


def _grouped_dot(x, w, group_sizes, grouped_dot: Optional[Callable] = None):
    """The grouped-matmul seam (``dropless.py:105-124``).  Every tensor goes
    to ``grouped_matmul``, whose dispatch is by device: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors.  There is no switch and
    no shape guard that falls back; ``grouped_dot`` replaces the function for
    a check that holds the kernels against the plain path."""
    return (grouped_dot or grouped_matmul)(x, w.to(x.dtype), group_sizes)


def top_k_routes(probs: torch.Tensor, top_k: int):
    """(top_probs, top_idx) of ``jax.lax.top_k``: the k largest per row, ties
    to the lower expert index.  ``torch.topk`` breaks ties the other way on
    the CPU, so this is a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :top_k], idx[:, :top_k]


def route(gate, tokens, top_k: int):
    """fp32 router: (probs (n, E), top_probs (n, k) renormalised, top_idx (n, k))."""
    probs = torch.softmax(tokens.float() @ gate.float(), dim=-1)
    top_probs, top_idx = top_k_routes(probs, top_k)
    return probs, top_probs / top_probs.sum(-1, keepdim=True), top_idx


def dropless_moe_apply(layer: dict, x, *, top_k: int = 2, grouped_dot: Optional[Callable] = None):
    """layer: {"gate": (H, E), "experts": {"w1", "w3": (E, H, M), "w2": (E, M, H)}}.

    Returns (out (B, S, H), l_aux, exp_counts).  l_aux is the GShard
    load-balancing loss on the top-1 assignment, Σ(me·ce)·E, with its grad
    through the mean gate probabilities ``me`` only.  Dropless routing draws
    no noise, so the JAX signature's ``train`` flag has no counterpart."""
    B, S, H = x.shape
    E = layer["gate"].shape[1]
    tokens = x.reshape(B * S, H)

    probs, top_probs, top_idx = route(layer["gate"], tokens, top_k)
    me = probs.mean(0)
    ce = F.one_hot(top_idx[:, 0], E).float().mean(0)
    l_aux = (me * ce).sum() * E

    flat_expert = top_idx.reshape(-1)
    flat_weight = top_probs.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    inv = _inverse_permutation(order)
    inv_token = order // top_k
    gathered = _ExpandSorted.apply(tokens, inv_token, inv, top_k)
    # bincount would read the largest id on the host (a sync on CUDA)
    group_sizes = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))

    w1, w2, w3 = layer["experts"]["w1"], layer["experts"]["w2"], layer["experts"]["w3"]
    h1 = _grouped_dot(gathered, w1, group_sizes, grouped_dot)
    h3 = _grouped_dot(gathered, w3, group_sizes, grouped_dot)
    hidden = F.silu(h1) * h3
    expert_out = _grouped_dot(hidden, w2, group_sizes, grouped_dot)

    scale = flat_weight.index_select(0, order).to(expert_out.dtype)
    out = _CombineSorted.apply(expert_out, scale, inv_token, inv, top_k)
    return out.reshape(B, S, H), l_aux, group_sizes
