"""AdamW on fp32 masters with the reference's clip, skip and loss scaler
(port of ``internevo_tpu/solver/optimizer.py``, one device).

Semantics are the JAX ``optimizer_step``'s (reference
``hybrid_zero_optim.py:695-807`` and ``DynamicGradScaler``,
``optimizer/utils.py:431``): global and per-group gradient norms on unscaled
grads with the unscale folded in before squaring, global-norm clipping,
skip-on-non-finite with the scale backoff and hysteresis, and the -1 / -2
norm sentinels.  Every decision stays on the device, as in the JAX step: no
host sync.

One difference of form: the JAX step returns new trees, and this one writes
the new bf16 params, masters, m and v IN PLACE (under ``torch.no_grad()``),
so a step allocates no second copy of the 16 bytes per parameter of state.
Parameter trees are nested dicts and lists of tensors.

A second difference: every leaf's update goes through the fused AdamW
wrapper (``ops/cuda/fused_adamw.py``), so on the card it is always the Triton
kernel.  The JAX package keeps its Pallas kernel behind ``IEVO_FUSED_ADAM``
because on the TPU it was slower than XLA's update; on an H100 the kernel is
several times faster than the plain torch update, which makes a dozen passes
over each fp32 leaf, and shortens the training step (``PERF.md``), so the
port has no opt-in.
On CPU tensors the wrapper runs the plain update, the JAX step's expression.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Iterator, Optional

import torch

from ..ops.cuda import fused_adamw


@dataclasses.dataclass
class AdamWConfig:
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_grad_norm: float = 1.0


@dataclasses.dataclass
class GradScalerConfig:
    """Reference ``DynamicGradScaler`` (``solver/optimizer/utils.py:431``)."""

    initial_scale: float = 1.0  # 2**16 for fp16; 1 for bf16/fp32
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 1000
    hysteresis: int = 2
    min_scale: Optional[float] = 1.0
    max_scale: Optional[float] = 2.0**24


# ------------------------------------------------------------------- trees


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists, zipping ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in JAX's order (dict keys sorted, so two trees
    with the same keys list their leaves alike); paths are spelled as
    ``jax.tree_util.keystr`` spells them (``['blocks'][0]['wqkv']['weight']``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_leaves_with_path(t, f"{path}[{i}]")
    else:
        yield path, tree


def tree_leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


# ------------------------------------------------------------------ groups


_FP32_KEYS = frozenset({"norm", "norm1", "norm2", "norm1_bias", "norm2_bias"})
_EMBED_HEAD_KEYS = frozenset({"embedding", "head"})
# residual-MoE mixing coefficient is a DENSE-branch param (ref moe/moe.py:66-99)
_MOE_DENSE_LEAVES = frozenset({"coefficient", "coefficient_bias"})


def param_group_of(path: str) -> str:
    """Reference optimizer param groups (``train/utils.py:11-84``):
    ``embed_head`` (embedding + output head), ``fp32`` (norm weights, by name
    even where they are bf16, as in the JAX package), ``moe`` (expert
    params), ``default`` (everything else).  Classification is by EXACT key
    segments of a keystr or "/"-joined path."""
    segs = re.findall(r"\['([^']+)'\]", path) or path.strip("/.").split("/")
    if "moe" in segs:
        return "default" if segs[-1] in _MOE_DENSE_LEAVES else "moe"
    if any(s in _EMBED_HEAD_KEYS for s in segs):
        return "embed_head"
    if any(s in _FP32_KEYS for s in segs):
        return "fp32"
    return "default"


def _group_sq_sums(tree, pre_scale) -> dict[str, list[torch.Tensor]]:
    """Per group, each leaf's fp32 sum((g * pre_scale)^2): the unscale is
    applied per element BEFORE squaring, so loss-scaled grads cannot overflow
    fp32 inside the square and fake an inf skip."""
    sums: dict[str, list[torch.Tensor]] = {}
    for path, leaf in tree_leaves_with_path(tree):
        sums.setdefault(param_group_of(path), []).append(
            torch.sum(torch.square(leaf.float() * pre_scale)))
    return sums


def _norms(tree, pre_scale) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(global norm, per-group norms) from one pass over the leaves."""
    sums = _group_sq_sums(tree, pre_scale)
    total = torch.sqrt(torch.sum(torch.stack([s for v in sums.values() for s in v])))
    return total, {g: torch.sqrt(torch.sum(torch.stack(v))) for g, v in sums.items()}


def param_group_norms(tree, pre_scale=1.0) -> dict[str, torch.Tensor]:
    """Per-group L2 grad norms (reference ``hybrid_zero_optim.py:598-645``)."""
    return _norms(tree, pre_scale)[1]


def global_norm(tree, pre_scale=1.0) -> torch.Tensor:
    """L2 norm over the whole grad tree, fp32, ``pre_scale`` folded in."""
    return _norms(tree, pre_scale)[0]


# -------------------------------------------------------------------- step


def init_optimizer_state(params, scaler_cfg: GradScalerConfig | None = None) -> dict:
    """fp32 master copy, adam moments, step and grad-scaler state, on the
    params' device."""
    scaler_cfg = scaler_cfg or GradScalerConfig()
    device = tree_leaves(params)[0].device
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)

    def scalar(x, dtype=torch.int32):
        return torch.tensor(x, dtype=dtype, device=device)

    return {
        "step": scalar(0),
        "master": master,
        "m": tree_map(torch.zeros_like, master),
        "v": tree_map(torch.zeros_like, master),
        "grad_scale": scalar(scaler_cfg.initial_scale, torch.float32),
        "growth_tracker": scalar(0),
        "hysteresis_tracker": scalar(0),  # overflow steps so far (ref _hysteresis_step)
        "num_skipped": scalar(0),
    }


@torch.no_grad()
def optimizer_step(params, grads, state: dict, lr, beta2=None,
                   adam_cfg: AdamWConfig = AdamWConfig(),
                   scaler_cfg: GradScalerConfig = GradScalerConfig()):
    """One AdamW step on the fp32 masters; returns (params, state, stats),
    with params and the state's master/m/v trees updated IN PLACE.

    ``grads`` (the params' layout; the train step's fp32 accumulators) are
    the raw, possibly loss-scaled gradients.  Non-finite grads skip the
    update, count in num_skipped and back off the scale; the norm is taken on
    unscaled grads and clipped to ``clip_grad_norm`` (0 disables clipping).
    Each leaf is updated by ``fused_adamw_update_``: the Triton kernel for
    CUDA leaves, the plain update for CPU leaves."""
    beta1, beta2_default = adam_cfg.betas
    beta2 = beta2_default if beta2 is None else beta2
    scale = state["grad_scale"]

    inv_scale = 1.0 / scale
    norm, group_norms = _norms(grads, inv_scale)
    found_inf = ~torch.isfinite(norm)

    if adam_cfg.clip_grad_norm > 0:
        clip_coef = torch.clamp(adam_cfg.clip_grad_norm / (norm + 1e-6), max=1.0)
    else:  # reference convention: clip_grad_norm == 0 disables clipping
        clip_coef = torch.ones_like(norm)
    clip_coef = torch.where(found_inf, 0.0, clip_coef)
    gscale = clip_coef * inv_scale  # folded unscale + clip multiplier

    step = state["step"] + torch.where(found_inf, 0, 1).to(torch.int32)
    t = step.to(torch.float32)
    bias1 = 1.0 - torch.pow(torch.tensor(beta1, dtype=torch.float32, device=t.device), t)
    bias2 = 1.0 - torch.pow(torch.tensor(beta2, dtype=torch.float32, device=t.device), t)
    scalars = fused_adamw.adamw_scalars(lr, beta1, beta2, bias1, bias2, adam_cfg.eps,
                                        adam_cfg.weight_decay, gscale, found_inf, norm.device)

    for p, g, m, v, w in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                             tree_leaves(state["v"]), tree_leaves(state["master"])):
        fused_adamw.fused_adamw_update_(g, m, v, w, p, scalars)

    # dynamic grad scaler (ref utils.py:484-522): the hysteresis count goes UP
    # on overflow; once it reaches ``hysteresis`` every further overflow backs
    # off (no reset after a backoff); a growth event resets it to 0
    growth = state["growth_tracker"] + 1
    hyst = torch.where(found_inf, state["hysteresis_tracker"] + 1, state["hysteresis_tracker"])
    do_backoff = found_inf & (hyst >= scaler_cfg.hysteresis)
    do_growth = ~found_inf & (growth >= scaler_cfg.growth_interval)
    new_scale = torch.where(do_backoff,
                            torch.clamp(scale * scaler_cfg.backoff_factor, min=scaler_cfg.min_scale or 1.0),
                            scale)
    grown = new_scale * scaler_cfg.growth_factor
    if scaler_cfg.max_scale:
        grown = torch.clamp(grown, max=scaler_cfg.max_scale)
    new_scale = torch.where(do_growth, grown, new_scale)
    num_skipped = state["num_skipped"] + found_inf.to(torch.int32)
    state.update({
        "step": step,
        "grad_scale": new_scale,
        "growth_tracker": torch.where(found_inf | do_growth, 0, growth).to(torch.int32),
        "hysteresis_tracker": torch.where(do_growth, 0, hyst).to(torch.int32),
        "num_skipped": num_skipped,
    })
    # reference sentinel contract (utils.py:372-376): -1 = inf, -2 = nan
    norm_rep = torch.where(torch.isnan(norm), -2.0, torch.where(torch.isinf(norm), -1.0, norm))
    stats = {
        "grad_norm": norm_rep,
        "grad_norm_groups": group_norms,
        "found_inf": found_inf,
        "loss_scale": scale,
        "num_skipped": num_skipped,
    }
    return params, state, stats
