"""Activation recompute with named saves: the port of the JAX model's
``jax.checkpoint`` policies (``internevo_tpu/models/base.py:497-588``).

A recomputed layer runs its forward without keeping activations; its
backward runs the forward again and differentiates that.  A policy names the
results that are kept from the first forward and handed back to the
recompute in place of a second run, as ``save_only_these_names`` keeps named
values:

- ``FLASH``: the splash forward's (out, lse), kept under every policy, so the
  backward never launches the forward kernel again (the JAX ``flash_out`` and
  ``flash_lse``);
- ``GATES``: the SwiGLU gates ``mlp_w1o`` and ``mlp_w3o`` (``remat_save_mlp``);
- ``QKV``: the post-rotary q, k and v (``remat_save_qkv``): the recompute
  skips the wqkv projection and the rotary.

A named result is produced by ``saved(name, compute)`` inside a function whose
autograd backward needs only its inputs, so the recompute builds the same
graph whether the value was kept or computed.  ``offload`` names the kept
results that wait in pinned host memory (``activation_offload``): on a CUDA
tensor the copy goes out after the first forward and comes back for the
recompute, both on the current stream; a CPU tensor stays where it is.

The port does this with its own ``autograd.Function`` rather than
``torch.utils.checkpoint``'s selective policies: these need a dispatcher op
to name, and keep what they save on the device, where ``activation_offload``
keeps it on the host.  Dropout masks and attention seeds are stateless
functions of the layer's key, so the recompute draws them again exactly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

FLASH = "flash"
GATES = frozenset({"mlp_w1o", "mlp_w3o"})
QKV = "attn_qkv"
# the profiler range around each recompute (``tools/profile_step.py`` sums
# the device time of the kernels inside it)
PROFILE_LABEL = "remat_recompute"


class Policy(NamedTuple):
    """What a recomputed layer keeps (``saves``) and which of those wait in
    host memory (``offload``)."""

    saves: frozenset
    offload: frozenset = frozenset()


class _Frame:
    """The kept results of one recomputed layer, in the order they were made."""

    def __init__(self, policy: Policy):
        self.policy = policy
        self.records: list = []
        self.replaying = False

    def keep(self, name: str, out):
        offload = name in self.policy.offload
        self.records.append((_map(out, _to_host) if offload else out, offload))

    def take(self, device):
        out, offloaded = self.records.pop(0)
        return _map(out, lambda t: t.to(device, non_blocking=True)) if offloaded else out


_frame: Optional[_Frame] = None


def _map(out, fn):
    return tuple(fn(t) for t in out) if isinstance(out, tuple) else fn(out)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def saved(name: str, compute: Callable, device=None):
    """``compute()``, or under a recomputed layer whose policy names ``name``:
    in the first forward its result, kept; in the recompute the kept result,
    without running ``compute``, brought back to ``device`` from the host
    when the policy offloads it."""
    f = _frame
    if f is None or name not in f.policy.saves:
        return compute()
    if f.replaying:
        return f.take(device)
    out = compute()
    f.keep(name, out)
    return out


def _run(frame: _Frame, run: Callable, x):
    global _frame
    prev, _frame = _frame, frame
    try:
        return run(x)
    finally:
        _frame = prev


class _Recompute(torch.autograd.Function):
    """out = run(x) with the layer's leaves as inputs; the backward runs
    ``run`` again under the same frame and differentiates it."""

    @staticmethod
    def forward(ctx, run, frame, x, *leaves):
        ctx.run, ctx.frame, ctx.leaves = run, frame, leaves
        ctx.save_for_backward(x)
        return _run(frame, run, x)

    @staticmethod
    def backward(ctx, *grads):
        (x,) = ctx.saved_tensors
        x = x.detach().requires_grad_(ctx.needs_input_grad[2])
        frame = ctx.frame
        frame.replaying = True
        with torch.enable_grad(), torch.profiler.record_function(PROFILE_LABEL):
            out = _run(frame, ctx.run, x)
        if frame.records:
            raise RuntimeError(f"the recompute left {len(frame.records)} kept results unread")
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        inputs = [t for t in (x, *ctx.leaves) if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if t.requires_grad else None for t in (x, *ctx.leaves))


def checkpoint(run: Callable, x: torch.Tensor, leaves: list, policy: Optional[Policy]):
    """``run(x)``, recomputed in the backward under ``policy`` (None: run as
    it is, keeping every activation).  ``leaves`` are the tensors ``run``
    closes over whose grads the backward returns (a layer's params).  Without
    grad mode there is no backward, and ``run`` runs as it is."""
    if policy is None or not torch.is_grad_enabled():
        return run(x)
    return _Recompute.apply(run, _Frame(policy), x, *leaves)
