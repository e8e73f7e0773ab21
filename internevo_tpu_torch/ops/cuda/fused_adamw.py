"""Fused AdamW update: the Triton kernel's wrapper and its plain version.

Replaces ``internevo_tpu/ops/pallas/fused_adamw.py::_kernel``: one streaming
pass over one parameter leaf that reads the gradient (fp32 accumulator, or
bf16) and the fp32 m, v and master, and writes m, v and master in place and
the working parameter in its own dtype (bf16 weights, the fp32 final norm).
The update, with the 9 scalars of the JAX kernel held in one fp32 device
tensor ``[lr, beta1, beta2, 1/bias1, 1/bias2, eps, weight_decay, gscale,
skip]``::

    g   = grad * gscale                   (gscale = clip_coef / loss_scale)
    m'  = beta1*m + (1-beta1)*g
    v'  = beta2*v + (1-beta2)*g^2
    w'  = w - lr*((m'/bias1) / (sqrt(v'/bias2) + eps) + weight_decay*w)
    skip > 0 (non-finite global grad norm): m, v, w keep their values and the
    param is re-cast from w.

What bounds it on this card: device-memory bytes, ~30 per element with an
fp32 gradient (4 read of g, 8 each for m, v and w, 2 written for a bf16 param),
and a few flops per element; so the kernel is a masked 1-D load/compute/store
over ``BLOCK`` elements per program, with every intermediate in registers.
Triton is enough for that: there is no matrix product and no shared-memory
reuse to arrange.

Dispatch is on the tensors' device: a CPU leaf runs ``plain_adamw_update_``,
a CUDA leaf launches the kernel or raises.  ``solver/optimizer.py::
optimizer_step`` calls ``fused_adamw_update_`` for every leaf.
"""

from __future__ import annotations

import torch

BLOCK = 1024      # elements per program
NUM_WARPS = 4
N_SCALARS = 9
PARAM_DTYPES = (torch.bfloat16, torch.float16, torch.float32)

launches = 0      # kernel launches; the plain version never counts
_compiled = None  # the @triton.jit function, made on first launch


def adamw_scalars(lr, beta1, beta2, bias1, bias2, eps, weight_decay, gscale, skip, device):
    """The (9,) fp32 scalar vector of one step, on ``device``; tensor
    arguments stay on the device (no host sync)."""
    vals = [lr, beta1, beta2, 1.0 / bias1, 1.0 / bias2, eps, weight_decay, gscale, skip]
    return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=device).reshape(()) for x in vals])


def plain_adamw_update_(g, m, v, w, p, scalars) -> None:
    """In place: m, v, w (fp32) and p (the working param) after one AdamW
    step, in plain torch (the expression the kernel computes)."""
    lr, b1, b2, inv_bias1, inv_bias2, eps, wd, gs, skip = scalars.unbind()
    gf = g.float() * gs
    m1 = b1 * m + (1.0 - b1) * gf
    v1 = b2 * v + (1.0 - b2) * (gf * gf)
    del gf
    w1 = w - lr * ((m1 * inv_bias1) / (torch.sqrt(v1 * inv_bias2) + eps) + wd * w)
    keep = skip > 0.0
    m.copy_(torch.where(keep, m, m1))
    v.copy_(torch.where(keep, v, v1))
    w.copy_(torch.where(keep, w, w1))
    p.copy_(w)


def _kernel():
    global _compiled
    if _compiled is None:
        import triton
        import triton.language as tl

        @triton.jit
        def adamw_kernel(g_ptr, m_ptr, v_ptr, w_ptr, p_ptr, sc_ptr, n, BLOCK: tl.constexpr):
            offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            lr = tl.load(sc_ptr + 0)
            b1 = tl.load(sc_ptr + 1)
            b2 = tl.load(sc_ptr + 2)
            inv_bias1 = tl.load(sc_ptr + 3)
            inv_bias2 = tl.load(sc_ptr + 4)
            eps = tl.load(sc_ptr + 5)
            wd = tl.load(sc_ptr + 6)
            gs = tl.load(sc_ptr + 7)
            skip = tl.load(sc_ptr + 8)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32) * gs
            m0 = tl.load(m_ptr + offs, mask=mask, other=0.0)
            v0 = tl.load(v_ptr + offs, mask=mask, other=0.0)
            w0 = tl.load(w_ptr + offs, mask=mask, other=0.0)
            m1 = b1 * m0 + (1.0 - b1) * g
            v1 = b2 * v0 + (1.0 - b2) * (g * g)
            upd = tl.div_rn(m1 * inv_bias1, tl.sqrt_rn(v1 * inv_bias2) + eps)
            w1 = w0 - lr * (upd + wd * w0)
            keep = skip > 0.0
            w_new = tl.where(keep, w0, w1)
            tl.store(m_ptr + offs, tl.where(keep, m0, m1), mask=mask)
            tl.store(v_ptr + offs, tl.where(keep, v0, v1), mask=mask)
            tl.store(w_ptr + offs, w_new, mask=mask)
            tl.store(p_ptr + offs, w_new.to(p_ptr.dtype.element_ty), mask=mask)

        _compiled = adamw_kernel
    return _compiled


def _check(g, m, v, w, p, scalars):
    # the JAX guard (fused_adamw_supported) asks for a bf16 param and a
    # (rows, 1024) tiling, which only the TPU's blocks need; this kernel
    # stores the param in its own float dtype, so every leaf of a model goes
    # through it
    if p.dtype not in PARAM_DTYPES:
        raise TypeError(f"the fused AdamW kernel writes a bf16, fp16 or fp32 param, not {p.dtype}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grad must be fp32 or bf16, not {g.dtype}")
    for name, t in (("m", m), ("v", v), ("master", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, not {t.dtype}")
    for name, t in (("grad", g), ("m", m), ("v", v), ("master", w), ("param", p)):
        if t.shape != p.shape or t.device != p.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(p.shape)} on {p.device}: "
                             f"{tuple(t.shape)} on {t.device}")
    if scalars.shape != (N_SCALARS,) or scalars.dtype != torch.float32 or scalars.device != p.device:
        raise ValueError(f"scalars must be ({N_SCALARS},) fp32 on {p.device}")


def launch(g, m, v, w, p, scalars):
    """Launch the kernel on one CUDA leaf; returns Triton's compiled-kernel
    handle (registers and spills for a build report)."""
    global launches
    _check(g, m, v, w, p, scalars)
    n = p.numel()
    kernel = _kernel()
    with torch.cuda.device(p.device):
        handle = kernel[(-(-n // BLOCK),)](g, m, v, w, p, scalars, n, BLOCK=BLOCK, num_warps=NUM_WARPS)
    launches += 1
    return handle


def fused_adamw_update_(g, m, v, w, p, scalars) -> None:
    """One AdamW step on one leaf, in place (m, v, master w, param p):
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    if p.device.type == "cpu":
        _check(g, m, v, w, p, scalars)
        plain_adamw_update_(g, m, v, w, p, scalars)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused AdamW runs on cpu (plain) or cuda (kernel), not {p.device}")
    launch(g, m, v, w, p, scalars)
