"""Residual dropout with JAX's masks: the Triton kernel's wrapper, its plain
version, and the autograd Function that joins them.

The JAX model's residual dropout (``internevo_tpu/models/base.py:412-417``)
is ``keep = bernoulli(key, 1 - rate, h.shape)`` and ``where(keep, h / (1 -
rate), 0)`` in h's dtype; its gradient is the same map of the upstream grad.
JAX draws the mask with ``jax.random.bernoulli`` outside Pallas, so this is no
port of a TPU kernel; it is here because the plain version of the draw, ~150
int64 passes over the tensor (20 threefry rounds of add, rotate and xor, each
masked to 32 bits), would cost ~10 ms a (4096, 4096) mask on the card.

The kernel does the whole map in one pass: each element's threefry counter
is its flat index (``core/random.py``), the 32 bits become JAX's float32
uniform and the keep test, and the element is scaled or zeroed and stored.
Its bound is the larger of the bytes of h read once and the output
written once, and the hash's 74 integer operations an element
(``HASH_INT_OPS``: 2 adds, 20 rounds of add, rotate and xor, 5 key
injections of 2 adds, then the xor and shift of the bits) at the card's
INT32 rate, SMs x 64 lanes x SM clock, which the data sheet does not
list.  The divisor is ``1 - rate`` rounded to h's dtype,
as JAX converts the Python float; the quotient is the IEEE float32 quotient
(``div_rn``) rounded once to h's dtype, as XLA computes a bf16 division.

Dispatch is on the tensor's device: a CPU tensor runs ``plain_dropout``, a
CUDA tensor launches the kernel or raises.  The backward draws the mask
again from the key; nothing is saved.
"""

from __future__ import annotations

import torch

from ...core import random as jrandom

BLOCK = 1024      # elements per program
NUM_WARPS = 4

HASH_INT_OPS = 74  # integer operations of one element's hash (module docstring)

launches = 0      # kernel launches; the plain version never counts
_compiled = None  # the @triton.jit function, made on first launch


def divisor(rate: float, dtype: torch.dtype) -> torch.Tensor:
    """``1 - rate`` as JAX makes it for an array of ``dtype``: the Python
    float rounded to float32, then to ``dtype``."""
    return torch.tensor(1.0 - rate, dtype=torch.float32).to(dtype)


def plain_dropout(h: torch.Tensor, key: jrandom.Key, rate: float) -> torch.Tensor:
    """``where(bernoulli(key, 1 - rate, h.shape), h / (1 - rate), 0)`` in h's
    dtype, in plain torch (``core/random.py``)."""
    keep = jrandom.bernoulli(key, 1.0 - rate, h.shape, device=h.device)
    c = divisor(rate, h.dtype).to(h.device)
    return torch.where(keep, h / c, torch.zeros((), dtype=h.dtype, device=h.device))


def _kernel():
    global _compiled
    if _compiled is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["k0", "k1"])
        def dropout_kernel(x_ptr, y_ptr, n, k0, k1, p, c, BLOCK: tl.constexpr):
            offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            # threefry2x32 of the key and the counter (index >> 32, index & M32)
            ks0 = k0.to(tl.uint32)
            ks1 = k1.to(tl.uint32)
            ks2 = ks0 ^ ks1 ^ 0x1BD11BDA
            x0 = (offs >> 32).to(tl.uint32) + ks0
            x1 = offs.to(tl.uint32) + ks1
            x0 += x1; x1 = x0 ^ ((x1 << 13) | (x1 >> 19))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 15) | (x1 >> 17))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 26) | (x1 >> 6))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 6) | (x1 >> 26))  # noqa: E702
            x0 += ks1
            x1 += ks2 + 1
            x0 += x1; x1 = x0 ^ ((x1 << 17) | (x1 >> 15))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 29) | (x1 >> 3))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 16) | (x1 >> 16))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 24) | (x1 >> 8))  # noqa: E702
            x0 += ks2
            x1 += ks0 + 2
            x0 += x1; x1 = x0 ^ ((x1 << 13) | (x1 >> 19))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 15) | (x1 >> 17))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 26) | (x1 >> 6))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 6) | (x1 >> 26))  # noqa: E702
            x0 += ks0
            x1 += ks1 + 3
            x0 += x1; x1 = x0 ^ ((x1 << 17) | (x1 >> 15))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 29) | (x1 >> 3))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 16) | (x1 >> 16))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 24) | (x1 >> 8))  # noqa: E702
            x0 += ks1
            x1 += ks2 + 4
            x0 += x1; x1 = x0 ^ ((x1 << 13) | (x1 >> 19))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 15) | (x1 >> 17))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 26) | (x1 >> 6))  # noqa: E702
            x0 += x1; x1 = x0 ^ ((x1 << 6) | (x1 >> 26))  # noqa: E702
            x0 += ks2
            x1 += ks0 + 5
            # JAX's float32 uniform (the top 23 bits over 2**23, exact) and keep test
            u = ((x0 ^ x1) >> 9).to(tl.float32) * 1.1920928955078125e-07
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = tl.where(u < p, tl.div_rn(x, c), 0.0)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

        _compiled = dropout_kernel
    return _compiled


def launch(h: torch.Tensor, key: jrandom.Key, rate: float, out: torch.Tensor | None = None):
    """Launch the kernel on a contiguous CUDA tensor; returns (out,
    Triton's compiled-kernel handle)."""
    global launches
    if not h.is_contiguous():
        raise ValueError("the dropout kernel takes a contiguous tensor")
    if h.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"the dropout kernel takes bf16, fp16 or fp32, not {h.dtype}")
    out = torch.empty_like(h) if out is None else out
    n = h.numel()
    kernel = _kernel()
    p = float(torch.tensor(1.0 - rate, dtype=torch.float32))
    with torch.cuda.device(h.device):
        handle = kernel[(max(1, -(-n // BLOCK)),)](h, out, n, key[0], key[1], p,
                                                    float(divisor(rate, h.dtype)), BLOCK=BLOCK,
                                                    num_warps=NUM_WARPS)
    launches += 1
    return out, handle


def _apply(h: torch.Tensor, key: jrandom.Key, rate: float) -> torch.Tensor:
    if h.device.type == "cpu":
        return plain_dropout(h, key, rate)
    if h.device.type != "cuda":
        raise ValueError(f"dropout runs on cpu (plain) or cuda (kernel), not {h.device}")
    return launch(h.contiguous(), key, rate)[0]


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, key, rate):
        ctx.key, ctx.rate = key, rate
        return _apply(h, key, rate)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, ctx.key, ctx.rate), None, None


def dropout(h: torch.Tensor, key: jrandom.Key, rate: float) -> torch.Tensor:
    """JAX's residual dropout of ``h`` under ``key``, differentiable: the
    backward maps the grad with the same mask, drawn again from the key."""
    return _Dropout.apply(h, key, float(rate))
