"""fp32 tensors as three bf16 pieces: the operands of the splash kernels'
fp32 instantiations, its Triton kernel's wrapper and its plain version.

The TPU kernel forms its dots with ``preferred_element_type=f32``, so on
fp32 inputs every product is an fp32 product (``internevo_tpu/ops/pallas/
splash_attention.py:513,528,612,627``).  Hopper's tensor cores take no fp32
operand (TF32 rounds to 10 bits), so an fp32 x goes to them as hi = bf16(x),
mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even.
The subtractions are exact and the pieces hold x's 24 significand bits, so
hi + mid + lo is x wherever the pieces are normal numbers (|x| above about
2^-110; below, the lo piece is subnormal and loses bits), and a product
a·b is the bf16 terms a_i·b_j with i + j <= 2 (``TERMS``), each exact,
summed in fp32; the terms left out are below 2^-24 of a·b.  The kernels split P and dS in registers
(``split3`` in ``csrc/hopper.cuh``); q, k, v and dO are split here.

The split is one elementwise pass, 4 bytes read and 6 written an element,
so the Triton kernel fuses it: ``plain_split``'s torch glue is several
passes with fp32 temporaries, about half of the fp32 forward's time at
head dim 128 (``PERF.md``, from ``chip_smoke.py`` kernel_coverage).

Dispatch is on the tensor's device: a CPU tensor runs ``plain_split``, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

# the terms (i, j) of a product of three-piece operands a·b = Σ a_i·b_j,
# smallest first, as the kernels sum them (``piece_a`` / ``piece_b`` in
# ``csrc/splash.cuh``)
TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
BLOCK = 1024      # elements per program
NUM_WARPS = 4

launches = 0      # kernel launches; the plain version never counts
_compiled = None  # the @triton.jit function, made on first launch


def plain_split(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as its pieces, stacked (3, *x.shape) in bf16, in plain torch."""
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    out[0] = x
    rest = x - out[0].float()
    out[1] = rest
    out[2] = rest - out[1].float()
    return out


MAX_TENSORS = 4  # tensors one launch splits: q, k, v and dO


def _kernel():
    global _compiled
    if _compiled is None:
        import triton
        import triton.language as tl

        @triton.jit
        def split_block(x_ptr, out_ptr, n, block, BLOCK: tl.constexpr):
            offs = block.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            x = tl.load(x_ptr + offs, mask=mask, other=0.0)
            hi = x.to(tl.bfloat16)  # round to nearest even
            rest = x - hi.to(tl.float32)
            mid = rest.to(tl.bfloat16)
            lo = (rest - mid.to(tl.float32)).to(tl.bfloat16)
            tl.store(out_ptr + offs, hi, mask=mask)
            tl.store(out_ptr + n + offs, mid, mask=mask)
            tl.store(out_ptr + 2 * n + offs, lo, mask=mask)

        # one launch for up to four tensors: program ids [e_{t-1}, e_t) take
        # tensor t's blocks
        @triton.jit
        def split_kernel(x0, o0, n0, x1, o1, n1, x2, o2, n2, x3, o3, n3, e0, e1, e2, BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            if pid < e0:
                split_block(x0, o0, n0, pid, BLOCK)
            elif pid < e1:
                split_block(x1, o1, n1, pid - e0, BLOCK)
            elif pid < e2:
                split_block(x2, o2, n2, pid - e1, BLOCK)
            else:
                split_block(x3, o3, n3, pid - e2, BLOCK)

        _compiled = split_kernel
    return _compiled


def launch(*xs: torch.Tensor):
    """Launch the kernel once on up to four contiguous fp32 CUDA tensors;
    returns (their pieces, Triton's compiled-kernel handle)."""
    global launches
    if not 0 < len(xs) <= MAX_TENSORS:
        raise ValueError(f"the split kernel takes 1 to {MAX_TENSORS} tensors, not {len(xs)}")
    for x in xs:
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != xs[0].device:
            raise TypeError(f"the split kernel takes contiguous fp32 tensors on one device, not {x.dtype}")
    outs = [torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device) for x in xs]
    args, ends, blocks = [], [], 0
    for t in range(MAX_TENSORS):
        x, o = (xs[t], outs[t]) if t < len(xs) else (xs[0], outs[0])
        n = x.numel() if t < len(xs) else 0
        blocks += -(-n // BLOCK)
        args += [x, o, n]
        ends.append(blocks)
    with torch.cuda.device(xs[0].device):
        handle = _kernel()[(max(1, blocks),)](*args, *ends[:3], BLOCK=BLOCK, num_warps=NUM_WARPS)
    launches += 1
    return outs, handle


def split_pieces(*xs: torch.Tensor) -> list:
    """Each fp32 tensor of ``xs`` as (3, *x.shape) bf16 pieces:
    ``plain_split`` on the CPU, one kernel launch on the card."""
    if xs[0].device.type == "cpu":
        return [plain_split(x) for x in xs]
    if xs[0].device.type != "cuda":
        raise ValueError(f"split_pieces runs on cpu (plain) or cuda (kernel), not {xs[0].device}")
    return launch(*(x.contiguous() for x in xs))[0]
