"""Grouped matmul for the dropless MoE: the CUDA kernels' wrappers, their
plain versions, and the autograd Function that joins them.

Counterpart of ``internevo_tpu/ops/pallas/gmm.py``.  Rows sorted by expert
meet their expert's weights::

    gmm:   out[i] = x[i] @ w[g(i)]          (w: (E, K, N); transpose_rhs: @ w[g(i)]ᵀ)
    tgmm:  dw[e]  = Σ_{i ∈ e} x[i]ᵀ dy[i]    (exactly 0 for an empty group)

``group_sizes`` (E,) gives the rows of each group in order; rows past
``sum(group_sizes)`` belong to the last group, as the TPU kernel's padded
rows do (``gmm.py::_metadata``).  Products accumulate in fp32 and round once
to ``out_dtype``.

Dispatch is on the tensors' device and nothing else: CPU tensors run the
plain versions (``plain_gmm`` / ``plain_tgmm``, one fp32 matmul per group),
CUDA tensors launch ``csrc/gmm.cu`` or raise.  The kernels take bf16 or
fp16 operands of one dtype (the TPU kernel computes in x's dtype),
contiguous, with every feature dim a multiple of 8, and write the operands'
dtype or fp32; the wrappers
read ``group_sizes`` only on the device (a cumulative sum), so no call waits
on the host.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .build import load

SOURCE = "gmm.cu"
# the operand dtypes: the suffix of each one's C entry points
DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16"}
GMM_TILE_M = 128  # output rows of a work item (csrc/gmm.cu GMM_BM): x rows in gmm, dW rows in tgmm
GMM_TILE_N = 256  # output columns of a work item (GMM_BN)
GMM_SLICE = 64    # rows of one tgmm contraction slice (GMM_BK)
BAND = 8          # row tiles of a band of the item order (BAND)

# kernel launches; the plain versions never count
launches_gmm = 0          # gmm forward (transpose_rhs False)
launches_gmm_dgrad = 0    # gmm with transpose_rhs (the input grad)
launches_tgmm = 0         # tgmm (the weight grad)
# the same launches by instantiation: (kernel "gmm" / "gmm_dgrad" / "tgmm",
# operand dtype suffix) -> count
launches_by_case: Counter = Counter()


# ------------------------------------------------------------ plain version


def _host_sizes(group_sizes, n: int) -> list[int]:
    """Group sizes on the host, the last group taking the rows past the sum."""
    sizes = [int(s) for s in group_sizes.tolist()]
    sizes[-1] += n - sum(sizes)
    return sizes


def plain_gmm(x, w, group_sizes, *, transpose_rhs: bool = False, out_dtype=None):
    """Plain torch ``gmm``: one fp32 matmul per group, one cast.  Differentiable
    in x and w by autograd."""
    F = w.shape[1] if transpose_rhs else w.shape[2]
    outs, start = [], 0
    for e, size in enumerate(_host_sizes(group_sizes, x.shape[0])):
        if size:
            we = w[e].float()
            outs.append(x[start:start + size].float() @ (we.T if transpose_rhs else we))
            start += size
    out = torch.cat(outs) if outs else x.new_zeros(0, F, dtype=torch.float32)
    return out.to(out_dtype or x.dtype)


def plain_tgmm(x, dy, group_sizes, E: int, out_dtype=torch.float32):
    """Plain torch ``tgmm``: (E, K, N), zero for an empty group; an fp32 sum
    per group, cast once to ``out_dtype``."""
    out = torch.zeros(E, x.shape[1], dy.shape[1], dtype=torch.float32, device=x.device)
    start = 0
    for e, size in enumerate(_host_sizes(group_sizes, x.shape[0])):
        if size:
            out[e] = x[start:start + size].float().T @ dy[start:start + size].float()
            start += size
    return out.to(out_dtype)


def _group_spans(ends, n: int) -> list[tuple[int, int, int]]:
    """(group, lo, hi) for each group: the groups cut [0, n) in order at the
    ends, clamped to [0, n) and never decreasing; the last group also takes
    the rows past the sum (``csrc/gmm.cu::gmm_pair``, ``group_rows``)."""
    spans, end = [], 0
    for g, c in enumerate(ends):
        lo = end
        end = n if g == len(ends) - 1 else min(n, max(lo, int(c)))
        spans.append((g, lo, end))
    return spans


def gmm_work_items(ends, n: int) -> list[tuple[int, int, int, int]]:
    """The gmm kernel's (group, m-tile, lo, hi) pairs, in its order, for the
    group ends ``ends`` (the cumulative group sizes) over n rows: the Python
    twin of ``csrc/gmm.cu::gmm_pair``.  A non-empty group [lo, hi) lists
    every m-tile that its rows overlap.  The kernel runs each pair once for
    every n-tile, with the group's weights, and stores only the rows [lo, hi)."""
    return [(g, mt, lo, hi) for g, lo, hi in _group_spans(ends, n) if lo < hi
            for mt in range(lo // GMM_TILE_M, (hi - 1) // GMM_TILE_M + 1)]


def _band_order(t: int, tiles_m: int, tiles_n: int) -> tuple[int, int]:
    """Tile (tm, tn) of linear id t in bands of ``BAND`` row tiles swept
    column by column (``csrc/gmm.cu::band_order``)."""
    width = BAND * tiles_n
    first = t // width * BAND
    rows = min(tiles_m - first, BAND)
    return first + t % width % rows, t % width // rows


def tgmm_work_items(ends, n: int, K: int, N: int) -> list[tuple[int, int, int, int, int]]:
    """The tgmm kernel's (expert, K-tile, N-tile, lo, hi) items, in its walk
    order, for the group ends ``ends`` over n rows: the Python twin of
    ``csrc/gmm.cu::work_item<TGMM>``.  Every expert lists each of its
    (K-tile, N-tile) tiles once, in bands of K-tiles swept across the
    N-tiles; the contraction runs over the group's rows [lo, hi) in
    ``GMM_SLICE``-row slices from lo (``tgmm_slices``), and an empty
    group's items run none and store zeros.  Persistent block b takes items
    b, b + blocks, ..."""
    tiles_k, tiles_n = -(-K // GMM_TILE_M), -(-N // GMM_TILE_N)
    return [(g, *_band_order(t, tiles_k, tiles_n), lo, hi) for g, lo, hi in _group_spans(ends, n)
            for t in range(tiles_k * tiles_n)]


def tgmm_slices(lo: int, hi: int) -> list[tuple[int, int]]:
    """The contraction slices of a tgmm item over rows [lo, hi): (first row,
    rows the group owns); the kernel zeroes x's rows past that count."""
    return [(r, min(GMM_SLICE, hi - r)) for r in range(lo, hi, GMM_SLICE)]


# ------------------------------------------------------------------ kernels


def _check_operand(name, t, dims, x):
    """Refuses an operand that no kernel takes: another rank, device or
    dtype than x's, a dtype other than bf16 or fp16, a layout TMA cannot
    address."""
    if t.dim() != dims:
        raise ValueError(f"{name} must be {dims}-D: {tuple(t.shape)}")
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if t.dtype not in DTYPES or t.dtype != x.dtype:
        raise TypeError(f"the CUDA gmm kernels take bf16 or fp16 operands of one dtype; {name} is {t.dtype}, "
                        f"x {x.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if any(s % 8 for s in t.shape[1:]):
        raise ValueError(f"the CUDA gmm kernels take feature dims that are multiples of 8; "
                         f"{name} is {tuple(t.shape)}")


def _group_ends(group_sizes, E: int, device):
    """The int32 cumulative sum of ``group_sizes``, computed on the device."""
    if group_sizes.shape != (E,) or group_sizes.device != device:
        raise ValueError(f"group_sizes must be ({E},) on {device}: {tuple(group_sizes.shape)} "
                         f"on {group_sizes.device}")
    return torch.cumsum(group_sizes, 0, dtype=torch.int32)


def _fn(name: str, n_ptrs: int, n_ints: int):
    """A C entry point of ``csrc/gmm.cu``, built and loaded on first use."""
    fn = getattr(load(SOURCE), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    return fn


def _check_out(out_dtype, x, what: str) -> None:
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"the CUDA {what} kernel writes {x.dtype} or fp32 for {x.dtype} operands, not {out_dtype}")


def _run(fn, device, args, what: str) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


class GmmCall:
    """The prepared operands of one gmm (group ends, output, argument list);
    ``launch`` launches the kernel on them.  ``ends`` is the device tensor the
    kernel reads."""

    def __init__(self, x, w, group_sizes, transpose_rhs: bool = False, out_dtype=None):
        out_dtype = out_dtype or x.dtype
        _check_operand("x", x, 2, x)
        _check_operand("w", w, 3, x)
        E = w.shape[0]
        Kc, F = (w.shape[2], w.shape[1]) if transpose_rhs else (w.shape[1], w.shape[2])
        if x.shape[1] != Kc:
            raise ValueError(f"x {tuple(x.shape)} does not contract with w {tuple(w.shape)} "
                             f"(transpose_rhs={transpose_rhs})")
        _check_out(out_dtype, x, "gmm")
        load(SOURCE)  # built before any work: a machine without the toolkit fails here
        self.ends = _group_ends(group_sizes, E, x.device)
        self.out = torch.empty(x.shape[0], F, dtype=out_dtype, device=x.device)
        self.transpose_rhs = transpose_rhs
        self.device, self.dtype = x.device, DTYPES[x.dtype]
        self.args = [x.data_ptr(), w.data_ptr(), self.ends.data_ptr(), self.out.data_ptr(),
                     x.shape[0], Kc, F, E, int(transpose_rhs), int(out_dtype == torch.float32)]
        self.inputs = (x, w)  # kept alive while the kernel may read them

    def launch(self) -> None:
        global launches_gmm, launches_gmm_dgrad
        if self.out.shape[0] == 0:
            return
        _run(_fn(f"gmm_{self.dtype}", 4, 6), self.device, self.args, "gmm")
        if self.transpose_rhs:
            launches_gmm_dgrad += 1
        else:
            launches_gmm += 1
        launches_by_case[("gmm_dgrad" if self.transpose_rhs else "gmm", self.dtype)] += 1


class TgmmCall:
    """The prepared operands of one tgmm; ``launch`` launches the kernel.
    With no rows, ``out`` is already the zeros and nothing is launched."""

    def __init__(self, x, dy, group_sizes, E: int, out_dtype=torch.float32):
        _check_operand("x", x, 2, x)
        _check_operand("dy", dy, 2, x)
        if dy.shape[0] != x.shape[0]:
            raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} differ in rows")
        _check_out(out_dtype, x, "tgmm")
        load(SOURCE)
        self.ends = _group_ends(group_sizes, E, x.device)
        n = x.shape[0]
        self.out = (torch.empty if n else torch.zeros)(E, x.shape[1], dy.shape[1], dtype=out_dtype,
                                                       device=x.device)
        self.device, self.dtype = x.device, DTYPES[x.dtype]
        self.args = [x.data_ptr(), dy.data_ptr(), self.ends.data_ptr(), self.out.data_ptr(),
                     n, x.shape[1], dy.shape[1], E, int(out_dtype == torch.float32)]
        self.inputs = (x, dy)

    def launch(self) -> None:
        global launches_tgmm
        if self.inputs[0].shape[0] == 0:
            return
        _run(_fn(f"tgmm_{self.dtype}", 4, 5), self.device, self.args, "tgmm")
        launches_tgmm += 1
        launches_by_case[("tgmm", self.dtype)] += 1


# ------------------------------------------------------------------ dispatch


def _use_plain(x) -> bool:
    """True for CPU tensors (the plain versions), False for CUDA tensors (the
    kernels); any other device is refused."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gmm runs on cpu (plain) or cuda (kernel), not {x.device}")
    return x.device.type == "cpu"


def gmm(x, w, group_sizes, *, transpose_rhs: bool = False, out_dtype=None):
    """x: (n, Kc); w: (E, Kc, N), or (E, N, Kc) with ``transpose_rhs``;
    group_sizes: (E,) int.  Returns (n, N) in ``out_dtype`` (default x's)."""
    if _use_plain(x):
        return plain_gmm(x, w, group_sizes, transpose_rhs=transpose_rhs, out_dtype=out_dtype)
    call = GmmCall(x, w, group_sizes, transpose_rhs, out_dtype)
    call.launch()
    return call.out


def tgmm(x, dy, group_sizes, E: int, out_dtype=torch.float32):
    """x: (n, K); dy: (n, N); group_sizes: (E,) int.  Returns (E, K, N) in
    ``out_dtype``: the fp32 sums, rounded once."""
    if _use_plain(x):
        return plain_tgmm(x, dy, group_sizes, E, out_dtype)
    call = TgmmCall(x, dy.contiguous(), group_sizes, E, out_dtype)
    call.launch()
    return call.out


class GroupedMatmul(torch.autograd.Function):
    """out = gmm(x, w); the JAX ``grouped_matmul`` custom_vjp: dx by gmm with
    the rhs transposed, dW by tgmm, its fp32 sums written in w's dtype (JAX
    casts the fp32 result, ``gmm.py:342-347``: the same single rounding)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return gmm(x, w, group_sizes, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, w, group_sizes, transpose_rhs=True, out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, dy, group_sizes, w.shape[0], out_dtype=w.dtype)
        return dx, dw, None


def grouped_matmul(x, w, group_sizes):
    """``out[i] = x[i] @ w[g(i)]`` for rows sorted by group, differentiable in
    x and w.  x: (n, K); w: (E, K, N); group_sizes: (E,) int summing to at
    most n.  Returns (n, N) in x's dtype."""
    return GroupedMatmul.apply(x, w, group_sizes)
