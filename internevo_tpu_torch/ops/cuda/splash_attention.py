"""Splash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd Functions that join them.

Counterpart of ``internevo_tpu/ops/pallas/splash_attention.py``.
``splash_attention`` / ``splash_attention_with_lse`` keep the JAX public names
and semantics: causal ∧ same-segment attention over packed rows, GQA,
optional counter-hash dropout, out (B, S, Hq, D) and lse (B, Hq, S) fp32, out 0
and lse -inf on rows with no valid key.  Both are differentiable in q, k and
v (``splash_attention_with_lse`` in its lse too, as the JAX ``custom_vjp``).

Dispatch is on the tensors' device and nothing else: CPU tensors run the
plain versions (``plain_forward`` / ``plain_backward``, dense torch over a
materialised score tensor), CUDA tensors launch a kernel or raise.  On the
card every dtype runs the wgmma kernels, ``csrc/splash_attention_fwd.cu``
forward and ``csrc/splash_attention_bwd.cu`` backward.  bf16 and fp16 q/k/v
are their operands as they are.  fp32 keeps full fp32 products, as the TPU
kernel forms on fp32 inputs: ``pieces.split_pieces`` splits q, k, v (and
dO) into three bf16 pieces whose sum is each value exactly, and the
kernels' fp32 instantiations sum the six bf16 products of the pieces that
fp32 accuracy needs (``pieces.TERMS``) in fp32.  Every head dim up to 128
that is a multiple of 8 is taken; a larger one, or one that TMA's 16-byte
strides cannot address, is refused.  Inside a recomputed layer (``core/remat.py``) the
forward's (out, lse) are kept from the first forward (``remat.FLASH``), so
the recompute hands them to the backward without launching the forward
kernel again.

The TPU kernel visits, per q block, only kv blocks from the start of the
segment run at the block's first token (``kv_lo``) up to the diagonal; its
static budget from ``max_segment_len`` truncates only data that breaks the
packing contract.  The CUDA kernel reads ``kv_lo`` (computed here on the
device, ``_segment_windows``) and loops to the diagonal, so it needs no budget:
``max_segment_len`` is accepted for the API and not used.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ...core import remat
from .build import load
from .pieces import split_pieces

LOG2E = 1.4426950408889634
SOURCE = "splash_attention_fwd.cu"
BWD_SOURCE = "splash_attention_bwd.cu"
# the kernels' dtypes: the suffix of each one's C entry points
DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
MAX_HEAD_DIM = 128
# the forward's (q, kv) block sizes: its 128-row q items walk 64-row kv
# tiles from kv_lo (ITEM and TILE in its source)
BLOCK_Q = 128
BLOCK_K = 64
# the backward's (q, kv) block sizes: the dK/dV kernel's 128-row kv items
# walk 64-row q tiles up to q_hi; the dQ kernel's 128-row q items walk 64-row
# kv tiles from kv_lo (TILE and ITEM in its source)
BWD_DKDV_BLOCKS = (64, 128)
BWD_DQ_BLOCKS = (128, 64)
# the fp32 backward's blocks: both kernels' 64-row items walk 64-row tiles
# (item_rows<3> and TILE in its source); the fp32 forward's are the forward's
F32_BWD_BLOCKS = (64, 64)
# plain version: the largest (B, heads, S, Sk) score slab materialised at once
_PLAIN_SLAB_ELEMS = 1 << 28

# kernel launches; the plain versions never count
launches = 0             # forward
launches_bwd_dkdv = 0    # backward, dK/dV kernel
launches_bwd_dq = 0      # backward, dQ kernel
# the same launches by instantiation: (kernel "fwd" / "bwd_dkdv" / "bwd_dq",
# dtype suffix, head dim) -> count
launches_by_case: Counter = Counter()


# ------------------------------------------------------------------ dropout

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash_rc(row, col, head, base):
    """The dropout hash of GLOBAL (q row, kv col, q head) coordinates, as
    uint32 values held in int64 tensors."""
    return _fmix32(_mul32(row, 0x9E3779B1) ^ _mul32(col, 0x85EBCA77)
                   ^ _mul32(head, 0xC2B2AE3D) ^ base)


def _keep_thresh(rate: float) -> int:
    return min(int(rate * 2.0**32), 2**32 - 1)


def _norm_seed(dropout_seed) -> tuple[int, ...]:
    """A dropout seed as the five int32 words ``(seed, row0, col0, head0,
    batch0)``, host ints wrapped to int32 as ``jnp.asarray`` wraps them; a
    scalar or (1,) seed means offsets 0.  A Python int, a sequence of ints or
    a numpy array costs no device work, which is what the model passes (one
    seed a layer, drawn on the host from the layer's key); a tensor seed is
    read to the host, which for a CUDA tensor waits for the device."""
    if dropout_seed is None:
        return (0,) * 5
    if isinstance(dropout_seed, torch.Tensor):
        vals = dropout_seed.reshape(-1).tolist()
    else:
        vals = np.asarray(dropout_seed).reshape(-1).tolist()
    vals = [(int(v) + 2**31) % 2**32 - 2**31 for v in vals]
    if len(vals) == 1:
        vals += [0] * 4
    if len(vals) != 5:
        raise ValueError(f"dropout_seed must be scalar or (5,): {len(vals)} values")
    return tuple(vals)


def _seed_u32(dropout_seed) -> list[int]:
    return [s & _M32 for s in _norm_seed(dropout_seed)]


def dropout_mask_dense(rate: float, dropout_seed, B: int, H: int, S: int, Sk: int,
                       device=None, head_offset: int = 0, n_heads: Optional[int] = None):
    """(B, H, S, Sk) fp32 keep-and-scale mask, bit-identical to the kernel's
    in-kernel draw and to the JAX ``dropout_mask_dense``.  ``head_offset`` /
    ``n_heads`` select heads [head_offset, head_offset + n_heads) of H."""
    if dropout_seed is None:
        raise ValueError("attention dropout needs dropout_seed")
    s0, r0, c0, h0, b0 = _seed_u32(dropout_seed)
    n_heads = H if n_heads is None else n_heads
    kw = dict(device=device, dtype=torch.int64)
    row = ((torch.arange(S, **kw) + r0) & _M32).view(1, 1, S, 1)
    col = ((torch.arange(Sk, **kw) + c0) & _M32).view(1, 1, 1, Sk)
    head = ((torch.arange(head_offset, head_offset + n_heads, **kw) + h0) & _M32).view(1, n_heads, 1, 1)
    b = ((torch.arange(B, **kw) + b0) & _M32).view(B, 1, 1, 1)
    base = (s0 + _mul32(b, 0x632BE59B)) & _M32
    keep = _hash_rc(row, col, head, base) >= _keep_thresh(rate)
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


# ------------------------------------------------------------- control data


def _run_start(kv_seg: torch.Tensor) -> torch.Tensor:
    """(B, Sk): the first index of each kv token's segment RUN (runs are
    contiguous; ids need not be monotonic)."""
    B, Sk = kv_seg.shape
    idx_k = torch.arange(Sk, device=kv_seg.device).expand(B, Sk)
    change = torch.ones_like(kv_seg, dtype=torch.bool)
    change[:, 1:] = kv_seg[:, 1:] != kv_seg[:, :-1]
    return torch.cummax(torch.where(change, idx_k, torch.zeros_like(idx_k)), dim=1).values


def _run_end(seg: torch.Tensor) -> torch.Tensor:
    """(B, S): the last index of each q token's segment run."""
    B, S = seg.shape
    idx_q = torch.arange(S, device=seg.device).expand(B, S)
    change_n = torch.ones_like(seg, dtype=torch.bool)
    change_n[:, :-1] = seg[:, 1:] != seg[:, :-1]
    ends = torch.where(change_n, idx_q, torch.full_like(idx_q, S - 1))
    return torch.cummin(ends.flip(1), dim=1).values.flip(1)


def _kv_lo(run_start: torch.Tensor, block_q: int, block_k: int) -> torch.Tensor:
    """(B, cdiv(S, block_q)): the first useful kv block of each q block."""
    return (run_start[:, ::block_q] // block_k).to(torch.int32)


def _q_hi(run_end: torch.Tensor, Sk: int, block_q: int, block_k: int) -> torch.Tensor:
    """(B, cdiv(Sk, block_k)): the last useful q block of each kv block -- the
    run end at the kv block's last token, which the dK/dV loop stops at.
    Where block_k does not divide S, the last, partial kv block reads the run
    end at token S - 1."""
    S = run_end.shape[1]
    last = (torch.arange(-(-Sk // block_k), device=run_end.device) * block_k + block_k - 1).clamp_max(S - 1)
    return (run_end[:, last] // block_q).to(torch.int32)


def _segment_windows(seg: torch.Tensor, kv_seg: torch.Tensor, block_q: int, block_k: int):
    """``kv_lo`` (B, cdiv(S, block_q)) and ``q_hi`` (B, cdiv(Sk, block_k)) from
    the segment runs.  Self-attention only (S == Sk); elsewhere than a ragged
    last kv block, ``q_hi`` is the JAX function's."""
    return _kv_lo(_run_start(kv_seg), block_q, block_k), _q_hi(_run_end(seg), kv_seg.shape[1], block_q, block_k)


# ------------------------------------------------------------ plain version


def plain_forward(q, k, v, segment_ids=None, kv_segment_ids=None, softmax_scale=None,
                  causal=True, dropout_rate=0.0, dropout_seed=None):
    """Dense torch forward with the kernel's semantics: fp32 scores from the
    inputs, masks causal ∧ same segment, empty rows out 0 / lse -inf, dropout
    on the normalised probabilities (lse over the undropped ones), probs cast
    to v's dtype for the PV product.  Heads are processed in slabs so the
    materialised (B, heads, S, Sk) scores stay bounded."""
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    rep = Hq // Hkv
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :])
    hc = max(1, min(Hq, _PLAIN_SLAB_ELEMS // max(1, B * S * Sk)))
    outs, lses = [], []
    for h0 in range(0, Hq, hc):
        h1 = min(Hq, h0 + hc)
        qh = q[:, :, h0:h1].float()
        kh = k[:, :, [h // rep for h in range(h0, h1)]].float()
        vh = v[:, :, [h // rep for h in range(h0, h1)]]
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        logits = logits.masked_fill(~mask, -math.inf)
        m = logits.amax(dim=-1)
        empty = torch.isneginf(m)
        safe_m = torch.where(empty, torch.zeros_like(m), m)
        unnorm = torch.exp(logits - safe_m[..., None])
        del logits
        denom = unnorm.sum(dim=-1)
        lse = torch.where(empty, torch.full_like(m, -math.inf),
                          safe_m + torch.log(denom.clamp_min(1e-37)))
        probs = unnorm / denom.clamp_min(1e-37)[..., None]
        del unnorm
        if dropout_rate > 0.0:
            probs = probs * dropout_mask_dense(dropout_rate, dropout_seed, B, Hq, S, Sk,
                                               device=q.device, head_offset=h0,
                                               n_heads=h1 - h0)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), vh.float())
        outs.append(out.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=1)


def plain_backward(q, k, v, out, lse, do, dlse=None, segment_ids=None, kv_segment_ids=None,
                   softmax_scale=None, causal=True, dropout_rate=0.0, dropout_seed=None):
    """Dense torch backward with the kernels' math: P = exp(QKᵀ·scale − lse)
    on the valid pairs (0 on masked pairs and on rows whose lse is -inf),
    delta = rowsum(dO∘O) − dlse, dV = Σ (P∘drop)ᵀ dO, dS = P∘(dP∘drop − delta),
    dQ = scale·dS K, dK = scale·dSᵀ Q, dK/dV summed over each kv group; P∘drop
    and dS rounded to the input dtype before their products, as the kernels
    do.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    rep = Hq // Hkv
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    mask = mask[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :])
    delta = torch.einsum("bshd,bshd->bhs", do.float(), out.float())
    if dlse is not None:
        delta = delta - dlse.float()
    dof = do.float()
    dq = torch.empty(B, S, Hq, D, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, Sk, Hkv, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros(B, Sk, Hkv, D, dtype=torch.float32, device=q.device)
    hc = max(1, min(Hq, _PLAIN_SLAB_ELEMS // max(1, B * S * Sk)))
    for h0 in range(0, Hq, hc):
        h1 = min(Hq, h0 + hc)
        kv_idx = [h // rep for h in range(h0, h1)]
        qh, doh = q[:, :, h0:h1].float(), dof[:, :, h0:h1]
        kh, vh = k[:, :, kv_idx].float(), v[:, :, kv_idx].float()
        lse_h = lse[:, h0:h1].float()
        valid = mask & ~torch.isneginf(lse_h)[..., None]
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        p = torch.where(valid, torch.exp(logits - torch.where(valid, lse_h[..., None], 0.0)), 0.0)
        del logits
        dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
        pd = p
        if dropout_rate > 0.0:
            drop = dropout_mask_dense(dropout_rate, dropout_seed, B, Hq, S, Sk, device=q.device,
                                      head_offset=h0, n_heads=h1 - h0)
            pd, dp = p * drop, dp * drop
            del drop
        ds = (p * (dp - delta[:, h0:h1, :, None])).to(q.dtype).float()
        del p, dp
        dv_h = torch.einsum("bhqk,bqhd->bkhd", pd.to(v.dtype).float(), doh)
        del pd
        dq[:, :, h0:h1] = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kh)
        dk_h = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qh)
        del ds
        for j, hk in enumerate(kv_idx):
            dk[:, :, hk] += dk_h[:, :, j]
            dv[:, :, hk] += dv_h[:, :, j]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels


def _check_cuda_inputs(q, k, v, segment_ids, kv_segment_ids):
    """Refuses what no kernel takes: q/k/v of another dtype than bf16, fp16
    or fp32, or of mixed dtypes; a head dim above 128 or not a multiple of 8;
    non-contiguous or unaligned operands; misshapen segment ids."""
    B, S, Hq, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v must be (B, Sk, Hkv, D) like q: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {k.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"the CUDA splash kernels take bf16, fp16 or fp32 q/k/v of one dtype; "
                            f"{name} is {t.dtype}, q {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not 0 < D <= MAX_HEAD_DIM or D % 8:
        raise ValueError(f"the CUDA splash kernels take a head_dim of at most {MAX_HEAD_DIM} that is a "
                         f"multiple of 8 (TMA's 16-byte strides), not {D}")
    for name, t, n in (("segment_ids", segment_ids, S), ("kv_segment_ids", kv_segment_ids, k.shape[1])):
        if t is not None and (t.shape != (B, n) or t.device != q.device):
            raise ValueError(f"{name} must be ({B}, {n}) on {q.device}: {tuple(t.shape)} on {t.device}")


def _segment_args(q, k, segment_ids, kv_segment_ids, cross_kv, lo_blocks, hi_blocks=None):
    """int32 (q_seg, kv_seg, kv_lo[, q_hi]) on the device: kv_lo at the (q, kv)
    block sizes ``lo_blocks``, q_hi at ``hi_blocks`` (left out when None);
    windows are off (kv_lo 0, q_hi the last q block) without segments or for
    cross kv."""
    B, S = q.shape[:2]
    Sk = k.shape[1]
    if segment_ids is None:
        q_seg = kv_seg = torch.zeros(1, dtype=torch.int32, device=q.device)
    else:
        q_seg = segment_ids.to(torch.int32).contiguous()
        kv_seg = (segment_ids if kv_segment_ids is None else kv_segment_ids).to(torch.int32).contiguous()
    if segment_ids is None or cross_kv:
        kv_lo = torch.zeros(B, -(-S // lo_blocks[0]), dtype=torch.int32, device=q.device)
        if hi_blocks is None:
            return q_seg, kv_seg, kv_lo
        return q_seg, kv_seg, kv_lo, torch.full((B, -(-Sk // hi_blocks[1])), -(-S // hi_blocks[0]) - 1,
                                                dtype=torch.int32, device=q.device)
    kv_lo = _kv_lo(_run_start(kv_seg), *lo_blocks).contiguous()
    if hi_blocks is None:
        return q_seg, kv_seg, kv_lo
    return q_seg, kv_seg, kv_lo, _q_hi(_run_end(q_seg), Sk, *hi_blocks).contiguous()



def _dropout_args(dropout_rate, dropout_seed):
    """(dropout flag, keep threshold, keep scale, 5 seed words) for the kernels."""
    if dropout_rate <= 0.0:
        return [0, 0, 1.0] + [0] * 5
    return [1, _keep_thresh(dropout_rate), float(1.0 / (1.0 - dropout_rate))] + _seed_u32(dropout_seed)


def _count(kernel: str, q) -> None:
    launches_by_case[(kernel, DTYPES[q.dtype], q.shape[-1])] += 1


def _kernel_fn(dtype):
    """The forward's C entry point for ``dtype``, built and loaded on first
    use, with its ctypes signature (one for every dtype)."""
    fn = getattr(load(SOURCE), f"splash_attention_fwd_{DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_float]
                       + [ctypes.c_uint] * 5 + [ctypes.c_void_p])
    return fn


def _bwd_fn(name: str, dtype):
    """A backward C entry point (``splash_attention_bwd_{dkdv,dq}_<dtype>``;
    one signature), built and loaded on first use."""
    fn = getattr(load(BWD_SOURCE), f"{name}_{DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_float]
                       + [ctypes.c_uint] * 5 + [ctypes.c_void_p])
    return fn


class ForwardCall:
    """The prepared operands of one forward (control data, outputs, the
    persistent blocks' item counter, the argument list); ``launch`` launches
    the kernel on them (the kernel zeroes the counter first), fp32 q/k/v
    split into their pieces first."""

    def __init__(self, q, k, v, segment_ids, kv_segment_ids, scale, causal, cross_kv, dropout_rate,
                 dropout_seed):
        _check_cuda_inputs(q, k, v, segment_ids, kv_segment_ids)
        load(SOURCE)  # built before any work: a machine without the toolkit fails here
        B, S, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        # its control data: kv_lo alone, at the forward's blocks
        self.segs = _segment_args(q, k, segment_ids, kv_segment_ids, cross_kv, (BLOCK_Q, BLOCK_K))
        self.out = torch.empty_like(q)
        self.lse = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
        self.next_item = torch.empty(1, dtype=torch.int32, device=q.device)
        self.device, self.dtype = q.device, q.dtype
        self.args = ([t.data_ptr() for t in (q, k, v, *self.segs, self.out, self.lse, self.next_item)]
                     + [B, S, Sk, Hq, Hkv, D, float(scale * LOG2E), int(causal), int(segment_ids is not None),
                        *_dropout_args(dropout_rate, dropout_seed)])
        self.inputs = (q, k, v)  # kept alive while the kernel may read them

    def launch(self) -> None:
        global launches
        fn = _kernel_fn(self.dtype)
        with torch.cuda.device(self.device):
            args = self.args
            if self.dtype == torch.float32:
                self.pieces = split_pieces(*self.inputs)
                args = [t.data_ptr() for t in self.pieces] + args[3:]
            err = fn(*args, torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"splash_attention_fwd launch failed: cudaError {err}")
        launches += 1
        _count("fwd", self.inputs[0])


def _kernel_forward(q, k, v, segment_ids, kv_segment_ids, scale, causal, cross_kv,
                    dropout_rate, dropout_seed):
    call = ForwardCall(q, k, v, segment_ids, kv_segment_ids, scale, causal, cross_kv, dropout_rate,
                       dropout_seed)
    call.launch()
    return call.out, call.lse


class BackwardCall:
    """The prepared operands of one backward: delta = rowsum(dO∘O) − dlse in
    plain torch (as the JAX package computes it in XLA), the control data, the
    outputs, and the argument list both kernels take, with fp32 q, k, v and
    dO as their pieces (``split``).  ``launch_dkdv`` and ``launch_dq``
    launch the two kernels on it."""

    def __init__(self, q, k, v, out, lse, do, dlse, segment_ids, kv_segment_ids, scale, causal,
                 cross_kv, dropout_rate, dropout_seed):
        _check_cuda_inputs(q, k, v, segment_ids, kv_segment_ids)
        load(BWD_SOURCE)  # built before any work: a machine without the toolkit fails here
        B, S, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        do = do.contiguous()  # the cotangent through reshape/out_proj need not be
        if do.shape != q.shape or out.shape != q.shape or do.dtype != q.dtype or out.dtype != q.dtype:
            raise ValueError(f"out and dO must be {tuple(q.shape)} {q.dtype}: "
                             f"{tuple(out.shape)} {out.dtype}, {tuple(do.shape)} {do.dtype}")
        if lse.shape != (B, Hq, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
            raise ValueError(f"lse must be contiguous ({B}, {Hq}, {S}) fp32: {tuple(lse.shape)} {lse.dtype}")
        if lse.numel() >= 2**31:  # the kernels index (B, Hq, S) with 32-bit offsets
            raise ValueError(f"B * Hq * S must be below 2**31: {B} * {Hq} * {S}")
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        self.delta = delta.contiguous()
        f32 = q.dtype == torch.float32
        self.segs = _segment_args(q, k, segment_ids, kv_segment_ids, cross_kv,
                                  F32_BWD_BLOCKS if f32 else BWD_DQ_BLOCKS,
                                  F32_BWD_BLOCKS if f32 else BWD_DKDV_BLOCKS)
        self.do = do
        self.dq, self.dk, self.dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        self.device, self.dtype = q.device, q.dtype
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, self.delta, *self.segs,
                                       self.dq, self.dk, self.dv)]
        self.args = ptrs + [B, S, Sk, Hq, Hkv, D, float(scale), float(scale * LOG2E), int(causal),
                            int(segment_ids is not None), *_dropout_args(dropout_rate, dropout_seed)]
        self.inputs = (q, k, v, lse)  # kept alive while the kernels may read them
        if f32:
            self.split()

    def split(self) -> None:
        """fp32: q, k, v and dO as their pieces, the kernels' operands."""
        self.pieces = split_pieces(*self.inputs[:3], self.do)
        self.args[:4] = [t.data_ptr() for t in self.pieces]

    def _launch(self, name: str) -> None:
        fn = _bwd_fn(name, self.dtype)
        with torch.cuda.device(self.device):
            err = fn(*self.args, torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")

    def launch_dkdv(self) -> None:
        global launches_bwd_dkdv
        self._launch("splash_attention_bwd_dkdv")
        launches_bwd_dkdv += 1
        _count("bwd_dkdv", self.inputs[0])

    def launch_dq(self) -> None:
        global launches_bwd_dq
        self._launch("splash_attention_bwd_dq")
        launches_bwd_dq += 1
        _count("bwd_dq", self.inputs[0])


def _kernel_backward(q, k, v, out, lse, do, dlse, segment_ids, kv_segment_ids, scale, causal,
                     cross_kv, dropout_rate, dropout_seed):
    call = BackwardCall(q, k, v, out, lse, do, dlse, segment_ids, kv_segment_ids, scale, causal,
                        cross_kv, dropout_rate, dropout_seed)
    call.launch_dkdv()
    call.launch_dq()
    return call.dq, call.dk, call.dv


# ------------------------------------------------------------------ dispatch


def _use_plain(q) -> bool:
    """True for CPU tensors (the plain versions), False for CUDA tensors (the
    kernels); any other device is refused."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"splash_attention runs on cpu (plain) or cuda (kernel), not {q.device}")
    return q.device.type == "cpu"


def _forward(q, k, v, segment_ids, kv_segment_ids, scale, causal, cross_kv, dropout_rate,
             dropout_seed):
    if _use_plain(q):
        return plain_forward(q, k, v, segment_ids, kv_segment_ids, scale, causal, dropout_rate,
                             dropout_seed)
    return _kernel_forward(q, k, v, segment_ids, kv_segment_ids, scale, causal, cross_kv,
                           dropout_rate, dropout_seed)


def _backward(ctx, do, dlse):
    q, k, v, out, lse, segment_ids, kv_segment_ids = ctx.saved_tensors
    scale, causal, cross_kv, dropout_rate, dropout_seed = ctx.static
    if _use_plain(q):
        return plain_backward(q, k, v, out, lse, do, dlse, segment_ids, kv_segment_ids, scale,
                              causal, dropout_rate, dropout_seed)
    return _kernel_backward(q, k, v, out, lse, do, dlse, segment_ids, kv_segment_ids, scale,
                            causal, cross_kv, dropout_rate, dropout_seed)


def _save(ctx, q, k, v, out, lse, segment_ids, kv_segment_ids, *static):
    ctx.save_for_backward(q, k, v, out, lse, segment_ids, kv_segment_ids)
    ctx.static = static


class _Splash(torch.autograd.Function):
    """out = splash(q, k, v); the JAX ``_splash`` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale, causal, dropout_rate, dropout_seed):
        out, lse = remat.saved(remat.FLASH, lambda: _forward(q, k, v, segment_ids, None, scale, causal, False,
                                                             dropout_rate, dropout_seed), q.device)
        _save(ctx, q, k, v, out, lse, segment_ids, None, scale, causal, False, dropout_rate,
              dropout_seed)
        return out

    @staticmethod
    def backward(ctx, do):
        return (*_backward(ctx, do, None), None, None, None, None, None)


class _SplashWithLse(torch.autograd.Function):
    """(out, lse) = splash(q, k, v) with the lse differentiable; the JAX
    ``_splash_lse`` custom_vjp (dlse enters delta)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, scale, causal, cross_kv, dropout_rate,
                dropout_seed):
        out, lse = remat.saved(remat.FLASH, lambda: _forward(q, k, v, segment_ids, kv_segment_ids, scale, causal,
                                                             cross_kv, dropout_rate, dropout_seed), q.device)
        _save(ctx, q, k, v, out, lse, segment_ids, kv_segment_ids, scale, causal, cross_kv,
              dropout_rate, dropout_seed)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_backward(ctx, do, dlse), None, None, None, None, None, None, None)


def _prepare(q, softmax_scale, dropout_rate, dropout_seed):
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("attention dropout needs dropout_seed")
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    return scale, (_norm_seed(dropout_seed) if dropout_rate > 0.0 else None)


def splash_attention(q, k, v, segment_ids=None, softmax_scale=None, causal=True,
                     max_segment_len=None, dropout_rate=0.0, dropout_seed=None):
    """q: (B, S, Hq, D); k/v: (B, Sk, Hkv, D); segment_ids: (B, S) int.
    Returns out (B, S, Hq, D), differentiable in q, k, v.  ``max_segment_len``
    is accepted for the API; the kernels need no static bound (module
    docstring)."""
    scale, seed = _prepare(q, softmax_scale, dropout_rate, dropout_seed)
    return _Splash.apply(q, k, v, segment_ids, scale, causal, float(dropout_rate), seed)


def splash_attention_with_lse(q, k, v, segment_ids=None, kv_segment_ids=None,
                              softmax_scale=None, causal=True, max_segment_len=None,
                              dropout_rate=0.0, dropout_seed=None):
    """Like ``splash_attention`` but returns (out, lse (B, Hq, S) fp32), both
    differentiable.  ``kv_segment_ids`` may differ from ``segment_ids`` (a
    rotated kv chunk); then segment windows are off and only the elementwise
    masks apply."""
    scale, seed = _prepare(q, softmax_scale, dropout_rate, dropout_seed)
    cross = kv_segment_ids is not None and kv_segment_ids is not segment_ids
    return _SplashWithLse.apply(q, k, v, segment_ids, kv_segment_ids, scale, causal, cross,
                                float(dropout_rate), seed)
