"""The kernels at the dtypes and head dims slice 11 added, against their
plain versions, on the card: the splash forward and backward in bf16 and
fp16 at head dims below and between the instantiated widths (16, 32, 80,
96, 120), and in fp32 (the same kernels on three bf16 pieces an operand)
at 16, 40 and 128, with GQA, segment runs across the tiles, dropout and an
lse cotangent; the fp32 backward run twice gives the same bits; the fp32
pieces' split kernel bit for bit its plain version; gmm, gmm dgrad and
tgmm with fp16 operands.

Needs an NVIDIA GPU with the CUDA toolkit; skips elsewhere.  On such a
machine:

    python -m pytest --noconftest tests/test_torch_coverage_cuda.py -q

Tolerances, relative L2 against the plain version: out as ``chip_smoke.py``
kernel_coverage holds it (10x its largest reading on an H100: bf16 3.1e-2,
fp16 3.9e-3, fp32 3.4e-6) and lse within 2e-5 (fp32 in both); the grads
bf16 1.6e-2, fp16 2e-3 and fp32 1e-4, looser than kernel_coverage's
because the random lse cotangent here enters delta and so every dS (bf16
read 2.8e-3 at head dim 16 on an H100); fp16 gmm 9.1e-4 (kernel_coverage's).
The counts by instantiation show which kernel ran.
"""

import numpy as np
import pytest
import torch

from internevo_tpu_torch.ops.cuda import gmm, pieces
from internevo_tpu_torch.ops.cuda import splash_attention as splash

pytestmark = pytest.mark.cuda

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
LIMITS = {"bf16": (3.1e-2, 1.6e-2), "f16": (3.9e-3, 2e-3), "f32": (3.4e-6, 1e-4)}
CASES = [("bf16", 16), ("bf16", 80), ("bf16", 120), ("f16", 32), ("f16", 96), ("f16", 16),
         ("f32", 16), ("f32", 40), ("f32", 128)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _segments(S, seed):
    rng = np.random.RandomState(seed)
    seg, p, sid = np.zeros((2, S), np.int32), 0, 1
    for b in range(2):
        p = 0
        while p < S:
            n = rng.randint(1, 300)
            seg[b, p:p + n], p, sid = sid, p + n, sid + 1
    return seg


@pytest.mark.parametrize("name,D", CASES, ids=[f"{n}-d{d}" for n, d in CASES])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_splash_instantiation_matches_plain(dev, name, D, rate):
    dtype, (out_lim, grad_lim) = DTYPES[name], LIMITS[name]
    S, Hq, Hkv = 777, 8, 2
    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v = (torch.randn(2, S, h, D, generator=g, device=dev).to(dtype) for h in (Hq, Hkv, Hkv))
    do = torch.randn(2, S, Hq, D, generator=g, device=dev).to(dtype)
    dlse = torch.randn(2, Hq, S, generator=g, device=dev)
    seg = torch.from_numpy(_segments(S, D)).to(dev)
    seed = splash._norm_seed([99, 3, 0, 1, 0]) if rate else None
    before = dict(splash.launches_by_case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = splash.splash_attention_with_lse(*leaves, seg, dropout_rate=rate, dropout_seed=seed)
    torch.autograd.backward((out, lse), (do, dlse))
    torch.cuda.synchronize()
    for kernel in ("fwd", "bwd_dkdv", "bwd_dq"):
        key = (kernel, name, D)
        assert splash.launches_by_case[key] == before.get(key, 0) + 1
    ref_out, ref_lse = splash.plain_forward(q, k, v, seg, None, None, True, rate, seed)
    want = splash.plain_backward(q, k, v, ref_out, ref_lse, do, dlse, seg, None, D**-0.5, True, rate, seed)
    assert out.dtype == dtype and torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = ~torch.isneginf(ref_lse)
    assert float((lse.detach() - ref_lse)[fin].abs().max()) <= 2e-5
    assert _rel(out, ref_out) <= out_lim
    for t, w in zip(leaves, want):
        assert t.grad.dtype == dtype and torch.isfinite(t.grad.float()).all()
        assert _rel(t.grad, w) <= grad_lim


def _runs_across_tiles(S):
    """Segment runs whose boundaries fall at many offsets inside the fp32
    kernels' 64-row tiles and the forward's 128-row items, and inside the
    32-row halves each backward consumer takes."""
    lengths = (193, 257, 65, 130, 301, 2, 127, 448, 63, 191, 33, 31)
    seg, p, i = np.zeros((1, S), np.int32), 0, 0
    while p < S:
        n = lengths[i % len(lengths)]
        seg[0, p:p + n], p, i = i + 1, p + n, i + 1
    return seg


# the structure of the fp32 instantiations (three pieces, 64-row backward
# items, 32-row consumer halves): S not a multiple of 64 or 128 (at 4000 the
# forward's last item has an empty second consumer), runs across the tiles,
# GQA with dropout, each 64-column chunk its own scale (the descriptors of
# each piece), inputs that ramp along the sequence (the fragments), no
# causal mask, and a rotated kv chunk
FP32_STRUCTURE = [(200, 2, 2, 64, "plain", 0.0, True), (4000, 2, 1, 128, "plain", 0.0, True),
                  (1111, 4, 1, 64, "runs", 0.0, True), (333, 8, 2, 128, "runs", 0.1, True),
                  (512, 2, 2, 128, "chunks", 0.0, True), (512, 2, 2, 128, "ramp", 0.0, True),
                  (512, 4, 2, 64, "ramp", 0.2, False), (1111, 4, 2, 128, "runs", 0.0, False),
                  (1111, 4, 2, 128, "cross", 0.0, True)]


@pytest.mark.parametrize("S,Hq,Hkv,D,variant,rate,causal", FP32_STRUCTURE,
                         ids=[f"S{c[0]}-d{c[3]}-{c[4]}-drop{c[5]}-{'causal' if c[6] else 'full'}"
                              for c in FP32_STRUCTURE])
def test_fp32_structure_matches_plain(dev, S, Hq, Hkv, D, variant, rate, causal):
    out_lim, grad_lim = LIMITS["f32"]
    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v = (torch.randn(1, S, h, D, generator=g, device=dev) for h in (Hq, Hkv, Hkv))
    do = torch.randn(1, S, Hq, D, generator=g, device=dev)
    seg = torch.from_numpy(_runs_across_tiles(S) if variant in ("runs", "cross") else _segments(S, S)[:1]).to(dev)
    if variant == "chunks":
        f = lambda sc: torch.tensor(sc, device=dev).repeat_interleave(64)  # noqa: E731
        q, k, v, do = q * f([1.0, 0.25]), k * f([0.5, 2.0]), v * f([3.0, 0.5]), do * f([0.2, 4.0])
    elif variant == "ramp":
        ramp = torch.linspace(0.2, 1.8, S, device=dev)[None, :, None, None]
        q, k = q * ramp, k * ramp.flip(1)
        v, do = v * torch.linspace(0.1, 2.0, D, device=dev), do * torch.linspace(2.0, 0.1, D, device=dev)
    kv_seg = torch.roll(seg, S // 3, dims=1) if variant == "cross" else None
    seed = splash._norm_seed([11, 0, 2, 0, 0]) if rate else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = splash.splash_attention_with_lse(*leaves, seg, kv_seg, causal=causal, dropout_rate=rate,
                                                dropout_seed=seed)
    lse_ok = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    torch.autograd.backward([out, lse_ok], [do, torch.zeros_like(lse)])
    torch.cuda.synchronize()
    ref_out, ref_lse = splash.plain_forward(q, k, v, seg, kv_seg, None, causal, rate, seed)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = ~torch.isneginf(ref_lse)
    assert float((lse.detach() - ref_lse)[fin].abs().max()) <= 2e-5
    assert _rel(out.detach(), ref_out) <= out_lim
    want = splash.plain_backward(q, k, v, ref_out, ref_lse, do, None, seg, kv_seg, D**-0.5, causal, rate, seed)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.float32 and torch.isfinite(t.grad).all()
        assert _rel(t.grad, w) <= grad_lim


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_fp32_backward_repeats_bitwise(dev, rate):
    """No atomics: every fp32 grad element is one fixed sequence of sums,
    the two consumers' partials added in one order."""
    S, Hq, Hkv, D = 1111, 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(1, S, h, D, generator=g, device=dev) for h in (Hq, Hkv, Hkv))
    do = torch.randn(1, S, Hq, D, generator=g, device=dev)
    seg = torch.from_numpy(_segments(S, 5)[:1]).to(dev)
    seed = splash._norm_seed([7, 0, 0, 0, 0]) if rate else None
    out, lse = splash.plain_forward(q, k, v, seg, None, None, True, rate, seed)
    runs = []
    for _ in range(2):
        call = splash.BackwardCall(q, k, v, out, lse, do, None, seg, None, D**-0.5, True, False, rate, seed)
        call.launch_dkdv()
        call.launch_dq()
        runs.append((call.dq, call.dk, call.dv))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_split_kernel_matches_plain(dev):
    x = torch.randn(3, 1000, 7, device=dev) * torch.logspace(-20, 20, 7, device=dev)
    y = torch.randn(513, device=dev)
    before = pieces.launches
    got = pieces.split_pieces(x, y)
    assert pieces.launches == before + 1
    for a, t in zip(got, (x, y)):
        assert torch.equal(a.view(torch.int16), pieces.plain_split(t).view(torch.int16))
        assert torch.equal((a[0].float() + a[1].float()) + a[2].float(), t)


@pytest.mark.parametrize("sizes", [[300, 300, 200, 200], [700, 0, 0, 300]], ids=["balanced", "empty"])
def test_gmm_fp16_matches_plain(dev, sizes):
    g = torch.Generator(device=dev).manual_seed(1)
    n, K, N, E = 1000, 256, 512, 4
    x = torch.randn(n, K, generator=g, device=dev).half()
    w = (0.05 * torch.randn(E, K, N, generator=g, device=dev)).half()
    dy = torch.randn(n, N, generator=g, device=dev).half()
    gs = torch.tensor(sizes, device=dev)
    before = dict(gmm.launches_by_case)
    for od in (torch.float16, torch.float32):
        assert _rel(gmm.gmm(x, w, gs, out_dtype=od), gmm.plain_gmm(x, w, gs, out_dtype=od)) <= 9.1e-4
        assert _rel(gmm.gmm(dy, w, gs, transpose_rhs=True, out_dtype=od),
                    gmm.plain_gmm(dy, w, gs, transpose_rhs=True, out_dtype=od)) <= 9.1e-4
        dw = gmm.tgmm(x, dy, gs, E, od)
        assert _rel(dw, gmm.plain_tgmm(x, dy, gs, E, od)) <= 9.1e-4
        assert all(not dw[e].any() for e in range(E - 1) if sizes[e] == 0)
    assert torch.equal(gmm.tgmm(x, dy, gs, E, torch.float16), gmm.tgmm(x, dy, gs, E).half())
    for kernel in ("gmm", "gmm_dgrad"):
        assert gmm.launches_by_case[(kernel, "f16")] == before.get((kernel, "f16"), 0) + 2
