"""The kernels at the dtypes and head dims slice 11 added, against their
plain versions, on the card: the splash forward and backward in bf16 and
fp16 at head dims below and between the instantiated widths (16, 32, 80,
96, 120), and in fp32 (the CUDA-core kernels) at 16, 40 and 128, with GQA,
segment runs across the tiles, dropout and an lse cotangent; gmm, gmm
dgrad and tgmm with fp16 operands.

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

from internevo_tpu_torch.ops.cuda import gmm
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
