"""The dtypes and head dims the port's kernels take since they follow the JAX
kernels': fp16 and fp32 besides bf16, and every head dim up to 128 that is a
multiple of 8.

On the CPU the wrappers run their plain versions, which the card holds each
kernel against (``chip_smoke.py`` kernel_coverage).  So here the plain
splash forward and backward, through the autograd Functions, meet JAX's
``splash_attention_with_lse`` and its vjp in interpret mode, in both of its
layouts (``IEVO_FLASH_BSD``: the (B, S, H·D) kernels and the head-major
ones), at head dims 16, 32 and 80, in fp16 and fp32, with GQA, packed
segments, dropout and an lse cotangent; the plain gmm and tgmm meet JAX's
``_gmm_call`` / ``_tgmm_call`` in fp16.  The input guards are held on meta
tensors (no card, no data): they take what a kernel takes and refuse what
none does.

Tolerances:
- fp32 splash: rtol = atol = 1e-4, as ``test_torch_splash_backward.py``
  (the same fp32 math summed in another order).
- fp16 splash out and lse: atol 2e-3 + rtol 2e-3.  JAX rounds the
  unnormalised p of its online softmax to fp16 before PV and divides by l
  after; the plain version rounds the normalised p: one fp16 rounding (2**-11
  relative) at another point for each term of the average.
- fp16 splash grads: 1e-2 of the largest element of each grad, elementwise,
  and a relative L2 of 5e-3: both round P∘drop and dS to fp16 (JAX from its
  online-softmax p), and dq, dk, dv once more; the grads sum up to 128
  products an element.
- fp16 gmm: the out rounds once to fp16 from fp32 sums in another order
  (one fp16 step, rtol 2**-10, atol 1e-3 where the out is near 0); tgmm's
  fp32 dW atol 2e-3 over 250-row sums, as ``test_torch_gmm.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.ops.pallas import splash_attention as jsplash
from internevo_tpu.ops.pallas.gmm import _gmm_call, _tgmm_call
from internevo_tpu_torch.ops.cuda import gmm
from internevo_tpu_torch.ops.cuda import splash_attention as tsplash
from internevo_tpu_torch.utils.common import device_peak_fp32_tflops

BLOCK = 64
B, S, HQ, HKV = 1, 128, 4, 2
F32_TOL = dict(rtol=1e-4, atol=1e-4)
F16_OUT_TOL = dict(rtol=2e-3, atol=2e-3)
F16_GRAD_MAX, F16_GRAD_REL_L2 = 1e-2, 5e-3
NP = {torch.float16: np.float16, torch.float32: np.float32}
JNP = {torch.float16: jnp.float16, torch.float32: jnp.float32}


def _segments(seed):
    rng = np.random.RandomState(seed)
    seg, pos, sid = np.zeros((B, S), np.int32), 0, 1
    while pos < S:
        n = rng.randint(20, 70)
        seg[0, pos:pos + n] = sid
        pos, sid = pos + n, sid + 1
    return seg


# (head dim, dtype, JAX layout, dropout rate): each head dim in both dtypes,
# each dtype in both layouts
SPLASH_CASES = [
    (16, torch.float16, "head_major", 0.1), (32, torch.float16, "bsd", 0.0), (80, torch.float16, "head_major", 0.0),
    (16, torch.float32, "bsd", 0.0), (32, torch.float32, "head_major", 0.1), (80, torch.float32, "bsd", 0.1),
]


@pytest.mark.parametrize("D,dtype,layout,rate", SPLASH_CASES,
                         ids=[f"d{d}-{str(t)[6:]}-{lay}-drop{r}" for d, t, lay, r in SPLASH_CASES])
def test_plain_splash_matches_jax(D, dtype, layout, rate, monkeypatch):
    monkeypatch.setenv("IEVO_FLASH_BSD", "1" if layout == "bsd" else "0")
    rng = np.random.RandomState(D + int(rate * 10))
    q, k, v = (rng.randn(B, S, h, D).astype(NP[dtype]) for h in (HQ, HKV, HKV))
    do = rng.randn(B, S, HQ, D).astype(NP[dtype])
    dlse = rng.randn(B, HQ, S).astype(np.float32)
    seg = _segments(D)
    kw = dict(dropout_rate=rate, dropout_seed=[77, 0, 0, 1, 0] if rate else None)

    (oj, lj), vjp = jax.vjp(lambda q_, k_, v_: jsplash.splash_attention_with_lse(
        q_, k_, v_, segment_ids=jnp.asarray(seg), block_q=BLOCK, block_k=BLOCK, interpret=True, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ot, lt = tsplash.splash_attention_with_lse(*ts, segment_ids=torch.from_numpy(seg), **kw)
    ((ot.float() * torch.from_numpy(do).float()).sum() + (lt * torch.from_numpy(dlse)).sum()).backward()
    assert ot.dtype == dtype and all(t.grad.dtype == dtype for t in ts)
    assert oj.dtype == JNP[dtype] and lj.dtype == jnp.float32

    if dtype == torch.float32:
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), **F32_TOL)
        np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), **F32_TOL)
        for t, w in zip(ts, jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **F32_TOL)
        return
    np.testing.assert_allclose(ot.detach().float().numpy(), np.asarray(oj, np.float32), **F16_OUT_TOL)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), **F16_OUT_TOL)
    for name, t, w in zip("qkv", ts, jgrads):
        got, want = t.grad.float().numpy(), np.asarray(w, np.float32)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= F16_GRAD_MAX * scale, f"d{name}"
        assert np.linalg.norm(got - want) <= F16_GRAD_REL_L2 * np.linalg.norm(want), f"d{name}"


@pytest.mark.parametrize("gs", [[250, 250, 250, 250], [600, 0, 300, 100]], ids=["balanced", "empty_group"])
def test_plain_gmm_fp16_matches_jax(gs):
    n, K, N, E = 1000, 256, 384, 4
    rng = np.random.RandomState(len(gs) + gs[1])
    x = rng.randn(n, K).astype(np.float16)
    w = (0.05 * rng.randn(E, K, N)).astype(np.float16)
    dy = rng.randn(n, N).astype(np.float16)
    gs_np = np.asarray(gs, np.int32)
    gs_t = torch.from_numpy(gs_np)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    jx, jw, jdy, jgs = (jnp.asarray(a) for a in (x, w, dy, gs_np))

    out = gmm.gmm(tx, tw, gs_t)
    want = _gmm_call(jx, jw, jgs, transpose_rhs=False, out_dtype=jnp.float16, interpret=True)
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), rtol=2.0**-10, atol=1e-3)

    dx = gmm.gmm(tdy, tw, gs_t, transpose_rhs=True)
    want = _gmm_call(jdy, jw, jgs, transpose_rhs=True, out_dtype=jnp.float16, interpret=True)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want, np.float32), rtol=2.0**-10, atol=1e-3)

    dw = gmm.tgmm(tx, tdy, gs_t, E)
    want = np.asarray(_tgmm_call(jx, jdy, jgs, E, interpret=True))
    np.testing.assert_allclose(dw.numpy(), want, atol=2e-3)
    assert not dw[1].any() if gs[1] == 0 else True
    # the grouped_matmul backward writes dW in w's dtype: the fp32 sums rounded once
    assert torch.equal(gmm.tgmm(tx, tdy, gs_t, E, out_dtype=torch.float16), dw.to(torch.float16))
    assert gmm.launches_gmm == gmm.launches_gmm_dgrad == gmm.launches_tgmm == 0


# ------------------------------------------------------------------- guards


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 80, 96, 120, 128])
def test_splash_guard_takes_the_kernels_dtypes_and_head_dims(dtype, D):
    q, k = _meta(2, 256, 8, D, dtype=dtype), _meta(2, 256, 2, D, dtype=dtype)
    tsplash._check_cuda_inputs(q, k, k, _meta(2, 256, dtype=torch.int32), None)


@pytest.mark.parametrize("D", [4, 12, 100, 136, 256])
def test_splash_guard_refuses_other_head_dims(D):
    q = _meta(1, 64, 2, D, dtype=torch.float16)
    with pytest.raises(ValueError, match=f"head_dim of at most 128 that is a multiple of 8.*not {D}"):
        tsplash._check_cuda_inputs(q, q, q, None, None)


@pytest.mark.parametrize("dtypes", [(torch.float64,) * 3, (torch.float16, torch.bfloat16, torch.float16),
                                    (torch.float32, torch.float32, torch.float16), (torch.int8,) * 3])
def test_splash_guard_refuses_other_dtypes(dtypes):
    q, k, v = (_meta(1, 64, 2, 64, dtype=t) for t in dtypes)
    with pytest.raises(TypeError, match="bf16, fp16 or fp32 q/k/v of one dtype"):
        tsplash._check_cuda_inputs(q, k, v, None, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gmm_guard_takes_bf16_and_fp16(dtype):
    x, w = _meta(512, 256, dtype=dtype), _meta(4, 256, 384, dtype=dtype)
    gmm._check_operand("x", x, 2, x)
    gmm._check_operand("w", w, 3, x)
    for out in (dtype, torch.float32):
        gmm._check_out(out, x, "gmm")


@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.float32, torch.float32), (torch.float16, torch.bfloat16),
                                             (torch.bfloat16, torch.float16), (torch.float64, torch.float64)])
def test_gmm_guard_refuses_other_operands(x_dtype, w_dtype):
    x, w = _meta(512, 256, dtype=x_dtype), _meta(4, 256, 384, dtype=w_dtype)
    with pytest.raises(TypeError, match="bf16 or fp16 operands of one dtype"):
        gmm._check_operand("x", x, 2, x)
        gmm._check_operand("w", w, 3, x)


def test_gmm_guard_refuses_other_outputs_and_dims():
    x = _meta(512, 256, dtype=torch.float16)
    with pytest.raises(TypeError, match="writes torch.float16 or fp32"):
        gmm._check_out(torch.bfloat16, x, "gmm")
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm._check_operand("w", _meta(4, 256, 100, dtype=torch.float16), 3, x)


def test_fp32_peak_table():
    """The CUDA cores' fp32 rate, which the fp32 kernels' CUDA-core bound
    beside their tensor-core bound uses (NVIDIA's H100 SXM data sheet)."""
    assert device_peak_fp32_tflops("NVIDIA H100 80GB HBM3") == 67.0
    with pytest.raises(KeyError, match="fp32 peak"):
        device_peak_fp32_tflops("NVIDIA A100-SXM4-80GB")
