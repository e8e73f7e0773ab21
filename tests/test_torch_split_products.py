"""The arithmetic of the fp32 splash kernels on the tensor cores, on the CPU:
an fp32 operand as three bf16 pieces (``ops/cuda/pieces.py``), a product as
the six bf16 terms of the pieces that fp32 accuracy needs, summed in fp32.

- The pieces sum back to the fp32 input bit for bit where they are normal
  numbers: randn at scales from 1e-20 to 1e30 (at 1e-30 the lo piece of
  the smaller values is subnormal and loses bits), and values on and
  beside the points where rounding to bf16 turns (a bf16 value plus half
  its ulp, and one fp32 step either side).
- The six-term product at the kernels' tile shapes (64 x 64 x D for S = Q
  Kᵀ, 64 x 64 x D for O = P V, D = 16 and 128), its terms summed in the
  kernels' order in fp32, stays within ``chip_smoke.py``'s kernel_coverage
  out limit for fp32 (relative L2 3.4e-6) of the fp64 product of the fp32
  inputs; left out, the three smallest terms are ~2^-24 of it.
- The plain fp32 splash forward fed the pieces' sum (the same bits) meets
  JAX's Pallas splash in interpret mode on the same numpy inputs, rtol =
  atol = 1e-4, as ``test_torch_coverage.py`` holds fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.ops.pallas import splash_attention as jsplash
from internevo_tpu_torch.ops.cuda import pieces
from internevo_tpu_torch.ops.cuda import splash_attention as tsplash
from internevo_tpu_torch.utils.common import FP32_EXACT_TERMS, device_peak_fp32_exact_tflops

# chip_smoke.py COVERAGE_LIMITS["f32"]["out"]: kernel vs plain, relative L2
F32_OUT_LIMIT = 3.4e-6
F32_TOL = dict(rtol=1e-4, atol=1e-4)
TILE = 64


def _sum(p: torch.Tensor) -> torch.Tensor:
    return (p[0].float() + p[1].float()) + p[2].float()


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e3, 1e30])
def test_pieces_sum_back_bitwise(scale):
    x = (torch.from_numpy(np.random.RandomState(7).randn(4096)) * scale).float()
    (p,) = pieces.split_pieces(x)
    assert p.shape == (3, 4096) and p.dtype == torch.bfloat16
    assert torch.equal(_sum(p), x)
    # each piece is at most half a bf16 ulp of the rest it was cut from
    assert bool((p[1].float().abs() <= x.abs() * 2.0**-8).all())
    assert bool((p[2].float().abs() <= (x - p[0].float()).abs() * 2.0**-8).all())


def test_pieces_sum_back_at_rounding_boundaries():
    """bf16 values plus half their ulp, where round-to-nearest-even turns,
    and the fp32 values one step either side, of both signs."""
    rng = np.random.RandomState(3)
    base = torch.from_numpy(rng.randn(2048)).float().to(torch.bfloat16).float()
    half_ulp = torch.ldexp(torch.ones_like(base), torch.frexp(base).exponent - 9)
    mid = base + half_ulp
    x = torch.cat([mid, torch.nextafter(mid, mid + 1), torch.nextafter(mid, mid - 1)])
    x = torch.cat([x, -x])
    (p,) = pieces.split_pieces(x)
    assert torch.equal(_sum(p), x)
    assert torch.equal(pieces.plain_split(x), p)


def _six_terms(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Σ a_i @ b_j over the kernels' terms, smallest first, in fp32."""
    out = torch.zeros(a3.shape[1], b3.shape[2], dtype=torch.float32)
    for i, j in pieces.TERMS:
        out += a3[i].float() @ b3[j].float()
    return out


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("product", ["q_kT", "p_v"])
def test_six_term_product_within_the_fp32_limit(product, D):
    rng = np.random.RandomState(D + len(product))
    if product == "q_kT":  # S = Q Kᵀ: 64 q rows, 64 kv rows, contraction D
        a = rng.randn(TILE, D).astype(np.float32)
        b = rng.randn(D, TILE).astype(np.float32)
    else:  # O = P V: softmax rows over a 64-row kv tile, contraction 64
        s = rng.randn(TILE, TILE) * 2
        a = (np.exp(s - s.max(1, keepdims=True)) / np.exp(s - s.max(1, keepdims=True)).sum(1, keepdims=True))
        a = a.astype(np.float32)
        b = rng.randn(TILE, D).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    a3, b3 = pieces.split_pieces(torch.from_numpy(a), torch.from_numpy(b))
    got = _six_terms(a3, b3).double().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= F32_OUT_LIMIT, rel
    # the hi piece alone (one bf16 product) is far outside it: the pieces matter
    hi = (a3[0].float() @ b3[0].float()).double().numpy()
    assert np.linalg.norm(hi - want) / np.linalg.norm(want) > 100 * F32_OUT_LIMIT


@pytest.mark.parametrize("D,layout", [(16, "bsd"), (64, "head_major"), (128, "bsd")])
def test_plain_forward_on_the_pieces_matches_jax(D, layout, monkeypatch):
    monkeypatch.setenv("IEVO_FLASH_BSD", "1" if layout == "bsd" else "0")
    B, S, HQ, HKV = 1, 128, 4, 2
    rng = np.random.RandomState(D)
    q, k, v = (rng.randn(B, S, h, D).astype(np.float32) for h in (HQ, HKV, HKV))
    seg = np.repeat(np.arange(1, 5, dtype=np.int32), S // 4)[None]
    oj, lj = jsplash.splash_attention_with_lse(*(jnp.asarray(x) for x in (q, k, v)), segment_ids=jnp.asarray(seg),
                                               block_q=TILE, block_k=TILE, interpret=True)
    summed = [_sum(p) for p in pieces.split_pieces(*(torch.from_numpy(x) for x in (q, k, v)))]
    assert all(torch.equal(t, torch.from_numpy(x)) for t, x in zip(summed, (q, k, v)))
    ot, lt = tsplash.plain_forward(*summed, torch.from_numpy(seg))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32_TOL)


def test_split_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="contiguous fp32"):
        pieces.launch(torch.empty(8, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="1 to 4 tensors"):
        pieces.launch(*(torch.empty(8, device="meta") for _ in range(5)))
    with pytest.raises(ValueError, match="cpu \\(plain\\) or cuda"):
        pieces.split_pieces(torch.empty(8, device="meta"))


def test_fp32_exact_peak():
    """The fp32 kernels' bound: the bf16 dense peak over the six terms."""
    assert FP32_EXACT_TERMS == len(pieces.TERMS) == 6
    assert device_peak_fp32_exact_tflops("NVIDIA H100 80GB HBM3") == pytest.approx(989.0 / 6)
    with pytest.raises(KeyError, match="bf16 peak"):
        device_peak_fp32_exact_tflops("NVIDIA A100-SXM4-80GB")
