"""The CUDA grouped-matmul kernels (gmm forward, gmm with the rhs transposed,
tgmm) against their plain versions, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernels have no CPU mode);
skips elsewhere.  On such a machine:

    python -m pytest --noconftest tests/test_torch_gmm_cuda.py -q

(``--noconftest``: the repo's conftest imports jax, which such a machine need
not have.)

Tolerances: bf16 outputs within rtol = atol = 1.6e-2 (both sum bf16 products
in fp32 and round once; the sums run in another order, so a value near a
rounding boundary may land one bf16 step away), fp32 outputs within 1e-5 of
each tensor's scale; an empty group's dW is exactly 0.  tgmm's bf16 dW is
the rounding of the same kernel's fp32 dW, so the two are compared exactly.
"""

import pytest
import torch

from internevo_tpu_torch.ops.cuda import gmm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gmm kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 matmuls in full fp32
    return torch.device("cuda")


def _inputs(dev, n, K, N, E, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, K, generator=g, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn(E, K, N, generator=g, device=dev)).to(torch.bfloat16)
    dy = torch.randn(n, N, generator=g, device=dev).to(torch.bfloat16)
    return x, w, dy


def _close_f32(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))  # exact for want == 0


# (n, K, N, group sizes); the forward contracts K into N columns, the dgrad
# (transpose_rhs) N into K columns
CASES = {
    "balanced": (1000, 256, 384, [250, 250, 250, 250]),
    "empty_groups": (1000, 256, 384, [100, 0, 600, 300]),
    "one_group": (777, 128, 264, [0, 0, 777, 0]),
    "rows_past_the_sum": (300, 136, 128, [37, 120, 100, 0]),
    "ragged_tiles": (1, 40, 24, [0, 1, 0, 0]),
    # the Hopper mainloop's edges: a contraction that is not a multiple of its
    # 64-deep slice (zero-filled inside the expert), output widths that are
    # not a multiple of its 256-column tile, n not a multiple of its 128-row
    # tile, groups straddling several m-tiles with the first and last empty,
    # and rows past the sum
    "contraction_tail_200": (700, 200, 256, [300, 0, 250, 150]),
    "width_264": (640, 128, 264, [200, 200, 40, 200]),
    "width_24": (333, 64, 24, [100, 100, 100, 33]),
    "rows_not_tile_multiple": (333, 256, 512, [111, 111, 111, 0]),
    "straddling_empty_ends": (430, 192, 320, [0, 130, 300, 0]),
    "rows_past_the_sum_many_tiles": (900, 128, 256, [0, 300, 200, 0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gmm_kernels_match_plain(dev, case):
    n, K, N, gs = CASES[case]
    x, w, dy = _inputs(dev, n, K, N, len(gs))
    group_sizes = torch.tensor(gs, device=dev)
    before = (gmm.launches_gmm, gmm.launches_gmm_dgrad, gmm.launches_tgmm)
    out = gmm.gmm(x, w, group_sizes)
    dx = gmm.gmm(dy, w, group_sizes, transpose_rhs=True)
    out32 = gmm.gmm(x, w, group_sizes, out_dtype=torch.float32)
    dx32 = gmm.gmm(dy, w, group_sizes, transpose_rhs=True, out_dtype=torch.float32)
    dw = gmm.tgmm(x, dy, group_sizes, len(gs))
    torch.cuda.synchronize()
    assert (gmm.launches_gmm, gmm.launches_gmm_dgrad, gmm.launches_tgmm) == (before[0] + 2, before[1] + 2,
                                                                              before[2] + 1)
    assert out.dtype == dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    torch.testing.assert_close(out.float(), gmm.plain_gmm(x, w, group_sizes).float(), rtol=1.6e-2, atol=1.6e-2)
    torch.testing.assert_close(dx.float(), gmm.plain_gmm(dy, w, group_sizes, transpose_rhs=True).float(),
                               rtol=1.6e-2, atol=1.6e-2)
    _close_f32(out32, gmm.plain_gmm(x, w, group_sizes, out_dtype=torch.float32))
    _close_f32(dx32, gmm.plain_gmm(dy, w, group_sizes, transpose_rhs=True, out_dtype=torch.float32))
    _close_f32(dw, gmm.plain_tgmm(x, dy, group_sizes, len(gs)))
    for e, size in enumerate(gs[:-1]):
        if size == 0:
            assert bool((dw[e] == 0).all()), e


def _check_tgmm(x, dy, group_sizes, E):
    """tgmm with fp32 and bf16 output against plain_tgmm; the bf16 dW is the
    fp32 dW rounded, bit for bit; an empty group's dW is exactly 0."""
    before = gmm.launches_tgmm
    dw32 = gmm.tgmm(x, dy, group_sizes, E)
    dw16 = gmm.tgmm(x, dy, group_sizes, E, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert gmm.launches_tgmm == before + 2
    assert dw32.dtype == torch.float32 and dw16.dtype == torch.bfloat16
    want = gmm.plain_tgmm(x, dy, group_sizes, E)
    for e in range(E):  # each expert at its own scale; bf16: the fp32 bound and one rounding
        _close_f32(dw32[e], want[e])
        torch.testing.assert_close(dw16[e].float(), want[e].to(torch.bfloat16).float(), rtol=1.6e-2,
                                   atol=1.6e-2 + 1e-5 * float(want[e].abs().max()))
    assert torch.equal(dw16, dw32.to(torch.bfloat16))
    for e, size in enumerate(group_sizes.tolist()[:-1]):
        if size == 0:
            assert bool((dw32[e] == 0).all()) and bool((dw16[e] == 0).all()), e


@pytest.mark.parametrize("case", list(CASES))
def test_tgmm_kernel_matches_plain(dev, case):
    n, K, N, gs = CASES[case]
    x, _, dy = _inputs(dev, n, K, N, len(gs), seed=3)
    _check_tgmm(x, dy, torch.tensor(gs, device=dev), len(gs))


def test_tgmm_reads_each_feature_chunk(dev):
    """x^T is the MN-major A operand: each consumer reads its own 64-feature
    box of the K-tile.  Every 64-column chunk of x carries its own scale, so
    a descriptor that reads another chunk, or the wrong stride inside one,
    moves whole rows of dW."""
    n, K, N = 640, 320, 512
    x, _, dy = _inputs(dev, n, K, N, 2, seed=4)
    scale = (torch.arange(K, device=dev) // 64 + 1).to(torch.bfloat16)
    _check_tgmm((x * scale).contiguous(), dy, torch.tensor([300, 340], device=dev), 2)


def test_tgmm_masks_the_next_group_inside_a_slice(dev):
    """Group ends inside a 64-row slice (100 = 64 + 36, 230 = 228 + 2): the
    last slice of groups 0 and 1 also loads the next group's rows.  Rows from
    100 on carry x and dy 1e3 times larger, so without the edge mask the next
    group's products swamp dW[0] (by ~1e6) and move dW[1] by about half."""
    n, K, N = 512, 128, 256
    x, _, dy = _inputs(dev, n, K, N, 3, seed=5)
    big = torch.ones(n, 1, device=dev, dtype=torch.bfloat16)
    big[100:] = 1e3
    _check_tgmm((x * big).contiguous(), (dy * big).contiguous(), torch.tensor([100, 130, 282], device=dev), 3)


def test_tgmm_of_no_rows_is_zero(dev):
    x, _, dy = _inputs(dev, 64, 128, 256, 2, seed=6)
    group_sizes = torch.zeros(2, dtype=torch.int64, device=dev)
    before = gmm.launches_tgmm
    for out_dtype in (torch.float32, torch.bfloat16):
        dw = gmm.tgmm(x[:0], dy[:0], group_sizes, 2, out_dtype=out_dtype)
        assert dw.shape == (2, 128, 256) and dw.dtype == out_dtype and not bool(dw.any())
    assert gmm.launches_tgmm == before


def test_grouped_matmul_backward_launches_the_kernels(dev):
    x, w, dy = _inputs(dev, 512, 128, 256, 4, seed=1)
    group_sizes = torch.tensor([200, 0, 112, 200], device=dev)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (gmm.launches_gmm, gmm.launches_gmm_dgrad, gmm.launches_tgmm)
    gmm.grouped_matmul(xg, wg, group_sizes).backward(dy)
    torch.cuda.synchronize()
    assert (gmm.launches_gmm, gmm.launches_gmm_dgrad, gmm.launches_tgmm) == tuple(b + 1 for b in before)
    assert xg.grad.dtype == wg.grad.dtype == torch.bfloat16
    torch.testing.assert_close(xg.grad.float(), gmm.plain_gmm(dy, w, group_sizes, transpose_rhs=True).float(),
                               rtol=1.6e-2, atol=1.6e-2)
    torch.testing.assert_close(wg.grad.float(), gmm.plain_tgmm(x, dy, group_sizes, 4).to(torch.bfloat16).float(),
                               rtol=1.6e-2, atol=1.6e-2)
    assert torch.equal(wg.grad, gmm.tgmm(x, dy, group_sizes, 4).to(torch.bfloat16))  # no separate cast pass
    assert float(wg.grad[1].float().abs().max()) == 0.0


def test_gmm_is_deterministic(dev):
    x, w, dy = _inputs(dev, 1024, 256, 512, 4, seed=2)
    group_sizes = torch.tensor([500, 24, 0, 500], device=dev)
    assert torch.equal(gmm.gmm(x, w, group_sizes), gmm.gmm(x, w, group_sizes))
    assert torch.equal(gmm.gmm(dy, w, group_sizes, transpose_rhs=True),
                       gmm.gmm(dy, w, group_sizes, transpose_rhs=True))
    assert torch.equal(gmm.tgmm(x, dy, group_sizes, 4), gmm.tgmm(x, dy, group_sizes, 4))
    assert torch.equal(gmm.tgmm(x, dy, group_sizes, 4, out_dtype=torch.bfloat16),
                       gmm.tgmm(x, dy, group_sizes, 4, out_dtype=torch.bfloat16))


def test_gmm_refuses_what_it_does_not_take(dev):
    x, w, _ = _inputs(dev, 64, 128, 128, 2)
    group_sizes = torch.tensor([32, 32], device=dev)
    with pytest.raises(TypeError, match="bf16 or fp16"):
        gmm.gmm(x.float(), w.float(), group_sizes)
    with pytest.raises(TypeError, match="of one dtype"):
        gmm.gmm(x.half(), w, group_sizes)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm.gmm(x[:, :100].contiguous(), w[:, :100].contiguous(), group_sizes)
    with pytest.raises(ValueError, match="contiguous"):
        gmm.gmm(x.t().contiguous().t(), w, group_sizes)
    with pytest.raises(ValueError, match="group_sizes"):
        gmm.gmm(x, w, group_sizes.cpu())
