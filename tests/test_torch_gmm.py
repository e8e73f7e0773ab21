"""The port's grouped matmul (``internevo_tpu_torch/ops/cuda/gmm.py``) on the
CPU, where its wrappers run the plain versions, against the JAX kernel
(``internevo_tpu/ops/pallas/gmm.py``, Pallas in interpret mode) and
``lax.ragged_dot``, with the cases of ``tests/test_ops/test_gmm.py``: empty
groups, one group owning every row, rows that are not a tile multiple, rows
past ``sum(group_sizes)``, bf16.

Tolerances, as there: forward atol 2e-5, dx 2e-4, dW 2e-3 (fp32 sums over a
few hundred rows in another order), and an empty group's dW exactly 0.  bf16
outputs: both sides sum in fp32 and round once, so they differ by at most one
bf16 step where the fp32 sums straddle a rounding boundary (rtol 2**-7)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from internevo_tpu.ops.pallas.gmm import _gmm_call, _tgmm_call, grouped_matmul as jax_grouped_matmul
from internevo_tpu_torch.ops.cuda import gmm

BF16_RTOL = 2.0**-7


def _inputs(n, K, N, E, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, K).astype(np.float32).astype(dtype)
    w = (0.05 * rng.randn(E, K, N)).astype(np.float32).astype(dtype)
    dy = rng.randn(n, N).astype(np.float32).astype(dtype)
    return x, w, dy


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _ragged(x, w, gs):
    return jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs), preferred_element_type=jnp.float32)


@pytest.mark.parametrize("gs", [
    [100, 0, 300, 50, 250, 0, 200, 100],  # empty groups
    [1000, 0, 0, 0, 0, 0, 0, 0],          # one group owns every row
    [125, 125, 125, 125, 125, 125, 125, 125],
], ids=["empty_groups", "one_group", "balanced"])
def test_plain_gmm_matches_jax(gs):
    n, K, N, E = 1000, 256, 384, 8
    gs = np.asarray(gs, np.int32)
    x, w, _ = _inputs(n, K, N, E)
    out = gmm.gmm(_t(x), _t(w), torch.from_numpy(gs)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                                                  jnp.asarray(gs), True)), atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(_ragged(x, w, gs)), atol=2e-5)
    assert gmm.launches_gmm == 0


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["fp32", "bf16"])
def test_grouped_matmul_grads_match_jax(dtype):
    """The autograd Function's backward (gmm with the rhs transposed, tgmm
    written in w's dtype) against ``jax.vjp`` of the Pallas kernel, whose dW
    is the fp32 tgmm cast to w's dtype, and in fp32 of ``ragged_dot``; group
    1 is empty, so its dW is exactly 0.  bf16: both sides round the same fp32
    sums once, so they differ by at most one bf16 step."""
    n, K, N, E = 512, 128, 256, 4
    gs = np.asarray([200, 0, 112, 200], np.int32)
    x, w, dy = _inputs(n, K, N, E, seed=1, dtype=dtype)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    gmm.grouped_matmul(xt, wt, torch.from_numpy(gs)).backward(_t(dy))
    jx, jw, jgs = jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)
    _, f_k = jax.vjp(lambda a, b: jax_grouped_matmul(a, b, jgs, True), jx, jw)
    refs = [f_k(jnp.asarray(dy))]
    if dtype == np.float32:
        refs.append(jax.vjp(lambda a, b: _ragged(a, b, jgs), jx, jw)[1](jnp.asarray(dy)))
    rtol = 0 if dtype == np.float32 else BF16_RTOL
    for dx_j, dw_j in refs:
        np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(dx_j, np.float32), rtol=rtol, atol=2e-4)
        np.testing.assert_allclose(wt.grad.float().numpy(), np.asarray(dw_j, np.float32), rtol=rtol, atol=2e-3)
    assert wt.grad.dtype == _t(w).dtype and float(wt.grad[1].float().abs().max()) == 0.0


def test_plain_gmm_bf16_row_padding():
    """n not a multiple of the TPU kernel's 128-row tile; bf16 in and out."""
    n, K, N, E = 300, 128, 128, 4
    gs = np.asarray([37, 120, 143, 0], np.int32)
    x, w, _ = _inputs(n, K, N, E, seed=2, dtype=ml_dtypes.bfloat16)
    out = gmm.gmm(_t(x), _t(w), torch.from_numpy(gs))
    assert out.shape == (n, N) and out.dtype == torch.bfloat16
    want = np.asarray(jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs), True), np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=BF16_RTOL, atol=1e-6)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(_ragged(x, w, gs)), atol=0.15)


def test_plain_gmm_rows_past_the_sum_use_the_last_group():
    """Rows past sum(group_sizes) meet the last group's weights, as the TPU
    kernel's padded rows do (``dropless.py:112-115``)."""
    n, K, N, E = 300, 128, 256, 4
    gs = np.asarray([37, 120, 100, 0], np.int32)
    x, w, _ = _inputs(n, K, N, E, seed=3)
    out = gmm.gmm(_t(x), _t(w), torch.from_numpy(gs)).numpy()
    want = np.asarray(jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs), True))
    np.testing.assert_allclose(out, want, atol=2e-5)
    np.testing.assert_allclose(out[257:], x[257:] @ w[3], atol=2e-5)


@pytest.mark.parametrize("gs", [[200, 0, 112, 200], [100, 50, 0, 90]], ids=["sum_n", "sum_below_n"])
def test_plain_gmm_transpose_rhs_matches_jax(gs):
    n, K, N, E = 512, 128, 256, 4
    gs = np.asarray(gs, np.int32)
    _, w, dy = _inputs(n, K, N, E, seed=4)
    out = gmm.gmm(_t(dy), _t(w), torch.from_numpy(gs), transpose_rhs=True).numpy()
    want = _gmm_call(jnp.asarray(dy), jnp.asarray(w), jnp.asarray(gs), transpose_rhs=True,
                     out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(out, np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("gs", [[200, 0, 112, 200], [100, 50, 0, 90]], ids=["sum_n", "sum_below_n"])
def test_plain_tgmm_matches_jax(gs):
    n, K, N, E = 512, 128, 256, 4
    gs = np.asarray(gs, np.int32)
    x, _, dy = _inputs(n, K, N, E, seed=5)
    out = gmm.tgmm(_t(x), _t(dy), torch.from_numpy(gs), E)
    assert out.dtype == torch.float32 and out.shape == (E, K, N)
    want = _tgmm_call(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gs), E, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-3)
    for e in np.flatnonzero(gs == 0):
        if e != E - 1:  # the last group also owns the rows past the sum
            assert float(out[e].abs().max()) == 0.0
    assert gmm.launches_tgmm == 0


def test_plain_tgmm_bf16_matches_jax_cast():
    """``plain_tgmm(out_dtype=bf16)`` is the fp32 sum rounded once, as JAX's
    ``_tgmm_call(...).astype(bf16)`` (the grouped_matmul backward's dW); bf16
    operands, an empty group, rows past the sum."""
    n, K, N, E = 300, 128, 256, 4
    gs = np.asarray([90, 0, 150, 40], np.int32)
    x, _, dy = _inputs(n, K, N, E, seed=8, dtype=ml_dtypes.bfloat16)
    out = gmm.tgmm(_t(x), _t(dy), torch.from_numpy(gs), E, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (E, K, N)
    want = _tgmm_call(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gs), E, interpret=True).astype(jnp.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), rtol=BF16_RTOL, atol=2e-3)
    assert float(out[1].float().abs().max()) == 0.0
    torch.testing.assert_close(out, gmm.plain_tgmm(_t(x), _t(dy), torch.from_numpy(gs), E).to(torch.bfloat16),
                               rtol=0, atol=0)


def test_gmm_refuses_other_devices():
    x = torch.zeros(16, 8, device="meta")
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        gmm.gmm(x, torch.zeros(2, 8, 8, device="meta"), torch.zeros(2, dtype=torch.int32, device="meta"))


def _row_owners(sizes, n):
    """The group of each of n rows under the plain rule: groups in order, the
    last one also owning the rows past the sum."""
    owners, start = np.empty(n, np.int64), 0
    for g, size in enumerate(gmm._host_sizes(torch.tensor(sizes), n)):
        owners[start:start + size] = g
        start += size
    return owners


@pytest.mark.parametrize("n,sizes", [
    (1000, [250, 250, 250, 250]),       # balanced, n not a tile multiple
    (8192, [6000, 0, 2000, 192]),       # skewed with an empty group
    (430, [0, 130, 300, 0]),            # empty first and last groups, several m-tiles each
    (600, [0, 130, 300, 0]),            # rows past the sum go to the (otherwise empty) last group
    (1, [0, 1, 0, 0]),                  # one row
    (512, [128, 128, 0, 256]),          # boundaries on tile edges
    (777, [5, 3, 1, 700, 0, 60, 8, 0]), # several groups inside one m-tile
    (300, [37, 120, 100, 0]),           # rows past the sum, last group otherwise empty
], ids=["balanced", "skewed_empty", "empty_ends", "rows_past_sum", "one_row", "tile_edges", "many_in_one_tile",
        "past_sum_small"])
def test_gmm_work_items_store_every_row_once_in_its_group(n, sizes):
    """Every row is stored by exactly one (group, m-tile) item, and that item's
    group is the row's own; a group boundary inside an m-tile costs one extra
    item at most.  Running the items as the kernel does (each tile's product
    with its group's weights, only rows [lo, hi) stored) gives plain_gmm."""
    E, tile = len(sizes), gmm.GMM_TILE_M
    items = gmm.gmm_work_items(np.cumsum(sizes).tolist(), n)
    stored = np.zeros(n, np.int64)
    owner = np.full(n, -1)
    for g, mt, lo, hi in items:
        rows = np.arange(max(lo, mt * tile), min(hi, mt * tile + tile))
        assert len(rows) > 0 and hi <= n
        stored[rows] += 1
        owner[rows] = g
    assert (stored == 1).all()
    np.testing.assert_array_equal(owner, _row_owners(sizes, n))
    assert len(items) <= -(-n // tile) + E - 1

    x, w, _ = _inputs(n, 16, 24, E, seed=6)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    out = torch.full((n, 24), float("nan"))
    for g, mt, lo, hi in items:
        tile_out = xt[mt * tile:mt * tile + tile] @ wt[g]
        a, b = max(lo, mt * tile), min(hi, mt * tile + tile)
        out[a:b] = tile_out[a - mt * tile:b - mt * tile]
    torch.testing.assert_close(out, gmm.plain_gmm(xt, wt, torch.tensor(sizes)), rtol=0, atol=1e-6)


def test_gmm_work_items_random_layouts():
    """The same ownership over random group sizes, with sums below n."""
    rng = np.random.RandomState(7)
    for _ in range(200):
        E = int(rng.randint(1, 9))
        n = int(rng.randint(1, 2000))
        sizes = rng.multinomial(int(rng.randint(0, n + 1)), rng.dirichlet(np.full(E, 0.3))).tolist()
        stored = np.zeros(n, np.int64)
        owner = np.full(n, -1)
        for g, mt, lo, hi in gmm.gmm_work_items(np.cumsum(sizes).tolist(), n):
            rows = np.arange(max(lo, mt * gmm.GMM_TILE_M), min(hi, (mt + 1) * gmm.GMM_TILE_M))
            stored[rows] += 1
            owner[rows] = g
        assert (stored == 1).all(), (n, sizes)
        np.testing.assert_array_equal(owner, _row_owners(sizes, n))


# ------------------------------------------------------------- tgmm walk

TGMM_LAYOUTS = [(n, sizes) for n, sizes in (
    (1000, [250, 250, 250, 250]), (8192, [6000, 0, 2000, 192]), (430, [0, 130, 300, 0]),
    (600, [0, 130, 300, 0]), (1, [0, 1, 0, 0]), (512, [128, 128, 0, 256]), (777, [5, 3, 1, 700, 0, 60, 8, 0]),
    (300, [37, 120, 100, 0]), (8192, [0, 0, 8192, 0]))]
TGMM_IDS = ["balanced", "skewed_empty", "empty_ends", "rows_past_sum", "one_row", "tile_edges", "many_in_one_tile",
            "past_sum_small", "one_group"]


def _check_tgmm_walk(n, sizes, K, N):
    """Each (expert, K-tile, N-tile) is listed exactly once; each item's
    slices cover its group's rows exactly once, from lo; an empty group's
    items run no slice; the groups own the rows the plain rule gives them."""
    E = len(sizes)
    items = gmm.tgmm_work_items(np.cumsum(sizes).tolist(), n, K, N)
    tiles_k, tiles_n = -(-K // gmm.GMM_TILE_M), -(-N // gmm.GMM_TILE_N)
    assert sorted((e, tk, tn) for e, tk, tn, _, _ in items) == [
        (e, tk, tn) for e in range(E) for tk in range(tiles_k) for tn in range(tiles_n)]
    spans = {(e, lo, hi) for e, _, _, lo, hi in items}
    assert sorted(e for e, _, _ in spans) == list(range(E))  # one row span an expert
    owner = np.full(n, -1)
    for e, lo, hi in spans:
        slices = gmm.tgmm_slices(lo, hi)
        covered = np.zeros(n, np.int64)
        for r0, rows in slices:
            assert 0 < rows <= gmm.GMM_SLICE and r0 + rows <= hi
            covered[r0:r0 + rows] += 1
        assert (covered[lo:hi] == 1).all() and covered.sum() == hi - lo
        assert (len(slices) == 0) == (lo == hi)
        owner[lo:hi] = e
    np.testing.assert_array_equal(owner, _row_owners(sizes, n))
    return items


@pytest.mark.parametrize("n,sizes", TGMM_LAYOUTS, ids=TGMM_IDS)
def test_tgmm_work_items_cover_every_tile_and_row_once(n, sizes):
    """At the two training directions' widths (4096 x 11008 and 11008 x
    4096, tiles that divide evenly) and at widths with partial tiles; and
    running the items as the kernel does (each slice's x rows past the
    group's end zeroed, dy as it is) gives plain_tgmm."""
    for K, N in ((4096, 11008), (11008, 4096), (200, 264)):
        _check_tgmm_walk(n, sizes, K, N)
    if n > 1000:
        return
    K, N = 136, 264
    x, _, dy = _inputs(n, K, N, len(sizes), seed=9)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    out = torch.full((len(sizes), K, N), float("nan"))
    tm, tn_ = gmm.GMM_TILE_M, gmm.GMM_TILE_N
    for e, tk, tn, lo, hi in _check_tgmm_walk(n, sizes, K, N):
        acc = torch.zeros(tm, tn_)
        for r0, rows in gmm.tgmm_slices(lo, hi):
            xs = torch.zeros(gmm.GMM_SLICE, tm)
            ys = torch.zeros(gmm.GMM_SLICE, tn_)
            xk = xt[r0:r0 + gmm.GMM_SLICE, tk * tm:tk * tm + tm]
            yk = dyt[r0:r0 + gmm.GMM_SLICE, tn * tn_:tn * tn_ + tn_]
            xs[:xk.shape[0], :xk.shape[1]] = xk
            ys[:yk.shape[0], :yk.shape[1]] = yk
            xs[rows:] = 0  # the edge mask
            acc += xs.T @ ys
        k1, n1 = min(K, tk * tm + tm), min(N, tn * tn_ + tn_)
        out[e, tk * tm:k1, tn * tn_:n1] = acc[:k1 - tk * tm, :n1 - tn * tn_]
    torch.testing.assert_close(out, gmm.plain_tgmm(xt, dyt, torch.tensor(sizes), len(sizes)), rtol=0, atol=1e-4)


def test_tgmm_work_items_random_layouts():
    """The same coverage over random group sizes, with sums below n."""
    rng = np.random.RandomState(10)
    for _ in range(100):
        E = int(rng.randint(1, 9))
        n = int(rng.randint(1, 2000))
        sizes = rng.multinomial(int(rng.randint(0, n + 1)), rng.dirichlet(np.full(E, 0.3))).tolist()
        _check_tgmm_walk(n, sizes, int(8 * rng.randint(1, 80)), int(8 * rng.randint(1, 80)))
