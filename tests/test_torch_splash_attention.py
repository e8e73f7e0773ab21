"""The port's splash module on the CPU (its plain version and its control
data) against the JAX splash kernel in interpret mode, on the same numpy
inputs.  Tolerance 2e-5, as the JAX splash tests use; the dropout mask is
compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.ops.pallas import splash_attention as jsplash
from internevo_tpu_torch.ops.cuda import splash_attention as tsplash

TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK = 64


def _packed_segments(B, S, max_len, seed=0):
    """Contiguous runs, none longer than max_len (cut-packing)."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((B, S), dtype=np.int32)
    for b in range(B):
        pos, sid = 0, 1
        while pos < S:
            n = rng.randint(max(1, max_len // 3), max_len + 1)
            seg[b, pos:pos + n] = sid
            pos += n
            sid += 1
    return seg


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, Hq, D).astype(np.float32), rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32))


def _both(fn_j, fn_t, arrays, **kw):
    j = fn_j(*[None if a is None else jnp.asarray(a) for a in arrays], **kw,
             block_q=BLOCK, block_k=BLOCK, interpret=True)
    kw.pop("max_segment_len", None)
    t = fn_t(*[None if a is None else torch.from_numpy(a) for a in arrays], **kw)
    return j, t


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("max_seg", [None, 96])
def test_forward_matches_jax(causal, max_seg):
    q, k, v = _qkv(2, 256, 2, 2, 64)
    seg = _packed_segments(2, 256, 96)
    j, t = _both(jsplash.splash_attention, tsplash.splash_attention, (q, k, v, seg),
                 causal=causal, max_segment_len=max_seg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (4, 1)])
def test_gqa_with_lse_matches_jax(hq, hkv):
    q, k, v = _qkv(1, 192, hq, hkv, 64, seed=hq + hkv)
    seg = _packed_segments(1, 192, 80, seed=1)
    (oj, lj), (ot, lt) = _both(jsplash.splash_attention_with_lse, tsplash.splash_attention_with_lse,
                               (q, k, v, seg), max_segment_len=80)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_no_segments_matches_jax():
    q, k, v = _qkv(1, 128, 2, 2, 128)
    j, t = _both(jsplash.splash_attention, tsplash.splash_attention, (q, k, v))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_cross_kv_fully_masked_rows():
    """Rotated kv chunk: rows with no visible key give out 0 and lse -inf."""
    q, k, v = _qkv(1, 128, 2, 1, 64, seed=3)
    seg = np.repeat(np.array([[1, 2]], np.int32), 64, axis=1)
    kv_seg = np.full((1, 128), 2, np.int32)
    (oj, lj), (ot, lt) = _both(jsplash.splash_attention_with_lse, tsplash.splash_attention_with_lse,
                               (q, k, v, seg, kv_seg))
    empty = np.isneginf(np.asarray(lj))
    assert empty[..., :64].all() and not empty[..., 64:].any()
    np.testing.assert_array_equal(np.isneginf(lt.numpy()), empty)
    np.testing.assert_allclose(lt.numpy()[~empty], np.asarray(lj)[~empty], **TOL)
    np.testing.assert_array_equal(ot.numpy()[:, :64], 0.0)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)


def test_nonmonotonic_pad_ids():
    """Eval-style [real | pad 0] rows with the boundary mid-block."""
    q, k, v = _qkv(1, 256, 2, 2, 64, seed=4)
    seg = np.zeros((1, 256), np.int32)
    seg[:, :160] = 1
    j, t = _both(jsplash.splash_attention, tsplash.splash_attention, (q, k, v, seg), max_segment_len=256)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_array_equal(
        tsplash._segment_windows(torch.from_numpy(seg), torch.from_numpy(seg), BLOCK, BLOCK)[0].numpy(),
        np.asarray(jsplash._segment_windows(jnp.asarray(seg), jnp.asarray(seg), BLOCK, BLOCK)[0]))


@pytest.mark.parametrize("block_q,block_k,S", [
    pytest.param(32, 32, 512, id="32"),
    pytest.param(64, 64, 512, id="64"),
    # the forward kernel's blocks, the last q block ragged (500 = 3 * 128 + 116)
    pytest.param(tsplash.BLOCK_Q, tsplash.BLOCK_K, 500, id="forward"),
])
def test_kv_lo_matches_segment_windows(block_q, block_k, S):
    seg = _packed_segments(3, S, 100, seed=5)
    seg[1, 400:] = 0  # zero-padded tail
    kv_lo = tsplash._segment_windows(torch.from_numpy(seg), torch.from_numpy(seg), block_q, block_k)[0]
    ref = jsplash._segment_windows(jnp.asarray(seg), jnp.asarray(seg), block_q, block_k)[0]
    assert kv_lo.shape == (3, -(-S // block_q))
    np.testing.assert_array_equal(kv_lo.numpy(), np.asarray(ref))


@pytest.mark.parametrize("segments,cross", [(True, False), (True, True), (False, False)],
                         ids=["windows", "cross_kv", "no_segments"])
def test_forward_call_control_is_kv_lo(monkeypatch, segments, cross):
    """The forward kernel's control data is (q_seg, kv_seg, kv_lo) alone, kv_lo
    at its (128, 64) blocks as the JAX function computes it; windows off (kv_lo
    0) without segments or for cross kv.  Built by ``ForwardCall`` on CPU
    tensors, with the library's loader stubbed: nothing is launched."""
    assert (tsplash.BLOCK_Q, tsplash.BLOCK_K) == (128, 64)
    monkeypatch.setattr(tsplash, "load", lambda source: None)
    B, S = 2, 333
    seg = _packed_segments(B, S, 90, seed=2)
    q = k = v = torch.zeros(B, S, 2, 64, dtype=torch.bfloat16)
    seg_t = torch.from_numpy(seg) if segments else None
    kv_seg = torch.roll(seg_t, 5, dims=1) if cross else None
    call = tsplash.ForwardCall(q, k, v, seg_t, kv_seg, 0.125, True, cross, 0.0, None)
    assert len(call.segs) == 3
    q_seg, kv_seg_arg, kv_lo = call.segs
    assert kv_lo.shape == (B, 3) and kv_lo.dtype == q_seg.dtype == kv_seg_arg.dtype == torch.int32
    assert [t.data_ptr() for t in call.segs] == call.args[3:6]
    if segments and not cross:
        ref = jsplash._segment_windows(jnp.asarray(seg), jnp.asarray(seg), 128, 64)[0]
        np.testing.assert_array_equal(kv_lo.numpy(), np.asarray(ref))
    else:
        assert (kv_lo == 0).all()


@pytest.mark.parametrize("seed", [1234, [7, 64, 0, 2, 1]])
def test_dropout_matches_jax(seed):
    q, k, v = _qkv(2, 128, 4, 2, 64, seed=6)
    seg = _packed_segments(2, 128, 64, seed=2)
    (oj, lj), (ot, lt) = _both(jsplash.splash_attention_with_lse, tsplash.splash_attention_with_lse,
                               (q, k, v, seg), dropout_rate=0.25, dropout_seed=seed)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("seed", [7, np.array([3, 100, -5, 2, 9], np.int32), -123456789],
                         ids=["scalar", "offsets", "negative"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_bitwise(seed, rate):
    mj = np.asarray(jsplash.dropout_mask_dense(rate, seed, 2, 3, 33, 70))
    mt = tsplash.dropout_mask_dense(rate, seed, 2, 3, 33, 70).numpy()
    assert mt.dtype == mj.dtype == np.float32
    np.testing.assert_array_equal(mt.view(np.uint32), mj.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(tsplash._norm_seed(seed)), np.asarray(jsplash._norm_seed(seed)))
