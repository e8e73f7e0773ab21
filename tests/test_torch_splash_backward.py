"""The splash backward of the port on the CPU -- ``plain_backward`` and the
autograd path through ``splash_attention`` / ``splash_attention_with_lse`` --
against ``jax.vjp`` of the JAX splash kernel in interpret mode (blocks of
64), on the same numpy inputs and cotangents, in fp32.

Tolerance rtol = atol = 1e-4: the same math in fp32, summed in another order;
the gradients sum up to a few hundred products per element.  The dropout mask
is the bit-identical counter hash, so dropout cases use the same bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.ops.pallas import splash_attention as jsplash
from internevo_tpu_torch.ops.cuda import splash_attention as tsplash

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = 64


def _packed_segments(B, S, max_len, seed=0):
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


def _inputs(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(B, S, Hq, D), f(B, S, Hkv, D), f(B, S, Hkv, D), f(B, S, Hq, D), f(B, Hq, S)


def _jax_vjp(fn, q, k, v, cot, **kw):
    out, vjp = jax.vjp(lambda q_, k_, v_: fn(q_, k_, v_, **kw, block_q=BLOCK, block_k=BLOCK,
                                             interpret=True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, vjp(cot)


def _torch_grads(fn, q, k, v, cots, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * c).sum() for o, c in zip(outs, cots) if c is not None)
    loss.backward()
    return out, [t.grad for t in ts]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (4, 1)], ids=["gqa1", "gqa2", "gqa4"])
def test_autograd_matches_jax_vjp(causal, hq, hkv):
    q, k, v, do, _ = _inputs(2, 192, hq, hkv, 64, seed=hq * 3 + hkv)
    seg = _packed_segments(2, 192, 80, seed=hq)
    _, jgrads = _jax_vjp(jsplash.splash_attention, q, k, v, jnp.asarray(do),
                         segment_ids=jnp.asarray(seg), causal=causal, max_segment_len=80)
    _, tgrads = _torch_grads(tsplash.splash_attention, q, k, v, [torch.from_numpy(do)],
                             segment_ids=torch.from_numpy(seg), causal=causal)
    _close(tgrads, jgrads)


def test_no_segments_matches_jax_vjp():
    q, k, v, do, _ = _inputs(1, 128, 2, 2, 128, seed=7)
    _, jgrads = _jax_vjp(jsplash.splash_attention, q, k, v, jnp.asarray(do))
    _, tgrads = _torch_grads(tsplash.splash_attention, q, k, v, [torch.from_numpy(do)])
    _close(tgrads, jgrads)


@pytest.mark.parametrize("seed", [1234, [7, 64, 0, 2, 1]], ids=["scalar", "offsets"])
def test_dropout_with_lse_matches_jax_vjp(seed):
    """Dropout and the lse cotangent together: delta carries dlse, and the
    backward regenerates the forward's mask."""
    q, k, v, do, dlse = _inputs(2, 128, 4, 2, 64, seed=11)
    seg = _packed_segments(2, 128, 64, seed=2)
    kw = dict(dropout_rate=0.25, dropout_seed=seed)
    (oj, lj), jgrads = _jax_vjp(jsplash.splash_attention_with_lse, q, k, v,
                                (jnp.asarray(do), jnp.asarray(dlse)), segment_ids=jnp.asarray(seg), **kw)
    (ot, lt), tgrads = _torch_grads(tsplash.splash_attention_with_lse, q, k, v,
                                    [torch.from_numpy(do), torch.from_numpy(dlse)],
                                    segment_ids=torch.from_numpy(seg), **kw)
    _close([ot, lt], [oj, lj])
    _close(tgrads, jgrads)


def test_cross_kv_empty_rows_match_jax_vjp():
    """A rotated kv chunk: rows with no visible key get zero dq, and the lse
    cotangent of those rows (lse = -inf) is ignored."""
    q, k, v, do, dlse = _inputs(1, 128, 2, 1, 64, seed=3)
    seg = np.repeat(np.array([[1, 2]], np.int32), 64, axis=1)
    kv_seg = np.full((1, 128), 2, np.int32)
    (_, lj), jgrads = _jax_vjp(jsplash.splash_attention_with_lse, q, k, v,
                               (jnp.asarray(do), jnp.asarray(dlse)),
                               segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(kv_seg))
    (_, lt), tgrads = _torch_grads(tsplash.splash_attention_with_lse, q, k, v,
                                   [torch.from_numpy(do), torch.from_numpy(dlse)],
                                   segment_ids=torch.from_numpy(seg),
                                   kv_segment_ids=torch.from_numpy(kv_seg))
    assert np.isneginf(np.asarray(lj))[..., :64].all()
    np.testing.assert_array_equal(tgrads[0].numpy()[:, :64], 0.0)
    _close(tgrads, jgrads)


def test_plain_backward_matches_jax_vjp():
    """``plain_backward`` called directly on the forward's residuals, GQA 2,
    packed segments, with dlse."""
    q, k, v, do, dlse = _inputs(1, 192, 4, 2, 64, seed=5)
    seg = _packed_segments(1, 192, 70, seed=5)
    (_, _), jgrads = _jax_vjp(jsplash.splash_attention_with_lse, q, k, v,
                              (jnp.asarray(do), jnp.asarray(dlse)), segment_ids=jnp.asarray(seg))
    T = torch.from_numpy
    out, lse = tsplash.plain_forward(T(q), T(k), T(v), T(seg))
    tgrads = tsplash.plain_backward(T(q), T(k), T(v), out, lse, T(do), T(dlse), T(seg))
    _close(tgrads, jgrads)


@pytest.mark.parametrize("block", [32, 64, tsplash.BWD_DKDV_BLOCKS, tsplash.BWD_DQ_BLOCKS])
def test_q_hi_matches_segment_windows(block):
    """Square blocks, and the backward kernels' (q, kv) blocks (64, 128) and
    (128, 64) on a length 128 does not divide: there the JAX function's
    strided slice has no entry for the ragged last kv block, which reads the
    run end at token S - 1."""
    block_q, block_k = (block, block) if isinstance(block, int) else block
    S = 512 if isinstance(block, int) else 576
    seg = _packed_segments(3, S, 100, seed=5)
    seg[1, 400:] = 0  # zero-padded tail
    kv_lo, q_hi = tsplash._segment_windows(torch.from_numpy(seg), torch.from_numpy(seg), block_q, block_k)
    ref_lo, ref_hi = jsplash._segment_windows(jnp.asarray(seg), jnp.asarray(seg), block_q, block_k)
    np.testing.assert_array_equal(kv_lo.numpy(), np.asarray(ref_lo))
    n = np.asarray(ref_hi).shape[1]
    assert q_hi.shape == (3, -(-S // block_k))
    np.testing.assert_array_equal(q_hi.numpy()[:, :n], np.asarray(ref_hi))
    np.testing.assert_array_equal(q_hi.numpy()[:, n:], (S - 1) // block_q)


@pytest.mark.parametrize("segments,cross", [(True, False), (True, True), (False, False)],
                         ids=["windows", "cross_kv", "no_segments"])
def test_backward_segment_args(segments, cross):
    """The backward's control data: kv_lo at the dQ kernel's (128, 64)
    blocks, q_hi at the dK/dV kernel's (64, 128); windows off (kv_lo 0, q_hi
    the last 64-row q tile) without segments or for cross kv."""
    B, S = 2, 333
    seg = torch.from_numpy(_packed_segments(B, S, 90, seed=2))
    q = k = torch.zeros(B, S, 1, 64)
    _, _, kv_lo, q_hi = tsplash._segment_args(q, k, seg if segments else None, None, cross,
                                              tsplash.BWD_DQ_BLOCKS, tsplash.BWD_DKDV_BLOCKS)
    assert kv_lo.shape == (B, 3) and q_hi.shape == (B, 3)
    assert kv_lo.dtype == q_hi.dtype == torch.int32
    if segments and not cross:
        torch.testing.assert_close(kv_lo, tsplash._segment_windows(seg, seg, 128, 64)[0].int())
        torch.testing.assert_close(q_hi, tsplash._segment_windows(seg, seg, 64, 128)[1].int())
    else:
        assert (kv_lo == 0).all() and (q_hi == -(-S // 64) - 1).all()


def test_q_hi_ragged_last_block():
    """Where 64 does not divide S, the partial last kv block reads the run
    end at token S - 1 (the JAX function only takes lengths its blocks
    divide)."""
    seg = np.ones((1, 200), np.int32)
    seg[:, 150:] = 2
    _, q_hi = tsplash._segment_windows(torch.from_numpy(seg), torch.from_numpy(seg), 64, 64)
    np.testing.assert_array_equal(q_hi.numpy(), [[2, 2, 3, 3]])
