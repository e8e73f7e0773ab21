"""Gradients of the port's ops against ``jax.grad`` of the JAX ops, on the
same numpy inputs, in fp32: the fused norm + head + CE (chunk recompute and
save-logits, ragged last chunk, label smoothing, embed_grad_scale, norm_head),
RMSNorm/LayerNorm and rotary.  Tolerance rtol = atol = 1e-5: the same math
summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.ops import fused_ce as jfce
from internevo_tpu.ops import norm as jnorm
from internevo_tpu.ops import rotary as jrot
from internevo_tpu_torch.ops import fused_ce as tfce
from internevo_tpu_torch.ops import norm as tnorm
from internevo_tpu_torch.ops import rotary as trot

TOL = dict(rtol=1e-5, atol=1e-5)


def _leaves(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in arrays]


@pytest.mark.parametrize("save_logits", [False, True], ids=["recompute", "save_logits"])
@pytest.mark.parametrize("smoothing,norm_head,chunk", [(0.0, False, 16), (0.1, True, 37)],
                         ids=["plain_chunk16", "smooth_normhead_ragged37"])
def test_fused_norm_head_ce_grads(save_logits, smoothing, norm_head, chunk):
    rng = np.random.RandomState(4)
    h = rng.randn(2, 40, 32).astype(np.float32)
    nw = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    w = (0.2 * rng.randn(32, 101)).astype(np.float32)  # JAX (hidden, vocab)
    lab = rng.randint(0, 101, (2, 40)).astype(np.int32)
    lab[:, -5:] = -100
    kw = dict(eps=1e-5, embed_grad_scale=0.1, norm_head=norm_head, label_smoothing=smoothing,
              chunk_size=chunk)

    def jloss(h_, nw_, w_):
        return jfce.fused_norm_head_ce(h_, nw_, w_, jnp.asarray(lab), save_logits=save_logits, **kw)[0]

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jnp.asarray(h), jnp.asarray(nw), jnp.asarray(w))
    th, tnw, tw = _leaves(h, nw, w.T)
    nll, n_valid, _ = tfce.fused_norm_head_ce(th, tnw, tw, torch.from_numpy(lab), save_logits=save_logits, **kw)
    nll.backward()
    np.testing.assert_allclose(float(nll.detach()), float(jval), **TOL)
    assert int(n_valid) == 2 * 35
    for got, want in zip((th.grad, tnw.grad, tw.grad.T), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_grads():
    rng = np.random.RandomState(0)
    x, w, b, cot = (rng.randn(*s).astype(np.float32) for s in ((3, 7, 64), (64,), (64,), (3, 7, 64)))
    jr = jax.grad(lambda x_, w_: jnp.sum(jnorm.rms_norm(x_, w_) * cot), argnums=(0, 1))(x, w)
    tx, tw = _leaves(x, w)
    (tnorm.rms_norm(tx, tw) * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((tx.grad, tw.grad), jr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jl = jax.grad(lambda x_, w_, b_: jnp.sum(jnorm.layer_norm(x_, w_, b_) * cot), argnums=(0, 1, 2))(x, w, b)
    tx, tw, tb = _leaves(x, w, b)
    (tnorm.layer_norm(tx, tw, tb) * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((tx.grad, tw.grad, tb.grad), jl):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rotary_grads():
    rng = np.random.RandomState(1)
    pos = np.tile(np.arange(40), (2, 1)).astype(np.int32)
    pos[:, 20:] -= 20  # packed positions restart
    x, cot = rng.randn(2, 40, 3, 64).astype(np.float32), rng.randn(2, 40, 3, 64).astype(np.float32)
    jc, js = jrot.rope_frequencies(jnp.asarray(pos), 64)
    jg = jax.grad(lambda x_: jnp.sum(jrot.apply_rotary(x_, jc, js) * cot))(jnp.asarray(x))
    tc, ts = trot.rope_frequencies(torch.from_numpy(pos), 64)
    (tx,) = _leaves(x)
    (trot.apply_rotary(tx, tc, ts) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), **TOL)
