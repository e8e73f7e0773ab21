"""The port's dropless MoE layer (``internevo_tpu_torch/models/moe/dropless.py``)
against the JAX one (``internevo_tpu/models/moe/dropless.py``) on the CPU:
the layer's output, aux loss and expert counts, and the grads of the tokens,
the gate and the three expert stacks, top-1 and top-2, in fp32 and bf16; the
dispatch and combine Functions' backward rounding points; top-k ties.

The same numpy inputs feed both.  On the CPU the JAX layer's grouped matmul
is ``lax.ragged_dot`` and the port's the plain ``gmm`` (both one fp32 sum per
output, rounded once).  Tolerances: fp32 rtol 1e-5 (plus atol 1e-6 of each
tensor's largest entry, for entries that cancel to near 0); bf16 within two
bf16 steps (rtol 2**-6) of each tensor's scale, because the two frameworks
round the SiLU and the products in bf16 at slightly different points.  The
top-1 gate grad in fp32 is held within 2e-4 of its scale (see the test).  Gate
logits are drawn wide (std 0.3 over H = 64) so that no token lies within
fp32 noise of a routing tie."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from internevo_tpu.models.moe import dropless as jd
from internevo_tpu_torch.models.moe import dropless as td

B, S, H, M, E = 2, 48, 64, 96, 4


def _layer(seed, dtype):
    rng = np.random.RandomState(seed)
    return {"gate": (0.3 * rng.randn(H, E)).astype(np.float32),
            "experts": {"w1": (0.1 * rng.randn(E, H, M)).astype(np.float32).astype(dtype),
                        "w3": (0.1 * rng.randn(E, H, M)).astype(np.float32).astype(dtype),
                        "w2": (0.1 * rng.randn(E, M, H)).astype(np.float32).astype(dtype)}}


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, bf16, name, fp32_atol=1e-6):
    got, want = _np32(got), _np32(want)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-6 * np.abs(want).max(), err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=fp32_atol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
def test_dropless_layer_matches_jax(top_k, dtype):
    rng = np.random.RandomState(10 + top_k)
    layer = _layer(top_k, dtype)
    x = rng.randn(B, S, H).astype(np.float32).astype(dtype)
    cot = rng.randn(B, S, H).astype(np.float32).astype(dtype)
    aux_cot = 0.7
    bf16 = dtype is not np.float32

    def jfn(x, gate, w1, w2, w3):
        out, l_aux, _ = jd.dropless_moe_apply({"gate": gate, "experts": {"w1": w1, "w2": w2, "w3": w3}}, x,
                                              top_k=top_k)
        return out, l_aux

    jargs = (jnp.asarray(x), jnp.asarray(layer["gate"]),
             *(jnp.asarray(layer["experts"][k]) for k in ("w1", "w2", "w3")))
    (jout, jaux), vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp((jnp.asarray(cot), jnp.asarray(aux_cot, jnp.float32)))
    jcounts = jd.dropless_moe_apply(jax.tree.map(jnp.asarray, layer), jnp.asarray(x), top_k=top_k)[2]

    targs = [_t(a).requires_grad_() for a in (x, layer["gate"], layer["experts"]["w1"], layer["experts"]["w2"],
                                              layer["experts"]["w3"])]
    tlayer = {"gate": targs[1], "experts": {"w1": targs[2], "w2": targs[3], "w3": targs[4]}}
    tout, taux, tcounts = td.dropless_moe_apply(tlayer, targs[0], top_k=top_k)
    torch.autograd.backward([tout, taux], [_t(cot), torch.tensor(aux_cot)])

    assert tout.dtype == targs[0].dtype and tout.shape == (B, S, H)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert int(tcounts.sum()) == B * S * top_k
    _close(tout, jout, bf16, "out")
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5)
    for name, t, j in zip(("x", "gate", "w1", "w2", "w3"), targs, jgrads):
        assert t.grad.dtype == t.dtype, name
        # top-1: the renormalised weight p / p is 1, and its grad, 0 in exact
        # arithmetic, is the difference of two terms of the size of dscale / p
        # that cancel to fp32 noise (~5e-5 of the gate grad's scale)
        _close(t.grad, j, bf16, f"d{name}", fp32_atol=2e-4 if (name, top_k) == ("gate", 1) else 1e-6)


def _route(seed, n=96, k=2):
    rng = np.random.RandomState(seed)
    expert = rng.randint(0, E, (n, k))
    order = np.argsort(expert.reshape(-1), kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return order, inv


def test_inverse_permutation():
    order, inv = _route(0)
    np.testing.assert_array_equal(td._inverse_permutation(torch.from_numpy(order)).numpy(), inv)
    np.testing.assert_array_equal(np.asarray(jd._inverse_permutation(jnp.asarray(order))), inv)


def test_combine_backward_keeps_the_jax_rounding_points():
    """bf16: deo is the bf16 product of the gathered cotangent and the bf16
    scale, bit for bit; dscale sums that cotangent, already cast to bf16,
    times eo in fp32 and rounds to bf16 (``dropless.py:94-97``)."""
    k = 2
    order, inv = _route(1, k=k)
    src = order // k
    rng = np.random.RandomState(2)
    eo = rng.randn(order.size, H).astype(ml_dtypes.bfloat16)
    scale = rng.rand(order.size).astype(ml_dtypes.bfloat16)
    dout = rng.randn(order.size // k, H).astype(ml_dtypes.bfloat16)
    jargs = (jnp.asarray(eo), jnp.asarray(scale), jnp.asarray(src), jnp.asarray(inv))
    jout, vjp = jax.vjp(lambda a, b: jd._combine_sorted(a, b, jargs[2], jargs[3], k), *jargs[:2])
    jdeo, jdscale = vjp(jnp.asarray(dout))
    teo, tscale = _t(eo).requires_grad_(), _t(scale).requires_grad_()
    tout = td._CombineSorted.apply(teo, tscale, torch.from_numpy(src), torch.from_numpy(inv), k)
    tout.backward(_t(dout))
    np.testing.assert_array_equal(_np32(tout), _np32(jout))
    np.testing.assert_array_equal(_np32(teo.grad), _np32(jdeo))
    assert tscale.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(_np32(tscale.grad), _np32(jdscale), rtol=2.0**-8, atol=0)


def test_expand_backward_matches_jax():
    k = 2
    order, inv = _route(3, k=k)
    src = order // k
    rng = np.random.RandomState(4)
    tokens = rng.randn(order.size // k, H).astype(ml_dtypes.bfloat16)
    dg = rng.randn(order.size, H).astype(ml_dtypes.bfloat16)
    _, vjp = jax.vjp(lambda t: jd._expand_sorted(t, jnp.asarray(src), jnp.asarray(inv), k), jnp.asarray(tokens))
    (jdt,) = vjp(jnp.asarray(dg))
    tt = _t(tokens).requires_grad_()
    gathered = td._ExpandSorted.apply(tt, torch.from_numpy(src), torch.from_numpy(inv), k)
    np.testing.assert_array_equal(_np32(gathered), _np32(tokens)[src])
    gathered.backward(_t(dg))
    np.testing.assert_array_equal(_np32(tt.grad), _np32(jdt))


def test_top_k_ties_go_to_the_lower_expert_as_in_jax():
    probs = np.full((6, E), 0.25, np.float32)
    probs[1] = [0.1, 0.3, 0.3, 0.3]
    probs[2] = [0.4, 0.1, 0.4, 0.1]
    probs[3] = [0.2, 0.2, 0.2, 0.4]
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = td.top_k_routes(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
