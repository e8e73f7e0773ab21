"""The port's GShard capacity routing (``internevo_tpu_torch/models/moe/
gshard.py``) against ``internevo_tpu.models.moe.gshard`` on the CPU, from the
same numpy logits and the same key: top-1 with and without RTS, RSample,
``min_capacity`` binding, ``drop_tokens=False``; top-2 with and without the
gumbel noise and with capacity binding; ``moe_layer_apply`` at top-1 and
top-2 (with Jitter, in training and in eval); the refusal of an unknown noise
policy; and the INTERNLM_MoE model routed GShard at 2 layers with the JAX
params carried across: logits, the summed aux loss and every param grad under
a train key.

Tolerances: routing (the dispatch mask and the expert counts) exact; fp32
combine weights, outputs and aux losses rtol 1e-5 (``atol`` 1e-6 for outputs
near 0); the model as ``test_torch_moe_model.py``: logits rtol/atol 1e-4,
grads rtol 1e-4 plus atol 1e-5 of each leaf's largest entry.  The noise is
the port's own draw: its bits equal JAX's, and its float transform
(``_gumbel``'s two logs) lies within 5e-7 of JAX's
(``test_gumbel_and_uniform_seams``), far below the gaps between the noisy
logits here, so no argmax flips and nothing is injected through the seams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.models import modeling_moe as jmoe
from internevo_tpu.models.moe import gshard as jg
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.core import random as tr
from internevo_tpu_torch.models import modeling_moe as tmoe
from internevo_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from internevo_tpu_torch.models.moe import gshard as tg
from tests.test_torch_model import TINY, packed_batch
from tests.test_torch_moe_model import _torch_batch, moe_tree

S, E = 96, 4
SEED = 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: these tests run many tiny ops, and with
    the suite's parallel workers sharing the cores an op's thread barrier
    costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)  # the JAX model on the CPU runs its jnp attention
    yield
    set_use_pallas(None)


def _logits(seed=0, s=S, e=E, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(s, e)).astype(np.float32)


def _keys(seed=SEED):
    return jax.random.PRNGKey(seed), tr.PRNGKey(seed)


def _assert_gating_equal(jout, tout):
    """(l_aux, combine, dispatch, exp_counts) of both: routing exact, values rtol 1e-5."""
    jl, jc, jd, jn = (np.asarray(a) for a in jout)
    tl, tc, td, tn = tout
    assert tc.shape == jc.shape
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


TOP1_CASES = {
    # (capacity_factor, min_capacity, noisy_gate_policy, drop_tokens, use_rts, with a key)
    "no_rts_cap_binds": (0.5, 4, None, True, False, False),  # mask1.T all ties: lower token index first
    "rts": (1.0, 4, None, True, True, True),
    "rts_cap_binds": (0.5, 4, None, True, True, True),
    "rsample": (1.0, 4, "RSample", True, False, True),
    "rsample_rts": (0.75, 4, "RSample", True, True, True),
    "min_capacity_binds": (0.1, 20, None, True, False, False),  # ceil(96/4 * 0.1) = 3 < 20
    "no_drop": (0.25, 4, None, False, True, True),  # capacity = tokens
}


@pytest.mark.parametrize("case", list(TOP1_CASES))
def test_top1gating_matches_jax(case):
    cf, min_cap, policy, drop, rts, keyed = TOP1_CASES[case]
    logits = _logits(1)
    jk, tk = _keys() if keyed else (None, None)
    jout = jg.top1gating(jnp.asarray(logits), cf, min_cap, rng=jk, noisy_gate_policy=policy,
                         drop_tokens=drop, use_rts=rts)
    tout = tg.top1gating(torch.from_numpy(logits), cf, min_cap, rng=tk, noisy_gate_policy=policy,
                         drop_tokens=drop, use_rts=rts)
    _assert_gating_equal(jout, tout)
    capacity = S if not drop else max(int(np.ceil(S / E * cf)), min_cap)
    assert tout[1].shape == (S, E, capacity)
    kept = tout[2].sum(dim=(0, 2))
    assert int(kept.max()) <= capacity and int(tout[2].sum(dim=(1, 2)).max()) <= 1
    if case in ("no_rts_cap_binds", "rts_cap_binds"):
        assert int(kept.sum()) < S  # the capacity dropped tokens


@pytest.mark.parametrize("cf,keyed", [(1.0, False), (1.0, True), (0.5, True), (0.25, False)],
                         ids=["cap1", "cap1_gumbel", "cap05_gumbel", "cap025"])
def test_top2gating_matches_jax(cf, keyed):
    logits = _logits(2)
    jk, tk = _keys(7) if keyed else (None, None)
    jout = jg.top2gating(jnp.asarray(logits), cf, 4, rng=jk)
    tout = tg.top2gating(torch.from_numpy(logits), cf, 4, rng=tk)
    _assert_gating_equal(jout, tout)
    l_aux, combine, dispatch, counts = tout
    capacity = combine.shape[-1]
    assert capacity == max(int(np.ceil(S / E * cf * 2)), 4)
    # expert e's second choices take slots after all of its first choices
    first = torch.from_numpy(np.array(jnp.argmax(jax.nn.softmax(jnp.asarray(logits), axis=1), axis=1)))
    for e in range(E):
        n_first = int((first == e).sum())
        slots_first = dispatch[first == e, e].nonzero()[:, 1]
        slots_second = dispatch[first != e, e].nonzero()[:, 1]
        assert slots_first.tolist() == list(range(min(n_first, capacity)))
        assert all(int(c) >= n_first for c in slots_second)
    if cf < 1.0:
        assert int(dispatch.sum()) < 2 * S  # the capacity dropped assignments
    sums = combine.sum(dim=(1, 2))
    both = dispatch.sum(dim=(1, 2)) == 2
    np.testing.assert_allclose(sums[both].numpy(), 1.0, rtol=1e-6)


def test_argmax_ties_take_the_first():
    """Equal gates route to the lower expert, as ``jnp.argmax``: logits
    with exact ties, top-1 and top-2."""
    logits = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 2.0, 2.0, 2.0], [3.0, 3.0, 3.0, 3.0]] * 8, np.float32)
    for jfn, tfn in ((lambda x: jg.top1gating(x, 1.0, 4, use_rts=False),
                      lambda x: tg.top1gating(x, 1.0, 4, use_rts=False)),
                     (lambda x: jg.top2gating(x, 1.0, 4), lambda x: tg.top2gating(x, 1.0, 4))):
        _assert_gating_equal(jfn(jnp.asarray(logits)), tfn(torch.from_numpy(logits)))


def test_gumbel_and_uniform_seams():
    """``_uniform`` equals JAX's bit for bit; ``_gumbel`` within 5e-7
    absolute (the bits are JAX's; each log of the CPU's own may differ from
    XLA's by one ulp: 2.4e-7 measured at 2.54), and its float32 maxval is
    1.0."""
    jk, tk = _keys(11)
    shape = (257, 4)
    np.testing.assert_array_equal(tg._uniform(tk, shape, 0.99, 1.01, device="cpu").numpy(),
                                  np.asarray(jg._uniform(jk, shape, 0.99, 1.01)))
    jgum = np.asarray(jg._gumbel(jk, shape))
    tgum = tg._gumbel(tk, shape, device="cpu").numpy()
    np.testing.assert_allclose(tgum, jgum, rtol=0, atol=5e-7)
    assert np.float32(1.0 - 1e-10) == np.float32(1.0)


def _layer(seed=3, H=16, M=32):
    rng = np.random.RandomState(seed)
    return {"gate": (0.5 * rng.randn(H, E)).astype(np.float32),
            "experts": {"w1": (0.1 * rng.randn(E, H, M)).astype(np.float32),
                        "w3": (0.1 * rng.randn(E, H, M)).astype(np.float32),
                        "w2": (0.1 * rng.randn(E, M, H)).astype(np.float32)}}


LAYER_CASES = {
    # (top_k, capacity_factor, use_rts, noisy_gate_policy, train)
    "top2_train": (2, 1.0, True, None, True),
    "top2_cap05_train": (2, 0.5, True, None, True),
    "top2_eval": (2, 1.0, True, None, False),
    "top1_rts_train": (1, 1.0, True, None, True),
    "top1_jitter_train": (1, 2.0, False, "Jitter", True),
    "top1_jitter_eval": (1, 2.0, False, "Jitter", False),
    "top2_jitter_train": (2, 1.0, True, "Jitter", True),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_apply_matches_jax(case):
    top_k, cf, rts, policy, train = LAYER_CASES[case]
    layer = _layer()
    x = np.random.RandomState(4).randn(2, 48, 16).astype(np.float32)
    jk, tk = _keys(13)
    kw = dict(top_k=top_k, capacity_factor=cf, min_capacity=4, use_rts=rts, noisy_gate_policy=policy, train=train)
    jo, jl, jc = jg.moe_layer_apply(jax.tree.map(jnp.asarray, layer), jnp.asarray(x), rng=jk, **kw)
    tlayer = jax.tree.map(torch.from_numpy, layer)
    to, tl, tc = tg.moe_layer_apply(tlayer, torch.from_numpy(x), rng=tk, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    if policy == "Jitter":  # jitter acts in training only
        plain = tg.moe_layer_apply(tlayer, torch.from_numpy(x), rng=tk, **dict(kw, noisy_gate_policy=None))[0]
        assert torch.equal(plain, to) != train


def test_unknown_noise_policy_is_refused():
    layer = jax.tree.map(torch.from_numpy, _layer())
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        tg.moe_layer_apply(layer, torch.zeros(1, 8, 16), noisy_gate_policy="bogus", rng=tr.PRNGKey(0))


# ------------------------------------------------------------------ the model

GSHARD = dict(TINY, num_experts=4, top_k=2, moe_type="GShard", dtype="float32")


def test_gshard_model_matches_jax_under_a_train_key():
    """INTERNLM_MoE routed GShard (top-2, RTS, capacity 1.0): logits and the
    summed aux loss in training (every layer's gumbel noise from its key
    ``fold_in(dropout_rng, i)``, with both dropout rates 0) and in eval, and
    every param grad of ``sum(logits * cot) + 0.5 * moe`` against
    ``jax.grad``."""
    kw = dict(GSHARD, moe_capacity_factor=1.0, moe_eval_capacity_factor=0.75)
    jmodel, tmodel = jmoe.build_model_with_cfg(**kw), tmoe.build_model_with_cfg(**kw)
    assert not tmoe.is_dropless(tmodel.config)
    tree = moe_tree(jmodel, seed=6)
    batch = packed_batch(2, 96, TINY["vocab_size"], seed=6)
    tb = _torch_batch(batch)
    cot = np.random.RandomState(8).randn(2, 96, TINY["vocab_size"]).astype(np.float32)
    jkey, tkey = jax.random.fold_in(jax.random.PRNGKey(1024), 3), tr.fold_in(tr.PRNGKey(1024), 3)
    jb = [jnp.asarray(batch[k]) for k in ("input_ids", "indexes", "segment_ids")]
    tbatch = [tb[k] for k in ("input_ids", "indexes", "segment_ids")]

    for train in (False, True):
        lj, aj = jmodel.apply(jax.tree.map(jnp.asarray, tree), *jb, dropout_rng=jkey if train else None,
                              train=train)
        lt, at = tmodel.apply(params_from_jax(tree, "cpu"), *tbatch, dropout_rng=tkey if train else None,
                              train=train)
        np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(at["moe"]), float(aj["moe"]), rtol=1e-5)
    # the noise is on: another key routes otherwise
    lt2, _ = tmodel.apply(params_from_jax(tree, "cpu"), *tbatch, dropout_rng=tr.fold_in(tkey, 1), train=True)
    assert not torch.allclose(lt2, lt)

    def jloss(p):
        logits, aux = jmodel.apply(p, *jb, dropout_rng=jkey, train=True)
        return jnp.sum(logits * cot) + 0.5 * aux["moe"]

    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, tree))
    params = params_from_jax(tree, "cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    logits, aux = tmodel.apply(params, *tbatch, dropout_rng=tkey, train=True)
    ((logits * torch.from_numpy(cot)).sum() + 0.5 * aux["moe"]).backward()
    tgrads = params_to_numpy(jax.tree.map(lambda t: t.grad, params))
    flat_j, tdef_j = jax.tree.flatten(jgrads)
    assert jax.tree.structure(tgrads) == tdef_j
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tgrads), flat_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=jax.tree_util.keystr(path))
