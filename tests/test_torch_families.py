"""The INTERNLM2 and LLAMA2 families, the reward head and the streaming
metrics of the port against the JAX package on the CPU, fp32.

Each family is built through both registries from the same kwargs (as a
config's ``model`` block gives them, ``use_fp32_norm`` included) and run on
one numpy-made tree: logits, and every param grad of a fixed cotangent,
under GQA ratios 2 and 4, packed segments and ``norm_head``.  Tolerances as
``tests/test_torch_train.py``'s model grads: rtol 1e-4 plus atol 1e-5 of each
leaf's largest entry; logits rtol and atol 1e-4.  The metrics are held on
the same per-token values to 1e-6 (fp32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import internevo_tpu.models  # noqa: F401  (registers the JAX families)
import internevo_tpu_torch.models  # noqa: F401  (registers the port's)
from internevo_tpu.models import base as jbase
from internevo_tpu.models import metrics as jmetrics
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu.utils.registry import MODEL_INITIALIZER as JAX_MODELS
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.models import metrics as tmetrics
from internevo_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy
from internevo_tpu_torch.utils.registry import MODEL_INITIALIZER as PORT_MODELS
from tests.test_torch_model import TINY, _torch_batch, numpy_tree, packed_batch


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


def _build(family, **kw):
    kw = dict(TINY, **kw, use_fp32_norm=False, embed_split_hidden=True)
    jmodel = JAX_MODELS.get_module(family)(**kw, dtype="torch.float32")
    tmodel = PORT_MODELS.get_module(family)(**kw, dtype="torch.float32")
    return jmodel, tmodel


def _logits_and_grads(jmodel, tmodel, seed):
    tree = numpy_tree(jmodel.config, seed=seed)
    batch = packed_batch(2, 96, TINY["vocab_size"], seed=seed)
    V = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))["head"]["kernel"].shape[1]
    cot = np.random.RandomState(seed + 1).randn(2, 96, V).astype(np.float32)

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["indexes"]),
                              jnp.asarray(batch["segment_ids"]), train=True)
        return jnp.sum(logits * cot), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, tree))
    params = params_from_jax(tree, "cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    tb = _torch_batch(batch)
    tlogits = tmodel.apply(params, tb["input_ids"], tb["indexes"], tb["segment_ids"], train=True)
    (tlogits * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    tgrads = params_to_numpy(jax.tree.map(lambda t: t.grad, params))
    flat_j, tdef_j = jax.tree.flatten(jgrads)
    assert jax.tree.structure(tgrads) == tdef_j
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tgrads), flat_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=jax.tree_util.keystr(path))
    return tree, params


@pytest.mark.parametrize("family", ["INTERNLM2", "INTERNLM2_PUBLIC", "LLAMA2"])
@pytest.mark.parametrize("heads,kv_heads,norm_head", [(4, 2, False), (8, 2, True)],
                         ids=["gqa2", "gqa4_norm_head"])
def test_family_logits_and_grads_match_jax(family, heads, kv_heads, norm_head):
    jmodel, tmodel = _build(family, num_attention_heads=heads, num_kv_attention_heads=kv_heads,
                            norm_head=norm_head, no_bias=True)
    assert not (tmodel.config.qkv_bias or tmodel.config.o_bias or tmodel.config.mlp_bias)
    assert tmodel.config.q_per_kv == heads // kv_heads
    tree, _ = _logits_and_grads(jmodel, tmodel, seed=5)
    assert "bias" not in tree["blocks"]["wqkv"]


def test_family_defaults_yield_to_the_config():
    """The families' no-bias defaults are defaults: a config that asks for a
    wqkv bias gets one, as from the JAX builder."""
    jmodel, tmodel = _build("INTERNLM2", num_attention_heads=4, num_kv_attention_heads=2, qkv_bias=True)
    assert jmodel.config.qkv_bias and tmodel.config.qkv_bias and not tmodel.config.o_bias
    _logits_and_grads(jmodel, tmodel, seed=6)


@pytest.mark.parametrize("family", ["INTERNLM", "INTERNLM2"])
def test_reward_head_matches_jax_and_round_trips(family):
    """``is_reward``: one output column in init and in the logits; the
    bridge carries the (H, 1) JAX head to the port's (1, H) and back."""
    jmodel, tmodel = _build(family, num_attention_heads=4, num_kv_attention_heads=2, is_reward=True)
    assert tmodel.config.is_reward
    tree, params = _logits_and_grads(jmodel, tmodel, seed=7)
    assert tree["head"]["kernel"].shape == (128, 1) and params["head"]["weight"].shape == (1, 128)
    back = params_to_numpy(params)
    assert back["head"]["kernel"].tobytes() == np.asarray(tree["head"]["kernel"]).tobytes()
    init = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    assert init["head"]["weight"].shape == (1, 128)


def _metric_inputs(seed=0, B=3, S=40, V=50, n_types=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, S, V).astype(np.float32)
    labels = rng.randint(0, V, (B, S))
    labels[rng.rand(B, S) < 0.2] = -100
    type_ids = rng.randint(0, n_types, (B, S))
    return logits, labels, type_ids


def _assert_metrics_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("types", [None, ["en", "code", "math"]], ids=["untyped", "typed"])
def test_acc_perplex_matches_jax(types):
    """``update`` from logits, and ``update_from_token_stats`` from the
    per-token (nll, correct) of the eval step, over two batches."""
    jm = jmetrics.AccPerplex(dataset_types=types)
    tm = tmetrics.AccPerplex(dataset_types=types)
    for seed in (0, 1):
        logits, labels, type_ids = _metric_inputs(seed)
        tid = type_ids if types else None
        jm.update(jnp.asarray(logits), jnp.asarray(labels), tid)
        tm.update(torch.from_numpy(logits), torch.from_numpy(labels), None if tid is None else torch.from_numpy(tid))
    _assert_metrics_equal(tm.get_metric(), jm.get_metric())

    logits, labels, type_ids = _metric_inputs(2)
    valid = labels != -100
    nll = np.where(valid, np.random.RandomState(3).rand(*labels.shape).astype(np.float32) * 5, 0.0)
    correct = (np.random.RandomState(4).rand(*labels.shape) < 0.3) & valid
    tid = type_ids if types else None
    jm.update_from_token_stats(nll, correct, labels, tid)
    tm.update_from_token_stats(torch.from_numpy(nll), torch.from_numpy(correct), torch.from_numpy(labels),
                               None if tid is None else torch.from_numpy(tid))
    _assert_metrics_equal(tm.get_metric(), jm.get_metric())


def test_loss_with_type_id_matches_jax():
    types = ["a", "b", "c", "d"]
    jm, tm = jmetrics.LossWithTypeId(dataset_types=types), tmetrics.LossWithTypeId(dataset_types=types)
    logits, labels, type_ids = _metric_inputs(5, n_types=4)
    jm.update(jnp.asarray(logits), jnp.asarray(labels), type_ids)
    tm.update(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(type_ids))
    nll = np.random.RandomState(6).rand(labels.size).astype(np.float32)
    jm.update_from_nll(nll, labels.reshape(-1), type_ids)
    tm.update_from_nll(nll, labels.reshape(-1), type_ids)
    _assert_metrics_equal(tm.get_metric(), jm.get_metric())
