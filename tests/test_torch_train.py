"""The port's training path against the JAX package on the CPU, fp32:
every param grad of a tiny INTERNLM (MHA and GQA, packed segments) against
``jax.grad`` of ``model_forward``, and the whole slice -- the ``tiny`` bench
preset (``bench.py``) through the port's ``initialize_*`` and ``Trainer`` --
against the JAX trainer for three steps from the same weights and batch.

Tolerances: model grads rtol 1e-4 plus atol 1e-5 of each leaf's largest
entry (fp32, sums over ~200 tokens in another order, where entries that
cancel to near 0 keep the absolute error of their larger terms).  Trainer: losses rtol 5e-5 (``doc/perf_notes.md``), grad
norms rtol 1e-4; after step 3 the params and masters within atol 2e-6 (three
AdamW moves of ~1e-4 each, where a grad near zero turns a last-digit
difference into a different Adam direction), m within rtol 1e-3 / atol 1e-6
of its scale and v within rtol 1e-3 / atol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.models import base as jbase
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.models.jax_bridge import (opt_state_from_jax, opt_state_to_numpy,
                                                   params_from_jax, params_to_numpy)
from tests.test_torch_model import TINY, numpy_tree, packed_batch


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)  # the JAX model on the CPU runs its jnp attention
    yield
    set_use_pallas(None)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k in ("input_ids", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("kv_heads", [None, 1], ids=["mha", "gqa"])
def test_model_grads_match_jax(kv_heads):
    heads = 2 if kv_heads is None else 4
    kw = dict(TINY, num_attention_heads=heads, num_kv_attention_heads=kv_heads)
    jcfg = jbase.ModelConfig(**kw, dtype=jnp.float32)
    tcfg = tbase.ModelConfig(**kw, dtype=torch.float32)
    tree = numpy_tree(jcfg, seed=3)
    batch = packed_batch(2, 96, TINY["vocab_size"], seed=3)
    cot = np.random.RandomState(9).randn(2, 96, TINY["vocab_size"]).astype(np.float32)

    def jloss(p):
        logits = jbase.model_forward(jcfg, p, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["indexes"]),
                                     jnp.asarray(batch["segment_ids"]), train=True)
        return jnp.sum(logits * cot)

    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, tree))
    params = params_from_jax(tree, "cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    tb = _torch_batch(batch)
    logits = tbase.model_forward(tcfg, params, tb["input_ids"], tb["indexes"], tb["segment_ids"], train=True)
    (logits * torch.from_numpy(cot)).sum().backward()
    tgrads = params_to_numpy(jax.tree.map(lambda t: t.grad, params))
    flat_j, tdef_j = jax.tree.flatten(jgrads)
    assert jax.tree.structure(tgrads) == tdef_j
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tgrads), flat_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_opt_state_bridge_round_trip():
    """A JAX optimizer state (stacked blocks, kernels (in, out)) comes over
    into the port's layout and goes back unchanged, bit for bit."""
    from internevo_tpu.solver.optimizer import init_optimizer_state

    jcfg = jbase.ModelConfig(**TINY, dtype=jnp.float32)
    state = init_optimizer_state(jax.tree.map(jnp.asarray, numpy_tree(jcfg, seed=4)))
    rng = np.random.RandomState(4)
    state = {**jax.tree.map(np.asarray, state),
             "m": jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), state["m"])}
    tstate = opt_state_from_jax(state, "cpu")
    assert tstate["m"]["blocks"][1]["wqkv"]["weight"].shape == (3 * 128, 128)
    back = opt_state_to_numpy(tstate)
    flat_a, tdef_a = jax.tree.flatten(state)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _tiny_config():
    from bench import build_bench_config, build_full_config

    cfg = build_full_config(build_bench_config("tiny"))
    cfg["model"]["dtype"] = "torch.float32"
    return cfg


def _tiny_batch(micro_num, P, vocab, seed=0):
    """Cut-packed rows with positions restarting per segment, a padded tail."""
    rows = [packed_batch(1, P, vocab, seed=seed + i, max_len=200, pad=23) for i in range(micro_num)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}  # (micro_num, 1, P)


def test_tiny_trainer_matches_jax_trainer():
    from internevo_tpu.core.context import gpc
    from internevo_tpu.initialize.launch import launch
    from internevo_tpu.train import pipeline as jpipe
    from internevo_tpu_torch.core.config import Config as TConfig
    from internevo_tpu_torch.train import pipeline as tpipe

    launch(_tiny_config(), seed=1024, devices=jax.devices()[:1])
    config = gpc.config.to_dict()
    jmodel, jparams = jpipe.initialize_model()
    tree = jax.tree.map(np.asarray, jparams)  # before the JAX step donates the buffers
    jopt, jlr, jb2 = jpipe.initialize_optimizer(jmodel, jparams)
    jtrainer = jpipe.initialize_trainer(jmodel, jparams, jopt, jlr, jb2)
    d = config["data"]
    micro_num, P = d["micro_num"], d["micro_bsz"] * d["seq_len"]
    batch = _tiny_batch(micro_num, P, config["model"]["vocab_size"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    tcfg = TConfig(config)
    tmodel, _ = tpipe.initialize_model(tcfg, "cpu", torch.Generator().manual_seed(0))
    tparams = params_from_jax(tree, "cpu")
    topt, tlr, tb2 = tpipe.initialize_optimizer(tmodel, tparams, tcfg)
    ttrainer = tpipe.initialize_trainer(tmodel, tparams, topt, tlr, tb2, tcfg)
    tbatch = _torch_batch(batch)

    losses = []
    for step in range(3):
        jm = jtrainer.execute_schedule(jbatch)
        tm = ttrainer.execute_schedule(tbatch)
        losses.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=5e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert int(tm["n_tokens"]) == int(jm["n_tokens"]) == micro_num * (P - 23)
        for g, v in jm["grad_norm_groups"].items():
            np.testing.assert_allclose(float(tm["grad_norm_groups"][g]), float(v), rtol=1e-4, err_msg=g)
    assert losses[2] < losses[1] < losses[0], losses

    jstate = jax.tree.map(np.asarray, jtrainer.engine.opt_state)
    tstate = opt_state_to_numpy(ttrainer.engine.opt_state)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_tree_close(params_to_numpy(ttrainer.engine.params), jax.tree.map(np.asarray, jtrainer.engine.params),
                       atol=2e-6)
    _assert_tree_close(tstate["master"], jstate["master"], atol=2e-6)
    _assert_tree_close(tstate["m"], jstate["m"], rtol=1e-3, atol=1e-6)
    _assert_tree_close(tstate["v"], jstate["v"], rtol=1e-3, atol=1e-9)


def _assert_tree_close(t, j, rtol=0.0, atol=0.0):
    flat_j, tdef_j = jax.tree.flatten(j)
    assert jax.tree.structure(t) == tdef_j
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(t), flat_j):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))
