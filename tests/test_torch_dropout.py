"""Residual and attention dropout of the port against the JAX package on the
CPU: the dropout map itself bit for bit (bf16 and fp32, forward and grad),
one block's masks and attention seed, whole-model forwards (dense and MoE),
three steps of the tiny trainers with both dropouts on (dense and MoE), the
eval step ignoring dropout, and a planted skipped step after which the
port's stream stays in step with JAX's (which folds the optimizer's count of
applied steps, not the steps run).

Tolerances: bit for bit where the map is the same expression; fp32 model
outputs rtol and atol 1e-5 (sums in another order); trainer losses rtol
5e-5 and grad norms rtol 1e-4 (``doc/perf_notes.md:287-289``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.models import base as jbase
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.core import random as tr
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.models.jax_bridge import params_from_jax
from internevo_tpu_torch.ops.cuda import dropout as tdropout
from tests.test_torch_model import TINY, _torch_batch, numpy_tree, packed_batch

RATES = dict(drop_rate=0.2, attn_drop_rate=0.3)


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


def _jkey(seed, *folds):
    k = jax.random.PRNGKey(seed)
    for d in folds:
        k = jax.random.fold_in(k, d)
    return k


def _tkey(seed, *folds):
    k = tr.PRNGKey(seed)
    for d in folds:
        k = tr.fold_in(k, d)
    return k


@pytest.mark.parametrize("jdt,tdt", [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.07])
def test_dropout_map_and_grad_bitwise(jdt, tdt, rate):
    """JAX's ``where(bernoulli(key, 1 - rate), h / (1 - rate), 0)`` in h's
    dtype (``models/base.py:412-417``) and its vjp, against the port's
    autograd Function, bit for bit."""
    rs = np.random.RandomState(int(rate * 100))
    x = (rs.randn(37, 129) * 3).astype(np.float32)
    g = rs.randn(37, 129).astype(np.float32)
    key = _jkey(7, 3, 1)

    def jdrop(h):
        keep = jax.random.bernoulli(key, 1.0 - rate, h.shape)
        return jnp.where(keep, h / (1.0 - rate), 0).astype(h.dtype)

    jy, vjp = jax.vjp(jdrop, jnp.asarray(x).astype(jdt))
    (jg,) = vjp(jnp.asarray(g).astype(jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty = tdropout.dropout(tx, _tkey(7, 3, 1), rate)
    ty.backward(torch.from_numpy(g).to(tdt))
    assert ty.dtype == tdt
    np.testing.assert_array_equal(ty.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(), np.asarray(jg.astype(jnp.float32)))
    assert tdropout.launches == 0  # a CPU tensor runs the plain version


def _block_inputs(seed, dtype=np.float32, **kw):
    kw = dict(TINY, num_attention_heads=4, num_kv_attention_heads=2, **RATES, **kw)
    jcfg = jbase.ModelConfig(**kw, dtype=jnp.float32)
    tcfg = tbase.ModelConfig(**kw, dtype=torch.float32)
    tree = numpy_tree(jcfg, seed=seed)
    batch = packed_batch(2, 96, TINY["vocab_size"], seed=seed)
    return jcfg, tcfg, tree, batch


def test_block_masks_and_attention_seed_match_jax():
    """One block's residual masks (tags 0 and 1) and attention seed (tag 7)
    from the layer's key, against JAX ``block_forward``; a block with
    another key differs."""
    jcfg, tcfg, tree, batch = _block_inputs(2)
    layer_j = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["blocks"])
    layer_t = params_from_jax(tree, "cpu")["blocks"][1]
    x = np.random.RandomState(2).randn(2, 96, 128).astype(np.float32)
    jout = jbase.block_forward(jcfg, layer_j, jnp.asarray(x), jnp.asarray(batch["indexes"]),
                               jnp.asarray(batch["segment_ids"]), _jkey(5, 9, 1), True)
    tb = _torch_batch(batch)
    tout = tbase.block_forward(tcfg, layer_t, torch.from_numpy(x), tb["indexes"], tb["segment_ids"],
                               _tkey(5, 9, 1), True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    other = tbase.block_forward(tcfg, layer_t, torch.from_numpy(x), tb["indexes"], tb["segment_ids"],
                                _tkey(5, 9, 2), True)
    assert np.abs(other.numpy() - np.asarray(jout)).max() > 1e-2
    jseed = int(np.asarray(jax.random.bits(_jkey(5, 9, 1, 7), dtype=jnp.uint32).astype(jnp.int32)))
    assert tr.bits_scalar(tr.fold_in(_tkey(5, 9, 1), 7)) == jseed & 0xFFFFFFFF


def _moe_kw():
    return dict(num_experts=4, top_k=2, moe_type="MegaBlock-D")


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_model_forward_train_matches_jax(moe):
    """Whole-model training forward with both dropouts, the per-layer keys
    folded from the micro-batch's key, dense and dropless MoE."""
    from internevo_tpu.models import modeling_moe as jmoe
    from internevo_tpu_torch.models import modeling_moe as tmoe

    kw = _moe_kw() if moe else {}
    jcfg, tcfg, tree, batch = _block_inputs(4, **kw)
    if moe:
        shapes = jax.eval_shape(lambda: jmoe.init_moe_params(jcfg, jax.random.PRNGKey(0)))
        tree = jax.tree.map(lambda s: (0.05 * np.random.RandomState(4).randn(*s.shape)).astype(np.float32)
                            if len(s.shape) >= 2 else np.ones(s.shape, np.float32), shapes)
        japply, tapply = jmoe.moe_model_forward, tmoe.moe_model_forward
    else:
        japply, tapply = jbase.model_forward, tbase.model_forward
    args = [jnp.asarray(batch[k]) for k in ("input_ids", "indexes", "segment_ids")]
    jout = japply(jcfg, jax.tree.map(jnp.asarray, tree), *args, dropout_rng=_jkey(11, 5), train=True)
    tb = _torch_batch(batch)
    tout = tapply(tcfg, params_from_jax(tree, "cpu"), tb["input_ids"], tb["indexes"], tb["segment_ids"],
                  dropout_rng=_tkey(11, 5), train=True)
    if moe:
        jout, tout = jout[0], tout[0]
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)


def _trainers(config: dict, gate_scale=None, seed=0):
    """The JAX trainer (launched with seed 1024) and the port's from the same
    weights and config, and one batch."""
    from internevo_tpu.core.context import gpc
    from internevo_tpu.initialize.launch import launch
    from internevo_tpu.train import pipeline as jpipe
    from internevo_tpu_torch.core.config import Config as TConfig
    from internevo_tpu_torch.train import pipeline as tpipe
    from tests.test_torch_train import _tiny_batch

    launch(config, seed=1024, devices=jax.devices()[:1])
    config = gpc.config.to_dict()
    jmodel, jparams = jpipe.initialize_model()
    tree = jax.tree.map(np.asarray, jparams)
    if gate_scale is not None:
        tree["blocks"]["moe"]["gate"] = tree["blocks"]["moe"]["gate"] * gate_scale
        jparams = jax.tree.map(lambda a, ref: jax.device_put(a, ref.sharding), tree, jparams)
    jopt, jlr, jb2 = jpipe.initialize_optimizer(jmodel, jparams)
    jtrainer = jpipe.initialize_trainer(jmodel, jparams, jopt, jlr, jb2)
    d = config["data"]
    batch = _tiny_batch(d["micro_num"], d["micro_bsz"] * d["seq_len"], config["model"]["vocab_size"], seed=seed)
    tcfg = TConfig(config)
    tmodel, _ = tpipe.initialize_model(tcfg, "cpu", torch.Generator().manual_seed(0))
    tparams = params_from_jax(tree, "cpu")
    topt, tlr, tb2 = tpipe.initialize_optimizer(tmodel, tparams, tcfg)
    ttrainer = tpipe.initialize_trainer(tmodel, tparams, topt, tlr, tb2, tcfg)
    return jtrainer, ttrainer, jax.tree.map(jnp.asarray, batch), _torch_batch(batch)


def _small_config():
    """The ``tiny`` bench preset at 2 layers of 256 tokens, fp32."""
    from bench import build_bench_config, build_full_config

    cfg = build_full_config(dict(build_bench_config("tiny"), layers=2, seq=256))
    cfg["model"]["dtype"] = "torch.float32"
    return cfg


def _dense_config():
    cfg = _small_config()
    cfg["model"].update(RATES)
    return cfg


def _moe_config():
    from tests.test_torch_moe_model import _tiny_moe_config

    cfg = _tiny_moe_config()
    cfg["model"].update(RATES)
    return cfg


def _assert_step(tm, jm, step):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=5e-5, err_msg=f"step {step}")
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4, err_msg=f"step {step}")
    np.testing.assert_allclose(float(tm["moe_loss"]), float(jm["moe_loss"]), rtol=1e-4, atol=1e-9)
    assert bool(tm["found_inf"]) == bool(jm["found_inf"])


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_tiny_trainer_with_dropout_matches_jax_trainer(moe):
    """Three steps with drop_rate 0.2 and attn_drop_rate 0.3: each step's and
    micro-batch's masks from JAX's stream (``rng(1024, "dropout")``, the
    applied step, the micro index, the layer), losses falling."""
    from tests.test_torch_moe_model import GATE_SCALE

    jtrainer, ttrainer, jbatch, tbatch = _trainers(_moe_config() if moe else _dense_config(),
                                                   GATE_SCALE if moe else None, seed=22 if moe else 0)
    losses = []
    for step in range(3):
        jm, tm = jtrainer.execute_schedule(jbatch), ttrainer.execute_schedule(tbatch)
        _assert_step(tm, jm, step)
        losses.append(float(tm["loss"]))
    assert losses[2] < losses[1] < losses[0], losses


def test_eval_step_ignores_dropout():
    """The eval step runs the model without dropout: the same loss as the
    same model built with both rates at 0, and as JAX's eval step."""
    jtrainer, ttrainer, jbatch, tbatch = _trainers(_dense_config())
    micro = {k: v[0] for k, v in tbatch.items()}
    got = ttrainer.engine.run_eval_step(micro)
    jgot = jtrainer.engine.run_eval_step({k: v[0] for k, v in jbatch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(jgot["loss"]), rtol=5e-5)
    from internevo_tpu_torch.core.scheduler.no_pipeline import make_eval_step
    import dataclasses

    plain = tbase.make_model_def(dataclasses.replace(ttrainer.engine.model.config, drop_rate=0.0, attn_drop_rate=0.0))
    want = make_eval_step(plain, per_token=True)(ttrainer.engine.params, micro)
    assert float(got["loss"]) == float(want["loss"])


def test_skipped_step_keeps_the_stream_in_step():
    """Step 2 is made non-finite in both trainers (an infinite loss scale);
    JAX's optimizer does not advance its step, so step 3 draws step 2's
    stream again.  The port's train step reads the optimizer's step count
    before it draws step 3's keys, so its losses and norms stay JAX's."""
    jtrainer, ttrainer, jbatch, tbatch = _trainers(_dense_config())
    for step in range(4):
        planted = step == 1
        if planted:
            jtrainer.engine.opt_state = {**jtrainer.engine.opt_state, "grad_scale": jnp.asarray(jnp.inf, jnp.float32)}
            ttrainer.engine.opt_state["grad_scale"].fill_(float("inf"))
        jm, tm = jtrainer.execute_schedule(jbatch), ttrainer.execute_schedule(tbatch)
        if planted:
            assert bool(tm["found_inf"]) and bool(jm["found_inf"])
            jtrainer.engine.opt_state = {**jtrainer.engine.opt_state, "grad_scale": jnp.asarray(1.0, jnp.float32)}
            ttrainer.engine.opt_state["grad_scale"].fill_(1.0)
            continue
        _assert_step(tm, jm, step)
    assert int(ttrainer.engine.opt_state["step"]) == int(jtrainer.engine.opt_state["step"]) == 3
