"""The port's INTERNLM_MoE (dropless) against the JAX model on the CPU, from
one numpy-made parameter tree: logits and the summed aux loss with and
without the residual-MoE branch, the eval step, every param grad against
``jax.grad``, the weight bridge round trip of the MoE subtree, the MoE
configuration through ``initialize_model`` (routed dropless, and the shipped
file unmodified, routed by capacity), and a tiny MoE trainer's three steps
against the JAX trainer.

fp32 throughout: the point is the algorithm.  Tolerances as the dense model's
tests (``test_torch_model.py``, ``test_torch_train.py``); the trainer's
losses rtol 5e-5 and ``moe_loss`` rtol 1e-4, with identical expert counts in
every layer: routing is discontinuous, so the test asserts that no token's
top-2/top-3 gate margin is below 1e-4, far above the fp32 differences of the
two forwards (~1e-7), and then holds the counts equal."""

from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from internevo_tpu.core.scheduler import no_pipeline as jsched
from internevo_tpu.models import base as jbase
from internevo_tpu.models import modeling_moe as jmoe
from internevo_tpu.models.moe import dropless as jd
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.core.scheduler import no_pipeline as tsched
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.models import modeling_moe as tmoe
from internevo_tpu_torch.models.jax_bridge import (opt_state_from_jax, opt_state_to_numpy, params_from_jax,
                                                   params_to_numpy)
from internevo_tpu_torch.models.moe import dropless as td
from tests.test_torch_model import TINY, packed_batch

REPO = Path(__file__).resolve().parents[1]
TINY_MOE = dict(TINY, num_experts=4, top_k=2, moe_type="dropless", dtype="float32")


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)  # the JAX model on the CPU runs its jnp attention
    yield
    set_use_pallas(None)


def moe_tree(jmodel, seed=0, dtype=np.float32):
    """A JAX-layout MoE param tree drawn with numpy: weights N(0, 0.05) (the
    gate too, so that routing is decisive), norms near 1."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))

    def draw(path, s):
        if len(s.shape) >= 2 and jax.tree_util.keystr(path).find("gate") < 0:
            return (0.05 * rng.randn(*s.shape)).astype(np.float32).astype(dtype)
        if len(s.shape) >= 2:
            return (0.05 * rng.randn(*s.shape)).astype(np.float32)
        return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k in ("input_ids", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


def _models(**kw):
    kw = dict(TINY_MOE, **kw)
    return jmoe.build_model_with_cfg(**kw), tmoe.build_model_with_cfg(**kw)


@pytest.mark.parametrize("residual", [False, True], ids=["experts", "residual_moe"])
def test_moe_logits_and_aux_match_jax(residual):
    jmodel, tmodel = _models(moe_use_residual=residual)
    assert tmodel.config.num_shared_experts == int(residual)
    tree = moe_tree(jmodel, seed=1)
    batch = packed_batch(2, 96, TINY["vocab_size"], seed=1)
    lj, aj = jmodel.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["input_ids"]),
                          jnp.asarray(batch["indexes"]), jnp.asarray(batch["segment_ids"]), train=False)
    tb = _torch_batch(batch)
    lt, at = tmodel.apply(params_from_jax(tree, "cpu"), tb["input_ids"], tb["indexes"], tb["segment_ids"])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(at["moe"]), float(aj["moe"]), rtol=1e-5)
    hidden, ah = tmodel.apply(params_from_jax(tree, "cpu"), tb["input_ids"], tb["indexes"], tb["segment_ids"],
                              return_hidden=True)
    assert hidden.shape == (2, 96, TINY["hidden_size"]) and float(ah["moe"]) == float(at["moe"])


@pytest.mark.parametrize("per_token", [False, True])
def test_moe_eval_step_matches_jax(per_token):
    """The fused CE path, and with ``per_token`` the logits path that MoE
    models take (JAX ``no_pipeline.py:187-200``)."""
    jmodel, tmodel = _models()
    tree = moe_tree(jmodel, seed=2)
    batch = packed_batch(2, 128, TINY["vocab_size"], seed=2)
    rj = jsched.make_eval_step(jmodel, per_token=per_token)(jax.tree.map(jnp.asarray, tree),
                                                            jax.tree.map(jnp.asarray, batch))
    rt = tsched.make_eval_step(tmodel, per_token=per_token)(params_from_jax(tree, "cpu"), _torch_batch(batch))
    np.testing.assert_allclose(float(rt["loss"]), float(rj["loss"]), rtol=5e-5)
    assert int(rt["n_tokens"]) == int(rj["n_tokens"]) and int(rt["n_correct"]) == int(rj["n_correct"])
    if per_token:
        np.testing.assert_allclose(rt["nll"].numpy(), np.asarray(rj["nll"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("residual", [False, True], ids=["experts", "residual_moe"])
def test_moe_param_grads_match_jax(residual):
    """Every param grad of ``sum(logits * cot) + 0.5 * moe`` against
    ``jax.grad``: rtol 1e-4 plus atol 1e-5 of each leaf's largest entry."""
    jmodel, tmodel = _models(moe_use_residual=residual)
    tree = moe_tree(jmodel, seed=3)
    batch = packed_batch(2, 96, TINY["vocab_size"], seed=3)
    cot = np.random.RandomState(9).randn(2, 96, TINY["vocab_size"]).astype(np.float32)

    def jloss(p):
        logits, aux = jmodel.apply(p, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["indexes"]),
                                   jnp.asarray(batch["segment_ids"]), train=True)
        return jnp.sum(logits * cot) + 0.5 * aux["moe"]

    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, tree))
    params = params_from_jax(tree, "cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    tb = _torch_batch(batch)
    logits, aux = tmodel.apply(params, tb["input_ids"], tb["indexes"], tb["segment_ids"], train=True)
    ((logits * torch.from_numpy(cot)).sum() + 0.5 * aux["moe"]).backward()
    tgrads = params_to_numpy(jax.tree.map(lambda t: t.grad, params))
    flat_j, tdef_j = jax.tree.flatten(jgrads)
    assert jax.tree.structure(tgrads) == tdef_j
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tgrads), flat_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["fp32", "bf16"])
def test_moe_bridge_round_trip_exact(dtype):
    """The MoE subtree (gate, expert stacks, residual coefficient) comes over
    unstacked and untransposed, and goes back bit for bit; so does an
    optimizer state over it."""
    from internevo_tpu.solver.optimizer import init_optimizer_state

    jmodel, _ = _models(moe_use_residual=True)
    tree = moe_tree(jmodel, seed=4, dtype=dtype)
    params = params_from_jax(tree, "cpu")
    moe = params["blocks"][1]["moe"]
    assert moe["gate"].shape == (128, 4) and moe["gate"].dtype == torch.float32
    assert moe["experts"]["w1"].shape == (4, 128, 384) and moe["experts"]["w2"].shape == (4, 384, 128)
    assert moe["coefficient"].shape == (128, 2) and moe["coefficient_bias"].shape == (2,)
    torch.testing.assert_close(moe["experts"]["w3"].float(), torch.from_numpy(
        np.asarray(tree["blocks"]["moe"]["experts"]["w3"][1], np.float32)), rtol=0, atol=0)
    state = jax.tree.map(np.asarray, init_optimizer_state(jax.tree.map(jnp.asarray, tree)))
    for back, want in ((params_to_numpy(params), tree), (opt_state_to_numpy(opt_state_from_jax(state, "cpu")), state)):
        flat_a, tdef_a = jax.tree.flatten(want)
        flat_b, tdef_b = jax.tree.flatten(back)
        assert tdef_a == tdef_b
        for a, b in zip(flat_a, flat_b):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_moe_init_and_config():
    """``configs/7B_MoE4_sft.py`` routed dropless (the profiler's
    ``moe_config``), cut to a narrow width: the ``moe`` block's top_k and
    drop_tokens reach the model; the gate is fp32 (H, E); no dense MLP is
    drawn; the config file as it stands builds and routes GShard, its
    ``moe`` block's capacity and noise keys reaching the model."""
    from internevo_tpu_torch.tools.profile_step import moe_config
    from internevo_tpu_torch.train.pipeline import initialize_model

    cfg = moe_config(num_layers=2)
    cfg.model.update(hidden_size=128, num_attention_heads=2, vocab_size=256)
    model, params = initialize_model(cfg, "cpu", torch.Generator().manual_seed(0))
    c = model.config
    assert (c.num_experts, c.top_k, c.moe_drop_tokens, c.moe_type, c.mlp_hidden) == (4, 2, True, "MegaBlock-D", 512)
    layer = params["blocks"][0]
    assert "w1" not in layer and set(layer["moe"]) == {"gate", "experts"}
    assert layer["moe"]["gate"].dtype == torch.float32 and layer["moe"]["gate"].shape == (128, 4)
    assert layer["moe"]["experts"]["w2"].shape == (4, 512, 128) and layer["moe"]["experts"]["w2"].dtype == torch.bfloat16
    # the per-layer w2 std shrinks with depth (scaled init)
    assert float(params["blocks"][1]["moe"]["experts"]["w2"].float().std()) < float(
        layer["moe"]["experts"]["w2"].float().std())
    ids = torch.zeros(1, 8, dtype=torch.long)
    logits, aux = model.apply(params, ids, torch.arange(8)[None], torch.ones(1, 8, dtype=torch.int32))
    assert logits.shape == (1, 8, 256) and bool(torch.isfinite(logits.float()).all()) and float(aux["moe"]) > 0

    from internevo_tpu_torch.core.config import Config
    from internevo_tpu_torch.tools.profile_step import MOE_CONFIG

    shipped = Config.from_file(MOE_CONFIG)
    shipped.model.update(num_layers=2, hidden_size=128, num_attention_heads=2, vocab_size=256)
    gshard, gparams = initialize_model(shipped, "cpu", torch.Generator().manual_seed(0))
    g = gshard.config
    assert (g.moe_type, g.top_k, g.moe_capacity_factor, g.moe_eval_capacity_factor, g.moe_min_capacity,
            g.moe_use_rts, g.moe_noisy_gate_policy) == ("GShard", 2, 1.0, 1.0, 4, True, None)
    assert not tmoe.is_dropless(g)
    logits, aux = gshard.apply(gparams, ids, torch.arange(8)[None], torch.ones(1, 8, dtype=torch.int32))
    assert logits.shape == (1, 8, 256) and bool(torch.isfinite(logits.float()).all()) and float(aux["moe"]) > 0
    cfg.model.moe_type = "GShard"
    cfg.moe.drop_tokens = False  # no token may drop: the JAX model routes dropless
    assert tmoe.is_dropless(initialize_model(cfg, "cpu", torch.Generator().manual_seed(0))[0].config)


# ------------------------------------------------------------------ trainer


GATE_SCALE = 10.0   # the JAX init's gate std 0.006 leaves near-ties at this batch; x10 does not


def _tiny_moe_config():
    from bench import build_bench_config, build_full_config

    cfg = build_full_config(dict(build_bench_config("tiny"), layers=2, seq=128, experts=4, top_k=2,
                                 model_type="INTERNLM_MoE"))
    cfg["model"]["dtype"] = "torch.float32"
    cfg["loss"]["moe_loss_coeff"] = 0.1
    return cfg


def _port_routing(model, params, batch):
    """Per layer of each micro-batch: the expert counts and the smallest
    top-k / top-(k+1) gate margin, from the port's forward."""
    cfg, out = model.config, []
    for i in range(batch["input_ids"].shape[0]):
        micro = {k: v[i] for k, v in batch.items()}

        def block(layer, h, key):
            def ffn(hh):
                probs, _, idx = td.route(layer["moe"]["gate"], hh.reshape(-1, hh.shape[-1]), cfg.top_k)
                srt = probs.sort(-1, descending=True).values
                out.append((np.bincount(idx.reshape(-1).numpy(), minlength=cfg.num_experts),
                            float((srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]).min())))
                return tmoe.moe_ffn(cfg, layer, hh)
            return tbase.block_forward(cfg, layer, h, micro["indexes"], micro["segment_ids"], ffn=ffn)

        with torch.no_grad():
            model.apply(params, micro["input_ids"], micro["indexes"], micro["segment_ids"], block_fn=block)
    return out


def _jax_counts(jmodel, params, batch):
    """The same counts from the JAX layer, one block at a time."""
    cfg, out = jmodel.config, []
    for i in range(batch["input_ids"].shape[0]):
        micro = {k: jnp.asarray(v[i]) for k, v in batch.items()}
        x = jbase.embed_tokens(cfg, params, micro["input_ids"])
        for li in range(cfg.num_layers):
            layer = jax.tree.map(lambda a: a[li], params["blocks"])

            def ffn(hh):
                y, l_aux, counts = jd.dropless_moe_apply(layer["moe"], hh, top_k=cfg.top_k)
                out.append(np.asarray(counts))
                return y, l_aux

            x, _ = jbase.block_forward(cfg, layer, x, micro["indexes"], micro["segment_ids"], None, False, ffn=ffn)
    return out


def test_tiny_moe_trainer_matches_jax_trainer():
    from internevo_tpu.core.context import gpc
    from internevo_tpu.initialize.launch import launch
    from internevo_tpu.train import pipeline as jpipe
    from internevo_tpu_torch.core.config import Config as TConfig
    from internevo_tpu_torch.train import pipeline as tpipe
    from tests.test_torch_train import _tiny_batch, _torch_batch as train_batch

    launch(_tiny_moe_config(), seed=1024, devices=jax.devices()[:1])
    config = gpc.config.to_dict()
    jmodel, jparams = jpipe.initialize_model()
    tree = jax.tree.map(np.asarray, jparams)
    tree["blocks"]["moe"]["gate"] = tree["blocks"]["moe"]["gate"] * GATE_SCALE
    jparams = jax.tree.map(lambda a, ref: jax.device_put(a, ref.sharding), tree, jparams)
    jopt, jlr, jb2 = jpipe.initialize_optimizer(jmodel, jparams)
    jtrainer = jpipe.initialize_trainer(jmodel, jparams, jopt, jlr, jb2)
    d = config["data"]
    micro_num, P = d["micro_num"], d["micro_bsz"] * d["seq_len"]
    batch = _tiny_batch(micro_num, P, config["model"]["vocab_size"], seed=22)  # margin 6.8e-4 at step 0
    jbatch = jax.tree.map(jnp.asarray, batch)

    tcfg = TConfig(config)
    tmodel, _ = tpipe.initialize_model(tcfg, "cpu", torch.Generator().manual_seed(0))
    tparams = params_from_jax(tree, "cpu")
    topt, tlr, tb2 = tpipe.initialize_optimizer(tmodel, tparams, tcfg)
    ttrainer = tpipe.initialize_trainer(tmodel, tparams, topt, tlr, tb2, tcfg)
    tbatch = train_batch(batch)

    losses = []
    for step in range(3):
        routing = _port_routing(tmodel, ttrainer.engine.params, tbatch)
        margin = min(m for _, m in routing)
        assert margin > 1e-4, f"step {step}: a token lies {margin} from a routing tie"
        jcounts = _jax_counts(jmodel, jtrainer.engine.params, batch)
        for (tc, _), jc in zip(routing, jcounts):
            np.testing.assert_array_equal(tc, jc, err_msg=f"step {step}")
        jm = jtrainer.execute_schedule(jbatch)
        tm = ttrainer.execute_schedule(tbatch)
        losses.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=5e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["moe_loss"]), float(jm["moe_loss"]), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert set(tm["grad_norm_groups"]) == set(jm["grad_norm_groups"]) >= {"moe"}
        for g, v in jm["grad_norm_groups"].items():
            np.testing.assert_allclose(float(tm["grad_norm_groups"][g]), float(v), rtol=1e-4, err_msg=g)
        assert float(tm["moe_loss"]) > 0
    assert losses[2] < losses[1] < losses[0], losses
