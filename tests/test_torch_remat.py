"""Activation recompute in the port (``core/remat.py`` under
``models/base.py::remat_policies``) on the CPU: every tier leaves the loss and
every grad bit for bit those of no recompute, dense and MoE, with both
dropouts on; the layer layout follows the JAX stacks (the MoE stack rounds
the recomputed count, the dense one truncates); counters show what each tier
keeps; and the fused CE's config knobs reach it and leave the loss as the
JAX trainer has it (rtol 5e-5)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.core import random as tr
from internevo_tpu_torch.core import remat
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.models import modeling_moe as tmoe
from internevo_tpu_torch.ops.cuda import splash_attention as splash
from internevo_tpu_torch.solver.optimizer import tree_leaves
from internevo_tpu_torch.ops.fused_ce import fused_norm_head_ce
from tests.test_torch_model import TINY, _torch_batch, packed_batch

BASE = dict(TINY, num_layers=3, num_attention_heads=4, num_kv_attention_heads=2, drop_rate=0.2, attn_drop_rate=0.3)
MOE = dict(num_experts=4, top_k=2, moe_type="MegaBlock-D", num_shared_experts=1)
TIERS = {"plain": {}, "mlp": dict(remat_save_mlp=1.0), "qkv": dict(remat_save_qkv=1.0),
         "both": dict(remat_save_mlp=0.5, remat_save_qkv=1.0), "offload": dict(activation_offload=True,
                                                                               remat_save_mlp=0.5)}


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
    set_use_pallas(False)  # the JAX trainer on the CPU runs its jnp attention
    yield
    set_use_pallas(None)


def _model(moe: bool, dtype=torch.float32, **kw):
    cfg = tbase.ModelConfig(**dict(BASE, **(MOE if moe else {}), **kw), dtype=dtype)
    init = tmoe.init_moe_params if moe else tbase.init_params
    forward = tmoe.moe_model_forward if moe else tbase.model_forward
    return cfg, init(cfg, torch.Generator().manual_seed(3), "cpu"), forward


def _loss_and_grads(cfg, params, forward, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    out = forward(cfg, params, batch["input_ids"], batch["indexes"], batch["segment_ids"],
                  dropout_rng=tr.fold_in(tr.PRNGKey(1024), 3), train=True, return_hidden=True)
    hidden, aux = out if isinstance(out, tuple) else (out, {"moe": 0.0})
    nll, n, _ = fused_norm_head_ce(hidden, params["norm"], params["head"]["weight"], batch["labels"],
                                   eps=cfg.layer_norm_epsilon, embed_grad_scale=cfg.embed_grad_scale)
    loss = nll / n + 0.01 * aux["moe"]
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in leaves]


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("checkpoint", [0.5, 1.0])
@pytest.mark.parametrize("moe,dtype", [(False, torch.float32), (False, torch.bfloat16), (True, torch.float32)],
                         ids=["dense", "dense_bf16", "moe"])
def test_recompute_is_bit_identical(moe, dtype, checkpoint, tier):
    batch = _torch_batch(packed_batch(2, 64, TINY["vocab_size"], seed=4))
    cfg, params, forward = _model(moe, dtype)
    want_loss, want = _loss_and_grads(cfg, params, forward, batch)
    got_loss, got = _loss_and_grads(dataclasses.replace(cfg, checkpoint=checkpoint, **TIERS[tier]), params, forward,
                                    batch)
    assert torch.equal(got_loss, want_loss)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _saves(policy):
    return None if policy is None else (sorted(policy.saves - {remat.FLASH}), sorted(policy.offload))


@pytest.mark.parametrize("kw,dense,moe", [
    # 3 layers at 0.5: the dense stack recomputes int(1.5) = 1, the MoE stack round(1.5) = 2
    (dict(checkpoint=0.5), [[], None, None], [[], [], None]),
    # gates in round(4 * 0.5) = 2 layers, q/k/v in 1: both first, then the larger tier
    (dict(num_layers=4, checkpoint=1.0, remat_save_mlp=0.5, remat_save_qkv=0.25),
     [["attn_qkv", "mlp_w1o", "mlp_w3o"], ["mlp_w1o", "mlp_w3o"], [], []],
     [["attn_qkv", "mlp_w1o", "mlp_w3o"], ["mlp_w1o", "mlp_w3o"], [], []]),
    (dict(num_layers=4, checkpoint=0.75, remat_save_qkv=0.5),
     [["attn_qkv"], ["attn_qkv"], [], None], [["attn_qkv"], ["attn_qkv"], [], None]),
    # offload: the dense stack keeps the splash output on the host in every
    # recomputed layer, and the gates on the device; the MoE stack ignores it
    (dict(checkpoint=1.0, activation_offload=True, remat_save_mlp=0.4, remat_save_qkv=1.0),
     [(["mlp_w1o", "mlp_w3o"], ["flash"])] * 3,
     [["attn_qkv", "mlp_w1o", "mlp_w3o"], ["attn_qkv"], ["attn_qkv"]]),
], ids=["odd_layers", "tiers", "partial", "offload"])
def test_layout_follows_the_jax_stacks(kw, dense, moe):
    cfg = tbase.ModelConfig(**dict(BASE, **kw))

    def norm(want):
        return [None if w is None else (w if isinstance(w, tuple) else (w, [])) for w in want]

    assert [_saves(p) for p in tbase.remat_policies(cfg)] == norm(dense)
    assert [_saves(p) for p in tbase.remat_policies(cfg, moe=True)] == norm(moe)


class _CountingF:
    """``torch.nn.functional`` with ``linear`` counting the products of the
    given weights."""

    def __init__(self, weights):
        self.ids, self.calls = {id(w) for w in weights}, 0

    def linear(self, x, w, b=None):
        self.calls += id(w) in self.ids
        return F.linear(x, w, b)

    def __getattr__(self, name):
        return getattr(F, name)


@pytest.mark.parametrize("tier,rotary_runs,gate_runs", [
    ("none", 1, 1), ("plain", 2, 2), ("qkv", 1, 2), ("mlp", 2, 1), ("both", 1, 1), ("offload", 2, 1)])
def test_what_each_tier_keeps(monkeypatch, tier, rotary_runs, gate_runs):
    """Per layer and micro-batch, under ``checkpoint=1``: the splash forward
    runs once whatever the tier; the rotary runs again in the recompute unless
    q, k, v are kept; the w1/w3 products run again unless the gates are (the
    offload tier keeps them in every layer once ``remat_save_mlp`` is set)."""
    kw = {} if tier == "none" else dict(checkpoint=1.0, **dict(TIERS, both=dict(remat_save_mlp=1.0,
                                                                                 remat_save_qkv=1.0))[tier])
    cfg, params, forward = _model(False, **kw)
    L = cfg.num_layers
    counts = {"splash": 0, "rotary": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(splash, "plain_forward", counting("splash", splash.plain_forward))
    monkeypatch.setattr(tbase, "apply_rotary", counting("rotary", tbase.apply_rotary))
    f = _CountingF([lyr[n]["weight"] for lyr in params["blocks"] for n in ("w1", "w3")])
    monkeypatch.setattr(tbase, "F", f)
    _loss_and_grads(cfg, params, forward, _torch_batch(packed_batch(2, 64, TINY["vocab_size"], seed=5)))
    assert counts == {"splash": L, "rotary": 2 * L * rotary_runs}  # q and k
    assert f.calls == 2 * L * gate_runs


def test_loss_knobs_reach_the_fused_ce(monkeypatch):
    """``loss.save_ce_logits`` and ``loss.ce_chunk_size`` of the config reach
    the fused CE of the port's train and eval steps, and the train step's
    loss stays the JAX trainer's under the same config (``gpc_loss_knobs``)."""
    from internevo_tpu_torch.core.scheduler import no_pipeline
    from tests.test_torch_dropout import _small_config, _trainers

    cfg = _small_config()
    cfg["loss"].update(save_ce_logits=True, ce_chunk_size=96)
    seen = []

    def spy(name, fn):
        def wrapped(*a, **k):
            seen.append((name, k.get("save_logits"), k.get("chunk_size")))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(no_pipeline, "fused_norm_head_ce", spy("train", no_pipeline.fused_norm_head_ce))
    monkeypatch.setattr(no_pipeline, "fused_norm_head_nll_tokens", spy("eval", no_pipeline.fused_norm_head_nll_tokens))
    jtrainer, ttrainer, jbatch, tbatch = _trainers(cfg)
    for step in range(2):
        jm, tm = jtrainer.execute_schedule(jbatch), ttrainer.execute_schedule(tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=5e-5, err_msg=f"step {step}")
    ttrainer.engine.run_eval_step({k: v[0] for k, v in tbatch.items()})
    assert set(seen) == {("train", True, 96), ("eval", None, 96)}
