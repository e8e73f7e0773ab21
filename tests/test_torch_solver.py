"""The port's solver against ``internevo_tpu.solver`` on the same numpy
trees: the lr and beta2 schedules, ``optimizer_step`` over three steps
(clipping on and off, an injected inf grad that skips the step and backs off
the scale, hysteresis, growth, the -1/-2 norm sentinels, group norms), every
leaf's update going through the fused AdamW wrapper, and the fused AdamW
plain version against the Pallas kernel in interpret mode.

Tolerances (fp32): m, v and the step's scalars rtol 1e-6 (the same
expressions, except that the port divides by the bias corrections through
their inverses, as the JAX kernel does, where the JAX step divides by them);
params and masters rtol 1e-6 / atol 1e-7, the JAX fused-AdamW test's bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.ops.pallas.fused_adamw import fused_adamw_update
from internevo_tpu.solver import lr_scheduler as jlr
from internevo_tpu.solver import optimizer as jopt
from internevo_tpu_torch.ops.cuda import fused_adamw as tfa
from internevo_tpu_torch.solver import lr_scheduler as tlr
from internevo_tpu_torch.solver import optimizer as topt

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(rng, dtype=np.float32):
    """A small tree with every param group: embedding/head (embed_head),
    bf16-kind norms (fp32 group), the final norm, and dense leaves."""
    return {
        "embedding": {"weight": rng.randn(16, 8).astype(dtype)},
        "blocks": {"norm1": (1 + 0.1 * rng.randn(2, 8)).astype(dtype),
                   "wqkv": {"kernel": rng.randn(2, 8, 24).astype(dtype)}},
        "norm": (1 + 0.1 * rng.randn(8)).astype(np.float32),
        "head": {"kernel": rng.randn(8, 16).astype(dtype)},
    }


def _to_torch(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _run_both(grad_seq, adam_cfg_kw=None, scaler_kw=None, lrs=(1e-3, 5e-4, 2e-4), beta2s=(None, 0.99, None)):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    jcfg, tcfg = jopt.AdamWConfig(**(adam_cfg_kw or {})), topt.AdamWConfig(**(adam_cfg_kw or {}))
    jsc, tsc = jopt.GradScalerConfig(**(scaler_kw or {})), topt.GradScalerConfig(**(scaler_kw or {}))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_optimizer_state(jp, jsc)
    tp = _to_torch(params)
    ts = topt.init_optimizer_state(tp, tsc)
    jstats, tstats = [], []
    for grads, lr, b2 in zip(grad_seq, lrs, beta2s):
        jp, js, st = jopt.optimizer_step(jp, jax.tree.map(jnp.asarray, grads), js, jnp.asarray(lr, jnp.float32),
                                         b2, adam_cfg=jcfg, scaler_cfg=jsc)
        jstats.append(st)
        tp, ts, st = topt.optimizer_step(tp, _to_torch(grads), ts, lr, b2, adam_cfg=tcfg, scaler_cfg=tsc)
        tstats.append(st)
    return (jp, js, jstats), (tp, ts, tstats)


def _grads(seed, scale=1.0, poison=None):
    g = jax.tree.map(lambda a: (a * scale).astype(np.float32), _tree(np.random.RandomState(seed)))
    if poison is not None:
        g["blocks"]["wqkv"]["kernel"][0, 0, 0] = poison
    return g


def _assert_trees(t, j, **tol):
    flat_j = sorted(jax.tree_util.tree_leaves_with_path(j), key=lambda kv: jax.tree_util.keystr(kv[0]))
    flat_t = sorted(topt.tree_leaves_with_path(t))
    assert [p for p, _ in flat_t] == [jax.tree_util.keystr(p) for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=path, **(tol or TOL))


def _assert_steps(j, t):
    (jp, js, jstats), (tp, ts, tstats) = j, t
    _assert_trees(tp, jp)
    for k in ("master", "m", "v"):
        _assert_trees(ts[k], js[k])
    for k in ("step", "growth_tracker", "hysteresis_tracker", "num_skipped"):
        assert int(ts[k]) == int(js[k]), k
    assert float(ts["grad_scale"]) == float(js["grad_scale"])
    for a, b in zip(tstats, jstats):
        np.testing.assert_allclose(float(a["grad_norm"]), float(b["grad_norm"]), rtol=1e-6)
        assert bool(a["found_inf"]) == bool(b["found_inf"])
        assert float(a["loss_scale"]) == float(b["loss_scale"])
        assert sorted(a["grad_norm_groups"]) == sorted(b["grad_norm_groups"])
        for g in b["grad_norm_groups"]:
            np.testing.assert_allclose(float(a["grad_norm_groups"][g]), float(b["grad_norm_groups"][g]),
                                       rtol=1e-6, err_msg=g)


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_three_steps_match_jax(clip):
    seq = [_grads(1, 3.0), _grads(2, 0.1), _grads(3)]
    _assert_steps(*_run_both(seq, adam_cfg_kw=dict(clip_grad_norm=clip)))


@pytest.mark.parametrize("poison,sentinel", [(np.inf, -1.0), (np.nan, -2.0)], ids=["inf", "nan"])
def test_overflow_skips_and_backs_off(poison, sentinel):
    """fp16-style scaler: a poisoned grad skips the step (params, m, v and the
    step count unchanged), reports the sentinel, and with hysteresis 1 halves
    the scale at once."""
    seq = [_grads(1, 2.0**10), _grads(2, 2.0**10, poison=poison), _grads(3, 2.0**9)]
    j, t = _run_both(seq, scaler_kw=dict(initial_scale=2.0**10, hysteresis=1))
    _assert_steps(j, t)
    _, ts, tstats = t
    assert float(tstats[1]["grad_norm"]) == sentinel and bool(tstats[1]["found_inf"])
    assert int(ts["step"]) == 2 and int(ts["num_skipped"]) == 1
    assert float(ts["grad_scale"]) == 2.0**9


def test_hysteresis_and_growth():
    """Hysteresis 2: the first overflow only counts; the second backs off.
    Growth interval 1: a clean step doubles the scale and resets the count."""
    seq = [_grads(1, poison=np.inf), _grads(2), _grads(3, poison=np.inf), _grads(4, poison=np.inf)]
    scaler = dict(initial_scale=8.0, hysteresis=2, growth_interval=1, min_scale=1.0)
    j, t = _run_both(seq, scaler_kw=scaler, lrs=(1e-3,) * 4, beta2s=(None,) * 4)
    _assert_steps(j, t)
    assert [float(s["loss_scale"]) for s in t[2]] == [8.0, 8.0, 16.0, 16.0]
    assert float(t[1]["grad_scale"]) == 8.0 and int(t[1]["num_skipped"]) == 3


def test_every_leaf_goes_through_the_fused_wrapper(monkeypatch):
    """``optimizer_step`` updates each leaf -- the bf16 weight and the fp32
    final norm alike -- through ``fused_adamw_update_``, which runs the plain
    version for CPU tensors (whose numbers ``test_three_steps_match_jax``
    holds against JAX): each param is its new master's cast, and no kernel
    launches."""
    rng = np.random.RandomState(5)
    params = {"w": torch.from_numpy(rng.randn(4, 64).astype(np.float32)).to(torch.bfloat16),
              "norm": torch.from_numpy(rng.randn(64).astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.randn(4, 64).astype(np.float32)),
             "norm": torch.from_numpy(rng.randn(64).astype(np.float32))}
    seen = []
    wrapper = tfa.fused_adamw_update_

    def counting(g, m, v, w, p, scalars):
        seen.append(p.dtype)
        wrapper(g, m, v, w, p, scalars)

    monkeypatch.setattr(tfa, "fused_adamw_update_", counting)
    p = topt.tree_map(torch.clone, params)
    s = topt.init_optimizer_state(p)
    topt.optimizer_step(p, grads, s, 1e-3)
    assert sorted(map(str, seen)) == ["torch.bfloat16", "torch.float32"]

    for k in ("w", "norm"):
        assert torch.equal(p[k], s["master"][k].to(p[k].dtype)), k
        assert not torch.equal(s["master"][k], params[k].float()), k
    assert tfa.launches == 0


@pytest.mark.parametrize("skip", [0.0, 1.0])
@pytest.mark.parametrize("gdtype", ["bfloat16", "float32"])
def test_plain_adamw_matches_pallas_kernel(skip, gdtype):
    rng = np.random.RandomState(0)
    shape = (64, 1024)
    g = jnp.asarray(rng.randn(*shape), getattr(jnp, gdtype))
    m = jnp.asarray(rng.randn(*shape) * 0.1, jnp.float32)
    v = jnp.asarray(np.abs(rng.randn(*shape)) * 0.01, jnp.float32)
    w = jnp.asarray(rng.randn(*shape), jnp.float32)
    b1, b2 = 0.9, 0.95
    bias1, bias2 = 1 - b1**3, 1 - b2**3
    sc = [1e-3, b1, b2, 1 / bias1, 1 / bias2, 1e-8, 0.01, 0.7, skip]
    want = fused_adamw_update(g, m, v, w, jnp.asarray(sc, jnp.float32), interpret=True)
    T = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    tg = T(g).to(getattr(torch, gdtype))
    tm, tv, tw = T(m), T(v), T(w)
    tp = torch.empty(shape, dtype=torch.bfloat16)
    scalars = tfa.adamw_scalars(1e-3, b1, b2, bias1, bias2, 1e-8, 0.01, 0.7, skip, "cpu")
    tfa.fused_adamw_update_(tg, tm, tv, tw, tp, scalars)
    for got, ref, name in zip((tm, tv, tw, tp), want, ("m", "v", "master", "param")):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), err_msg=name, **TOL)


def test_fused_adamw_takes_float_params_and_refuses_others():
    """The wrapper writes the param in its own dtype (the JAX guard's bf16
    condition is not the port's): an fp32 param gets the fp32 master's
    values; a float64 param is refused."""
    rng = np.random.RandomState(7)
    g, m, w = (torch.from_numpy(rng.randn(64).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy(np.abs(rng.randn(64)).astype(np.float32))
    sc = tfa.adamw_scalars(1e-3, 0.9, 0.95, 0.1, 0.05, 1e-8, 0.01, 1.0, 0.0, "cpu")
    p = torch.empty(64)
    tfa.fused_adamw_update_(g, m, v, w, p, sc)
    assert torch.equal(p, w)
    z = torch.zeros(8)
    with pytest.raises(TypeError, match="bf16, fp16 or fp32 param"):
        tfa.fused_adamw_update_(z, z, z, z, z.double(), tfa.adamw_scalars(1, 0.9, 0.9, 1, 1, 0, 0, 1, 0, "cpu"))


def test_norms_match_jax():
    """``global_norm`` and ``param_group_norms`` with the unscale folded in
    before squaring: a loss scale of 2^60 does not overflow fp32."""
    grads = _grads(6, 2.0**60)
    jg = jax.tree.map(jnp.asarray, grads)
    tg = _to_torch(grads)
    np.testing.assert_allclose(float(topt.global_norm(tg, 2.0**-60)),
                               float(jopt.global_norm(jg, 2.0**-60)), rtol=1e-6)
    want = jopt.param_group_norms(jg, 2.0**-60)
    got = topt.param_group_norms(tg, 2.0**-60)
    assert sorted(got) == sorted(want) == ["default", "embed_head", "fp32"]
    for g in want:
        assert np.isfinite(float(got[g]))
        np.testing.assert_allclose(float(got[g]), float(want[g]), rtol=1e-6, err_msg=g)


def test_param_group_of_matches_jax():
    paths = ["['blocks']['norm1']", "['blocks'][3]['norm2']", "['norm']", "['embedding']['weight']",
             "['head']['weight']", "['blocks'][0]['wqkv']['bias']", "['blocks']['moe']['w1']",
             "['blocks']['moe']['coefficient']", "blocks/norm1", "['blocks']['normalizer']"]
    assert [topt.param_group_of(p) for p in paths] == [jopt.param_group_of(p) for p in paths]


def test_schedulers_match_jax():
    for tsched, jsched in [
        (tlr.CosineAnnealingWarmupLR(1e-3, 50, 5, 1e-5), jlr.CosineAnnealingWarmupLR(1e-3, 50, 5, 1e-5)),
        (tlr.FineTuneCosineAnnealingWarmupLR(1e-4, 100, init_steps=3, warmup_ratio=0.1, eta_min=1e-6),
         jlr.FineTuneCosineAnnealingWarmupLR(1e-4, 100, init_steps=3, warmup_ratio=0.1, eta_min=1e-6)),
    ]:
        assert [tsched.get_lr(s) for s in range(110)] == [jsched.get_lr(s) for s in range(110)]
    for c in (0.0, 0.8):
        tb, jb = tlr.Beta2Scheduler(0.95, c), jlr.Beta2Scheduler(0.95, c)
        assert [tb.get_beta2(s) for s in range(50)] == [jb.get_beta2(s) for s in range(50)]
    from internevo_tpu.core.config import Config as JConfig
    from internevo_tpu_torch.core.config import Config as TConfig

    adam, sched = dict(lr=3e-4), dict(total_steps=40, init_steps=2, warmup_ratio=0.05, eta_min=1e-5)
    t = tlr.build_lr_scheduler(TConfig(adam), TConfig(sched))
    j = jlr.build_lr_scheduler(JConfig(adam), JConfig(sched))
    assert t.state_dict() == j.state_dict()
    assert [t.get_lr(s) for s in range(45)] == [j.get_lr(s) for s in range(45)]
