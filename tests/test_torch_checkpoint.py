"""The port's checkpoints (``internevo_tpu_torch/checkpoint/checkpoint_manager.py``
and ``train/main.py``'s save protocol) on the CPU, held against the JAX
package's ``internevo_tpu/checkpoint/checkpoint_manager.py``:

- the save, snapshot and stop-file decisions for steps 0-60 (both managers,
  the same config);
- the auto-resume pick, the newest ``.step`` stamp whatever order
  ``os.walk`` meets the folders in;
- ``CheckpointLoadMask``;
- save at step k and resume for 3 steps equals k + 3 uninterrupted steps
  bit for bit (losses, params, masters, moments, counters, batches), dense
  and GShard MoE, with the async write on and off;
- the ``context.pkl`` of a 3-step run from the same params equals JAX's, and
  the optimizer state agrees with JAX's orbax ``arrays_opt`` within fp32
  rtol 5e-5 (``doc/perf_notes.md:287-289``);
- a model-only load, the async save's contract, and the emulated object
  store (``tests/test_utils/test_checkpoint.py:109-160``)."""

import os
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from internevo_tpu.checkpoint import checkpoint_manager as jcm
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.checkpoint import checkpoint_manager as tcm
from internevo_tpu_torch.models.jax_bridge import opt_state_to_numpy, params_from_jax
from internevo_tpu_torch.solver.lr_scheduler import CosineAnnealingWarmupLR
from internevo_tpu_torch.solver.optimizer import tree_leaves, tree_leaves_with_path
from internevo_tpu_torch.train import main as tmain
from tests.test_training import test_loss

GSHARD_MOE = dict(model_type="INTERNLM_MoE", model=dict(num_experts=4, top_k=2, moe_type="GShard"),
                  loss=dict(label_smoothing=0, moe_loss_coeff=0.01))
COUNTERS = ("batch_count", "step_count", "num_consumed_tokens", "num_consumed_samples_in_epoch",
            "inf_nan_skip_batches", "sampler_consumed_batches", "sampler_consumed_samples")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)  # the JAX model on the CPU runs its jnp attention
    yield
    set_use_pallas(None)


class _State:
    def __init__(self, step=0):
        self.step_count = step
        self.batch_count = step

    def state_dict(self):
        return {"batch_count": self.batch_count, "num_consumed_samples_in_epoch": 0, "num_consumed_tokens": 0,
                "inf_nan_skip_batches": 0, "step_count": self.step_count}

    def load_state_dict(self, d, train_dl=None):
        self.batch_count = d["batch_count"] + 1
        self.step_count = d["step_count"]


class _Engine:
    """The engine surface the manager reads: params, opt_state, lr_scheduler."""

    def __init__(self, fill=0.0):
        self.params = {"w": torch.arange(8, dtype=torch.float32) + fill,
                       "blocks": [{"b": torch.full((2, 3), fill, dtype=torch.bfloat16)}]}
        self.opt_state = {"m": {"w": torch.ones(8) * (1 + fill)}, "step": torch.tensor(3 + int(fill))}
        self.lr_scheduler = CosineAnnealingWarmupLR(lr=1e-3, total_steps=100, warmup_steps=10)
        self.resets = 0

    def reset_step_count(self):
        self.resets += 1


def _ckpt_cfg(folder, **kw):
    return {**dict(enable_save_ckpt=True, save_ckpt_folder=str(folder), checkpoint_every=5, auto_resume=True,
                   async_upload=False, oss_snapshot_freq=0, load_ckpt_info=None), **kw}


# ------------------------------------------------------------------ decisions


@pytest.mark.parametrize("every,snap", [(50, 25), (10, 0), (7, 3), (0, 5)], ids=lambda x: str(x))
@pytest.mark.parametrize("stop", ["+13", "-13", "", "garbage"], ids=["plus", "minus", "empty", "garbage"])
def test_save_decisions_match_jax(every, snap, stop, tmp_path, monkeypatch):
    """For steps 0-60: whether to save, the path, and whether to quit."""
    stop_file = tmp_path / "stop"
    stop_file.write_text(stop)
    cfg = _ckpt_cfg(tmp_path / "ck", checkpoint_every=every, oss_snapshot_freq=snap, stop_file_path=str(stop_file))
    got = {}
    for name, mod in (("jax", jcm), ("port", tcm)):
        mgr = mod.CheckpointManager(dict(cfg), engine=None)
        paths = []
        monkeypatch.setattr(mgr, "save_checkpoint", lambda path, ts, block=True, paths=paths: paths.append(path))
        got[name] = []
        for step in range(61):
            quit_now = mgr.try_save_checkpoint(_State(step))
            got[name].append((step, quit_now, paths.pop() if paths else None))
    assert got["port"] == got["jax"]
    assert any(p for _, _, p in got["port"]) and not any(paths)


@pytest.mark.parametrize("walk_order,want", [
    ([("30", 30), ("200", 200), ("10", 10)], "200"),
    ([("snapshot/1", 60), ("50", 50)], "snapshot/1"),
    ([("50", 50), ("snapshot/1", 25)], "50"),
], ids=["walk_order_30_200_10", "snapshot_newer", "numbered_newer"])
def test_auto_resume_picks_the_newest_stamp(walk_order, want, tmp_path, monkeypatch):
    """C1: the folder whose stamp names the highest step, whatever order
    ``os.walk`` meets the folders in (30, 200, 10 in the first case)."""
    root = tmp_path / "llm"
    for rel, step in walk_order:
        (root / rel).mkdir(parents=True)
        (root / rel / f"{step}.step").write_text(str(step))
    walk = [(str(root), sorted({rel.split("/")[0] for rel, _ in walk_order}), [])]
    walk += [(str(root / rel), [], ["context.pkl", f"{step}.step"]) for rel, step in walk_order]
    monkeypatch.setattr(os, "walk", lambda top, *a, **k: iter(walk) if str(top) == str(root) else iter([]))
    picks = [mod.CheckpointManager(dict(_ckpt_cfg(root))).query_latest_snapshot_step_local() for mod in (jcm, tcm)]
    assert picks == [str(root / want)] * 2


@pytest.mark.parametrize("content", [("model",), ("all",), ("model", "optimizer"), ("MODEL", "sampler"),
                                     ("scheduler",)], ids=lambda c: "_".join(c))
def test_load_mask_matches_jax(content):
    j, t = jcm.CheckpointLoadMask(content), tcm.CheckpointLoadMask(content)
    assert j.load_set == t.load_set and str(j) == str(t)
    for c in ("model", "sampler", "optimizer", "scheduler"):
        assert (j.need_load(c), j.not_only_load(c), j.only_load(c)) == (t.need_load(c), t.not_only_load(c),
                                                                         t.only_load(c))


# ------------------------------------------------------------------ resume


def _loop_cfg(folder, overrides, every, async_upload):
    return test_loss.demo_config(ckpt=dict(enable_save_ckpt=True, save_ckpt_folder=f"local:{folder}",
                                           checkpoint_every=every, async_upload=async_upload, oss_snapshot_freq=0,
                                           auto_resume=True),
                                 enable_tb=False, **overrides)


def _run(cfg, steps, monkeypatch):
    """``run_training``, and the input ids of the batches it loaded, in order."""
    seen = []
    load = tmain.load_new_batch

    def spy(train_dl, train_iter, train_state):
        batch, it = load(train_dl, train_iter, train_state)
        seen.append(batch[0]["input_ids"].copy())
        return batch, it

    monkeypatch.setattr(tmain, "load_new_batch", spy)
    out = tmain.run_training(cfg, device="cpu", steps=steps)
    out["batches"] = seen
    return out


def _same_tree(a, b):
    pa, pb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("async_upload", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("overrides", [{}, GSHARD_MOE], ids=["dense", "gshard_moe"])
def test_resume_is_bit_for_bit(overrides, async_upload, tmp_path, monkeypatch):
    """Save at step 2, resume for 3 steps: the same losses, grad norms,
    params, masters, moments, counters and batches as 5 uninterrupted steps
    (the GShard gate's noise folds the applied-step count, which the resume
    must re-read).  The interrupted run goes one step past its save, so the
    save is made with the next batch already loaded, as in a long run."""
    k = 2
    full = _run(_loop_cfg(tmp_path / "a", overrides, k, async_upload), k + 3, monkeypatch)
    first = _run(_loop_cfg(tmp_path / "b", overrides, k, async_upload), k + 1, monkeypatch)
    assert (tmp_path / "b" / str(k) / f"{k}.step").exists() and first["saved_after"] == [k - 1]
    resumed = _run(_loop_cfg(tmp_path / "b", overrides, k, async_upload), k + 3, monkeypatch)
    assert resumed["ckpt_manager"].load_record["path"] == f"{tmp_path / 'b'}/{k}"
    tail = full["records"][k:]
    assert [r["step"] for r in resumed["records"]] == [r["step"] for r in tail] == list(range(k, k + 3))
    for key in ("loss", "grad_norm", "moe_loss", "lr", "real_tokens"):
        assert [r[key] for r in resumed["records"]] == [r[key] for r in tail], key
    for a, b in zip(resumed["batches"], full["batches"][k:]):
        np.testing.assert_array_equal(a, b)
    _same_tree(resumed["engine"].params, full["engine"].params)
    _same_tree(resumed["engine"].opt_state, full["engine"].opt_state)
    for c in COUNTERS:
        assert getattr(resumed["train_state"], c) == getattr(full["train_state"], c), c
    assert resumed["engine"].step_count == full["engine"].step_count == k + 3


def _same_meta(got, want, where="context"):
    """Equal nested dicts, lists and arrays (an array's dtype too)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (where, sorted(got), sorted(want))
        for k in want:
            _same_meta(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_meta(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got, want)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


def test_resume_rereads_the_step_count(tmp_path):
    """An engine whose step count was read before the load reads the loaded
    one after it (the lr schedule and the gate noise follow it)."""
    saved = tmain.run_training(_loop_cfg(tmp_path / "a", {}, 2, False), device="cpu", steps=2)
    from internevo_tpu_torch.core.trainer import TrainState
    from internevo_tpu_torch.initialize.launch import launch
    from internevo_tpu_torch.train.pipeline import initialize_model, initialize_optimizer, initialize_trainer

    config = launch(_loop_cfg(tmp_path / "a", {}, 2, False), device="cpu").config
    model, params = initialize_model(config, "cpu", torch.Generator().manual_seed(3))
    engine = initialize_trainer(model, params, *initialize_optimizer(model, params, config), config).engine
    assert engine.step_count == 0
    train_state = TrainState(config)
    tcm.CheckpointManager(config.ckpt, engine=engine, train_state=train_state).try_resume_training(train_state)
    assert engine.step_count == 2 == train_state.step_count
    _same_tree(engine.params, saved["engine"].params)


def _jax_train_and_save(config, steps):
    """JAX's ``train.py`` loop on one device for ``steps`` steps, then its
    save: the initial params (numpy)."""
    from internevo_tpu.core.context import gpc
    from internevo_tpu.core.trainer import TrainState
    from internevo_tpu.data.build_dataloader import build_train_loader_with_data_type
    from internevo_tpu.initialize.launch import launch
    from internevo_tpu.train.pipeline import (batch_to_device, initialize_model, initialize_optimizer,
                                              initialize_trainer, load_new_batch)

    launch(config, seed=1024, devices=jax.devices()[:1])
    model, params = initialize_model()
    tree = jax.tree.map(np.asarray, params)
    opt_state, lr_sched, beta2_sched = initialize_optimizer(model, params)
    train_dl, _ = build_train_loader_with_data_type()
    train_state = TrainState(gpc.config, train_dl.batch_sampler)
    trainer = initialize_trainer(model, params, opt_state, lr_sched, beta2_sched)
    mgr = jcm.CheckpointManager(gpc.config.ckpt, engine=trainer.engine, train_state=train_state,
                                train_dl=train_dl, model_config=gpc.config.model)
    it = iter(train_dl)
    for i in range(steps):
        batch, it = load_new_batch(train_dl, it, train_state)
        train_state.batch_count = i
        train_state.num_consumed_tokens += int(np.asarray(batch[0]["input_ids"]).size)
        metrics = trainer.execute_schedule(batch_to_device(batch, micro_num=batch[0]["input_ids"].shape[0]))
        float(metrics["loss"])
        train_state.step_count += 1
    assert not mgr.try_save_checkpoint(train_state)
    mgr.wait_async_upload_finish()
    return tree


def test_checkpoint_matches_jax(tmp_path):
    """3 steps from the same params, then a save: ``context.pkl`` equals
    JAX's, the optimizer state agrees with JAX's orbax ``arrays_opt``."""
    import orbax.checkpoint as ocp

    def cfg(folder):
        return test_loss.demo_config(ckpt=dict(enable_save_ckpt=True, save_ckpt_folder=str(folder),
                                               checkpoint_every=3, async_upload=False, oss_snapshot_freq=0,
                                               auto_resume=False), enable_tb=False)

    tree = _jax_train_and_save(cfg(tmp_path / "jax"), 3)
    tmain.run_training(cfg(tmp_path / "port"), params=params_from_jax(tree, "cpu"), device="cpu", steps=3)
    jdir, tdir = tmp_path / "jax" / "3", tmp_path / "port" / "3"
    assert (jdir / "3.step").exists() and (tdir / "3.step").exists()
    with open(jdir / "context.pkl", "rb") as f, open(tdir / "context.pkl", "rb") as g:
        jmeta, tmeta = pickle.load(f), pickle.load(g)
    _same_meta(tmeta, jmeta)
    jopt = ocp.StandardCheckpointer().restore((jdir / "arrays_opt").resolve())["opt_state"]
    topt = opt_state_to_numpy({p.stem: torch.load(p, weights_only=True) for p in (tdir / "arrays_opt").glob("*.pt")})
    jleaves, tleaves = jax.tree_util.tree_leaves_with_path(jopt), jax.tree_util.tree_leaves_with_path(topt)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == [jax.tree_util.keystr(p) for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        want = np.asarray(a, np.float64)
        # rtol 5e-5 of each element, or of the leaf's largest where an element
        # is near zero (a moment's sum of opposite grads cancels there)
        np.testing.assert_allclose(np.asarray(b, np.float64), want, rtol=5e-5, atol=5e-5 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_model_only_load_keeps_counters_and_optimizer_fresh(tmp_path):
    """``content=("model",)``: the params load; the counters, step and
    moments stay fresh, as in JAX, and the fp32 masters restart from the
    loaded params (the reference's ``reload_zero_fp32_buff``; JAX keeps the
    masters of the random init, which the first step would write back over
    the loaded params)."""
    saved = tmain.run_training(_loop_cfg(tmp_path / "a", {}, 3, False), device="cpu", steps=3)
    cfg = test_loss.demo_config(ckpt=dict(auto_resume=False, load_ckpt_info=dict(
        path=f"local:{tmp_path / 'a' / '3'}", content=("model",), ckpt_type="internevo")), enable_tb=False)
    out = tmain.run_training(cfg, device="cpu", seed=7, steps=0)
    engine, ts = out["engine"], out["train_state"]
    _same_tree(engine.params, saved["engine"].params)
    assert all(getattr(ts, c) == 0 for c in COUNTERS)
    assert int(engine.opt_state["step"]) == 0 and engine.step_count == 0
    assert all(not t.any() for key in ("m", "v") for t in tree_leaves(engine.opt_state[key]))
    for m, p in zip(tree_leaves(engine.opt_state["master"]), tree_leaves(engine.params)):
        assert torch.equal(m, p.float())


def test_model_only_load_in_jax_leaves_the_optimizer(tmp_path):
    """JAX's side of the case above, on its own manager: a model-only load
    touches neither the train state nor the optimizer state."""
    import jax.numpy as jnp

    class _JEngine:
        def __init__(self, w):
            self.params = {"w": jnp.full((8,), w, jnp.float32)}
            self.opt_state = {"m": jnp.full((8,), w, jnp.float32), "step": jnp.asarray(int(w))}
            self.lr_scheduler = CosineAnnealingWarmupLR(lr=1e-3, total_steps=100, warmup_steps=10)

    engine, ts = _JEngine(3.0), _State(7)
    jcm.CheckpointManager(_ckpt_cfg(tmp_path), engine=engine, train_state=ts).save_checkpoint(
        str(tmp_path / "7"), ts)
    fresh, fresh_ts = _JEngine(0.0), _State(0)
    jcm.try_load_internevo_ckpt(fresh, fresh_ts, str(tmp_path / "7"), jcm.CheckpointLoadMask(("model",)))
    np.testing.assert_array_equal(fresh.params["w"], np.full(8, 3.0))
    assert not np.asarray(fresh.opt_state["m"]).any() and int(fresh.opt_state["step"]) == 0
    assert (fresh_ts.step_count, fresh_ts.batch_count) == (0, 0)


# ------------------------------------------------------------------ async save


def test_async_save_holds_the_snapshot_and_stamps_last(tmp_path, monkeypatch):
    """The file holds the state as of ``save_checkpoint``'s return, not an
    in-place update made after it; no stamp exists before the write lands."""
    engine, ts = _Engine(), _State(7)
    mgr = tcm.CheckpointManager(_ckpt_cfg(tmp_path, async_upload=True), engine=engine, train_state=ts)
    release = threading.Event()
    save = torch.save

    def slow_save(obj, path, *a, **k):
        assert release.wait(timeout=30)
        save(obj, path, *a, **k)

    monkeypatch.setattr(tcm.torch, "save", slow_save)
    mgr.save_checkpoint(str(tmp_path / "7"), ts, block=False)
    engine.params["w"].add_(100.0)  # the next step's in-place update
    engine.opt_state["m"]["w"].mul_(-1)
    assert not (tmp_path / "7" / "7.step").exists()
    release.set()
    mgr.wait_async_upload_finish()
    assert (tmp_path / "7" / "7.step").read_text() == "7"
    stored = torch.load(tmp_path / "7" / "arrays_model" / "params.pt", weights_only=True)
    assert torch.equal(stored["w"], torch.arange(8, dtype=torch.float32))
    assert torch.equal(torch.load(tmp_path / "7" / "arrays_opt" / "m.pt", weights_only=True)["w"], torch.ones(8))
    record = mgr.save_records[0]
    assert record["bytes"] > 0 and record["stamp_s"] >= record["snapshot_s"] > 0


def test_async_write_error_raises_at_the_barrier(tmp_path, monkeypatch):
    engine, ts = _Engine(), _State(7)
    mgr = tcm.CheckpointManager(_ckpt_cfg(tmp_path, async_upload=True), engine=engine, train_state=ts)

    def full_disk(obj, path, *a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(tcm.torch, "save", full_disk)
    mgr.save_checkpoint(str(tmp_path / "7"), ts, block=False)  # returns: the write runs behind
    with pytest.raises(OSError, match="No space left"):
        mgr.wait_async_upload_finish()
    assert not (tmp_path / "7" / "7.step").exists()
    assert mgr.query_latest_snapshot_step_local() is None


def test_load_refuses_a_mismatched_leaf(tmp_path):
    engine, ts = _Engine(), _State(7)
    tcm.CheckpointManager(_ckpt_cfg(tmp_path), engine=engine, train_state=ts).save_checkpoint(
        str(tmp_path / "7"), ts)
    other = _Engine(5.0)
    other.params["blocks"][0]["b"] = torch.zeros((2, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match=r"\['blocks'\]\[0\]\['b'\].*bfloat16.*float32"):
        tcm.try_load_internevo_ckpt(other, _State(), str(tmp_path / "7"), tcm.CheckpointLoadMask(("all",)))
    assert torch.equal(other.params["w"], torch.arange(8, dtype=torch.float32) + 5.0)  # nothing copied


# ------------------------------------------------------------------ object store


def _store(tmp_path, monkeypatch):
    root = tmp_path / "objstore"
    monkeypatch.setenv("IEVO_OBJECT_STORE_ROOT", str(root))
    return root


@pytest.mark.parametrize("async_upload", [False, True], ids=["sync", "async"])
def test_object_store_save_resume_roundtrip(async_upload, tmp_path, monkeypatch):
    """``boto3:s3://…``: the tree stages locally, uploads with md5 sidecars,
    the remote stamp lands last, auto-resume scans the store and downloads
    the tree back."""
    root = _store(tmp_path, monkeypatch)
    uri = "boto3:s3://bucket/ckpts"
    cfg = dict(_ckpt_cfg(uri, async_upload=async_upload), async_upload_tmp_folder=str(tmp_path / "stage"))
    engine, ts = _Engine(), _State(7)
    mgr = tcm.CheckpointManager(cfg, engine=engine, train_state=ts)
    mgr.save_checkpoint(f"{uri}/7", ts, block=not async_upload)
    mgr.wait_async_upload_finish()
    obj_dir = root / "boto3" / "bucket" / "ckpts" / "7"
    assert (obj_dir / "7.step").exists(), list(obj_dir.rglob("*"))
    assert (obj_dir / "context.pkl.md5").exists() and (obj_dir / "arrays_model" / "params.pt.md5").exists()
    assert not list((tmp_path / "stage").glob("ckpt_stage/*"))

    other, other_ts = _Engine(5.0), _State()
    mgr2 = tcm.CheckpointManager(cfg, engine=other, train_state=other_ts)
    assert mgr2.query_latest_snapshot_step_local() == f"{uri}/7"
    mgr2.try_resume_training(other_ts)
    _same_tree(other.params, _Engine().params)
    _same_tree(other.opt_state, _Engine().opt_state)
    assert other.resets == 1 and other_ts.step_count == 7


def test_object_store_md5_guard(tmp_path, monkeypatch):
    root = _store(tmp_path, monkeypatch)
    uri = "volc:vc://bucket/run1"
    cfg = dict(_ckpt_cfg(uri), async_upload_tmp_folder=str(tmp_path / "stage"))
    engine, ts = _Engine(), _State()
    mgr = tcm.CheckpointManager(cfg, engine=engine, train_state=ts)
    for step in (5, 15, 10):
        ts.step_count = step
        mgr.save_checkpoint(f"{uri}/{step}", ts)
    assert mgr.query_latest_snapshot_step_local() == f"{uri}/15"
    (root / "volc" / "bucket" / "run1" / "15" / "context.pkl").write_bytes(b"corrupted")
    with pytest.raises(IOError, match="md5 mismatch"):
        tcm.try_load_internevo_ckpt(engine, ts, f"{uri}/15", tcm.CheckpointLoadMask(("all",)))


def test_object_store_without_root_raises_jax_error(tmp_path, monkeypatch):
    monkeypatch.delenv("IEVO_OBJECT_STORE_ROOT", raising=False)
    errors = []
    for mod in (jcm, tcm):
        mgr = mod.CheckpointManager(dict(_ckpt_cfg("oss2:ali://bucket/x")))
        with pytest.raises(NotImplementedError) as e:
            mgr.query_latest_snapshot_step_local()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "IEVO_OBJECT_STORE_ROOT" in errors[0]
