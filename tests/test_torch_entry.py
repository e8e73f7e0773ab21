"""The port's entry point (``internevo_tpu_torch/train/main.py``) on the CPU:
its loop on ``tests/test_training/test_loss.py::demo_config()`` from JAX's
initial params against JAX's ``run_training`` for 3 steps (one device), a
GShard MoE variant of the same config, ``configs/demo.py`` through the CLI,
what it refused before the checkpoint and observability slice (saving, the
stop file, loading, auto-resume, eval, the writer, the memory profiler, the
diagnostics, alerts) running, the refusal of a layout over more than one
device, a run that starts fresh when the checkpoint folder it names holds
nothing, and ``--device cuda`` without a card.

Tolerance: losses fp32 rtol 5e-5 (``doc/perf_notes.md:287-289``), the same
data from both loaders (``tests/test_torch_data.py`` holds them byte for
byte)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.models.jax_bridge import params_from_jax
from internevo_tpu_torch.train import main as tmain
from tests.test_training import test_loss

STEPS = 3
DEMO = str(Path(__file__).resolve().parents[1] / "configs" / "demo.py")


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
def _in_tmp_path(tmp_path, monkeypatch):
    """The loop's default scalar writer makes ``tb_logs/`` in the working
    directory: let it make it here."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)  # the JAX model on the CPU runs its jnp attention
    yield
    set_use_pallas(None)


def _jax_run(config, monkeypatch):
    """JAX's ``run_training`` on one device for ``STEPS`` steps: (losses,
    its initial params as numpy)."""
    captured = {}
    init = test_loss.initialize_model

    def capture():
        model, params = init()
        captured["params"] = jax.tree.map(np.asarray, params)
        return model, params

    monkeypatch.setattr(test_loss, "initialize_model", capture)
    losses, _ = test_loss.run_training(config, steps=STEPS, n_devices=1)
    return losses, captured["params"]


GSHARD_MOE = dict(model_type="INTERNLM_MoE", model=dict(num_experts=4, top_k=2, moe_type="GShard"),
                  loss=dict(label_smoothing=0, moe_loss_coeff=0.01))


@pytest.mark.parametrize("overrides", [{}, GSHARD_MOE], ids=["dense", "gshard_moe"])
def test_entry_loop_matches_jax_run_training(overrides, monkeypatch):
    jlosses, tree = _jax_run(test_loss.demo_config(**overrides), monkeypatch)
    out = tmain.run_training(test_loss.demo_config(**overrides), params=params_from_jax(tree, "cpu"),
                             device="cpu", steps=STEPS)
    losses = [r["loss"] for r in out["records"]]
    np.testing.assert_allclose(losses, jlosses, rtol=5e-5)
    assert [r["step"] for r in out["records"]] == list(range(STEPS))
    assert out["train_state"].step_count == STEPS and out["train_state"].batch_count == STEPS - 1
    assert len(out["load_wait_s"]) == STEPS
    if overrides:
        assert all(r["moe_loss"] > 0 for r in out["records"])
        assert not out["model"].config.moe_type.lower().startswith("megablock")


def test_cli_trains_demo_config_on_the_cpu(caplog):
    """``configs/demo.py`` as the CLI runs it: 20 steps, a falling loss."""
    import logging

    with caplog.at_level(logging.INFO, logger="internevo_tpu_torch"):
        tmain.main(["--config", DEMO, "--device", "cpu"])
    lines = [r.getMessage() for r in caplog.records if "tgs(tokens/gpu/second)" in r.getMessage()]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
    assert len(losses) == 20 and losses[-1] < losses[0], losses


REFUSED = {
    "tensor_parallel": (dict(parallel=dict(tensor=dict(size=2, mode="mtp"))), "A8"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_entry_refuses_what_is_not_ported(case, tmp_path):
    overrides, item = REFUSED[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}|{item}.*ROADMAP"):
        tmain.run_training(test_loss.demo_config(**overrides), device="cpu", steps=STEPS)


def _saved_run(folder, steps=2, **ckpt):
    """A run that leaves a stamped checkpoint of step ``steps`` in ``folder``."""
    ckpt = {**dict(enable_save_ckpt=True, save_ckpt_folder=f"local:{folder}", checkpoint_every=steps,
                   async_upload=False), **ckpt}
    cfg = test_loss.demo_config(ckpt=ckpt, enable_tb=False)
    return tmain.run_training(cfg, device="cpu", steps=steps)


def _ran_save(tmp_path, out):
    assert (tmp_path / "ck" / "2" / "2.step").read_text() == "2" and out["saved_after"] == [1]


def _ran_stop_file(tmp_path, out):
    assert out["stopped"] and [r["step"] for r in out["records"]] == [0, 1]
    assert (tmp_path / "ck" / "2" / "2.step").exists()


def _ran_load_existing(tmp_path, out):
    assert out["ckpt_manager"].load_record["path"] == f"local:{tmp_path / 'saved' / '2'}"
    assert out["train_state"].step_count == STEPS  # model only: the counters start fresh


def _ran_auto_resume(tmp_path, out):
    assert out["ckpt_manager"].load_record["path"] == str(tmp_path / "saved" / "snapshot" / "1")
    assert [r["step"] for r in out["records"]] == [2] and out["train_state"].step_count == STEPS


def _ran_eval(names):
    def check(tmp_path, out):
        assert [e["step"] for e in out["evals"]] == [2] and sorted(out["evals"][0]["results"]) == names
        assert all(np.isfinite(r["loss"]) and r["tokens"] > 0 for r in out["evals"][0]["results"].values())
    return check


def _ran_tensorboard(tmp_path, out):
    files = [p for p in (tmp_path / "tb").iterdir() if p.stat().st_size > 0]
    assert files and out["writer"].folder == str(tmp_path / "tb")


def _ran_memory_profiling(tmp_path, out):
    reports = out["memory_profiler"].reports
    assert [r["step"] for r in reports] == [1]
    assert reports[0]["params_total"] == "1.00MB" and reports[0]["optimizer_total"] == "3.01MB"


def _ran_diag(tmp_path, out):
    assert [d["batch"] for d in out["diags"]] == [1, 2] and all(d["tflops"] > 0 for d in out["diags"])


def _ran_alert(tmp_path, out):
    texts = [t for _, t in out["posts"]]
    assert any("started" in t for t in texts) and any("completed" in t for t in texts)
    assert {url for url, _ in out["posts"]} == {"http://localhost:9/hook"}


def _valid_folder(root):
    import json

    (root / "en").mkdir(parents=True)
    tokens = [list(range(1, 40)), list(range(5, 100)), list(range(3, 70)), list(range(7, 60))]
    lines = [(json.dumps({"tokens": t}) + "\n").encode() for t in tokens]
    (root / "en" / "val.bin").write_bytes(b"".join(lines))
    offsets = np.cumsum([0] + [len(ln) for ln in lines[:-1]])
    with open(root / "en" / "val.bin.meta", "wb") as f:
        np.save(f, np.stack([offsets, [len(t) for t in tokens]], axis=1).astype(np.int64))
    return str(root)


# what the entry point refused before the checkpoint and observability slice:
# each case's config, the run it needs beforehand, and what shows it ran
RAN = {
    "save": (lambda tmp: dict(ckpt=dict(enable_save_ckpt=True, save_ckpt_folder=f"local:{tmp}/ck",
                                        checkpoint_every=2)), None, _ran_save),
    "stop_file": (lambda tmp: dict(ckpt=dict(enable_save_ckpt=True, save_ckpt_folder=f"local:{tmp}/ck",
                                             checkpoint_every=100, stop_file_path=f"{tmp}/stop")),
                  lambda tmp: (tmp / "stop").write_text("+2"), _ran_stop_file),
    "load_existing": (lambda tmp: dict(ckpt=dict(auto_resume=False, load_ckpt_info=dict(
        path=f"local:{tmp}/saved/2", content=("model",)))), lambda tmp: _saved_run(tmp / "saved"),
        _ran_load_existing),
    "auto_resume_snapshot": (lambda tmp: dict(ckpt=dict(auto_resume=True, save_ckpt_folder=f"{tmp}/saved")),
                             lambda tmp: _saved_run(tmp / "saved", checkpoint_every=0, oss_snapshot_freq=2),
                             _ran_auto_resume),
    "valid_folder": (lambda tmp: dict(data=dict(valid_folder=_valid_folder(tmp / "val"), valid_every=2)), None,
                     _ran_eval(["en/val.bin"])),
    "valid_every": (lambda tmp: dict(data=dict(valid_every=2)), None, _ran_eval(["val"])),
    "tensorboard": (lambda tmp: dict(tensorboard_folder=f"{tmp}/tb", enable_tb=True), None, _ran_tensorboard),
    "memory_profiling": (lambda tmp: dict(enable_memory_profiling=True), None, _ran_memory_profiling),
    "diag": (lambda tmp: dict(data=dict(empty_cache_and_diag_interval=1)), None, _ran_diag),
    "alert": (lambda tmp: dict(monitor=dict(alert=dict(enable_feishu_alert=True,
                                                       feishu_alert_address="http://localhost:9/hook"))),
              None, _ran_alert),
}


@pytest.mark.parametrize("case", list(RAN))
def test_entry_runs_what_was_refused(case, tmp_path, monkeypatch):
    """Each feature the entry point once refused now runs, and shows it."""
    from internevo_tpu_torch.monitor import monitor

    overrides, before, ran = RAN[case]
    if before is not None:
        before(tmp_path)
    posts = []

    def urlopen(request, timeout):  # the alert's webhook, answered here
        posts.append((request.full_url, request.data.decode()))
        raise monitor.urllib.error.URLError("not sent")

    monkeypatch.setattr(monitor.urllib.request, "urlopen", urlopen)
    cfg = test_loss.demo_config(**{"enable_tb": False, **overrides(tmp_path)})
    out = tmain.run_training(cfg, device="cpu", steps=STEPS)
    out["posts"] = posts
    ran(tmp_path, out)


def test_entry_starts_fresh_with_nothing_to_load(tmp_path):
    """A named checkpoint that does not exist, and a save folder with no
    stamped snapshot, hold nothing to load: the run starts at step 0."""
    cfg = test_loss.demo_config(ckpt=dict(auto_resume=True, save_ckpt_folder=f"local:{tmp_path}",
                                          load_ckpt_info=dict(path=f"local:{tmp_path}/missing",
                                                              content=("model",))))
    out = tmain.run_training(cfg, device="cpu", steps=1)
    assert [r["step"] for r in out["records"]] == [0]


def test_cuda_run_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--config", DEMO])
