"""The port's eval and the loop's observability on the CPU, held against the
JAX package where it has the same function:

- ``eval/evaluation.py::evaluate_on_val_dls`` against JAX's from the same
  params on ``demo_config()``: the same writer keys, the loss, accuracy,
  perplexity and typed ``AccPerplex`` bins within fp32 rtol 5e-5
  (``doc/perf_notes.md:287-289``), on the 500-sample ``RandomDataset`` and on
  a ``valid_folder`` of two typed ``.bin`` files;
- ``utils/writer.py``'s tensorboard and JSONL branches, and its swallowed
  errors;
- ``utils/gpudiag.py::timer_diagnosis`` raising the alerts of JAX's
  ``utils/tpudiag.py`` for one sequence of step times;
- ``utils/timeout.py::llm_timeout``;
- ``utils/simple_memory_profiler.py``'s layout bytes against JAX's;
- ``--profiling``'s trace of batches 3-6 (the loop stops it at batch 7);
- ``monitor/monitor.py``'s loss-spike and stuck alerts through a patched
  webhook."""

import json
import sys
import time
import urllib.error

import jax
import numpy as np
import pytest
import torch

from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.core.config import Config
from internevo_tpu_torch.data.build_dataloader import build_valid_loader_with_data_type
from internevo_tpu_torch.eval.evaluation import evaluate_on_val_dls
from internevo_tpu_torch.initialize.launch import args_sanity_check
from internevo_tpu_torch.models.jax_bridge import opt_state_from_jax, params_from_jax
from internevo_tpu_torch.monitor import monitor as tmonitor
from internevo_tpu_torch.train import main as tmain
from internevo_tpu_torch.train.pipeline import build_model, initialize_optimizer, initialize_trainer
from internevo_tpu_torch.utils import gpudiag, timeout as ttimeout, writer as twriter
from internevo_tpu_torch.utils.simple_memory_profiler import SimpleMemoryProfiler
from tests.test_training import test_loss


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)
    yield
    set_use_pallas(None)


class _Capture:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, key, value, step):
        self.scalars[key] = (float(value), step)


def _valid_folder(root):
    """Two ``.bin`` files of jsonl samples in ``en/`` and ``code/``, with
    their ``.bin.meta`` offset indexes (``data/single_dataset.py``)."""
    rng = np.random.RandomState(5)
    for kind in ("en", "code"):
        (root / kind).mkdir(parents=True)
        lines, meta, offset = [], [], 0
        for _ in range(9):
            tokens = rng.randint(1, 1024, rng.randint(20, 128)).tolist()
            line = (json.dumps({"tokens": tokens}) + "\n").encode()
            lines.append(line)
            meta.append((offset, len(tokens)))
            offset += len(line)
        (root / kind / "val.bin").write_bytes(b"".join(lines))
        with open(root / kind / "val.bin.meta", "wb") as f:
            np.save(f, np.asarray(meta, dtype=np.int64))
    return str(root)


@pytest.mark.parametrize("source", ["random", "valid_folder"])
def test_eval_matches_jax(source, tmp_path):
    from internevo_tpu.data.build_dataloader import build_valid_loader_with_data_type as jbuild_valid
    from internevo_tpu.eval.evaluation import evaluate_on_val_dls as jevaluate
    from internevo_tpu.initialize.launch import launch as jlaunch
    from internevo_tpu.train.pipeline import initialize_model as jinit_model
    from internevo_tpu.train.pipeline import initialize_optimizer as jinit_opt
    from internevo_tpu.train.pipeline import initialize_trainer as jinit_trainer

    data = dict(valid_every=2) if source == "random" else dict(valid_every=2, valid_folder=_valid_folder(tmp_path))
    cfg = test_loss.demo_config(data=data)
    jlaunch(cfg, seed=1024, devices=jax.devices()[:1])
    jmodel, jparams = jinit_model()
    jtrainer = jinit_trainer(jmodel, jparams, *jinit_opt(jmodel, jparams))
    want = _Capture()
    jevaluate(jtrainer, jbuild_valid()[0], want, step_count=2)

    config = args_sanity_check(Config(test_loss.demo_config(data=data)))
    model = build_model(config)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    trainer = initialize_trainer(model, params, *initialize_optimizer(model, params, config), config)
    got = _Capture()
    results = evaluate_on_val_dls(trainer, build_valid_loader_with_data_type(config)[0], got, step_count=2)
    assert sorted(got.scalars) == sorted(want.scalars)
    assert any("/" in k.split("/", 2)[-1] for k in got.scalars), got.scalars  # typed bins
    for k, (value, step) in want.scalars.items():
        np.testing.assert_allclose(got.scalars[k][0], value, rtol=5e-5, err_msg=k)
        assert got.scalars[k][1] == step == 2
    assert trainer.engine._training and all(r["tokens"] > 0 for r in results.values())
    if source == "valid_folder":
        assert sorted(results) == ["code/val.bin", "en/val.bin"]


def test_writer_tensorboard_and_jsonl(tmp_path, monkeypatch):
    tb = twriter.Writer(tensorboard_folder=str(tmp_path / "tb"))
    assert tb.tb_writer is not None
    tb.add_scalar("train/loss", 1.5, 3)
    tb.close()
    assert any(p.name.startswith("events.out.tfevents") and p.stat().st_size > 0 for p in (tmp_path / "tb").iterdir())

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import fails, as on the card machine
    js = twriter.Writer(tensorboard_folder=str(tmp_path / "js"))
    assert js.tb_writer is None
    js.add_scalar("train/loss", np.float32(2.5), 4)
    js.add_scalars("val", {"acc": 0.5}, 4)
    js.add_scalar("train/bad", "not a number", 5)  # logged and dropped
    js.close()
    lines = [json.loads(ln) for ln in (tmp_path / "js" / "scalars.jsonl").read_text().splitlines()]
    assert [(d["key"], d["value"], d["step"]) for d in lines] == [("train/loss", 2.5, 4), ("val/acc", 0.5, 4)]
    assert twriter.Writer(enable_tb=False).jsonl_file is None


def test_timer_diagnosis_alerts_like_jax(monkeypatch):
    from internevo_tpu.utils import tpudiag

    times = [1.0] * 12 + [2.3] + [1.0] * 5 + [2.1, 1.9, 3.0] + [1.0] * 40 + [2.4]
    alerts = {}
    for name, mod in (("jax", tpudiag), ("port", gpudiag)):
        sent = alerts.setdefault(name, [])
        monkeypatch.setattr(mod, "send_alert_message", lambda message="", sent=sent, **kw: sent.append(message))
        monkeypatch.setattr(mod, "_step_history", [])
        for t in times:
            mod.timer_diagnosis(t)
    assert alerts["port"] == alerts["jax"] and len(alerts["port"]) == 3


def test_diag_runs_its_benchmarks_and_drops_their_errors(monkeypatch):
    monkeypatch.setattr(gpudiag, "_step_history", [])
    assert gpudiag.empty_cache_and_diag(0, interval=1, device="cpu") is None  # never at batch 0
    assert gpudiag.empty_cache_and_diag(3, interval=2, device="cpu") is None
    diag = gpudiag.empty_cache_and_diag(2, interval=2, device="cpu")
    assert diag["batch"] == 2 and diag["net_s"] > 0 and diag["tflops"] > 0

    def broken(**kw):
        raise RuntimeError("no device")

    monkeypatch.setattr(gpudiag, "bench_net", broken)
    assert gpudiag.empty_cache_and_diag(4, interval=2, device="cpu") is None


def test_llm_timeout(monkeypatch):
    from internevo_tpu.utils import timeout as jtimeout

    assert ttimeout.LLM_TIMEOUT_DICTS == jtimeout.LLM_TIMEOUT_DICTS

    @ttimeout.llm_timeout(seconds=1, func_name="a_slow_phase")
    def slow():
        time.sleep(3)

    @ttimeout.llm_timeout(seconds=1)
    def quick():
        return 7

    monkeypatch.setattr(ttimeout, "ENABLE_TIMEOUT", True)
    t0 = time.perf_counter()
    with pytest.raises(ttimeout.LlmTimeoutError, match="a_slow_phase timed out after 1s"):
        slow()
    assert time.perf_counter() - t0 < 2.5
    assert quick() == 7
    monkeypatch.setattr(ttimeout, "ENABLE_TIMEOUT", False)
    assert quick() == 7


def test_memory_profiler_bytes_match_jax():
    import jax.numpy as jnp

    from internevo_tpu.models import ModelConfig
    from internevo_tpu.models.base import init_params
    from internevo_tpu.solver.optimizer import init_optimizer_state
    from internevo_tpu.utils.simple_memory_profiler import SimpleMemoryProfiler as JProfiler

    cfg = ModelConfig(num_layers=2, hidden_size=64, num_attention_heads=4, vocab_size=128, mlp_ratio=2.0,
                      multiple_of=32, dtype=jnp.bfloat16)
    tree = init_params(cfg, jax.random.PRNGKey(0))
    opt = init_optimizer_state(tree)
    act = dict(hidden_size=64, mlp_hidden=128, num_layers=2, tokens_per_device=256)
    want = JProfiler(tree, opt, activation_config=act).layout_report()
    port = SimpleMemoryProfiler(params_from_jax(jax.tree.map(np.asarray, tree), "cpu"),
                                opt_state_from_jax(jax.tree.map(np.asarray, opt), "cpu"), activation_config=act)
    assert port.layout_report() == want
    reports = [port.step() for _ in range(5)]
    assert [r is not None for r in reports] == [True, False, False, False, True]
    assert reports[0]["params_total"] == want["params_total"] and "bytes_in_use" not in reports[0]  # no card


def test_profiling_traces_batches_3_to_6(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmain.run_training(test_loss.demo_config(JOB_NAME="prof", enable_tb=False), device="cpu", steps=8,
                             profiling=True)
    assert len(out["records"]) == 8
    traces = list((tmp_path / "RUN" / "prof" / "torch_trace").glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {f"batch {b}" for b in range(8)} & names == {f"batch {b}" for b in (3, 4, 5, 6)}


def test_monitor_alerts_through_the_webhook(monkeypatch):
    posts = []

    class _Response:
        status = 200

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def urlopen(request, timeout):
        posts.append(json.loads(request.data)["content"]["post"]["zh_cn"])
        return _Response()

    monkeypatch.setattr(tmonitor.urllib.request, "urlopen", urlopen)
    tracker = tmonitor.MonitorTracker("http://localhost:9/hook", check_interval=3600, loss_spike_limit=1.5)
    tracker.update(2.0, 10)
    tracker._check_loss_spike()
    tracker.update(2.5, 11)
    tracker._check_loss_spike()
    assert posts == []
    tracker.update(4.0, 12)
    tracker._check_loss_spike()
    assert len(posts) == 1 and "loss spike may be happened in step 12" in posts[0]["content"][0][0]["text"]
    tracker._check_stuck()
    tracker._check_stuck()  # no update since: stuck
    assert "stuck" in posts[-1]["content"][0][0]["text"] and len(posts) == 2

    def refused(request, timeout):
        raise urllib.error.URLError("connection refused")

    monkeypatch.setattr(tmonitor.urllib.request, "urlopen", refused)
    assert tmonitor.send_feishu_msg_with_webhook("http://localhost:9/hook", "t", "m") is False  # logged
