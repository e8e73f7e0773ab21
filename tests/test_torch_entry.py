"""The port's entry point (``internevo_tpu_torch/train/main.py``) on the CPU:
its loop on ``tests/test_training/test_loss.py::demo_config()`` from JAX's
initial params against JAX's ``run_training`` for 3 steps (one device), a
GShard MoE variant of the same config, ``configs/demo.py`` through the CLI,
each refusal of what the port does not run yet, a run that starts fresh when
the checkpoint folder it names holds nothing, and ``--device cuda`` without a
card.

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
    "save": (dict(ckpt=dict(enable_save_ckpt=True, save_ckpt_folder="local:unused")), "A5"),
    "stop_file": (dict(ckpt=dict(stop_file_path="stop")), "A5"),
    "load_existing": (dict(ckpt=dict(load_ckpt_info=dict(path="local:{tmp}", content=("model",)))), "A5"),
    "auto_resume_snapshot": (dict(ckpt=dict(auto_resume=True, save_ckpt_folder="{tmp}")), "A5"),
    "valid_folder": (dict(data=dict(valid_folder="{tmp}")), "A7"),
    "valid_every": (dict(data=dict(valid_every=2)), "A7"),
    "tensorboard": (dict(tensorboard_folder="{tmp}"), "A7"),
    "memory_profiling": (dict(enable_memory_profiling=True), "A7"),
    "diag": (dict(data=dict(empty_cache_and_diag_interval=1)), "A7"),
    "alert": (dict(monitor=dict(alert=dict(enable_feishu_alert=True))), "A7"),
    "tensor_parallel": (dict(parallel=dict(tensor=dict(size=2, mode="mtp"))), "A8"),
}


def _fill(obj, tmp):
    if isinstance(obj, dict):
        return {k: _fill(v, tmp) for k, v in obj.items()}
    return obj.replace("{tmp}", tmp) if isinstance(obj, str) else obj


@pytest.mark.parametrize("case", list(REFUSED))
def test_entry_refuses_what_is_not_ported(case, tmp_path):
    (tmp_path / "7.step").write_text("")
    overrides, item = REFUSED[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}|{item}.*ROADMAP"):
        tmain.run_training(test_loss.demo_config(**_fill(overrides, str(tmp_path))), device="cpu", steps=STEPS)


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
