"""The port's entry point (``internevo_tpu_torch/train/main.py``) on the
CPU at the dtypes its kernels now take on the card, against JAX's loop on
one device from the same initial params and data:

- ``configs/demo.py`` as the file stands (fp32, head dim 64 / 4 = 16, the
  README's quickstart): the losses and grad norms of the first steps;
- the demo at fp16 with the dynamic loss scaler under the overlays of
  ``tests/test_training/test_eval_and_fp16.py``'s overflow test (an initial
  scale of 2**26, max 2**30, hysteresis 2): the scale trajectory, which
  steps overflow and are skipped, a skipped step's grad-norm sentinel, and
  the losses, step for step.

Tolerances: fp32 losses rtol 5e-5 (``doc/perf_notes.md:287-289``, as
``test_torch_entry.py``), grad norms rtol 1e-4 (a norm over every grad sums
each one's fp32 rounding).  fp16: the scale and the skipped steps exactly;
losses rtol 2e-3 and grad norms rtol 2e-2 (the two models round their fp16
activations at different points: the attention's probabilities, the
norms, the logits; about two fp16 steps of the loss, and the norm of the
unscaled fp16 grads a few more)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.models.jax_bridge import params_from_jax
from internevo_tpu_torch.train import main as tmain
from tests.test_training import test_loss

DEMO = str(Path(__file__).resolve().parents[1] / "configs" / "demo.py")
FP32_STEPS, FP16_STEPS = 4, 18
FP16_OVERFLOW = dict(model=dict(dtype="torch.float16"),
                     grad_scaler=dict(fp16=dict(initial_scale=2.0**26, min_scale=1, growth_interval=1000),
                                      growth_factor=2, backoff_factor=0.5, max_scale=2**30, hysteresis=2))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the loop's scalar writer makes tb_logs/ here


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)
    yield
    set_use_pallas(None)


def _jax_run(config, steps):
    """JAX's loop on one device (``test_eval_and_fp16.py``'s): per step the
    loss, grad norm, loss scale and whether it overflowed; and its initial
    params as numpy."""
    from internevo_tpu.data.build_dataloader import build_train_loader_with_data_type
    from internevo_tpu.initialize.launch import launch
    from internevo_tpu.train.pipeline import batch_to_device, initialize_model, initialize_optimizer, \
        initialize_trainer

    launch(config, seed=1024, devices=jax.devices()[:1])
    model, params = initialize_model()
    tree = jax.tree.map(np.asarray, params)
    opt_state, lrs, b2 = initialize_optimizer(model, params)
    trainer = initialize_trainer(model, params, opt_state, lrs, b2)
    train_dl, _ = build_train_loader_with_data_type()
    records, it = [], iter(train_dl)
    for _ in range(steps):
        batch = next(it)
        m = trainer.execute_schedule(batch_to_device(batch, micro_num=batch[0]["input_ids"].shape[0]))
        records.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), scale=float(m["loss_scale"]),
                            skipped=bool(m["found_inf"])))
    return records, tree


def _port_run(config, tree, steps):
    out = tmain.run_training(config, params=params_from_jax(tree, "cpu"), device="cpu", steps=steps)
    return [dict(loss=r["loss"], grad_norm=r["grad_norm"], scale=r["loss_scale"], skipped=not r["success_update"])
            for r in out["records"]]


def test_demo_config_fp32_matches_jax():
    want, tree = _jax_run(DEMO, FP32_STEPS)
    got = _port_run(DEMO, tree, FP32_STEPS)
    assert abs(want[0]["loss"] - np.log(1024)) < 0.05  # ln(vocab) at random init
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=5e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in got], [r["grad_norm"] for r in want], rtol=1e-4)
    assert not any(r["skipped"] for r in got)


def test_fp16_scaler_trajectory_matches_jax():
    want, tree = _jax_run(test_loss.demo_config(**FP16_OVERFLOW), FP16_STEPS)
    got = _port_run(test_loss.demo_config(**FP16_OVERFLOW), tree, FP16_STEPS)
    assert [r["scale"] for r in got] == [r["scale"] for r in want]
    assert [r["skipped"] for r in got] == [r["skipped"] for r in want]
    skipped = [r for r in got if r["skipped"]]
    clean = [r for r in got if not r["skipped"]]
    # the run overflowed, backed off after the hysteresis, and recovered
    assert skipped and clean and got.index(clean[0]) == len(skipped)
    # a skipped step's sentinel: -1 for an inf grad norm, -2 for nan.  Which
    # of the two an overflow gives depends on where inf first meets inf in
    # each framework's kernels, so the sentinels are held to the pair only
    assert all(r["grad_norm"] in (-1.0, -2.0) for r in skipped + [r for r in want if r["skipped"]])
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=2e-3)
    np.testing.assert_allclose([r["grad_norm"] for r in clean], [r["grad_norm"] for r in want if not r["skipped"]],
                               rtol=2e-2)
    assert clean[-1]["loss"] < clean[0]["loss"]
