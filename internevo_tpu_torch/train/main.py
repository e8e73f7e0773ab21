"""Training entry point of the port, the counterpart of the root ``train.py``:

    python -m internevo_tpu_torch.train.main --config configs/7B_MoE4_sft.py [--seed 1024] [--device cuda]

The same main-loop phases as ``train.py`` on one device: launch (config
defaults and checks, the device, the seed), model and optimizer, the train
loader (``data/build_dataloader.py``: the packed dataset, the sampler, the
collater, a prefetch thread) and the ``TrainState``, the trainer, then the
loop: load the next batch, move it to the device, settle the previous step
(its metrics read from the device, its line logged) and dispatch this one,
so that the host's batch preparation overlaps the device's step.  It runs on
the card unless ``--device cpu`` is given; without a card it raises.

Not ported yet, and refused where a config turns them on
(``refuse_unported``): saving checkpoints and loading one that exists
(ROADMAP A5); eval, the scalar writer, the memory profiler, the device
diagnostics and alerts (A7).  With nothing to load the run starts fresh, as
JAX's ``try_resume_training`` does.

``run_training`` is the loop as a function: the tests and ``chip_smoke.py``
call it in-process with a config and, optionally, initial params.
"""

from __future__ import annotations

import gc
import logging
import os
import time
from typing import Any, Optional

import torch

from ..core.config import Config
from ..core.trainer import TrainState
from ..data.build_dataloader import build_train_loader_with_data_type
from ..initialize.launch import launch
from ..utils.common import BatchSkipper, parse_args
from .pipeline import (batch_to_device, build_model, get_tflops_func_builder, initialize_model,
                       initialize_optimizer, initialize_trainer, load_new_batch,
                       record_current_batch_training_metrics)

logger = logging.getLogger(__name__)
STORAGE_BACKENDS = ("local", "boto3", "volc", "oss2")  # utils/storage_manager.py's path prefixes


def _local_path(path: str) -> Optional[str]:
    """The file-system path of a storage path, or None for an object store."""
    backend, rest = path.split(":", 1) if path.split(":", 1)[0] in STORAGE_BACKENDS else ("local", path)
    return rest if backend == "local" else None


def checkpoint_to_load(ckpt: Config) -> Optional[str]:
    """What JAX's ``try_resume_training`` would load: with ``auto_resume``
    the newest ``<step>.step``-stamped folder under ``save_ckpt_folder``,
    else ``load_ckpt_info``'s path.  A local path that does not exist holds
    nothing to load (None); an object-store path cannot be looked into here
    and is returned as it is."""
    folder = ckpt.get("save_ckpt_folder")
    if ckpt.get("auto_resume", True) and folder:
        local = _local_path(folder)
        if local is None:
            return folder
        for root, _dirs, files in os.walk(local):
            if any(f.endswith(".step") and f[:-len(".step")].isdigit() for f in files):
                return root
    info = ckpt.get("load_ckpt_info")
    if info and info.get("path"):
        local = _local_path(info["path"])
        if local is None or os.path.exists(local):
            return info["path"]
    return None


def refuse_unported(config: Config, total_steps: int) -> None:
    """Raise, naming the ROADMAP item, for what the config turns on that the
    port does not run yet."""
    ckpt, data = config.ckpt, config.data
    why = []
    if ckpt.get("enable_save_ckpt"):
        why.append("ckpt.enable_save_ckpt: saving checkpoints (A5, checkpoint)")
    if ckpt.get("stop_file_path"):
        why.append("ckpt.stop_file_path: the stop file saves a checkpoint (A5, checkpoint)")
    found = checkpoint_to_load(ckpt)
    if found is not None:
        why.append(f"a checkpoint to load at {found!r} (A5, checkpoint)")
    if data.get("valid_folder"):
        why.append("data.valid_folder: eval (A7, observability and eval)")
    if data.get("valid_every", 0) > 0 and total_steps >= data.valid_every:
        why.append(f"data.valid_every={data.valid_every} within {total_steps} steps: eval (A7, observability "
                   "and eval)")
    if config.get("tensorboard_folder") or config.get("enable_tb"):
        why.append("tensorboard output: the scalar writer (A7, observability and eval)")
    if config.get("enable_memory_profiling"):
        why.append("enable_memory_profiling: the memory profiler (A7, observability and eval)")
    interval = data.get("empty_cache_and_diag_interval", 0) or 0
    if 0 < interval < total_steps:
        why.append(f"data.empty_cache_and_diag_interval={interval} within {total_steps} steps: the device "
                   "diagnostics (A7, observability and eval)")
    if config.get("monitor", {}).get("alert", {}).get("enable_feishu_alert"):
        why.append("monitor.alert.enable_feishu_alert: alerts (A7, observability and eval)")
    if why:
        raise NotImplementedError("the port does not run these yet (ROADMAP): " + "; ".join(why))


def run_training(config: str | os.PathLike | dict | Config, params: Optional[dict] = None, device: Any = "cuda",
                 seed: int = 1024, steps: Optional[int] = None) -> dict:
    """Train ``steps`` steps (default ``data.total_steps``) from a fresh
    start, as the root ``train.py``'s ``main``.  ``params`` (a tree on the
    device, e.g. ``models/jax_bridge.params_from_jax``'s) replaces the
    random init from ``seed``.

    Returns ``records`` (one dict a step run: loss, grad_norm, moe_loss,
    tgs, tflops, time_cost, lr, ...), ``load_wait_s`` (seconds each step
    waited in ``load_new_batch``), ``setup_s`` (seconds to build model,
    optimizer, loader and trainer), and ``config``, ``model``,
    ``train_state`` and ``engine``."""
    t_setup = time.perf_counter()
    launched = launch(config, seed=seed, device=device)
    config, dev = launched.config, launched.device
    total_steps = config.data.total_steps if steps is None else steps
    refuse_unported(config, total_steps)
    if params is None:
        model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(launched.seed))
    else:
        model = build_model(config)
    opt_state, lr_scheduler, beta2_scheduler = initialize_optimizer(model, params, config)
    train_dl, _dataset_types = build_train_loader_with_data_type(config)
    train_state = TrainState(config, train_dl.batch_sampler)
    trainer = initialize_trainer(model, params, opt_state, lr_scheduler, beta2_scheduler, config,
                                 seed=launched.seed)
    engine = trainer.engine
    get_tflops_func = get_tflops_func_builder(config)
    batch_skipper = BatchSkipper(config.data.skip_batches)
    setup_s = time.perf_counter() - t_setup

    records, load_wait_s = [], []
    # the step's metrics are read one iteration late, so that the next
    # batch's host work overlaps the running step (train.py:118-123)
    pending = None
    last_handle_time = time.time()

    def handle_pending() -> None:
        nonlocal pending, last_handle_time
        if pending is None:
            return
        p_count, p_batch, p_metrics, p_start = pending
        pending = None
        loss, grad_norm = float(p_metrics["loss"]), float(p_metrics["grad_norm"])
        success_update = not bool(p_metrics["found_inf"])
        if success_update:
            train_state.step_count += 1
        else:
            train_state.inf_nan_skip_batches += 1
            engine.note_overflow()
            logger.warning("overflow detected at step %d, skipping update", p_count)
        # overlapped windows would count twice: charge this step the wall time
        # since the previous step was settled
        now = time.time()
        step_time = now - max(p_start, last_handle_time)
        last_handle_time = now
        records.append(record_current_batch_training_metrics(
            get_tflops_func, logger, None, success_update, p_count, p_batch, train_state, engine,
            now - step_time, loss, grad_norm, p_metrics))

    train_iter = iter(train_dl)
    gc.collect()
    gc.disable()
    try:
        logger.info("start training from batch_count=%d", train_state.batch_count)
        for batch_count in range(train_state.batch_count, total_steps):
            start_time = time.time()
            t0 = time.perf_counter()
            batch, train_iter = load_new_batch(train_dl, train_iter, train_state)
            load_wait_s.append(time.perf_counter() - t0)
            train_state.batch_count = batch_count
            train_state.num_consumed_tokens += int(batch[0]["input_ids"].size)
            if batch_skipper(batch_count):
                logger.info("skip batch %d", batch_count)
                continue
            device_batch = batch_to_device(batch, batch[0]["input_ids"].shape[0], dev)  # one data rank
            handle_pending()
            metrics = trainer.execute_schedule(device_batch)
            pending = (batch_count, device_batch, metrics, start_time)
        handle_pending()
    finally:
        gc.enable()
    return {"records": records, "load_wait_s": load_wait_s, "setup_s": setup_s, "config": config, "model": model,
            "train_state": train_state, "engine": engine}


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    run_training(args.config, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
