"""Training entry point of the port, the counterpart of the root ``train.py``:

    python -m internevo_tpu_torch.train.main --config configs/7B_MoE4_sft.py [--seed 1024] [--device cuda]
                                             [--profiling]

The same main-loop phases as ``train.py`` on one device: launch (config
defaults and checks, the device, the seed), model and optimizer, the train
loader (``data/build_dataloader.py``: the packed dataset, the sampler, the
collater, a prefetch thread) and the ``TrainState``, the trainer, the
checkpoint manager and auto-resume, the scalar writer and the memory
profiler, then the loop under the monitor: load the next batch, move it to
the device, settle the previous step (its metrics read from the device, its
line logged, eval every ``valid_every`` steps, the checkpoint decision with
the counters of that step's dispatch), run the device diagnostics and
dispatch this one, so that the host's batch preparation overlaps the
device's step.  A stop-file quit ends the loop; the end waits for the last
checkpoint to land.  ``--profiling`` traces batches 3-7 with
``torch.profiler`` into ``RUN/<JOB_NAME>/torch_trace``.  It runs on the card
unless ``--device cpu`` is given; without a card it raises.  Layouts over
more than one device are refused at launch (ROADMAP A8).

``run_training`` is the loop as a function: the tests and ``chip_smoke.py``
call it in-process with a config and, optionally, initial params.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Any, Optional

import torch

from ..checkpoint.checkpoint_manager import CheckpointManager
from ..core.config import Config
from ..core.trainer import TrainState
from ..data.build_dataloader import build_train_loader_with_data_type, build_valid_loader_with_data_type
from ..eval.evaluation import evaluate_on_val_dls
from ..initialize.launch import launch
from ..monitor.monitor import initialize_monitor_manager, send_alert_message
from ..utils.common import BatchSkipper, parse_args
from ..utils.gpudiag import empty_cache_and_diag
from ..utils.logger import get_logger
from ..utils.simple_memory_profiler import SimpleMemoryProfiler
from ..utils.timers import megatron_timer as timer
from ..utils.writer import Writer
from .pipeline import (batch_to_device, build_model, get_tflops_func_builder, initialize_model,
                       initialize_optimizer, initialize_trainer, load_new_batch,
                       record_current_batch_training_metrics)

logger = get_logger(__name__)
PROFILE_BATCHES = (3, 7)  # --profiling traces batches [3, 7) (train.py:110)
# the counters a save must describe as of the settled step's dispatch
# (train.py:213-219): by the time it settles, the next batch is loaded
DISPATCH_COUNTERS = ("batch_count", "num_consumed_tokens", "sampler_consumed_batches", "sampler_consumed_samples",
                     "num_consumed_samples_in_epoch")


def run_training(config: str | os.PathLike | dict | Config, params: Optional[dict] = None, device: Any = "cuda",
                 seed: int = 1024, steps: Optional[int] = None, profiling: bool = False) -> dict:
    """Train from ``config`` up to ``steps`` (default ``data.total_steps``),
    as the root ``train.py``'s ``main``, resuming where the checkpoint
    manager finds a checkpoint.  ``params`` (a tree on the device, e.g.
    ``models/jax_bridge.params_from_jax``'s) replaces the random init from
    ``seed``.

    Returns ``records`` (one dict a step run: loss, grad_norm, moe_loss,
    tgs, tflops, time_cost, lr, ...), ``load_wait_s`` (seconds each step
    waited in ``load_new_batch``), ``setup_s`` (seconds to build model,
    optimizer, loader and trainer, to resume and to allocate the saves'
    pinned staging buffers), ``staging_s`` (the last of those), ``evals``
    (one dict an eval: step, seconds, the per-loader results), ``diags`` (the device
    benchmarks that ran), ``saved_after`` (the batches whose settling
    saved a checkpoint), ``stopped`` (a stop-file quit), and ``config``,
    ``model``, ``train_state``, ``engine``, ``ckpt_manager``, ``writer``
    and ``memory_profiler``."""
    t_setup = time.perf_counter()
    launched = launch(config, seed=seed, device=device)
    config, dev = launched.config, launched.device
    data = config.data
    total_steps = data.total_steps if steps is None else steps
    if params is None:
        model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(launched.seed))
    else:
        model = build_model(config)
    opt_state, lr_scheduler, beta2_scheduler = initialize_optimizer(model, params, config)
    train_dl, dataset_types = build_train_loader_with_data_type(config)
    train_state = TrainState(config, train_dl.batch_sampler)
    trainer = initialize_trainer(model, params, opt_state, lr_scheduler, beta2_scheduler, config,
                                 seed=launched.seed)
    engine = trainer.engine

    ckpt_manager = CheckpointManager(config.ckpt, engine=engine, train_state=train_state, train_dl=train_dl,
                                     model_config=config.model)
    ckpt_manager.try_resume_training(train_state)
    staging_s = ckpt_manager.allocate_staging()  # the first save's pinned buffers, outside the loop

    job_name = config.get("JOB_NAME", "internevo_tpu")
    writer = Writer(job_name=job_name, launch_time=time.strftime("%m-%d-%H:%M:%S"),
                    tensorboard_folder=config.get("tensorboard_folder", None),
                    enable_tb=config.get("enable_tb", True))
    memory_profiler = None
    if config.get("enable_memory_profiling", False):
        memory_profiler = SimpleMemoryProfiler(
            engine.params, engine.opt_state,
            activation_config=dict(hidden_size=config.model.hidden_size,
                                   mlp_hidden=int(config.model.hidden_size * config.model.get("mlp_ratio", 4)),
                                   num_layers=config.model.num_layers, tokens_per_device=data.packed_length))
    get_tflops_func = get_tflops_func_builder(config)
    batch_skipper = BatchSkipper(data.skip_batches)
    valid_every = data.get("valid_every", 0)
    diag_interval = data.get("empty_cache_and_diag_interval", 0) or 0
    setup_s = time.perf_counter() - t_setup

    records, load_wait_s, evals, diags, saved_after = [], [], [], [], []
    profile_dir = os.path.join("RUN", job_name, "torch_trace")
    profiler = None
    # the step's metrics are read one iteration late, so that the next
    # batch's host work overlaps the running step (train.py:118-123)
    pending = None
    last_handle_time = time.time()
    last_step_time = None

    def handle_pending() -> bool:
        """Settle the dispatched step; True when the stop file says quit."""
        nonlocal pending, last_handle_time, last_step_time
        if pending is None:
            return False
        p_count, p_batch, p_metrics, p_start, p_counters = pending
        pending = None
        loss, grad_norm = float(p_metrics["loss"]), float(p_metrics["grad_norm"])
        success_update = not bool(p_metrics["found_inf"])
        if success_update:
            train_state.step_count += 1
        else:
            train_state.inf_nan_skip_batches += 1
            engine.note_overflow()
            logger.warning("overflow detected at step %d, skipping update", p_count)
            send_alert_message(message=f"inf/nan grad at step {p_count}, skipped")
        # overlapped windows would count twice: charge this step the wall time
        # since the previous step was settled
        now = time.time()
        last_step_time = now - max(p_start, last_handle_time)
        last_handle_time = now
        if memory_profiler is not None:
            memory_profiler.step()
        records.append(record_current_batch_training_metrics(
            get_tflops_func, logger, writer, success_update, p_count, p_batch, train_state, engine,
            now - last_step_time, loss, grad_norm, p_metrics))
        if valid_every > 0 and train_state.step_count % valid_every == 0:
            t0 = time.perf_counter()
            results = evaluate_on_val_dls(trainer, build_valid_loader_with_data_type(config)[0], writer,
                                          train_state.step_count, dataset_types=dataset_types)
            evals.append({"step": train_state.step_count, "after_batch": p_count,
                          "seconds": time.perf_counter() - t0, "results": results})
        # the save describes the state as of batch p_count, but the next batch
        # was already loaded and counted: swap in the dispatch-time counters
        live = {k: getattr(train_state, k) for k in p_counters}
        for k, v in p_counters.items():
            setattr(train_state, k, v)
        n_saves = len(ckpt_manager.save_records)
        try:
            should_stop = ckpt_manager.try_save_checkpoint(train_state)
        finally:
            for k, v in live.items():
                setattr(train_state, k, v)
        if len(ckpt_manager.save_records) > n_saves:
            saved_after.append(p_count)
        return should_stop

    train_iter = iter(train_dl)
    gc.collect()
    gc.disable()
    stopped = False
    try:
        with initialize_monitor_manager(job_name=job_name,
                                        alert_address=config.monitor.alert.get("feishu_alert_address", None)):
            logger.info("start training from batch_count=%d", train_state.batch_count)
            for batch_count in range(train_state.batch_count, total_steps):
                if profiling and batch_count == PROFILE_BATCHES[0]:
                    profiler = _start_profiler(dev)
                if profiling and batch_count == PROFILE_BATCHES[1] and profiler is not None:
                    _stop_profiler(profiler, dev, profile_dir)
                    profiler = None
                start_time = time.time()
                timer("one-batch").start()
                t0 = time.perf_counter()
                batch, train_iter = load_new_batch(train_dl, train_iter, train_state)
                load_wait_s.append(time.perf_counter() - t0)
                train_state.batch_count = batch_count
                train_state.num_consumed_tokens += int(batch[0]["input_ids"].size)
                if batch_skipper(batch_count):
                    logger.info("skip batch %d", batch_count)
                    continue
                device_batch = batch_to_device(batch, batch[0]["input_ids"].shape[0], dev)  # one data rank
                if handle_pending():
                    stopped = True
                    break
                diag = empty_cache_and_diag(batch_count, interval=diag_interval, step_time=last_step_time,
                                            device=dev)
                if diag is not None:
                    diags.append(diag)
                timer("fwd-bwd").start()
                with torch.profiler.record_function(f"batch {batch_count}"):  # names the step in a trace
                    metrics = trainer.execute_schedule(device_batch)
                timer("fwd-bwd").stop()
                timer("one-batch").stop()
                pending = (batch_count, device_batch, metrics, start_time,
                           {k: getattr(train_state, k) for k in DISPATCH_COUNTERS})
            stopped = handle_pending() or stopped
        ckpt_manager.wait_async_upload_finish()
    finally:
        gc.enable()
        if profiler is not None:
            _stop_profiler(profiler, dev, profile_dir)
        writer.close()
    return {"records": records, "load_wait_s": load_wait_s, "setup_s": setup_s, "staging_s": staging_s,
            "evals": evals, "diags": diags,
            "saved_after": saved_after, "stopped": stopped, "config": config, "model": model,
            "train_state": train_state, "engine": engine, "ckpt_manager": ckpt_manager, "writer": writer,
            "memory_profiler": memory_profiler}


def _start_profiler(dev: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, dev: torch.device, profile_dir: str) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    profiler.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def main(argv=None) -> None:
    args = parse_args(argv)
    run_training(args.config, device=args.device, seed=args.seed, profiling=args.profiling)


if __name__ == "__main__":
    main()
