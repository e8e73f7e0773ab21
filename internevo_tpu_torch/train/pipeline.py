"""Train glue (port of ``internevo_tpu/train/pipeline.py``; reference
``internlm/train/pipeline.py``): model, optimizer and trainer from a config
(``initialize_model`` :157, ``initialize_optimizer`` :282), the batch on the
device, ``load_new_batch`` (:380) and the step's metrics record (:462-633).

The JAX functions read the launched global config (``gpc``); these take the
config explicitly.  It must hold the blocks that ``initialize/launch.py``'s
``args_sanity_check`` fills in when a config file leaves them out (``adam``,
``grad_scaler``, ``lr_scheduler``, ``beta2_scheduler``), as
``configs/7B_sft.py`` holds them.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from .. import models  # noqa: F401  (registry population)
from ..accelerator import get_device
from ..core.config import Config
from ..core.engine import Engine
from ..core.scheduler.no_pipeline import make_eval_step, make_train_step
from ..core.trainer import Trainer, TrainState
from ..models.base import ModelDef
from ..monitor.monitor import monitor_manager, send_heartbeat
from ..ops.fused_ce import loss_knobs
from ..solver.lr_scheduler import Beta2Scheduler, build_lr_scheduler
from ..solver.optimizer import AdamWConfig, GradScalerConfig, init_optimizer_state
from ..utils.common import get_megatron_flops
from ..utils.logger import get_logger
from ..utils.registry import MODEL_INITIALIZER
from ..utils.timers import megatron_timer as timer

logger = get_logger(__name__)

# the top-level `moe = dict(...)` block's keys and the model fields they set
# (JAX train/pipeline.py:53-56)
_MOE_FIELDS = {"top_k": "top_k", "capacity_factor": "moe_capacity_factor",
               "eval_capacity_factor": "moe_eval_capacity_factor", "min_capacity": "moe_min_capacity",
               "drop_tokens": "moe_drop_tokens", "use_rts": "moe_use_rts",
               "noisy_gate_policy": "moe_noisy_gate_policy"}


def build_model(config: Config) -> ModelDef:
    """The registered model of ``config.model_type`` (default "INTERNLM", as
    ``initialize/launch.py:27``).  Packed segments are never longer than
    ``data.seq_len``, which becomes ``max_segment_len`` unless the model
    config sets it."""
    model_cfg = dict(config.model)
    if "max_segment_len" not in model_cfg and "data" in config:
        model_cfg["max_segment_len"] = config.data.get("seq_len", None)
    # the top-level `moe = dict(...)` block (reference 7B_MoE4_sft.py:204) maps
    # onto the model's moe fields, as JAX train/pipeline.py:49-59 does
    moe = config.get("moe") or {}
    model_cfg.update({dst: moe[src] for src, dst in _MOE_FIELDS.items() if src in moe})
    return MODEL_INITIALIZER.get_module(config.get("model_type", "INTERNLM"))(**model_cfg)


def initialize_model(config: Config, device, generator: torch.Generator) -> tuple[ModelDef, dict]:
    """``build_model``, and its params drawn from ``generator`` on ``device``."""
    device = get_device(device)
    model = build_model(config)
    return model, model.init(generator, device)


def _adam_cfg(config: Config) -> AdamWConfig:
    adam = config.adam
    return AdamWConfig(
        lr=adam.lr,
        betas=(adam.adam_beta1, adam.adam_beta2),
        eps=adam.adam_eps,
        weight_decay=adam.weight_decay,
        clip_grad_norm=config.get("hybrid_zero_optimizer", {}).get("clip_grad_norm", 1.0),
    )


def _scaler_cfg(config: Config) -> GradScalerConfig:
    gs = config.grad_scaler
    dtype = str(config.model.get("dtype", "torch.bfloat16"))
    fp16 = gs.get("fp16", {})
    is_fp16 = "float16" in dtype and "b" not in dtype.split(".")[-1]
    return GradScalerConfig(
        initial_scale=fp16.get("initial_scale", 2**16) if is_fp16 else 1.0,
        growth_factor=gs.get("growth_factor", 2.0),
        backoff_factor=gs.get("backoff_factor", 0.5),
        growth_interval=fp16.get("growth_interval", 1000),
        hysteresis=gs.get("hysteresis", 2),
        min_scale=fp16.get("min_scale", 1),
        max_scale=gs.get("max_scale", 2**24),
    )


def initialize_optimizer(model: ModelDef, params, config: Config) -> tuple[Any, Any, Any]:
    """Optimizer state on the params' device, and the lr and beta2
    schedulers (reference ``initialize_optimizer`` :282)."""
    opt_state = init_optimizer_state(params, _scaler_cfg(config))
    lr_scheduler = build_lr_scheduler(config.adam, config.lr_scheduler)
    b2cfg = config.beta2_scheduler
    beta2_scheduler = Beta2Scheduler(init_beta2=b2cfg.init_beta2, c=b2cfg.c)
    return opt_state, lr_scheduler, beta2_scheduler


def initialize_trainer(model: ModelDef, params, opt_state, lr_scheduler, beta2_scheduler,
                       config: Config, seed: int = 1024) -> Trainer:
    """The non-pipeline train step, the per-token eval step, and the engine
    and trainer around them.  ``seed`` is the launch seed whose "dropout"
    stream the train step draws (JAX ``initialize/launch.py:130``); the
    ``loss`` block's ``save_ce_logits`` and ``ce_chunk_size`` reach the
    fused CE of both steps."""
    loss = config.get("loss", {})
    knobs = loss_knobs(loss)
    train_step = make_train_step(model, _adam_cfg(config), _scaler_cfg(config),
                                 label_smoothing=loss.get("label_smoothing", 0),
                                 moe_loss_coeff=loss.get("moe_loss_coeff", 0.01), seed=seed, **knobs)
    eval_step = make_eval_step(model, loss.get("label_smoothing", 0), per_token=True,
                               chunk_size=knobs["chunk_size"])
    engine = Engine(model, params, opt_state, train_step, lr_scheduler, beta2_scheduler, eval_step)
    return Trainer(engine)


def batch_to_device(batch: tuple, micro_num: int, device) -> dict:
    """The loader's ``(data, labels)`` (arrays (micro_num * dp_batch, P), the
    rows of one micro step consecutive) as (micro_num, dp_batch, P) tensors
    on ``device``: ``input_ids`` and ``labels`` int64, ``indexes`` and
    ``segment_ids`` int32 (JAX ``batch_to_device``, :178)."""
    data, labels = batch
    arrays = {"input_ids": data["input_ids"], "segment_ids": data["segment_ids"], "indexes": data["indexes"],
              "labels": labels}
    total, length = arrays["input_ids"].shape
    if total % micro_num:
        raise ValueError(f"{total} rows do not split into {micro_num} micro-batches")
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v).reshape(micro_num, total // micro_num, length))
        out[k] = t.to(device=device, dtype=torch.int64 if k in ("input_ids", "labels") else torch.int32)
    return out


def load_new_batch(train_dl, train_iter, train_state: TrainState):
    """The next batch, rolling into a new epoch when the loader runs out
    (JAX ``load_new_batch``, :208-229): the per-epoch consumption restarts,
    the batch count stays cumulative, and the resume snapshot is taken anew
    from the live sampler, which reshuffled at the end of the epoch."""
    timer("batch-gen").start()
    try:
        batch = next(train_iter)
        train_state.num_consumed_samples_in_epoch += len(batch[1])
    except StopIteration:
        train_iter = iter(train_dl)
        batch = next(train_iter)
        train_state.num_consumed_samples_in_epoch = 0
        train_state.sampler_consumed_samples = 0
        if train_state.batch_sampler is not None:
            train_state.batch_sampler_state = train_state.batch_sampler.copy()
    train_state.note_batch_consumed(len(batch[1]))
    timer("batch-gen").stop()
    return batch, train_iter


def record_current_batch_training_metrics(get_tflops_func: Callable, logger_obj, writer, success_update: bool,
                                          batch_count: int, batch: dict, train_state: TrainState, engine,
                                          start_time: float, loss: float, grad_norm: float, metrics: dict) -> dict:
    """Tokens a device a second, TFLOP/s and the step's line (JAX
    ``record_current_batch_training_metrics``, :232-287, one device), the
    light monitor's heartbeat, the monitor's reading and, with a writer, the
    ``train/*`` scalars.  Returns the numbers of the line."""
    time_cost = time.time() - start_time
    tokens = batch["input_ids"].numel()
    tgs = tokens / time_cost
    tflops = get_tflops_func(time_cost)
    stat = train_state.tgs_statistic
    stat["sum_step"] += 1
    stat["sum_tg"] += tokens
    stat["sum_time"] += time_cost
    stat["last_tgs_10"].append(tgs)
    stat["last_tgs_50"].append(tgs)
    group_norms = {k: float(v) for k, v in metrics.get("grad_norm_groups", {}).items()}
    gn_str = " ".join(f"{k}={v:.5f}" for k, v in sorted(group_norms.items()))
    record = {"step": batch_count, "loss": loss, "grad_norm": grad_norm, "tgs": tgs, "tflops": tflops,
              "time_cost": time_cost, "lr": engine.current_lr, "loss_scale": float(metrics["loss_scale"]),
              "acc": float(metrics.get("acc", 0)), "perplexity": float(metrics.get("perplexity", 0)),
              "moe_loss": float(metrics.get("moe_loss", 0)), "real_tokens": int(metrics.get("n_tokens", 0)),
              "success_update": success_update}
    logger_obj.info(
        f"tflops={tflops:.2f} step={batch_count} loss={loss:.5f} "
        f"tgs(tokens/gpu/second)={tgs:.2f} tgs_avg={np.mean(stat['last_tgs_10']):.2f} "
        f"lr={engine.current_lr:.4e} loss_scale={record['loss_scale']:.1f} "
        f"grad_norm={grad_norm:.5f} acc={record['acc']:.4f} perplexity={record['perplexity']:.3f} "
        f"real_tokens={record['real_tokens']} " + (f"grad_norm_groups=[{gn_str}] " if gn_str else ""))
    # light-monitor heartbeat every 50 steps (ref train/pipeline.py:599-600)
    send_heartbeat("TRAIN_METRICS", {"loss": loss, "tgs": round(tgs, 1), "tflops": round(tflops, 1)},
                   step=batch_count)
    monitor_manager.update(loss, batch_count)
    if writer is not None:
        writer.add_scalar("train/loss", loss, batch_count)
        writer.add_scalar("train/tgs", tgs, batch_count)
        writer.add_scalar("train/lr", engine.current_lr, batch_count)
        writer.add_scalar("train/grad_norm", grad_norm, batch_count)
        for k, v in group_norms.items():
            writer.add_scalar(f"train/grad_norm/{k}", v, batch_count)
    return record


def get_tflops_func_builder(config: Config, checkpoint_fraction: float | None = None) -> Callable[[float], float]:
    """Megatron TFLOP/s of one step from its seconds (JAX
    ``get_tflops_func_builder``, :290-311), one device."""
    model, data = config.model, config.data
    ckpt = model.get("checkpoint", 0.0) if checkpoint_fraction is None else checkpoint_fraction

    def f(elapsed: float) -> float:
        return get_megatron_flops(elapsed, checkpoint=ckpt > 0, seq_len=data.seq_len,
                                  hidden_size=model.hidden_size, num_layers=model.num_layers,
                                  vocab_size=model.vocab_size, global_batch_size=data.micro_num * data.micro_bsz,
                                  global_world_size=1, mlp_ratio=model.get("mlp_ratio", 4.0),
                                  use_swiglu=model.get("use_swiglu", True))

    return f
