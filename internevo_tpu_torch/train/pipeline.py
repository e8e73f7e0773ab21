"""Train glue: model, optimizer and trainer from a config (port of
``internevo_tpu/train/pipeline.py:35-175``; reference ``initialize_model``
:157, ``initialize_optimizer`` :282).

The JAX functions read the launched global config (``gpc``); these take the
config explicitly.  It must hold the blocks that the JAX ``launch`` fills in
when a config file leaves them out (``adam``, ``grad_scaler``,
``lr_scheduler``, ``beta2_scheduler``), as ``configs/7B_sft.py`` does.
"""

from __future__ import annotations

from typing import Any

import torch

from .. import models  # noqa: F401  (registry population)
from ..accelerator import get_device
from ..core.config import Config
from ..core.engine import Engine
from ..core.scheduler.no_pipeline import make_eval_step, make_train_step
from ..core.trainer import Trainer
from ..models.base import ModelDef
from ..ops.fused_ce import loss_knobs
from ..solver.lr_scheduler import Beta2Scheduler, build_lr_scheduler
from ..solver.optimizer import AdamWConfig, GradScalerConfig, init_optimizer_state
from ..utils.registry import MODEL_INITIALIZER

_MOE_FIELDS = {"top_k": "top_k", "drop_tokens": "moe_drop_tokens"}


def initialize_model(config: Config, device, generator: torch.Generator) -> tuple[ModelDef, dict]:
    """Build the registered model of ``config.model_type`` (default
    "INTERNLM", as ``initialize/launch.py:27``) and draw its params from
    ``generator`` on ``device``.  Packed segments are never longer than
    ``data.seq_len``, which becomes ``max_segment_len`` unless the model
    config sets it."""
    device = get_device(device)
    model_cfg = dict(config.model)
    if "max_segment_len" not in model_cfg and "data" in config:
        model_cfg["max_segment_len"] = config.data.get("seq_len", None)
    # the top-level `moe = dict(...)` block (reference 7B_MoE4_sft.py:204) maps
    # onto the model's moe fields, as JAX train/pipeline.py:49-59 does
    moe = config.get("moe") or {}
    model_cfg.update({dst: moe[src] for src, dst in _MOE_FIELDS.items() if src in moe})
    model = MODEL_INITIALIZER.get_module(config.get("model_type", "INTERNLM"))(**model_cfg)
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
