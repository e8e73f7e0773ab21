"""Config defaults and launch, one process on one device (port of
``internevo_tpu/initialize/launch.py``; reference ``internlm/initialize/
launch.py``: ``args_sanity_check`` :71-445, ``initialize_distributed_env``
:588).

``args_sanity_check`` fills the blocks a config file may leave out (data,
parallel, model, adam, grad scaler, lr and beta2 schedulers, loss, ckpt,
monitor) with the JAX package's defaults, which the port's
``initialize_optimizer`` and entry point read.  One process drives one
device: a parallel layout over more than one device is refused until the
multi-GPU slice (ROADMAP A8).  ``launch`` returns the checked config, the
device (the card unless the caller asks for the CPU) and the seed whose
streams the model init and the train step draw.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from ..accelerator import get_device
from ..core.config import Config


def _refuse_parallel(parallel: Config) -> None:
    sizes = {"zero1": parallel.zero1.get("size", -1), "tensor": parallel.tensor.get("size", 1),
             "pipeline": parallel.pipeline.get("size", 1), "weight": parallel.weight.get("size", 1)}
    wide = {k: v for k, v in sizes.items() if v not in (-1, 1)}
    if wide:
        raise NotImplementedError(f"parallel sizes {wide} need more than one device; the port runs one process on "
                                  "one device until the multi-GPU slice (ROADMAP A8)")


def args_sanity_check(cfg: Config) -> Config:
    """Default and check ``cfg`` in place, as the JAX ``args_sanity_check``
    (``launch.py:24-127``); returns it."""
    cfg.setdefault("model_type", "INTERNLM")

    data = cfg.setdefault("data", Config())
    data.setdefault("seq_len", 2048)
    data.setdefault("micro_num", 1)
    data.setdefault("micro_bsz", 1)
    data.setdefault("rampup_batch_size", None)
    data.setdefault("gradient_accum_size", data.micro_num)
    data.setdefault("use_packed_dataset", True)
    data.setdefault("pack_sample_into_one", False)
    data.setdefault("fixed_random_dataset_seqlen", True)
    data.setdefault("train_folder", None)
    data.setdefault("valid_folder", None)
    data.setdefault("valid_every", 0)
    data.setdefault("valid_micro_num", data.micro_num)
    data.setdefault("min_length", 50)
    data.setdefault("total_steps", 50000)
    data.setdefault("skip_batches", "")
    data.setdefault("diag_outlier_ratio", 1.1)
    # the invariant the whole packed pipeline relies on (ref :125)
    expected = data.seq_len * data.micro_bsz
    if "packed_length" in data:
        if data.packed_length != expected:
            raise ValueError(f"data.packed_length {data.packed_length} != seq_len * micro_bsz = {expected}")
    else:
        data.packed_length = expected

    parallel = cfg.setdefault("parallel", Config())
    parallel.setdefault("zero1", Config(dict(size=-1, fsdp=False)))
    if not isinstance(parallel.zero1, dict):
        parallel.zero1 = Config(dict(size=parallel.zero1, fsdp=False))
    parallel.setdefault("tensor", Config(dict(size=1, mode="mtp")))
    if not isinstance(parallel.tensor, dict):
        parallel.tensor = Config(dict(size=parallel.tensor, mode="mtp"))
    parallel.tensor.setdefault("mode", "mtp")
    parallel.setdefault("pipeline", Config(dict(size=1, interleaved_overlap=True)))
    if not isinstance(parallel.pipeline, dict):
        parallel.pipeline = Config(dict(size=parallel.pipeline, interleaved_overlap=True))
    parallel.setdefault("weight", Config(dict(size=1, overlap=True, memory_pool=True)))
    parallel.setdefault("sequence_parallel", parallel.tensor.mode in ("msp", "fsp", "isp", "rsp"))
    if parallel.tensor.mode not in ("mtp", "msp", "fsp", "isp", "rsp"):
        raise ValueError(f"parallel.tensor.mode {parallel.tensor.mode!r}")
    _refuse_parallel(parallel)

    model = cfg.setdefault("model", Config())
    model.setdefault("dtype", "torch.bfloat16")
    model.setdefault("checkpoint", 0.0)
    model.setdefault("parallel_output", True)

    cfg.setdefault("adam", Config(dict(lr=1e-4, adam_beta1=0.9, adam_beta2=0.95,
                                       adam_beta2_c=0, adam_eps=1e-8, weight_decay=0.01)))
    cfg.setdefault("grad_scaler", Config(dict(
        fp16=dict(initial_scale=2**16, min_scale=1, growth_interval=1000),
        growth_factor=2, backoff_factor=0.5, max_scale=2**24, hysteresis=2)))
    cfg.setdefault("hybrid_zero_optimizer", Config(dict(
        overlap_sync_grad=True, overlap_sync_param=True,
        reduce_bucket_size=512 * 1024 * 1024, clip_grad_norm=1.0)))
    cfg.setdefault("lr_scheduler", Config(dict(total_steps=data.total_steps, init_steps=0,
                                               warmup_ratio=0.01, eta_min=1e-5)))
    cfg.setdefault("beta2_scheduler", Config(dict(init_beta2=cfg.adam.adam_beta2, c=cfg.adam.adam_beta2_c)))
    cfg.setdefault("loss", Config(dict(label_smoothing=0)))
    ckpt = cfg.setdefault("ckpt", Config())
    ckpt.setdefault("enable_save_ckpt", False)
    ckpt.setdefault("save_ckpt_folder", None)
    ckpt.setdefault("checkpoint_every", 50)
    ckpt.setdefault("load_ckpt_info", None)
    ckpt.setdefault("auto_resume", True)
    ckpt.setdefault("async_upload", True)
    ckpt.setdefault("async_upload_tmp_folder", "/dev/shm/internevo_tmp_ckpt/")
    ckpt.setdefault("oss_snapshot_freq", 0)
    ckpt.setdefault("stop_file_path", None)
    cfg.setdefault("monitor", Config(dict(alert=dict(enable_feishu_alert=False))))
    return cfg


@dataclasses.dataclass
class Launched:
    """What ``launch`` sets up: the checked config, the device and the seed."""

    config: Config
    device: torch.device
    seed: int


def launch(config: str | os.PathLike | dict | Config, seed: int = 1024, device: Any = "cuda") -> Launched:
    """Load ``config`` (a file, a dict or a ``Config``), default and check
    it, and pick the device: the card unless ``device`` is "cpu"; without a
    card "cuda" raises (``accelerator.get_device``).  One process has no
    process group to join, so this is also the reference's
    ``initialize_distributed_env`` (``launch.py:588``)."""
    if not isinstance(config, Config):
        config = Config(config) if isinstance(config, dict) else Config.from_file(config)
    return Launched(args_sanity_check(config), get_device(device), int(seed))
