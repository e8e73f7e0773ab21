"""Profile one step of the port on the card and break its device time down
by kernel class (counterpart of ``tools/profile_step.py``, which profiles the
JAX step).

    python -m internevo_tpu_torch.tools.profile_step train
    python -m internevo_tpu_torch.tools.profile_step score
    python -m internevo_tpu_torch.tools.profile_step moe_train
    python -m internevo_tpu_torch.tools.profile_step moe_score
    python -m internevo_tpu_torch.tools.profile_step internlm2_train
    python -m internevo_tpu_torch.tools.profile_step internlm2_score
    python -m internevo_tpu_torch.tools.profile_step gshard_train
    python -m internevo_tpu_torch.tools.profile_step gshard_score

``train``: the training slice's setup (``train_setup``): ``configs/7B_sft.py``
at full width and 8 layers, one step of 4 micro-batches of one packed
4096-token row through ``initialize_*`` and ``Trainer.execute_schedule``.
``score``: the same config at full depth, one ``make_eval_step`` over two
packed rows of 4096 tokens.  ``moe_train`` and ``moe_score``: the same two
on ``configs/7B_MoE4_sft.py`` routed dropless (``moe_config``), training at
4 layers (``moe_train_setup``), scoring at full depth.  ``internlm2_train``:
``configs/7B_internlm2.py`` at full width and 16 layers with recompute and
residual and attention dropout (``internlm2_train_config``), one step as
``train``'s; ``internlm2_score``: the same file at full depth, scored as
``score``.  ``gshard_train`` and ``gshard_score``: ``configs/7B_MoE4_sft.py``
as the file stands (GShard capacity routing, top-2, RTS, capacity factor 1;
``gshard_config``), training at 4 layers, scoring at full depth.  Weights
are random from a seed.  The step runs
twice untraced (kernel builds, allocator), then once under
``torch.profiler`` with CPU and CUDA activities.  One JSON line: the card and
its power limit, the traced step's wall seconds, the device's busy seconds
(the union of kernel intervals) and busy share, kernel milliseconds and
launches by class, the slowest kernels, and the kernel time inside the
recompute's profiler ranges (``core/remat.py``), or null where the profiler
records no range.

``train_setup``, ``moe_train_setup``, ``internlm2_train_config`` and
``packed_batch`` are also what ``chip_smoke.py`` trains with.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..core import remat
from ..core.config import Config
from ..core.scheduler.no_pipeline import make_eval_step
from ..core.trainer import Trainer
from ..models.base import ModelDef
from ..train.pipeline import initialize_model, initialize_optimizer, initialize_trainer

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "7B_sft.py"
MOE_CONFIG = CONFIG.with_name("7B_MoE4_sft.py")
INTERNLM2_CONFIG = CONFIG.with_name("7B_internlm2.py")
SEED = 0
ROW, MAX_SEG, SCORE_ROWS, SCORE_PAD = 4096, 2048, 2, 357
# training: 7B_sft at full width, depth cut to 8 layers so that the 18 bytes a
# parameter of weights, fp32 grads and AdamW state fit one 80 GB card; a
# 20-step lr schedule, so that the config's 500-step warm-up does not hold lr
# near 0 over a few steps
TRAIN_LAYERS, TRAIN_LR_STEPS = 8, 20
# MoE training: 7B_MoE4_sft at full width, depth cut to 4 layers: 845.2M
# embedding and head params and 608.2M a layer, 59 GB of state at 18 bytes a
# parameter, plus bf16 grads and one micro-batch's activations
MOE_TRAIN_LAYERS = 4
# InternLM2 training: 7B_internlm2 at full width, depth cut to 16 layers with
# every layer recomputed (0.758B embedding and head params and 0.177B a
# layer: 3.59B params, 64.7 GB of state at 18 bytes a parameter), residual
# and attention dropout at 0.1; the shipped file sets neither
INTERNLM2_TRAIN_LAYERS = 16
INTERNLM2_TRAIN_OVERRIDES = dict(checkpoint=1.0, drop_rate=0.1, attn_drop_rate=0.1)
# the reference's name for dropless MegaBlocks, which the model routes through
# the grouped matmul (kernels B3, B4); the config file says "GShard" (capacity
# routing, dense dispatch and combine), which ``gshard_config`` keeps
MOE_TYPE = "MegaBlock-D"
# kernel classes, first match of a name fragment wins ("tgmm_kernel" holds
# "gmm_kernel", and none of the three holds "gemm")
CLASSES = (
    ("split_pieces", ("split_kernel",)),
    ("splash_fwd", ("splash_fwd_kernel",)),
    ("splash_bwd_dkdv", ("splash_bwd_dkdv_kernel",)),
    ("splash_bwd_dq", ("splash_bwd_dq_kernel",)),
    ("fused_adamw", ("adamw_kernel",)),
    ("dropout", ("dropout_kernel",)),
    ("gmm_dgrad", ("gmm_dgrad_kernel",)),
    ("tgmm", ("tgmm_kernel",)),
    ("gmm", ("gmm_kernel",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def packed_segments(B, S, max_len, pad, rng):
    """Cut-packing: contiguous runs of at most max_len, positions restart per
    run, the last ``pad`` tokens are segment 0."""
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        p, sid = 0, 1
        while p < S - pad:
            n = min(int(rng.randint(64, max_len + 1)), S - pad - p)
            seg[b, p:p + n] = sid
            pos[b, p:p + n] = np.arange(n)
            p += n
            sid += 1
        pos[b, S - pad:] = np.arange(pad)
    return seg, pos


def packed_batch(lead: tuple, S: int, pad: int, vocab: int, rng, device="cuda") -> dict:
    """Random ids and labels over cut-packed rows, shaped ``lead + (S,)``, on
    ``device``; padding labels are -100."""
    n = int(np.prod(lead))
    seg, pos = packed_segments(n, S, MAX_SEG, pad, rng)
    labels = rng.randint(0, vocab, (n, S))
    labels[:, S - pad:] = -100
    out = {"input_ids": rng.randint(0, vocab, (n, S)), "indexes": pos, "segment_ids": seg, "labels": labels}
    return {k: torch.from_numpy(v.reshape(*lead, S)).to(device) for k, v in out.items()}


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, frags in CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"


def _union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile(step) -> dict:
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if e.name != remat.PROFILE_LABEL]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    # the recompute's ranges as the device ran them, where the profiler
    # records them (user annotations on the device timeline)
    spans = [(e.time_range.start, e.time_range.end) for e in device if e.name == remat.PROFILE_LABEL]
    recompute_ms = (sum(e.time_range.elapsed_us() for e in kernels
                        if any(a <= e.time_range.start and e.time_range.end <= b for a, b in spans)) / 1e3
                    if spans else None)
    by_class: dict = {}
    by_name: dict = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        c = by_class.setdefault(kernel_class(e.name), [0.0, 0])
        c[0] += us / 1e3
        c[1] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = _union_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall, "kernels": len(kernels),
            "recompute_kernel_ms": recompute_ms, "recompute_ranges": len(spans),
            "kernel_ms_by_class": {k: round(v[0], 3) for k, v in sorted(by_class.items(), key=lambda kv: -kv[1][0])},
            "launches_by_class": {k: v[1] for k, v in by_class.items()},
            "top_kernels_ms": [[name[:120], round(ms, 3)] for name, ms in top]}


def train_config(num_layers: int = TRAIN_LAYERS) -> Config:
    config = Config.from_file(CONFIG)
    config.model.num_layers = num_layers
    config.lr_scheduler.total_steps = TRAIN_LR_STEPS
    return config


def moe_config(num_layers: int | None = None) -> Config:
    """``configs/7B_MoE4_sft.py`` routed dropless (``MOE_TYPE``, as
    ``bench.py`` sets ``moe_type`` for its MoE presets), the rest of the file
    unchanged (its ``moe`` block's top_k 2, ``moe_loss_coeff`` 0.1); depth
    cut to ``num_layers`` when given, and the 20-step lr schedule."""
    config = Config.from_file(MOE_CONFIG)
    config.model.moe_type = MOE_TYPE
    if num_layers is not None:
        config.model.num_layers = num_layers
    config.lr_scheduler.total_steps = TRAIN_LR_STEPS
    return config


def gshard_config(num_layers: int | None = None) -> Config:
    """``configs/7B_MoE4_sft.py`` as the file stands (GShard routing, its lr
    schedule), the depth cut to ``num_layers`` when given."""
    config = Config.from_file(MOE_CONFIG)
    if num_layers is not None:
        config.model.num_layers = num_layers
    return config


def internlm2_train_config(num_layers: int = INTERNLM2_TRAIN_LAYERS, **overrides) -> Config:
    """``configs/7B_internlm2.py`` with the depth cut to ``num_layers``,
    ``INTERNLM2_TRAIN_OVERRIDES`` (then ``overrides``) on its model block,
    and the 20-step lr schedule."""
    config = Config.from_file(INTERNLM2_CONFIG)
    config.model.num_layers = num_layers
    for k, v in {**INTERNLM2_TRAIN_OVERRIDES, **overrides}.items():
        config.model[k] = v
    config.lr_scheduler.total_steps = TRAIN_LR_STEPS
    return config


def train_setup(device, seed: int = SEED, config: Config | None = None
                ) -> tuple[Config, ModelDef, dict, Trainer, dict]:
    """(config, model, params, trainer, batch) of the training slice: the
    ``train_config`` model (or ``config``'s) and optimizer through
    ``initialize_*``, and one step's batch of ``micro_num`` packed rows of
    ``micro_bsz * seq_len`` tokens, shaped (micro_num, 1, S), all drawn from
    ``seed``."""
    config = config if config is not None else train_config()
    model, params = initialize_model(config, device, torch.Generator(device=device).manual_seed(seed))
    opt_state, lr_sched, beta2_sched = initialize_optimizer(model, params, config)
    trainer = initialize_trainer(model, params, opt_state, lr_sched, beta2_sched, config)
    d = config.data
    batch = packed_batch((d.micro_num, 1), d.micro_bsz * d.seq_len, 0, model.config.vocab_size,
                         np.random.RandomState(seed), device)
    return config, model, params, trainer, batch


def moe_train_setup(device, seed: int = SEED) -> tuple[Config, ModelDef, dict, Trainer, dict]:
    """``train_setup`` on ``moe_config(MOE_TRAIN_LAYERS)``."""
    return train_setup(device, seed, moe_config(MOE_TRAIN_LAYERS))


def train_step(config: Config):
    config, model, _, trainer, batch = train_setup("cuda", SEED, config)
    d = config.data
    return lambda: trainer.execute_schedule(batch), d.micro_num * d.micro_bsz * d.seq_len, model.config.num_layers


def score_step(config: Config):
    model, params = initialize_model(config, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    batch = packed_batch((SCORE_ROWS,), ROW, SCORE_PAD, model.config.vocab_size, np.random.RandomState(SEED))
    step = make_eval_step(model)
    return lambda: step(params, batch), SCORE_ROWS * ROW, model.config.num_layers


PATHS = {"train": lambda: train_step(train_config()), "score": lambda: score_step(Config.from_file(CONFIG)),
         "moe_train": lambda: train_step(moe_config(MOE_TRAIN_LAYERS)), "moe_score": lambda: score_step(moe_config()),
         "internlm2_train": lambda: train_step(internlm2_train_config()),
         "internlm2_score": lambda: score_step(Config.from_file(INTERNLM2_CONFIG)),
         "gshard_train": lambda: train_step(gshard_config(MOE_TRAIN_LAYERS)),
         "gshard_score": lambda: score_step(gshard_config())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", choices=tuple(PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    step, tokens, layers = PATHS[args.path]()
    out = profile(step)
    print(json.dumps({"path": args.path, "layers": layers,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tokens": tokens, "tokens_per_s_traced": tokens / out["wall_s"],
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, **out}), flush=True)


if __name__ == "__main__":
    main()
