"""Flops accounting, device peaks, the batch skipper and the entry point's
CLI (port of ``internevo_tpu/utils/common.py``)."""

from __future__ import annotations

import argparse

import torch


def get_megatron_flops(
    elapsed_time_per_iter: float,
    checkpoint: bool = False,
    seq_len: int = 2048,
    hidden_size: int = 12,
    num_layers: int = 32,
    vocab_size: int = 12,
    global_batch_size: int = 4,
    global_world_size: int = 1,
    mlp_ratio: float = 4,
    use_swiglu: bool = True,
) -> float:
    """Megatron-SC21 model-flops accounting (reference ``utils/common.py:208-239``).

    Returns TFLOPS per device. ``checkpoint`` adds the recompute factor (4 vs 3
    matmul passes).
    """
    checkpoint_activations_factor = 4 if checkpoint else 3
    if use_swiglu:
        mlp_ratio = mlp_ratio * 3 / 2
    flops_per_iteration = (
        checkpoint_activations_factor
        * (
            (8 + mlp_ratio * 4) * global_batch_size * seq_len * hidden_size**2
            + 4 * global_batch_size * seq_len**2 * hidden_size
        )
    ) * num_layers + 6 * global_batch_size * seq_len * hidden_size * vocab_size
    return flops_per_iteration / (elapsed_time_per_iter * global_world_size * 1e12)


# Peak dense bf16 TFLOP/s and device-memory bytes/s per card, keyed on a
# substring of torch.cuda.get_device_name() (NVIDIA data sheets, SXM parts,
# no sparsity).
GPU_PEAK_TFLOPS = {"H100": 989.0}
GPU_PEAK_BYTES_PER_S = {"H100": 3.35e12}
# fp32 FMAs outside the tensor cores (the CUDA-core bound kept beside the
# fp32 splash kernels' tensor-core one)
GPU_PEAK_FP32_TFLOPS = {"H100": 67.0}


def _lookup(table: dict, what: str, device_name: str | None) -> float:
    name = device_name if device_name is not None else torch.cuda.get_device_name(0)
    for key, value in table.items():
        if key in name:
            return value
    raise KeyError(f"no {what} known for device {name!r}")


def device_peak_tflops(device_name: str | None = None) -> float:
    """bf16 dense peak of the named card (default: CUDA device 0).  Raises for
    a card the table does not know, rather than guessing."""
    return _lookup(GPU_PEAK_TFLOPS, "bf16 peak", device_name)


def device_peak_fp32_tflops(device_name: str | None = None) -> float:
    """fp32 peak of the named card's CUDA cores (default: CUDA device 0)."""
    return _lookup(GPU_PEAK_FP32_TFLOPS, "fp32 peak", device_name)


# the bf16 products a fp32-exact product of three-piece operands takes
# (ops/cuda/pieces.py, TERMS)
FP32_EXACT_TERMS = 6


def device_peak_fp32_exact_tflops(device_name: str | None = None) -> float:
    """fp32-exact peak of the named card's tensor cores: the bf16 dense peak
    over the six bf16 products of three bf16 pieces an operand (the fp32
    splash kernels' rate)."""
    return device_peak_tflops(device_name) / FP32_EXACT_TERMS


def device_peak_bandwidth(device_name: str | None = None) -> float:
    """Device-memory bytes/s of the named card (default: CUDA device 0)."""
    return _lookup(GPU_PEAK_BYTES_PER_S, "memory bandwidth", device_name)


class BatchSkipper:
    """Skip the batches of given global steps, "lo-hi,n,..." (reference
    ``utils/common.py:165``)."""

    def __init__(self, skip_batches: str = ""):
        self.intervals = []
        if skip_batches:
            for chunk in skip_batches.split(","):
                lo, _, hi = chunk.partition("-")
                hi = hi or lo
                self.intervals.append((int(lo), int(hi)))

    def __call__(self, batch_count: int) -> bool:
        return any(lo <= batch_count <= hi for lo, hi in self.intervals)


def parse_args(argv=None) -> argparse.Namespace:
    """The entry point's CLI: the root ``train.py``'s ``--config``,
    ``--seed`` and ``--profiling``, and ``--device`` (the card unless "cpu"
    is asked for)."""
    parser = argparse.ArgumentParser(description="InternEvo training on one device (PyTorch port)")
    parser.add_argument("--config", type=str, required=True, help="path to the python config file")
    parser.add_argument("--seed", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--profiling", default=False, action="store_true",
                        help="trace batches 3-7 with torch.profiler into RUN/<JOB_NAME>/torch_trace")
    return parser.parse_args(argv)
