"""In-training device diagnostics, the counterpart of
``internevo_tpu/utils/tpudiag.py`` (reference ``internlm/utils/gputest.py``):
``empty_cache_and_diag``, the loop's cadence hook (reference :36), which
checks each step's time for outliers (``timer_diagnosis``, :117-180) and
every ``interval`` batches empties the allocator's cache and times a local
matmul (``bench_device``) and a 16 MB pass (``bench_net``).

One process drives one device here, so ``bench_net`` times the JAX
package's one-device stand-in for the all-reduce: ``a * 2`` over 16 MB.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..monitor.monitor import send_alert_message
from .logger import get_logger

logger = get_logger(__name__)

_step_history: list[float] = []


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def empty_cache_and_diag(batch_count: int, interval: int = 50, step_time: Optional[float] = None,
                         device="cuda") -> Optional[dict]:
    """Record ``step_time``; every ``interval`` batches (never at batch 0)
    empty the CUDA cache and run the benchmarks.  Returns the benchmark's
    readings when it ran; its errors are logged and dropped (JAX
    ``tpudiag.py:42-44``)."""
    if step_time is not None:
        timer_diagnosis(step_time)
    if interval <= 0 or batch_count == 0 or batch_count % interval != 0:
        return None
    device = torch.device(device)
    try:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        net = bench_net(device=device)
        tflops = bench_device(device=device)
    except Exception as e:  # diagnostics must never kill training
        logger.warning("diagnostics failed: %s", e)
        return None
    logger.info("diag@%d: allreduce_16MB=%.2fms (%.1f GB/s), local_matmul=%.1f TFLOPS",
                batch_count, net * 1e3, 16e-3 / max(net, 1e-9), tflops)
    return {"batch": batch_count, "net_s": net, "tflops": tflops}


def timer_diagnosis(step_time: float, outlier_ratio: float = 1.1, history: int = 50) -> None:
    """Alert on a step slower than ``outlier_ratio`` x 2 x the trimmed mean
    of the history (JAX ``tpudiag.py:47-58``)."""
    _step_history.append(step_time)
    if len(_step_history) > history:
        _step_history.pop(0)
    if len(_step_history) >= 10:
        hist = np.sort(np.asarray(_step_history[:-1]))
        trimmed = hist[1:-1].mean() if len(hist) > 4 else hist.mean()
        if step_time > outlier_ratio * trimmed * 2:
            send_alert_message(
                message=f"slow step detected: {step_time * 1e3:.1f}ms vs trimmed mean "
                        f"{trimmed * 1e3:.1f}ms")


def bench_net(size_mb: int = 16, device="cuda") -> float:
    """Seconds of ``a * 2`` over a 16 MB fp32 buffer on one device (JAX
    ``tpudiag.py:66-68``), the mean of 5 after a warm-up."""
    device = torch.device(device)
    x = torch.ones(size_mb * 1024 * 1024 // 4, dtype=torch.float32, device=device)
    out = x * 2
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(5):
        out = x * 2
    _sync(device)
    del out
    return (time.perf_counter() - t0) / 5


def bench_device(dim: int = 2048, device="cuda") -> float:
    """TFLOP/s of a (dim, dim) bf16 matmul, the mean of 20 after a warm-up."""
    device = torch.device(device)
    a = torch.ones((dim, dim), dtype=torch.bfloat16, device=device)
    out = a @ a
    _sync(device)
    steps = 20
    t0 = time.perf_counter()
    for _ in range(steps):
        out = a @ a
    _sync(device)
    del out
    return 2 * dim**3 / ((time.perf_counter() - t0) / steps) / 1e12
