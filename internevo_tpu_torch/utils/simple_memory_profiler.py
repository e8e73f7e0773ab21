"""Memory accounting and live device-memory reports (port of
``internevo_tpu/utils/simple_memory_profiler.py``; reference
``internlm/utils/simple_memory_profiler.py``).

The static layout (bytes of each top-level param subtree, of all params, of
the optimizer state, and an activation estimate) is the JAX package's,
byte for byte.  Where JAX reads the compiled step's memory analysis
(``note_compiled``), the port reads the CUDA caching allocator:
``torch.cuda.memory_stats`` and ``max_memory_allocated``.  A CPU run has no
allocator report, and reports the layout alone.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import torch

from ..solver.optimizer import tree_leaves
from .logger import get_logger

logger = get_logger(__name__)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _fmt(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PB"


class SimpleMemoryProfiler:
    """Static layout + periodic live snapshots."""

    def __init__(self, params, opt_state=None, log_file: Optional[str] = None,
                 activation_config: Optional[dict] = None):
        self.params = params
        self.opt_state = opt_state
        self.log_file = log_file
        self.activation_config = activation_config or {}
        self._step = 0
        self.reports: list[dict] = []

    def layout_report(self) -> dict:
        report: dict[str, Any] = {"params": {k: _fmt(_tree_bytes(sub)) for k, sub in self.params.items()}}
        report["params_total"] = _fmt(_tree_bytes(self.params))
        if self.opt_state is not None:
            report["optimizer_total"] = _fmt(_tree_bytes(self.opt_state))
        ac = self.activation_config
        if ac:
            # bf16 activations per token per layer for a pre-norm SwiGLU block
            h, m, layers = ac.get("hidden_size", 0), ac.get("mlp_hidden", 0), ac.get("num_layers", 0)
            per_token = 2 * (h * 6 + m * 2) * layers
            report["activation_estimate"] = _fmt(per_token * ac.get("tokens_per_device", 0))
        return report

    def device_memory_stats(self) -> dict:
        """The allocator's in-use, peak and reserved bytes on the params'
        card; nothing for CPU params."""
        device = tree_leaves(self.params)[0].device
        if device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(device)
        return {
            "bytes_in_use": _fmt(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": _fmt(torch.cuda.max_memory_allocated(device)),
            "bytes_reserved": _fmt(stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": _fmt(torch.cuda.get_device_properties(device).total_memory),
        }

    def step(self) -> Optional[dict]:
        """Count a settled step; report at steps 1, 5 and every 100th."""
        self._step += 1
        if not (self._step in (1, 5) or self._step % 100 == 0):
            return None
        report = {"step": self._step, **self.layout_report(), **self.device_memory_stats()}
        self.reports.append(report)
        line = json.dumps(report)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(line + "\n")
        else:
            logger.info("memory: %s", line)
        return report
