"""Device shim (port of ``internevo_tpu/accelerator.py``).

The port names its device explicitly.  ``get_device("cuda")`` returns the
card or raises when there is none; it never hands back the CPU.  The CPU is
given only when asked for by name, as the tests do.
"""

from __future__ import annotations

import torch


def get_device(kind: str | torch.device = "cuda") -> torch.device:
    """The device named by ``kind``; a ``torch.device`` is returned as it is."""
    if isinstance(kind, torch.device):
        return kind
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device kind must be 'cuda' or 'cpu', not {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port does not fall back to the CPU")
    return torch.device("cuda")

