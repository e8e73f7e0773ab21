"""Named phase timers (port of ``internevo_tpu/utils/timers.py``; reference
``internlm/utils/megatron_timers.py:11-135``).

Timers wrap host-side phases (batch load, fwd-bwd, save).  CUDA work is
asynchronous, so ``stop(barrier=True)`` synchronises the card first, where
the JAX timer waits on the device's effects.
"""

from __future__ import annotations

import time

import torch


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self._elapsed = 0.0
        self._started = False
        self._start_time = 0.0
        self.history: list[float] = []

    def start(self):
        if self._started:
            return
        self._started = True
        self._start_time = time.perf_counter()

    def stop(self, barrier: bool = False):
        if not self._started:
            return
        if barrier and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        delta = time.perf_counter() - self._start_time
        self._elapsed += delta
        self.history.append(delta)
        self._started = False

    def reset(self):
        self._elapsed = 0.0
        self._started = False

    def elapsed(self, reset: bool = True) -> float:
        if self._started:
            self.stop()
            self.start()
        out = self._elapsed
        if reset:
            self._elapsed = 0.0
        return out


class Timers:
    def __init__(self):
        self._timers: dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self._timers:
            self._timers[name] = _Timer(name)
        return self._timers[name]

    def log(self, names=None, logger=None, normalizer: float = 1.0, reset: bool = True) -> str:
        names = names if names is not None else list(self._timers)
        parts = [f"{name}: {self._timers[name].elapsed(reset=reset) / normalizer * 1000:.2f}ms"
                 for name in names if name in self._timers]
        msg = " | ".join(parts)
        if logger is not None and msg:
            logger.info("time: %s", msg)
        return msg


megatron_timer = Timers()
