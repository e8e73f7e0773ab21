"""LR and beta2 schedules, as pure step->value functions (a copy of
``internevo_tpu/solver/lr_scheduler.py``, which imports no JAX; the port
imports nothing of that package).

Parity: reference ``internlm/solver/schedulers/lr_scheduler.py:10-135``
(``WarmupScheduler`` -> ``CosineAnnealingWarmupLR`` ->
``FineTuneCosineAnnealingWarmupLR``) and ``beta2_scheduler.py:7``.

The reference's torch versions are stateful wrappers around the optimizer;
here they are closed-form functions of the global step, evaluated on the host
and fed into the train step as a scalar -- resume needs no scheduler state
beyond step_count.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class CosineAnnealingWarmupLR:
    """Linear warmup for warmup_steps, then cosine from lr to eta_min over the
    remaining (total_steps - warmup_steps)."""

    lr: float
    total_steps: int
    warmup_steps: int = 0
    eta_min: float = 0.0

    def get_lr(self, step: int) -> float:
        """step is 0-based (torch last_epoch semantics: lr used at step N is
        get_lr after N steps; reference warmup uses (last_epoch+1)/warmup)."""
        if step < self.warmup_steps:
            return (step + 1) / self.warmup_steps * self.lr
        t = step - self.warmup_steps
        T = max(1, self.total_steps - self.warmup_steps)
        return self.eta_min + (self.lr - self.eta_min) * (1 + math.cos(math.pi * t / T)) / 2

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            if hasattr(self, k):
                setattr(self, k, v)


@dataclasses.dataclass
class FineTuneCosineAnnealingWarmupLR(CosineAnnealingWarmupLR):
    """lr==0 for init_steps, then warmup over warmup_ratio*total_steps, then cosine."""

    init_steps: int = 0
    warmup_ratio: float = 0.0

    def __post_init__(self):
        self.warmup_steps = int(self.total_steps * self.warmup_ratio)

    def get_lr(self, step: int) -> float:
        if step < self.init_steps:
            return 0.0
        if step < self.init_steps + self.warmup_steps:
            return (step + 1 - self.init_steps) / self.warmup_steps * self.lr
        t = step - self.warmup_steps - self.init_steps
        T = max(1, self.total_steps - self.warmup_steps - self.init_steps)
        return self.eta_min + (self.lr - self.eta_min) * (1 + math.cos(math.pi * t / T)) / 2


@dataclasses.dataclass
class Beta2Scheduler:
    """beta2(iter) = max(init_beta2, 1 - iter^-c); c<=0 disables annealing.

    Parity: reference ``beta2_scheduler.py`` (note ``cur_iter`` starts at 1 for
    the first step because torch steps the scheduler after the optimizer)."""

    init_beta2: float
    c: float = 0.8

    def get_beta2(self, step: int) -> float:
        if self.c <= 0:
            return self.init_beta2
        cur_iter = max(1, step)
        return max(self.init_beta2, 1 - (1 / cur_iter**self.c))


def build_lr_scheduler(adam_cfg, lr_scheduler_cfg) -> CosineAnnealingWarmupLR:
    """Build from config blocks (reference ``train/pipeline.py`` initialize_optimizer)."""
    return FineTuneCosineAnnealingWarmupLR(
        lr=adam_cfg.lr,
        total_steps=lr_scheduler_cfg.total_steps,
        init_steps=lr_scheduler_cfg.get("init_steps", 0),
        warmup_ratio=lr_scheduler_cfg.get("warmup_ratio", 0.0),
        eta_min=lr_scheduler_cfg.get("eta_min", 0.0),
    )
