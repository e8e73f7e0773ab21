"""Engine: bundles params, optimizer state, schedulers and the train step
(port of ``internevo_tpu/core/engine.py``; reference
``internlm/core/engine.py:19-196``).

The train step updates params and optimizer state in place; Engine owns
them, evaluates the lr and beta2 schedules on the host and keeps a host
mirror of the optimizer step.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..solver.lr_scheduler import Beta2Scheduler, CosineAnnealingWarmupLR


class Engine:
    def __init__(
        self,
        model,                      # ModelDef
        params,
        opt_state,
        train_step_fn: Callable,
        lr_scheduler: CosineAnnealingWarmupLR,
        beta2_scheduler: Optional[Beta2Scheduler] = None,
        eval_step_fn: Optional[Callable] = None,
    ):
        self.model = model
        self.params = params
        self.opt_state = opt_state
        self.train_step_fn = train_step_fn
        self.eval_step_fn = eval_step_fn
        self.lr_scheduler = lr_scheduler
        self.beta2_scheduler = beta2_scheduler
        self.current_lr = 0.0
        self._training = True
        # host-side mirror of opt_state["step"]: reading the device value every
        # step would wait for the device; incremented optimistically and
        # corrected via note_overflow() when a step was skipped
        self._host_step: Optional[int] = None

    def train(self):
        self._training = True

    def eval(self):
        self._training = False

    @property
    def step_count(self) -> int:
        if self._host_step is None:
            self._host_step = int(self.opt_state["step"])
        return self._host_step

    def note_overflow(self) -> None:
        """The step just run turned out to be skipped (non-finite grads)."""
        if self._host_step is not None and self._host_step > 0:
            self._host_step -= 1

    def reset_step_count(self) -> None:
        """Read the step count from the optimizer state again (after a
        checkpoint load: the lr schedule, dropout and the gate noise all
        follow the applied-step count)."""
        self._host_step = None

    def run_step(self, batch: dict) -> dict:
        """One global step: evaluate the schedules on the host, run the step."""
        step = self.step_count
        self._host_step = step + 1  # optimistic; corrected by note_overflow
        lr = self.lr_scheduler.get_lr(step)
        beta2 = self.beta2_scheduler.get_beta2(step + 1) if self.beta2_scheduler else None
        self.current_lr = lr
        self.params, self.opt_state, metrics = self.train_step_fn(
            self.params, self.opt_state, batch, lr, beta2)
        return metrics

    def run_eval_step(self, batch: dict) -> dict:
        if self.eval_step_fn is None:
            raise RuntimeError("this engine was built without an eval step")
        return self.eval_step_fn(self.params, batch)
