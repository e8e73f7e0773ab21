"""Scheduler hooks (port of ``internevo_tpu/core/scheduler/hooks.py``).

The reference ``SchedulerHook`` protocol (``utils/common.py:269-300``) with
its 7 callbacks, and ``SchedulerMetricHook`` (``model/metrics.py:340``),
which streams a train step's metrics dict into a metric object through
``post_helper_func``, as the JAX package does.  The ISP prefetch hook comes
with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional


class SchedulerHook:
    def before_forward(self, scheduler, inputs) -> None: ...

    def after_forward(self, scheduler, outputs) -> None: ...

    def before_criterion(self, scheduler, outputs, label) -> None: ...

    def after_criterion(self, scheduler, loss) -> None: ...

    def before_backward(self, scheduler, outputs, outputs_grad) -> None: ...

    def after_backward(self, scheduler, inputs_grad) -> None: ...

    def post_helper_func(self, scheduler, outputs, label) -> None: ...


class SchedulerMetricHook(SchedulerHook):
    """Streams step metrics into an AccPerplex-style metric object."""

    def __init__(self, metric: Optional[object] = None, skip: bool = False):
        self._metric = metric
        self._skip = skip

    def post_helper_func(self, scheduler, outputs, label=None) -> None:
        if self._skip or self._metric is None:
            return
        # ``outputs`` is the train-step metrics dict (host side)
        if isinstance(outputs, dict) and "n_tokens" in outputs:
            update = getattr(self._metric, "update_from_step", None)
            if update:
                update(outputs)
