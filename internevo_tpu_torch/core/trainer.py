"""Trainer (port of ``Trainer`` in ``internevo_tpu/core/trainer.py``;
reference ``internlm/core/trainer.py:138-213``): holds the engine and
exposes the reference's train-loop surface.  ``TrainState`` comes with the
data slice of the port."""

from __future__ import annotations


class Trainer:
    def __init__(self, engine):
        self._engine = engine

    @property
    def engine(self):
        return self._engine

    def execute_schedule(self, batch: dict) -> dict:
        """One training step on ``batch`` ((micro_num, B, S) tensors)."""
        return self._engine.run_step(batch)
