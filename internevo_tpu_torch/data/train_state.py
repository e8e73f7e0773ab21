"""TrainState builder (port of ``internevo_tpu/data/train_state.py``; reference
``internlm/data/train_state.py:6``)."""

from __future__ import annotations

from ..core.trainer import TrainState


def get_train_state(config, dataloader) -> TrainState:
    return TrainState(config, batch_sampler=getattr(dataloader, "batch_sampler", None))
