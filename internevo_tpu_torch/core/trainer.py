"""TrainState and Trainer (port of ``internevo_tpu/core/trainer.py``;
reference ``internlm/core/trainer.py``).

``TrainState`` (reference :20-135) counts batches, consumed samples and
tokens, skipped steps and applied steps, and keeps a snapshot of the batch
sampler for exact resume; the loader's prefetch runs ahead of the train
loop, so the snapshot is the epoch-start sampler and the consumed counters
say how far the loop got.  ``Trainer`` (reference :138-213) holds the engine
and exposes the reference's train-loop surface.
"""

from __future__ import annotations

from collections import deque


class TrainState:
    def __init__(self, config, batch_sampler=None):
        self.batch_count: int = 0
        self.num_consumed_samples_in_epoch: int = 0
        self.num_consumed_tokens: int = 0
        self.inf_nan_skip_batches: int = 0
        self.step_count: int = 0
        self.total_steps: int = config.data.total_steps
        # moving-average TGS windows (ref :49-57)
        self.tgs_statistic = {"sum_step": 0, "sum_tg": 0, "sum_time": 0.0, "last_tgs_10": deque(maxlen=10),
                              "last_tgs_50": deque(maxlen=50)}
        self.batch_sampler = batch_sampler
        self.batch_sampler_state = batch_sampler.copy() if batch_sampler is not None else None
        # Consumed-position counters for the sampler snapshot.  The loader's
        # prefetch thread advances the live sampler AHEAD of consumption (the
        # reference keeps a sampler .copy() for the same reason, trainer.py:28-89);
        # we snapshot the epoch-start state and track what the train loop has
        # actually consumed, merging the two at save time.
        self.sampler_consumed_batches = 0
        self.sampler_consumed_samples = 0

    def init_batch_sampler(self, batch_sampler):
        self.batch_sampler = batch_sampler
        self.batch_sampler_state = batch_sampler.copy()

    def note_batch_consumed(self, n_rows: int):
        self.sampler_consumed_batches += 1
        self.sampler_consumed_samples += n_rows

    def __str__(self) -> str:
        return (
            f"TrainState(batch_count={self.batch_count}, step_count={self.step_count}, "
            f"num_consumed_tokens={self.num_consumed_tokens}, "
            f"inf_nan_skip_batches={self.inf_nan_skip_batches})"
        )

    def load_state_dict(self, other: dict, train_dl=None):
        self.batch_count = other["batch_count"] + 1  # resume from the NEXT batch (ref :117)
        self.num_consumed_samples_in_epoch = other["num_consumed_samples_in_epoch"]
        self.num_consumed_tokens = other["num_consumed_tokens"]
        self.inf_nan_skip_batches = other["inf_nan_skip_batches"]
        self.step_count = other.get("step_count", self.batch_count)
        if train_dl is not None and "batch_sampler" in other:
            self.batch_sampler = train_dl.batch_sampler
            self.batch_sampler.load_state_dict(other["batch_sampler"])
            self.batch_sampler_state = self.batch_sampler.copy()
            self.sampler_consumed_batches = other["batch_sampler"]["batch_count"]
            self.sampler_consumed_samples = other["batch_sampler"]["num_consumed_samples_in_epoch"]

    def state_dict(self) -> dict:
        out = {
            "batch_count": self.batch_count,
            "num_consumed_samples_in_epoch": self.num_consumed_samples_in_epoch,
            "num_consumed_tokens": self.num_consumed_tokens,
            "inf_nan_skip_batches": self.inf_nan_skip_batches,
            "step_count": self.step_count,
        }
        if self.batch_sampler_state is not None:
            sampler_state = self.batch_sampler_state.state_dict()
            # overwrite the epoch-start snapshot's position with what the train
            # loop actually consumed (prefetch runs ahead of consumption)
            sampler_state["batch_count"] = self.sampler_consumed_batches
            sampler_state["num_consumed_samples_in_epoch"] = self.sampler_consumed_samples
            out["batch_sampler"] = sampler_state
        return out


class Trainer:
    def __init__(self, engine):
        self._engine = engine

    @property
    def engine(self):
        return self._engine

    def train(self):
        self._engine.train()

    def eval(self):
        self._engine.eval()

    def execute_schedule(self, batch: dict) -> dict:
        """One training step on ``batch`` ((micro_num, B, S) tensors)."""
        return self._engine.run_step(batch)
