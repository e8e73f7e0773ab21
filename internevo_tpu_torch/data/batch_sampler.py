"""Batch samplers with batch-size rampup and exact-resume state.

Parity: reference ``internlm/data/tokenized/batch_sampler.py`` —
``StaticBatchSampler`` (:110-287; epoch-seeded shuffling, rampup
"start incr every", dp-rank slicing, state_dict/load_state_dict re-deriving
indices from the saved RNG state) and ``DataParallelSampler`` (:21, eval).

A numpy-only copy of ``internevo_tpu/data/batch_sampler.py``, kept equal to it in
what it yields (``tests/test_torch_data.py``): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


class StaticBatchSampler:
    """Yields lists of dataset indices; one yield = one global step's micro-batches
    for this dp rank (batch_size = micro_num packs).

    Behavioral contract (pinned by ``tests/test_data`` golden streams and the
    reference-parity suite; the reference implementation is
    ``batch_sampler.py:110-287``):

    - the shuffle order is drawn from a ``np.random.RandomState(seed + epoch)``
      stream whose pre-shuffle state is captured so resume can re-derive the
      identical permutation instead of persisting the whole index array;
    - rampup "start incr every": the per-step batch size climbs from ``start``
      by ``incr`` every ``every`` steps until it reaches ``batch_size``;
    - the epoch's index pool is truncated so every post-rampup step is exactly
      full-batch across all dp ranks (no partial trailing batches);
    - dp rank r consumes the strided view ``pool[r::world]``.
    """

    def __init__(
        self,
        datasets,
        batch_size: int = 192,
        rampup_batch_size: str | None = "6 2 8",
        micro_bsz: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        data_rank: int = 0,
        data_world_size: int = 1,
    ):
        if not drop_last:
            raise NotImplementedError("partial trailing batches are not supported (drop_last=False)")
        if rampup_batch_size:
            ramp = tuple(int(tok) for tok in rampup_batch_size.split())
        else:
            ramp = (batch_size, batch_size, 1)
        self.raw_rampup_batch_size = rampup_batch_size
        self.start_bsz, self.bsz_incre, self.incre_every = ramp
        if (batch_size - self.start_bsz) % self.bsz_incre != 0:
            raise ValueError(f"rampup {ramp} cannot reach batch_size={batch_size} exactly")
        self.batch_size = batch_size
        self.micro_bsz = micro_bsz
        self.seed = seed
        self.epoch = 0
        self.rng = np.random.RandomState(seed)
        self.batch_count = 0  # global steps produced so far (drives rampup stage)
        self.data_rank = data_rank
        self.data_world_size = data_world_size
        self.datasets = datasets
        self.num_samples = sum(len(ds) for ds in datasets)
        self.num_consumed_samples_in_epoch = 0
        self._reshuffle()

    # ------------------------------------------------------------- internals

    def _ramp_stages(self) -> int:
        return (self.batch_size - self.start_bsz) // self.bsz_incre

    def _rampup_sample_budget(self) -> int:
        """Samples one dp rank consumes while the batch size is still climbing
        (vectorized arithmetic series over the rampup stages)."""
        stage_sizes = self.start_bsz + self.bsz_incre * np.arange(self._ramp_stages())
        return int(stage_sizes.sum()) * self.incre_every

    def _step_batch_size(self, step: int) -> int:
        return min(self.start_bsz + (step // self.incre_every) * self.bsz_incre, self.batch_size)

    def _pool_size(self) -> int:
        """Epoch pool size: whatever rampup needs plus a whole number of
        full-size global batches out of the remaining samples."""
        world = self.data_world_size
        if self.batch_count < self._ramp_stages() * self.incre_every:
            ramp_total = self._rampup_sample_budget() * world
            if ramp_total > self.num_samples:
                raise ValueError(
                    f"dataset ({self.num_samples} packs) too small for the requested "
                    f"rampup ({ramp_total} packs across {world} dp ranks)")
            full_batches = (self.num_samples - ramp_total) // (self.batch_size * world)
            return full_batches * self.batch_size * world + ramp_total
        return (self.num_samples // (self.batch_size * world)) * self.batch_size * world

    def _reshuffle(self, pool_size: int | None = None):
        """Draw the next permutation from the rng stream.  The rng state is
        captured *before* shuffling: ``load_state_dict`` restores it and calls
        this again with the CHECKPOINTED pool size, reproducing the identical
        pool without trusting the stored index array (the pool size depends on
        the batch_count at pool-BUILD time — rampup vs post-rampup — which the
        fresh sampler cannot re-derive)."""
        fresh = np.arange(self.num_samples)
        self.rng_state = self.rng.get_state()
        self.rng.shuffle(fresh)
        self.indices = fresh.astype(int)[: self._pool_size() if pool_size is None else pool_size]
        if len(self.indices) < self.batch_size:
            raise ValueError(f"epoch pool ({len(self.indices)}) smaller than one batch ({self.batch_size})")
        self.num_consumed_samples_in_epoch = 0

    # ------------------------------------------------------------- public api

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.rng = np.random.RandomState(self.seed + self.epoch)

    def __len__(self):
        if self.batch_count < self._ramp_stages() * self.incre_every:
            post_ramp = self.num_samples - self._rampup_sample_budget() * self.data_world_size
            return (post_ramp // self.batch_size) // self.data_world_size \
                + self._ramp_stages() * self.incre_every
        return self.num_samples // self.batch_size // self.data_world_size

    def __iter__(self):
        mine = self.indices[self.data_rank :: self.data_world_size]
        while self.num_consumed_samples_in_epoch < len(mine):
            cursor = self.num_consumed_samples_in_epoch
            take = self._step_batch_size(self.batch_count)
            batch = mine[cursor : cursor + take]
            self.num_consumed_samples_in_epoch += len(batch)
            self.batch_count += 1
            yield batch
        self._reshuffle()  # roll straight into the next pool

    def state_dict(self) -> dict:
        return {
            "batch_size": self.batch_size,
            "raw_rampup_batch_size": self.raw_rampup_batch_size,
            "rng_state": self.rng_state,
            "epoch": self.epoch,
            "seed": self.seed,
            "data_world_size": self.data_world_size,
            "num_consumed_samples_in_epoch": self.num_consumed_samples_in_epoch,
            "batch_count": self.batch_count,
            "indices": self.indices,
        }

    def load_state_dict(self, states: dict):
        for name in ("data_world_size", "raw_rampup_batch_size", "seed"):
            if states[name] != getattr(self, name):
                raise ValueError(f"resume mismatch on {name}: {states[name]} != {getattr(self, name)}")
        self.rng.set_state(states["rng_state"])
        self._reshuffle(pool_size=len(states["indices"]))
        np.testing.assert_array_equal(self.indices, states["indices"])  # drift guard
        self.epoch = states["epoch"]
        self.batch_count = states["batch_count"]
        self.num_consumed_samples_in_epoch = states["num_consumed_samples_in_epoch"]

    def copy(self) -> "StaticBatchSampler":
        out = StaticBatchSampler(
            self.datasets,
            self.batch_size,
            self.raw_rampup_batch_size,
            self.micro_bsz,
            self.seed,
            drop_last=True,
            data_rank=self.data_rank,
            data_world_size=self.data_world_size,
        )
        out.load_state_dict(self.state_dict())
        return out


class DataParallelSampler:
    """Eval-time dp sampler (reference :21): shards sample indices across dp ranks
    with optional shuffling; pads to equal length."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, data_rank: int = 0, data_world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.data_rank = data_rank
        self.data_world_size = data_world_size
        self.epoch = 0
        if self.drop_last and len(self.dataset) % self.data_world_size != 0:
            self.num_samples = math.ceil((len(self.dataset) - self.data_world_size) / self.data_world_size)
        else:
            self.num_samples = math.ceil(len(self.dataset) / self.data_world_size)
        self.total_size = self.num_samples * self.data_world_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(len(self.dataset))
        else:
            indices = np.arange(len(self.dataset))
        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                indices = np.concatenate([indices, indices[:pad]])
        else:
            indices = indices[: self.total_size]
        indices = indices[self.data_rank : self.total_size : self.data_world_size]
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i : i + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                break
            yield list(batch)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return math.ceil(self.num_samples / self.batch_size)
