"""Dataloader builders (port of ``internevo_tpu/data/build_dataloader.py``;
reference ``internlm/data/build_dataloader.py``).

The JAX package's in-process loader with a background prefetch thread
(packing is numpy and the per-step batch is small against the device step),
yielding the reference collaters' ``(data_dict, labels)``.  The JAX builders
read the launched global config; these take the config explicitly.  One
process feeds one device, so the data rank is 0 of 1 and one sampler batch is
``micro_num`` packs; the multi-GPU slice brings the per-rank slicing.
"""

from __future__ import annotations

import os
import queue
import threading
from functools import partial
from typing import Callable, Iterator

from .batch_sampler import DataParallelSampler, StaticBatchSampler
from .collaters import jsonl_ds_collate_fn, packed_collate_fn
from .dummy_dataset import RandomDataset
from .packed_dataset import (
    ConcatDataset,
    PackedDatasetWithCut,
    PackedDatasetWithoutCuSeqlen,
    get_packed_dataset_without_short_length,
)
from .single_dataset import JsonlDataset
from .utils import get_dataset_type_id, get_dataset_type_ids_map


class DataLoader:
    """Minimal map-style loader: batch_sampler yields index lists; collate_fn
    assembles numpy batches; optional prefetch thread keeps ``prefetch`` batches
    ready."""

    def __init__(self, dataset, batch_sampler, collate_fn: Callable, prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.prefetch = prefetch

    def _produce(self) -> Iterator:
        for idxs in self.batch_sampler:
            yield self.collate_fn([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            yield from self._produce()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for item in self._produce():
                    q.put(item)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item

    def __len__(self):
        return len(self.batch_sampler)


def get_tokenized_train_loader_items(data_cfg):
    use_packed = data_cfg.get("use_packed_dataset", True)
    micro_bsz = data_cfg.micro_bsz
    if data_cfg.get("train_folder", None) is None:
        base_ds = RandomDataset(
            num_samples=data_cfg.get("num_random_samples", 1000000),
            max_len=data_cfg.seq_len,
            fixed_seqlen=data_cfg.get("fixed_random_dataset_seqlen", False),
        )
        cls = PackedDatasetWithoutCuSeqlen if data_cfg.get("pack_sample_into_one", False) else PackedDatasetWithCut
        train_ds = cls(base_ds, max_length_per_sample=data_cfg.seq_len,
                       packed_length=data_cfg.packed_length, use_packed=use_packed, micro_bsz=micro_bsz)
    else:
        train_ds = get_packed_dataset_without_short_length(
            folder=data_cfg.train_folder,
            packed_length=data_cfg.packed_length,
            max_length_per_sample=data_cfg.seq_len,
            show_progress=True,
            min_length=data_cfg.get("min_length", 0),
            min_length_dict=data_cfg.get("min_length_dict", None),
            pack_sample_into_one=data_cfg.get("pack_sample_into_one", False),
            use_packed=use_packed,
            micro_bsz=micro_bsz,
        )
    dp_rank, dp_size, local_dp = _data_rank_and_size()
    # One sampler batch is micro_num * local_dp packs; row (j, r) of the
    # reshaped (micro_num, local_dp) batch is what reference dp rank r gets at
    # micro step j.  Rampup units count per-rank micro batches (reference
    # semantics) and are scaled to global units here.
    rampup = data_cfg.get("rampup_batch_size", None)
    if rampup and local_dp > 1:
        start, incre, every = map(int, rampup.split())
        rampup = f"{start * local_dp} {incre * local_dp} {every}"
    train_sampler = StaticBatchSampler(
        train_ds.datasets if isinstance(train_ds, ConcatDataset) else [train_ds],
        batch_size=data_cfg.micro_num * local_dp,
        rampup_batch_size=rampup,
        micro_bsz=micro_bsz,
        seed=data_cfg.get("seed", 1024),
        drop_last=True,
        data_rank=dp_rank,
        data_world_size=dp_size,
    )
    train_collate_fn = partial(packed_collate_fn, packed_length=data_cfg.packed_length)
    return train_ds, train_sampler, train_collate_fn


def _data_rank_and_size():
    """(process_rank, process_count, local_dp_rows_per_micro_step): one
    process feeding one device."""
    return 0, 1, 1


def build_train_loader_with_data_type(config):
    """Returns (train_dl, dataset_types) for ``config.data``."""
    data_cfg = config.data
    train_folder = data_cfg.get("train_folder", None)
    dataset_types = list(get_dataset_type_ids_map(train_folder).keys()) if train_folder else ["en", "cn", "code"]
    train_ds, train_sampler, train_collate_fn = get_tokenized_train_loader_items(data_cfg)
    train_dl = DataLoader(train_ds, train_sampler, train_collate_fn,
                          prefetch=data_cfg.get("prefetch", 2))
    return train_dl, dataset_types


def build_valid_loader_with_data_type(config):
    """Returns ({name: loader}, names) for ``config.data``'s validation sets."""
    data_cfg = config.data
    if not data_cfg.get("valid_folder", None):
        valid_ds = {"val": RandomDataset(
            num_samples=500 * max(1, _data_rank_and_size()[1]),
            max_len=data_cfg.seq_len,
            fixed_seqlen=data_cfg.get("fixed_random_dataset_seqlen", False),
        )}
    else:
        valid_ds = {}
        for root, _dirs, files in os.walk(data_cfg.valid_folder, followlinks=True):
            for fn in sorted(files):
                if fn.endswith(".bin"):
                    path = os.path.join(root, fn)
                    name = os.path.relpath(path, data_cfg.valid_folder)
                    try:  # type id from the folder layout (ref utils.py:11-24)
                        tid = get_dataset_type_id(path)
                    except AssertionError:
                        tid = 0
                    valid_ds[name] = JsonlDataset(path, tid, min_length=0)
    collate = partial(jsonl_ds_collate_fn, max_length_per_sample=data_cfg.seq_len)
    dp_rank, dp_size, _local_dp = _data_rank_and_size()
    loaders = {}
    for name, ds in valid_ds.items():
        sampler = DataParallelSampler(
            ds, batch_size=data_cfg.get("valid_micro_num", data_cfg.micro_num) * data_cfg.micro_bsz,
            shuffle=False, drop_last=True, data_rank=dp_rank, data_world_size=dp_size,
        )
        loaders[name] = DataLoader(ds, sampler, collate, prefetch=0)
    return loaders, list(valid_ds)
