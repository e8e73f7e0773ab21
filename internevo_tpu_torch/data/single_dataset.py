"""Memmap-backed tokenized dataset.

Parity: reference ``internlm/data/tokenized/single_dataset.py:18-114`` —
``*.bin`` files of one-JSON-object-per-line ``{"tokens": [...]}`` plus a
``*.bin.meta`` numpy array of ``(byte_offset, length)`` rows; ``min_length``
filtering at load.

A numpy-only copy of ``internevo_tpu/data/single_dataset.py``, kept equal to it in
what it yields (``tests/test_torch_data.py``): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import json
import mmap
import os
import threading
from pathlib import Path

import numpy as np


class JsonlDataset:
    """One ``.bin`` token file addressed via its ``.bin.meta`` offsets index."""

    def __init__(self, path: str, dataset_type_id: int = 0, min_length: int = 50):
        self.path = str(path)
        self.threadlocal = threading.local()
        resolved_path = Path(path).resolve()
        self.resolved_path = resolved_path
        self.meta = Path(f"{resolved_path}.meta")
        self.type_id = dataset_type_id

        if not os.path.exists(self.meta):
            raise FileNotFoundError(f"meta file {self.meta} not found for {self.path}")
        with open(self.meta, "rb") as f:
            meta = np.load(f)
        self.offsets = meta[:, 0]
        self.lengths = meta[:, -1]
        if min_length > 0:
            mask = self.lengths >= min_length
            self.old_lengths = self.lengths.copy()
            self.old_length = len(self.offsets)
            self.offsets = self.offsets[mask]
            self.lengths = self.lengths[mask]

    def _get_mmap(self) -> mmap.mmap:
        if not hasattr(self.threadlocal, "handles"):
            f = open(self.path, "rb")
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self.threadlocal.handles = [f, mm]
        return self.threadlocal.handles[-1]

    def __getitem__(self, idx: int) -> dict:
        f = self._get_mmap()
        position = int(self.offsets[idx])
        f.seek(position)
        raw = f.readline()
        # native fast parse of the {"tokens": [...]} line (C++ fastpack);
        # falls back to json.loads when the toolchain is unavailable
        from ..native import parse_tokens_line

        tokens = parse_tokens_line(raw)
        return {"tokens": tokens.tolist(), "length": len(tokens), "type_id": self.type_id}

    def get_dataset_name(self) -> str:
        return str(self.resolved_path)

    def __len__(self) -> int:
        return len(self.offsets)

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "threadlocal"}

    def __setstate__(self, state):
        self.__dict__ = state
        self.threadlocal = threading.local()


def gen_shm_meta_name_without_scalar(path: str) -> str:  # parity helper
    return str(Path(path).resolve()) + ".meta"
