"""Synthetic dataset for no-folder runs and loss-pin tests.

Parity: reference ``internlm/data/tokenized/dummy_dataset.py`` — RandomDataset
with the fixed seed 1999 and the [n, r] + range(n)*r construction, so loss
curves are reproducible across frameworks given the same sampler seed.

A numpy-only copy of ``internevo_tpu/data/dummy_dataset.py``, kept equal to it in
what it yields (``tests/test_torch_data.py``): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np


class RandomDataset:
    def __init__(self, num_samples: int = 10000, max_len: int = 1024, fixed_seqlen: bool = False):
        rng = np.random.RandomState(1999)
        max_num = rng.randint(1, 30, size=(num_samples,))
        rep_num = rng.randint(10, 200, size=(num_samples,))
        data = []
        lengths = []
        for n, r in zip(max_num, rep_num):
            d = list(range(n)) * r
            if fixed_seqlen:
                while len(d) < max_len:
                    r *= 2
                    d = list(range(n)) * r
            d = [n, r] + d
            d = d[:max_len]
            data.append(d)
            lengths.append(len(d))
        self.data = data
        self.max_len = max_len
        self.lengths = np.array(lengths, dtype=int)

    def __getitem__(self, index: int) -> dict:
        return {"tokens": list(np.array(self.data[index], dtype=int)), "type_id": 0}

    def get_dataset_name(self) -> str:
        return "dummy_path/dummy_lang/dummy_ds/train.bin"

    def __len__(self) -> int:
        return len(self.data)
