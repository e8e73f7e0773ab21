"""Synthetic dataset for no-folder runs and loss-pin tests.

Parity: reference ``internlm/data/tokenized/dummy_dataset.py`` — RandomDataset
with the fixed seed 1999 and the [n, r] + range(n)*r construction, so loss
curves are reproducible across frameworks given the same sampler seed.

It yields what ``internevo_tpu/data/dummy_dataset.py`` yields
(``tests/test_torch_data.py`` holds every sample equal), but keeps only each
sample's (n, r) and length and builds its tokens when it is read: the JAX
package builds every sample as a python list at construction, which for the
shipped files' 1,000,000 samples of 2,048 tokens takes ~16 GB of host memory
and over a minute.  The port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


class RandomDataset:
    def __init__(self, num_samples: int = 10000, max_len: int = 1024, fixed_seqlen: bool = False):
        rng = np.random.RandomState(1999)
        max_num = rng.randint(1, 30, size=(num_samples,))
        rep_num = rng.randint(10, 200, size=(num_samples,))
        if fixed_seqlen:
            # the reference doubles r until range(n) * r holds max_len tokens
            short = max_num * rep_num < max_len
            while short.any():
                rep_num = np.where(short, rep_num * 2, rep_num)
                short = max_num * rep_num < max_len
        self.max_num = max_num
        self.rep_num = rep_num
        self.max_len = max_len
        self.lengths = np.minimum(2 + max_num * rep_num, max_len).astype(int)

    def __getitem__(self, index: int) -> dict:
        n, r, length = self.max_num[index], self.rep_num[index], self.lengths[index]
        tokens = np.empty(length, dtype=int)
        tokens[:2] = (n, r)
        tokens[2:] = np.arange(length - 2) % n
        return {"tokens": list(tokens), "type_id": 0}

    def get_dataset_name(self) -> str:
        return "dummy_path/dummy_lang/dummy_ds/train.bin"

    def __len__(self) -> int:
        return len(self.lengths)
