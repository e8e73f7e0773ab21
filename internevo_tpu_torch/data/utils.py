"""Data utilities: dataset-type mapping and packed→padded unpacking.

Parity: reference ``internlm/data/utils.py`` (:11-24 type-id map, :27-55
``unpack_data``).

A numpy-only copy of ``internevo_tpu/data/utils.py``, kept equal to it in
what it yields (``tests/test_torch_data.py``): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np

DATASET_TYPE_IDS_MAP = {"en": 0, "cn": 1, "code": 2}


def get_dataset_type_ids_map(path: str | None = None) -> dict:
    return dict(DATASET_TYPE_IDS_MAP)


def get_dataset_type_id(path: str) -> int:
    import re

    match_idxes = []
    for key, idx in DATASET_TYPE_IDS_MAP.items():
        if re.search(rf"/[z_]*{key}/", path):
            match_idxes.append(idx)
    assert len(match_idxes) == 1, f"{path} matched types {match_idxes}, should be exactly one"
    return match_idxes[0]


def unpack_data(input_ids: np.ndarray, cu_seqlens, padding_v: int = 0, seq_len: int = 2048):
    """Convert one packed row back into (micro_bsz, seq_len) padded rows
    (reference ``data/utils.py:27-55``, used when use_packed_dataset=False)."""
    bsz = input_ids.shape[0]
    num_seq = max(len(cu) - 1 for cu in cu_seqlens) if isinstance(cu_seqlens, list) else cu_seqlens.shape[1] - 1
    out = np.full((bsz, num_seq, seq_len), padding_v, dtype=input_ids.dtype)
    for b in range(bsz):
        cu = cu_seqlens[b] if isinstance(cu_seqlens, list) else cu_seqlens[b]
        for i in range(len(cu) - 1):
            lo, hi = int(cu[i]), int(cu[i + 1])
            out[b, i, : hi - lo] = input_ids[b, lo:hi]
    return out.reshape(-1, seq_len)
