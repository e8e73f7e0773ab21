"""Collate functions producing numpy batches.

Parity: reference ``internlm/data/tokenized/collaters.py:7-88``
(``packed_collate_fn``, ``jsonl_ds_collate_fn``).  Addition to the reference: the
packed collater also converts ``cu_seqlens`` into dense per-token
``segment_ids`` — the segment encoding the splash attention kernels consume
instead of varlen cu_seqlens (SURVEY §2.9).

A numpy-only copy of ``internevo_tpu/data/collaters.py``, kept equal to it in
what it yields (``tests/test_torch_data.py``): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np


def cu_seqlens_to_segment_ids(cu_seqlens: np.ndarray, packed_length: int) -> np.ndarray:
    """[0, 3, 5, 8] -> [1, 1, 1, 2, 2, 3, 3, 3]; 1-based so that 0 can mean padding."""
    seg = np.zeros(packed_length, dtype=np.int32)
    boundaries = np.asarray(cu_seqlens[1:-1], dtype=np.int64)
    np.add.at(seg, boundaries[boundaries < packed_length], 1)
    return np.cumsum(seg).astype(np.int32) + 1


def packed_collate_fn(batch, packed_length: int):
    """Returns ``({input_ids, segment_ids, indexes, cu_seqlens, type_ids}, labels)``
    with everything shaped (B, packed_length) except cu_seqlens (list of arrays)."""
    xs, ys, ts, seg, idxs, cu_list = [], [], [], [], [], []
    for b in batch:
        assert len(b["tokens"]) == packed_length, (len(b["tokens"]), packed_length)
        assert len(b["labels"]) == packed_length
        tokens = np.abs(np.asarray(b["tokens"], dtype=np.int64))
        labels = np.asarray(b["labels"], dtype=np.int64)
        labels = np.where(labels > 0, labels, -100)
        xs.append(tokens.astype(np.int32))
        ys.append(labels.astype(np.int32))
        ts.append(np.asarray(b["type_ids"], dtype=np.int32))
        cu = np.asarray(b["cu_seqlens"], dtype=np.int32)
        cu_list.append(cu)
        seg.append(cu_seqlens_to_segment_ids(cu, packed_length))
        idxs.append(np.asarray(b["indexes"], dtype=np.int32))
    data = {
        "input_ids": np.stack(xs),
        "segment_ids": np.stack(seg),
        "indexes": np.stack(idxs),
        "cu_seqlens": cu_list,
        "type_ids": np.stack(ts),
    }
    return data, np.stack(ys)


def jsonl_ds_collate_fn(batch, max_length_per_sample: int):
    """Eval collater: pad whole samples to max_length (ref :61-88); emits
    segment_ids (1 = real tokens, 0 = pad) and restart positions for parity with
    the packed path."""
    xs, ys, tids = [], [], []
    for x in batch:
        # negative ids mark loss-masked tokens (SFT prompts; ref collaters.py:70:
        # labels from the RAW signed tokens, inputs from abs())
        raw = np.asarray(x["tokens"][:max_length_per_sample], dtype=np.int64)
        tokens = np.abs(raw)
        labels = np.where(raw > 0, raw, -100)
        labels = np.concatenate([labels[1:], [-100]])
        xs.append(tokens)
        ys.append(labels)
        tids.append(int(x.get("type_id", 0)))
    maxlen = max_length_per_sample
    B = len(xs)
    input_ids = np.zeros((B, maxlen), dtype=np.int32)
    label_arr = np.full((B, maxlen), -100, dtype=np.int32)
    seg = np.zeros((B, maxlen), dtype=np.int32)
    pos = np.zeros((B, maxlen), dtype=np.int32)
    type_ids = np.zeros((B, maxlen), dtype=np.int32)
    for i, (t, l) in enumerate(zip(xs, ys)):
        n = len(t)
        input_ids[i, :n] = t
        label_arr[i, :n] = l
        seg[i, :n] = 1
        pos[i, :n] = np.arange(n)
        pos[i, n:] = np.arange(maxlen - n)
        type_ids[i, :] = tids[i]
    return {"input_ids": input_ids, "segment_ids": seg, "indexes": pos,
            "type_ids": type_ids}, label_arr
