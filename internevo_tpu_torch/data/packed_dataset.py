"""Packed datasets: aggregate variable-length samples into fixed packed_length rows.

Parity: reference ``internlm/data/tokenized/packed_dataset.py`` —
``PackedDatasetWithCut`` (:206-390, samples CUT across pack boundaries, labels
pre-shifted per chunk with the cross-boundary label being the first token of the
next fragment, cu_seqlens re-split at ``max_length_per_sample``, position ids
restarting at each boundary) and ``PackedDatasetWithoutCuSeqlen`` (:70-204,
concatenation without boundaries).  Sample order is a seed-shuffled permutation
with DEFAULT_SEED=1024.

The behavioral contract here (SURVEY A.4) is what loss-matching the reference
depends on; the implementation is vectorised numpy rather than python lists.

A numpy-only copy of ``internevo_tpu/data/packed_dataset.py``, kept equal to it in
what it yields (``tests/test_torch_data.py``): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_SEED = 1024


class PackedDataset:
    def __init__(self, dataset, max_length_per_sample: int = 2048, packed_length: int = 4096,
                 use_packed: bool = True, micro_bsz: int = 1):
        assert hasattr(dataset, "lengths")
        assert len(dataset.lengths) == len(dataset)
        self.dataset = dataset
        self.max_length_per_sample = max_length_per_sample
        self.lengths = dataset.lengths
        self.packed_length = packed_length
        self.seed = DEFAULT_SEED
        self.use_packed = use_packed
        self.micro_bsz = micro_bsz

    def __getitem__(self, item: int) -> dict:
        if self.use_packed:
            return self.build_pack(item)
        return self.build_unpack(item)

    def _unpacked_len(self) -> int:
        # unpacked mode serves micro_bsz WHOLE samples per item (truncated to
        # max_length_per_sample) — NOT token windows
        return -(-len(self.dataset) // self.micro_bsz)

    def get_dataset_name(self):
        return self.dataset.get_dataset_name()


class PackedDatasetWithCut(PackedDataset):
    """Pack i = token window [i*P, (i+1)*P) of the seed-shuffled sample
    concatenation; samples are cut across pack boundaries.

    Behavioral contract (SURVEY A.4, pinned byte-identical by
    ``test_reference_pack_parity.py``):
    - labels are next-token within a sample; the label at a cut is the first
      token of the sample's continuation in the next pack; true sample ends
      get -100;
    - cu_seqlens additionally re-splits any span longer than
      ``max_length_per_sample`` (labels are NOT affected by the re-split);
    - position ids restart at every cu_seqlens boundary, and each pack
      fragment re-chunks from its own start.
    """

    def __init__(self, dataset, max_length_per_sample: int = 2048, packed_length: int = 4096,
                 use_packed: bool = True, micro_bsz: int = 1):
        super().__init__(dataset, max_length_per_sample, packed_length, use_packed, micro_bsz)
        order = np.arange(len(self.lengths))
        np.random.RandomState(self.seed).shuffle(order)
        self.shuffled_order = order
        # _cum_tokens[j] = tokens in the first j+1 shuffled samples; the sole
        # index structure (replaces any per-pack sample walking)
        self._cum_tokens = np.cumsum(np.asarray(self.lengths, dtype=np.int64)[order])
        self.num_tokens = int(self._cum_tokens[-1]) if len(order) else 0

    def __len__(self):
        if not self.use_packed:
            return self._unpacked_len()
        return self.num_tokens // self.packed_length

    def _locate(self, token_pos: int):
        """Global stream offset -> (shuffled sample index, offset inside it)."""
        j = int(np.searchsorted(self._cum_tokens, token_pos, side="right"))
        base = int(self._cum_tokens[j - 1]) if j > 0 else 0
        return j, token_pos - base

    def _spans(self, n: int):
        """Fragment of n tokens -> (span lengths capped at max_length, restart
        position ids), vectorized."""
        maxlen = self.max_length_per_sample
        positions = (np.arange(n) % maxlen).tolist()
        full, rem = divmod(n, maxlen)
        return [maxlen] * full + ([rem] if rem else []), positions

    def build_pack(self, item: int) -> dict:
        window_start = item * self.packed_length
        j, offset = self._locate(window_start)

        tokens, labels, type_ids, positions = [], [], [], []
        cu_seqlens = [0]
        remaining = self.packed_length
        while remaining > 0:
            sample = self.dataset[int(self.shuffled_order[j])]
            toks = sample["tokens"]
            frag = list(toks[offset : offset + remaining])
            if not frag:
                # zero-length sample (min_length=0 lets them through): nothing
                # to pack — appending the -100 carry with no token would
                # desync labels from tokens (the reference asserts on these,
                # packed_dataset.py:295; skipping is the lenient superset)
                j += 1
                offset = 0
                continue
            cut_at = offset + len(frag)
            # next-token labels; at a cut the label is the continuation's first
            # token, at a true sample end it is -100 (ref :312-318)
            carry = toks[cut_at] if cut_at < len(toks) else -100
            tokens.extend(frag)
            labels.extend(frag[1:])
            labels.append(carry)
            type_ids.extend([sample.get("type_id", 0)] * len(frag))
            span_lens, pos = self._spans(len(frag))
            positions.extend(pos)
            for s in span_lens:
                cu_seqlens.append(cu_seqlens[-1] + s)
            remaining -= len(frag)
            j += 1
            offset = 0

        return {"tokens": tokens, "cu_seqlens": cu_seqlens, "indexes": positions,
                "labels": labels, "type_ids": type_ids}

    def build_unpack(self, index: int) -> dict:
        """Unpacked mode: micro_bsz whole samples truncated to max_length, padded
        to packed_length with 0s and label 0 (ref :342-389)."""
        tokens, labels, type_ids, positions = [], [], [], []
        cu_seqlens = [0]
        lo = index * self.micro_bsz
        for j in range(lo, min(lo + self.micro_bsz, len(self.dataset))):
            sample = self.dataset[int(self.shuffled_order[j])]
            frag = list(sample["tokens"][: self.max_length_per_sample])
            tokens.extend(frag)
            labels.extend(frag[1:])
            labels.append(-100)
            type_ids.extend([sample.get("type_id", 0)] * len(frag))
            cu_seqlens.append(cu_seqlens[-1] + len(frag))
            positions.extend(range(len(frag)))
        pad = self.packed_length - cu_seqlens[-1]
        if pad > 0:
            tokens.extend([0] * pad)
            labels.extend([0] * pad)
            type_ids.extend([0] * pad)
            positions.extend(range(pad))
            cu_seqlens.append(self.packed_length)
        return {"tokens": tokens, "cu_seqlens": cu_seqlens, "indexes": positions,
                "labels": labels, "type_ids": type_ids}


class PackedDatasetWithoutCuSeqlen(PackedDataset):
    """Concatenate seed-shuffled samples without boundaries (ref :70-204):
    one pack is a contiguous packed_length token window; labels are global
    shift-by-1 within the window; positions run 0..packed_length-1."""

    def __init__(self, dataset, max_length_per_sample: int = 2048, packed_length: int = 4096,
                 use_packed: bool = True, micro_bsz: int = 1):
        assert packed_length % max_length_per_sample == 0
        super().__init__(dataset, max_length_per_sample, packed_length, use_packed, micro_bsz)
        indices = np.arange(len(self.lengths))
        rng = np.random.RandomState(self.seed)
        rng.shuffle(indices)
        self.indices = indices
        self.cum_lens = np.cumsum(np.asarray(self.lengths)[self.indices])
        self.num_tokens = int(sum(self.lengths))

    def __len__(self):
        if not self.use_packed:
            return self._unpacked_len()
        return self.num_tokens // self.packed_length

    def find_offset(self, offset: int):
        idx = int(np.searchsorted(self.cum_lens, offset, side="right"))
        if idx == 0:
            return idx, offset
        return idx, int(offset - self.cum_lens[idx - 1])

    def build_pack(self, item: int) -> dict:
        start = item * self.packed_length
        end = start + self.packed_length
        tokens, type_ids = [], []
        idx, offset = self.find_offset(start)
        while len(tokens) < self.packed_length and idx < len(self.indices):
            sample = self.dataset[self.indices[idx]]
            chunk = sample["tokens"][offset:]
            need = self.packed_length - len(tokens)
            chunk = chunk[:need]
            tokens.extend(chunk)
            type_ids.extend([sample.get("type_id", 0)] * len(chunk))
            idx += 1
            offset = 0
        labels = list(tokens[1:]) + [-100]
        cu_seqlens = list(range(0, self.packed_length + 1, self.max_length_per_sample))
        indexes = list(range(self.max_length_per_sample)) * (self.packed_length // self.max_length_per_sample)
        return {"tokens": tokens, "cu_seqlens": cu_seqlens, "indexes": indexes,
                "labels": labels, "type_ids": type_ids}

    build_unpack = build_pack  # no distinct unpacked mode for this variant


class ConcatDataset:
    """Minimal torch-free ConcatDataset over packed datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1]) if len(self._cum) else 0

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self._cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self._cum[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]

    def get_dataset_name(self):
        return "+".join(d.get_dataset_name() for d in self.datasets)


def get_packed_dataset_without_short_length(
    folder,
    max_length_per_sample: int = 2048,
    packed_length: int = 4096,
    show_progress: bool = False,
    min_length: int = 50,
    min_length_dict: dict | None = None,
    pack_sample_into_one: bool = False,
    use_packed: bool = True,
    micro_bsz: int = 1,
):
    """Walk a dataset folder of ``*.bin`` files, filter short samples, wrap each in
    a packed dataset, concat (ref ``packed_dataset.py:392+``)."""
    from .single_dataset import JsonlDataset
    from .utils import get_dataset_type_id

    min_length_dict = min_length_dict or {}
    datasets = []
    delete_samples = 0
    for root, _dirs, files in os.walk(folder, followlinks=True):
        for fn in sorted(files):
            if not fn.endswith(".bin"):
                continue
            fp = os.path.join(root, fn)
            ds_type_id = get_dataset_type_id(path=fp)
            ds = JsonlDataset(fp, ds_type_id, min_length=min_length_dict.get(fp, min_length))
            if len(ds) == 0:
                continue
            if hasattr(ds, "old_length"):
                delete_samples += ds.old_length - len(ds)
            cls = PackedDatasetWithoutCuSeqlen if pack_sample_into_one else PackedDatasetWithCut
            datasets.append(cls(ds, max_length_per_sample, packed_length, use_packed, micro_bsz))
    if not datasets:
        raise FileNotFoundError(f"no .bin datasets found under {folder}")
    return ConcatDataset(datasets)
