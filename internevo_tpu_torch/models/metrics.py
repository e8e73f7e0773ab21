"""Streaming training and validation metrics (port of
``internevo_tpu/models/metrics.py``; reference ``internlm/model/metrics.py``).

``AccPerplex`` (reference :55) streams token accuracy and perplexity across
batches, with optional per-dataset-type bins and bits per byte;
``LossWithTypeId`` (:246) streams the loss with per-type bins.  Batch
statistics are computed from torch tensors on their device; the running sums
are host numbers, as in the JAX classes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _batch_stats(logits: torch.Tensor, labels: torch.Tensor):
    """(n_correct, n_tokens, nll_sum, per-token nll) of one batch, -100
    labels ignored, in fp32."""
    flat = logits.reshape(-1, logits.shape[-1]).float()
    lab = labels.reshape(-1)
    valid = lab != -100
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    n_correct = ((flat.argmax(dim=-1) == lab) & valid).sum()
    picked = torch.take_along_dim(flat, safe[:, None], dim=-1)[:, 0]
    nll = torch.where(valid, torch.logsumexp(flat, dim=-1) - picked, torch.zeros_like(picked))
    return n_correct, valid.sum(), nll.sum(), nll


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class AccPerplex:
    """Streaming accuracy and perplexity with optional per-type bins."""

    def __init__(self, device=None, tp_pg=None, dp_pg=None, tokenizer=None,
                 dataset_types: Optional[list] = None):
        self.tokenizer = tokenizer
        self._token_bytes = None  # id -> utf-8 byte count, made on first use
        self.dataset_types = dataset_types or []
        self.loss_with_type_id = LossWithTypeId(dataset_types=dataset_types)
        self.reset()

    def reset(self):
        self.right = 0
        self.total = 0
        self.total_log_probs = 0.0
        self.total_bytes = 0
        self.type_right = {t: 0 for t in self.dataset_types}
        self.type_total = {t: 0 for t in self.dataset_types}
        self.loss_with_type_id.reset()

    def _bytes_of(self, token_ids: np.ndarray) -> int:
        """utf-8 byte count of the label tokens, from a per-id table of the
        tokenizer's pieces (sentencepiece or HF), or by decoding each token
        for a tokenizer with only ``decode`` (JAX ``AccPerplex._bytes_of``)."""
        tok = self.tokenizer
        if self._token_bytes is None:
            if hasattr(tok, "id_to_piece"):
                pieces = [tok.id_to_piece(i) for i in range(tok.vocab_size())]
            elif hasattr(tok, "convert_ids_to_tokens"):
                pieces = tok.convert_ids_to_tokens(list(range(len(tok))))
            else:
                return sum(len(tok.decode([int(t)]).encode("utf-8")) for t in token_ids)
            self._token_bytes = np.asarray(
                [len(p.replace("▁", " ").encode("utf-8")) for p in pieces], np.int64)
        return int(self._token_bytes[np.clip(token_ids, 0, len(self._token_bytes) - 1)].sum())

    def update(self, logits, labels, type_ids=None):
        n_correct, n_tokens, nll, nll_all = _batch_stats(logits, labels)
        self.right += int(n_correct)
        self.total += int(n_tokens)
        self.total_log_probs += float(nll)
        lab = _host(labels).reshape(-1)
        valid = lab != -100
        if self.tokenizer is not None:
            self.total_bytes += self._bytes_of(lab[valid])
        self.loss_with_type_id.update_from_nll(_host(nll_all), lab, type_ids)
        if type_ids is not None and self.dataset_types:
            pred = _host(logits.reshape(-1, logits.shape[-1]).argmax(dim=-1))
            tid = _host(type_ids).reshape(-1)
            for i, t in enumerate(self.dataset_types):
                m = valid & (tid == i)
                self.type_total[t] += int(m.sum())
                self.type_right[t] += int(((pred == lab) & m).sum())

    def update_from_token_stats(self, nll, correct, labels, type_ids=None):
        """Accumulate from per-token (nll, correct), the logits-free eval path
        (``make_eval_step(per_token=True)``)."""
        nll = _host(nll).reshape(-1)
        cor = _host(correct).reshape(-1)
        lab = _host(labels).reshape(-1)
        valid = lab != -100
        self.right += int(cor.sum())
        self.total += int(valid.sum())
        self.total_log_probs += float(nll.sum())
        if self.tokenizer is not None:
            self.total_bytes += self._bytes_of(lab[valid])
        self.loss_with_type_id.update_from_nll(nll, lab, type_ids)
        if type_ids is not None and self.dataset_types:
            tid = _host(type_ids).reshape(-1)
            n_types = len(self.dataset_types)
            totals = np.bincount(tid[valid], minlength=n_types)
            rights = np.bincount(tid[valid], weights=cor[valid], minlength=n_types)
            for i, t in enumerate(self.dataset_types):
                self.type_total[t] += int(totals[i])
                self.type_right[t] += int(rights[i])

    def __call__(self, logits, labels, type_ids=None):
        self.update(logits, labels, type_ids=type_ids)

    def get_metric(self, reset: bool = True) -> dict:
        total = max(self.total, 1)
        res = {
            "acc": round(self.right / total, 5),
            "perplexity": round(float(np.exp(min(self.total_log_probs / total, 80))), 5),
        }
        if self.tokenizer is not None:
            res["BPB"] = round(self.total_log_probs / max(self.total_bytes, 1), 4)
        for t in self.dataset_types:
            if self.type_total[t] > 0:
                res[f"acc/{t}"] = round(self.type_right[t] / self.type_total[t], 5)
        res.update(self.loss_with_type_id.get_metric(reset=False))
        if reset:
            self.reset()
        return res


class LossWithTypeId:
    """Streaming loss with per-dataset-type bins, reported as ``loss/{type}``
    and ``perplexity/{type}``."""

    def __init__(self, device=None, dp_pg=None, dataset_types: Optional[list] = None):
        self.dataset_types = dataset_types or []
        self.reset()

    def reset(self):
        self.loss = 0.0
        self.token_num = 0
        self.type_loss = {t: 0.0 for t in self.dataset_types}
        self.type_tokens = {t: 0 for t in self.dataset_types}

    def update(self, logits, labels, type_ids=None):
        nll_all = _batch_stats(logits, labels)[3]
        self.update_from_nll(_host(nll_all), _host(labels).reshape(-1), type_ids)

    def update_from_nll(self, nll, labels, type_ids=None):
        """Accumulate from per-token nll (shared with ``AccPerplex``)."""
        nll, labels = _host(nll).reshape(-1), _host(labels).reshape(-1)
        valid = labels != -100
        self.loss += float(nll[valid].sum())
        self.token_num += int(valid.sum())
        if type_ids is not None and self.dataset_types:
            tid = _host(type_ids).reshape(-1)
            n_types = len(self.dataset_types)
            sums = np.bincount(tid[valid], weights=nll[valid], minlength=n_types)
            counts = np.bincount(tid[valid], minlength=n_types)
            for i, t in enumerate(self.dataset_types):
                self.type_loss[t] += float(sums[i])
                self.type_tokens[t] += int(counts[i])

    def get_metric(self, reset: bool = True) -> dict:
        res = {"loss_from_metric": round(self.loss / max(self.token_num, 1), 4)}
        for t in self.dataset_types:
            if self.type_tokens[t] > 0:
                mean = self.type_loss[t] / self.type_tokens[t]
                res[f"loss/{t}"] = round(mean, 4)
                res[f"perplexity/{t}"] = round(float(np.exp(min(mean, 80))), 4)
        if reset:
            self.reset()
        return res
