"""Fused final-norm + head matmul + cross-entropy, chunked over tokens
(port of ``internevo_tpu/ops/fused_ce.py``).

Each chunk of ``chunk_size`` tokens is normed, projected to the vocab and
reduced, so the full (tokens, vocab) logits are never materialised: at
InternLM-7B (vocab 103168) they would be 1.7 GB in bf16 for one packed batch.
``chunk_size`` is an explicit argument (default 512).  The head weight is in
``torch.nn.Linear`` layout, (vocab, hidden).

Under autograd each chunk body runs inside
``torch.utils.checkpoint.checkpoint`` (the JAX ``jax.checkpoint`` around the
scanned chunk body), so the backward recomputes the chunk's logits and keeps
only its inputs; ``save_logits=True`` keeps each chunk's model-dtype logits
instead and recomputes only the reductions after them (the JAX
``save_only_these_names("ce_logits")`` policy).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .norm import rms_norm

DEFAULT_CHUNK = 512


def loss_knobs(loss: dict) -> dict:
    """``save_logits`` and ``chunk_size`` from a config's ``loss`` block
    (``save_ce_logits``, ``ce_chunk_size``), as the JAX ``gpc_loss_knobs``
    resolves them from the launched config (``internevo_tpu/ops/fused_ce.py:
    24-38``): unset, the logits are recomputed and chunks are
    ``DEFAULT_CHUNK`` tokens.  The port reads no environment variable."""
    return {"save_logits": bool(loss.get("save_ce_logits") or False),
            "chunk_size": int(loss.get("ce_chunk_size", 0) or 0) or None}


def _head_weight(head_weight, embed_grad_scale: float, norm_head: bool):
    w = head_weight
    if embed_grad_scale != 1:
        w = embed_grad_scale * w + (1 - embed_grad_scale) * w.detach()
    if norm_head:
        norm = torch.linalg.vector_norm(w.float(), dim=1, keepdim=True)
        w = (w / (norm.detach() + 1e-7)).to(w.dtype)
    return w


def _chunks(hidden, labels, chunk_size):
    B, S, H = hidden.shape
    flat_h = hidden.reshape(B * S, H)
    flat_lab = labels.reshape(B * S)
    step = min(chunk_size or DEFAULT_CHUNK, B * S)
    for lo in range(0, B * S, step):
        yield flat_h[lo:lo + step], flat_lab[lo:lo + step]


def _chunk_logits(h_c, norm_weight, w, eps: float):
    hn = rms_norm(h_c, norm_weight, eps=eps, out_dtype=h_c.dtype)
    return torch.nn.functional.linear(hn, w.to(hn.dtype))  # (c, V) in the model dtype


def _chunk_ce(logits, lab_c, label_smoothing: float, compute_acc: bool):
    """(nll_sum, n_valid, n_correct) of one chunk's logits."""
    valid = lab_c != -100
    safe = torch.where(valid, lab_c, torch.zeros_like(lab_c)).long()
    # max of the model-dtype logits is exact; detached like the JAX
    # stop_gradient (the max shift's cotangent cancels)
    m = logits.detach().amax(dim=-1).float()
    lse = m + torch.log(torch.exp(logits.float() - m[:, None]).sum(dim=-1))
    picked = torch.take_along_dim(logits, safe[:, None], dim=-1)[:, 0].float()
    nll = lse - picked
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (lse - logits.float().mean(dim=-1))
    nll_sum = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    n_correct = (((logits.argmax(dim=-1) == lab_c) & valid).sum() if compute_acc
                 else torch.zeros((), dtype=torch.int64, device=logits.device))
    return nll_sum, valid.sum(), n_correct


def _chunk_body(h_c, lab_c, norm_weight, w, eps: float, label_smoothing: float, compute_acc: bool):
    return _chunk_ce(_chunk_logits(h_c, norm_weight, w, eps), lab_c, label_smoothing, compute_acc)


def fused_norm_head_ce(hidden, norm_weight, head_weight, labels, *, eps: float = 1e-5,
                       embed_grad_scale: float = 1.0, norm_head: bool = False,
                       label_smoothing: float = 0.0, chunk_size: int | None = None,
                       compute_acc: bool = True, save_logits: bool = False):
    """hidden (B, S, H) pre-final-norm; head_weight (V, H); labels (B, S),
    -100 ignored.  Returns (nll_sum fp32, n_valid, n_correct), nll_sum
    differentiable in hidden, norm_weight and head_weight."""
    w = _head_weight(head_weight, embed_grad_scale, norm_head)
    remat = torch.is_grad_enabled()
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=hidden.device)
    n_correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for h_c, lab_c in _chunks(hidden, labels, chunk_size):
        if not remat:
            out = _chunk_body(h_c, lab_c, norm_weight, w, eps, label_smoothing, compute_acc)
        elif save_logits:
            out = checkpoint(_chunk_ce, _chunk_logits(h_c, norm_weight, w, eps), lab_c,
                             label_smoothing, compute_acc, use_reentrant=False)
        else:
            out = checkpoint(_chunk_body, h_c, lab_c, norm_weight, w, eps, label_smoothing,
                             compute_acc, use_reentrant=False)
        nll_sum = nll_sum + out[0]
        n_valid = n_valid + out[1]
        n_correct = n_correct + out[2]
    return nll_sum, n_valid, n_correct


def fused_norm_head_nll_tokens(hidden, norm_weight, head_weight, labels, *, eps: float = 1e-5,
                               embed_grad_scale: float = 1.0, norm_head: bool = False,
                               label_smoothing: float = 0.0, chunk_size: int | None = None):
    """Eval-only per-token variant: (nll (B, S) fp32, correct (B, S) bool),
    without materialising the full logits.  As in the JAX function,
    ``embed_grad_scale`` is accepted and not applied (the mix is the identity
    in the forward)."""
    B, S, _ = hidden.shape
    w = _head_weight(head_weight, 1.0, norm_head)
    nlls, cors = [], []
    for h_c, lab_c in _chunks(hidden, labels, chunk_size):
        hn = rms_norm(h_c, norm_weight, eps=eps, out_dtype=h_c.dtype)
        logits = torch.nn.functional.linear(hn, w.to(hn.dtype)).float()
        valid = lab_c != -100
        safe = torch.where(valid, lab_c, torch.zeros_like(lab_c)).long()
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - torch.take_along_dim(logits, safe[:, None], dim=-1)[:, 0]
        if label_smoothing > 0.0:
            nll = (1 - label_smoothing) * nll + label_smoothing * (lse - logits.mean(dim=-1))
        nlls.append(torch.where(valid, nll, torch.zeros_like(nll)))
        cors.append((logits.argmax(dim=-1) == lab_c) & valid)
    return torch.cat(nlls).reshape(B, S), torch.cat(cors).reshape(B, S)
