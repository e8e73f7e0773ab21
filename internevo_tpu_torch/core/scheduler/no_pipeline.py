"""Non-pipeline schedule (port of ``internevo_tpu/core/scheduler/no_pipeline.py``):
the train step with gradient accumulation over micro-batches, and the eval
step.

An eval batch is a dict of (B, S) tensors: ``input_ids``, ``indexes`` (packed
positions), ``segment_ids`` and ``labels`` (-100 ignored); a train batch has
a leading micro axis, (micro_num, B, S).  Eval steps run under
``torch.inference_mode()``, without dropout; train steps under autograd.

A stochastic model draws JAX's stream: ``rng(seed, "dropout")`` folded by
the optimizer's count of applied steps, then by the micro-batch index
(``internevo_tpu/core/scheduler/no_pipeline.py:98-127``); the model folds in
the layer.  It is stochastic, as in JAX, with residual or attention dropout,
or as an MoE model whose gate needs noise: RTS, top-2 (the gumbel on the
second choice) or a noise policy.  Dropless routing reads no key, but the
step counts it as JAX does.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...core import random as jrandom
from ...models.base import ModelDef
from ...ops.cross_entropy import cross_entropy_loss
from ...ops.fused_ce import fused_norm_head_ce, fused_norm_head_nll_tokens
from ...solver.optimizer import AdamWConfig, GradScalerConfig, optimizer_step, tree_leaves, tree_map


def _micro_loss_and_metrics(model: ModelDef, params, micro, label_smoothing: float = 0.0,
                            moe_loss_coeff: float = 0.01, fused_ce: bool = True,
                            is_train: bool = True, chunk_size: int | None = None,
                            save_logits: bool = False, dropout_rng=None):
    """(loss, (ce_loss, n_valid, n_correct, moe_loss)): the fused
    norm+head+CE for RMSNorm models, logits + ``cross_entropy_loss``
    otherwise.  An MoE model returns ``(hidden or logits, {"moe": aux})``;
    the loss is then ce_loss + moe_loss_coeff * aux, and dense models have
    moe_loss 0.  ``dropout_rng`` is the micro-batch's key."""
    cfg = model.config
    moe_loss = torch.zeros((), dtype=torch.float32, device=micro["input_ids"].device)
    if fused_ce and cfg.norm_type == "rmsnorm":
        hidden = model.apply(params, micro["input_ids"], micro["indexes"], micro["segment_ids"],
                             dropout_rng=dropout_rng, train=is_train, return_hidden=True)
        if isinstance(hidden, tuple):
            hidden, aux = hidden
            moe_loss = aux.get("moe", moe_loss)
        nll_sum, n_valid, n_correct = fused_norm_head_ce(
            hidden, params["norm"], params["head"]["weight"], micro["labels"],
            eps=cfg.layer_norm_epsilon, embed_grad_scale=cfg.embed_grad_scale,
            norm_head=cfg.norm_head, label_smoothing=label_smoothing, chunk_size=chunk_size,
            save_logits=save_logits)
        ce_loss = nll_sum / n_valid.clamp_min(1)
        return ce_loss + moe_loss_coeff * moe_loss, (ce_loss, n_valid, n_correct, moe_loss)

    logits = model.apply(params, micro["input_ids"], micro["indexes"], micro["segment_ids"],
                         dropout_rng=dropout_rng, train=is_train)
    if isinstance(logits, tuple):
        logits, aux = logits
        moe_loss = aux.get("moe", moe_loss)
    flat_logits = logits.reshape(-1, logits.shape[-1])
    labels = micro["labels"].reshape(-1)
    ce_loss, n_valid = cross_entropy_loss(flat_logits, labels, label_smoothing=label_smoothing)
    n_correct = ((flat_logits.argmax(dim=-1) == labels) & (labels != -100)).sum()
    return ce_loss + moe_loss_coeff * moe_loss, (ce_loss, n_valid, n_correct, moe_loss)


def make_train_step(model: ModelDef, adam_cfg: AdamWConfig, scaler_cfg: GradScalerConfig,
                    label_smoothing: float = 0.0, moe_loss_coeff: float = 0.01, seed: int = 1024,
                    save_logits: bool = False, chunk_size: int | None = None) -> Callable:
    """``train_step(params, opt_state, batch, lr, beta2, step=None) ->
    (params, opt_state, metrics)`` (the JAX ``make_train_step``; reference
    ``no_pipeline_scheduler.py:28-239``).

    ``batch`` tensors are (micro_num, B, S); the loop runs over the leading
    micro axis.  Each micro-batch's loss is scaled by ``grad_scale /
    micro_num`` before its backward, and its bf16 ``.grad``s are added into
    fp32 accumulators and dropped, so one micro-batch's grads live at a time.
    Then one ``optimizer_step`` updates params and state in place.

    A stochastic step's stream folds the optimizer's count of applied steps
    (``opt_state["step"]``, which a skipped step does not advance), read
    from the device at the start of the step: one wait for the previous
    step a step.  A caller that already holds that count as a host int may
    pass it as ``step``.  ``save_logits`` and ``chunk_size`` are the fused
    CE's knobs (``ops/fused_ce.py::loss_knobs``)."""
    cfg = model.config
    # the MoE gate needs noise with RTS (top-1), the gumbel of the second
    # choice (top-2) or a noise policy (JAX no_pipeline.py:98-103)
    moe_stochastic = cfg.num_experts > 1 and (cfg.moe_use_rts or cfg.top_k >= 2
                                              or cfg.moe_noisy_gate_policy is not None)
    stochastic = cfg.drop_rate > 0.0 or cfg.attn_drop_rate > 0.0 or moe_stochastic
    base_rng = jrandom.rng(seed, "dropout") if stochastic else None

    def train_step(params, opt_state, batch, lr, beta2, step: int | None = None):
        micro_num = batch["input_ids"].shape[0]
        scale = opt_state["grad_scale"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        acc = tree_leaves(grads)
        zero = torch.zeros((), dtype=torch.float32, device=scale.device)
        loss_sum, moe_sum = zero, zero
        n_tokens = n_correct = torch.zeros((), dtype=torch.int64, device=scale.device)
        step_rng = None
        if stochastic:
            step_rng = jrandom.fold_in(base_rng, int(opt_state["step"]) if step is None else step)
        for i in range(micro_num):
            micro = {k: v[i] for k, v in batch.items()}
            loss, (ce_loss, n_valid, n_cor, moe_loss) = _micro_loss_and_metrics(
                model, params, micro, label_smoothing, moe_loss_coeff, chunk_size=chunk_size,
                save_logits=save_logits, dropout_rng=None if step_rng is None else jrandom.fold_in(step_rng, i))
            (loss * scale / micro_num).backward()
            with torch.no_grad():
                for a, p in zip(acc, leaves):
                    if p.grad is not None:
                        a.add_(p.grad)
                        p.grad = None
            loss_sum = loss_sum + ce_loss.detach()
            moe_sum = moe_sum + moe_loss.detach()
            n_tokens = n_tokens + n_valid
            n_correct = n_correct + n_cor
        params, opt_state, stats = optimizer_step(params, grads, opt_state, lr, beta2,
                                                  adam_cfg=adam_cfg, scaler_cfg=scaler_cfg)
        loss = loss_sum / micro_num
        metrics = {
            "loss": loss,
            "grad_norm": stats["grad_norm"],
            "grad_norm_groups": stats["grad_norm_groups"],
            "found_inf": stats["found_inf"],
            "loss_scale": stats["loss_scale"],
            "num_skipped": stats["num_skipped"],
            "n_tokens": n_tokens,
            "acc": n_correct / n_tokens.clamp_min(1),
            # perplexity from summed nll: loss is already the mean over tokens
            "perplexity": torch.exp(loss),
            "moe_loss": moe_sum / micro_num,
        }
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: ModelDef, label_smoothing: float = 0.0, per_token: bool = False,
                   chunk_size: int | None = None) -> Callable:
    """``eval_step(params, batch) -> dict`` (reference
    ``forward_backward_step(forward_only=True)``): loss, n_tokens, n_correct,
    and with ``per_token`` the per-token ``nll`` (B, S) fp32 and ``correct``
    (B, S) bool for per-dataset-type validation bins."""
    cfg = model.config

    @torch.inference_mode()
    def eval_step(params, batch):
        if not per_token:
            _, (ce_loss, n_valid, n_correct, _) = _micro_loss_and_metrics(
                model, params, batch, label_smoothing, is_train=False, chunk_size=chunk_size)
            return {"loss": ce_loss, "n_tokens": n_valid, "n_correct": n_correct}

        if cfg.num_experts <= 1 and cfg.norm_type == "rmsnorm":
            hidden = model.apply(params, batch["input_ids"], batch["indexes"],
                                 batch["segment_ids"], train=False, return_hidden=True)
            nll, cor = fused_norm_head_nll_tokens(
                hidden, params["norm"], params["head"]["weight"], batch["labels"],
                eps=cfg.layer_norm_epsilon, embed_grad_scale=cfg.embed_grad_scale,
                norm_head=cfg.norm_head, label_smoothing=label_smoothing, chunk_size=chunk_size)
        else:  # the JAX step's logits path, which MoE models take (no_pipeline.py:187-200)
            out = model.apply(params, batch["input_ids"], batch["indexes"], batch["segment_ids"], train=False)
            logits = (out[0] if isinstance(out, tuple) else out).float()
            lab = batch["labels"]
            valid = lab != -100
            safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
            lse = torch.logsumexp(logits, dim=-1)
            nll = lse - torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
            if label_smoothing > 0.0:
                nll = (1 - label_smoothing) * nll + label_smoothing * (lse - logits.mean(dim=-1))
            nll = torch.where(valid, nll, torch.zeros_like(nll))
            cor = (logits.argmax(dim=-1) == lab) & valid
        n_valid = (batch["labels"] != -100).sum()
        return {"loss": nll.sum() / n_valid.clamp_min(1), "n_tokens": n_valid,
                "n_correct": cor.sum(), "nll": nll, "correct": cor}

    return eval_step
