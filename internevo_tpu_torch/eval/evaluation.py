"""Validation loop (port of ``internevo_tpu/eval/evaluation.py``; reference
``internlm/eval/evaluation.py:45-143``).

``evaluate_on_val_dls`` runs the engine's eval step (``make_eval_step``
with per-token statistics) over every validation loader and aggregates the
token-weighted loss, accuracy and perplexity, and, where the batches carry
type ids, the per-dataset-type ``AccPerplex`` bins, logging them and
writing them to the writer under JAX's keys (``val/<loader>/<metric>``).
The JAX function reads the launched config for the dataset types; this one
takes them, defaulting to the type map's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data.utils import get_dataset_type_ids_map
from ..models.metrics import AccPerplex
from ..solver.optimizer import tree_leaves
from ..utils.logger import get_logger

logger = get_logger(__name__)


def evaluate_on_val_dls(trainer, val_dls: dict, writer=None, step_count: int = 0, streaming: bool = False,
                        dataset_types: list | None = None, tokenizer=None) -> dict:
    """Returns ``{loader name: {"loss", "acc", "perplexity", "batches",
    "tokens", and the typed bins}}`` for every loader that held tokens."""
    trainer.eval()
    engine = trainer.engine
    device = tree_leaves(engine.params)[0].device
    if dataset_types is None:
        dataset_types = list(get_dataset_type_ids_map().keys())
    results = {}
    try:
        for val_name, val_dl in val_dls.items():
            if not streaming and len(val_dl) == 0:
                logger.info("no samples in %s, skip validation", val_name)
                continue
            total_loss, total_tokens, total_correct, n_batches = 0.0, 0, 0, 0
            acc_perplex = AccPerplex(tokenizer=tokenizer, dataset_types=dataset_types)
            has_types = False
            for data, labels in val_dl:
                batch = {k: torch.from_numpy(np.ascontiguousarray(data[k])).to(device=device, dtype=torch.int32)
                         for k in ("indexes", "segment_ids")}
                batch["input_ids"] = torch.from_numpy(np.ascontiguousarray(data["input_ids"])).to(
                    device=device, dtype=torch.int64)
                batch["labels"] = torch.from_numpy(np.ascontiguousarray(labels)).to(device=device,
                                                                                    dtype=torch.int64)
                out = engine.run_eval_step(batch)
                n_tok = int(out["n_tokens"])
                total_loss += float(out["loss"]) * n_tok
                total_tokens += n_tok
                total_correct += int(out["n_correct"])
                n_batches += 1
                if "nll" in out:
                    type_ids = data.get("type_ids")
                    has_types = has_types or type_ids is not None
                    acc_perplex.update_from_token_stats(out["nll"], out["correct"], labels, type_ids=type_ids)
            if total_tokens == 0:
                continue
            avg_loss = total_loss / total_tokens
            acc = total_correct / total_tokens
            ppl = math.exp(min(avg_loss, 80))
            typed = acc_perplex.get_metric() if has_types else {}
            typed = {k: v for k, v in typed.items() if "/" in k or k == "BPB"}  # per-type bins + BPB only
            extra = "".join(f" {k}={v}" for k, v in sorted(typed.items()))
            logger.info("validation on %s: step=%d loss=%.5f acc=%.4f perplexity=%.3f (%d batches)%s",
                        val_name, step_count, avg_loss, acc, ppl, n_batches, extra)
            if writer is not None:
                writer.add_scalar(f"val/{val_name}/loss", avg_loss, step_count)
                writer.add_scalar(f"val/{val_name}/acc", acc, step_count)
                writer.add_scalar(f"val/{val_name}/perplexity", ppl, step_count)
                for k, v in typed.items():
                    writer.add_scalar(f"val/{val_name}/{k}", v, step_count)
            results[val_name] = {"loss": avg_loss, "acc": acc, "perplexity": ppl, "batches": n_batches,
                                 "tokens": total_tokens, **typed}
    finally:
        trainer.train()
    return results
