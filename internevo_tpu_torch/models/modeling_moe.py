"""INTERNLM_MoE model family, registry name "INTERNLM_MoE" (port of
``internevo_tpu/models/modeling_moe.py``; reference ``modeling_moe.py``).

InternLM blocks whose FFN is a mixture of SwiGLU experts, with the optional
residual-MoE branch (a dense MLP mixed in by a learned 2-way coefficient,
reference ``moe/moe.py:66-99``).  The apply function returns ``(logits or
hidden, {"moe": l_aux summed over the layers})``; the train step adds
``moe_loss_coeff * moe`` to the CE loss.

Routing as the JAX model's (``modeling_moe.py:110-146``): dropless
(``models/moe/dropless.py``, the grouped-matmul kernels) for ``moe_type``
"Dropless", "MegaBlock-D" or "MegaBlock", or ``moe_drop_tokens`` false;
otherwise GShard capacity routing (``models/moe/gshard.py``) with the train
or eval capacity factor, RTS and, in training, the noise policy.  The GShard
gate draws its noise from the layer's key, ``fold_in(dropout_rng, i)``, the
key dropout uses, which the layer gets in training whatever the dropout
rates.

Layer params: the dense block's (``models/base.py``, without w1/w2/w3 when
every FFN is experts) and ``layer["moe"]`` in the JAX layout, unstacked:
``gate`` (H, E) fp32, ``experts`` w1/w3 (E, H, M) and w2 (E, M, H), and with
the residual branch ``coefficient`` (H, 2) and ``coefficient_bias`` (2,).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..utils.registry import MODEL_INITIALIZER
from ..core import random as jrandom
from .base import (ModelConfig, ModelDef, _dense, _normal, block_forward, config_from_kwargs, embed_tokens,
                   head_logits, init_params, layer_plan, run_layer)
from .moe.dropless import dropless_moe_apply
from .moe.gshard import moe_layer_apply

MODEL_TYPE = "INTERNLM_MoE"
DROPLESS_TYPES = ("dropless", "megablock-d", "megablock")


def is_dropless(cfg: ModelConfig) -> bool:
    """The JAX model's routing choice (``modeling_moe.py:116-117``)."""
    return cfg.moe_type.lower() in DROPLESS_TYPES or not cfg.moe_drop_tokens


def init_moe_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """The dense init, and each layer's gate and expert stacks drawn like the
    JAX ``init_moe_params`` (``modeling_moe.py:40-71``): gate N(0, 0.006) in
    fp32, w1/w3 N(0, ffn_uplayer_init_std), w2 N(0, 0.006 / sqrt(2 (i + 1)))
    with scaled init, the rest in the model dtype."""
    residual = cfg.num_shared_experts > 0
    params = init_params(cfg, generator, device, mlp=residual)
    H, M, E = cfg.hidden_size, cfg.mlp_hidden, cfg.num_experts
    draw = lambda shape, std: _normal(shape, std, generator, device).to(cfg.dtype)  # noqa: E731
    for i, layer in enumerate(params["blocks"]):
        w2_std = 0.006 / math.sqrt(2.0 * (i + 1)) if cfg.use_scaled_init else cfg.ffn_other_init_std
        moe = {
            "gate": _normal((H, E), 0.006, generator, device),
            "experts": {"w1": draw((E, H, M), cfg.ffn_uplayer_init_std),
                        "w3": draw((E, H, M), cfg.ffn_uplayer_init_std),
                        "w2": draw((E, M, H), w2_std)},
        }
        if residual:  # reference moe/moe.py:73 `torch.nn.Linear(hidden_size, 2)`, with bias
            moe["coefficient"] = draw((H, 2), 0.006)
            moe["coefficient_bias"] = torch.zeros(2, dtype=cfg.dtype, device=device)
        layer["moe"] = moe
    return params


def _residual_branch(cfg: ModelConfig, layer: dict, h, out):
    """The residual-MoE mix (``modeling_moe.py:149-159``): the dense SwiGLU
    and the experts' output weighted by a softmax over two coefficients."""
    if cfg.num_shared_experts == 0:
        return out
    dense = _dense(h, layer["w1"]["weight"])
    w3o = _dense(h, layer["w3"]["weight"])
    dense_out = _dense(F.silu(dense) * w3o, layer["w2"]["weight"])
    moe = layer["moe"]
    coef_logits = h @ moe["coefficient"].to(h.dtype)
    if "coefficient_bias" in moe:
        coef_logits = coef_logits + moe["coefficient_bias"].to(coef_logits.dtype)
    coef = torch.softmax(coef_logits.float(), dim=-1)
    return out * coef[..., 0:1].to(out.dtype) + dense_out * coef[..., 1:].to(out.dtype)


def moe_ffn(cfg: ModelConfig, layer: dict, h, grouped_dot: Optional[Callable] = None,
            key: Optional[jrandom.Key] = None, train: bool = False):
    """The MoE FFN of one block: (out, l_aux).  Dropless routing draws
    nothing, and ``grouped_dot`` replaces its grouped matmul (a check holds
    the kernels against the plain path); GShard routing draws the gate's
    noise from the layer's ``key`` when ``train``."""
    if is_dropless(cfg):
        out, l_aux, _ = dropless_moe_apply(layer["moe"], h, top_k=cfg.top_k, grouped_dot=grouped_dot)
    else:
        if grouped_dot is not None:
            raise ValueError("GShard routing runs no grouped matmul to replace")
        out, l_aux, _ = moe_layer_apply(
            layer["moe"], h, top_k=cfg.top_k,
            capacity_factor=cfg.moe_capacity_factor if train else cfg.moe_eval_capacity_factor,
            min_capacity=cfg.moe_min_capacity, drop_tokens=True, use_rts=cfg.moe_use_rts,
            noisy_gate_policy=cfg.moe_noisy_gate_policy if train else None, rng=key, train=train)
    return _residual_branch(cfg, layer, h, out), l_aux


def moe_model_forward(cfg: ModelConfig, params: dict, input_ids, positions, segment_ids,
                      dropout_rng: Optional[jrandom.Key] = None, train: bool = False,
                      block_fn: Optional[Callable] = None, return_hidden: bool = False):
    """Forward over the layer stack: (logits, {"moe": Σ l_aux}), or the
    pre-final-norm hidden states in place of the logits with
    ``return_hidden``.  The aux losses are summed over the layers, not
    averaged (``modeling_moe.py:208-209``).  Dropout and recompute as the
    dense stack's (``models/base.py::layer_plan``), except that the number of
    recomputed layers rounds (``modeling_moe.py:178``).  In training a
    GShard layer gets its key for the gate's noise; dropless routing draws
    nothing from it.  ``block_fn(layer, x, key) -> (x, l_aux)`` replaces the
    block body."""
    if block_fn is None:
        def block_fn(layer, h, key):
            return block_forward(cfg, layer, h, positions, segment_ids, key, train,
                                 ffn=lambda hh: moe_ffn(cfg, layer, hh, key=key, train=train))
    x = embed_tokens(cfg, params, input_ids)
    if cfg.residual_in_fp32:
        x = x.float()
    moe_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, key, policy in layer_plan(cfg, params["blocks"], dropout_rng, train, moe=True,
                                         keyed=not is_dropless(cfg)):
        x, l_aux = run_layer(block_fn, layer, key, policy, x)
        moe_loss = moe_loss + l_aux
    if return_hidden:
        return x, {"moe": moe_loss}
    return head_logits(cfg, params, x), {"moe": moe_loss}


@MODEL_INITIALIZER.register_module(MODEL_TYPE)
def build_model_with_cfg(**kwargs) -> ModelDef:
    """The JAX ``build_model_with_cfg`` (``modeling_moe.py:217-238``):
    ``moe_gate_k`` is the routing top-k and ``moe_use_residual`` turns on the
    residual branch; keys the port does not model are dropped by
    ``config_from_kwargs``."""
    gate_k = kwargs.pop("moe_gate_k", None)
    if gate_k is not None:
        kwargs.setdefault("top_k", gate_k)
    if kwargs.pop("moe_use_residual", False):
        kwargs.setdefault("num_shared_experts", 1)
    cfg = config_from_kwargs(kwargs, qkv_bias=True, o_bias=True, mlp_bias=False)
    if cfg.num_experts <= 1:
        raise ValueError("INTERNLM_MoE requires model.num_experts > 1")
    return ModelDef(config=cfg, init=partial(init_moe_params, cfg), apply=partial(moe_model_forward, cfg))
