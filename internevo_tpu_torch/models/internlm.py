"""INTERNLM model family, registry name "INTERNLM" (port of
``internevo_tpu/models/internlm.py``; reference ``modeling_internlm.py:463-549``).

InternLM1: MHA, wqkv/out_proj bias, no mlp bias, scaled init on out_proj/w2.
"""

from __future__ import annotations

from ..utils.registry import MODEL_INITIALIZER
from .base import ModelDef, config_from_kwargs, make_model_def

MODEL_TYPE = "INTERNLM"


@MODEL_INITIALIZER.register_module(MODEL_TYPE)
def build_model_with_cfg(**kwargs) -> ModelDef:
    """Keys the port does not model are dropped or refused by
    ``config_from_kwargs``, as the JAX ``build_model_with_cfg`` drops keys it
    does not know."""
    return make_model_def(config_from_kwargs(kwargs, qkv_bias=True, o_bias=True, mlp_bias=False))
