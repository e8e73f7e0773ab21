"""INTERNLM2 model family, registry names "INTERNLM2" and "INTERNLM2_PUBLIC"
(port of ``internevo_tpu/models/internlm2.py``; reference
``modeling_internlm2.py:1012-1176``).

InternLM2: GQA with the per-kv-group fused wqkv packing (``models/base.py::
split_qkv``), no biases unless the config asks for them, the optional
baichuan2-style ``norm_head``.
"""

from __future__ import annotations

from ..utils.registry import MODEL_INITIALIZER
from .base import ModelDef, config_from_kwargs, make_model_def

# the JAX builder's defaults, which the config's keys override
DEFAULTS = dict(qkv_bias=False, o_bias=False, mlp_bias=False)


@MODEL_INITIALIZER.register_module("INTERNLM2")
def build_model_with_cfg(**kwargs) -> ModelDef:
    """Keys that are no ``ModelConfig`` field (``use_fp32_norm`` and the
    others the JAX builder pops) are dropped."""
    return make_model_def(config_from_kwargs(kwargs, DEFAULTS))


MODEL_INITIALIZER.register_module("INTERNLM2_PUBLIC")(build_model_with_cfg)
