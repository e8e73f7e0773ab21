"""LLAMA2 model family, registry name "LLAMA2" (port of
``internevo_tpu/models/llama2.py``; reference ``modeling_llama.py``).

An HF-Llama-compatible GQA transformer: rmsnorm, SwiGLU, no biases unless
the config asks for them.  The reference keeps wq, wk and wv apart; the JAX
package and the port keep the fused per-kv-group wqkv and convert at
checkpoint import and export.
"""

from __future__ import annotations

from ..utils.registry import MODEL_INITIALIZER
from .base import ModelDef, config_from_kwargs, make_model_def
from .internlm2 import DEFAULTS

MODEL_TYPE = "LLAMA2"


@MODEL_INITIALIZER.register_module(MODEL_TYPE)
def build_model_with_cfg(**kwargs) -> ModelDef:
    """Keys that are no ``ModelConfig`` field are dropped."""
    return make_model_def(config_from_kwargs(kwargs, DEFAULTS))
