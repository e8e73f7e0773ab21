"""Model zoo: importing this package registers the model families."""

from . import internlm, internlm2, llama2, modeling_moe  # noqa: F401
from .base import ModelConfig, ModelDef

__all__ = ["ModelConfig", "ModelDef"]
