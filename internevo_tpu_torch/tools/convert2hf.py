"""Export a checkpoint of the port to a HuggingFace model folder, the
counterpart of the root ``tools/convert2hf.py`` (reference
``transformers/convert2hf_internlm*.py``):

    python -m internevo_tpu_torch.tools.convert2hf --config configs/7B_sft.py \\
        --ckpt llm_ckpts/2000 --out hf_out [--format llama|internlm|internlm2] [--dtype float16]

It reads ``<ckpt>/arrays_model/params.pt`` on the host (no card, no random
init) and writes ``pytorch_model.bin`` and the ``config.json`` that JAX's
exporter writes (``tools/convert2hf.py:58-90``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..checkpoint import convert
from ..checkpoint.checkpoint_manager import MODEL_FOLDER, PARAMS_FILE
from ..core.config import Config
from ..initialize.launch import args_sanity_check
from ..train.pipeline import build_model

ARCHITECTURES = {"llama": "LlamaForCausalLM", "internlm": "InternLMForCausalLM",
                 "internlm2": "InternLM2ForCausalLM"}


def hf_config(cfg, fmt: str, dtype: str, sd: dict) -> dict:
    """The ``config.json`` JAX's exporter writes for ``cfg``."""
    out = {
        "architectures": [ARCHITECTURES[fmt]],
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.mlp_hidden,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_kv_attention_heads,
        "vocab_size": cfg.vocab_size,
        "rms_norm_eps": cfg.layer_norm_epsilon,
        "rope_theta": cfg.rope_base,
        "max_position_embeddings": cfg.max_position_embeddings,
        "torch_dtype": dtype,
        "model_type": fmt,
        "tie_word_embeddings": False,
    }
    if fmt == "internlm":
        out["bias"] = True  # HF InternLM1 carries qkv/o biases
    if fmt == "llama":
        # InternLM1-family exports carry qkv/o biases; HF llama takes them
        # behind attention_bias
        out["attention_bias"] = any(k.endswith("self_attn.q_proj.bias") for k in sd)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True, help="checkpoint folder of the port")
    parser.add_argument("--out", required=True)
    parser.add_argument("--format", default="llama", choices=sorted(ARCHITECTURES))
    parser.add_argument("--dtype", default="float16")
    args = parser.parse_args(argv)

    cfg = build_model(args_sanity_check(Config.from_file(args.config))).config
    params = torch.load(os.path.join(args.ckpt, MODEL_FOLDER, PARAMS_FILE), map_location="cpu", mmap=True,
                        weights_only=True)
    sd = {"llama": convert.to_hf_llama, "internlm": convert.to_hf_internlm,
          "internlm2": convert.to_hf_internlm2}[args.format](params, cfg)
    torch_dtype = getattr(torch, args.dtype)
    torch_sd = {k: v.to(torch_dtype) for k, v in sd.items()}
    os.makedirs(args.out, exist_ok=True)
    torch.save(torch_sd, os.path.join(args.out, "pytorch_model.bin"))
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(hf_config(cfg, args.format, args.dtype, sd), f, indent=2)
    print(f"wrote {args.out}/pytorch_model.bin + config.json ({len(torch_sd)} tensors)")


if __name__ == "__main__":
    main()
