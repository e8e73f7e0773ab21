"""HuggingFace and Meta checkpoint converters (port of
``internevo_tpu/checkpoint/convert.py``; reference
``transformers/convert2hf_internlm*.py``, ``revert_internlm*.py`` and the
external loaders of ``internlm/checkpoint/load_funcs.py:16-192``).

They act on the port's param tree (``models/jax_bridge.py::params_from_jax``'s
layout): a list of per-layer dicts whose linear weights are already in
torch's (out, in) layout, so no transpose is needed; the fused ``wqkv``
keeps the per-kv-group packed layout of ``models/base.py::split_qkv``, which
``split_wqkv`` and ``merge_wqkv`` unpack and pack.  The rotary convention is
HF llama's rotate_half, so no permutation either.  The exporters return fp32
tensors on the host, as JAX's return fp32 arrays; the importers return JAX's
dtypes (norms fp32, the rest in the model dtype), and a loader casts each
leaf to the live tree's.

The external loaders read an HF folder without ``transformers`` or
``safetensors``: ``pytorch_model.bin``, the shards an ``*.index.json``
names, or ``model.safetensors``, parsed here (an 8-byte header length, a
JSON header, raw little-endian buffers).
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from ..models.base import ModelConfig
from .checkpoint_manager import assign_tree, register_load_func, reload_zero_fp32_buff


def _f32(x) -> torch.Tensor:
    """A host fp32 copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def split_wqkv(cfg: ModelConfig, wqkv: torch.Tensor):
    """((q_per_kv + 2) * Hkv * D, ...) grouped rows -> q (Hq * D, ...), k, v
    (Hkv * D, ...): a weight (out, in) or a bias (out,)."""
    D, Hkv, qpk = cfg.head_dim, cfg.num_kv_attention_heads, cfg.q_per_kv
    rest = wqkv.shape[1:]
    grouped = wqkv.reshape(Hkv, (qpk + 2) * D, *rest)
    q = grouped[:, : qpk * D].reshape(Hkv * qpk * D, *rest)
    k = grouped[:, qpk * D: (qpk + 1) * D].reshape(Hkv * D, *rest)
    v = grouped[:, (qpk + 1) * D:].reshape(Hkv * D, *rest)
    return q, k, v


def merge_wqkv(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of ``split_wqkv``."""
    D, Hkv, qpk = cfg.head_dim, cfg.num_kv_attention_heads, cfg.q_per_kv
    rest = q.shape[1:]
    grouped = torch.cat([q.reshape(Hkv, qpk * D, *rest), k.reshape(Hkv, D, *rest), v.reshape(Hkv, D, *rest)],
                        dim=1)
    return grouped.reshape(Hkv * (qpk + 2) * D, *rest)


def to_hf_llama(params: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's tree -> HF LlamaForCausalLM state dict (fp32, host)."""
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": _f32(params["embedding"]["weight"]),
        "model.norm.weight": _f32(params["norm"]),
        "lm_head.weight": _f32(params["head"]["weight"]),
    }
    for i, layer in enumerate(params["blocks"]):
        pre = f"model.layers.{i}"
        q, k, v = split_wqkv(cfg, _f32(layer["wqkv"]["weight"]))
        sd[f"{pre}.self_attn.q_proj.weight"] = q.contiguous()
        sd[f"{pre}.self_attn.k_proj.weight"] = k.contiguous()
        sd[f"{pre}.self_attn.v_proj.weight"] = v.contiguous()
        sd[f"{pre}.self_attn.o_proj.weight"] = _f32(layer["out_proj"]["weight"])
        sd[f"{pre}.mlp.gate_proj.weight"] = _f32(layer["w1"]["weight"])
        sd[f"{pre}.mlp.up_proj.weight"] = _f32(layer["w3"]["weight"])
        sd[f"{pre}.mlp.down_proj.weight"] = _f32(layer["w2"]["weight"])
        sd[f"{pre}.input_layernorm.weight"] = _f32(layer["norm1"])
        sd[f"{pre}.post_attention_layernorm.weight"] = _f32(layer["norm2"])
        if "bias" in layer["wqkv"]:
            bq, bk, bv = split_wqkv(cfg, _f32(layer["wqkv"]["bias"]))
            sd[f"{pre}.self_attn.q_proj.bias"] = bq.contiguous()
            sd[f"{pre}.self_attn.k_proj.bias"] = bk.contiguous()
            sd[f"{pre}.self_attn.v_proj.bias"] = bv.contiguous()
        if "bias" in layer["out_proj"]:
            sd[f"{pre}.self_attn.o_proj.bias"] = _f32(layer["out_proj"]["bias"])
    return sd


def _tree(embedding, layers, norm, head, dtype) -> dict:
    """The port's tree from fp32 pieces, in JAX's importer dtypes: norms
    fp32, everything else ``dtype``."""

    def cast(layer):
        return {k: (v.float() if k.startswith("norm") else v.to(dtype)) if isinstance(v, torch.Tensor)
                else {kk: vv.to(dtype) for kk, vv in v.items()} for k, v in layer.items()}

    return {"embedding": {"weight": embedding.to(dtype)}, "blocks": [cast(layer) for layer in layers],
            "norm": norm.float(), "head": {"weight": head.to(dtype)}}


def from_hf_llama(sd: Dict, cfg: ModelConfig, dtype=None) -> dict:
    """HF LlamaForCausalLM state dict -> the port's tree (reference
    ``load_hf_llama_pretrained_weights``, ``load_funcs.py:73``)."""
    dtype = dtype or cfg.dtype
    get = lambda k: _f32(sd[k])  # noqa: E731
    has_qkv_bias = "model.layers.0.self_attn.q_proj.bias" in sd
    has_o_bias = "model.layers.0.self_attn.o_proj.bias" in sd
    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        proj = lambda name, kind="weight": get(f"{pre}.self_attn.{name}_proj.{kind}")  # noqa: E731
        layer = {
            "norm1": get(f"{pre}.input_layernorm.weight"),
            "norm2": get(f"{pre}.post_attention_layernorm.weight"),
            "wqkv": {"weight": merge_wqkv(cfg, proj("q"), proj("k"), proj("v"))},
            "out_proj": {"weight": proj("o")},
            "w1": {"weight": get(f"{pre}.mlp.gate_proj.weight")},
            "w3": {"weight": get(f"{pre}.mlp.up_proj.weight")},
            "w2": {"weight": get(f"{pre}.mlp.down_proj.weight")},
        }
        if has_qkv_bias:
            layer["wqkv"]["bias"] = merge_wqkv(cfg, proj("q", "bias"), proj("k", "bias"), proj("v", "bias"))
        if has_o_bias:
            layer["out_proj"]["bias"] = proj("o", "bias")
        layers.append(layer)
    return _tree(get("model.embed_tokens.weight"), layers, get("model.norm.weight"), get("lm_head.weight"),
                 dtype)


def to_hf_internlm2(params: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's tree -> HF InternLM2 naming, the fused wqkv kept fused
    (reference ``convert2hf_internlm2.py:218``)."""
    sd: Dict[str, torch.Tensor] = {
        "model.tok_embeddings.weight": _f32(params["embedding"]["weight"]),
        "model.norm.weight": _f32(params["norm"]),
        "output.weight": _f32(params["head"]["weight"]),
    }
    for i, layer in enumerate(params["blocks"]):
        pre = f"model.layers.{i}"
        sd[f"{pre}.attention.wqkv.weight"] = _f32(layer["wqkv"]["weight"])
        sd[f"{pre}.attention.wo.weight"] = _f32(layer["out_proj"]["weight"])
        sd[f"{pre}.feed_forward.w1.weight"] = _f32(layer["w1"]["weight"])
        sd[f"{pre}.feed_forward.w3.weight"] = _f32(layer["w3"]["weight"])
        sd[f"{pre}.feed_forward.w2.weight"] = _f32(layer["w2"]["weight"])
        sd[f"{pre}.attention_norm.weight"] = _f32(layer["norm1"])
        sd[f"{pre}.ffn_norm.weight"] = _f32(layer["norm2"])
    return sd


def from_hf_internlm2(sd: Dict, cfg: ModelConfig, dtype=None) -> dict:
    dtype = dtype or cfg.dtype
    get = lambda k: _f32(sd[k])  # noqa: E731
    layers = [{
        "norm1": get(f"model.layers.{i}.attention_norm.weight"),
        "norm2": get(f"model.layers.{i}.ffn_norm.weight"),
        "wqkv": {"weight": get(f"model.layers.{i}.attention.wqkv.weight")},
        "out_proj": {"weight": get(f"model.layers.{i}.attention.wo.weight")},
        "w1": {"weight": get(f"model.layers.{i}.feed_forward.w1.weight")},
        "w3": {"weight": get(f"model.layers.{i}.feed_forward.w3.weight")},
        "w2": {"weight": get(f"model.layers.{i}.feed_forward.w2.weight")},
    } for i in range(cfg.num_layers)]
    return _tree(get("model.tok_embeddings.weight"), layers, get("model.norm.weight"), get("output.weight"), dtype)


def to_hf_internlm(params: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's INTERNLM(1) tree -> HF InternLMForCausalLM: llama's key
    names with the qkv and o biases (reference
    ``transformers/convert2hf_internlm.py:141-190``), so ``to_hf_llama``'s
    mapping, which carries the biases."""
    return to_hf_llama(params, cfg)


def from_hf_internlm(sd: Dict, cfg: ModelConfig, dtype=None) -> dict:
    """HF InternLMForCausalLM -> the port's tree (llama's key space)."""
    return from_hf_llama(sd, cfg, dtype=dtype)


# -------------------------------------------------------- Meta-llama (pth) IO


# Meta/InternEvo-native llama naming (reference load_llama_pretrained_weights,
# checkpoint/load_funcs.py:16-70): tensor-parallel shards concatenate column
# weights (wq/wk/wv/w1/w3/output) on dim 0 and row weights (wo/w2) on dim 1;
# tok_embeddings splits the hidden dim (dim 1).
_META_DIM0 = ("attention.wq", "attention.wk", "attention.wv", "feed_forward.w1", "feed_forward.w3", "output")
_META_DIM1 = ("attention.wo", "feed_forward.w2", "tok_embeddings")


def merge_meta_llama_shards(shards: list) -> Dict[str, torch.Tensor]:
    """Merge tensor-parallel Meta-llama state dicts (ordered by tp rank)."""
    if len(shards) == 1:
        return dict(shards[0])
    merged: Dict[str, torch.Tensor] = {}
    for key in shards[0]:
        parts = [torch.as_tensor(s[key]) for s in shards]
        if any(m in key for m in _META_DIM0):
            merged[key] = torch.cat(parts, dim=0)
        elif any(m in key for m in _META_DIM1):
            merged[key] = torch.cat(parts, dim=1)
        else:  # norms: replicated
            merged[key] = parts[0]
    return merged


def from_meta_llama(sd: Dict, cfg: ModelConfig, dtype=None) -> dict:
    """Meta/InternEvo-native llama state dict -> the port's tree (reference
    ``load_llama_pretrained_weights``, ``load_funcs.py:16-70``)."""
    dtype = dtype or cfg.dtype
    get = lambda k: _f32(sd[k])  # noqa: E731
    layers = []
    for i in range(cfg.num_layers):
        pre = f"layers.{i}"
        att = lambda name: get(f"{pre}.attention.{name}.weight")  # noqa: E731
        layers.append({
            "norm1": get(f"{pre}.attention_norm.weight"),
            "norm2": get(f"{pre}.ffn_norm.weight"),
            "wqkv": {"weight": merge_wqkv(cfg, att("wq"), att("wk"), att("wv"))},
            "out_proj": {"weight": att("wo")},
            "w1": {"weight": get(f"{pre}.feed_forward.w1.weight")},
            "w3": {"weight": get(f"{pre}.feed_forward.w3.weight")},
            "w2": {"weight": get(f"{pre}.feed_forward.w2.weight")},
        })
    return _tree(get("tok_embeddings.weight"), layers, get("norm.weight"), get("output.weight"), dtype)


def to_meta_llama(params: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's tree -> Meta/InternEvo-native llama state dict (inverse of
    ``from_meta_llama``)."""
    sd: Dict[str, torch.Tensor] = {
        "tok_embeddings.weight": _f32(params["embedding"]["weight"]),
        "norm.weight": _f32(params["norm"]),
        "output.weight": _f32(params["head"]["weight"]),
    }
    for i, layer in enumerate(params["blocks"]):
        pre = f"layers.{i}"
        q, k, v = split_wqkv(cfg, _f32(layer["wqkv"]["weight"]))
        sd[f"{pre}.attention.wq.weight"] = q.contiguous()
        sd[f"{pre}.attention.wk.weight"] = k.contiguous()
        sd[f"{pre}.attention.wv.weight"] = v.contiguous()
        sd[f"{pre}.attention.wo.weight"] = _f32(layer["out_proj"]["weight"])
        sd[f"{pre}.feed_forward.w1.weight"] = _f32(layer["w1"]["weight"])
        sd[f"{pre}.feed_forward.w3.weight"] = _f32(layer["w3"]["weight"])
        sd[f"{pre}.feed_forward.w2.weight"] = _f32(layer["w2"]["weight"])
        sd[f"{pre}.attention_norm.weight"] = _f32(layer["norm1"])
        sd[f"{pre}.ffn_norm.weight"] = _f32(layer["norm2"])
    return sd


# -------------------------------------------------------- HF folder reading


_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                       "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
                       "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors: an 8-byte little-endian header
    length, a JSON header of {name: dtype, shape, data_offsets}, then the
    raw little-endian buffers."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dtype, shape = _SAFETENSORS_DTYPES[info["dtype"]], info["shape"]
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(data, dtype=dtype, count=(end - start) // dtype.itemsize,
                                         offset=start).reshape(shape)
    return out


def _read_weight_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_hf_state_dict(folder: str) -> Dict[str, torch.Tensor]:
    """An HF model folder's weights: the shards an ``*.index.json`` names,
    else ``pytorch_model.bin``, else ``model.safetensors``."""
    indexes = sorted(glob.glob(os.path.join(folder, "*.index.json")))
    if indexes:
        with open(indexes[0]) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        files = [os.path.join(folder, s) for s in shards]
    else:
        files = [p for p in (os.path.join(folder, "pytorch_model.bin"), os.path.join(folder, "model.safetensors"))
                 if os.path.exists(p)][:1]
    if not files:
        raise FileNotFoundError(f"no pytorch_model.bin, model.safetensors or *.index.json in {folder}")
    sd: Dict[str, torch.Tensor] = {}
    for fp in files:
        sd.update(_read_weight_file(fp))
    return sd


# ------------------------------------------------------------- load_funcs glue


def try_load_hf_llama_ckpt(engine, train_state, ckpt_path: str, load_mask):
    """ckpt_type='hf_llama' (reference ``load_funcs.py:73``): an HF llama
    folder into the engine's params, the optimizer restarted from them."""
    params = from_hf_llama(read_hf_state_dict(ckpt_path), engine.model.config)
    assign_tree(engine.params, params, "hf_llama", cast=True)
    reload_zero_fp32_buff(engine)
    return True


def try_load_meta_llama_ckpt(engine, train_state, ckpt_path: str, load_mask):
    """ckpt_type='llama' (reference ``load_funcs.py:16-70``): a folder of
    Meta/InternEvo-native llama weights, either tensor-parallel
    ``model_tp{i}_*.pt`` shards (merged here) or ``*.pth``/``*.pt`` files
    (Meta's ``consolidated.NN.pth``)."""
    fns = sorted(f for f in glob.glob(os.path.join(ckpt_path, "model_t*")) if not f.endswith("md5"))
    if not fns:
        fns = sorted(glob.glob(os.path.join(ckpt_path, "*.pth")) + glob.glob(os.path.join(ckpt_path, "*.pt")))
    if not fns:
        raise FileNotFoundError(f"no Meta-llama checkpoint files in {ckpt_path}")
    shards = [{k: v for k, v in torch.load(fn, map_location="cpu", weights_only=True).items()
               if not k.endswith(".inv_freq")} for fn in fns]
    params = from_meta_llama(merge_meta_llama_shards(shards), engine.model.config)
    assign_tree(engine.params, params, "llama", cast=True)
    reload_zero_fp32_buff(engine)
    return True


register_load_func("hf_llama", try_load_hf_llama_ckpt)
register_load_func("llama", try_load_meta_llama_ckpt)
