"""Sequence generation with a kv-cache (port of ``internevo_tpu/apis/inference.py``:
greedy and sampling; beam search comes later).

Prefill is one ``model_decode_step`` over the prompt; decoding is a Python
loop of one-token steps with the JAX loop's early exit once every row has
emitted an eos, and without the last step's forward, whose logits nobody
reads.  Sampling draws from a ``torch.Generator`` seeded by ``seed``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..accelerator import get_device
from ..models.base import ModelConfig, _dense, _norm, split_qkv
from ..ops.rotary import apply_rotary, dynamic_ntk_frequencies, rope_frequencies


@dataclasses.dataclass
class InferenceParams:
    """kv-cache container (reference ``inference.py:13``)."""

    max_sequence_len: int
    max_batch_size: int
    sequence_len_offset: int = 0
    key_value_memory_dict: dict = dataclasses.field(default_factory=dict)


def init_kv_cache(cfg: ModelConfig, batch_size: int, max_len: int, device="cuda") -> dict:
    """Zeroed k/v caches on ``device``: the card unless the caller asks for the
    CPU; a CUDA request without a card raises."""
    device = get_device(device)
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_attention_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _cached_attention(cfg: ModelConfig, q, k_cache, v_cache, cache_len: int):
    """q: (B, T, Hq, D); caches: (B, maxS, Hkv, D); positions < cache_len valid."""
    B, T, Hq, D = q.shape
    n_rep = Hq // k_cache.shape[2]
    maxS = k_cache.shape[1]
    k = k_cache.repeat_interleave(n_rep, dim=2) if n_rep > 1 else k_cache
    v = v_cache.repeat_interleave(n_rep, dim=2) if n_rep > 1 else v_cache
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    kv_pos = torch.arange(maxS, device=q.device)[None, None, None, :]
    q_pos = (cache_len - T) + torch.arange(T, device=q.device)[None, None, :, None]
    logits = torch.where(kv_pos <= q_pos, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).to(q.dtype)


def model_decode_step(cfg: ModelConfig, params: dict, input_ids, kv_cache: dict, cache_index: int):
    """Forward T tokens, writing their k/v into ``kv_cache`` in place at
    ``cache_index``.  Returns (logits (B, T, V) fp32, kv_cache).  Prefill
    passes the prompt (T = its length), decode one token."""
    B, T = input_ids.shape
    positions = cache_index + torch.arange(T, device=input_ids.device)[None, :]
    x = F.embedding(input_ids, params["embedding"]["weight"]).to(cfg.dtype)
    if cfg.use_dynamic_ntk_rope:
        cos, sin = dynamic_ntk_frequencies(positions, cfg.head_dim, cfg.rope_base,
                                           cfg.max_position_embeddings, seq_len=cache_index + T)
    else:
        cos, sin = rope_frequencies(positions, cfg.head_dim, base=cfg.rope_base)

    h = x
    for lidx, layer in enumerate(params["blocks"]):
        residual = h
        hn = _norm(cfg, residual, layer["norm1"], layer.get("norm1_bias"))
        q, k, v = split_qkv(cfg, _dense(hn, layer["wqkv"]["weight"], layer["wqkv"].get("bias")))
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        kv_cache["k"][lidx, :, cache_index:cache_index + T] = k
        kv_cache["v"][lidx, :, cache_index:cache_index + T] = v
        ctx = _cached_attention(cfg, q, kv_cache["k"][lidx], kv_cache["v"][lidx], cache_index + T)
        attn_out = _dense(ctx.reshape(B, T, -1), layer["out_proj"]["weight"],
                          layer["out_proj"].get("bias"))
        residual = attn_out + residual
        hn = _norm(cfg, residual, layer["norm2"], layer.get("norm2_bias"))
        w1o = _dense(hn, layer["w1"]["weight"], layer["w1"].get("bias"))
        w3o = _dense(hn, layer["w3"]["weight"], layer["w3"].get("bias"))
        mlp_out = _dense(F.silu(w1o) * w3o, layer["w2"]["weight"], layer["w2"].get("bias"))
        h = (mlp_out + residual).to(cfg.dtype)

    h = _norm(cfg, h, params["norm"], params.get("norm_bias"))
    w = params["head"]["weight"]
    if cfg.norm_head:
        norm = torch.linalg.vector_norm(w.float(), dim=1, keepdim=True)
        w = (w / (norm + 1e-7)).to(w.dtype)
    return F.linear(h, w.to(h.dtype)).float(), kv_cache


def top_k_top_p_filtering(logits, top_k: int = 0, top_p: float = 1.0,
                          filter_value: float = -float("inf")):
    """Reference ``inference.py:925`` semantics."""
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, torch.full_like(logits, filter_value), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cutoff_mask = probs.cumsum(dim=-1) - probs > top_p  # keep until cum prob exceeds top_p
        threshold = torch.where(cutoff_mask, torch.full_like(sorted_logits, math.inf),
                                sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, torch.full_like(logits, filter_value), logits)
    return logits


class SequenceGenerator:
    """Greedy / sampling generation (reference ``inference.py:66``)."""

    def __init__(self, decoder, tokenizer=None, bos_token_id: int = 1, pad_token_id: int = 0,
                 eos_token_id: int = 2, additional_eos_token_list=None):
        """``decoder``: a (ModelDef, params) pair, or an object with .model/.params."""
        if isinstance(decoder, tuple):
            self.model, self.params = decoder
        else:
            self.model, self.params = decoder.model, decoder.params
        self.cfg: ModelConfig = self.model.config
        self.bos_token_id = bos_token_id
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.additional_eos = set(additional_eos_token_list or [])
        self.device = self.params["embedding"]["weight"].device

    @torch.inference_mode()
    def generate(self, tokens=None, num_return_sequences: int = 1, max_length: int = 64,
                 do_sample: bool = False, temperature: float = 1.0, top_k: int = 50,
                 top_p: float = 1.0, repetition_penalty: float = 1.0,
                 length_penalty: float = 1.0, seed: int = 0) -> torch.Tensor:
        """Returns (B * num_return_sequences, n) int64 tokens, prompt included;
        n stops at ``max_length`` or once every row has emitted an eos."""
        cfg, dev = self.cfg, self.device
        if tokens is None:
            tokens = torch.full((1, 1), self.bos_token_id, dtype=torch.int64)
        tokens = torch.as_tensor(tokens, dtype=torch.int64).to(dev)
        if num_return_sequences > 1:
            tokens = tokens.repeat_interleave(num_return_sequences, dim=0)
        B, prompt_len = tokens.shape

        kv_cache = init_kv_cache(cfg, B, max_length, dev)
        logits, kv_cache = model_decode_step(cfg, self.params, tokens, kv_cache, 0)
        lg = logits[:, -1, :]
        out = torch.full((B, max_length), self.pad_token_id, dtype=torch.int64, device=dev)
        out[:, :prompt_len] = tokens
        seen = torch.zeros(B, lg.shape[-1], dtype=torch.bool, device=dev)
        seen.scatter_(1, tokens, True)
        eos = torch.tensor(sorted({self.eos_token_id} | self.additional_eos), device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows = torch.arange(B, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)

        cur = prompt_len
        while cur < max_length and not bool(finished.all()):
            step_logits = lg / max(temperature, 1e-6)
            if repetition_penalty != 1.0:
                step_logits = torch.where(
                    seen, torch.where(step_logits > 0, step_logits / repetition_penalty,
                                      step_logits * repetition_penalty), step_logits)
            if do_sample:
                step_logits = top_k_top_p_filtering(step_logits, top_k=top_k, top_p=top_p)
                tok = torch.multinomial(torch.softmax(step_logits, dim=-1), 1, generator=gen)[:, 0]
            else:
                tok = step_logits.argmax(dim=-1)
            tok = torch.where(finished, torch.full_like(tok, self.pad_token_id), tok)
            out[:, cur] = tok
            if repetition_penalty != 1.0:
                seen[rows, tok] = True
            finished = finished | torch.isin(tok, eos)
            if cur + 1 < max_length and not bool(finished.all()):
                logits, kv_cache = model_decode_step(cfg, self.params, tok[:, None], kv_cache, cur)
                lg = logits[:, -1, :]
            cur += 1
        return out[:, :cur]

    def greedy_generate(self, tokens, **kw):
        kw.pop("do_sample", None)
        return self.generate(tokens, do_sample=False, **kw)

    def sample_generate(self, tokens, **kw):
        kw.pop("do_sample", None)
        return self.generate(tokens, do_sample=True, **kw)
