"""Generic pre-norm SwiGLU transformer over packed sequences (port of
``internevo_tpu/models/base.py``).

Parameters are a plain dict of tensors.  Linear weights are in
``torch.nn.Linear`` layout, (out, in); the blocks are a list with one dict per
layer.  Dtypes follow the JAX tree, whose init casts every leaf of two or more
dims to the model dtype: the per-layer leaves (stacked there, so norms and
biases included) are in the model dtype, and only the final norm is fp32.
``models/jax_bridge.py`` converts between the two layouts.  The forward is
differentiable (the splash attention's backward is a kernel too).  Training
with residual or attention dropout, or with activation recompute
(``checkpoint`` > 0), is not ported yet: ``model_forward(train=True)`` raises
for those settings rather than run without them.

Block structure (``modeling_internlm.py:189-236``)::

    h = norm1(x); x = x + attention(h)     # wqkv -> rope -> flash -> out_proj
    h = norm2(x); x = x + mlp(h)           # SwiGLU: w2(silu(w1 h) * w3 h)
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.norm import layer_norm, rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies

_DTYPES = {"torch.bfloat16": torch.bfloat16, "torch.float16": torch.float16,
           "torch.float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float32": torch.float32}


@dataclasses.dataclass
class ModelConfig:
    """The dense-model and MoE fields of the JAX ``ModelConfig`` (the
    reference ``build_model_with_cfg`` kwargs, ``modeling_internlm.py:463-549``).
    ``checkpoint``, ``drop_rate`` and ``attn_drop_rate`` are read only to
    refuse training with them (``model_forward``)."""

    num_layers: int = 12
    hidden_size: int = 768
    num_attention_heads: int = 12
    num_kv_attention_heads: Optional[int] = None  # GQA; None = MHA
    vocab_size: int = 50304
    mlp_ratio: float = 4.0
    max_position_embeddings: int = 2048
    dtype: Any = torch.bfloat16
    checkpoint: float = 0.0          # fraction of layers fully rematerialized
    layer_norm_epsilon: float = 1e-5
    embed_grad_scale: float = 0.1
    use_dynamic_ntk_rope: bool = False
    # static bound on packed-segment length (data.seq_len); the CUDA kernel
    # needs no bound, the API keeps it
    max_segment_len: Optional[int] = None
    rotary_bf16: bool = False
    residual_in_fp32: bool = False
    norm_type: str = "rmsnorm"
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    use_scaled_init: bool = True
    rope_base: float = 10000.0
    multiple_of: int = 256
    qkv_bias: bool = True
    o_bias: bool = True
    mlp_bias: bool = False
    norm_head: bool = False
    init_std: float = 0.0052
    attn_wqkv_init_std: float = 0.006
    attn_other_init_std: float = 0.0015
    ffn_uplayer_init_std: float = 0.006
    ffn_other_init_std: float = 0.0015
    out_head_init_std: float = 0.0052
    no_bias: bool = False
    # MoE knobs that dropless routing reads (used by modeling_moe; the JAX
    # ModelConfig's, models/base.py:116-128).  The capacity and noise knobs
    # come with the GShard routing that reads them
    num_experts: int = 1
    top_k: int = 2
    num_shared_experts: int = 0
    moe_drop_tokens: bool = True
    moe_type: str = "GShard"  # GShard (capacity) | Dropless / MegaBlock-D (grouped matmul)

    def __post_init__(self):
        # config files may say checkpoint=True/False (ref 7B_sft.py comment)
        self.checkpoint = float(self.checkpoint)
        if self.num_kv_attention_heads is None:
            self.num_kv_attention_heads = self.num_attention_heads
        if self.no_bias:
            self.qkv_bias = False
            self.o_bias = False
            self.mlp_bias = False
        if isinstance(self.dtype, str):
            self.dtype = _DTYPES[self.dtype]

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mlp_hidden(self) -> int:
        h = int(self.hidden_size * self.mlp_ratio)
        return self.multiple_of * ((h + self.multiple_of - 1) // self.multiple_of)

    @property
    def q_per_kv(self) -> int:
        return self.num_attention_heads // self.num_kv_attention_heads


# Keys of the JAX ModelConfig that the port does not model.  A key whose value
# changes what the model computes on one device is refused unless it holds its
# JAX default (key: (default, what it asks for)); the others change nothing
# here and are accepted (key: why).  Keys that neither ModelConfig holds (among
# them those the JAX builders pop, ``internevo_tpu/models/internlm.py:22-27``)
# are dropped, as the JAX builders drop them.
REFUSED_KEYS = {
    "is_reward": (False, "the reward model's 1-wide scalar head (internevo_tpu/models/base.py:108,220)"),
    "remat_save_mlp": (0.0, "saved SwiGLU gates under activation recompute, which the port refuses"),
    "remat_save_qkv": (0.0, "saved q/k/v under activation recompute, which the port refuses"),
    "activation_offload": (False, "host offload of recomputed layers' attention, which the port refuses"),
}
ACCEPTED_KEYS = {
    "parallel_output": "lays the head's output over tensor-parallel ranks",
    "scan_unroll": "unrolls the JAX layer scan",
    "ring_schedule": "orders ring attention's sequence shards",
    "use_swiglu": "read by no JAX model: the MLP is always SwiGLU",
    "moe_gate_noise": "read by nothing in the JAX package",
    "moe_layer_freq": "read by nothing in the JAX package",
    "moe_capacity_factor": "GShard capacity routing only, which the port refuses",
    "moe_eval_capacity_factor": "GShard capacity routing only, which the port refuses",
    "moe_min_capacity": "GShard capacity routing only, which the port refuses",
    "moe_use_rts": "GShard capacity routing only, which the port refuses",
    "moe_noisy_gate_policy": "GShard capacity routing only, which the port refuses",
}


def config_from_kwargs(kwargs: dict, **fixed) -> ModelConfig:
    """A ``ModelConfig`` from a builder's kwargs and the family's ``fixed``
    fields (which the kwargs cannot override, as in the JAX builders).
    Raises ``NotImplementedError`` for a key of ``REFUSED_KEYS`` set to
    anything but its JAX default."""
    for key, (default, what) in REFUSED_KEYS.items():
        if key in kwargs and kwargs[key] != default:
            raise NotImplementedError(
                f"model.{key}={kwargs[key]!r} asks for {what}; the port does not model it yet")
    return ModelConfig(**fixed, **{k: v for k, v in kwargs.items()
                                   if k in ModelConfig.__dataclass_fields__ and k not in fixed})


# --------------------------------------------------------------------------- init


def _normal(shape, std, generator, device):
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * std


def init_params(cfg: ModelConfig, generator: torch.Generator, device, mlp: bool = True) -> dict:
    """Random parameters with the reference's init distributions
    (``modeling_internlm.py:154-180``), drawn from ``generator`` on ``device``
    (which must be the generator's device).  The numbers differ from JAX's
    threefry draws; parity tests load the JAX tree through ``jax_bridge``.
    ``mlp=False`` leaves out the dense w1/w2/w3 (an MoE model whose FFN is
    all experts)."""
    H, M, D = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
    qkv_out = H + 2 * cfg.num_kv_attention_heads * D
    big = lambda t: t.to(cfg.dtype)  # noqa: E731
    ones = lambda n: torch.ones(n, dtype=cfg.dtype, device=device)  # noqa: E731
    zeros = lambda n: torch.zeros(n, dtype=cfg.dtype, device=device)  # noqa: E731
    blocks = []
    for i in range(cfg.num_layers):
        scaled = lambda base: base / math.sqrt(2.0 * (i + 1))  # noqa: E731  (ref quirk: layer_idx + 1)
        out_std = scaled(cfg.attn_wqkv_init_std) if cfg.use_scaled_init else cfg.attn_other_init_std
        w2_std = scaled(cfg.ffn_uplayer_init_std) if cfg.use_scaled_init else cfg.ffn_other_init_std
        layer = {
            "norm1": ones(H),
            "norm2": ones(H),
            "wqkv": {"weight": big(_normal((qkv_out, H), cfg.attn_wqkv_init_std, generator, device))},
            "out_proj": {"weight": big(_normal((H, H), out_std, generator, device))},
        }
        if mlp:
            layer["w1"] = {"weight": big(_normal((M, H), cfg.ffn_uplayer_init_std, generator, device))}
            layer["w3"] = {"weight": big(_normal((M, H), cfg.ffn_uplayer_init_std, generator, device))}
            layer["w2"] = {"weight": big(_normal((H, M), w2_std, generator, device))}
        if cfg.qkv_bias:
            layer["wqkv"]["bias"] = zeros(qkv_out)
        if cfg.o_bias:
            layer["out_proj"]["bias"] = zeros(H)
        if mlp and cfg.mlp_bias:
            layer["w1"]["bias"] = zeros(M)
            layer["w3"]["bias"] = zeros(M)
            layer["w2"]["bias"] = zeros(H)
        if cfg.norm_type == "layernorm":
            layer["norm1_bias"] = zeros(H)
            layer["norm2_bias"] = zeros(H)
        blocks.append(layer)
    params = {
        "embedding": {"weight": big(_normal((cfg.vocab_size, H), cfg.init_std, generator, device))},
        "blocks": blocks,
        "norm": torch.ones(H, dtype=torch.float32, device=device),
        "head": {"weight": big(_normal((cfg.vocab_size, H), cfg.out_head_init_std, generator, device))},
    }
    if cfg.norm_type == "layernorm":
        params["norm_bias"] = torch.zeros(H, dtype=torch.float32, device=device)
    return params


# ----------------------------------------------------------------------- forward


def _dense(x, weight, bias=None):
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def _norm(cfg: ModelConfig, x, weight, bias=None):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, weight, eps=cfg.layer_norm_epsilon, out_dtype=cfg.dtype)
    return layer_norm(x, weight, bias, eps=cfg.layer_norm_epsilon, out_dtype=cfg.dtype)


def split_qkv(cfg: ModelConfig, qkv: torch.Tensor):
    """Unpack the fused wqkv output from the per-kv-group layout
    [q * q_per_kv | k | v] x num_kv_heads (``modeling_internlm2.py:147-154``),
    used for every family as in the JAX package."""
    B, S = qkv.shape[:2]
    D, Hq, Hkv, g = cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_attention_heads, cfg.q_per_kv
    grouped = qkv.reshape(B, S, Hkv, (g + 2) * D)
    q = grouped[..., : g * D].reshape(B, S, Hq, D)
    k = grouped[..., g * D: (g + 1) * D].reshape(B, S, Hkv, D)
    v = grouped[..., (g + 1) * D:].reshape(B, S, Hkv, D)
    return q, k, v


def attention_block(cfg: ModelConfig, layer: dict, x, positions, segment_ids,
                    attention_fn: Callable = flash_attention):
    """fused wqkv -> rope(positions) -> segment-id attention -> out_proj.
    ``attention_fn`` has ``flash_attention``'s signature; a check may pass
    the splash module's plain version to hold the kernel path against it."""
    B, S, _ = x.shape
    qkv = _dense(x, layer["wqkv"]["weight"], layer["wqkv"].get("bias"))
    q, k, v = split_qkv(cfg, qkv)
    cos, sin = rope_frequencies(positions, cfg.head_dim, base=cfg.rope_base)
    rot_dtype = torch.bfloat16 if cfg.rotary_bf16 else torch.float32
    cos, sin = cos.to(rot_dtype), sin.to(rot_dtype)
    q = apply_rotary(q, cos, sin, compute_dtype=rot_dtype)
    k = apply_rotary(k, cos, sin, compute_dtype=rot_dtype)
    ctx = attention_fn(q, k, v.contiguous(), segment_ids=segment_ids,
                       softmax_scale=1.0 / math.sqrt(cfg.head_dim), causal=True,
                       max_segment_len=cfg.max_segment_len)
    ctx = ctx.reshape(B, S, cfg.num_attention_heads * cfg.head_dim)
    return _dense(ctx, layer["out_proj"]["weight"], layer["out_proj"].get("bias"))


def mlp_block(cfg: ModelConfig, layer: dict, x):
    """SwiGLU: w2(silu(w1 x) * w3 x)  (``modules/mlp.py:84-88``)."""
    w1o = _dense(x, layer["w1"]["weight"], layer["w1"].get("bias"))
    w3o = _dense(x, layer["w3"]["weight"], layer["w3"].get("bias"))
    return _dense(F.silu(w1o) * w3o, layer["w2"]["weight"], layer["w2"].get("bias"))


def block_forward(cfg: ModelConfig, layer: dict, x, positions, segment_ids,
                  mixer: Optional[Callable] = None, ffn: Optional[Callable] = None):
    """One pre-norm block (``modeling_internlm.py:189-236``); ``mixer``/``ffn``
    replace the attention and the MLP.  An MoE ``ffn`` returns (out, l_aux);
    the block then returns (out, l_aux) too, as the JAX ``block_forward``."""
    mixer = mixer or (lambda h: attention_block(cfg, layer, h, positions, segment_ids))
    ffn = ffn or (lambda h: mlp_block(cfg, layer, h))
    residual = x.float() if cfg.residual_in_fp32 else x
    h = mixer(_norm(cfg, residual, layer["norm1"], layer.get("norm1_bias")))
    residual = (h + residual).to(residual.dtype)
    ffn_out = ffn(_norm(cfg, residual, layer["norm2"], layer.get("norm2_bias")))
    aux = None
    if isinstance(ffn_out, tuple):
        ffn_out, aux = ffn_out
    out = (ffn_out + residual).to(torch.float32 if cfg.residual_in_fp32 else cfg.dtype)
    return out if aux is None else (out, aux)


def embed_tokens(cfg: ModelConfig, params: dict, input_ids):
    """Embedding lookup with the embed_grad_scale mix (``modeling_internlm.py:382-385``),
    the identity up to rounding in the forward."""
    x = F.embedding(input_ids, params["embedding"]["weight"]).to(cfg.dtype)
    if cfg.embed_grad_scale != 1:
        x = cfg.embed_grad_scale * x + (1 - cfg.embed_grad_scale) * x.detach()
    return x


def head_logits(cfg: ModelConfig, params: dict, h):
    """Final norm + head (``modeling_internlm.py:414-417``, ``ops/linear.py:69-78``)."""
    h = _norm(cfg, h, params["norm"], params.get("norm_bias"))
    w = params["head"]["weight"]
    if cfg.embed_grad_scale != 1:
        w = cfg.embed_grad_scale * w + (1 - cfg.embed_grad_scale) * w.detach()
    if cfg.norm_head:
        norm = torch.linalg.vector_norm(w.float(), dim=1, keepdim=True)
        w = (w / (norm.detach() + 1e-7)).to(w.dtype)
    return F.linear(h, w.to(h.dtype))


def _refuse_untrained_settings(cfg: ModelConfig) -> None:
    """Training settings of the JAX model that the port does not carry yet."""
    if cfg.drop_rate > 0.0:
        raise NotImplementedError(
            f"drop_rate={cfg.drop_rate}: residual dropout draws JAX threefry bits "
            "(internevo_tpu/models/base.py:412-417) and comes with a later slice of the port")
    if cfg.attn_drop_rate > 0.0:
        raise NotImplementedError(
            f"attn_drop_rate={cfg.attn_drop_rate}: attention dropout in training needs the "
            "per-layer dropout streams, which come with a later slice of the port")
    if cfg.checkpoint > 0.0:
        raise NotImplementedError(
            f"checkpoint={cfg.checkpoint}: activation recompute (remat, "
            "internevo_tpu/models/base.py:497-588) comes with a later slice of the port")


def model_forward(cfg: ModelConfig, params: dict, input_ids, positions, segment_ids,
                  train: bool = False, block_fn: Optional[Callable] = None,
                  return_hidden: bool = False):
    """Forward over the layer stack: logits (B, S, V), or the pre-final-norm
    hidden states with ``return_hidden`` (the fused norm+head+CE input).
    ``block_fn(layer, x) -> x`` replaces the block body.  ``train`` runs the
    training forward, which with this slice's settings is the same
    computation; the settings it does not carry yet raise."""
    if train:
        _refuse_untrained_settings(cfg)
    if block_fn is None:
        def block_fn(layer, h):
            return block_forward(cfg, layer, h, positions, segment_ids)
    x = embed_tokens(cfg, params, input_ids)
    if cfg.residual_in_fp32:
        x = x.float()
    for layer in params["blocks"]:
        x = block_fn(layer, x)
    if return_hidden:
        return x
    return head_logits(cfg, params, x)


@dataclasses.dataclass
class ModelDef:
    """A built model: config, ``init(generator, device) -> params`` and
    ``apply(params, input_ids, positions, segment_ids, ...)``."""

    config: ModelConfig
    init: Callable[[torch.Generator, Any], dict]
    apply: Callable[..., torch.Tensor]


def make_model_def(cfg: ModelConfig) -> ModelDef:
    return ModelDef(config=cfg, init=partial(init_params, cfg), apply=partial(model_forward, cfg))
