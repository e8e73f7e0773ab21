"""Generic pre-norm SwiGLU transformer over packed sequences (port of
``internevo_tpu/models/base.py``).

Parameters are a plain dict of tensors.  Linear weights are in
``torch.nn.Linear`` layout, (out, in); the blocks are a list with one dict per
layer.  Dtypes follow the JAX tree, whose init casts every leaf of two or more
dims to the model dtype: the per-layer leaves (stacked there, so norms and
biases included) are in the model dtype, and only the final norm is fp32.
``models/jax_bridge.py`` converts between the two layouts.  The forward is
differentiable (the splash attention's backward is a kernel too).

Training draws JAX's streams (``core/random.py``): layer i's key is
``fold_in(dropout_rng, i)``, its residual dropout masks ``fold_in(key, 0)``
and ``fold_in(key, 1)``, and its attention-dropout seed the 32 bits of
``fold_in(key, 7)``.  ``checkpoint`` recomputes the first ``int(L *
checkpoint)`` layers in the backward (``core/remat.py``), with the JAX
model's tiers: ``remat_save_mlp`` and ``remat_save_qkv`` keep the SwiGLU
gates or the post-rotary q, k, v in a front fraction of them, and
``activation_offload`` keeps their attention output in host memory.

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

from ..core import random as jrandom
from ..core import remat
from ..ops.attention import flash_attention
from ..ops.cuda.dropout import dropout as residual_dropout
from ..ops.norm import layer_norm, rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from ..solver.optimizer import tree_leaves

_DTYPES = {"torch.bfloat16": torch.bfloat16, "torch.float16": torch.float16,
           "torch.float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float32": torch.float32}


@dataclasses.dataclass
class ModelConfig:
    """The dense-model and MoE fields of the JAX ``ModelConfig`` (the
    reference ``build_model_with_cfg`` kwargs, ``modeling_internlm.py:463-549``)."""

    num_layers: int = 12
    hidden_size: int = 768
    num_attention_heads: int = 12
    num_kv_attention_heads: Optional[int] = None  # GQA; None = MHA
    vocab_size: int = 50304
    mlp_ratio: float = 4.0
    max_position_embeddings: int = 2048
    dtype: Any = torch.bfloat16
    checkpoint: float = 0.0          # fraction of layers fully rematerialized
    activation_offload: bool = False  # recomputed layers keep their attention output on the host
    remat_save_mlp: float = 0.0      # fraction of the recomputed layers that keep the SwiGLU gates
    remat_save_qkv: float = 0.0      # fraction of the recomputed layers that keep post-rotary q, k, v
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
    is_reward: bool = False          # reward model: a 1-wide scalar head
    init_std: float = 0.0052
    attn_wqkv_init_std: float = 0.006
    attn_other_init_std: float = 0.0015
    ffn_uplayer_init_std: float = 0.006
    ffn_other_init_std: float = 0.0015
    out_head_init_std: float = 0.0052
    no_bias: bool = False
    # MoE knobs (used by modeling_moe; the JAX ModelConfig's,
    # models/base.py:116-128)
    num_experts: int = 1
    top_k: int = 2
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.0
    moe_eval_capacity_factor: float = 1.0
    moe_min_capacity: int = 4
    moe_drop_tokens: bool = True
    moe_use_rts: bool = True
    moe_type: str = "GShard"  # GShard (capacity) | Dropless / MegaBlock-D (grouped matmul)
    moe_noisy_gate_policy: Optional[str] = None  # None | "RSample" | "Jitter" (ref gshard top1)

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


# Keys of the JAX ModelConfig that the port does not hold because they change
# nothing it computes on one device (key: why).  Keys that neither ModelConfig
# holds (among them those the JAX builders pop,
# ``internevo_tpu/models/internlm.py:22-27``) are dropped, as the JAX builders
# drop them.
ACCEPTED_KEYS = {
    "parallel_output": "lays the head's output over tensor-parallel ranks",
    "scan_unroll": "unrolls the JAX layer scan",
    "ring_schedule": "orders ring attention's sequence shards",
    "use_swiglu": "read by no JAX model: the MLP is always SwiGLU",
    "moe_gate_noise": "read by nothing in the JAX package",
    "moe_layer_freq": "read by nothing in the JAX package",
}


def config_from_kwargs(kwargs: dict, defaults: Optional[dict] = None, **fixed) -> ModelConfig:
    """A ``ModelConfig`` from a builder's kwargs, the family's ``defaults``
    (which the kwargs override) and its ``fixed`` fields (which they cannot
    override), as the JAX builders make them; keys that are no field are
    dropped."""
    fields = {**(defaults or {}), **{k: v for k, v in kwargs.items()
                                     if k in ModelConfig.__dataclass_fields__ and k not in fixed}}
    return ModelConfig(**fixed, **fields)


# --------------------------------------------------------------------------- init


def _normal(shape, std, generator, device):
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * std


def init_params(cfg: ModelConfig, generator: torch.Generator, device, mlp: bool = True) -> dict:
    """Random parameters with the reference's init distributions
    (``modeling_internlm.py:154-180``), drawn from ``generator`` on ``device``
    (which must be the generator's device).  The numbers differ from JAX's
    draws; parity tests load the JAX tree through ``jax_bridge``.
    ``mlp=False`` leaves out the dense w1/w2/w3 (an MoE model whose FFN is
    all experts).  A reward model's head has one row (``models/base.py:220``)."""
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
        "head": {"weight": big(_normal((1 if cfg.is_reward else cfg.vocab_size, H), cfg.out_head_init_std,
                                       generator, device))},
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


def _linear_grads(g, x, weight, has_bias: bool):
    """(dx, dW, db) of y = x Wᵀ + b for the upstream grad ``g``."""
    g2 = g.reshape(-1, g.shape[-1])
    dx = (g2 @ weight).reshape(x.shape)
    dw = g2.t() @ x.reshape(-1, x.shape[-1])
    return dx, dw, (g2.sum(0) if has_bias else None)


class _NamedLinear(torch.autograd.Function):
    """y = x Wᵀ + b, named ``name`` for recompute (``core/remat.py``): its
    backward needs only x and W, so a recompute that keeps y skips the
    product."""

    @staticmethod
    def forward(ctx, x, weight, bias, name):
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight)
        return remat.saved(name, lambda: F.linear(x, weight, bias), x.device)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*_linear_grads(g, x, weight, ctx.has_bias), None)


def named_linear(x, linear: dict, name: str):
    """``_dense`` under a name the recompute tiers can keep."""
    bias = linear.get("bias")
    return _NamedLinear.apply(x, linear["weight"].to(x.dtype), None if bias is None else bias.to(x.dtype), name)


def _rotary_grad(g, cos, sin, dtype):
    """The rotary's backward: the transposed rotation of the grad in the
    frequencies' dtype, rounded once to ``dtype`` (as autograd through
    ``apply_rotary`` computes it)."""
    half = g.shape[-1] // 2
    g1, g2 = g[..., :half].to(cos.dtype), g[..., half:].to(cos.dtype)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([g1 * c + g2 * s, g2 * c - g1 * s], dim=-1).to(dtype)


class _QkvRotary(torch.autograd.Function):
    """(q, k, v): the fused wqkv projection split into heads, the rotary on q
    and k in the frequencies' dtype, v contiguous; named ``remat.QKV``.  Its
    backward needs only x, the weight and the frequencies, so a recompute
    that keeps q, k, v skips the projection and the rotary."""

    @staticmethod
    def forward(ctx, x, weight, bias, cos, sin, cfg):
        def compute():
            q, k, v = split_qkv(cfg, F.linear(x, weight, bias))
            return (apply_rotary(q, cos, sin, compute_dtype=cos.dtype),
                    apply_rotary(k, cos, sin, compute_dtype=cos.dtype), v.contiguous())

        ctx.cfg, ctx.has_bias = cfg, bias is not None
        ctx.save_for_backward(x, weight, cos, sin)
        return remat.saved(remat.QKV, compute, x.device)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, weight, cos, sin = ctx.saved_tensors
        cfg = ctx.cfg
        B, S = x.shape[:2]
        Hkv, D = cfg.num_kv_attention_heads, cfg.head_dim
        dq = _rotary_grad(dq, cos, sin, x.dtype).reshape(B, S, Hkv, cfg.q_per_kv * D)
        dk = _rotary_grad(dk, cos, sin, x.dtype)
        dqkv = torch.cat([dq, dk, dv], dim=-1).reshape(B, S, -1)
        return (*_linear_grads(dqkv, x, weight, ctx.has_bias), None, None, None)


def attention_block(cfg: ModelConfig, layer: dict, x, positions, segment_ids, attn_seed: Optional[int] = None,
                    attention_fn: Callable = flash_attention):
    """fused wqkv -> rope(positions) -> segment-id attention -> out_proj,
    with attention dropout at ``cfg.attn_drop_rate`` when ``attn_seed`` is
    given.  ``attention_fn`` has ``flash_attention``'s signature; a check may
    pass the splash module's plain version to hold the kernel path against
    it."""
    B, S, _ = x.shape
    cos, sin = rope_frequencies(positions, cfg.head_dim, base=cfg.rope_base)
    rot_dtype = torch.bfloat16 if cfg.rotary_bf16 else torch.float32
    bias = layer["wqkv"].get("bias")
    q, k, v = _QkvRotary.apply(x, layer["wqkv"]["weight"].to(x.dtype), None if bias is None else bias.to(x.dtype),
                               cos.to(rot_dtype), sin.to(rot_dtype), cfg)
    rate = cfg.attn_drop_rate if attn_seed is not None else 0.0
    ctx = attention_fn(q, k, v, segment_ids=segment_ids, softmax_scale=1.0 / math.sqrt(cfg.head_dim), causal=True,
                       max_segment_len=cfg.max_segment_len, dropout_rate=rate, dropout_seed=attn_seed)
    ctx = ctx.reshape(B, S, cfg.num_attention_heads * cfg.head_dim)
    return _dense(ctx, layer["out_proj"]["weight"], layer["out_proj"].get("bias"))


def mlp_block(cfg: ModelConfig, layer: dict, x):
    """SwiGLU: w2(silu(w1 x) * w3 x)  (``modules/mlp.py:84-88``), the gates
    named ``mlp_w1o`` and ``mlp_w3o``."""
    w1o = named_linear(x, layer["w1"], "mlp_w1o")
    w3o = named_linear(x, layer["w3"], "mlp_w3o")
    return _dense(F.silu(w1o) * w3o, layer["w2"]["weight"], layer["w2"].get("bias"))


def block_forward(cfg: ModelConfig, layer: dict, x, positions, segment_ids, key: Optional[jrandom.Key] = None,
                  train: bool = False, ffn: Optional[Callable] = None, attention_fn: Callable = flash_attention):
    """One pre-norm block (``modeling_internlm.py:189-236``); ``ffn`` replaces
    the MLP and ``attention_fn`` the attention kernel (``attention_block``).
    An MoE ``ffn`` returns (out, l_aux); the block then returns (out, l_aux)
    too, as the JAX ``block_forward``.
    With ``train`` and the layer's ``key``, residual dropout (tags 0 and 1)
    and attention dropout (tag 7) draw from it (JAX ``models/base.py:339-424``)."""
    attn_seed = (jrandom.bits_scalar(jrandom.fold_in(key, 7))
                 if train and key is not None and cfg.attn_drop_rate > 0.0 else None)
    ffn = ffn or (lambda h: mlp_block(cfg, layer, h))

    def dropout(h, tag):
        if not train or cfg.drop_rate == 0.0 or key is None:
            return h
        return residual_dropout(h, jrandom.fold_in(key, tag), cfg.drop_rate)

    residual = dropout(x, 0)
    if cfg.residual_in_fp32:
        residual = residual.float()
    h = attention_block(cfg, layer, _norm(cfg, residual, layer["norm1"], layer.get("norm1_bias")), positions,
                        segment_ids, attn_seed, attention_fn)
    residual = (dropout(h, 1) + residual).to(residual.dtype)
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


def remat_policies(cfg: ModelConfig, moe: bool = False) -> list[Optional[remat.Policy]]:
    """Each layer's recompute policy, None for a layer that keeps everything,
    laid out as the JAX stacks lay out their scans (``internevo_tpu/models/
    base.py:497-587``, ``modeling_moe.py:170-200``): the first ``int(L * checkpoint)`` layers are
    recomputed (the MoE stack rounds, the dense one truncates), and of those
    ``round(n * remat_save_mlp)`` keep the gates and ``round(n *
    remat_save_qkv)`` keep q, k, v, both fractions counted from the front:
    the layers keeping both, then the larger single tier, then the plain
    recomputed ones.  Every policy keeps the splash forward's (out, lse).
    ``activation_offload`` (dense stacks only, as in JAX) keeps them in host
    memory instead, and the gates on the device in every recomputed layer
    when ``remat_save_mlp`` is set, with no q, k, v tier."""
    L = cfg.num_layers
    n_full = min(int(round(L * cfg.checkpoint)) if moe else int(L * cfg.checkpoint), L)

    def count(frac) -> int:
        return int(round(n_full * min(1.0, max(0.0, float(frac)))))

    n_gates, n_qkv = count(cfg.remat_save_mlp), count(cfg.remat_save_qkv)
    flash = frozenset({remat.FLASH})
    full = remat.Policy(flash)
    if cfg.activation_offload and not moe:
        full = remat.Policy(flash | (remat.GATES if cfg.remat_save_mlp > 0 else frozenset()), flash)
        n_gates = n_qkv = 0
    n_both, n_single = min(n_gates, n_qkv), max(n_gates, n_qkv)
    both = remat.Policy(flash | remat.GATES | {remat.QKV})
    single = remat.Policy(flash | (remat.GATES if n_gates >= n_qkv else {remat.QKV}))
    return [both] * n_both + [single] * (n_single - n_both) + [full] * (n_full - n_single) + [None] * (L - n_full)


def layer_plan(cfg: ModelConfig, blocks: list, dropout_rng: Optional[jrandom.Key], train: bool,
               moe: bool = False, keyed: bool = False):
    """(layer, key, policy) for each layer: its params, its key
    ``fold_in(dropout_rng, i)`` while the layer draws (``train``, a key, and
    a dropout rate above 0 or ``keyed``, a layer whose gate draws noise;
    else None) and its recompute policy."""
    active = train and dropout_rng is not None and (cfg.drop_rate > 0.0 or cfg.attn_drop_rate > 0.0 or keyed)
    for i, (layer, policy) in enumerate(zip(blocks, remat_policies(cfg, moe))):
        yield layer, (jrandom.fold_in(dropout_rng, i) if active else None), policy


def run_layer(block_fn: Callable, layer: dict, key, policy, x):
    """``block_fn(layer, x, key)`` under the layer's recompute policy."""
    return remat.checkpoint(lambda h: block_fn(layer, h, key), x, tree_leaves(layer), policy)


def model_forward(cfg: ModelConfig, params: dict, input_ids, positions, segment_ids,
                  dropout_rng: Optional[jrandom.Key] = None, train: bool = False,
                  block_fn: Optional[Callable] = None, return_hidden: bool = False):
    """Forward over the layer stack: logits (B, S, V), or the pre-final-norm
    hidden states with ``return_hidden`` (the fused norm+head+CE input).
    ``dropout_rng`` is the micro-batch's key (``core/random.py``); with
    ``train`` it feeds the layers' dropout.  ``block_fn(layer, x, key) -> x``
    replaces the block body."""
    if block_fn is None:
        def block_fn(layer, h, key):
            return block_forward(cfg, layer, h, positions, segment_ids, key, train)
    x = embed_tokens(cfg, params, input_ids)
    if cfg.residual_in_fp32:
        x = x.float()
    for layer, key, policy in layer_plan(cfg, params["blocks"], dropout_rng, train):
        x = run_layer(block_fn, layer, key, policy, x)
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
