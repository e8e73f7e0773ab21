"""The port's model against the JAX model on one numpy-made parameter tree:
the weight bridge round trip, whole-model logits (MHA with packed segments,
and GQA through the grouped wqkv layout), and the eval step's loss and
counts.  fp32 throughout: the point is the algorithm."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from internevo_tpu.core.scheduler import no_pipeline as jsched
from internevo_tpu.models import base as jbase
from internevo_tpu.models import internlm as jinternlm
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.core.scheduler import no_pipeline as tsched
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.models import internlm as tinternlm
from internevo_tpu_torch.models.jax_bridge import params_from_jax, params_to_numpy

TINY = dict(num_layers=2, hidden_size=128, num_attention_heads=2, vocab_size=512,
            mlp_ratio=8 / 3, multiple_of=64, max_segment_len=48, embed_grad_scale=0.1)


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)  # the JAX model on the CPU runs its jnp attention
    yield
    set_use_pallas(None)


def numpy_tree(jcfg, seed=0, dtype=np.float32):
    """A JAX-layout param tree drawn with numpy: weights N(0, 0.05), norms
    near 1, biases non-zero so their layout is exercised."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jbase.init_params(jcfg, jax.random.PRNGKey(0)))

    def draw(s):
        if len(s.shape) >= 2:
            return (0.05 * rng.randn(*s.shape)).astype(np.float32).astype(dtype)
        return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree.map(draw, shapes)


def packed_batch(B, S, vocab, seed=0, max_len=48, pad=20):
    rng = np.random.RandomState(seed)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        p, sid = 0, 1
        while p < S - pad:
            n = min(rng.randint(8, max_len + 1), S - pad - p)
            seg[b, p:p + n] = sid
            pos[b, p:p + n] = np.arange(n)
            p += n
            sid += 1
        pos[b, S - pad:] = np.arange(pad)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels[:, S - pad:] = -100
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    return {"input_ids": ids, "indexes": pos, "segment_ids": seg, "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k in ("input_ids", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["fp32", "bf16"])
def test_bridge_round_trip_exact(dtype):
    jcfg = jbase.ModelConfig(**TINY, num_kv_attention_heads=1, dtype=jnp.float32)
    tree = numpy_tree(jcfg, dtype=dtype)
    params = params_from_jax(tree, "cpu")
    assert params["blocks"][1]["wqkv"]["weight"].shape == (2 * 64 + 2 * 64, 128)
    want_dtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    assert params["blocks"][0]["w1"]["weight"].dtype == want_dtype
    assert params["blocks"][0]["wqkv"]["bias"].dtype == want_dtype  # stacked: 2-D in JAX
    assert params["norm"].dtype == torch.float32
    back = params_to_numpy(params)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("kv_heads,norm_type", [(None, "rmsnorm"), (1, "rmsnorm"), (2, "layernorm")],
                         ids=["mha", "gqa", "layernorm"])
def test_model_forward_logits(kv_heads, norm_type):
    heads = 2 if kv_heads is None else 4
    kw = dict(TINY, num_attention_heads=heads, num_kv_attention_heads=kv_heads, norm_type=norm_type,
              qkv_bias=True, o_bias=True)
    jcfg = jbase.ModelConfig(**kw, dtype=jnp.float32)
    tcfg = tbase.ModelConfig(**kw, dtype=torch.float32)
    tree = numpy_tree(jcfg, seed=1)
    batch = packed_batch(2, 96, TINY["vocab_size"], seed=1)
    lj = jbase.model_forward(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["input_ids"]),
                             jnp.asarray(batch["indexes"]), jnp.asarray(batch["segment_ids"]), train=False)
    tb = _torch_batch(batch)
    lt = tbase.model_forward(tcfg, params_from_jax(tree, "cpu"), tb["input_ids"], tb["indexes"], tb["segment_ids"])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"], ids=["fused_ce", "unfused"])
@pytest.mark.parametrize("per_token", [False, True])
def test_eval_step(per_token, norm_type):
    kw = dict(TINY, dtype="float32", norm_type=norm_type)
    jmodel = jinternlm.build_model_with_cfg(**kw)
    tmodel = tinternlm.build_model_with_cfg(**kw)
    assert tmodel.config.qkv_bias and tmodel.config.max_segment_len == 48
    tree = numpy_tree(jmodel.config, seed=2)
    batch = packed_batch(2, 128, TINY["vocab_size"], seed=2)
    # plant correct predictions on every third token so n_correct is not trivially 0
    logits = jmodel.apply(jax.tree.map(jnp.asarray, tree), batch["input_ids"], batch["indexes"],
                          batch["segment_ids"], train=False)
    pred = np.asarray(jnp.argmax(logits, axis=-1))
    batch["labels"][:, :100:3] = pred[:, :100:3]
    rj = jsched.make_eval_step(jmodel, label_smoothing=0.1, per_token=per_token)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    rt = tsched.make_eval_step(tmodel, label_smoothing=0.1, per_token=per_token, chunk_size=100)(
        params_from_jax(tree, "cpu"), _torch_batch(batch))
    np.testing.assert_allclose(float(rt["loss"]), float(rj["loss"]), rtol=5e-5)
    assert int(rt["n_tokens"]) == int(rj["n_tokens"]) == 2 * (128 - 20)
    assert int(rt["n_correct"]) == int(rj["n_correct"]) >= 2 * 34
    if per_token:
        np.testing.assert_allclose(rt["nll"].numpy(), np.asarray(rj["nll"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(rt["correct"].numpy(), np.asarray(rj["correct"]))


def test_initialize_model_from_config():
    """The 7B config builds through the registry with max_segment_len from
    data.seq_len (cut to 1 layer and a narrow width to run on the CPU)."""
    from pathlib import Path

    from internevo_tpu_torch.core.config import Config
    from internevo_tpu_torch.train.pipeline import initialize_model

    cfg = Config.from_file(Path(__file__).resolve().parents[1] / "configs" / "7B_sft.py")
    cfg.model.update(num_layers=1, hidden_size=128, num_attention_heads=2, vocab_size=256)
    model, params = initialize_model(cfg, "cpu", torch.Generator().manual_seed(0))
    c = model.config
    assert (c.max_segment_len, c.dtype, c.mlp_hidden, c.embed_grad_scale) == (2048, torch.bfloat16, 512, 1)
    assert params["blocks"][0]["wqkv"]["bias"].dtype == torch.bfloat16  # stacked: 2-D in JAX
    assert params["norm"].dtype == torch.float32
    assert params["head"]["weight"].shape == (256, 128)
    full = dataclasses.replace(c, hidden_size=4096, num_attention_heads=32)
    assert (full.head_dim, full.mlp_hidden) == (128, 11008)


# ------------------------------------------------------------ config keys


@pytest.mark.parametrize("config,model_type,shape", [
    ("7B_sft.py", "INTERNLM", (32, 4096, 103168, 32, True)),
    ("7B_MoE4_sft.py", "INTERNLM_MoE", (32, 4096, 103168, 32, True)),
    ("7B_internlm2.py", "INTERNLM2_PUBLIC", (32, 4096, 92544, 8, False)),
    ("7B_llama2.py", "LLAMA2", (32, 4096, 32000, 8, False))])
def test_shipped_configs_build(config, model_type, shape):
    """The shipped configs build through the registry under their own
    ``model_type``, with the keys the JAX builders pop (``embed_split_hidden``,
    ``use_flash_attn``, ``use_fp32_norm``, ...) and the layout-only
    ``parallel_output``: layers, width, vocab, kv heads and the wqkv bias (off
    under ``no_bias``); the MoE config routed dropless, as the chip runs take
    it."""
    from pathlib import Path

    from internevo_tpu_torch.core.config import Config
    from internevo_tpu_torch.utils.registry import MODEL_INITIALIZER

    cfg = Config.from_file(Path(__file__).resolve().parents[1] / "configs" / config)
    assert cfg.get("model_type", "INTERNLM") == model_type
    kw = dict(cfg.model)
    assert {"embed_split_hidden", "use_flash_attn", "num_chunks", "parallel_output"} <= set(kw)
    if model_type == "INTERNLM_MoE":
        kw["moe_type"] = "MegaBlock-D"
    c = MODEL_INITIALIZER.get_module(model_type)(**kw, use_fp32_norm=False).config
    assert (c.num_layers, c.hidden_size, c.vocab_size, c.num_kv_attention_heads, c.qkv_bias) == shape


def test_port_config_covers_every_jax_field():
    """Every field of the JAX ModelConfig is a field of the port's, with the
    JAX default, or one of the port's accepted keys.  A field added to the
    JAX package fails here until the port decides."""
    port = tbase.ModelConfig.__dataclass_fields__
    jax_fields = jbase.ModelConfig.__dataclass_fields__
    assert not set(port) & set(tbase.ACCEPTED_KEYS) and set(tbase.ACCEPTED_KEYS) <= set(jax_fields)
    missing = set(jax_fields) - set(port) - set(tbase.ACCEPTED_KEYS)
    assert not missing, f"JAX ModelConfig fields the port neither models nor lists: {sorted(missing)}"
    for key in ("is_reward", "remat_save_mlp", "remat_save_qkv", "activation_offload", "checkpoint",
                "drop_rate", "attn_drop_rate"):
        assert port[key].default == jax_fields[key].default, key
