"""The port's generation path against the JAX one (``tests/test_apis/
test_inference.py`` is the model): decode-step logits, greedy tokens with
and without eos, repetition penalty, dynamic-NTK rope past the window, and
top-k/top-p filtering.  Sampling draws from another random stream than JAX's,
so it is held to its own properties: seeded runs repeat, and every sampled
token lies in the filtered set.  fp32 throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.apis import inference as jinf
from internevo_tpu.models import base as jbase
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.apis import inference as tinf
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.models.jax_bridge import params_from_jax
from tests.test_torch_model import numpy_tree

CFG = dict(num_layers=2, hidden_size=128, num_attention_heads=4, num_kv_attention_heads=2,
           vocab_size=256, mlp_ratio=2.0, multiple_of=32, qkv_bias=True, o_bias=True)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_dense_attention():
    set_use_pallas(False)
    yield
    set_use_pallas(None)


def _models(**over):
    kw = dict(CFG, **over)
    jcfg = jbase.ModelConfig(**kw, dtype=jnp.float32)
    tcfg = tbase.ModelConfig(**kw, dtype=torch.float32)
    tree = numpy_tree(jcfg, seed=3)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, "cpu")
    jgen = jinf.SequenceGenerator((jbase.ModelDef(config=jcfg, init=None, apply=None), jparams),
                                  eos_token_id=-1)
    tgen = tinf.SequenceGenerator((tbase.make_model_def(tcfg), tparams), eos_token_id=-1)
    return jcfg, jparams, tcfg, tparams, jgen, tgen


def _prompt(B=2, n=5, seed=0):
    return np.random.RandomState(seed).randint(3, CFG["vocab_size"], (B, n)).astype(np.int32)


def test_decode_step_matches_jax_and_full_forward():
    jcfg, jparams, tcfg, tparams, _, _ = _models()
    B, S = 2, 16
    ids = _prompt(B, S, seed=1)
    tids = torch.from_numpy(ids).long()
    pos = torch.arange(S).repeat(B, 1)
    full = tbase.model_forward(tcfg, tparams, tids, pos, torch.ones(B, S, dtype=torch.int32))
    jcache = jinf.init_kv_cache(jcfg, B, S)
    tcache = tinf.init_kv_cache(tcfg, B, S, "cpu")
    lj, jcache = jinf.model_decode_step(jcfg, jparams, jnp.asarray(ids[:, :8]), jcache, jnp.int32(0))
    lt, tcache = tinf.model_decode_step(tcfg, tparams, tids[:, :8], tcache, 0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(lt.numpy(), full[:, :8].numpy(), **TOL)
    for t in range(8, S):
        lj, jcache = jinf.model_decode_step(jcfg, jparams, jnp.asarray(ids[:, t:t + 1]), jcache, jnp.int32(t))
        lt, tcache = tinf.model_decode_step(tcfg, tparams, tids[:, t:t + 1], tcache, t)
        np.testing.assert_allclose(lt[:, 0].numpy(), np.asarray(lj[:, 0]), **TOL)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)


def test_greedy_matches_jax_with_and_without_eos():
    *_, jgen, tgen = _models()
    prompt = _prompt()
    out_j = np.asarray(jgen.generate(jnp.asarray(prompt), max_length=20))
    out_t = tgen.generate(torch.from_numpy(prompt), max_length=20).numpy()
    assert out_t.shape == (2, 20)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t[:, :5], prompt)
    # a real eos, the token greedy emits at step 8: generation stops there
    eos = int(out_j[0, 8])
    jgen.eos_token_id = tgen.eos_token_id = eos
    out_j = np.asarray(jgen.generate(jnp.asarray(prompt[:1]), max_length=20))
    out_t = tgen.generate(torch.from_numpy(prompt[:1]), max_length=20).numpy()
    assert out_t.shape == (1, int(np.argmax(out_t[0] == eos)) + 1) and out_t.shape[1] <= 9
    np.testing.assert_array_equal(out_t, out_j)


def test_repetition_penalty_matches_jax():
    *_, jgen, tgen = _models()
    prompt = _prompt(seed=2)
    out_j = np.asarray(jgen.generate(jnp.asarray(prompt), max_length=24, repetition_penalty=3.0))
    out_t = tgen.generate(torch.from_numpy(prompt), max_length=24, repetition_penalty=3.0).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    plain = tgen.generate(torch.from_numpy(prompt), max_length=24).numpy()
    assert not np.array_equal(plain, out_t)


def test_dynamic_ntk_past_window_matches_jax():
    *_, jgen, tgen = _models(use_dynamic_ntk_rope=True, max_position_embeddings=8)
    prompt = _prompt(n=6, seed=4)
    out_j = np.asarray(jgen.generate(jnp.asarray(prompt), max_length=20))
    out_t = tgen.generate(torch.from_numpy(prompt), max_length=20).numpy()
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.7), (5, 1.0), (20, 0.5), (1, 0.9)])
def test_top_k_top_p_filtering_matches_jax(top_k, top_p):
    logits = np.random.RandomState(top_k).randn(3, 50).astype(np.float32) * 2
    ft = tinf.top_k_top_p_filtering(torch.from_numpy(logits), top_k=top_k, top_p=top_p).numpy()
    fj = np.asarray(jinf.top_k_top_p_filtering(jnp.asarray(logits), top_k=top_k, top_p=top_p))
    np.testing.assert_array_equal(ft, fj)


def test_sampling_seeded_and_inside_filtered_set():
    _, _, tcfg, tparams, _, tgen = _models()
    prompt = torch.from_numpy(_prompt(seed=5))
    kw = dict(max_length=18, top_k=8, top_p=0.9, seed=11)
    a = tgen.sample_generate(prompt, **kw)
    b = tgen.sample_generate(prompt, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, tgen.sample_generate(prompt, **dict(kw, seed=12)))
    B, n = a.shape
    logits = tbase.model_forward(tcfg, tparams, a, torch.arange(n).repeat(B, 1),
                                 torch.ones(B, n, dtype=torch.int32))
    allowed = torch.isfinite(tinf.top_k_top_p_filtering(logits[:, 4:-1], top_k=8, top_p=0.9))
    picked = torch.take_along_dim(allowed, a[:, 5:, None], dim=-1)[..., 0]
    assert bool(picked.all())
    assert dataclasses.is_dataclass(tinf.InferenceParams(max_sequence_len=8, max_batch_size=1))
