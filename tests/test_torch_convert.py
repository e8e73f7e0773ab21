"""The port's checkpoint converters (``internevo_tpu_torch/checkpoint/convert.py``,
``internevo_tpu_torch/tools/convert2hf.py`` and ``tools/revert_hf.py``) on
the CPU, held against the JAX package's ``internevo_tpu/checkpoint/convert.py``:

- the HF exports of ``params_from_jax(tree)`` equal JAX's exports of
  ``tree`` bit for bit (llama, internlm with biases, internlm2);
- the importers give ``params_from_jax`` of JAX's importers' trees bit for
  bit, and Meta llama round-trips through a tensor-parallel shard merge;
- a checkpoint exported by ``convert2hf.py`` loads in ``transformers``'
  ``LlamaForCausalLM``, whose logits match the port's model (fp32, rtol and
  atol 2e-4, as ``tests/test_utils/test_convert_hf.py:71``);
- an HF folder written from JAX's ``to_hf_llama`` loads through the port's
  ``hf_llama`` loader (the entry point's ``load_ckpt_info``) to
  ``params_from_jax`` of the same tree, from ``pytorch_model.bin``, from
  ``model.safetensors`` (the port's own reader) and from indexed shards."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu.checkpoint import convert as jconv
from internevo_tpu.models import ModelConfig as JModelConfig
from internevo_tpu.models.base import init_params as jinit_params
from internevo_tpu.ops.attention import set_use_pallas
from internevo_tpu_torch.checkpoint import convert as tconv
from internevo_tpu_torch.checkpoint.checkpoint_manager import MODEL_FOLDER, PARAMS_FILE
from internevo_tpu_torch.models.base import ModelConfig as TModelConfig
from internevo_tpu_torch.models.jax_bridge import params_from_jax
from internevo_tpu_torch.solver.optimizer import tree_leaves, tree_leaves_with_path
from internevo_tpu_torch.tools import convert2hf, revert_hf
from internevo_tpu_torch.train import main as tmain
from internevo_tpu_torch.train.pipeline import initialize_model
from internevo_tpu_torch.core.config import Config
from internevo_tpu_torch.initialize.launch import args_sanity_check

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4, num_kv_attention_heads=2, vocab_size=128,
           mlp_ratio=2.0, multiple_of=32, qkv_bias=False, o_bias=False, embed_grad_scale=1)
FORMATS = {"llama": (jconv.to_hf_llama, tconv.to_hf_llama, jconv.from_hf_llama, tconv.from_hf_llama, False),
           "internlm": (jconv.to_hf_internlm, tconv.to_hf_internlm, jconv.from_hf_internlm, tconv.from_hf_internlm,
                        True),
           "internlm2": (jconv.to_hf_internlm2, tconv.to_hf_internlm2, jconv.from_hf_internlm2,
                         tconv.from_hf_internlm2, False)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(seed, dtype=jnp.float32, bias=False):
    """A JAX param tree with noise in every leaf (norms and biases too)."""
    cfg = JModelConfig(**{**CFG, "qkv_bias": bias, "o_bias": bias}, dtype=dtype)
    tree = jinit_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    noisy = jax.tree.map(lambda a: np.asarray(np.asarray(a, np.float32) + 0.02 * rng.randn(*a.shape), a.dtype),
                         tree)
    return cfg, noisy


def _tcfg(bias=False, dtype=torch.float32):
    return TModelConfig(**{**CFG, "qkv_bias": bias, "o_bias": bias}, dtype=dtype)


def _same_tree(got, want):
    g, w = list(tree_leaves_with_path(got)), list(tree_leaves_with_path(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_export_matches_jax(fmt, dtype):
    jto, tto, _, _, bias = FORMATS[fmt]
    jcfg, tree = _jax_tree(1, getattr(jnp, dtype), bias)
    want = jto(tree, jcfg)
    got = tto(params_from_jax(tree, "cpu"), _tcfg(bias, getattr(torch, dtype)))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_import_matches_jax_and_round_trips(fmt):
    jto, tto, jfrom, tfrom, bias = FORMATS[fmt]
    jcfg, tree = _jax_tree(2, jnp.bfloat16, bias)
    sd = jto(tree, jcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jfrom(sd, jcfg)), "cpu")
    _same_tree(tfrom({k: torch.from_numpy(v) for k, v in sd.items()}, _tcfg(bias, torch.bfloat16)), want)
    _same_tree(tfrom(sd, _tcfg(bias, torch.bfloat16)), want)  # numpy values too
    # and back: the port's export of the import is JAX's export
    again = tto(want, _tcfg(bias, torch.bfloat16))
    for k in sd:
        np.testing.assert_array_equal(again[k].numpy(), sd[k], err_msg=k)


def test_meta_llama_round_trip_and_shard_merge():
    jcfg, tree = _jax_tree(3)
    tcfg = _tcfg()
    params = params_from_jax(tree, "cpu")
    sd = tconv.to_meta_llama(params, tcfg)
    jsd = jconv.to_meta_llama(tree, jcfg)
    assert list(sd) == list(jsd) and all(np.array_equal(sd[k].numpy(), jsd[k]) for k in sd)
    shards = [{}, {}]
    for key, w in sd.items():
        if any(m in key for m in tconv._META_DIM0):
            h = w.shape[0] // 2
            shards[0][key], shards[1][key] = w[:h], w[h:]
        elif any(m in key for m in tconv._META_DIM1):
            h = w.shape[1] // 2
            shards[0][key], shards[1][key] = w[:, :h], w[:, h:]
        else:
            shards[0][key] = shards[1][key] = w
    merged = tconv.merge_meta_llama_shards(shards)
    jmerged = jconv.merge_meta_llama_shards([{k: v.numpy() for k, v in s.items()} for s in shards])
    assert all(np.array_equal(merged[k].numpy(), jmerged[k]) for k in jmerged)
    _same_tree(tconv.from_meta_llama(merged, tcfg), params)
    _same_tree(tconv.from_meta_llama(merged, tcfg),
               params_from_jax(jax.tree.map(np.asarray, jconv.from_meta_llama(jmerged, jcfg)), "cpu"))


def _config_file(tmp_path, bias=True):
    path = tmp_path / "tiny.py"
    path.write_text(
        "model_type = 'INTERNLM'\n"
        "data = dict(seq_len=16, micro_num=1, micro_bsz=1, total_steps=4, num_random_samples=50)\n"
        f"model = dict(num_layers=2, hidden_size=64, num_attention_heads=4, num_kv_attention_heads=2,\n"
        f"             vocab_size=128, mlp_ratio=2.0, multiple_of=32, qkv_bias={bias}, o_bias={bias},\n"
        "             embed_grad_scale=1, dtype='torch.float32', norm_type='rmsnorm', layer_norm_epsilon=1e-5,\n"
        "             max_position_embeddings=64)\n")
    return str(path)


def test_convert2hf_folder_loads_in_transformers(tmp_path):
    """A checkpoint of the port -> ``tools/convert2hf.py`` -> transformers'
    ``LlamaForCausalLM`` (with the qkv and o biases): its logits match the
    port's model on the same ids."""
    from transformers import LlamaForCausalLM

    config = _config_file(tmp_path)
    model, params = initialize_model(args_sanity_check(Config.from_file(config)), "cpu",
                                     torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in tree_leaves(params):  # biases and norms away from their init
            t.add_(0.02 * torch.randn(t.shape, generator=gen))
    (tmp_path / "ck" / MODEL_FOLDER).mkdir(parents=True)
    torch.save(params, tmp_path / "ck" / MODEL_FOLDER / PARAMS_FILE)
    convert2hf.main(["--config", config, "--ckpt", str(tmp_path / "ck"), "--out", str(tmp_path / "hf"),
                     "--dtype", "float32"])
    assert json.loads((tmp_path / "hf" / "config.json").read_text())["attention_bias"] is True
    hf = LlamaForCausalLM.from_pretrained(str(tmp_path / "hf")).eval()
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 128, (2, 16)))
    with torch.no_grad():
        want = hf(ids).logits
        got = model.apply(params, ids, torch.arange(16).repeat(2, 1).int(), torch.ones(2, 16, dtype=torch.int32),
                          train=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    # and back through tools/revert_hf.py: the same params
    revert_hf.main(["--config", config, "--hf_path", str(tmp_path / "hf"), "--out", str(tmp_path / "back")])
    assert (tmp_path / "back" / "0.step").exists()
    _same_tree(torch.load(tmp_path / "back" / MODEL_FOLDER / PARAMS_FILE, weights_only=True), params)


def _write_hf_folder(folder, sd: dict, form: str):
    folder.mkdir()
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if form == "bin":
        torch.save(tensors, folder / "pytorch_model.bin")
    elif form == "safetensors":
        from safetensors.torch import save_file

        save_file(tensors, str(folder / "model.safetensors"))
    else:  # two shards named by an index
        names = sorted(tensors)
        half = {n: ("pytorch_model-00001-of-00002.bin" if i % 2 else "pytorch_model-00002-of-00002.bin")
                for i, n in enumerate(names)}
        for shard in set(half.values()):
            torch.save({n: tensors[n] for n in names if half[n] == shard}, folder / shard)
        (folder / "pytorch_model.bin.index.json").write_text(json.dumps({"weight_map": half}))


@pytest.mark.parametrize("form", ["bin", "safetensors", "sharded"])
def test_jax_hf_folder_loads_through_the_entry_point(form, tmp_path):
    """JAX's ``to_hf_llama`` of a bf16 tree, written as an HF folder, loads
    through ``load_ckpt_info=dict(..., ckpt_type="hf_llama")`` into the
    port's params equal to ``params_from_jax`` of the tree; the masters
    restart from them and the moments are zero."""
    set_use_pallas(False)
    try:
        jcfg, tree = _jax_tree(4, jnp.bfloat16, bias=True)
    finally:
        set_use_pallas(None)
    _write_hf_folder(tmp_path / "hf", jconv.to_hf_llama(tree, jcfg), form)
    cfg = dict(model_type="INTERNLM",
               data=dict(seq_len=16, micro_num=1, micro_bsz=1, total_steps=1, num_random_samples=50),
               model={**CFG, "qkv_bias": True, "o_bias": True, "dtype": "torch.bfloat16"},
               ckpt=dict(auto_resume=False, load_ckpt_info=dict(path=str(tmp_path / "hf"), content=("model",),
                                                                ckpt_type="hf_llama")),
               enable_tb=False)
    out = tmain.run_training(cfg, device="cpu", steps=0)
    engine = out["engine"]
    _same_tree(engine.params, params_from_jax(tree, "cpu"))
    assert out["ckpt_manager"].load_record["type"] == "hf_llama"
    for m, p in zip(tree_leaves(engine.opt_state["master"]), tree_leaves(engine.params)):
        assert torch.equal(m, p.float())
    assert not any(t.any() for t in tree_leaves(engine.opt_state["m"]))


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import save_file

    tensors = {"a": torch.randn(3, 5), "b": torch.randn(7).to(torch.bfloat16), "c": torch.arange(6).int(),
               "d": torch.zeros(0, 4, dtype=torch.float16), "e": torch.tensor([True, False])}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = tconv.read_safetensors(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
