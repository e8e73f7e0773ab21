"""The PyTorch port stands alone: it never imports jax or internevo_tpu, its
device shim never hands back the CPU for a CUDA request, a CUDA request on a
machine without a card raises instead of falling back, and CUDA tensors --
those that need a gradient too -- reach the kernels, never the plain
versions."""

import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from internevo_tpu_torch.accelerator import get_device
from internevo_tpu_torch.ops.cuda import fused_adamw, gmm
from internevo_tpu_torch.ops.cuda import splash_attention as splash

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "internevo_tpu_torch",
    "internevo_tpu_torch.accelerator",
    "internevo_tpu_torch.core.config",
    "internevo_tpu_torch.core.scheduler.no_pipeline",
    "internevo_tpu_torch.core.engine",
    "internevo_tpu_torch.core.trainer",
    "internevo_tpu_torch.solver",
    "internevo_tpu_torch.solver.lr_scheduler",
    "internevo_tpu_torch.solver.optimizer",
    "internevo_tpu_torch.utils.registry",
    "internevo_tpu_torch.utils.common",
    "internevo_tpu_torch.ops.norm",
    "internevo_tpu_torch.ops.rotary",
    "internevo_tpu_torch.ops.attention",
    "internevo_tpu_torch.ops.cross_entropy",
    "internevo_tpu_torch.ops.fused_ce",
    "internevo_tpu_torch.ops.cuda.build",
    "internevo_tpu_torch.ops.cuda.splash_attention",
    "internevo_tpu_torch.ops.cuda.fused_adamw",
    "internevo_tpu_torch.ops.cuda.gmm",
    "internevo_tpu_torch.models",
    "internevo_tpu_torch.models.base",
    "internevo_tpu_torch.models.internlm",
    "internevo_tpu_torch.models.modeling_moe",
    "internevo_tpu_torch.models.moe",
    "internevo_tpu_torch.models.moe.dropless",
    "internevo_tpu_torch.models.moe.gshard",
    "internevo_tpu_torch.models.jax_bridge",
    "internevo_tpu_torch.core.scheduler.hooks",
    "internevo_tpu_torch.data.dummy_dataset",
    "internevo_tpu_torch.data.utils",
    "internevo_tpu_torch.data.packed_dataset",
    "internevo_tpu_torch.data.batch_sampler",
    "internevo_tpu_torch.data.collaters",
    "internevo_tpu_torch.data.single_dataset",
    "internevo_tpu_torch.data.build_dataloader",
    "internevo_tpu_torch.data.train_state",
    "internevo_tpu_torch.native",
    "internevo_tpu_torch.initialize",
    "internevo_tpu_torch.initialize.launch",
    "internevo_tpu_torch.train.pipeline",
    "internevo_tpu_torch.train.main",
    "internevo_tpu_torch.apis.inference",
    "internevo_tpu_torch.tools",
    "internevo_tpu_torch.tools.profile_step",
]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'internevo_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    # -S: no site hooks, so nothing outside the port can pull jax in first
    proc = subprocess.run([sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {sys.path!r}\n" + code],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_get_device_cuda_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        get_device("tpu")


def test_tensor_makers_default_to_the_card(monkeypatch):
    """``init_kv_cache``, ``params_from_jax``, ``opt_state_from_jax`` and the
    GShard gate's draws (``_gumbel``, ``_uniform``) put their tensors on the
    card unless the caller asks for the CPU, and without a card they raise,
    as ``get_device("cuda")`` does; the RNG helpers under them take no
    default device."""
    import numpy as np

    from internevo_tpu_torch.apis.inference import init_kv_cache
    from internevo_tpu_torch.core import random as jrandom
    from internevo_tpu_torch.models.moe import gshard
    from internevo_tpu_torch.models.base import ModelConfig
    from internevo_tpu_torch.models.jax_bridge import opt_state_from_jax, params_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(num_layers=1, hidden_size=8, num_attention_heads=2, vocab_size=4)
    layer = {"norm1": np.ones((1, 8), np.float32)}
    tree = {"embedding": {"weight": np.zeros((4, 8), np.float32)}, "blocks": layer,
            "norm": np.ones(8, np.float32), "head": {"kernel": np.zeros((8, 4), np.float32)}}
    state = {"step": np.zeros((), np.int32), "master": tree, "m": tree, "v": tree}
    for make in (lambda: init_kv_cache(cfg, 1, 4), lambda: params_from_jax(tree),
                 lambda: opt_state_from_jax(state), lambda: gshard._gumbel((0, 1), (4, 2)),
                 lambda: gshard._uniform((0, 1), (4, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for draw in (jrandom.bits, jrandom.uniform, jrandom.bernoulli):
        with pytest.raises(TypeError, match="device"):
            draw((0, 1), shape=(4, 2))
    assert gshard._gumbel((0, 1), (4, 2), "cpu").device.type == "cpu"
    assert init_kv_cache(cfg, 1, 4, "cpu")["k"].device.type == "cpu"
    assert params_from_jax(tree, "cpu")["blocks"][0]["norm1"].device.type == "cpu"
    assert opt_state_from_jax(state, "cpu")["m"]["norm"].device.type == "cpu"


def test_cuda_request_does_not_fall_back(monkeypatch):
    from internevo_tpu_torch.core.config import Config
    from internevo_tpu_torch.train.pipeline import initialize_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(dict(model=dict(num_layers=1, hidden_size=64, num_attention_heads=2,
                                 vocab_size=32, dtype="torch.bfloat16")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_model(cfg, "cuda", torch.Generator())


def test_splash_wrapper_refuses_non_cpu_non_cuda():
    """The wrapper takes the plain version only for CPU tensors; any other
    device is refused, never quietly computed on the CPU."""
    q = torch.zeros(1, 64, 2, 64, device="meta")
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        splash.splash_attention(q, q, q)
    assert splash.launches == 0


def _refuse_plain(*_, **__):
    raise AssertionError("a plain version was reached for a CUDA tensor")


class _KernelReached(RuntimeError):
    pass


def _kernel_reached(*_, **__):
    raise _KernelReached


def test_cuda_grad_reaches_kernels_never_plain(monkeypatch):
    """Fake CUDA tensors (shapes and devices, no card): the splash forward,
    the backward of both autograd Functions -- what autograd runs for a CUDA
    tensor that needs a gradient -- the fused AdamW update, and gmm, tgmm and
    the grouped matmul's backward all go for their kernels' builds, which are
    stubbed to raise here; no plain version runs and no launch counts.  (A fake CUDA tensor cannot itself require
    grad on a CPU-only build: the autograd engine asks for a CUDA device
    guard; ``test_splash_functions_carry_the_graph`` shows on the CPU that
    the same Functions carry the graph.)"""
    monkeypatch.setattr(splash, "plain_forward", _refuse_plain)
    monkeypatch.setattr(splash, "plain_backward", _refuse_plain)
    monkeypatch.setattr(splash, "load", _kernel_reached)
    monkeypatch.setattr(fused_adamw, "plain_adamw_update_", _refuse_plain)
    monkeypatch.setattr(fused_adamw, "_kernel", _kernel_reached)
    monkeypatch.setattr(gmm, "plain_gmm", _refuse_plain)
    monkeypatch.setattr(gmm, "plain_tgmm", _refuse_plain)
    monkeypatch.setattr(gmm, "load", _kernel_reached)

    def counts():
        return (splash.launches, splash.launches_bwd_dkdv, splash.launches_bwd_dq, fused_adamw.launches,
                gmm.launches_gmm, gmm.launches_gmm_dgrad, gmm.launches_tgmm)

    before = counts()
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore")  # data_ptr of a fake tensor
        q = torch.empty(1, 64, 2, 64, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(1, 2, 64, device="cuda")
        with pytest.raises(_KernelReached):
            splash.splash_attention(q, q, q)
        static = (0.125, True, False, 0.0, None)
        ctx = SimpleNamespace(saved_tensors=(q, q, q, q, lse, None, None), static=static)
        with pytest.raises(_KernelReached):
            splash._Splash.backward(ctx, torch.empty_like(q))
        with pytest.raises(_KernelReached):
            splash._SplashWithLse.backward(ctx, torch.empty_like(q), torch.empty_like(lse))
        p = torch.empty(64, dtype=torch.bfloat16, device="cuda")
        f32 = torch.empty(64, device="cuda")
        with pytest.raises(_KernelReached):
            fused_adamw.fused_adamw_update_(f32, f32, f32, f32, p, torch.empty(9, device="cuda"))
        x = torch.empty(64, 16, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(4, 16, 32, dtype=torch.bfloat16, device="cuda")
        dy = torch.empty(64, 32, dtype=torch.bfloat16, device="cuda")
        group_sizes = torch.empty(4, dtype=torch.int64, device="cuda")
        with pytest.raises(_KernelReached):
            gmm.gmm(x, w, group_sizes)
        with pytest.raises(_KernelReached):
            gmm.gmm(dy, w, group_sizes, transpose_rhs=True)
        with pytest.raises(_KernelReached):
            gmm.tgmm(x, dy, group_sizes, 4)
        ctx = SimpleNamespace(saved_tensors=(x, w, group_sizes), needs_input_grad=(True, True, False))
        with pytest.raises(_KernelReached):
            gmm.GroupedMatmul.backward(ctx, dy)
        ctx.needs_input_grad = (False, True, False)  # the weight grad alone goes to tgmm
        with pytest.raises(_KernelReached):
            gmm.GroupedMatmul.backward(ctx, dy)
    assert counts() == before


def test_splash_functions_carry_the_graph():
    """A tensor that needs a gradient gets its backward from the splash
    autograd Functions, whose backward dispatches as above."""
    x = torch.zeros(1, 64, 2, 64, requires_grad=True)
    assert splash.splash_attention(x, x, x).grad_fn.name() == "_SplashBackward"
    assert splash.splash_attention_with_lse(x, x, x)[0].grad_fn.name() == "_SplashWithLseBackward"


def test_moe_layer_carries_the_grouped_matmul_graph():
    """The dropless layer's three expert products are ``GroupedMatmul``
    nodes, so their backward dispatches as above."""
    from internevo_tpu_torch.models.moe.dropless import dropless_moe_apply

    g = torch.Generator().manual_seed(0)
    layer = {"gate": torch.randn(16, 4, generator=g),
             "experts": {k: torch.randn(*s, generator=g, requires_grad=True)
                         for k, s in (("w1", (4, 16, 24)), ("w3", (4, 16, 24)), ("w2", (4, 24, 16)))}}
    out, _, _ = dropless_moe_apply(layer, torch.randn(1, 8, 16, generator=g), top_k=2)
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            stack.extend(f for f, _ in fn.next_functions)
    assert sum(fn.name() == "GroupedMatmulBackward" for fn in seen) == 3
