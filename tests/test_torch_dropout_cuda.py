"""The Triton residual-dropout kernel against its plain version, and
activation recompute through the kernels, on the card.

Needs an NVIDIA GPU with Triton and nvcc (the kernels have no CPU mode);
skips elsewhere.  On such a machine:

    python -m pytest --noconftest tests/test_torch_dropout_cuda.py -q

Bit for bit: the kernel computes the plain version's expression (JAX's
threefry bits of each element's index, the float32 uniform, the keep test,
the IEEE quotient by ``1 - rate`` in the tensor's dtype rounded once), and
the recompute runs the same kernels on the same inputs.
"""

import dataclasses

import pytest
import torch

from internevo_tpu_torch.core import random as tr
from internevo_tpu_torch.models import base as tbase
from internevo_tpu_torch.ops.cuda import dropout
from internevo_tpu_torch.ops.cuda import splash_attention as splash
from internevo_tpu_torch.solver.optimizer import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dropout kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("shape,dtype,rate", [((4096, 4096), torch.bfloat16, 0.1), ((3, 1000, 77), torch.bfloat16, 0.5),
                                              ((1025,), torch.float32, 0.3), ((17, 4096), torch.float16, 0.07),
                                              ((1,), torch.bfloat16, 0.9)])
def test_kernel_matches_plain(dev, shape, dtype, rate):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
    key = tr.fold_in(tr.rng(1024, "dropout"), len(shape))
    before = dropout.launches
    got = dropout.launch(x, key, rate)[0]
    torch.cuda.synchronize()
    assert dropout.launches == before + 1
    assert torch.equal(_bits(got), _bits(dropout.plain_dropout(x, key, rate)))


def test_function_backward_and_strided_input(dev):
    """Forward and backward through the autograd Function on a transposed
    (non-contiguous) view; the backward maps the grad with the same mask."""
    x = torch.randn(256, 384, device=dev).to(torch.bfloat16).t().requires_grad_()
    gy = torch.randn(384, 256, device=dev).to(torch.bfloat16)
    key = tr.PRNGKey(5)
    y = dropout.dropout(x, key, 0.2)
    y.backward(gy)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y.detach()), _bits(dropout.plain_dropout(x.detach(), key, 0.2)))
    assert torch.equal(_bits(x.grad), _bits(dropout.plain_dropout(gy, key, 0.2)))


@pytest.mark.parametrize("tier", [dict(), dict(remat_save_mlp=1.0), dict(remat_save_qkv=1.0),
                                  dict(activation_offload=True)], ids=["plain", "mlp", "qkv", "offload"])
def test_recompute_through_the_kernels(dev, tier):
    """Two bf16 layers of 2 heads of 128 with both dropouts: grads under
    ``checkpoint=1`` bit for bit those of ``checkpoint=0``, and one splash
    forward a layer either way."""
    cfg = tbase.ModelConfig(num_layers=2, hidden_size=256, num_attention_heads=2, vocab_size=512, mlp_ratio=2.0,
                            multiple_of=64, drop_rate=0.1, attn_drop_rate=0.1, qkv_bias=False, o_bias=False,
                            dtype=torch.bfloat16)
    params = tbase.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = tree_leaves(params)
    ids = torch.randint(0, 512, (1, 1000), device=dev)
    seg = (torch.arange(1000, device=dev) // 300).to(torch.int32)[None]
    pos = (torch.arange(1000, device=dev) % 300)[None]

    def grads(c):
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        before = splash.launches
        out = tbase.model_forward(c, params, ids, pos, seg, dropout_rng=tr.PRNGKey(3), train=True)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        return splash.launches - before, [p.grad.clone() for p in leaves]

    n0, want = grads(cfg)
    n1, got = grads(dataclasses.replace(cfg, checkpoint=1.0, **tier))
    assert n0 == n1 == cfg.num_layers
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
