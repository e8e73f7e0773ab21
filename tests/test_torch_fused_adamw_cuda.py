"""The Triton fused AdamW kernel against its plain version, on the card.

Needs an NVIDIA GPU with Triton (the kernel has no CPU mode); skips
elsewhere.  On such a machine:

    python -m pytest --noconftest tests/test_torch_fused_adamw_cuda.py -q

Tolerance: m, v and master within 1e-6 of each tensor's largest magnitude
(the same fp32 expression; the kernel's compiler contracts multiply-adds),
the param exactly the cast of the kernel's master to its own dtype (bf16 or
fp32) and within one bf16 ulp of the plain param plus that master bound.
"""

import pytest
import torch

from internevo_tpu_torch.ops.cuda import fused_adamw

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused AdamW kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,gdtype,skip,pdtype", [(4096, torch.float32, 0.0, torch.bfloat16),
                                                  (1000003, torch.float32, 0.0, torch.bfloat16),
                                                  (77777, torch.bfloat16, 0.0, torch.bfloat16),
                                                  (4096, torch.float32, 1.0, torch.bfloat16),
                                                  (4099, torch.float32, 0.0, torch.float32)])
def test_kernel_matches_plain(dev, n, gdtype, skip, pdtype):
    g = torch.Generator(device=dev).manual_seed(n)
    grad = torch.randn(n, generator=g, device=dev).to(gdtype)
    m = torch.randn(n, generator=g, device=dev) * 0.1
    v = torch.rand(n, generator=g, device=dev) * 0.01
    w = torch.randn(n, generator=g, device=dev)
    p = w.to(pdtype)
    sc = fused_adamw.adamw_scalars(1e-3, 0.9, 0.95, 1 - 0.9**3, 1 - 0.95**3, 1e-8, 0.01, 0.7, skip, dev)
    ref = [t.clone() for t in (m, v, w, p)]
    before = fused_adamw.launches
    fused_adamw.fused_adamw_update_(grad, m, v, w, p, sc)
    torch.cuda.synchronize()
    assert fused_adamw.launches == before + 1
    fused_adamw.plain_adamw_update_(grad, *ref, sc)
    for name, got, want in zip(("m", "v", "master"), (m, v, w), ref):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max(), name
    assert torch.equal(p, w.to(pdtype))
    want = ref[3].float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert ((p.float() - want).abs() <= ulp + 1e-6 * ref[2].abs().max()).all()
    if skip:
        assert torch.equal(w, ref[2]) and torch.equal(p, w.to(pdtype))
