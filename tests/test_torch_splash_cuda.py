"""The CUDA splash kernels, forward and backward, against their plain
versions, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernel has no CPU mode); skips
elsewhere.  On such a machine:

    python -m pytest --noconftest tests/test_torch_splash_cuda.py -q

(``--noconftest``: the repo's conftest imports jax, which such a machine need
not have.)

Tolerance: out within rtol = atol = 1.6e-2 (bf16 probabilities rounded at
different points, then out rounded once), lse within 1e-4 (fp32 in both,
summed in another order);
dq, dk, dv within rtol = atol = 1.6e-2 (both round P∘drop and dS to bf16 at
the same points, from fp32 scores summed in another order, then round the
grads once).
"""

import numpy as np
import pytest
import torch

from internevo_tpu_torch.ops.cuda import splash_attention as splash

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the splash kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, B, S, Hq, Hkv, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    rng = np.random.RandomState(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        p, sid = 0, 1
        while p < S - 17:
            n = min(rng.randint(10, 200), S - 17 - p)
            seg[b, p:p + n], p, sid = sid, p + n, sid + 1
    return q, k, v, torch.from_numpy(seg).to(dev)


def _runs_across_tiles(B, S):
    """Segment runs whose boundaries fall at many offsets inside the
    kernels' 64- and 128-row tiles (1, 2, 63, 64, 65, 127, ... rows in),
    with runs long enough that most tile pairs need no mask: the kernels'
    unmasked path meets the masked one at every boundary."""
    lengths = (193, 257, 65, 130, 301, 2, 127, 448, 63, 191)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        p, i = 0, b
        while p < S:
            n = lengths[i % len(lengths)]
            seg[b, p:p + n], p, i = i + 1, p + n, i + 1
    return seg


def _chunk_scaled(t, scales):
    """t with each 64-column chunk of its head dim scaled by its own factor."""
    f = torch.tensor(scales, device=t.device).repeat_interleave(64)
    return (t.float() * f).to(t.dtype)


@pytest.mark.parametrize("S,Hq,Hkv,D,cross,drop,causal,variant", [
    (512, 4, 4, 128, False, 0.0, True, None),
    (333, 4, 2, 128, False, 0.0, True, None),
    (256, 4, 1, 64, False, 0.0, True, None),
    (384, 2, 2, 128, True, 0.0, True, None),
    (384, 4, 2, 64, False, 0.2, True, None),
    (300, 2, 2, 128, False, 0.0, False, None),
    # S no multiple of the 128-row q item: ragged last items, and at 4000 (31
    # items and 32 rows) one whose second 64-row consumer lies wholly past S
    (200, 2, 2, 64, False, 0.0, True, None),
    (4000, 2, 1, 128, False, 0.0, True, None),
    # run boundaries at many offsets inside 64- and 128-row tiles
    (2048, 4, 2, 128, False, 0.0, True, "runs"),
    (1111, 4, 1, 64, False, 0.0, True, "runs"),
    # GQA 4 with dropout, at D = 64 and D = 128
    (320, 8, 2, 64, False, 0.1, True, None),
    (333, 8, 2, 128, False, 0.1, True, "runs"),
    # each 64-column chunk of Q, K and V its own scale: a swapped LBO / SBO
    # of V's MN-major descriptor or a wrong chunk of the K-major ones mixes
    # the chunks
    (512, 2, 2, 128, False, 0.0, True, "chunks"),
    # inputs that are not symmetric in the tile: q and k grow along the
    # sequence, v along the head dim, so a permutation of P's columns in the
    # register fragments moves out
    (512, 2, 2, 128, False, 0.0, True, "ramp"),
    (512, 4, 2, 64, False, 0.2, False, "ramp"),
    # no causal mask, and a rotated kv chunk, at D = 128 over many tiles
    (1111, 4, 2, 128, False, 0.0, False, "runs"),
    (1111, 4, 2, 128, True, 0.0, True, "runs"),
])
def test_kernel_matches_plain(dev, S, Hq, Hkv, D, cross, drop, causal, variant):
    q, k, v, seg = _inputs(dev, 2, S, Hq, Hkv, D)
    if variant == "runs":
        seg = torch.from_numpy(_runs_across_tiles(2, S)).to(dev)
    elif variant == "chunks":
        q, k, v = _chunk_scaled(q, [1.0, 0.25]), _chunk_scaled(k, [0.5, 2.0]), _chunk_scaled(v, [3.0, 0.5])
    elif variant == "ramp":
        ramp = torch.linspace(0.2, 1.8, S, device=dev)[None, :, None, None]
        q, k = (q.float() * ramp).to(torch.bfloat16), (k.float() * ramp.flip(1)).to(torch.bfloat16)
        v = (v.float() * torch.linspace(0.1, 2.0, D, device=dev)).to(torch.bfloat16)
    kv_seg = torch.roll(seg, S // 3, dims=1) if cross else None
    seed = [5, 0, 0, 0, 0] if drop else None
    before = splash.launches
    out, lse = splash.splash_attention_with_lse(q, k, v, seg, kv_seg, causal=causal,
                                                dropout_rate=drop, dropout_seed=seed)
    torch.cuda.synchronize()
    assert splash.launches == before + 1
    ref_out, ref_lse = splash.plain_forward(q, k, v, seg, kv_seg, None, causal, drop, seed)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = ~torch.isneginf(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], rtol=0, atol=1e-4)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=1.6e-2, atol=1.6e-2)


def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v, seg = _inputs(dev, 1, 128, 2, 2, 128)
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        splash.splash_attention(q.double(), k.double(), v.double(), seg)
    with pytest.raises(TypeError, match="of one dtype"):
        splash.splash_attention(q.half(), k, v, seg)
    with pytest.raises(ValueError, match="head_dim"):
        splash.splash_attention(q[..., :100].contiguous(), k[..., :100].contiguous(),
                                v[..., :100].contiguous(), seg)
    big = torch.zeros(1, 128, 2, 136, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        splash.splash_attention(big, big, big, seg)
    with pytest.raises(ValueError, match="contiguous"):
        splash.splash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, seg)


@pytest.mark.parametrize("S,Hq,Hkv,D,cross,drop,causal,variant", [
    (512, 4, 4, 128, False, 0.0, True, None),
    (333, 4, 2, 128, False, 0.0, True, None),
    (256, 4, 1, 64, False, 0.0, True, None),
    (384, 2, 2, 128, True, 0.0, True, None),
    (384, 4, 2, 64, False, 0.2, True, None),
    (300, 2, 2, 128, False, 0.0, False, None),
    # S no multiple of 128, and one 96 short of 4096 (its last kv item
    # half empty, its last q tile ragged)
    (4000, 2, 1, 128, False, 0.0, True, None),
    (200, 2, 2, 64, False, 0.0, True, None),
    # run boundaries at many offsets inside 64- and 128-row tiles
    (2048, 4, 2, 128, False, 0.0, True, "runs"),
    (1111, 4, 1, 64, False, 0.0, True, "runs"),
    # GQA 4 at D = 64; dropout with GQA 4
    (320, 8, 2, 64, False, 0.0, True, None),
    (333, 8, 2, 128, False, 0.1, True, "runs"),
    # each 64-column chunk of Q, dO and K its own scale: a swapped LBO / SBO
    # of the MN-major descriptors or a wrong chunk of the K-major ones mixes
    # the chunks
    (512, 2, 2, 128, False, 0.0, True, "chunks"),
    # inputs that are not symmetric in the tile: q and k grow along the
    # sequence, dO along the head dim, so a permutation of P's or dS's
    # columns in the register fragments moves the grads
    (512, 2, 2, 128, False, 0.0, True, "ramp"),
    (512, 4, 2, 64, False, 0.2, False, "ramp"),
])
def test_backward_kernels_match_plain(dev, S, Hq, Hkv, D, cross, drop, causal, variant):
    """Through autograd (splash_attention_with_lse, dlse included): each
    backward kernel launches once, and dq/dk/dv match plain_backward."""
    q, k, v, seg = _inputs(dev, 2, S, Hq, Hkv, D, seed=1)
    if variant == "runs":
        seg = torch.from_numpy(_runs_across_tiles(2, S)).to(dev)
    elif variant == "chunks":
        q, k = _chunk_scaled(q, [1.0, 0.25]), _chunk_scaled(k, [0.5, 2.0])
    elif variant == "ramp":
        ramp = torch.linspace(0.2, 1.8, S, device=dev)[None, :, None, None]
        q, k = (q.float() * ramp).to(torch.bfloat16), (k.float() * ramp.flip(1)).to(torch.bfloat16)
    kv_seg = torch.roll(seg, S // 3, dims=1) if cross else None
    seed = [5, 0, 0, 0, 0] if drop else None
    g = torch.Generator(device=dev).manual_seed(2)
    do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    if variant == "chunks":
        do = _chunk_scaled(do, [3.0, 0.5])
    elif variant == "ramp":
        do = (do.float() * torch.linspace(0.1, 2.0, D, device=dev)).to(torch.bfloat16)
    dlse = torch.randn(2, Hq, S, generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (splash.launches_bwd_dkdv, splash.launches_bwd_dq)
    out, lse = splash.splash_attention_with_lse(*leaves, seg, kv_seg, causal=causal,
                                                dropout_rate=drop, dropout_seed=seed)
    lse_ok = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    torch.autograd.backward([out, lse_ok], [do, dlse])
    torch.cuda.synchronize()
    assert (splash.launches_bwd_dkdv, splash.launches_bwd_dq) == (before[0] + 1, before[1] + 1)
    ref = splash.plain_backward(q, k, v, out.detach(), lse.detach(), do,
                                torch.where(torch.isneginf(lse.detach()), 0.0, dlse), seg, kv_seg,
                                None, causal, drop, splash._norm_seed(seed) if drop else None)
    for name, got, want in zip(("dq", "dk", "dv"), (t.grad for t in leaves), ref):
        assert torch.isfinite(got.float()).all(), name
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1.6e-2, msg=name)


def test_backward_is_deterministic(dev):
    q, k, v, seg = _inputs(dev, 1, 1024, 4, 2, 128, seed=3)
    out, lse = splash.splash_attention_with_lse(q, k, v, seg)
    do = torch.ones_like(q)
    a = splash._kernel_backward(q, k, v, out, lse, do, None, seg, None, 128**-0.5, True, False, 0.0, None)
    b = splash._kernel_backward(q, k, v, out, lse, do, None, seg, None, 128**-0.5, True, False, 0.0, None)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
