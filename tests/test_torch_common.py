"""The port's flops accounting against the JAX package's, and its GPU peak
table."""

import pytest

from internevo_tpu.utils.common import get_megatron_flops as jax_flops
from internevo_tpu_torch.utils.common import device_peak_tflops, get_megatron_flops


@pytest.mark.parametrize("kw", [
    dict(seq_len=4096, hidden_size=4096, num_layers=32, vocab_size=103168, global_batch_size=2,
         mlp_ratio=8 / 3),
    dict(checkpoint=True, seq_len=2048, hidden_size=2048, num_layers=12, vocab_size=50304,
         global_batch_size=4, global_world_size=4, use_swiglu=False),
], ids=["7b_scoring", "700m_ckpt_4dev"])
def test_megatron_flops_matches_jax(kw):
    assert get_megatron_flops(0.35, **kw) == jax_flops(0.35, **kw)


def test_device_peak_table():
    assert device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    with pytest.raises(KeyError, match="no bf16 peak"):
        device_peak_tflops("NVIDIA A100-SXM4-80GB")


def test_device_bandwidth_table():
    from internevo_tpu_torch.utils.common import device_peak_bandwidth

    assert device_peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no memory bandwidth"):
        device_peak_bandwidth("NVIDIA A100-SXM4-80GB")
