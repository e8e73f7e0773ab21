"""The port's threefry (``internevo_tpu_torch/core/random.py``) against
``jax.random`` on the CPU, bit for bit: keys from seeds, ``fold_in``,
``split``, ``bits`` (0-d, odd and large shapes), ``uniform`` and
``bernoulli``, and the named streams of ``gpc.rng``.  jax 0.9.0 with
``jax_threefry_partitionable`` on, as the JAX package runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internevo_tpu_torch.core import random as tr

SEEDS = [0, 1, 1024, 2**31 - 1, -5]
SHAPES = [(), (1,), (3, 5), (7, 1, 3), (1025,)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: these tests run many tiny ops, and with
    the suite's parallel workers sharing the cores an op's thread barrier
    costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(a) -> tuple:
    return tuple(int(x) for x in np.asarray(a))


def test_partitionable_threefry_is_on():
    """The layout the port reproduces: each element's counter is its
    logical index."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [2**40 + 5])
def test_keys_fold_in_and_split(seed):
    jk = jax.random.PRNGKey(seed)
    assert tr.PRNGKey(seed) == _key(jk)
    for d in (0, 7, 2**31, 2**32 - 1):
        assert tr.fold_in(tr.PRNGKey(seed), d) == _key(jax.random.fold_in(jk, np.uint32(d)))
    assert tr.split(tr.PRNGKey(seed), 5) == [_key(k) for k in jax.random.split(jk, 5)]
    assert tr.split(tr.PRNGKey(seed)) == [_key(k) for k in jax.random.split(jk)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = tr.fold_in(tr.PRNGKey(seed), 3)
    jb = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32)).astype(np.int64)
    tb = tr.bits(tk, shape, device="cpu").numpy()
    assert tb.shape == jb.shape and np.array_equal(tb, jb)
    assert tr.bits_scalar(tk) == int(np.asarray(jax.random.bits(jk, dtype=jnp.uint32)))
    assert tr.uniform(tk, shape, device="cpu").numpy().tobytes() == np.asarray(jax.random.uniform(jk, shape)).tobytes()
    ju = np.asarray(jax.random.uniform(jk, shape, minval=-2.5, maxval=3.1))
    assert tr.uniform(tk, shape, -2.5, 3.1, device="cpu").numpy().tobytes() == ju.tobytes()
    for p in (0.1, 0.5, 1.0 - 0.1, 0.123456):
        np.testing.assert_array_equal(tr.bernoulli(tk, p, shape, device="cpu").numpy(),
                                      np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_bits_past_2_pow_24_elements():
    """A draw larger than 2**24 elements (the index words past float
    precision), made in chunks."""
    shape = (4097, 4097)
    jk = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(tr.bits(tr.PRNGKey(11), shape, device="cpu").numpy(),
                                  np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("seed,name", [(1024, "dropout"), (7, "dropout"), (1024, "init"), (0, "")])
def test_named_streams_match_gpc_rng(seed, name):
    from internevo_tpu.core.context import gpc

    gpc.set_seed(seed)
    assert tr.rng(seed, name) == _key(gpc.rng(name))
