"""The port's threefry key chain (``rivslam_tpu_torch/core/prng.py``)
against ``jax.random`` on the CPU, bit for bit: ``key``, ``split``,
``fold_in``, ``split_chain`` (against the reference Engine's
``_split_chain``) and ``uniform`` in float32 and float64.

The conftest turns ``jax_enable_x64`` on, under which ``jax.random.uniform``
draws float64 by default; every draw here names its dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared_cache import release_xla_executables  # noqa: F401  (and one torch thread a process)

from rivslam_tpu import pipeline as ref_pipeline
from rivslam_tpu_torch.core import prng

SEEDS = (0, 1, 2, 2**31 - 1, 2**40 + 12345)
DTYPES = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}


def _words(jax_key) -> tuple:
    """A JAX key's two words as Python ints."""
    return tuple(int(w) for w in np.asarray(jax.random.key_data(jax_key)))


def test_jax_uses_the_partitionable_scheme():
    """The port reproduces the partitionable threefry scheme; a JAX whose
    default scheme differs fails here first."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    assert prng.key(seed) == _words(jax.random.key(seed))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_split_matches_jax(n):
    for seed in SEEDS:
        want = [_words(k) for k in jax.random.split(jax.random.key(seed), n)]
        assert list(prng.split(prng.key(seed), n)) == want


def test_fold_in_matches_jax():
    for seed in SEEDS:
        base = jax.random.key(seed)
        for b in range(5):
            assert prng.fold_in(prng.key(seed), b) == _words(jax.random.fold_in(base, b))


def test_split_chain_matches_reference_engine():
    """The reference Engine's per-frame chain (one lax.scan of splits)."""
    for seed in (0, 7):
        key, subkeys = ref_pipeline._split_chain(jax.random.key(seed), 5)
        got_key, got = prng.split_chain(prng.key(seed), 5)
        assert got_key == _words(key)
        assert got == [_words(k) for k in subkeys]


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(3, 256), (128, 256), (128, 1024)])
def test_uniform_matches_jax(kind, shape):
    tdt, jdt = DTYPES[kind]
    for seed in (0, 3):
        _, k1 = jax.random.split(jax.random.key(seed))
        want = np.asarray(jax.random.uniform(k1, shape, dtype=jdt))
        got = prng.uniform(prng.split(prng.key(seed))[1], shape, tdt).numpy()
        assert got.dtype == want.dtype and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_uniform_stack_is_one_draw_per_key(kind):
    """The replay's batched draw: row f is frame f's subkey's draw."""
    tdt, jdt = DTYPES[kind]
    _, subkeys = prng.split_chain(prng.key(0), 3)
    got = prng.uniform_stack(subkeys, (128, 256), tdt).numpy()
    _, jax_keys = ref_pipeline._split_chain(jax.random.key(0), 3)
    for f in range(3):
        want = np.asarray(jax.random.uniform(jax_keys[f], (128, 256), dtype=jdt))
        np.testing.assert_array_equal(got[f].view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_reve_draw_is_the_floor_draws_first_rows(kind):
    """REVE's [3, n] draw of a frame's key is the first three rows of the
    floor detector's [128, n] draw of the same key, in JAX and in the port:
    one draw a frame serves both."""
    tdt, jdt = DTYPES[kind]
    k1 = jax.random.split(jax.random.key(0))[1]
    reve = np.asarray(jax.random.uniform(k1, (3, 1024), dtype=jdt))
    floor = np.asarray(jax.random.uniform(k1, (128, 1024), dtype=jdt))
    np.testing.assert_array_equal(reve, floor[:3])
    got = prng.uniform(_words(k1), (128, 1024), tdt).numpy()
    np.testing.assert_array_equal(got[:3].view(np.uint8), reve.view(np.uint8))


def test_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        prng.key(2**64)
    with pytest.raises(ValueError):
        prng.fold_in(prng.key(0), -1)
    with pytest.raises(ValueError):
        prng.uniform(prng.key(0), (2, 2), torch.float16)
