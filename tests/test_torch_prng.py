"""The port's threefry PRNG against jax.random: key words, uniform bits
and sampled ids must be equal exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402

SEEDS = [0, 1, 11, 12345, 2**31 - 1, -3]
SHAPES = [(1,), (7,), (3, 5), (1000,)]


def _words(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(_words(kj), kt.numpy())
    for data in (0, 1, 0x0C10, 2**32 - 1):
        np.testing.assert_array_equal(_words(jax.random.fold_in(kj, data)),
                                      prng.fold_in(kt, data).numpy())
    for num in (2, 3, 8):
        np.testing.assert_array_equal(_words(jax.random.split(kj, num)),
                                      prng.split(kt, num).numpy())
    # batched keys: one split per row, as jax.vmap(jax.random.split)
    kjs = jax.random.split(kj, 4)
    np.testing.assert_array_equal(
        _words(jax.vmap(jax.random.split)(kjs)),
        prng.split(torch.from_numpy(_words(kjs)), 2).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1e-12, 1.0), (-2.5, 3.7)])
def test_uniform_float32_bits(shape, bounds):
    for seed in SEEDS:
        a = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                          jnp.float32, *bounds))
        b = prng.uniform(prng.PRNGKey(seed, "cpu"), shape, *bounds).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("B,V", [(1, 2), (4, 512), (3, 1000), (2, 50257)])
def test_categorical_ids(B, V):
    rng = np.random.default_rng(B * V)
    for seed in SEEDS[:4]:
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(seed), B)
        a = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                        jnp.asarray(logits)))
        b = prng.categorical(torch.from_numpy(_words(keys)),
                             torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES + [(2, 8)])
@pytest.mark.parametrize("lo,hi", [(0, 512), (3, 151936), (-5, 5), (0, 1)])
def test_randint_ids(shape, lo, hi):
    for seed in SEEDS:
        a = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                          lo, hi))
        b = prng.randint(prng.PRNGKey(seed, "cpu"), shape, lo, hi).numpy()
        np.testing.assert_array_equal(a, b)
