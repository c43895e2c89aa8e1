"""Parity of the port's threefry PRNG with `jax.random`.

The JAX side runs under `jax.threefry_partitionable(False)`: the
non-partitionable counter layout that the port implements (and that
jax 0.4.x uses by default).  The flag acts when JAX traces, so every JAX
call here is made inside the context.

Tiers:
  * keys, fold_in, split and the raw uint32 bits: BITWISE;
  * normals: within 2 ulp (the port evaluates XLA's erf_inv and log
    polynomials with emulated fused multiply-adds; a double rounding can
    move the last bit — about 2e-5 of draws differ at all).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as prng

SEEDS = [0, 7, 123456, 2**31 - 1]


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        kt = prng.PRNGKey(seed)
        np.testing.assert_array_equal(_u32(k), kt.numpy())
        for data in (0, 1, 0x5EED, 0x6A66, 2**32 - 1):
            np.testing.assert_array_equal(
                _u32(jax.random.fold_in(k, data)),
                prng.fold_in(kt, data).numpy())
        for num in (2, 3):
            np.testing.assert_array_equal(_u32(jax.random.split(k, num)),
                                          prng.split(kt, num).numpy())


def test_batched_fold_in_matches_per_key():
    keys = torch.stack([prng.PRNGKey(s) for s in SEEDS])
    data = torch.tensor([3, 0, 9, 2**32 - 1])
    got = prng.fold_in(keys, data)
    for i, s in enumerate(SEEDS):
        np.testing.assert_array_equal(
            got[i].numpy(),
            prng.fold_in(prng.PRNGKey(s), int(data[i])).numpy())


@pytest.mark.parametrize("n", [1, 7, 192, 1001, 6144])
def test_bits_bitwise(n):
    with jax.threefry_partitionable(False):
        for seed in SEEDS[:2]:
            k = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EED)
            kt = prng.fold_in(prng.PRNGKey(seed), 0x5EED)
            np.testing.assert_array_equal(_u32(jax.random.bits(k, (n,))),
                                          prng.random_bits(kt, (n,)).numpy())


@pytest.mark.parametrize("shape", [(7,), (3, 5), (1, 2, 8, 8, 3),
                                   (400_000,)])
def test_normal_within_2_ulp(shape):
    with jax.threefry_partitionable(False):
        for seed in SEEDS[:2]:
            k = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
            want = np.asarray(jax.random.normal(k, shape))
            got = prng.normal(prng.fold_in(prng.PRNGKey(seed), 5), shape)
            assert got.shape == want.shape and got.dtype == torch.float32
            assert _ulp(want, got.numpy()).max() <= 2


def test_erf_inv_and_log1p_track_xla():
    x = np.linspace(-0.9999, 0.9999, 200_001).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    assert _ulp(want, got).max() <= 2
    a = -(x * x)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jnp.log1p)(jnp.asarray(a)))[np.abs(a) < 0.4142],
        prng.log1p_f32(torch.from_numpy(a)).numpy()[np.abs(a) < 0.4142])


def test_int32_key_words_round_trip():
    k = torch.tensor([[0, 2**32 - 1], [2**31, 5]])
    w = prng.to_int32_bits(k)
    assert w.dtype == torch.int32 and w[0, 1] == -1 and w[1, 0] == -2**31
    np.testing.assert_array_equal(prng.from_int32_bits(w).numpy(), k.numpy())


def test_seed_out_of_int32_range_raises():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**31)
