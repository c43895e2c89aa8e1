"""The probability-flow likelihood of the port against the JAX package's,
on the CPU (paper App. C.8: `log_likelihood`, exact divergence and
Hutchinson, `cld_nll_bound`).

Tiers:
  * bitwise: the Rademacher probes (the same key gives the same bits);
  * log-likelihoods within 1e-4 relative (plus 1e-4 absolute) of the JAX
    package's on the same exact-score oracle, key and grid: f32 Heun
    steps whose scores and divergences differ in the last bits (the port
    takes the divergence by reverse-mode products, JAX by forward-mode);
  * the JAX test's own check (`tests/test_general_sde_likelihood.py`):
    the VPSDE Gaussian's flow NLL within rtol 1e-2, atol 5e-2 of the
    closed form, and the Hutchinson mean within 5e-2 / 0.1 of the exact.
The CLD instances use `grid_substeps=1` (both packages): its R_t grid
solve costs ~9 s an instance at the default 8.  The JAX side draws under
`jax.threefry_partitionable(False)` (F1) and runs jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sde as jsde
from repro.core.likelihood import cld_nll_bound as jcld_nll_bound
from repro.core.likelihood import log_likelihood as jlog_likelihood
import repro_torch.sde as tsde
from repro_torch import random as prng
from repro_torch.core.likelihood import cld_nll_bound, log_likelihood

NOPART = jax.threefry_partitionable(False)


def close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the likelihood
# ---------------------------------------------------------------------------
def vpsde_oracles(mean, std):
    mix = lambda m: m.GaussianMixture(np.array([mean]), np.array([std]),
                                      np.array([1.0]))
    jv, tv = jsde.VPSDE(), tsde.VPSDE()
    jo, to = jsde.ExactScore(jv, mix(jsde)), tsde.ExactScore(tv, mix(tsde))
    return (jv, lambda u, t: jo.score(u, t)), (tv, lambda u, t: to.score(u, t))


X3 = np.array([[0.2, -0.4], [0.5, 0.0], [-0.1, -0.7]], np.float32)


@pytest.mark.parametrize("hutchinson", [False, True])
def test_log_likelihood_against_jax(hutchinson):
    (jv, jscore), (tv, tscore) = vpsde_oracles([0.2, -0.4], 0.3)
    with NOPART:
        ref = jax.jit(lambda x, key: jlog_likelihood(
            jv, jscore, x, n_steps=6, hutchinson=hutchinson, key=key))(
                jnp.asarray(X3), jax.random.PRNGKey(4))
    ours = log_likelihood(tv, tscore, torch.from_numpy(X3), n_steps=6,
                          hutchinson=hutchinson, key=prng.PRNGKey(4))
    assert ours.dtype == torch.float32 and ours.shape == (3,)
    close(ours.numpy(), ref)


def test_rademacher_probes_are_jax_bits():
    with NOPART:
        key, sub = jax.random.split(jax.random.PRNGKey(4))
        ref = jax.random.rademacher(sub, (3, 2), jnp.float32)
    key, sub = prng.split(prng.PRNGKey(4))
    np.testing.assert_array_equal(prng.rademacher(sub, (3, 2)).numpy(),
                                  np.asarray(ref))


def test_vpsde_gaussian_exact():
    """The JAX test's closed-form check, on the port: a single Gaussian's
    flow NLL equals its log-density at the SDE-smoothed time t_min."""
    _, (tv, tscore) = vpsde_oracles([0.2, -0.4], 0.3)
    ll = log_likelihood(tv, tscore, torch.from_numpy(X3), n_steps=150)
    a = tv.alpha(tv.t_min)
    var = a * 0.3 ** 2 + (1 - a)
    d = X3 - np.sqrt(a) * np.array([0.2, -0.4])
    ref = -0.5 * (d ** 2).sum(-1) / var - np.log(2 * np.pi * var)
    np.testing.assert_allclose(ll.numpy(), ref, rtol=1e-2, atol=5e-2)


def test_hutchinson_matches_exact():
    """The JAX test's claim (16 probe keys), at 30 Heun steps where it
    takes 100 (both estimates on the same grid)."""
    _, (tv, tscore) = vpsde_oracles([0.0, 0.0], 0.5)
    x = torch.tensor([[0.1, 0.2]])
    exact = log_likelihood(tv, tscore, x, n_steps=30)
    keys = prng.split(prng.PRNGKey(0), 16)
    hut = torch.stack([log_likelihood(tv, tscore, x, n_steps=30,
                                      hutchinson=True, key=k)
                       for k in keys]).mean(0)
    np.testing.assert_allclose(hut.numpy(), exact.numpy(), rtol=5e-2,
                               atol=0.1)


def test_cld_nll_bound_against_jax():
    """The App. C.8 bound on a small CLD state (2-D data, so the exact
    divergence), two velocity draws, against the JAX package's."""
    jc, tc = jsde.CLD(grid_substeps=1), tsde.CLD(grid_substeps=1)
    mix = lambda m: m.GaussianMixture(np.array([[0.3, -0.2]]),
                                      np.array([0.2]), np.array([1.0]))
    jo, to = jsde.ExactScore(jc, mix(jsde)), tsde.ExactScore(tc, mix(tsde))
    x = np.array([[0.3, -0.1], [0.0, 0.2]], np.float32)
    with NOPART:
        ref = jax.jit(lambda x, key: jcld_nll_bound(
            jc, lambda u, t: jo.score(u, t), x, key, n_v=2, n_steps=5))(
                jnp.asarray(x), jax.random.PRNGKey(1))
    ours = cld_nll_bound(tc, lambda u, t: to.score(u, t), torch.from_numpy(x),
                         prng.PRNGKey(1), n_v=2, n_steps=5)
    assert torch.isfinite(ours).all() and ours.shape == (2,)
    close(ours.numpy(), ref)
    hut = cld_nll_bound(tc, lambda u, t: to.score(u, t), torch.from_numpy(x),
                        prng.PRNGKey(1), n_v=2, n_steps=5, hutchinson=True)
    assert torch.isfinite(hut).all() and hut.shape == (2,)
