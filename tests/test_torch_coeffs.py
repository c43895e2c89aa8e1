"""Parity of the port's Stage-I pipeline and serving bank with the JAX
package (CLD).

Tier: BITWISE.  Stage I is the same float64 numpy arithmetic in both
packages and the float32 leaves are the same round-to-nearest casts, so
every SamplerCoeffs table and every FactoredBank leaf must be equal bit for
bit.  The CLD grid solve runs with `grid_substeps=1` in both packages (the
same code path at an eighth of the cost) to keep the test to seconds.
"""
import functools

import numpy as np
import pytest

import repro.core as jcore
import repro.sde as jsde
import repro_torch.core as tcore
import repro_torch.sde as tsde

SHAPE = (4, 4, 3)
# q 1/2, corrector, lambda 0/0.5, and the three algorithms
MENU = [dict(nfe=4), dict(nfe=4, q=2), dict(nfe=4, q=2, corrector=True),
        dict(nfe=4, corrector=True), dict(nfe=5, lam=0.5),
        dict(nfe=5, lam=0.5, algorithm="gmm"), dict(nfe=4, algorithm="accel")]


def memoized(sde):
    """Cache the reference SDE's float64 closed forms per argument.  They
    are pure functions of their float arguments, so every value (and so
    every Stage-I table) is unchanged bit for bit; the quadrature just stops
    recomputing the same matrix exponentials, which keeps this test to
    seconds."""
    for name in ("Psi_np", "Sigma_np", "R_np"):
        setattr(sde, name, functools.lru_cache(maxsize=None)(
            getattr(sde, name)))
    return sde


@pytest.fixture(scope="module")
def caches():
    jc = jcore.CoeffCache(memoized(jsde.CLD(grid_substeps=1)),
                          data_shape=SHAPE)
    tc = tcore.CoeffCache(tsde.CLD(grid_substeps=1), data_shape=SHAPE)
    for kw in MENU:
        assert jc.index_of(jcore.SamplerConfig(**kw)) == \
            tc.index_of(tcore.SamplerConfig(**kw))
    return jc, tc


def test_stage1_tables_bitwise(caches):
    jc, tc = caches
    for kw in MENU:
        a = jc.get(jcore.SamplerConfig(**kw))
        b = tc.get(tcore.SamplerConfig(**kw))
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if name == "lam":
                assert x == y
                continue
            np.testing.assert_array_equal(
                np.asarray(x), y.numpy(), err_msg=f"{kw} {name}")


def test_factored_bank_leaves_bitwise(caches):
    jc, tc = caches
    jb, tb = jc.factored_bank, tc.factored_bank
    assert jb.shape_key == tb.shape_key
    for name in jb._fields:
        x, y = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert jc.bank_restack_rows == tc.bank_restack_rows


@pytest.mark.parametrize("n,minimum,want", [(1, 4, 4), (5, 4, 8), (9, 8, 16),
                                            (2, 2, 2), (3, 1, 4)])
def test_bucket_size(n, minimum, want):
    assert tcore.bucket_size(n, minimum) == want == \
        jcore.bucket_size(n, minimum)


def test_time_grid_and_effective_q():
    sde_j, sde_t = jsde.CLD(), tsde.CLD()
    for kind in ("quadratic", "uniform"):
        np.testing.assert_array_equal(jcore.time_grid(sde_j, 7, kind),
                                      tcore.time_grid(sde_t, 7, kind))
    for kw in MENU:
        assert jcore.effective_q(jcore.SamplerConfig(**kw)) == \
            tcore.effective_q(tcore.SamplerConfig(**kw))


@pytest.mark.parametrize("kw", [dict(nfe=0), dict(nfe=4, q=2, lam=0.5),
                                dict(nfe=4, algorithm="gmm"),
                                dict(nfe=4, algorithm="accel", q=2),
                                dict(nfe=4, algorithm="nope")])
def test_sampler_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jcore.SamplerConfig(**kw)
    with pytest.raises(ValueError):
        tcore.SamplerConfig(**kw)


def test_cld_closed_forms_bitwise(caches):
    """Host float64 CLD objects (Psi, Sigma, R on its grid, Cholesky L):
    the same numpy/scipy arithmetic, bit for bit."""
    js, ts = caches[0].sdes["cld"], caches[1].sdes["cld"]
    for t in (1e-4, 2e-3, 0.1, 0.37, 1.0):
        for name in ("Sigma_np", "R_np", "L_np"):
            np.testing.assert_array_equal(getattr(js, name)(t),
                                          getattr(ts, name)(t), err_msg=name)
        np.testing.assert_array_equal(js.Psi_np(t, 0.5 * t),
                                      ts.Psi_np(t, 0.5 * t))


def test_cld_device_side_matches_jax(caches):
    """apply / apply_factored / canonical layout / prior on CPU tensors.
    Tier: rtol = atol = 1e-6 for the 2x2 contractions (the JAX einsum is a
    dot_general, one rounding apart); the prior within 1e-5 (its normals
    are within 2 ulp, then one 2x2 apply)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro_torch import random as prng
    js, ts = caches[0].sdes["cld"], caches[1].sdes["cld"]
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, 2) + SHAPE).astype(np.float32)
    c = rng.standard_normal((2, 2))
    diag = rng.standard_normal(48).astype(np.float32)
    tu = torch.from_numpy(u)
    np.testing.assert_allclose(ts.apply(c, tu).numpy(),
                               np.asarray(js.apply(c, jnp.asarray(u))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ts.apply_factored(c, torch.from_numpy(diag), tu).numpy(),
        np.asarray(js.apply_factored(c, jnp.asarray(diag), jnp.asarray(u))),
        rtol=1e-6, atol=1e-6)
    z = ts.canonicalize(tu)
    assert z.shape == (3, 2, 48) and ts.packed_k == js.packed_k == 2
    assert torch.equal(ts.decanonicalize(z, SHAPE), tu)
    assert torch.equal(ts.project_data(tu), tu[:, 0])
    with jax.threefry_partitionable(False):
        want = np.asarray(js.prior_sample(jax.random.PRNGKey(9), 2, SHAPE))
    got = ts.prior_sample(prng.PRNGKey(9), 2, SHAPE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
