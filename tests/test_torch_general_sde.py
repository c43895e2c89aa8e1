"""gDDIM's generality witness and the DDIM closed form in the port,
against the JAX package, on the CPU: `GeneralSDE` (an arbitrary constant
non-normal 2x2 F and full-rank G: Sigma_t with no closed form, R_t != L_t)
and `ddim_closed_form_check` (paper Eq. 12 / Prop. 2).

Tiers:
  * bitwise: GeneralSDE's host float64 Stage I (Psi, Sigma, R, L, the
    time grid and the sampler coefficients cast to f32) and
    `ddim_closed_form_check`;
  * gDDIM samples on GeneralSDE (path A: `ei_update` at k = 2, the plain
    version here) within 1e-4 relative, 1e-5 absolute of the JAX
    sampler's on the exact score of a two-mode mixture (normals within 2
    ulp, F2).
The GeneralSDE instances use `grid_substeps=1` (both packages): its R_t
grid solve costs ~9 s an instance at the default 8.  The JAX side draws
under `jax.threefry_partitionable(False)` (F1).
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sde as jsde
from repro.sde.general import GeneralSDE as JGeneral
import repro_torch.core as tcore
import repro_torch.sde as tsde
from repro_torch import random as prng

NOPART = jax.threefry_partitionable(False)


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def general():
    return JGeneral(grid_substeps=1), tsde.GeneralSDE(grid_substeps=1)


def test_general_sde_stage_one_bitwise(general):
    jg, tg = general
    for t in (1e-5, 0.05, 0.3, 0.7, 1.0):
        for fn in ("Psi_np", "Sigma_np", "R_np", "L_np"):
            args = (t, 0.0) if fn == "Psi_np" else (t,)
            np.testing.assert_array_equal(getattr(tg, fn)(*args),
                                          getattr(jg, fn)(*args), fn)
    ts = jcore.time_grid(jg, 8, "quadratic")
    np.testing.assert_array_equal(tcore.time_grid(tg, 8, "quadratic"), ts)
    jco = jcore.build_sampler_coeffs(jg, ts, q=2, lam=0.5)
    tco = tcore.build_sampler_coeffs(tg, ts, q=2, lam=0.5)
    for name in ("psi", "pC", "cC", "psi_hat", "B", "P_chol"):
        np.testing.assert_array_equal(getattr(tco, name).numpy(),
                                      np.asarray(getattr(jco, name)), name)


def test_general_sde_samples_like_jax(general):
    """gDDIM on GeneralSDE through the port's path A (ei_update at k = 2)
    against the JAX sampler on the exact score of a two-mode mixture."""
    jg, tg = general
    means, stds, w = np.array([[1.0], [-1.0]]), np.array([0.05, 0.05]), \
        np.array([1.0, 1.0])
    ts = jcore.time_grid(jg, 6, "uniform")
    jeps, _ = jsde.ExactScore(jg, jsde.GaussianMixture(
        means, stds, w)).eps_fn_for_grid(ts)
    teps, _ = tsde.ExactScore(tg, tsde.GaussianMixture(
        means, stds, w)).eps_fn_for_grid(ts)
    with NOPART:
        ju = jg.prior_sample(jax.random.PRNGKey(2), 16, (1,))
        jout = jcore.sample_gddim(jg, jcore.build_sampler_coeffs(jg, ts, q=2),
                                  jeps, ju, q=2)
    tu = tg.prior_sample(prng.PRNGKey(2), 16, (1,))
    close(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-6)
    tout = tcore.sample_gddim(tg, tcore.build_sampler_coeffs(tg, ts, q=2),
                              teps, tu, q=2)
    close(tout.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    assert torch.equal(tg.augment_data(tout[:, 0]), torch.stack(
        [tout[:, 0], torch.zeros_like(tout[:, 0])], dim=1))


@pytest.mark.parametrize("n", [5, 20])
def test_ddim_closed_form_bitwise(n):
    jv, tv = jsde.VPSDE(), tsde.VPSDE()
    ts = jcore.time_grid(jv, n)
    ours = tcore.ddim_closed_form_check(tv, ts)
    np.testing.assert_array_equal(ours, jcore.ddim_closed_form_check(jv, ts))
    co = tcore.build_sampler_coeffs(tv, ts, q=1)
    assert np.abs(co.pC[:, 0].numpy() - ours).max() < 1e-5
