"""Parity of the port's lockstep gDDIM samplers (`core/gddim.py`) and of
`DiffusionSpec.sample` with the JAX package's, on the CPU.

Inputs are made with numpy from a seed; the JAX side of every sampler that
draws noise runs under `jax.threefry_partitionable(False)`, the counter
layout the port implements.  The samplers run on the exact-score oracle
(`sde/mixture.py`: examples/quickstart.py's four-mode 2-D mixture for VPSDE
and CLD, a two-mode 8 x 8 x 3 mixture for BDM) with Stage-I coefficients
built once by the port and handed to both packages (test_torch_coeffs.py
holds Stage I bitwise), and `DiffusionSpec.sample` on the reduced configs
with the same random DiT weights (carried by `convert`).

Tiers:
  * BITWISE: VPSDE's host float64 closed forms and its Stage-I tables (the
    same numpy arithmetic and float32 casts in both packages), the
    mixture's host float64 score and the host RK45 baseline;
  * a stated bound, max |port - jax| <= BOUND = 1e-5 of the largest
    magnitude of the JAX result, for the stochastic sampler, EM, Heun,
    the oracle's eps and draws, and `DiffusionSpec.sample`: the port
    applies each update with one `ei_update` (or `bdm_ei_update`) over the
    packed state where the JAX package sums `sde.apply` terms, and the
    normals are within 2 ulp;
  * the deterministic exact-score samplers (`sample_gddim`,
    `sample_ancestral_bdm`) amplify f32 rounding on CLD and BDM, the
    reference's own included, so they are held to the reference evaluated
    in f64 (`_close_conditioned` says how and why).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sde as jsde
from repro.configs import get_diffusion as jget
import repro_torch.core as tcore
import repro_torch.sde as tsde
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.configs import get_diffusion as tget

BOUND = 1e-5
CONDITIONED = 4.0
NFE = 5
ANG = np.linspace(0, 2 * np.pi, 4, endpoint=False)
MIX2 = dict(means=np.stack([2.5 * np.cos(ANG), 2.5 * np.sin(ANG)], -1),
            stds=np.full(4, 0.08), weights=np.ones(4))


CLOSED_FORMS = ("F_np", "G2_np", "Psi_np", "Sigma_np", "R_np")


def memoized(sde, names=CLOSED_FORMS):
    """Cache an SDE's float64 closed forms per argument: pure functions of
    their float arguments, so every value is unchanged bit for bit; the
    quadratures only stop recomputing them."""
    for name in names:
        setattr(sde, name, functools.lru_cache(maxsize=None)(
            getattr(sde, name)))
    return sde


@functools.lru_cache(maxsize=None)
def _pair(fam: str):
    """One (jax, torch) SDE pair per family for the whole module, with the
    float64 closed forms memoized in both, so the Stage-I quadratures of
    every case share them."""
    if fam == "vpsde":
        return jsde.VPSDE(), tsde.VPSDE()
    if fam == "cld":
        names = CLOSED_FORMS + ("_sigma_exact",)    # the R_t solve's too
        return (memoized(jsde.CLD(grid_substeps=1), names),
                memoized(tsde.CLD(grid_substeps=1), names))
    raise ValueError(fam)


def _to_jax(co, dtype=jnp.float32):
    return jcore.SamplerCoeffs(*[
        v if isinstance(v, float) else jnp.asarray(v.numpy(), dtype)
        for v in co])


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert err <= BOUND * scale, f"{what}: {err:.3e} > {BOUND} x {scale:.3e}"


def _close_conditioned(got: torch.Tensor, run, what: str) -> None:
    """The tier for CLD's corrector and BDM's ancestral sampler on the
    exact score.  Both amplify f32 rounding (the corrector's second eval at
    t_{i-1}; the ancestral step's division by alpha_t ~ 2e-3 near T): at 10
    steps the JAX reference's own f32 result lies up to ~2e-4 of scale
    from the same reference evaluated in f64 on the same f32 coefficients
    and inputs (~3e-3 at 5 steps), so no f32 implementation can be held to
    BOUND of it there.  `run(dtype)`
    runs the JAX reference; the port is held to its f64 evaluation, within
    BOUND of scale or CONDITIONED times the JAX f32 result's own distance
    from it, whichever is larger."""
    want = np.asarray(run(jnp.float32))
    with jax.enable_x64(True):
        want64 = np.asarray(run(jnp.float64))
    scale = float(np.abs(want64).max())
    own = float(np.abs(want - want64).max())
    err = float(np.abs(got.numpy() - want64).max())
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert err <= max(BOUND * scale, CONDITIONED * own), \
        f"{what}: {err:.3e} from f64 (scale {scale:.3e}); the JAX f32 " \
        f"result {own:.3e}"


@functools.lru_cache(maxsize=None)
def _eps_fns(fam: str, nfe: int):
    """The mixture oracle's eps_fns (torch, jax) on an nfe-step quadratic
    grid, built once per family and grid for every q and lambda."""
    js, ts_ = _pair(fam)
    grid = tcore.time_grid(ts_, nfe)
    jmix, tmix = jsde.GaussianMixture(**MIX2), tsde.GaussianMixture(**MIX2)
    jeps, _ = jsde.ExactScore(js, jmix).eps_fn_for_grid(grid)
    teps, _ = tsde.ExactScore(ts_, tmix).eps_fn_for_grid(grid)
    return teps, jeps


@functools.lru_cache(maxsize=None)
def _oracle(fam: str, q: int, lam: float, nfe: int):
    """(jax sde, torch sde, torch coeffs, eps_fns (torch, jax), u_T numpy)
    for the mixture oracle on an nfe-step quadratic grid."""
    js, ts_ = _pair(fam)
    co = tcore.build_sampler_coeffs(ts_, tcore.time_grid(ts_, nfe), q=q,
                                    lam=lam)
    shape = (6,) + ts_.state_shape((2,))
    u_T = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    return (js, ts_, co) + _eps_fns(fam, nfe) + (u_T,)


def test_vpsde_closed_forms_and_stage_one_bitwise():
    js, ts_ = jsde.VPSDE(), tsde.VPSDE()
    for t, s in [(0.3, 0.7), (1e-3, 0.05), (0.9, 1.0)]:
        for name in ("F_np", "G2_np", "Sigma_np", "R_np", "L_np"):
            assert getattr(js, name)(t) == getattr(ts_, name)(t), name
        assert js.Psi_np(t, s) == ts_.Psi_np(t, s)
        assert js.Psi_hat_np(t, s, 0.5) == ts_.Psi_hat_np(t, s, 0.5)
        assert js.P_np(s, t, 0.5) == ts_.P_np(s, t, 0.5)
        assert js.ddim_step_reference(1.5, 0.2, s, t) == \
            ts_.ddim_step_reference(1.5, 0.2, s, t)
    grid = tcore.time_grid(ts_, 6)
    for lam in (0.0, 0.5):
        a = jcore.build_sampler_coeffs(js, grid, q=3, lam=lam)
        b = tcore.build_sampler_coeffs(ts_, grid, q=3, lam=lam)
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if name == "lam":
                assert x == y
            else:
                np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                              err_msg=name)


@pytest.mark.parametrize("fam,q,corrector", [
    ("vpsde", 2, False), ("cld", 1, False), ("cld", 1, True),
    ("cld", 2, False), ("cld", 2, True), ("cld", 3, False), ("cld", 3, True)])
def test_sample_gddim_matches_jax(fam, q, corrector):
    """VPSDE's corrector runs in test_diffusion_spec_sample_matches_jax."""
    js, ts_, co, teps, jeps, u_T = _oracle(fam, q, 0.0, 10)
    run = lambda dt: jcore.sample_gddim(js, _to_jax(co, dt), jeps,
                                        jnp.asarray(u_T, dt), q=q,
                                        corrector=corrector)
    got = tcore.sample_gddim(ts_, co, teps, torch.from_numpy(u_T), q=q,
                             corrector=corrector)
    what = f"sample_gddim {fam} q={q} corrector={corrector}"
    if corrector:
        _close_conditioned(got, run, what)
    else:
        _close(got, run(jnp.float32), what)


@pytest.mark.parametrize("fam", ["vpsde", "cld"])
@pytest.mark.parametrize("method", ["stochastic", "em", "heun"])
def test_baselines_and_stochastic_gddim_match_jax(fam, method):
    lam = {"stochastic": 0.5, "em": 1.0, "heun": 0.0}[method]
    js, ts_, co, teps, jeps, u_T = _oracle(fam, 1, lam, NFE)
    jco = _to_jax(co)
    ju, tu = jnp.asarray(u_T), torch.from_numpy(u_T)
    with jax.threefry_partitionable(False):
        if method == "stochastic":
            want = jcore.sample_gddim_stochastic(js, jco, jeps, ju,
                                                 jax.random.PRNGKey(3))
        elif method == "em":
            want = jcore.sample_em(js, jco, jeps, ju, jax.random.PRNGKey(3),
                                   lam=lam)
        else:
            want = jcore.sample_heun(js, jco, jeps, ju)
    if method == "stochastic":
        got = tcore.sample_gddim_stochastic(ts_, co, teps, tu,
                                            prng.PRNGKey(3))
    elif method == "em":
        got = tcore.sample_em(ts_, co, teps, tu, prng.PRNGKey(3), lam=lam)
    else:
        got = tcore.sample_heun(ts_, co, teps, tu)
    _close(got, want, f"{method} {fam}")


def test_ancestral_bdm_matches_jax():
    shape = (8, 8, 3)
    rng = np.random.default_rng(2)
    mix = dict(means=rng.standard_normal((2,) + shape) * 0.5,
               stds=np.array([0.1, 0.2]), weights=np.array([1.0, 2.0]))
    js = memoized(jsde.BDM(data_shape=shape), ("alpha_k", "Sigma_np"))
    ts_ = memoized(tsde.BDM(data_shape=shape), ("alpha_k", "Sigma_np"))
    grid = tcore.time_grid(ts_, NFE)
    jeps, _ = jsde.ExactScore(js, jsde.GaussianMixture(**mix)) \
        .eps_fn_for_grid(grid)
    teps, _ = tsde.ExactScore(ts_, tsde.GaussianMixture(**mix)) \
        .eps_fn_for_grid(grid)
    u_T = rng.standard_normal((3,) + shape).astype(np.float32)

    def run(dt):
        with jax.threefry_partitionable(False):
            return jcore.sample_ancestral_bdm(js, jeps, jnp.asarray(u_T, dt),
                                              grid, jax.random.PRNGKey(4))

    got = tcore.sample_ancestral_bdm(ts_, teps, torch.from_numpy(u_T), grid,
                                     prng.PRNGKey(4))
    _close_conditioned(got, run, "sample_ancestral_bdm")
    for a, b in zip(js.ancestral_coeffs(grid[::-1]),
                    ts_.ancestral_coeffs(grid[::-1])):
        np.testing.assert_array_equal(a, b)


def test_mixture_host_score_rk45_and_draws_match_jax():
    js, ts_ = _pair("vpsde")
    jmix, tmix = jsde.GaussianMixture(**MIX2), tsde.GaussianMixture(**MIX2)
    jo, to = jsde.ExactScore(js, jmix), tsde.ExactScore(ts_, tmix)
    u = np.random.default_rng(1).standard_normal((4, 2))
    for t in (1e-3, 0.2, 0.9):
        np.testing.assert_array_equal(to.score_np(u, t), jo.score_np(u, t))
    # the device-side score and eps against the host float64 score
    u32 = torch.from_numpy(u.astype(np.float32))
    sc = to.score_np(u.astype(np.float32).astype(np.float64), 0.4)
    _close(to.score(u32, 0.4), sc, "ExactScore.score")
    _close(to.eps(u32, 0.4), -ts_.R_np(0.4) * sc, "ExactScore.eps")
    x_t, n_t = tcore.sample_rk45_np(ts_, to.score_np, u, rtol=1e-3,
                                    atol=1e-3)
    x_j, n_j = jcore.sample_rk45_np(js, jo.score_np, u, rtol=1e-3,
                                    atol=1e-3)
    assert n_t == n_j
    np.testing.assert_array_equal(x_t, x_j)
    with jax.threefry_partitionable(False):
        want = jmix.sample(jax.random.PRNGKey(5), 256)
    _close(tmix.sample(prng.PRNGKey(5), 256), want, "GaussianMixture.sample")


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: (rng.standard_normal(leaf.shape)
                      / np.sqrt(leaf.shape[-2] if leaf.ndim >= 2 else 8)
                      ).astype(np.float32), shapes)


@pytest.mark.parametrize("name,kw", [
    ("cifar10-ddpm", dict(q=2, corrector=True)),
    ("cifar10-cld", dict(lam=0.5, nfe=5)),
    ("cifar10-bdm", dict(q=2))])
def test_diffusion_spec_sample_matches_jax(name, kw):
    """The reduced config end to end: prior, Stage I, the DiT and the
    sampler, with the same random weights in both packages."""
    jspec, tspec = jget(name, reduced=True), tget(name, reduced=True)
    if name == "cifar10-cld":
        js, ts_ = _pair("cld")
    else:
        js, ts_ = (memoized(dataclasses.replace(s.sde))
                   for s in (jspec, tspec))
    jspec = dataclasses.replace(jspec, sde=js)
    tspec = dataclasses.replace(tspec, sde=ts_)
    tree = _random_tree(jspec.param_shapes(), seed=5)
    net = tspec.init(seed=0, device="cpu")
    net.load_state_dict(convert.from_jax_params(tree))
    kw = dict(dict(nfe=4), **kw)
    with jax.threefry_partitionable(False):
        want = jspec.sample(jax.tree.map(jnp.asarray, tree),
                            jax.random.PRNGKey(9), 3, **kw)
    got = tspec.sample(net, prng.PRNGKey(9), 3, device="cpu", **kw)
    assert got.shape == (3, 8, 8, 3)
    _close(got, want, f"{name} {kw}")
