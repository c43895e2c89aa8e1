"""The pre-fusion serving step (`launch/steps.py`:
`make_diffusion_serve_step` in both modes and
`make_diffusion_round_step_stitched`) against the port's fused round step
and against the JAX package's stitched step, on the CPU.

Inputs are made with numpy from a seed: random non-zero DiT weights
(carried into the port by `convert`), a synthetic factored bank, random
states.  The JAX side runs under `jax.threefry_partitionable(False)`.

Tiers:
  * BITWISE: the port's engine served through the stitched step against
    the same engine through the fused step, request by request (the JAX
    package holds its fused round bitwise to its stitched chain; on a CPU
    state both of the port's are plain versions of the same arithmetic);
  * rtol = atol = 1e-5 for one stitched round of the port against the JAX
    package's (k and active exact): the JAX factor applies lower to FMA
    dot products, the DiTs round differently, and the normals are within
    2 ulp;
  * the single-config step within 1e-5 of its output's largest magnitude
    (an einsum against a product and a sum per term).
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
from repro.core.coeffs import FactoredBank as JBank
from repro.launch import steps as jsteps
from repro.serve.state import DiffusionState as JState
import repro_torch.core as tcore
import repro_torch.sde as tsde
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.configs import get_diffusion as tget
from repro_torch.core.coeffs import FactoredBank as TBank
from repro_torch.launch import steps as tsteps
from repro_torch.serve import DiffusionEngine, ServeRequest
from repro_torch.serve.state import DiffusionState as TState

MIX = [dict(nfe=4, q=2), dict(nfe=4, q=2, corrector=True),
       dict(nfe=5, lam=0.5), dict(nfe=5, lam=0.5, algorithm="gmm"),
       dict(nfe=4, algorithm="accel")]
TOL = dict(rtol=1e-5, atol=1e-5)


def memoized(sde, names):
    """Cache the SDE's float64 closed forms per argument (pure functions of
    their float arguments: every value unchanged bit for bit)."""
    for name in names:
        setattr(sde, name, functools.lru_cache(maxsize=None)(
            getattr(sde, name)))
    return sde


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: (rng.standard_normal(leaf.shape)
                      / np.sqrt(leaf.shape[-2] if leaf.ndim >= 2 else 8)
                      ).astype(np.float32), shapes)


CLOSED_FORMS = ("F_np", "G2_np", "Psi_np", "Sigma_np", "R_np")


def _specs(name):
    """(jax spec, torch spec) of the reduced config, the SDE's closed forms
    memoized; CLD with the coarse grid solve in both packages."""
    jspec, tspec = jget(name, reduced=True), tget(name, reduced=True)
    if name == "cifar10-cld":
        names = CLOSED_FORMS + ("_sigma_exact",)
        js, ts_ = (memoized(m.CLD(grid_substeps=1), names)
                   for m in (jsde, tsde))
    else:
        js, ts_ = (memoized(dataclasses.replace(s.sde), CLOSED_FORMS)
                   for s in (jspec, tspec))
    return (dataclasses.replace(jspec, sde=js),
            dataclasses.replace(tspec, sde=ts_))


@functools.lru_cache(maxsize=None)
def _nets(name):
    jspec, tspec = _specs(name)
    tree = _random_tree(jspec.param_shapes(), seed=5)
    net = tspec.init(seed=0, device="cpu")
    net.load_state_dict(convert.from_jax_params(tree))
    return jspec, tspec, jax.tree.map(jnp.asarray, tree), net


@pytest.mark.parametrize("name", ["cifar10-cld", "cifar10-bdm",
                                  "cifar10-ddpm"])
def test_stitched_engine_serves_the_fused_engines_samples_bitwise(name):
    _, tspec, _, net = _nets(name)
    eng = DiffusionEngine(tspec, net, batch_size=4, nfe=4, device="cpu")
    reqs = [ServeRequest(rid=i, seed=20 + i, **kw) for i, kw in
            enumerate(MIX)]
    fused = eng.serve(reqs)
    eng._steps = {
        (fam, prec): tsteps.make_diffusion_round_step_stitched(
            tspec, fam_index=eng.cache.fam_index(fam))
        for fam, prec in eng._steps}
    stitched = eng.serve(reqs)
    assert sorted(stitched) == sorted(fused) == list(range(len(MIX)))
    for rid in fused:
        assert np.abs(fused[rid]).max() > 0.1
        np.testing.assert_array_equal(stitched[rid], fused[rid],
                                      err_msg=f"request {rid} {MIX[rid]}")


def _bank(K, D, seed=0):
    """A synthetic factored bank: rows (n_steps, stochastic, corrector,
    alg) covering deterministic, corrector, stochastic gddim and gmm."""
    rows = [(4, False, False, 0), (5, False, True, 0), (5, True, False, 0),
            (4, True, False, 1)]
    CB, NB, QB, PB = 4, 8, 2, 3
    rng = np.random.default_rng(seed)
    f32 = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    di = lambda *s: rng.integers(0, PB, s).astype(np.int32)
    leaves = dict(
        t_cur=rng.uniform(0.05, 0.9, (CB, NB)).astype(np.float32),
        t_nxt=rng.uniform(0.05, 0.9, (CB, NB)).astype(np.float32),
        psi_blk=f32(CB, NB, K, K), psi_di=di(CB, NB),
        pC_blk=f32(CB, NB, QB, K, K), pC_di=di(CB, NB, QB),
        cC_blk=f32(CB, NB, QB, K, K), cC_di=di(CB, NB, QB),
        B_blk=f32(CB, NB, K, K), B_di=di(CB, NB),
        P_chol_blk=f32(CB, NB, K, K), P_chol_di=di(CB, NB),
        diag=f32(PB, D),
        n_steps=np.asarray([r[0] for r in rows], np.int32),
        stochastic=np.asarray([r[1] for r in rows]),
        corrector=np.asarray([r[2] for r in rows]),
        fam=np.zeros(CB, np.int32),
        alg=np.asarray([r[3] for r in rows], np.int32))
    return (JBank(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TBank(**{k: torch.from_numpy(v) for k, v in leaves.items()}))


@pytest.mark.parametrize("name", ["cifar10-cld", "cifar10-bdm"])
def test_stitched_round_step_matches_jax(name):
    """One corrector round over a mixed batch: a deterministic slot, a
    corrector slot, a stochastic gmm slot on its last step, a retired slot
    and a slot of a foreign family (both must stay frozen)."""
    jspec, tspec, jparams, net = _nets(name)
    kf = tspec.sde.packed_k
    D = int(np.prod(tspec.data_shape))
    jbank, tbank = _bank(kf, D)
    rng = np.random.default_rng(3)
    x = dict(u=rng.standard_normal((5, kf, D)).astype(np.float32),
             hist=rng.standard_normal((5, 2, kf, D)).astype(np.float32),
             k=np.asarray([0, 2, 1, 3, 1], np.int32),
             cfg=np.asarray([0, 1, 2, 3, 1], np.int32),
             fam=np.asarray([0, 0, 0, 0, 1], np.int32),
             prec=np.zeros(5, np.int32),
             keys=rng.integers(0, 2**32, (5, 2), dtype=np.uint64)
             .astype(np.uint32),
             active=np.asarray([True, True, True, False, True]))
    names = ("u", "hist", "k", "cfg", "fam", "prec", "keys", "active")
    jstep = jax.jit(jsteps.make_diffusion_round_step_stitched(jspec),
                    static_argnames=("with_corrector",))
    with jax.threefry_partitionable(False):
        want = jstep(jparams, JState(*[jnp.asarray(x[n]) for n in names]),
                     jbank, with_corrector=True)
    t = {n: torch.from_numpy(np.asarray(x[n])) for n in names}
    t["keys"] = prng.to_int32_bits(torch.from_numpy(
        x["keys"].astype(np.int64)))
    got = tsteps.make_diffusion_round_step_stitched(tspec)(
        net, TState(*[t[n] for n in names]), tbank, with_corrector=True)
    for n in ("k", "active"):
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(want, n)), err_msg=n)
    for n in ("u", "hist"):
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   np.asarray(getattr(want, n)), **TOL,
                                   err_msg=n)
    for b in (3, 4):                                    # frozen rows
        np.testing.assert_array_equal(got.u[b].numpy(), x["u"][b])
    # and it is the fused round on the same inputs, bit for bit
    fused = tsteps.make_diffusion_round_step(tspec)(
        net, TState(*[t[n] for n in names]), tbank, with_corrector=True)
    for a, b in zip(got, fused):
        assert torch.equal(a, b)


def test_single_config_serve_step_matches_jax():
    """Both forms of the step index (lockstep int, per-slot vector) on
    VPSDE and CLD; the eps model is a smooth stand-in for the DiT (the
    step's own arithmetic is what differs between the modes)."""
    grid = tcore.time_grid(tsde.VPSDE(), 4)
    for name in ("cifar10-ddpm", "cifar10-cld"):
        jspec, tspec = _nets(name)[:2]
        shape = (3,) + tspec.sde.state_shape(tuple(tspec.data_shape))
        jfake = type("Spec", (), dict(
            sde=jspec.sde, eps_model=staticmethod(lambda p, u, t: jnp.tanh(
                u) * t.reshape((-1,) + (1,) * (u.ndim - 1)))))
        tfake = type("Spec", (), dict(
            sde=tspec.sde, eps_model=staticmethod(lambda p, u, t: torch.tanh(
                u) * t.reshape((-1,) + (1,) * (u.dim() - 1)))))
        # K_t = L_t (Cholesky): the same step, without CLD's R_t grid solve
        tco = tcore.build_sampler_coeffs(tspec.sde, grid, q=1, kt="L")
        jco = jcore.build_sampler_coeffs(jspec.sde, grid, q=1, kt="L")
        u = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
        jstep = jsteps.make_diffusion_serve_step(jfake, jco)
        tstep = tsteps.make_diffusion_serve_step(tfake, tco)
        for k in (1, np.asarray([0, 3, 7], np.int32)):
            want = np.asarray(jstep(None, jnp.asarray(u), jnp.asarray(k)))
            got = tstep(None, torch.from_numpy(u), k if isinstance(k, int)
                        else torch.from_numpy(k))
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
