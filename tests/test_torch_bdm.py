"""The port's Blurring Diffusion Model against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; the JAX side draws noise under
`jax.threefry_partitionable(False)`, the counter layout the port
implements.  Tiers, each named in its test:

  * BITWISE: the host float64 schedule (`lam`, `alpha_k`, `F_np`, `G2_np`,
    `Psi_np`, `Sigma_np`, `R_np`) and every leaf of the factored bank for
    chip_smoke.py's request mix at full width (32, 32, 3) — the same numpy
    arithmetic and the same float32 casts in both packages;
  * max |port - jax| <= 1e-5 of scale for the device side (DCT applies,
    canonicalize, the prior) and the round commit (rtol = atol = 1e-5, k
    and active exact): the DCT products sum in other orders, and the
    normals are within 2 ulp;
  * a stated bound on served samples: the reduced `cifar10-bdm` engine's
    samples within 1e-5 of the sample's largest magnitude of the JAX
    engine's, the same random DiT weights carried by `convert`.
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
from repro.kernels.round_fused import ops as jrf
from repro.serve import DiffusionEngine as JEngine
from repro.serve import ServeRequest as JRequest
import repro_torch.core as tcore
import repro_torch.sde as tsde
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.configs import get_diffusion as tget
from repro_torch.core.coeffs import FactoredBank as TBank
from repro_torch.kernels.round_fused import ops as trf
from repro_torch.serve import DiffusionEngine as TEngine
from repro_torch.serve import ServeRequest

FULL = (32, 32, 3)
# chip_smoke.py's request mix
SMOKE_MIX = [dict(nfe=10, q=2), dict(nfe=10, q=2, corrector=True),
             dict(nfe=10, lam=0.5), dict(nfe=10, lam=0.5, algorithm="gmm")]
TIMES = [1e-3, 0.05, 0.31, 0.72, 0.999]


def memoized(sde):
    """Cache the reference SDE's float64 schedule per argument.  They are
    pure functions of their float arguments, so every value (and so every
    Stage-I table) is unchanged bit for bit; the quadrature only stops
    recomputing the same arrays, which keeps the test to seconds."""
    for name in ("alpha_k", "F_np", "G2_np", "Sigma_np", "R_np"):
        setattr(sde, name, functools.lru_cache(maxsize=None)(
            getattr(sde, name)))
    return sde


def test_schedule_tables_bitwise():
    j, t = jsde.BDM(data_shape=FULL), tsde.BDM(data_shape=FULL)
    np.testing.assert_array_equal(t.lam, j.lam)
    for x in TIMES:
        for name in ("alpha_k", "F_np", "G2_np", "Sigma_np", "R_np"):
            np.testing.assert_array_equal(
                getattr(t, name)(x), getattr(j, name)(x), err_msg=name)
        for s in TIMES:
            np.testing.assert_array_equal(t.Psi_np(x, s), j.Psi_np(x, s))


def test_factored_bank_of_the_smoke_mix_bitwise():
    jc = jcore.CoeffCache(memoized(jsde.BDM(data_shape=FULL)),
                          data_shape=FULL)
    tc = tcore.CoeffCache(tsde.BDM(data_shape=FULL), data_shape=FULL)
    for kw in SMOKE_MIX:
        assert jc.index_of(jcore.SamplerConfig(**kw)) == \
            tc.index_of(tcore.SamplerConfig(**kw))
    jb, tb = jc.factored_bank, tc.factored_bank
    assert tuple(tb.diag.shape) == (128, 3072)
    for name in jb._fields:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_device_side_matches_jax():
    shape = (8, 8, 3)
    j, t = jsde.BDM(data_shape=shape), tsde.BDM(data_shape=shape)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3,) + shape).astype(np.float32)
    coeff = j.Psi_np(0.3, 0.7).astype(np.float32)
    tu = torch.from_numpy(u)
    scale = float(np.abs(u).max())
    pairs = [
        (t.apply(coeff, tu), j.apply(coeff, jnp.asarray(u))),
        (t.to_freq(tu), j.to_freq(jnp.asarray(u))),
        (t.canonicalize(tu), j.canonicalize(jnp.asarray(u))),
        (t.decanonicalize(tu.reshape(3, 1, -1), shape),
         j.decanonicalize(jnp.asarray(u).reshape(3, 1, -1), shape))]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * scale)
    with jax.threefry_partitionable(False):
        want = np.asarray(j.prior_sample(jax.random.PRNGKey(3), 2, shape))
    got = t.prior_sample(prng.PRNGKey(3), 2, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- the round commit with BDM's streamed (DCT'd) noise ---------------------
SHAPE = (8, 8, 3)
D = 192
CB, NB, QB, PB = 8, 8, 2, 4
# config rows: (n_steps, stochastic, corrector, alg): gddim, gmm, a q = 2
# corrector row, and a deterministic row
ROWS = [(5, True, False, 0), (5, True, False, 1), (5, False, True, 0),
        (4, False, False, 0)]
# (slot configs, with_corrector): stochastic gddim + gmm; a corrector round
# with a stochastic slot riding along
CASES = [([0, 1, 0, 3], False), ([2, 2, 1, 0], True)]


def _bank():
    rng = np.random.default_rng(1)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    di = lambda *s: rng.integers(0, PB, s).astype(np.int32)
    n_steps = np.ones(CB, np.int32)
    stoch, corr = np.zeros(CB, bool), np.zeros(CB, bool)
    alg = np.zeros(CB, np.int32)
    for c, (n, s, cc, a) in enumerate(ROWS):
        n_steps[c], stoch[c], corr[c], alg[c] = n, s, cc, a
    leaves = dict(
        t_cur=f32(CB, NB), t_nxt=f32(CB, NB),
        psi_blk=f32(CB, NB, 1, 1), psi_di=di(CB, NB),
        pC_blk=f32(CB, NB, QB, 1, 1), pC_di=di(CB, NB, QB),
        cC_blk=f32(CB, NB, QB, 1, 1), cC_di=di(CB, NB, QB),
        B_blk=f32(CB, NB, 1, 1), B_di=di(CB, NB),
        P_chol_blk=f32(CB, NB, 1, 1), P_chol_di=di(CB, NB),
        diag=f32(PB, D), n_steps=n_steps, stochastic=stoch, corrector=corr,
        fam=np.zeros(CB, np.int32), alg=alg)
    return (JBank(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TBank(**{k: torch.from_numpy(v) for k, v in leaves.items()}))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_round_update_streams_the_dct_noise_like_jax(case):
    """k / active exact, u / hist within rtol = atol = 1e-5.  A plain
    version that reshapes the state-space noise instead of DCT-ing it
    misses here by O(1) on every stochastic slot."""
    jbank, tbank = _bank()
    cfgs, corr = CASES[case]
    rng = np.random.default_rng(10 + case)
    B = len(cfgs)
    cfg = np.asarray(cfgs, np.int32)
    k = rng.integers(0, 5, B).astype(np.int32)
    kc = np.minimum(k, np.asarray([ROWS[c][0] for c in cfgs]) - 1) \
        .astype(np.int32)
    x = dict(u=rng.standard_normal((B, 1, D)).astype(np.float32),
             hist=rng.standard_normal((B, QB, 1, D)).astype(np.float32),
             k=k, kc=kc, cfg=cfg, fam=np.zeros(B, np.int32),
             prec=np.zeros(B, np.int32),
             keys=rng.integers(0, 2**32, (B, 2), dtype=np.uint64)
             .astype(np.uint32),
             active=np.asarray([True, True, False, True]))
    eps_c, eps_n_c = (rng.standard_normal((B, 1, D)).astype(np.float32)
                      for _ in range(2))
    names = ("u", "hist", "k", "kc", "cfg", "fam", "prec", "keys", "active")
    with jax.threefry_partitionable(False):
        want = jax.jit(functools.partial(
            jrf.round_update, sde=jsde.BDM(data_shape=SHAPE),
            state_shape=SHAPE, kf=1, with_corrector=corr, impl="ref"))(
            *[jnp.asarray(x[n]) for n in names], jbank, jnp.asarray(eps_c),
            eps_n_c=jnp.asarray(eps_n_c))
    t = {n: torch.from_numpy(np.asarray(x[n])) for n in names if n != "keys"}
    keys = prng.to_int32_bits(torch.from_numpy(x["keys"].astype(np.int64)))
    got = trf.round_update(
        t["u"], t["hist"], t["k"], t["kc"], t["cfg"], t["fam"], t["prec"],
        keys, t["active"], tbank, torch.from_numpy(eps_c),
        sde=tsde.BDM(data_shape=SHAPE), state_shape=SHAPE, kf=1,
        with_corrector=corr, eps_n_c=torch.from_numpy(eps_n_c))
    for name, a, b in zip(("u", "hist", "k", "active"), want, got):
        a, b = np.asarray(a), b.numpy()
        if name in ("k", "active"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f"case {case} {name}")
    np.testing.assert_array_equal(got[0][2].numpy(), x["u"][2])   # retired


# ---- the engine end to end ---------------------------------------------------
MIX = [dict(nfe=4), dict(nfe=4, corrector=True), dict(nfe=5, lam=0.5),
       dict(nfe=5, lam=0.5, algorithm="gmm"), dict(nfe=4, q=2)]
BOUND = 1e-5


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: (rng.standard_normal(leaf.shape)
                      / np.sqrt(leaf.shape[-2] if leaf.ndim >= 2 else 8)
                      ).astype(np.float32), shapes)


def test_reduced_bdm_engine_serves_the_jax_samples():
    jspec = jget("cifar10-bdm", reduced=True)
    jspec = dataclasses.replace(jspec, sde=memoized(jspec.sde))
    tspec = tget("cifar10-bdm", reduced=True)
    tree = _random_tree(jspec.param_shapes(), seed=7)
    net = tspec.init(seed=0, device="cpu")
    net.load_state_dict(convert.from_jax_params(tree))

    wire = [ServeRequest(rid=i, seed=20 + i, **kw).to_wire()
            for i, kw in enumerate(MIX)]
    jeng = JEngine(jspec, jax.tree.map(jnp.asarray, tree), batch_size=4,
                   nfe=4)
    with jax.threefry_partitionable(False):
        want = jeng.serve([JRequest.from_wire(w) for w in wire])
    teng = TEngine(tspec, net, batch_size=4, nfe=4, device="cpu")
    got = teng.serve([ServeRequest.from_wire(w) for w in wire])
    assert sorted(got) == sorted(want) == list(range(len(MIX)))
    assert teng.n_rounds == jeng.n_rounds and teng.wave_log == jeng.wave_log
    for rid in want:
        a, b = np.asarray(want[rid]), got[rid]
        assert b.shape == a.shape == (8, 8, 3) and np.isfinite(b).all()
        assert np.abs(a).max() > 0.1
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=BOUND * np.abs(a).max(),
                                   err_msg=f"request {rid} {MIX[rid]}")
