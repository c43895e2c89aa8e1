"""Parity of the port's round commit (`round_update`, `round_predict`) with
the JAX package's, on CPU tensors (the plain version; the CUDA kernels are
held against it on the card by chip_smoke.py and tests/test_torch_cuda.py).

Inputs: one synthetic FactoredBank shared by both packages — random
coefficient blocks, a random diagonal pool with random row ids, and config
rows covering the CLD corners of tests/test_kernels.py's ROUND_CASES
(q 1/2, corrector, stochastic) crossed with the three algorithms (gddim,
gmm, accel) — and random states, histories, evals and keys, all from a
numpy seed.  Each batch mixes slots of several configs, one inactive slot
and one slot of a foreign family (both must stay frozen).

The JAX side is its plain reference, `impl="ref"` (jitted): the JAX
package's Pallas round kernel does not trace under the installed jax (it
calls `pl.load`, which jax 0.9 removed), so its interpret mode cannot run
here.  The reference is the chain that kernel is held bitwise against.

Tiers:
  * k_next / active_next: BITWISE;
  * u_next / hist_next / u_pred: rtol = atol = 1e-5.  The port sums each
    kf = 2 block contraction term by term while the JAX ref lowers it to an
    FMA dot_general (one rounding apart), and the stochastic slots add
    normals that are within 2 ulp.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coeffs import FactoredBank as JBank
from repro.kernels.round_fused import ops as jrf
from repro.sde import CLD
from repro_torch import random as prng
from repro_torch.core.coeffs import FactoredBank as TBank
from repro_torch.kernels.round_fused import ops as trf
from repro_torch.kernels.round_fused import ref as tref
from repro_torch.sde import CLD as TCLD

DATA = (4, 4, 3)
D = 48
K = KF = 2
CB, NB, QB, PB = 8, 8, 2, 3
# config rows: (n_steps, stochastic, corrector, alg) — alg 0 gddim, 1 gmm,
# 2 accel; row 1 is a q=2 corrector row, rows 2-3 stochastic
ROWS = [(4, False, False, 0), (5, False, True, 0), (5, True, False, 0),
        (4, True, False, 1), (4, False, False, 2)]
# (slot configs, with_corrector): the CLD ROUND_CASES corners x algorithms
CASES = [([0, 0, 4], False),          # deterministic q=1: gddim + accel
         ([1, 1, 0], True),           # q=2 + corrector (a plain row rides along)
         ([2, 3, 2], False),          # stochastic: gddim + gmm
         ([3, 4, 1], True)]           # every algorithm in one corrector round


def _bank(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    di = lambda *s: rng.integers(0, PB, s).astype(np.int32)
    n_steps = np.ones(CB, np.int32)
    stoch, corr = np.zeros(CB, bool), np.zeros(CB, bool)
    alg = np.zeros(CB, np.int32)
    for c, (n, s, cc, a) in enumerate(ROWS):
        n_steps[c], stoch[c], corr[c], alg[c] = n, s, cc, a
    leaves = dict(
        t_cur=f32(CB, NB), t_nxt=f32(CB, NB),
        psi_blk=f32(CB, NB, K, K), psi_di=di(CB, NB),
        pC_blk=f32(CB, NB, QB, K, K), pC_di=di(CB, NB, QB),
        cC_blk=f32(CB, NB, QB, K, K), cC_di=di(CB, NB, QB),
        B_blk=f32(CB, NB, K, K), B_di=di(CB, NB),
        P_chol_blk=f32(CB, NB, K, K), P_chol_di=di(CB, NB),
        diag=f32(PB, D), n_steps=n_steps, stochastic=stoch, corrector=corr,
        fam=np.zeros(CB, np.int32), alg=alg)
    return (JBank(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TBank(**{k: torch.from_numpy(v) for k, v in leaves.items()}))


def _inputs(cfgs, seed):
    rng = np.random.default_rng(seed)
    B = len(cfgs)
    cfg = np.asarray(cfgs, np.int32)
    k = rng.integers(0, 5, B).astype(np.int32)
    n_steps = np.asarray([ROWS[c][0] for c in cfgs])
    kc = np.clip(k, 0, n_steps - 1).astype(np.int32)
    return dict(
        u=rng.standard_normal((B, K, D)).astype(np.float32),
        hist=rng.standard_normal((B, QB, K, D)).astype(np.float32),
        k=k, kc=kc, cfg=cfg,
        fam=np.asarray([0, 0, 1], np.int32)[:B],        # slot 2: foreign
        prec=np.zeros(B, np.int32),
        keys=rng.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32),
        active=np.asarray([True, False, True])[:B],     # slot 1: retired
        eps_c=rng.standard_normal((B, KF, D)).astype(np.float32),
        eps_n_c=rng.standard_normal((B, KF, D)).astype(np.float32))


def _jax_args(x):
    return [jnp.asarray(x[n]) for n in ("u", "hist", "k", "kc", "cfg", "fam",
                                        "prec", "keys", "active")]


def _torch_args(x):
    t = {n: torch.from_numpy(np.asarray(x[n])) for n in
         ("u", "hist", "k", "kc", "cfg", "fam", "prec", "active", "eps_c",
          "eps_n_c")}
    t["keys"] = prng.to_int32_bits(torch.from_numpy(
        x["keys"].astype(np.int64)))
    return t


@pytest.fixture(scope="module")
def banks():
    return _bank()


_jax_round_predict = jax.jit(functools.partial(jrf.round_predict, kf=KF,
                                               impl="ref"))


@functools.lru_cache(maxsize=None)
def _jax_round_update(with_corrector: bool):
    return jax.jit(functools.partial(
        jrf.round_update, sde=CLD(), state_shape=(2,) + DATA, kf=KF,
        fam_index=0, prec_index=0, with_corrector=with_corrector,
        impl="ref"))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_round_update_matches_jax(banks, case):
    jbank, tbank = banks
    cfgs, corr = CASES[case]
    x = _inputs(cfgs, seed=case)
    with jax.threefry_partitionable(False):
        want = _jax_round_update(corr)(*_jax_args(x), jbank,
                                       jnp.asarray(x["eps_c"]),
                                       eps_n_c=jnp.asarray(x["eps_n_c"]))
    t = _torch_args(x)
    got = trf.round_update(
        t["u"], t["hist"], t["k"], t["kc"], t["cfg"], t["fam"], t["prec"],
        t["keys"], t["active"], tbank, t["eps_c"], sde=TCLD(),
        state_shape=(2,) + DATA, kf=KF, with_corrector=corr,
        eps_n_c=t["eps_n_c"])
    for name, a, b in zip(("u", "hist", "k", "active"), want, got):
        a, b = np.asarray(a), b.numpy()
        if name in ("k", "active"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f"case {case} {name}")
    # frozen rows are untouched bit for bit
    for i in (1, 2):
        np.testing.assert_array_equal(got[0][i].numpy(), x["u"][i])
        np.testing.assert_array_equal(got[1][i].numpy(), x["hist"][i])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_round_predict_matches_jax(banks, case):
    jbank, tbank = banks
    x = _inputs(CASES[case][0], seed=10 + case)
    jargs = _jax_args(x)
    want = _jax_round_predict(jargs[0], jargs[1], jargs[3], jargs[4], jbank,
                              jnp.asarray(x["eps_c"]))
    t = _torch_args(x)
    got = trf.round_predict(t["u"], t["hist"], t["kc"], t["cfg"], tbank,
                            t["eps_c"], kf=KF)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_step_noise_matches_jax_draw(banks):
    """The serving noise law alone (gddim and gmm slots): bits through
    `draw_step_noise` within 2 ulp of the JAX chain."""
    from repro.kernels.round_fused.ref import draw_step_noise
    x = _inputs([2, 3, 3], seed=3)
    alg = np.asarray([0, 1, 1], np.int32)
    with jax.threefry_partitionable(False):
        want = np.asarray(draw_step_noise(
            CLD(), jnp.asarray(x["keys"]), jnp.asarray(x["kc"]),
            jnp.asarray(alg), (2,) + DATA, jnp.float32))
    got = tref.draw_step_noise(_torch_args(x)["keys"],
                               torch.from_numpy(x["kc"]),
                               torch.from_numpy(alg), (2,) + DATA).numpy()
    ulp = np.abs(want.view(np.int32).astype(np.int64)
                 - got.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2


def test_stage_factors_and_ints_layout(banks):
    _, tbank = banks
    x = _torch_args(_inputs([1, 3, 4], seed=4))
    blks, dis = trf._stage_factors(tbank, x["cfg"], x["kc"], KF, True)
    assert blks.shape == (3, 3 + 2 * QB, KF, KF) and dis.dtype == torch.int32
    cfg, kc = x["cfg"], x["kc"]
    assert torch.equal(blks[:, 1], tbank.B_blk[cfg, kc])
    assert torch.equal(blks[:, 3 + QB + 1], tbank.cC_blk[cfg, kc, 1])
    ints = trf._stage_ints(x["k"], kc, cfg, x["fam"], x["prec"], x["active"],
                           tbank, fam_index=0, prec_index=0,
                           with_corrector=True)
    assert ints.shape == (3, trf.N_INTS) and ints.dtype == torch.int32
    np.testing.assert_array_equal(ints[:, 3].numpy(), [1, 0, 0])   # mine
    np.testing.assert_array_equal(ints[:, 7].numpy(), [0, 1, 2])   # alg


@pytest.mark.parametrize("kf", [1, 2])
@pytest.mark.parametrize("corr", [False, True])
def test_kernel_offsets_match_the_staged_layout(banks, kf, corr):
    """The factor-slot layout the kernels follow (`factor_layout`, the
    source's `factor_slot`) and the flat offsets a block computes into the
    bank tables the wrapper hands it (`factor_offsets`), read from the flat
    tables, equal `_stage_factors` element for element (commit and
    predictor), and the per-config flags a block reads at offset cfg equal
    `_stage_ints`'s columns, for random (cfg, kc)."""
    _, tbank = banks
    rng = np.random.default_rng(20 + 2 * kf + corr)
    B = 6
    cfg = torch.from_numpy(rng.integers(0, CB, B).astype(np.int32))
    kc = torch.from_numpy(rng.integers(0, NB, B).astype(np.int32))
    for predict in (False, True):
        layout = trf.factor_layout(QB, corr, predict_only=predict)
        blk_off, di_off = trf.factor_offsets(layout, cfg, kc, Nb=NB, K=K,
                                             kf=kf)
        flat = lambda nm, part, off: \
            getattr(tbank, f"{nm}_{part}").reshape(-1)[off]
        blks = torch.stack([flat(nm, "blk", blk_off[:, c])
                            for c, (nm, _, _) in enumerate(layout)], dim=1)
        dis = torch.stack([flat(nm, "di", di_off[:, c])
                           for c, (nm, _, _) in enumerate(layout)], dim=1)
        want_b, want_i = trf._stage_factors(tbank, cfg, kc, kf, corr,
                                            predict_only=predict)
        assert len(layout) == want_b.shape[1]
        assert torch.equal(blks, want_b) and torch.equal(dis, want_i)
    k = torch.from_numpy(rng.integers(0, 9, B).astype(np.int32))
    fam = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32))
    prec = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32))
    active = torch.from_numpy(rng.integers(0, 2, B).astype(bool))
    ints = trf._stage_ints(k, kc, cfg, fam, prec, active, tbank,
                           fam_index=1, prec_index=0, with_corrector=corr)
    at_cfg = lambda t: t.reshape(-1)[cfg.long()].to(torch.int32)
    for col, t in ((2, tbank.n_steps), (4, tbank.stochastic),
                   (7, tbank.alg)):
        assert torch.equal(ints[:, col], at_cfg(t))
    use_c = at_cfg(tbank.corrector).bool() & (kc < at_cfg(tbank.n_steps) - 1)
    assert torch.equal(ints[:, 5].bool(), use_c & corr)
    assert torch.equal(ints[:, 3].bool(), active & (fam == 1) & (prec == 0))


def test_cpu_tensors_never_reach_the_kernel_and_cuda_ones_never_the_ref(
        monkeypatch, banks):
    """Dispatch is by device alone: a CPU state runs the plain version and
    the kernel wrapper is not called."""
    _, tbank = banks
    x = _torch_args(_inputs([0, 0, 0], seed=5))

    def boom(*a, **k):
        raise AssertionError("CPU tensors must not reach the kernel")

    monkeypatch.setattr(trf, "round_fused", boom)
    monkeypatch.setattr(trf, "round_predict_kernel", boom)
    trf.round_predict(x["u"], x["hist"], x["kc"], x["cfg"], tbank,
                      x["eps_c"], kf=KF)
    trf.round_update(x["u"], x["hist"], x["k"], x["kc"], x["cfg"], x["fam"],
                     x["prec"], x["keys"], x["active"], tbank, x["eps_c"],
                     sde=TCLD(), state_shape=(2,) + DATA, kf=KF)


def test_fused_round_cost_matches_jax():
    kw = dict(B=8, K=2, Qb=2, kf=2, D=3072, pool_rows=1)
    for corr in (False, True):
        assert trf.fused_round_cost(with_corrector=corr, **kw) == \
            jrf.fused_round_cost(with_corrector=corr, **kw)
