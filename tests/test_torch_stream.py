"""Online serving in the port against the JAX package's, on the CPU:
`serve_stream` with deadline admission and preemption, over a three-family
`DiffusionEngine` and over the `TokenEngine`.

Host pieces (`poisson_trace`, `DeadlineScheduler`, `percentile`,
`serving_metrics`) are the JAX package's decision for decision: bitwise.

One module-scoped reference serve per engine kind.  The diffusion engine is
reduced `{vpsde: cifar10-ddpm, cld: cifar10-cld, bdm: cifar10-bdm}` at batch
4, NFE 4, with the same random non-zero weights in both packages (carried
by `repro_torch.convert`); it `serve_stream`s one seeded Poisson trace of
nine requests that mixes the three families, both corrector settings and
q 1 / 2, whose priorities and deadlines force two preemptions — one of a
q 2 VPSDE render at k 2, with its eps history live.  The JAX side runs
under `jax.threefry_partitionable(False)`, the counter layout the port
implements.

Tiers:
  * schedule (`wave_log`, `preemption_log`, counters, every `request_log`
    timestamp): equal;
  * samples: within 1e-5 of each sample's largest magnitude (the engine
    bound of test_torch_engine.py: the DiT's f32 rounding carried through
    at most 4 steps);
  * port only: every streamed (and preempted) result equals the same
    request served alone by a closed `serve` of the same engine, bitwise;
  * token engine: schedule and tokens equal to JAX's; the preempted and
    resumed stream equals the uninterrupted one, bitwise.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import sde as jsde
from repro.configs import get_diffusion as jget
from repro.serve import Arrival as JArrival
from repro.serve import DiffusionEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro.serve import TokenEngine as JTokenEngine
from repro.serve import TraceTraffic as JTrace
from repro.serve.scheduler import DeadlineScheduler as JDeadline
from repro.serve.traffic import RequestTiming as JTiming
from repro.serve.traffic import percentile as jpercentile
from repro.serve.traffic import poisson_trace as jpoisson
from repro.serve.traffic import serving_metrics as jmetrics
from repro_torch import convert
from repro_torch import sde as tsde
from repro_torch.configs import get_diffusion as tget
from repro_torch.serve import (Arrival, DeadlineScheduler, DiffusionEngine,
                               RequestTiming, ServeRequest, TokenEngine,
                               TraceTraffic, percentile, poisson_trace,
                               serving_metrics)

from tests.test_torch_lm import _archs, random_tree

BOUND = 1e-5
CONFIGS = {"vpsde": "cifar10-ddpm", "cld": "cifar10-cld",
           "bdm": "cifar10-bdm"}
# the trace's requests, by arrival order: families, q, corrector and
# urgency; every request at the engine's NFE 4
KINDS = [dict(family="cld", q=2), dict(family="vpsde", q=2),
         dict(family="bdm"), dict(family="cld", corrector=True),
         dict(family="vpsde", q=2), dict(family="bdm", priority=2),
         dict(family="cld", corrector=True, priority=3),
         dict(family="vpsde", priority=1), dict(family="cld", q=2)]
TRACE_SEED, TRACE_RATE = 2, 1.5


def _make(i, rng):
    kw = dict(KINDS[i])
    if kw.get("priority"):
        kw["deadline"] = float(rng.integers(8, 16))
    return ServeRequest(rid=i, seed=100 + i, **kw)


def _trace():
    return poisson_trace(_make, n=len(KINDS), rate=TRACE_RATE,
                         seed=TRACE_SEED)


def _jax_trace(trace):
    return JTrace([JArrival(a.t, JRequest.from_wire(a.request.to_wire()))
                   for a in trace.due(math.inf)])


# ---- host pieces: bitwise JAX's ------------------------------------------
def test_poisson_trace_is_the_jax_packages():
    mk = lambda cls: lambda i, rng: cls(
        rid=i, seed=i, nfe=int(rng.integers(2, 9)),
        priority=int(rng.integers(0, 3)))
    got = poisson_trace(mk(ServeRequest), n=20, rate=0.7, seed=11)
    want = jpoisson(mk(JRequest), n=20, rate=0.7, seed=11)
    g, w = got.due(math.inf), want.due(math.inf)
    assert [a.t for a in g] == [a.t for a in w]
    assert [a.request.to_wire() for a in g] == \
        [a.request.to_wire() for a in w]
    assert [a.request.to_wire() for a in _trace().due(math.inf)] == \
        [a.request.to_wire() for a in
         _jax_trace(_trace()).due(math.inf)]


def test_deadline_scheduler_order_is_the_jax_packages():
    rng = np.random.default_rng(4)
    kw = [dict(rid=i, seed=i, family=["vpsde", "cld"][int(rng.integers(2))],
               priority=int(rng.integers(0, 3)),
               deadline=None if rng.integers(2) else float(rng.integers(40)))
          for i in range(24)]
    key = lambda r: r.family
    got, want = DeadlineScheduler(key), JDeadline(key)
    got.submit_all([ServeRequest(**k) for k in kw])
    want.submit_all([JRequest(**k) for k in kw])
    order = lambda s: [[r.rid for r in s.take_group(n)]
                       for n in (3, 1, 5, 2, 4, 6, 8)]
    assert got.peek().rid == want.peek().rid
    assert order(got) == order(want)
    assert not got.has_pending() and not want.has_pending()


def test_percentile_and_serving_metrics_are_the_jax_packages():
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 10, size=17).tolist()
    for p in (0.0, 25.0, 50.0, 99.0, 100.0):
        assert percentile(xs, p) == jpercentile(xs, p)
    rows = [dict(t_arrival=0.0, deadline=4.0, t_admit=0.0, t_done=3.0),
            dict(t_arrival=1.0, t_admit=2.0, t_done=9.5, n_preempted=1),
            dict(t_arrival=2.0, deadline=5.0, priority=2, t_admit=2.0,
                 t_done=7.0),
            dict(t_arrival=3.5, deadline=6.0),
            dict(t_arrival=4.0, t_admit=4.0, t_done=8.0)]
    got = serving_metrics({i: RequestTiming(**r) for i, r in enumerate(rows)})
    want = jmetrics({i: JTiming(**r) for i, r in enumerate(rows)})
    assert got == want
    assert serving_metrics({}) == jmetrics({})


# ---- the three-family engine against the JAX reference -----------------
def _memo_cld(cld):
    for name in ("Psi_np", "Sigma_np", "R_np"):
        # pure float64 closed forms: a memo per argument changes no value,
        # it spares Stage I repeated expm calls (both packages)
        setattr(cld, name, functools.lru_cache(maxsize=None)(
            getattr(cld, name)))
    return cld


@pytest.fixture(scope="module")
def streamed():
    jspecs, tspecs, jparams, nets = {}, {}, {}, {}
    for i, (fam, name) in enumerate(CONFIGS.items()):
        jspec, tspec = jget(name, reduced=True), tget(name, reduced=True)
        if fam == "cld":
            jspec = dataclasses.replace(
                jspec, sde=_memo_cld(jsde.CLD(grid_substeps=1)))
            tspec = dataclasses.replace(
                tspec, sde=_memo_cld(tsde.CLD(grid_substeps=1)))
        tree = random_tree(jspec.param_shapes(), seed=20 + i)
        net = tspec.init(seed=0, device="cpu")
        net.load_state_dict(convert.from_jax_params(tree))
        jspecs[fam], tspecs[fam] = jspec, tspec
        jparams[fam], nets[fam] = jax.tree.map(jnp.asarray, tree), net

    jeng = JEngine(jspecs, jparams, batch_size=4, nfe=4, sync_every=4)
    with jax.threefry_partitionable(False):
        want = jeng.serve_stream(_jax_trace(_trace()))
    teng = DiffusionEngine(tspecs, nets, batch_size=4, nfe=4, sync_every=4,
                           device="cpu")
    got = teng.serve_stream(_trace())
    return jeng, want, teng, got


def test_stream_schedule_is_the_jax_packages(streamed):
    jeng, _, teng, _ = streamed
    assert teng.wave_log == jeng.wave_log
    assert teng.preemption_log == jeng.preemption_log
    for attr in ("n_preemptions", "n_resumes", "n_steps", "n_rounds",
                 "n_polls", "n_samples_out"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert sorted(teng.request_log) == sorted(jeng.request_log)
    for rid, t in teng.request_log.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(
            jeng.request_log[rid]), rid
    # the trace does what it claims: two preemptions, one of them a q 2
    # render with its eps history live (k >= 2 when parked), all three
    # families and both corrector settings served
    assert teng.n_preemptions == teng.n_resumes == 2
    victims = [v for _, _, v, _ in teng.preemption_log]
    assert any(KINDS[v].get("q") == 2 for v in victims)
    classes = {c for wave in teng.wave_log for c in wave}
    assert {c[0] for c in classes} == set(CONFIGS)
    assert {c[1] for c in classes} == {False, True}


def test_stream_samples_match_jax(streamed):
    _, want, _, got = streamed
    assert sorted(got) == sorted(want) == list(range(len(KINDS)))
    for rid in want:
        a, b = np.asarray(want[rid]), got[rid]
        assert b.shape == a.shape == (8, 8, 3) and np.isfinite(b).all()
        assert np.abs(a).max() > 0.1
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=BOUND * np.abs(a).max(),
                                   err_msg=f"request {rid} {KINDS[rid]}")


def test_streamed_and_preempted_equal_solo_bitwise(streamed):
    _, _, teng, got = streamed
    assert len(teng.parking) == 0
    assert teng.parking.n_parked_total == teng.n_preemptions
    for a in _trace().due(math.inf):
        r = a.request
        solo = teng.serve([r])[r.rid]
        np.testing.assert_array_equal(
            got[r.rid], solo, err_msg=f"request {r.rid} {KINDS[r.rid]}: "
            "streamed != served alone")


def test_mismatched_families_are_refused():
    tspec = tget("cifar10-ddpm", reduced=True)
    net = tspec.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="same family names"):
        DiffusionEngine({"vpsde": tspec}, {"cld": net}, batch_size=2,
                        device="cpu")
    big = dataclasses.replace(tspec, data_shape=(16, 16, 3))
    with pytest.raises(ValueError, match="share a data_shape"):
        DiffusionEngine({"vpsde": tspec, "cld": big},
                        {"vpsde": net, "cld": net}, batch_size=2,
                        device="cpu")


# ---- the token engine -----------------------------------------------------
@pytest.fixture(scope="module")
def token_streamed():
    jarch, tarch = _archs(6)
    tree = random_tree(jarch.param_shapes(), seed=6)
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=rid, workload="token",
                         tokens=rng.integers(2, 256, size=6).astype(np.int32),
                         max_new=m, **kw)
            for rid, m, kw in ((0, 12, {}), (1, 12, {}),
                               (2, 8, dict(priority=3, deadline=20.0)))]
    times = (0.0, 0.0, 3.0)
    trace = lambda: TraceTraffic([Arrival(t, r) for t, r in zip(times, reqs)])
    jeng = JTokenEngine(jarch, jax.tree.map(jnp.asarray, tree), batch_size=2,
                        max_len=48, sync_every=4)
    want = jeng.serve_stream(_jax_trace(trace()))
    params = convert.from_jax_transformer(tree, tarch.cfg)
    teng = TokenEngine(tarch, params, batch_size=2, max_len=48, sync_every=4,
                       device="cpu")
    got = teng.serve_stream(trace())
    solo = TokenEngine(tarch, params, batch_size=2, max_len=48, device="cpu")
    alone = {r.rid: solo.serve([r])[r.rid] for r in reqs}
    return jeng, want, teng, got, alone


def test_token_stream_matches_jax(token_streamed):
    jeng, want, teng, got, _ = token_streamed
    assert teng.n_preemptions == jeng.n_preemptions == 1
    assert teng.n_resumes == jeng.n_resumes == 1
    assert teng.preemption_log == jeng.preemption_log
    assert teng.wave_log == jeng.wave_log
    for attr in ("n_decode_steps", "n_prefill_calls", "n_polls",
                 "n_tokens_out"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    for rid, t in teng.request_log.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(
            jeng.request_log[rid]), rid
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")


def test_token_resumed_equals_uninterrupted(token_streamed):
    _, _, teng, got, alone = token_streamed
    assert len(teng.parking) == 0
    for rid, toks in alone.items():
        np.testing.assert_array_equal(got[rid], toks,
                                      err_msg=f"request {rid}")
