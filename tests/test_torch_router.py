"""The port's in-process `Router` against the JAX package's, on the CPU.

Tiers:
  * `Router.plan` on one seeded trace — with a replica fault window, a
    small queue bound and a requeue limit, so the plan requeues, probes
    and sheds — equals JAX's: the per-replica wire sub-traces, the
    assignment log, the sheds and the counters (pure Python: equal);
  * `Router.serve` over two port engines equals one port engine's
    `serve_stream` of the same trace, bitwise (a sample is a function of
    its seed and config alone).
"""
import math

import numpy as np
import pytest

from repro.serve import ReplicaSpec as JReplica
from repro.serve import Router as JRouter
from repro.serve import RouterConfig as JRouterConfig
from repro.serve import ServeRequest as JRequest
from repro.serve.traffic import poisson_trace as jpoisson
from repro_torch.configs import get_diffusion
from repro_torch.serve import (DiffusionEngine, ReplicaSpec, Router,
                               RouterConfig, ServeRequest, TraceTraffic,
                               VirtualClock, poisson_trace)

FLEET = dict(max_queue_depth=2, probe_every=3.0, requeue_delay=1.5,
             max_requeues=2, default_nfe=4)


def _trace(cls, poisson, n=14):
    mk = lambda i, rng: cls(rid=i, seed=i, nfe=int(rng.integers(3, 6)),
                            priority=int(rng.integers(0, 2)))
    return poisson(mk, n=n, rate=1.8, seed=5)


def _router(spec_cls, router_cls, cfg_cls, faults=((4.0, 10.0),)):
    return router_cls([spec_cls(index=0, batch=2),
                       spec_cls(index=1, batch=2, fault_windows=faults)],
                      cfg_cls(**FLEET))


def test_plan_is_the_jax_packages():
    got = _router(ReplicaSpec, Router, RouterConfig).plan(
        _trace(ServeRequest, poisson_trace))
    want = _router(JReplica, JRouter, JRouterConfig).plan(
        _trace(JRequest, jpoisson))
    assert got.sub_traces == want.sub_traces
    assert got.assignments == want.assignments
    assert got.shed == want.shed
    assert got.counters == want.counters
    # the trace does what it claims: requeues, sheds and probes happen
    assert got.counters["requeues"] > 0 and got.counters["n_shed"] > 0
    assert got.counters["health_probes"] > 0
    assert got.counters["requests_routed"] + got.counters["n_shed"] == 14


def test_router_refuses_bad_fleets():
    with pytest.raises(ValueError):
        Router([])
    with pytest.raises(ValueError):
        Router([ReplicaSpec(index=1)])
    r = _router(ReplicaSpec, Router, RouterConfig)
    with pytest.raises(ValueError):
        r.serve(_trace(ServeRequest, poisson_trace), [object()])


def test_routed_results_equal_one_engine_bitwise():
    spec = get_diffusion("cifar10-ddpm", reduced=True)
    net = spec.init(seed=0, device="cpu")
    engine = lambda: DiffusionEngine(spec, net, batch_size=2, nfe=4,
                                     device="cpu")
    router = Router([ReplicaSpec(index=i, batch=2) for i in (0, 1)],
                    RouterConfig(default_nfe=4))
    trace = lambda: _trace(ServeRequest, poisson_trace, n=8)
    routed, plan = router.serve(trace(), [engine(), engine()])
    assert all(plan.sub_traces) and plan.counters["n_shed"] == 0
    restored = [a.request for i in (0, 1)
                for a in router.replica_trace(plan, i).due(math.inf)]
    assert all(isinstance(r, ServeRequest) for r in restored)
    assert sorted(r.rid for r in restored) == \
        sorted(a["rid"] for a in plan.assignments)
    solo = engine().serve_stream(trace(), clock=VirtualClock())
    assert sorted(routed) == sorted(solo) == list(range(8))
    for rid in solo:
        np.testing.assert_array_equal(routed[rid], solo[rid],
                                      err_msg=f"request {rid}")
    # the shed-everything residue drains without a round
    eng = engine()
    assert eng.serve_stream(TraceTraffic([])) == {} and eng.n_rounds == 0
