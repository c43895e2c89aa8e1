"""Front-tier router: shard an arrival stream over N engine replicas.

One engine saturates at its slot batch; heavier traffic needs a fleet.
The router is the tier in front of it, and a whole multi-replica run is a
pure function of (trace, config, seeds):

  * Arrivals come from a `TraceTraffic` on a `VirtualClock` (traffic.py):
    the router routes each request at its arrival time on the virtual
    clock, never wall time.
  * Requests cross the router only in wire form (`ServeRequest.to_wire()`
    dicts, serve/api.py), the form a process boundary carries.
  * Routing is two-phase: `plan()` assigns every arrival to a replica (an
    explicit, replayable assignment log), then the per-replica sub-traces
    run on real engines — here in this process (`serve()`), each replica
    an engine of its own (on one card, or one card each).  Because every
    sample and decode is a pure function of (seed, config), the routed
    results are bitwise the results of one engine serving the same trace.

Health and backpressure (all deterministic in virtual time):

  * **Health probes** fire every `probe_every` virtual units against every
    replica; a replica's health comes from its `ReplicaSpec.fault_windows`
    (deterministic fault injection).  Routing sees the last probed state,
    so a replica that dies mid-window keeps taking traffic until the next
    probe.
  * **Admission backpressure**: each replica serves at most
    `max_queue_depth` in-flight requests under the router's service model
    (`batch` engine slots draining `nfe` / `max_new` rounds per request).
    An arrival with no healthy, un-full replica is requeued
    `requeue_delay` later, up to `max_requeues` times, then shed; the
    assignment log records every hop.

The counters (`requests_routed`, `requeues`, `health_probes`, `n_shed`)
are exact at a fixed trace.  Pure Python, the JAX package's router
decision for decision; its multi-process form (spawned replica processes)
is not ported.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .api import ServeRequest
from .traffic import Arrival, TraceTraffic, VirtualClock


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One engine replica as the router sees it: an index, the slot
    capacity its service model drains with, and deterministic fault
    windows [a, b) during which health probes report it down."""
    index: int
    batch: int = 4
    fault_windows: Tuple[Tuple[float, float], ...] = ()

    def healthy_at(self, t: float) -> bool:
        return not any(a <= t < b for a, b in self.fault_windows)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing policy knobs.  Everything is denominated in virtual-clock
    units (one predictor round — see traffic.py), so a config + trace +
    seeds replays to an identical plan on any host."""
    max_queue_depth: int = 8        # in-flight bound per replica (backpressure)
    probe_every: float = 4.0        # health-probe cadence
    requeue_delay: float = 1.0      # retry delay when no replica admits
    max_requeues: int = 8           # retries before a request is shed
    round_cost: float = 1.0         # virtual cost of one engine round
    default_nfe: int = 10           # service-model cost when nfe is None
    default_max_new: int = 16       # service-model cost when max_new absent


@dataclasses.dataclass
class RoutePlan:
    """The deterministic output of `Router.plan`: per-replica wire-form
    sub-traces plus the audited assignment log and counters."""
    sub_traces: List[List[Tuple[float, Dict[str, Any]]]]
    assignments: List[Dict[str, Any]]   # {t, rid, replica, n_requeues}
    shed: List[Dict[str, Any]]          # {t, rid, n_requeues}
    counters: Dict[str, int]            # requests_routed / requeues /
                                        # health_probes / n_shed


class Router:
    """Deterministic front-tier over N replicas.  `plan()` computes the
    full assignment ahead of execution; `serve()` additionally drains the
    per-replica sub-traces through in-process engines and merges results.
    """

    def __init__(self, replicas: Sequence[ReplicaSpec],
                 config: Optional[RouterConfig] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        indices = [r.index for r in replicas]
        if indices != list(range(len(replicas))):
            raise ValueError(f"replica indices must be 0..N-1, got {indices}")
        self.replicas = list(replicas)
        self.config = config if config is not None else RouterConfig()

    # -- service-model cost of one request, in virtual-clock units --------
    def _cost(self, wire: Dict[str, Any]) -> float:
        cfg = self.config
        if wire.get("workload") == "token":
            rounds = wire.get("max_new") or cfg.default_max_new
        else:
            rounds = wire.get("nfe") or cfg.default_nfe
        return rounds * cfg.round_cost

    def plan(self, trace: TraceTraffic,
             clock: Optional[VirtualClock] = None) -> RoutePlan:
        """Route every arrival of `trace` to a replica.  Pure function of
        (trace, self.replicas, self.config): replaying the same inputs
        yields an identical plan, assignment log and counters."""
        cfg = self.config
        n = len(self.replicas)
        clock = clock if clock is not None else VirtualClock()

        # event heap: (t, seq, wire_request, n_requeues); seq is the
        # ingress order, so simultaneous events resolve deterministically
        events: List[Tuple[float, int, Dict[str, Any], int]] = []
        seq = 0
        for a in trace.due(float("inf")):
            req = a.request
            wire = req if isinstance(req, dict) else req.to_wire()
            heapq.heappush(events, (max(a.t, clock.now()), seq, wire, 0))
            seq += 1

        healthy = [True] * n            # last *probed* state per replica
        probe_t = clock.now()           # next probe tick
        busy_until: List[List[float]] = [
            [clock.now()] * r.batch for r in self.replicas]
        done_times: List[List[float]] = [[] for _ in range(n)]

        sub_traces: List[List[Tuple[float, Dict[str, Any]]]] = \
            [[] for _ in range(n)]
        assignments: List[Dict[str, Any]] = []
        shed: List[Dict[str, Any]] = []
        health_probes = requeues = 0

        def load(i: int, now: float) -> int:
            dt = done_times[i]
            while dt and dt[0] <= now:
                heapq.heappop(dt)
            return len(dt)

        while events:
            t, _, wire, hops = heapq.heappop(events)
            clock.advance_to(t)
            while probe_t <= t:          # probes due before this event
                for i, spec in enumerate(self.replicas):
                    healthy[i] = spec.healthy_at(probe_t)
                    health_probes += 1
                probe_t += cfg.probe_every

            candidates = [(load(i, t), i) for i in range(n)
                          if healthy[i] and load(i, t) < cfg.max_queue_depth]
            if not candidates:
                if hops >= cfg.max_requeues:
                    shed.append({"t": t, "rid": wire["rid"],
                                 "n_requeues": hops})
                    continue
                requeues += 1
                seq += 1
                heapq.heappush(events,
                               (t + cfg.requeue_delay, seq, wire, hops + 1))
                continue

            _, i = min(candidates)      # least-loaded, lowest index ties
            start = max(t, heapq.heappop(busy_until[i]))
            done = start + self._cost(wire)
            heapq.heappush(busy_until[i], done)
            heapq.heappush(done_times[i], done)
            sub_traces[i].append((t, wire))
            assignments.append({"t": t, "rid": wire["rid"], "replica": i,
                                "n_requeues": hops})

        return RoutePlan(
            sub_traces=sub_traces, assignments=assignments, shed=shed,
            counters={"requests_routed": len(assignments),
                      "requeues": requeues,
                      "health_probes": health_probes,
                      "n_shed": len(shed)})

    def replica_trace(self, plan: RoutePlan, index: int) -> TraceTraffic:
        """Replica `index`'s sub-trace, deserialized from wire form —
        exactly what that replica's engine `serve_stream`s."""
        return TraceTraffic([Arrival(t, ServeRequest.from_wire(w))
                             for t, w in plan.sub_traces[index]])

    def serve(self, trace: TraceTraffic, engines: Sequence[Any]):
        """Plan, then drain every sub-trace through the in-process
        `engines` (one per replica, each on its own virtual clock) and
        merge the per-request results.  Returns (results, plan)."""
        if len(engines) != len(self.replicas):
            raise ValueError(f"{len(self.replicas)} replicas but "
                             f"{len(engines)} engines")
        plan = self.plan(trace)
        results: Dict[int, Any] = {}
        for i, engine in enumerate(engines):
            if plan.sub_traces[i]:
                results.update(engine.serve_stream(
                    self.replica_trace(plan, i), clock=VirtualClock()))
        return results, plan
