"""Streaming traffic for the online serving loop: seeded arrival traces,
the virtual clock they are replayed against, and per-request latency
accounting.

`ServeLoop.serve()` consumes a closed request list; the online path
(`ServeLoop.serve_stream`) instead pulls an open-ended stream of arrivals
from a `TraceTraffic` as a clock reaches their arrival times.  Nothing in
this module reads wall time: the clock is an explicit object, and the
default `VirtualClock` advances only when the loop dispatches rounds (one
`round_cost` per round) or deliberately skips ahead to the next arrival.
That makes an online run a pure function of (trace, engine config, seeds):
the same seeded trace replays to the same schedule, latencies and
preemptions, on the CPU or the card.

Time unit: one predictor round of the engine (`round_cost`, default 1.0).
Deadlines and the latency columns are denominated in the same unit, so a
diffusion request admitted at t with NFE n and an idle engine completes at
exactly t + n.

Traffic shapes:

  * `TraceTraffic([Arrival(t, request), ...])` — an explicit hand-written
    trace.
  * `poisson_trace(make_request, n, rate, seed)` — seeded Poisson arrivals:
    interarrival gaps are exponential(1/rate) draws from a
    `numpy.random.default_rng(seed)`, so the same seed always yields the
    same trace.

Deadlines and priorities ride on the request (`ServeRequest.deadline` /
`.priority`): the traffic layer only decides arrival times; urgency policy
lives in `DeadlineScheduler`.  The module is numpy only, the same code as
the JAX package's, so both tiers replay one trace identically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class VirtualClock:
    """Explicit simulation time.  The online loop advances it one
    `round_cost` per dispatched round and jumps it to the next arrival when
    the engine is idle; tests construct one directly and read `now()` to
    hand-check the schedule.  Monotone by construction (`advance` rejects
    negative steps, `advance_to` is a no-op for past times)."""

    def __init__(self, t0: float = 0.0):
        self._t = t0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t += dt

    def advance_to(self, t: float) -> None:
        if t > self._t:
            self._t = t


@dataclasses.dataclass
class Arrival:
    """One scheduled arrival: `request` becomes visible to the loop once
    the clock reaches `t` (never before — the loop cannot peek)."""
    t: float
    request: Any


class TraceTraffic:
    """An arrival trace consumed in time order.  `due(now)` pops every
    arrival with t <= now; `next_time()` is the earliest remaining arrival
    (None once drained) — the loop uses it to bound a round window so an
    arrival is never overrun by more than one round, and to skip the clock
    forward over idle gaps."""

    def __init__(self, arrivals: List[Arrival]):
        self._queue = sorted(arrivals, key=lambda a: a.t)
        self._head = 0

    def due(self, now: float) -> List[Arrival]:
        start = self._head
        while self._head < len(self._queue) \
                and self._queue[self._head].t <= now:
            self._head += 1
        return self._queue[start:self._head]

    def next_time(self) -> Optional[float]:
        if self._head >= len(self._queue):
            return None
        return self._queue[self._head].t

    def remaining(self) -> int:
        return len(self._queue) - self._head


def poisson_trace(make_request: Callable[[int, np.random.Generator], Any],
                  n: int, rate: float, seed: int,
                  start: float = 0.0) -> TraceTraffic:
    """Seeded Poisson arrival process: `n` arrivals at exponential(1/rate)
    gaps from `start`, each request built by `make_request(i, rng)` (the
    rng is the same seeded generator, so request attributes drawn from it
    — priorities, deadline slack, config choice — replay with the trace).
    Arrival times are converted to host floats at construction: the whole
    trace is plain Python data, nothing numpy leaks into the clock."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n).tolist()
    arrivals, t = [], start
    for i in range(n):
        t += gaps[i]
        arrivals.append(Arrival(t=t, request=make_request(i, rng)))
    return TraceTraffic(arrivals)


# ---------------------------------------------------------------------------
# per-request latency accounting
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RequestTiming:
    """arrival -> admission -> completion timestamps for one request, all
    in virtual-clock units.  `t_admit` is stamped at *first* admission;
    `n_preempted` counts suspensions (each resume restores the slot row
    bitwise, so preemption moves these timestamps, never the sample)."""
    t_arrival: float
    deadline: Optional[float] = None
    priority: int = 0
    t_admit: Optional[float] = None
    t_done: Optional[float] = None
    n_preempted: int = 0

    @property
    def latency(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival

    @property
    def met_slo(self) -> bool:
        """Completed within its deadline (no deadline = always met)."""
        return self.t_done is not None and (
            self.deadline is None or self.t_done <= self.deadline)


def percentile(xs: List[float], p: float) -> float:
    """Linear-interpolation percentile (numpy's default method), in pure
    host Python, so a hand-written log has a hand-computable value and the
    result is a plain float."""
    if not xs:
        raise ValueError("percentile of an empty sample")
    xs = sorted(xs)
    rank = (len(xs) - 1) * (p / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def serving_metrics(log: Dict[int, RequestTiming]) -> Dict[str, Any]:
    """Latency/goodput summary of one online run, from the loop's
    `request_log`.  All values are deterministic at a fixed trace:

      p50_latency / p99_latency — arrival->completion percentiles, in
                                  virtual rounds; None when the run
                                  completed nothing (a percentile of an
                                  empty sample has no value — reporting
                                  0.0 here read as "instant completion"
                                  on shed-everything runs)
      deadline_misses           — completed requests whose t_done exceeded
                                  their deadline (unfinished requests with
                                  a deadline also count: a shed or
                                  still-queued request has already lost
                                  its SLO)
      goodput_slo               — SLO-met completions per virtual round,
                                  over the span from the first arrival to
                                  the last completion; 0.0 when nothing
                                  completed

    A zero-completion log is a valid input (e.g. every request shed):
    the latency percentiles are None, goodput is 0.0, and deadline
    misses still count the unfinished-with-deadline requests.
    """
    timings = list(log.values())
    done = [t for t in timings if t.t_done is not None]
    lats = [t.latency for t in done]
    misses = sum(1 for t in timings
                 if t.deadline is not None and not t.met_slo)
    n_ok = sum(1 for t in done if t.met_slo)
    span = 0.0
    if done:
        span = max(t.t_done for t in done) - \
            min(t.t_arrival for t in timings)
    return {
        "n_arrived": len(timings),
        "n_done": len(done),
        "p50_latency": percentile(lats, 50.0) if lats else None,
        "p99_latency": percentile(lats, 99.0) if lats else None,
        "deadline_misses": misses,
        "goodput_slo": (n_ok / span) if span > 0 else 0.0,
        "span": span,
    }
