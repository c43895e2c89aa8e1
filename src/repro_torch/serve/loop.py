"""`ServeLoop`: the continuous-batching core behind both engines.

The per-slot state the round step consumes lives on the device (state.py)
and the host keeps only a cheap shadow of it in the `SlotTable` — enough
to pace the loop, never shipped back to the device.  `serve()` runs a
closed list of requests:

    while pending or busy:
        _admit()                  # fill free slots (the only host->device
                                  #   traffic: prompts / prior draws)
        n = _rounds_until_poll()  # host-side lower bound on rounds until
                                  #   the next retirement, capped at
                                  #   sync_every
        n x _round()              # device-resident steps, queued on the
                                  #   stream without a sync
        _poll(results)            # one small fetch of the token done/
                                  #   progress mask, or host arithmetic
                                  #   (a sampler's retirement round is
                                  #   exactly predictable), plus the fetch
                                  #   of each finished result

`serve_stream()` is the online path: arrivals stream in from a
`TraceTraffic` against a virtual clock (traffic.py), admission is by
deadline / priority urgency (`DeadlineScheduler`) with preemption into a
host-side `ParkingTable` (parking.py), and the poll is double-buffered:
the engine snapshots what its poll reads, the look-ahead round is queued,
and only then does the host wait on the snapshot.  Both paths share the
admit / round / poll hooks.  The schedule — waves, preemptions, polls,
every timestamp — is the JAX package's, decision for decision.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.coeffs import bucket_size
from .parking import ParkingTable
from .scheduler import DeadlineScheduler
from .slots import SlotTable
from .traffic import RequestTiming, VirtualClock


def bucket_pow2(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at `cap` (prefill width buckets;
    the same doubling policy as the coefficient-bank buckets)."""
    return min(bucket_size(n, 1), cap)


def check_unique_rids(requests) -> None:
    seen = set()
    for r in requests:
        if r.rid in seen:
            raise ValueError(f"duplicate request rid {r.rid}: results are "
                             "keyed by rid, a duplicate would be dropped")
        seen.add(r.rid)


class ServeLoop:
    """Continuous-batching skeleton.  Subclasses provide:

      _validate(req)            raise ValueError on a bad request
      _prepare(requests)        size shared resources for the whole call
      _admit_wave(group, free)  place one admission wave into device state
      _round()                  dispatch one round step
      _poll(results, snap, lag) retire finished slots into `results`,
                                return the retire count
      _poll_snapshot()          what `_poll` reads, copied before the
                                look-ahead round (None: nothing to read)
      _suspend_slot(slot)       gather a slot's device rows, deactivate it
      _resume_slot(req, shadow, payload, index)  restore parked rows
      _remaining_lb(slot)       host-side lower bound on rounds until this
                                slot can retire (0 = may already be done)
    """

    #: greedy engines fill every free slot per admission cycle (token: waves
    #: are prompt-length buckets, nothing is gained by spacing them out);
    #: non-greedy engines admit ONE head-of-line wave per cycle, so a queued
    #: wave of a more expensive cost class does not land next to the cheap
    #: wave just admitted (diffusion: a corrector wave would drag
    #: predictor-only neighbours through the 2-eval program)
    greedy_admit = True

    def __init__(self, batch_size: int, scheduler, sync_every: int = 8):
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.batch_size = batch_size
        self.scheduler = scheduler
        self.sync_every = sync_every
        self.slots = SlotTable(batch_size)
        self.n_polls = 0
        # online surface (serve_stream): parked rows of preempted slots,
        # preemption counters, the per-request latency log, and the
        # per-call wave / preemption traces
        self.parking = ParkingTable()
        self.n_preemptions = 0
        self.n_resumes = 0
        self.request_log: Dict[int, RequestTiming] = {}
        self.wave_log: List[tuple] = []
        self.preemption_log: List[tuple] = []

    def serve(self, requests: List[Any]) -> Dict[int, np.ndarray]:
        check_unique_rids(requests)
        for r in requests:
            self._validate(r)
        self._prepare(requests)
        self.scheduler.submit_all(requests)
        self.wave_log = []
        results: Dict[int, np.ndarray] = {}
        while self.scheduler.has_pending() or self.slots.active_ids():
            self._admit()
            if not self.slots.active_ids():
                continue
            n = self._rounds_until_poll()
            for _ in range(n):
                self._round()
            retired = self._poll(results)
            self.n_polls += 1
            if n == 0 and not retired:
                # a zero lower bound that retires nothing would spin; the
                # engine's bounds make this unreachable, but a round is safe
                self._round()                           # pragma: no cover
        return results

    def serve_stream(self, traffic, clock: Optional[VirtualClock] = None,
                     round_cost: float = 1.0) -> Dict[int, np.ndarray]:
        """Online serving: pull arrivals from `traffic` (serve/traffic.py)
        as `clock` reaches each arrival time, admit by deadline / priority
        urgency with preemption, and double-buffer the poll.  Returns the
        results keyed by rid, like `serve`; each request's arrival,
        admission and completion times land in `request_log` (summarized by
        `traffic.serving_metrics`).

        The clock is virtual by default: it advances one `round_cost` per
        dispatched round and jumps over idle gaps, so a run is a pure
        function of (trace, engine, seeds).

        Scheduling contract:

          * admission order is urgency — priority, then earliest deadline,
            then arrival (`DeadlineScheduler`); waves never mix cost
            classes;
          * a pending request preempts only a strictly lower priority
            active slot (lowest priority first, most remaining work as the
            tie-break); the victim's rows are parked on the host and
            restored bitwise on resume, so preemption changes when a
            result is computed, never the result;
          * polls happen only when a retirement is possible (the host lower
            bound reached zero) or `sync_every` rounds have run.
        """
        clock = VirtualClock() if clock is None else clock
        if round_cost <= 0:
            raise ValueError(f"round_cost must be > 0, got {round_cost}")
        results: Dict[int, np.ndarray] = {}
        self.request_log = {}
        self.wave_log = []
        self.preemption_log = []
        seen: set = set()
        fifo = self.scheduler
        self.scheduler = DeadlineScheduler(group_key=fifo._group_key)
        since_poll = 0          # rounds dispatched since the last poll
        try:
            while True:
                for arr in traffic.due(clock.now()):
                    r = arr.request
                    if r.rid in seen:
                        raise ValueError(
                            f"duplicate request rid {r.rid} in trace")
                    seen.add(r.rid)
                    self._validate(r)
                    self._prepare([r])
                    self.scheduler.submit(r)
                    self.request_log[r.rid] = RequestTiming(
                        t_arrival=arr.t,
                        deadline=getattr(r, "deadline", None),
                        priority=getattr(r, "priority", 0))
                if not (self.slots.active_ids()
                        or self.scheduler.has_pending()):
                    nxt = traffic.next_time()
                    if nxt is None:
                        break                     # drained: the stream ends
                    clock.advance_to(nxt)         # idle: skip to the next
                    continue                      # arrival
                self._admit_stream(now=clock.now())
                active = self.slots.active()
                if not active:                              # pragma: no cover
                    nxt = traffic.next_time()     # pending but unadmittable
                    if nxt is None:               # cannot happen: free
                        break                     # slots exist whenever
                    clock.advance_to(nxt)         # nothing is active
                    continue
                # window: rounds until the earliest of (possible
                # retirement, forced poll, next arrival); each dispatched
                # round advances the clock, the look-ahead included
                lb = min(self._remaining_lb(s) for s in active)
                n = min(lb, self.sync_every - since_poll)
                nxt = traffic.next_time()
                if nxt is not None:
                    gap = int(math.ceil((nxt - clock.now()) / round_cost))
                    n = min(n, max(gap, 1))
                for _ in range(max(n, 0)):
                    self._round()
                    clock.advance(round_cost)
                    since_poll += 1
                # an arrival-capped window ends with no slot at its
                # retirement bound: skip the poll (frozen rows make a late
                # observation safe; `sync_every` still forces one)
                if (lb - max(n, 0)) > 0 and since_poll < self.sync_every:
                    continue
                # double-buffered poll: snapshot what the poll reads, queue
                # the look-ahead round, then wait on the snapshot — round
                # k + 1 runs while the host waits on round k
                t_mark = clock.now()
                snap = self._poll_snapshot()
                nxt = traffic.next_time()
                lag = 0
                if (nxt is None or nxt > clock.now()) \
                        and any(self._remaining_lb(s) > 0
                                for s in self.slots.active()):
                    self._round()
                    clock.advance(round_cost)
                    lag = 1
                before = set(results)
                self._poll(results, snap=snap, lag=lag)
                self.n_polls += 1
                since_poll = lag
                for rid in set(results) - before:
                    timing = self.request_log.get(rid)
                    if timing is not None:
                        timing.t_done = t_mark
            if len(self.parking):
                raise RuntimeError(f"requests {self.parking.rids()} are "
                                   "still parked after the stream drained")
            return results
        finally:
            self.scheduler = fifo

    def _admit(self) -> None:
        """Fill free slots from the queue in class-homogeneous waves (one
        `take_group` run each): every wave for greedy engines, a single
        head-of-line wave per cycle otherwise (see `greedy_admit`)."""
        while True:
            free = self.slots.free_ids()
            group = self.scheduler.take_group(len(free))
            if not group:
                return
            self._place_group(group, free)
            if not self.greedy_admit:
                return

    def _admit_stream(self, now: float) -> int:
        """Online admission: fill free slots in urgency order, then let the
        most urgent pending request preempt strictly lower priority active
        slots while the batch is full.  Each eviction parks the victim's
        rows on the host and re-queues it (it competes again by its own
        urgency), so every iteration admits the pending head that justified
        it and eviction chains strictly descend in priority."""
        admitted = 0
        while True:
            free = self.slots.free_ids()
            group = self.scheduler.take_group(len(free))
            if not group:
                break
            self._place_group(group, free, now=now)
            admitted += len(group)
            if not self.greedy_admit:
                break
        while True:
            head = self.scheduler.peek()
            if head is None or self.slots.free_ids():
                break
            prio = getattr(head, "priority", 0)
            victims = [s for s in self.slots.active()
                       if getattr(s.request, "priority", 0) < prio]
            if not victims:
                break
            victim = min(victims, key=lambda s: (
                getattr(s.request, "priority", 0),
                -self._remaining_lb(s), s.index))
            self.preemption_log.append(
                (head.rid, prio, victim.request.rid,
                 getattr(victim.request, "priority", 0)))
            self._suspend(victim)
            free = self.slots.free_ids()
            group = self.scheduler.take_group(len(free))
            if group:
                self._place_group(group, free, now=now)
                admitted += len(group)
        return admitted

    def _place_group(self, group, free, now: Optional[float] = None) -> None:
        """Land one class-homogeneous wave: fresh requests through the
        engine's admission, parked ones through the bitwise row restore.
        `free` is consumed left to right, fresh requests first."""
        self.wave_log.append(
            tuple(self.scheduler._group_key(r) for r in group))
        fresh = [r for r in group if r.rid not in self.parking]
        parked = [r for r in group if r.rid in self.parking]
        if fresh:
            self._admit_wave(fresh, list(free[:len(fresh)]))
        for j, r in enumerate(parked):
            payload, shadow, _ = self.parking.pop(r.rid)
            index = free[len(fresh) + j]
            self._resume_slot(r, shadow, payload, index)
            self.slots.assign(index, r, **shadow)
            self.n_resumes += 1
        if now is not None:
            for r in group:
                timing = self.request_log.get(r.rid)
                if timing is not None and timing.t_admit is None:
                    timing.t_admit = now

    def _suspend(self, slot) -> None:
        """Preempt one active slot: park its device rows on the host (the
        engine's `_suspend_slot` gathers them and deactivates the device
        row), free the slot, and re-queue the request."""
        req = slot.request
        payload = self._suspend_slot(slot)
        self.parking.park(req.rid, payload, slot.data, req)
        self.slots.release(slot.index)
        self.scheduler.submit(req)
        self.n_preemptions += 1
        timing = self.request_log.get(req.rid)
        if timing is not None:
            timing.n_preempted += 1

    def _rounds_until_poll(self) -> int:
        lb = min(self._remaining_lb(s) for s in self.slots.active())
        return max(0, min(lb, self.sync_every))

    # ---- engine hooks -------------------------------------------------------
    def _validate(self, req) -> None:
        raise NotImplementedError

    def _prepare(self, requests) -> None:
        """Batch-level hook before any request is queued."""

    def _admit_wave(self, group, free) -> None:
        raise NotImplementedError

    def _round(self) -> None:
        raise NotImplementedError

    def _poll(self, results, snap=None, lag: int = 0) -> int:
        """Retire finished slots into `results`.  `snap` (from
        `_poll_snapshot`) is what the double-buffered online poll reads
        instead of the live state; `lag` counts the rounds dispatched after
        it (the look-ahead), so the shadow resync stays exact."""
        raise NotImplementedError

    def _poll_snapshot(self):
        """A copy of what `_poll` reads, taken before the look-ahead round
        is queued.  None for engines whose poll is host arithmetic
        (diffusion: retirement is exactly predictable)."""
        return None

    def _suspend_slot(self, slot):
        """Gather slot `slot.index`'s device rows for parking and
        deactivate the device row; returns the rows."""
        raise NotImplementedError

    def _resume_slot(self, request, shadow, payload, index: int) -> None:
        """Restore a parked payload into slot row `index`, bitwise."""
        raise NotImplementedError

    def _remaining_lb(self, slot) -> int:
        raise NotImplementedError
