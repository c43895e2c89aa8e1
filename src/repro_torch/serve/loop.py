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
                                  #   SYNC_EVERY
        n x _round()              # device-resident steps, queued on the
                                  #   stream without a sync
        _poll(results)            # one small fetch of the token done/
                                  #   progress mask, or host arithmetic
                                  #   (a sampler's retirement round is
                                  #   exactly predictable), plus the fetch
                                  #   of each finished result

Streaming arrivals, deadline scheduling and preemption belong to a later
slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..core.coeffs import bucket_size
from .slots import SlotTable

SYNC_EVERY = 8      # most rounds queued between two polls (the JAX default)


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
      _poll(results)            retire finished slots into `results`,
                                return the retire count
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

    def __init__(self, batch_size: int, scheduler):
        self.batch_size = batch_size
        self.scheduler = scheduler
        self.slots = SlotTable(batch_size)
        self.n_polls = 0
        self.wave_log: List[tuple] = []

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

    def _admit(self) -> None:
        """Fill free slots from the queue in class-homogeneous waves (one
        `take_group` run each): every wave for greedy engines, a single
        head-of-line wave per cycle otherwise (see `greedy_admit`)."""
        while True:
            free = self.slots.free_ids()
            group = self.scheduler.take_group(len(free))
            if not group:
                return
            self.wave_log.append(
                tuple(self.scheduler._group_key(r) for r in group))
            self._admit_wave(group, list(free[:len(group)]))
            if not self.greedy_admit:
                return

    def _rounds_until_poll(self) -> int:
        lb = min(self._remaining_lb(s) for s in self.slots.active())
        return max(0, min(lb, SYNC_EVERY))

    # ---- engine hooks -------------------------------------------------------
    def _validate(self, req) -> None:
        raise NotImplementedError

    def _prepare(self, requests) -> None:
        """Batch-level hook before any request is queued."""

    def _admit_wave(self, group, free) -> None:
        raise NotImplementedError

    def _round(self) -> None:
        raise NotImplementedError

    def _poll(self, results) -> int:
        raise NotImplementedError

    def _remaining_lb(self, slot) -> int:
        raise NotImplementedError
