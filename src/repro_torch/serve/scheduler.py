"""FIFO scheduler with head-of-line grouping, and its online variant.

`take_group(n)` pops up to `n` requests from the front whose group key
equals the head's key.  The diffusion engine keys requests by their
(family, corrector, precision) cost class, so admission waves are
class-homogeneous and runs of same-class traffic tend to share rounds.
A request of another class waits for the current run to drain rather
than being reordered around it: simple and starvation-free.

The online path (`ServeLoop.serve_stream`) swaps in `DeadlineScheduler`:
the same queue surface, but admission order is urgency — priority first
(higher preempts strictly lower, see loop.py), earliest deadline within a
priority, arrival order as the tie-break so no-deadline requests cannot
starve.  Waves stay (group key)-homogeneous: the wave is built from the
most urgent request's class, in urgency order, skipping over other
classes instead of stopping at them.  Both are the JAX package's
schedulers, decision for decision.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, List, Optional


class Scheduler:
    def __init__(self, group_key: Callable[[Any], Any] = lambda r: None):
        self._queue: deque = deque()
        self._group_key = group_key

    def submit(self, request: Any) -> None:
        self._queue.append(request)

    def submit_all(self, requests) -> None:
        for r in requests:
            self.submit(r)

    @property
    def n_pending(self) -> int:
        return len(self._queue)

    def has_pending(self) -> bool:
        return bool(self._queue)

    def take_group(self, n: int) -> List[Any]:
        """Pop up to `n` front requests sharing the head's group key."""
        if n <= 0 or not self._queue:
            return []
        key = self._group_key(self._queue[0])
        group = []
        while self._queue and len(group) < n \
                and self._group_key(self._queue[0]) == key:
            group.append(self._queue.popleft())
        return group


def urgency_key(request: Any):
    """Total order on pending requests for the online path: priority
    strictly first (higher = smaller key = more urgent), earliest deadline
    within a priority (no deadline sorts last).  The scheduler appends its
    submission sequence number as the final tie-break, so among equals the
    order is FIFO and a request is overtaken only by a strictly more
    urgent one."""
    deadline = getattr(request, "deadline", None)
    has_deadline = deadline is not None
    return (-getattr(request, "priority", 0),
            not has_deadline, deadline if has_deadline else 0.0)


class DeadlineScheduler(Scheduler):
    """Urgency-ordered admission for `ServeLoop.serve_stream`.  The same
    `submit` / `take_group` surface as the FIFO scheduler; `peek()` exposes
    the most urgent pending request, so the loop can decide whether it
    justifies a preemption."""

    def __init__(self, group_key: Callable[[Any], Any] = lambda r: None):
        super().__init__(group_key)
        self._seq = 0

    def submit(self, request: Any) -> None:
        self._queue.append((self._seq, request))
        self._seq += 1

    def _order(self) -> List[Any]:
        return sorted(self._queue,
                      key=lambda e: urgency_key(e[1]) + (e[0],))

    def peek(self) -> Optional[Any]:
        if not self._queue:
            return None
        return self._order()[0][1]

    def take_group(self, n: int) -> List[Any]:
        """Up to `n` pending requests sharing the most urgent request's
        group key, in urgency order (other classes are skipped over, not
        waited behind)."""
        if n <= 0 or not self._queue:
            return []
        ordered = self._order()
        key = self._group_key(ordered[0][1])
        group = [e for e in ordered
                 if self._group_key(e[1]) == key][:n]
        for e in group:
            self._queue.remove(e)
        return [r for _, r in group]
