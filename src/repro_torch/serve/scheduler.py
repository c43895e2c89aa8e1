"""FIFO scheduler with head-of-line grouping.

`take_group(n)` pops up to `n` requests from the front whose group key
equals the head's key.  The diffusion engine keys requests by their
(family, corrector, precision) cost class, so admission waves are
class-homogeneous and runs of same-class traffic tend to share rounds.
A request of another class waits for the current run to drain rather
than being reordered around it: simple and starvation-free.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, List


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
