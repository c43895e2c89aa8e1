"""Slot table: host-side bookkeeping for the continuous-batching engine.

A slot is one row of the device batch.  The engine allocates its slots
once; requests are admitted into free slots, run to completion at their
own per-slot position, retire, and the slot is refilled.

The table holds only the host's shadow of a slot: which request occupies it
(results are keyed by rid) and the cheap progress counters that pace the
loop (`k` for sampler slots).  The authoritative per-slot state lives on
the device in the engine's `DiffusionState`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Slot:
    """One batch row.  `request` is None while free; `data` holds the host
    shadow of the slot's progress."""
    index: int
    request: Optional[Any] = None
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def free(self) -> bool:
        return self.request is None


class SlotTable:
    def __init__(self, n_slots: int):
        self.slots: List[Slot] = [Slot(i) for i in range(n_slots)]

    def free_ids(self) -> List[int]:
        return [s.index for s in self.slots if s.free]

    def active_ids(self) -> List[int]:
        return [s.index for s in self.slots if not s.free]

    def active(self) -> List[Slot]:
        return [s for s in self.slots if not s.free]

    def assign(self, index: int, request: Any, **data) -> Slot:
        s = self.slots[index]
        if not s.free:
            raise RuntimeError(f"slot {index} already occupied")
        s.request = request
        s.data = dict(data)
        return s

    def release(self, index: int) -> None:
        s = self.slots[index]
        s.request = None
        s.data = {}
