"""Host-side parking table: suspended slot rows, restored bitwise.

Preempting a slot (loop.py `_suspend`) must not lose work: the engine
gathers the slot's row of every per-slot tensor — the `DiffusionState` /
`TokenState` row and, for the token engine, every cache leaf's row (the
layers' (k, v), the recurrent states of rwkv and zamba) — and the parking
table keeps a host copy, keyed by request rid, next
to the host shadow the `SlotTable` was tracking.  Resuming writes the same
bits back into whichever slot row is free at that point (`row_restore`),
so a preempted request's remaining rounds compute on exactly the state it
was suspended with: preempted + resumed == uninterrupted, bitwise.

`row_fetch` / `row_restore` (and the admission's `rows_scatter`) are
plain tensor indexing over a nested structure of tensors (a state
`NamedTuple`, lists of cache tuples); there is no kernel.  Parking is off the steady-state path: the device fetch
happens only at a preemption, the write only at a resume.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import torch


def _map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` over the tensor leaves of a nested tuple / NamedTuple / list /
    dict (and the same positions of `rest`), keeping the structure."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return tree


def row_fetch(tree: Any, i: int) -> Any:
    """Row `i` of every batch-leading tensor of `tree`, as new tensors on
    the tree's device (not views: the live row is overwritten after a
    preemption)."""
    return _map(lambda x: x[i].clone(), tree)


def row_restore(tree: Any, row: Any, i: int) -> Any:
    """Write `row` back at batch index `i` of every tensor of `tree`, in
    place (a host row is copied to the tree's device); returns `tree`.
    The bitwise inverse of `row_fetch` for the written row."""
    def put(dst, src):
        dst[i] = src.to(device=dst.device, dtype=dst.dtype)
        return dst
    return _map(put, tree, row)


def rows_scatter(tree: Any, rows: Any, ids: torch.Tensor, n: int) -> Any:
    """Rows [0, n) of every tensor of `rows` into rows `ids` of the same
    leaf of `tree`, in place, each cast to the destination's dtype (an
    admission wave's prefill caches into the slots' caches); returns
    `tree`."""
    def put(dst, src):
        dst[ids] = src[:n].to(dst.dtype)
        return dst
    return _map(put, tree, rows)


def to_host(tree: Any) -> Any:
    """A copy of every tensor of `tree` in host memory."""
    return _map(lambda x: x.cpu(), tree)


class ParkingTable:
    """rid -> (host payload, host shadow, request) for suspended slots.

    `park` copies the device rows to the host at the moment of suspension
    (the slot is about to be overwritten by the preempting admission);
    `pop` hands them back for the resume.  `n_parked_total` counts every
    park over the table's lifetime."""

    def __init__(self):
        self._rows: Dict[int, Tuple[Any, dict, Any]] = {}
        self.n_parked_total = 0

    def park(self, rid: int, device_rows: Any, shadow: dict,
             request: Any) -> None:
        if rid in self._rows:
            raise ValueError(f"request {rid} is already parked")
        self._rows[rid] = (to_host(device_rows), dict(shadow), request)
        self.n_parked_total += 1

    def pop(self, rid: int) -> Tuple[Any, dict, Any]:
        return self._rows.pop(rid)

    def __contains__(self, rid: int) -> bool:
        return rid in self._rows

    def __len__(self) -> int:
        return len(self._rows)

    def rids(self) -> Iterable[int]:
        return tuple(self._rows)
