"""Continuous-batching serving on one device: token decoding and gDDIM
sampling, over closed request lists and arrival streams.

  * `TokenState` / `DiffusionState` (state.py) — the device-resident
    per-slot state, updated by the round step without host round-trips
  * `ServeLoop` (loop.py) — the admit / round / poll skeleton: `serve` a
    closed list, `serve_stream` an arrival stream with deadline admission,
    preemption and a double-buffered poll
  * `SlotTable` (slots.py) — the host shadow that paces the loop
  * `Scheduler` / `DeadlineScheduler` (scheduler.py) — FIFO admission in
    cost-class waves; the online variant orders by urgency
  * `ParkingTable` (parking.py) — the host copies of preempted slots' rows
  * `TraceTraffic`, `VirtualClock`, `poisson_trace`, `serving_metrics`
    (traffic.py) — seeded arrival traces and latency accounting
  * `ServeRequest` (api.py) — the wire-level request, same schema as the
    JAX package's
  * `TokenEngine` (engine.py) — greedy decode over a transformer arch
  * `DiffusionEngine` (engine.py) — the gDDIM sampling service: several
    SDE families in one slot pool, f32 / bf16 / int8 score-net classes
  * `Router` (router.py) — a deterministic front tier over engine
    replicas in this process
"""
from .slots import Slot, SlotTable
from .api import WIRE_VERSION, ServeRequest
from .scheduler import DeadlineScheduler, Scheduler, urgency_key
from .loop import ServeLoop, bucket_pow2
from .parking import ParkingTable, row_fetch, row_restore
from .state import (DiffusionState, TokenState, diffusion_state_init,
                    token_state_init)
from .traffic import (Arrival, RequestTiming, TraceTraffic, VirtualClock,
                      percentile, poisson_trace, serving_metrics)
from .engine import DiffusionEngine, TokenEngine
from .router import ReplicaSpec, RoutePlan, Router, RouterConfig

__all__ = ["Slot", "SlotTable", "ServeRequest", "WIRE_VERSION", "Scheduler",
           "DeadlineScheduler", "urgency_key", "ServeLoop", "bucket_pow2",
           "ParkingTable", "row_fetch", "row_restore", "DiffusionState",
           "TokenState", "diffusion_state_init", "token_state_init",
           "Arrival", "RequestTiming", "TraceTraffic", "VirtualClock",
           "percentile", "poisson_trace", "serving_metrics",
           "DiffusionEngine", "TokenEngine", "ReplicaSpec", "RoutePlan",
           "Router", "RouterConfig"]
