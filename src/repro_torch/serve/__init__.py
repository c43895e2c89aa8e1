"""Continuous-batching serving on one device: token decoding and gDDIM
sampling.

  * `TokenState` / `DiffusionState` (state.py) — the device-resident
    per-slot state, updated by the round step without host round-trips
  * `ServeLoop` (loop.py) — the admit / round / poll skeleton
  * `SlotTable` (slots.py) — the host shadow that paces the loop
  * `Scheduler` (scheduler.py) — FIFO admission in cost-class waves
  * `ServeRequest` (api.py) — the wire-level request, same schema as the
    JAX package's
  * `TokenEngine` (engine.py) — greedy decode over a transformer arch
  * `DiffusionEngine` (engine.py) — the gDDIM sampling service
"""
from .slots import Slot, SlotTable
from .api import WIRE_VERSION, ServeRequest
from .scheduler import Scheduler
from .loop import ServeLoop, bucket_pow2
from .state import (DiffusionState, TokenState, diffusion_state_init,
                    token_state_init)
from .engine import DiffusionEngine, TokenEngine

__all__ = ["Slot", "SlotTable", "ServeRequest", "WIRE_VERSION", "Scheduler",
           "ServeLoop", "bucket_pow2", "DiffusionState", "TokenState",
           "diffusion_state_init", "token_state_init", "DiffusionEngine",
           "TokenEngine"]
