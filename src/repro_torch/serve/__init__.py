"""Continuous-batching gDDIM serving on one device.

  * `DiffusionState` (state.py) — the device-resident per-slot sampler
    state, updated by the round step without host round-trips
  * `ServeLoop` (loop.py) — the admit / round / poll skeleton
  * `SlotTable` (slots.py) — the host shadow that paces the loop
  * `Scheduler` (scheduler.py) — FIFO admission in cost-class waves
  * `ServeRequest` (api.py) — the wire-level request, same schema as the
    JAX package's
  * `DiffusionEngine` (engine.py) — the gDDIM sampling service
"""
from .slots import Slot, SlotTable
from .api import WIRE_VERSION, ServeRequest
from .scheduler import Scheduler
from .loop import ServeLoop
from .state import DiffusionState, diffusion_state_init
from .engine import DiffusionEngine

__all__ = ["Slot", "SlotTable", "ServeRequest", "WIRE_VERSION", "Scheduler",
           "ServeLoop", "DiffusionState", "diffusion_state_init",
           "DiffusionEngine"]
