"""The wire-level request surface: one `ServeRequest` for every workload
the serving tier accepts, with an exact JSON round-trip:

    req  = ServeRequest(rid=3, workload="diffusion", seed=3, nfe=20, q=2)
    wire = req.to_wire()          # plain-JSON dict, schema-versioned
    assert ServeRequest.from_wire(wire) == req     # exact, ndarrays included

The same dataclass, fields and wire schema (version 2) as the JAX
package's, so a request crosses between the two serving tiers unchanged.

  * **Frozen.**  Engines and schedulers hold references to the same
    object; `__post_init__` normalizes the two ndarray fields to their
    canonical dtypes (the one sanctioned write).
  * **Versioned wire form.**  `to_wire()` emits JSON scalars and lists plus
    the `"v"` schema tag; `from_wire()` rejects unknown versions and
    unknown keys instead of guessing.
  * **Value equality, array-aware.**  `==` compares the ndarray fields with
    `np.array_equal`.

Sampler-config fields (`nfe`/`q`/`corrector`/`lam`/`grid`/`family`/
`algorithm`/`precision`) mirror `repro_torch.core.coeffs.SamplerConfig`;
`None` means "use the engine default", and the merged config is validated
by the engine (`DiffusionEngine.config_of`).  `priority`/`deadline` ride
along for the online path and never enter the sampler config.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

# Bump when a field is added/renamed/retyped.  `from_wire` accepts exactly
# this version: cross-version traffic is a deploy error, not a soft case.
# v2: added the per-request sampler `algorithm` field.
WIRE_VERSION = 2

WORKLOADS = ("token", "diffusion")

# ndarray fields and their canonical wire dtypes (the only non-scalar
# fields; everything else is a JSON scalar or None)
_ARRAY_FIELDS = {"tokens": np.int32, "frames": np.float32}


@dataclasses.dataclass(frozen=True, eq=False)
class ServeRequest:
    """One serving request — token decoding or gDDIM sampling — in the
    form every tier speaks, in process or over the wire."""

    rid: int
    workload: str = "diffusion"         # member of WORKLOADS

    # --- seeding: the result is a pure function of (seed, merged config),
    #     independent of admission order, neighbours, replica or host
    seed: int = 0

    # --- sampler config (diffusion; None = engine default) --------------
    nfe: Optional[int] = None           # grid steps N
    q: Optional[int] = None             # multistep order (Eq. 19)
    corrector: Optional[bool] = None    # Eq. 45 / Alg. 1 corrector
    lam: Optional[float] = None         # stochasticity lambda (Eq. 22)
    grid: Optional[str] = None          # 'quadratic' | 'uniform'
    family: Optional[str] = None        # SDE family ('vpsde'|'cld'|'bdm')
    algorithm: Optional[str] = None     # sampler update rule
                                        # ('gddim'|'gmm'|'accel')
    precision: Optional[str] = None     # score-net precision class
                                        # ('f32'|'bf16'|'int8')

    # --- token workload --------------------------------------------------
    tokens: Optional[np.ndarray] = None  # (L,) int32 prompt
    max_new: int = 16                    # decode budget incl. prefill token
    frames: Optional[np.ndarray] = None  # (ctx, d_model) f32, encdec archs

    # --- urgency (online path; never enters the sampler config) ---------
    priority: int = 0                    # higher = more urgent
    deadline: Optional[float] = None     # absolute virtual-clock time

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"request {self.rid}: workload must be one of "
                             f"{WORKLOADS}, got {self.workload!r}")
        if self.workload == "token" and self.tokens is None:
            raise ValueError(f"request {self.rid}: token workload needs "
                             "a tokens prompt")
        for name, dtype in _ARRAY_FIELDS.items():
            val = getattr(self, name)
            if val is not None:
                object.__setattr__(
                    self, name,
                    np.asarray(val, dtype=dtype))

    # -- surface shared with the engines ----------------------------------
    @property
    def prompt_len(self) -> int:
        return int(len(self.tokens))

    # -- wire form ---------------------------------------------------------
    def to_wire(self) -> Dict[str, Any]:
        """Plain-JSON dict (scalars, lists, None) with the schema tag.
        Exact: `from_wire(to_wire(r)) == r` for every constructible r."""
        wire: Dict[str, Any] = {"v": WIRE_VERSION}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, np.ndarray):
                val = val.tolist()
            wire[f.name] = val
        return wire

    @classmethod
    def from_wire(cls, wire: Dict[str, Any]) -> "ServeRequest":
        """Inverse of `to_wire`.  Rejects unknown schema versions and
        unknown keys — the process boundary is where a fleet running
        mixed code must fail, not deep inside an engine."""
        version = wire.get("v")
        if version != WIRE_VERSION:
            raise ValueError(f"wire schema version {version!r} != "
                             f"{WIRE_VERSION} (this build)")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in wire.items() if k != "v"}
        unknown = sorted(set(kw) - names)
        if unknown:
            raise ValueError(f"unknown wire fields {unknown}; known: "
                             f"{sorted(names)}")
        return cls(**kw)    # __post_init__ restores the ndarray dtypes

    # -- value equality, array-aware ---------------------------------------
    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, ServeRequest):
            return NotImplemented
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name in _ARRAY_FIELDS:
                if (a is None) != (b is None):
                    return False
                if a is not None and not np.array_equal(a, b):
                    return False
            elif a != b:
                return False
        return True

    def __hash__(self) -> int:
        return hash((self.rid, self.workload, self.seed))
