"""The device-resident half of the serving engines: `TokenState` for the
token engine, `DiffusionState` for the diffusion engine.

Everything the round step consumes or updates per slot lives here, as one
batch-leading tuple of tensors on the engine's device.  The host keeps only
a shadow (serve/slots.py) that paces the loop; the round step reads and
writes the state on the device, and what comes back to the host is each
finished result and, for the token engine, the small done/progress mask
it polls.  Retired slots are frozen, not cleared: the round step masks
every update with `active`, so a finished result survives verbatim until
the host fetches it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class TokenState(NamedTuple):
    """Per-slot decode state for `TokenEngine` (all leaves batch-leading):

      last    (B, 1) int32   last emitted token (next step's input)
      pos     (B,)   int32   absolute cache position of the slot
      n_out   (B,)   int32   tokens emitted so far (incl. the prefill token)
      budget  (B,)   int32   the request's max_new
      out     (B, max_len) int32  per-slot output row; row b holds
                                  out[b, :n_out[b]]
      active  (B,)   bool    False once retired (eos / budget) — every
                             update in the round step is masked by this
    """
    last: Tensor
    pos: Tensor
    n_out: Tensor
    budget: Tensor
    out: Tensor
    active: Tensor


def token_state_init(batch_size: int, max_len: int,
                     device="cuda") -> TokenState:
    """All-free token state (every slot inactive, zeroed) on `device`."""
    B = batch_size
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return TokenState(
        last=i32(B, 1), pos=i32(B), n_out=i32(B),
        budget=torch.ones((B,), dtype=torch.int32, device=device),
        out=i32(B, max_len),
        active=torch.zeros((B,), dtype=torch.bool, device=device))


class DiffusionState(NamedTuple):
    """Per-slot sampler state in the canonical packed layout:

      u       (B, K, D) f32     the gDDIM iterate, K = k_max over resident
                                families (CLD: 2), D = prod(data_shape);
                                padding rows stay zero
      hist    (B, Qb, K, D)     multistep eps history, hist[:, j] ~ eps(t_{i+j})
      k       (B,) int32        per-slot sampler step index
      cfg     (B,) int32        per-slot config row in the FactoredBank
      fam     (B,) int32        per-slot SDE family id
      prec    (B,) int32        per-slot score-net precision class
      keys    (B, 2) int32      per-slot PRNG key, the two uint32 words as
                                int32 bit patterns (what the kernels read)
      active  (B,) bool         False once k reached the config's NFE
    """
    u: Tensor
    hist: Tensor
    k: Tensor
    cfg: Tensor
    fam: Tensor
    prec: Tensor
    keys: Tensor
    active: Tensor


def diffusion_state_init(batch_size: int, k_max: int, data_dim: int,
                         q_bucket: int, device="cuda") -> DiffusionState:
    """All-free diffusion state (B = batch_size, K = k_max, D = data_dim,
    Qb = q_bucket) on `device`."""
    B = batch_size
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return DiffusionState(
        u=torch.zeros((B, k_max, data_dim), dtype=torch.float32, device=device),
        hist=torch.zeros((B, q_bucket, k_max, data_dim), dtype=torch.float32,
                         device=device),
        k=i32(B), cfg=i32(B), fam=i32(B), prec=i32(B), keys=i32(B, 2),
        active=torch.zeros((B,), dtype=torch.bool, device=device))
