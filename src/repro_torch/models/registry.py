"""Architecture interface over the model families the launchers and the
token engine consume — the transformer family for now:

    init(seed, device)               -> params (random, from a seed)
    loss(params, batch)              -> scalar (causal-LM cross-entropy)
    init_cache(batch, max_len)       -> per-layer zeroed (k, v) caches
    prefill(params, batch, max_len)  -> (logits_last, caches)
    decode(params, token, caches, cache_len) -> (logits, caches)

`input_mode` is "tokens" for the LM archs and "embeddings" for the
entries whose modality frontend is a stub (internvl2-1b): their batches
carry (B, S, D) embeddings.  The other families of the JAX package (rwkv,
zamba, encdec) are not ported: an `Arch` over one of them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from . import transformer

FAMILIES = ("transformer",)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                   # transformer (rwkv | zamba | encdec: not ported)
    cfg: Any
    input_mode: str = "tokens"    # tokens | embeddings (stub frontend)


class Arch:
    def __init__(self, spec: ArchSpec):
        if spec.family not in FAMILIES:
            raise NotImplementedError(
                f"{spec.name}: the {spec.family!r} family is not ported "
                f"(ported: {FAMILIES})")
        self.spec = spec
        self.cfg = spec.cfg

    def init(self, seed: int = 0, device="cuda") -> Any:
        """Random weights drawn on `device` from a generator seeded with
        `seed` (so a full-width init never stages through the host)."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return transformer.init_params(self.cfg, gen, device)

    def loss(self, params: Any, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """The causal-LM loss of `batch` ("labels", and "tokens" or
        "embeddings"), with grad where grad mode is on."""
        return transformer.lm_loss(params, self.cfg, batch.get("tokens"),
                                   batch["labels"],
                                   embeddings=batch.get("embeddings"))

    def init_cache(self, batch: int, max_len: int, device="cuda") -> Any:
        return transformer.init_cache(self.cfg, batch, max_len,
                                      device=device)

    def prefill(self, params: Any, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Any]:
        return transformer.prefill(params, self.cfg, batch["tokens"],
                                   max_len)

    def decode(self, params: Any, token: torch.Tensor, caches: Any,
               cache_len) -> Tuple[torch.Tensor, Any]:
        """One-token serve step.  token: (B, 1); the caches are updated in
        place and returned."""
        return transformer.decode_step(params, self.cfg, token, caches,
                                       cache_len)
