"""Architecture interface over the model families the launchers and the
token engine consume — all four of the JAX package's: the transformer
(dense and MoE), rwkv (RWKV6, attention-free), zamba (Mamba2 with a
shared attention block) and the whisper-style encoder-decoder:

    init(seed, device)               -> params (random, from a seed)
    loss(params, batch)              -> scalar (causal-LM cross-entropy)
    init_cache(batch, max_len)       -> zeroed caches: lists of
                                        batch-leading tensors (the layers'
                                        (k, v); rwkv's per-layer states;
                                        zamba's per-layer Mamba2 states and
                                        per-group (k, v))
    encode_memory(params, frames)    -> encoder memory (encdec), else None
    prefill(params, batch, max_len)  -> (logits_last, caches)
    decode(params, token, caches, cache_len, memory=None)
                                     -> (logits, caches)

`input_mode` is "tokens" for the LM archs and "embeddings" for the
entries whose modality frontend is a stub (internvl2-1b): their batches
carry (B, S, D) embeddings.  An encdec batch carries "frames" (B,
frontend_ctx, D), the stub frontend's output, or for prefill the
encoder's "memory" itself.  An `Arch` over any other family raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import transformer, zoo

FAMILIES = ("transformer", "rwkv", "zamba", "encdec")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                   # transformer | rwkv | zamba | encdec
    cfg: Any
    input_mode: str = "tokens"    # tokens | embeddings (stub frontend)
    frontend_ctx: int = 0         # encoder frames (encdec)


class Arch:
    def __init__(self, spec: ArchSpec):
        if spec.family not in FAMILIES:
            raise NotImplementedError(
                f"{spec.name}: {spec.family!r} is not a family of the port "
                f"(families: {FAMILIES})")
        self.spec = spec
        self.cfg = spec.cfg
        self.family = spec.family
        self.encdec = spec.family == "encdec"

    def init(self, seed: int = 0, device="cuda") -> Any:
        """Random weights drawn on `device` from a generator seeded with
        `seed` (so a full-width init never stages through the host)."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        init = {"transformer": transformer.init_params,
                "rwkv": zoo.rwkv_init, "zamba": zoo.zamba_init,
                "encdec": zoo.encdec_init}[self.family]
        return init(self.cfg, gen, device)

    def loss(self, params: Any, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """The causal-LM loss of `batch` ("labels", and "tokens" or
        "embeddings"; encdec: "tokens" and "frames"), with grad where grad
        mode is on."""
        if self.encdec:
            return zoo.encdec_loss(params, self.cfg, batch["frames"],
                                   batch["tokens"], batch["labels"])
        loss = {"transformer": transformer.lm_loss, "rwkv": zoo.rwkv_loss,
                "zamba": zoo.zamba_loss}[self.family]
        return loss(params, self.cfg, batch.get("tokens"), batch["labels"],
                    embeddings=batch.get("embeddings"))

    def init_cache(self, batch: int, max_len: int, device="cuda") -> Any:
        if self.family == "rwkv":                  # O(1) in max_len
            return zoo.rwkv_init_cache(self.cfg, batch, device=device)
        init = {"transformer": transformer.init_cache,
                "zamba": zoo.zamba_init_cache,
                "encdec": zoo.encdec_init_cache}[self.family]
        return init(self.cfg, batch, max_len, device=device)

    def encode_memory(self, params: Any, frames: Optional[torch.Tensor]
                      ) -> Optional[torch.Tensor]:
        """The encoder memory (B, frontend_ctx, D) in cfg.dtype for an
        encdec arch; None for the others."""
        if not self.encdec:
            return None
        with torch.no_grad():
            return zoo.encode(params, self.cfg, frames)

    def prefill(self, params: Any, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Any]:
        if self.encdec:
            memory = batch.get("memory")
            if memory is None:
                memory = self.encode_memory(params, batch["frames"])
            return zoo.prefill(params, self.cfg, batch["tokens"], memory,
                               max_len)
        if self.family == "rwkv":
            return zoo.rwkv_prefill(params, self.cfg, batch.get("tokens"),
                                    batch.get("embeddings"))
        if self.family == "zamba":
            return zoo.zamba_prefill(params, self.cfg, batch.get("tokens"),
                                     max_len, batch.get("embeddings"))
        return transformer.prefill(params, self.cfg, batch["tokens"],
                                   max_len)

    def decode(self, params: Any, token: torch.Tensor, caches: Any,
               cache_len, memory: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Any]:
        """One-token serve step.  token: (B, 1); `memory` the encoder
        memory of an encdec arch.  K/V caches are updated in place; the
        recurrent states (rwkv, zamba's Mamba2 layers) come back as new
        tensors in the returned caches."""
        if self.encdec:
            return zoo.decode_step(params, self.cfg, token, memory, caches,
                                   cache_len)
        if self.family == "rwkv":
            return zoo.rwkv_decode_step(params, self.cfg, token, caches)
        if self.family == "zamba":
            return zoo.zamba_decode_step(params, self.cfg, token, caches,
                                         cache_len)
        return transformer.decode_step(params, self.cfg, token, caches,
                                       cache_len)
