"""Decoder-only transformer LM family (gemma3-1b, deepseek-coder-33b,
nemotron-4-15b, llama3-405b, internvl2-1b, qwen3-moe-30b-a3b,
llama4-maverick-400b-a17b):

  * GQA attention with RoPE (any n_kv_heads, incl. MQA n_kv = 1)
  * a per-pattern-position sliding window (gemma3's 5 local : 1 global)
  * gated (SwiGLU) or plain FFN (squared ReLU for nemotron-4), RMSNorm
    with the (1 + gamma) scale
  * MoE layers at the pattern positions `layer_moe` marks (top-k routing,
    an optional shared expert; llama4's dense / MoE alternation), in the
    dispatch form `MoECfg.impl` names (`common.MOE_IMPLS`)

The JAX package scans over pattern groups with params stacked
(n_groups, ...) per pattern position, then runs unrolled remainder layers.
Here depth is a plain loop over `params["layers"]` in the order JAX runs
them — layer l = g * P + pos of the groups, then the remainder layers —
and layer l uses the window of pattern position l % P (for the remainder
layers too).  `convert.from_jax_transformer` lays a JAX tree out in that
order.  Caches are per layer: a list of (k, v), each (B, max_len, Hkv, Dh).

Training (`lm_loss`) runs `forward` with grad and without caches.  With
`cfg.remat` every layer runs under `torch.utils.checkpoint`
(non-reentrant): its activations are recomputed in the backward from the
layer's input, which is all a layer keeps.  The JAX package checkpoints
each scanned pattern group (`jax.checkpoint`, nothing saveable) and not
its remainder layers; the values do not depend on where the cuts fall,
and one layer a cut keeps the recompute's peak at one layer's
activations, with no scan here to give the group a meaning.  `prefill`
and `decode_step` run without grad.  `forward(..., embeddings=)` feeds
(B, S, D) embeddings in place of token ids (an arch whose modality
frontend is a stub: `ArchSpec.input_mode` "embeddings").

An MoE layer holds "moe" (the f32 router, the expert stacks, "shared")
where a dense one holds "mlp".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ckpt.store import tree_flatten
from . import common

Tensor = torch.Tensor
Params = Dict[str, Any]
Cache = List[Tuple[Tensor, Tensor]]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    impl: str = "dense"          # dense | capacity | sorted (common.py)


@dataclasses.dataclass(frozen=True)
class TransformerCfg:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    # pattern description (length P): per-position sliding window (None =
    # global) and whether the FFN is MoE
    layer_windows: Tuple[Optional[int], ...] = (None,)
    layer_moe: Tuple[bool, ...] = (False,)
    moe: Optional[MoECfg] = None
    tie_embeddings: bool = True
    dtype: Any = torch.float32
    remat: bool = True

    @property
    def pattern(self) -> int:
        return len(self.layer_windows)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern

    @property
    def n_rem(self) -> int:
        return self.n_layers - self.n_groups * self.pattern

    def window(self, layer: int) -> Optional[int]:
        """Sliding window of layer `layer` in execution order."""
        return self.layer_windows[layer % self.pattern]

    def is_moe(self, layer: int) -> bool:
        """Whether layer `layer` (execution order) has an MoE FFN."""
        return self.moe is not None and \
            self.layer_moe[layer % len(self.layer_moe)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_params(gen, cfg: TransformerCfg, layer: int, device) -> Params:
    d, dt = cfg.d_model, cfg.dtype
    if cfg.is_moe(layer):
        m = cfg.moe
        ff = {"moe": common.moe_params(gen, d, m.d_ff, m.n_experts, dt,
                                       m.n_shared, m.d_ff_shared or None,
                                       device)}
    else:
        ff = {"mlp": common.mlp_params(gen, d, cfg.d_ff, dt, cfg.gated_mlp,
                                       device)}
    return {"ln_attn": torch.zeros(d, dtype=dt, device=device),
            "ln_mlp": torch.zeros(d, dtype=dt, device=device),
            "attn": common.attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.d_head, dt, device),
            **ff}


def init_params(cfg: TransformerCfg, gen: torch.Generator,
                device="cpu") -> Params:
    """Random weights at the JAX init's scales, drawn from `gen` (on the
    generator's device) and placed on `device`."""
    params: Params = {
        "embed": common.embed_init(gen, cfg.vocab, cfg.d_model, cfg.dtype,
                                   device),
        "ln_f": torch.zeros(cfg.d_model, dtype=cfg.dtype, device=device),
        "layers": [_layer_params(gen, cfg, layer, device)
                   for layer in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        params["unembed"] = common.dense_init(gen, cfg.d_model, cfg.vocab,
                                              cfg.dtype, None, device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block(p: Params, cfg: TransformerCfg, layer: int, x: Tensor,
           rope, kv_cache=None, cache_len=None):
    h = common.rms_norm(x, p["ln_attn"])
    attn_out, new_cache = common.attn_apply(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.d_head, causal=True, window=cfg.window(layer),
        rope=rope,
        kv_cache=kv_cache, cache_len=cache_len)
    x = x + attn_out
    h = common.rms_norm(x, p["ln_mlp"])
    if "moe" in p:
        m = cfg.moe
        ff = common.MOE_IMPLS[m.impl](p["moe"], h, top_k=m.top_k,
                                      act=cfg.act,
                                      capacity_factor=m.capacity_factor)
    else:
        ff = common.mlp_apply(p["mlp"], h, act=cfg.act)
    return x + ff, new_cache


def _trunk(params: Params, cfg: TransformerCfg, tokens: Optional[Tensor],
           caches: Optional[Cache], cache_len,
           embeddings: Optional[Tensor] = None
           ) -> Tuple[Tensor, Optional[Cache]]:
    """Every layer and the final norm: (B, S) ids, or (B, S, D)
    `embeddings` cast to cfg.dtype, -> (B, S, D) hidden."""
    if embeddings is not None:
        x = embeddings.to(cfg.dtype)
    else:
        x = params["embed"][tokens.long()]
    positions = common.decode_positions(x.shape[1], cache_len, x.device)
    rope = (common.rope_table(positions, cfg.d_head, cfg.rope_theta)
            if cfg.rope_theta > 0 else None)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_caches = None if caches is None else []
    for layer, p in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_remat_block, p, cfg, layer, x, rope,
                           use_reentrant=False)
            continue
        cache = None if caches is None else caches[layer]
        x, nc = _block(p, cfg, layer, x, rope, kv_cache=cache,
                       cache_len=cache_len)
        if caches is not None:
            new_caches.append(nc)
    return common.rms_norm(x, params["ln_f"]), new_caches


def _remat_block(p: Params, cfg: TransformerCfg, layer: int, x: Tensor,
                 rope) -> Tensor:
    return _block(p, cfg, layer, x, rope)[0]


def _logits(params: Params, cfg: TransformerCfg, x: Tensor) -> Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


def forward(params: Params, cfg: TransformerCfg, tokens: Optional[Tensor],
            *, embeddings: Optional[Tensor] = None,
            caches: Optional[Cache] = None,
            cache_len=None) -> Tuple[Tensor, Optional[Cache]]:
    """tokens: (B, S) int ids (or `embeddings` (B, S, D) for a stubbed
    frontend).  Returns (logits (B, S, vocab), caches).  Runs with grad
    where grad mode is on (training; remat per layer with `cfg.remat`).
    With `caches`, runs in cached mode: a scalar `cache_len` writes the S
    new K/V rows at that position (prefill: 0); a (B,) tensor is the
    per-slot one-token decode."""
    x, new_caches = _trunk(params, cfg, tokens, caches, cache_len,
                           embeddings)
    return _logits(params, cfg, x), new_caches


def lm_loss(params: Params, cfg: TransformerCfg, tokens: Optional[Tensor],
            labels: Tensor, embeddings: Optional[Tensor] = None) -> Tensor:
    """The causal-LM loss of the uncached forward (the training loss)."""
    logits, _ = forward(params, cfg, tokens, embeddings=embeddings)
    return common.causal_lm_loss(logits, labels)


def param_list(params: Params) -> List[Tensor]:
    """The params' tensors in one fixed order (sorted keys, layers in
    order): the list AdamW updates and `convert.lm_train_state_tree`
    lays out as the JAX tree."""
    return tree_flatten(params)[0]


def init_cache(cfg: TransformerCfg, batch: int, max_len: int, dtype=None,
               device="cpu") -> Cache:
    """Per-layer zeroed (k, v), each (batch, max_len, Hkv, Dh)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def prefill(params: Params, cfg: TransformerCfg, tokens: Tensor,
            max_len: int) -> Tuple[Tensor, Cache]:
    """(logits of the last position (B, vocab), fresh caches holding the
    prompt's K/V).  Only the last position is projected to the vocabulary,
    which is all the caller reads."""
    caches = init_cache(cfg, tokens.shape[0], max_len,
                        device=params["embed"].device)
    x, caches = _trunk(params, cfg, tokens, caches, 0)
    return _logits(params, cfg, x[:, -1]), caches


@torch.no_grad()
def decode_step(params: Params, cfg: TransformerCfg, token: Tensor,
                caches: Cache, cache_len) -> Tuple[Tensor, Cache]:
    """token: (B, 1); cache_len: scalar or (B,) — the valid entries."""
    x, caches = _trunk(params, cfg, token, caches, cache_len)
    return _logits(params, cfg, x[:, -1]), caches
