"""The whisper-style encoder-decoder backbone (the encdec half of the JAX
package's `models/zoo.py`; its rwkv and zamba halves are not ported).

  * the encoder: frames (B, S_audio, D) from the stubbed conv frontend plus
    a learned position table, then n_enc_layers of non-causal self-
    attention without rotary embedding and a plain GELU MLP, RMSNorm
    before each, a final RMSNorm: the encoder memory (B, S_audio, D);
  * the decoder: token embeddings, n_dec_layers of causal self-attention
    with RoPE (theta 1e4, against a per-layer KV cache when serving),
    cross-attention into the memory (non-causal, no rotary embedding, K
    and V projected from the memory in every call, as the JAX decoder
    does), the GELU MLP; a final RMSNorm and the tied unembedding.

Parameters keep the JAX tree's names with the layer stacks unstacked into
lists (`enc_layers`, `dec_layers`; `convert.from_jax_encdec`).  Caches are
per decoder layer, a list of (k, v), each (B, max_len, Hkv, Dh), as the
transformer's, so the token engine handles both families' caches alike.
With `cfg.remat` and grad on, each layer runs under
`torch.utils.checkpoint`, as the port's transformer does.

On the card the encoder's attention is the flash kernel's DiT form (Sq =
Sk = 1500, Hq = Hkv), the decoder's self-attention its causal form in
prefill and `decode_attention` in a decode step, and its cross-attention
the general form's non-causal instance (Sq != Sk).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import common

Tensor = torch.Tensor
Params = Dict[str, Any]
Cache = List[Tuple[Tensor, Tensor]]

DEC_ROPE_THETA = 10000.0      # the JAX decoder's, fixed in its code


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    n_audio_ctx: int = 1500       # encoder frames after the stubbed frontend
    dtype: Any = torch.float32
    remat: bool = True


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer(gen, cfg: EncDecCfg, device, cross: bool) -> Params:
    d, dt = cfg.d_model, cfg.dtype
    attn = lambda: common.attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.d_head, dt, device)
    p = {"ln_attn": torch.zeros(d, dtype=dt, device=device),
         "ln_mlp": torch.zeros(d, dtype=dt, device=device),
         "attn": attn(),
         "mlp": common.mlp_params(gen, d, cfg.d_ff, dt, gated=False,
                                  device=device)}
    if cross:
        p["ln_xattn"] = torch.zeros(d, dtype=dt, device=device)
        p["xattn"] = attn()
    return p


def encdec_init(cfg: EncDecCfg, gen: torch.Generator,
                device="cpu") -> Params:
    """Random weights at the JAX init's scales (the audio positions N(0,
    0.01^2)), drawn from `gen` and placed on `device`."""
    d, dt = cfg.d_model, cfg.dtype
    pos = torch.randn((cfg.n_audio_ctx, d), generator=gen,
                      dtype=torch.float32, device=gen.device) * 0.01
    return {
        "embed": common.embed_init(gen, cfg.vocab, d, dt, device),
        "pos_audio": pos.to(device=device, dtype=dt),
        "ln_enc": torch.zeros(d, dtype=dt, device=device),
        "ln_dec": torch.zeros(d, dtype=dt, device=device),
        "enc_layers": [_layer(gen, cfg, device, cross=False)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_layer(gen, cfg, device, cross=True)
                       for _ in range(cfg.n_dec_layers)]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _heads(cfg: EncDecCfg) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head)


def _enc_block(lp: Params, cfg: EncDecCfg, x: Tensor) -> Tensor:
    h = common.rms_norm(x, lp["ln_attn"])
    a, _ = common.attn_apply(lp["attn"], h, causal=False, **_heads(cfg))
    x = x + a
    h = common.rms_norm(x, lp["ln_mlp"])
    return x + common.mlp_apply(lp["mlp"], h, act="gelu")


def encode(params: Params, cfg: EncDecCfg, frames: Tensor) -> Tensor:
    """frames (B, S_audio, D), any float dtype -> the encoder memory (B,
    S_audio, D) in cfg.dtype."""
    S = frames.shape[1]
    x = frames.to(cfg.dtype) + params["pos_audio"][:S][None]
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["enc_layers"]:
        x = (checkpoint(_enc_block, lp, cfg, x, use_reentrant=False)
             if remat else _enc_block(lp, cfg, x))
    return common.rms_norm(x, params["ln_enc"])


def _dec_block(lp: Params, cfg: EncDecCfg, x: Tensor, memory: Tensor, rope,
               kv_cache=None, cache_len=None):
    h = common.rms_norm(x, lp["ln_attn"])
    a, new_kv = common.attn_apply(lp["attn"], h, causal=True, rope=rope,
                                  kv_cache=kv_cache, cache_len=cache_len,
                                  **_heads(cfg))
    x = x + a
    h = common.rms_norm(x, lp["ln_xattn"])
    a, _ = common.attn_apply(lp["xattn"], h, causal=False, x_kv=memory,
                             **_heads(cfg))
    x = x + a
    h = common.rms_norm(x, lp["ln_mlp"])
    return x + common.mlp_apply(lp["mlp"], h, act="gelu"), new_kv


def _remat_dec_block(lp, cfg, x, memory, rope) -> Tensor:
    return _dec_block(lp, cfg, x, memory, rope)[0]


def _dec_trunk(params: Params, cfg: EncDecCfg, tokens: Tensor,
               memory: Tensor, caches: Optional[Cache],
               cache_len) -> Tuple[Tensor, Optional[Cache]]:
    x = params["embed"][tokens.long()]
    positions = common.decode_positions(x.shape[1], cache_len, x.device)
    rope = common.rope_table(positions, cfg.d_head, DEC_ROPE_THETA)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_caches = None if caches is None else []
    for layer, lp in enumerate(params["dec_layers"]):
        if remat:
            x = checkpoint(_remat_dec_block, lp, cfg, x, memory, rope,
                           use_reentrant=False)
            continue
        x, nc = _dec_block(lp, cfg, x, memory, rope,
                           kv_cache=None if caches is None else caches[layer],
                           cache_len=cache_len)
        if caches is not None:
            new_caches.append(nc)
    return common.rms_norm(x, params["ln_dec"]), new_caches


def decode_forward(params: Params, cfg: EncDecCfg, tokens: Tensor,
                   memory: Tensor, caches: Optional[Cache] = None,
                   cache_len=None) -> Tuple[Tensor, Optional[Cache]]:
    """The decoder over tokens (B, S) with cross-attention into memory (B,
    S_audio, D): (logits (B, S, vocab), caches).  With `caches`, a scalar
    `cache_len` writes the S new K/V rows at that position (prefill: 0), a
    (B,) tensor is the per-slot one-token decode."""
    x, new_caches = _dec_trunk(params, cfg, tokens, memory, caches,
                               cache_len)
    return x @ params["embed"].T, new_caches


def encdec_loss(params: Params, cfg: EncDecCfg, frames: Tensor,
                tokens: Tensor, labels: Tensor) -> Tensor:
    """The causal-LM loss of the decoder over `tokens` given `frames`."""
    memory = encode(params, cfg, frames)
    logits, _ = decode_forward(params, cfg, tokens, memory)
    return common.causal_lm_loss(logits, labels)


def encdec_init_cache(cfg: EncDecCfg, batch: int, max_len: int, dtype=None,
                      device="cpu") -> Cache:
    """Per-decoder-layer zeroed (k, v), each (batch, max_len, Hkv, Dh)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_dec_layers)]


@torch.no_grad()
def prefill(params: Params, cfg: EncDecCfg, tokens: Tensor, memory: Tensor,
            max_len: int) -> Tuple[Tensor, Cache]:
    """(logits of the last position (B, vocab), fresh caches holding the
    prompt's self-attention K/V); only the last position is projected to
    the vocabulary."""
    caches = encdec_init_cache(cfg, tokens.shape[0], max_len,
                               device=params["embed"].device)
    x, caches = _dec_trunk(params, cfg, tokens, memory, caches, 0)
    return x[:, -1] @ params["embed"].T, caches


@torch.no_grad()
def decode_step(params: Params, cfg: EncDecCfg, token: Tensor,
                memory: Tensor, caches: Cache,
                cache_len) -> Tuple[Tensor, Cache]:
    """token (B, 1); cache_len scalar or (B,): (logits (B, vocab),
    caches updated in place)."""
    x, caches = _dec_trunk(params, cfg, token, memory, caches, cache_len)
    return x[:, -1] @ params["embed"].T, caches
