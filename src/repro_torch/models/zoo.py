"""The full models of the families beside the decoder-only transformer,
the JAX package's `models/zoo.py`: RWKV6LM (rwkv6-7b), Zamba2 (zamba2-2.7b)
and the whisper-style encoder-decoder (whisper-base).

RWKV6LM: token embeddings, n_layers of `rwkv6.layer_apply` (the time mix
and the channel mix, RMSNorm before each), a final RMSNorm and the tied
unembedding.  No attention: the decode state is O(1) a token, a tuple
(x_prev_t, S, x_prev_c) a layer (`rwkv6.init_layer_cache`).

Zamba2: token embeddings, n_layers Mamba2 layers (`ssm.mamba2_apply`,
RMSNorm before each) in n_groups = n_layers / share_every groups, and
after every group one *shared* transformer block (one set of weights:
causal self-attention with RoPE at theta 1e4, then a gated MLP), whose
every application keeps its own KV cache.  Its caches are the pair
(per-layer Mamba2 caches (conv_state, ssm_state), per-group (k, v), each
(B, max_len, Hkv, Dh)).  The shared block's attention goes through
`common.attn_apply`: on the card the causal flash kernel over the cache
in prefill, `decode_attention` in a decode step, `FlashAttention` under
grad (at zamba2-2.7b's head width 80).

Both recurrent families prefill through their chunked forms from the
zero cache (the JAX package runs its per-token form there: the same
function) and decode one token through the per-token recurrence.  Caches
are lists of batch-leading tensors, as the transformer's, so the token
engine scatters, parks and restores them leaf by leaf; the JAX package's
(L, B, ...) stacks are carried across by `convert.from_jax_cache`.  With
`cfg.remat` and grad on, RWKV6LM runs each layer and Zamba2 each group
of share_every Mamba2 layers with its shared block under
`torch.utils.checkpoint`, where the JAX package checkpoints its scanned
layer and group bodies.

The encoder-decoder:

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

from . import common, rwkv6, ssm
from .rwkv6 import RWKV6Cfg
from .ssm import Mamba2Cfg

Tensor = torch.Tensor
Params = Dict[str, Any]
Cache = List[Tuple[Tensor, Tensor]]

DEC_ROPE_THETA = 10000.0      # the JAX decoder's, fixed in its code
ZAMBA_ROPE_THETA = 10000.0    # the JAX shared block's, fixed in its code


def _embed(params: Params, cfg, tokens: Optional[Tensor],
           embeddings: Optional[Tensor]) -> Tensor:
    """(B, S) ids through the embedding, or (B, S, D) `embeddings` cast
    to cfg.dtype."""
    if embeddings is not None:
        return embeddings.to(cfg.dtype)
    return params["embed"][tokens.long()]


# ===========================================================================
# RWKV6 LM
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class RWKV6LMCfg:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    chunk: int = 16
    dtype: Any = torch.float32
    remat: bool = True

    @property
    def block(self) -> RWKV6Cfg:
        return RWKV6Cfg(d_model=self.d_model, n_heads=self.n_heads,
                        d_ff=self.d_ff, chunk=self.chunk, dtype=self.dtype)

    def param_count(self) -> int:
        """The JAX config's count (its LoRA ranks 64 and 32 fixed)."""
        d = self.d_model
        per_layer = (5 * d * d + d * (64 + 32) + (64 + 32) * 5 * d
                     + 2 * d * self.d_ff + d * d)
        return self.vocab * d + self.n_layers * per_layer


RWKVCache = List[Tuple[Tensor, Tensor, Tensor]]


def rwkv_init(cfg: RWKV6LMCfg, gen: torch.Generator, device="cpu") -> Params:
    """Random weights at the JAX init's scales, drawn from `gen` and
    placed on `device`."""
    return {"embed": common.embed_init(gen, cfg.vocab, cfg.d_model,
                                       cfg.dtype, device),
            "ln_f": torch.zeros(cfg.d_model, dtype=cfg.dtype, device=device),
            "layers": [rwkv6.layer_params(gen, cfg.block, device)
                       for _ in range(cfg.n_layers)]}


def _rwkv_remat_layer(lp: Params, blk: RWKV6Cfg, x: Tensor) -> Tensor:
    return rwkv6.layer_apply(lp, blk, x)[0]


def _rwkv_trunk(params: Params, cfg: RWKV6LMCfg, tokens, embeddings,
                caches: Optional[RWKVCache]
                ) -> Tuple[Tensor, Optional[RWKVCache]]:
    x = _embed(params, cfg, tokens, embeddings)
    blk = cfg.block
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_caches = None if caches is None else []
    for layer, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_rwkv_remat_layer, lp, blk, x, use_reentrant=False)
            continue
        x, nc = rwkv6.layer_apply(lp, blk, x,
                                  None if caches is None else caches[layer])
        if caches is not None:
            new_caches.append(nc)
    return common.rms_norm(x, params["ln_f"]), new_caches


def rwkv_forward(params: Params, cfg: RWKV6LMCfg, tokens: Optional[Tensor],
                 embeddings: Optional[Tensor] = None,
                 caches: Optional[RWKVCache] = None
                 ) -> Tuple[Tensor, Optional[RWKVCache]]:
    """(logits (B, S, vocab), the caches after the last token, or None
    without caches)."""
    x, new_caches = _rwkv_trunk(params, cfg, tokens, embeddings, caches)
    return x @ params["embed"].T, new_caches


def rwkv_loss(params: Params, cfg: RWKV6LMCfg, tokens: Optional[Tensor],
              labels: Tensor, embeddings: Optional[Tensor] = None) -> Tensor:
    logits, _ = rwkv_forward(params, cfg, tokens, embeddings)
    return common.causal_lm_loss(logits, labels)


def rwkv_init_cache(cfg: RWKV6LMCfg, batch: int, dtype=None,
                    device="cpu") -> RWKVCache:
    """Per-layer zeroed (x_prev_t, S, x_prev_c)."""
    return [rwkv6.init_layer_cache(cfg.block, batch, dtype or cfg.dtype,
                                   device) for _ in range(cfg.n_layers)]


@torch.no_grad()
def rwkv_prefill(params: Params, cfg: RWKV6LMCfg, tokens: Optional[Tensor],
                 embeddings: Optional[Tensor] = None
                 ) -> Tuple[Tensor, RWKVCache]:
    """(logits of the last position (B, vocab), the caches after the
    prompt), the chunked forms from zero states."""
    x0 = tokens if embeddings is None else embeddings
    caches = rwkv_init_cache(cfg, x0.shape[0], device=params["embed"].device)
    x, caches = _rwkv_trunk(params, cfg, tokens, embeddings, caches)
    return x[:, -1] @ params["embed"].T, caches


@torch.no_grad()
def rwkv_decode_step(params: Params, cfg: RWKV6LMCfg, token: Tensor,
                     caches: RWKVCache) -> Tuple[Tensor, RWKVCache]:
    """token (B, 1): (logits (B, vocab), the new caches)."""
    x, caches = _rwkv_trunk(params, cfg, token, None, caches)
    return x[:, -1] @ params["embed"].T, caches


# ===========================================================================
# Zamba2-style hybrid: Mamba2 backbone + a shared attention block
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class Zamba2Cfg:
    name: str
    n_layers: int                 # Mamba2 layers
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int                     # the shared block's FFN width
    vocab: int
    ssm_state: int = 64
    share_every: int = 6          # the shared block after every k layers
    chunk: int = 128
    dtype: Any = torch.float32
    remat: bool = True

    def __post_init__(self):
        if self.n_layers % self.share_every:
            raise ValueError(f"{self.name}: {self.n_layers} layers are not "
                             f"whole groups of {self.share_every}")

    @property
    def mamba(self) -> Mamba2Cfg:
        return Mamba2Cfg(d_model=self.d_model, d_state=self.ssm_state,
                         chunk=self.chunk, dtype=self.dtype)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.share_every

    def param_count(self) -> int:
        """The JAX config's count."""
        m = self.mamba
        d_in_proj = 2 * m.d_inner + 2 * m.d_state + m.n_heads
        per_mamba = (self.d_model * d_in_proj + m.d_conv * m.conv_dim
                     + m.d_inner * self.d_model)
        shared = (self.d_model * self.d_head
                  * (self.n_heads * 2 + self.n_kv_heads * 2)
                  + 3 * self.d_model * self.d_ff)
        return self.vocab * self.d_model + self.n_layers * per_mamba + shared


# (per-layer (conv_state, ssm_state), per-group (k, v))
ZambaCache = Tuple[List[Tuple[Tensor, Tensor]], Cache]


def zamba_init(cfg: Zamba2Cfg, gen: torch.Generator, device="cpu") -> Params:
    """Random weights at the JAX init's scales, drawn from `gen` and
    placed on `device`: the Mamba2 layers as a list, the shared block
    once."""
    d, dt = cfg.d_model, cfg.dtype
    zeros = lambda: torch.zeros(d, dtype=dt, device=device)
    params = {"embed": common.embed_init(gen, cfg.vocab, d, dt, device),
              "ln_f": zeros(),
              "layers": [{"ln": zeros(),
                          "mamba": ssm.mamba2_params(gen, cfg.mamba, device)}
                         for _ in range(cfg.n_layers)]}
    params["shared"] = {
        "ln_attn": zeros(), "ln_mlp": zeros(),
        "attn": common.attn_params(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.d_head, dt, device),
        "mlp": common.mlp_params(gen, d, cfg.d_ff, dt, device=device)}
    return params


def _zamba_shared_block(shared: Params, cfg: Zamba2Cfg, x: Tensor, rope,
                        kv_cache=None, cache_len=None):
    h = common.rms_norm(x, shared["ln_attn"])
    attn_out, new_kv = common.attn_apply(
        shared["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.d_head, causal=True, rope=rope, kv_cache=kv_cache,
        cache_len=cache_len)
    x = x + attn_out
    h = common.rms_norm(x, shared["ln_mlp"])
    return x + common.mlp_apply(shared["mlp"], h), new_kv


def _zamba_group(layers: List[Params], shared: Params, cfg: Zamba2Cfg,
                 x: Tensor, rope, m_caches=None, kv_cache=None,
                 cache_len=None):
    """share_every Mamba2 layers, then the shared block: (x, the layers'
    new caches, the group's (k, v))."""
    new_m = None if m_caches is None else []
    for j, lp in enumerate(layers):
        h, nc = ssm.mamba2_apply(lp["mamba"], cfg.mamba,
                                 common.rms_norm(x, lp["ln"]),
                                 cache=None if m_caches is None
                                 else m_caches[j])
        x = x + h
        if m_caches is not None:
            new_m.append(nc)
    x, new_kv = _zamba_shared_block(shared, cfg, x, rope, kv_cache,
                                    cache_len)
    return x, new_m, new_kv


def _zamba_remat_group(layers, shared, cfg, x, rope) -> Tensor:
    return _zamba_group(layers, shared, cfg, x, rope)[0]


def _zamba_trunk(params: Params, cfg: Zamba2Cfg, tokens, embeddings,
                 caches: Optional[ZambaCache], cache_len
                 ) -> Tuple[Tensor, Optional[ZambaCache]]:
    x = _embed(params, cfg, tokens, embeddings)
    positions = common.decode_positions(x.shape[1], cache_len, x.device)
    rope = common.rope_table(positions, cfg.d_head, ZAMBA_ROPE_THETA)
    k = cfg.share_every
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_m, new_kv = ([], []) if caches is not None else (None, None)
    for g in range(cfg.n_groups):
        layers = params["layers"][g * k:(g + 1) * k]
        if remat:
            x = checkpoint(_zamba_remat_group, layers, params["shared"], cfg,
                           x, rope, use_reentrant=False)
            continue
        if caches is None:
            x = _zamba_group(layers, params["shared"], cfg, x, rope)[0]
            continue
        x, nm, nkv = _zamba_group(layers, params["shared"], cfg, x, rope,
                                  caches[0][g * k:(g + 1) * k], caches[1][g],
                                  cache_len)
        new_m += nm
        new_kv.append(nkv)
    new_caches = None if caches is None else (new_m, new_kv)
    return common.rms_norm(x, params["ln_f"]), new_caches


def zamba_forward(params: Params, cfg: Zamba2Cfg, tokens: Optional[Tensor],
                  embeddings: Optional[Tensor] = None,
                  caches: Optional[ZambaCache] = None, cache_len=None
                  ) -> Tuple[Tensor, Optional[ZambaCache]]:
    """(logits (B, S, vocab), caches).  With `caches`, a scalar
    `cache_len` writes the S new K/V rows of every group at that position
    (prefill: 0, the Mamba2 layers chunked from their cached states); a
    (B,) tensor is the per-slot one-token decode."""
    x, new_caches = _zamba_trunk(params, cfg, tokens, embeddings, caches,
                                 cache_len)
    return x @ params["embed"].T, new_caches


def zamba_loss(params: Params, cfg: Zamba2Cfg, tokens: Optional[Tensor],
               labels: Tensor, embeddings: Optional[Tensor] = None) -> Tensor:
    logits, _ = zamba_forward(params, cfg, tokens, embeddings)
    return common.causal_lm_loss(logits, labels)


def zamba_init_cache(cfg: Zamba2Cfg, batch: int, max_len: int, dtype=None,
                     device="cpu") -> ZambaCache:
    """(per-layer zeroed (conv_state, ssm_state), per-group zeroed (k, v),
    each (batch, max_len, Hkv, Dh))."""
    dtype = dtype or cfg.dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return ([ssm.init_mamba_cache(cfg.mamba, batch, dtype, device)
             for _ in range(cfg.n_layers)],
            [(torch.zeros(shape, dtype=dtype, device=device),
              torch.zeros(shape, dtype=dtype, device=device))
             for _ in range(cfg.n_groups)])


@torch.no_grad()
def zamba_prefill(params: Params, cfg: Zamba2Cfg, tokens: Optional[Tensor],
                  max_len: int, embeddings: Optional[Tensor] = None
                  ) -> Tuple[Tensor, ZambaCache]:
    """(logits of the last position (B, vocab), fresh caches holding the
    prompt's states and K/V)."""
    x0 = tokens if embeddings is None else embeddings
    caches = zamba_init_cache(cfg, x0.shape[0], max_len,
                              device=params["embed"].device)
    x, caches = _zamba_trunk(params, cfg, tokens, embeddings, caches, 0)
    return x[:, -1] @ params["embed"].T, caches


@torch.no_grad()
def zamba_decode_step(params: Params, cfg: Zamba2Cfg, token: Tensor,
                      caches: ZambaCache, cache_len
                      ) -> Tuple[Tensor, ZambaCache]:
    """token (B, 1); cache_len scalar or (B,): (logits (B, vocab), the
    caches, K/V written in place)."""
    x, caches = _zamba_trunk(params, cfg, token, None, caches, cache_len)
    return x[:, -1] @ params["embed"].T, caches


# ===========================================================================
# Whisper-style encoder-decoder backbone
# ===========================================================================


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
