"""Shared neural components: initializers, norms, rotary embedding, the
(gated) MLP, the attention block with its two KV-cache branches and the
causal-LM loss.

Parameters keep the JAX package's orientation: a dense weight is
(d_in, d_out) and is applied as `x @ W`.  Norms compute in f32 and cast
back to the activation dtype, as in the JAX package.  Attention dispatches
through `kernels.attention.ops` and, for one-token decode against a
per-slot cache, through `kernels.decode_attention.ops` (the plain version
on a CPU tensor, the CUDA kernel on a CUDA tensor).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.attention import ops as attn_ops
from ..kernels.decode_attention import ops as decode_ops

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# initializers (the JAX package's scales; torch.Generator draws)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, device="cpu") -> Tensor:
    """N(0, 1/d_in) weight (or N(0, scale^2)), drawn in f32 then cast.  The
    draw happens on the generator's device and lands on `device`."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device="cpu") -> Tensor:
    """N(0, 0.02^2) embedding table (vocab, d)."""
    return dense_init(gen, vocab, d, dtype, 0.02, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor,
               eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis in f32 (biased variance, like
    `jnp.var`), cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(),
                        eps).to(x.dtype)


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm in f32 with the (1 + gamma) scale (gamma zero at init), cast
    back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(d_head: int, theta: float = 10000.0) -> np.ndarray:
    """float64 inverse frequencies, (d_head / 2,)."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))


@functools.lru_cache(maxsize=None)
def _freqs_on(d_head: int, theta: float, device: str) -> Tensor:
    # one upload per (width, theta, device): a pageable host->device copy
    # inside a decode round would stall the host on the card's queue
    return torch.from_numpy(
        rope_frequencies(d_head, theta).astype(np.float32)).to(device)


def rope_table(positions: Tensor, d_head: int,
               theta: float = 10000.0) -> Tuple[Tensor, Tensor]:
    """(cos, sin) of the rotary angles of `positions` ((B, S) or (S,)),
    each (B, S, 1, Dh/2): angles in f32 from the float64 frequencies cast
    to f32, in the JAX package's order.  Every layer of a step shares one
    table, so a forward computes it once."""
    freqs = _freqs_on(d_head, float(theta), str(positions.device))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # (B, S, Dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: Tensor, table: Tuple[Tensor, Tensor]) -> Tensor:
    """x: (B, S, H, Dh) rotated by `rope_table`'s (cos, sin): the two
    halves of the head (not interleaved pairs), in f32."""
    cos, sin = table
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations and MLP
# ---------------------------------------------------------------------------
def activation(name: str, x: Tensor) -> Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                 # jax.nn.gelu's default: tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu2":                # squared ReLU (Primer / nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp_apply(p: Params, x: Tensor, act: str = "silu") -> Tensor:
    """up -> activation -> down; gated (act(x W_gate) * x W_up) when the
    params carry `w_gate`."""
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = activation(act, x @ p["w_gate"]) * up
    else:
        up = activation(act, up)
    return up @ p["w_down"]


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------
def attn_params(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                d_head: int, dtype, device="cpu") -> Params:
    init = lambda a, b, s=None: dense_init(gen, a, b, dtype, s, device)
    return {"wq": init(d_model, n_heads * d_head),
            "wk": init(d_model, n_kv * d_head),
            "wv": init(d_model, n_kv * d_head),
            "wo": init(n_heads * d_head, d_model,
                       1.0 / math.sqrt(n_heads * d_head))}


def decode_positions(seq_len: int, cache_len, device) -> Tensor:
    """Absolute positions of a (B, S) input decoded against a cache: a
    per-slot (B,) `cache_len` gives (B, S); a scalar (int or 0-d) gives
    (S,); None gives (S,) from zero."""
    ar = torch.arange(seq_len, device=device)
    if cache_len is None:
        return ar
    if torch.is_tensor(cache_len) and cache_len.dim() == 1:
        return cache_len[:, None].long() + ar[None]
    return ar + cache_len


def attn_apply(p: Params, x: Tensor, *, n_heads: int, n_kv: int, d_head: int,
               causal: bool = True, window: Optional[int] = None,
               rope: Optional[Tuple[Tensor, Tensor]] = None,
               kv_cache: Optional[Tuple[Tensor, Tensor]] = None,
               cache_len=None) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """Returns (out, new_kv); new_kv is the cache pair when one was given.

    `rope` is the (cos, sin) table of the rows' positions (`rope_table`);
    None applies no rotary embedding (the DiT).

    * No cache: self-attention over x (the DiT passes causal=False).
    * Per-slot decode (x (B, 1, D), `cache_len` a (B,) tensor): row b's K/V
      is written at its own position cache_len[b], then one query per row
      attends its first cache_len[b] + 1 entries (`decode_attention`).
    * Prefill / shared position (`cache_len` a scalar): K/V written at
      cache_len, attention over the whole cache with q_offset = cache_len;
      the causal mask hides the unwritten tail.

    The caches are updated in place (the engine owns them; an in-place row
    write spares a copy of every layer's cache each round)."""
    B, Sq, _ = x.shape
    q = (x @ p["wq"]).reshape(B, Sq, n_heads, d_head)
    k = (x @ p["wk"]).reshape(B, Sq, n_kv, d_head)
    v = (x @ p["wv"]).reshape(B, Sq, n_kv, d_head)

    if rope is not None:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)

    per_slot = torch.is_tensor(cache_len) and cache_len.dim() == 1
    if kv_cache is not None and per_slot:
        if Sq != 1:
            raise ValueError("per-slot cache_len supports one-token decode "
                             f"only; got Sq={Sq}")
        ck, cv = kv_cache
        rows = torch.arange(B, device=x.device)
        idx = cache_len.long()
        ck[rows, idx] = k[:, 0].to(ck.dtype)
        cv[rows, idx] = v[:, 0].to(cv.dtype)
        out = decode_ops.decode_attention(q[:, 0], ck, cv, cache_len + 1,
                                          window=window)
        return out.reshape(B, Sq, n_heads * d_head) @ p["wo"], (ck, cv)

    if kv_cache is not None:
        ck, cv = kv_cache
        idx = int(cache_len) if cache_len is not None else ck.shape[1] - Sq
        ck[:, idx:idx + Sq] = k.to(ck.dtype)
        cv[:, idx:idx + Sq] = v.to(cv.dtype)
        k_full, v_full, q_off, new_cache = ck, cv, idx, (ck, cv)
    else:
        k_full, v_full, q_off, new_cache = k, v, 0, None
    # the GQA repeat is left to the attention (h -> h // rep), which gives
    # the numbers of the JAX package's repeat_kv: it is an exact broadcast
    out = attn_ops.attention(q, k_full, v_full, causal=causal, window=window,
                             q_offset=q_off)
    return out.reshape(B, Sq, n_heads * d_head) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def causal_lm_loss(logits: Tensor, labels: Tensor, ignore: int = -1) -> Tensor:
    """Mean cross-entropy over the positions whose label is not `ignore`:
    logits (B, S, V) upcast to f32, labels (B, S) int; the target logit is
    gathered at max(label, 0), and the sum is divided by max(count, 1), as
    in the JAX package."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.gather(logits32, -1,
                       labels.long().clamp_min(0)[..., None])[..., 0]
    valid = (labels != ignore).float()
    return torch.sum((lse - tgt) * valid) / torch.clamp_min(valid.sum(), 1.0)
