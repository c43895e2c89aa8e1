"""RWKV6 "Finch" token mixing (Peng et al. 2024, arXiv:2404.05892), the
JAX package's `models/rwkv6.py` in PyTorch.

An attention-free linear recurrence with a data-dependent decay per
channel:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (per head, S: (Dk, Dv))
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with w_t = exp(-exp(d_t)) from a token-shifted LoRA and the "bonus" u
giving the current token a path without decay.  The decode state is O(1)
a token.

`rwkv6_chunked` is the training and prefill form: within chunks of Q
tokens the pairwise decay D[t, s, d] = B_t[d] - A_s[d] (A the inclusive,
B the exclusive cumulative sum of log w) is materialized and masked to
-inf above the diagonal *before* the exponential, so no exponent is
positive, and `torch.where` keeps the masked entries out of the gradient;
the chunk-boundary states run through a loop over the chunks (the JAX
`lax.scan`).  `rwkv6_sequential` is the per-token recurrence (the decode
step, and the oracle of the tests).  Both are plain PyTorch, as the JAX
package computes them in plain jnp: there is no Pallas kernel to port.

`time_mix_apply` with a cache and one token runs the per-token recurrence,
as the JAX decode does; with a cache and more tokens (prefill) it runs the
chunked form from the cache's state and returns its final state, the same
function as the JAX package's per-token prefill, computed in O(S / Q)
steps.  A padded tail step has log w = 0 and k = v = 0, so the state at the
last real token is the final one.

Parameters keep the JAX tree's names and orientation (a dense weight is
(d_in, d_out)); the layer cache is the tuple (x_prev of the time mix (B,
1, D), S (B, H, Dk, Dv) f32, x_prev of the channel mix (B, 1, D)).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from . import common
from .common import Params

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RWKV6Cfg:
    d_model: int
    n_heads: int                 # head size = d_model // n_heads
    d_ff: int
    lora_decay: int = 64         # decay LoRA rank
    lora_mix: int = 32           # token-shift mix LoRA rank
    chunk: int = 16              # intra-chunk tile (exponent-safe)
    dtype: Any = torch.float32

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# core recurrence
# ---------------------------------------------------------------------------
def rwkv6_chunked(r: Tensor, k: Tensor, v: Tensor, w_log: Tensor, u: Tensor,
                  chunk: int, state0: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """r/k: (B, S, H, Dk); v: (B, S, H, Dv); w_log = log w_t (<= 0), k's
    shape; u: (H, Dk); S a multiple of `chunk`.  Returns (y (B, S, H, Dv)
    in r's dtype, the final state (B, H, Dk, Dv) f32)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    rc = r.reshape(b, nc, chunk, h, dk).to(f32)
    kc = k.reshape(b, nc, chunk, h, dk).to(f32)
    vc = v.reshape(b, nc, chunk, h, dv).to(f32)
    wc = w_log.reshape(b, nc, chunk, h, dk).to(f32)

    A = torch.cumsum(wc, dim=2)                    # inclusive
    Bx = A - wc                                    # exclusive: A_{t-1}
    A_last = A[:, :, -1]                           # (b, nc, h, dk)

    # intra-chunk: y_t = sum_{s<t} (r_t . exp(B_t - A_s) . k_s) v_s
    #   + (r_t . u . k_t) v_t, the pairwise decay masked before exp
    D = Bx[:, :, :, None] - A[:, :, None, :]       # (b, nc, t, s, h, dk)
    t_idx = torch.arange(chunk, device=r.device)
    strict = (t_idx[:, None] > t_idx[None, :])[None, None, :, :, None, None]
    D = torch.where(strict, D, torch.full_like(D, -torch.inf))
    scores = torch.einsum("bcthd,bctshd,bcshd->bcths", rc, torch.exp(D), kc)
    diag = torch.einsum("bcthd,hd,bcthd->bcth", rc, u.to(f32), kc)
    eye = torch.eye(chunk, dtype=f32, device=r.device)[:, None, :]
    scores = scores + diag[..., None] * eye
    y = torch.einsum("bcths,bcshd->bcthd", scores, vc)

    # chunk summary: S_out = diag(exp(A_Q)) S_in + sum_s exp(A_Q - A_s) k_s v_s
    decay_out = torch.exp(A_last[:, :, None] - A)  # exponent <= 0
    chunk_states = torch.einsum("bcshd,bcshd,bcshe->bchde", decay_out, kc, vc)

    S = (torch.zeros((b, h, dk, dv), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    S_prev = []                                    # the state entering c
    for c in range(nc):
        S_prev.append(S)
        S = torch.exp(A_last[:, c])[..., None] * S + chunk_states[:, c]
    S_prev = torch.stack(S_prev, dim=1)            # (b, nc, h, dk, dv)

    # the entering state's contribution: y_t += (r_t . exp(B_t)) @ S_in
    y = y + torch.einsum("bcthd,bcthd,bchde->bcthe", rc, torch.exp(Bx),
                         S_prev)
    return y.reshape(b, s, h, dv).to(r.dtype), S


def rwkv6_sequential(r: Tensor, k: Tensor, v: Tensor, w_log: Tensor,
                     u: Tensor, state0: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """The per-token recurrence (decode; the tests' oracle): the shapes
    of `rwkv6_chunked`, any S."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    f32 = torch.float32
    S = (torch.zeros((b, h, dk, dv), dtype=f32, device=r.device)
         if state0 is None else state0.to(f32))
    u32 = u.to(f32)
    ys = []
    for t in range(s):
        rt, kt, vt = r[:, t].to(f32), k[:, t].to(f32), v[:, t].to(f32)
        wt = torch.exp(w_log[:, t].to(f32))
        y = torch.einsum("bhd,bhde->bhe", rt, S) + \
            torch.einsum("bhd,hd,bhd,bhe->bhe", rt, u32, kt, vt)
        S = wt[..., None] * S + torch.einsum("bhd,bhe->bhde", kt, vt)
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), S


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _uniform(gen, shape, device) -> Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device).to(device)


def _lora(gen, d: int, rank: int, d_out: int, dtype, device) -> Params:
    b = torch.randn((rank, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device) * 0.01
    return {"a": common.dense_init(gen, d, rank, dtype, None, device),
            "b": b.to(device=device, dtype=dtype)}


def _lora_apply(p: Params, x: Tensor) -> Tensor:
    return torch.tanh(x @ p["a"]) @ p["b"]


def time_mix_params(gen: torch.Generator, cfg: RWKV6Cfg,
                    device="cpu") -> Params:
    """The JAX init's leaves and scales, drawn from `gen`."""
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.dtype
    dense = lambda: common.dense_init(gen, d, d, dt, None, device)
    mu = _uniform(gen, (5, d), device).to(dt)
    mix_lora = _lora(gen, d, cfg.lora_mix, 5 * d, dt, device)
    wr, wk, wv, wg, wo = dense(), dense(), dense(), dense(), dense()
    decay_lora = _lora(gen, d, cfg.lora_decay, d, dt, device)
    u = torch.randn((h, cfg.d_head), generator=gen, dtype=torch.float32,
                    device=gen.device).to(device) * 0.5
    return {"mu": mu, "mix_lora": mix_lora, "wr": wr, "wk": wk, "wv": wv,
            "wg": wg, "wo": wo,
            "decay_base": torch.full((d,), -4.0, dtype=torch.float32,
                                     device=device),
            "decay_lora": decay_lora, "u": u,
            "ln_out": torch.ones(d, dtype=torch.float32, device=device)}


def _token_shift(x: Tensor, x_prev: Optional[Tensor]) -> Tensor:
    """x shifted one token later, `x_prev` (B, 1, D) (or zeros) first."""
    xp = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev.to(x.dtype)
    return torch.cat([xp, x[:, :-1]], dim=1)


def _pad_tokens(t: Tensor, pad: int) -> Tensor:
    """(B, S, ...) padded with `pad` zero steps at the end."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def time_mix_apply(p: Params, cfg: RWKV6Cfg, x: Tensor,
                   cache: Optional[Tuple[Tensor, Tensor]] = None
                   ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """x: (B, S, D); cache = (x_prev (B, 1, D), state (B, H, Dk, Dv)).
    Returns (out, (x_prev, state) after the last token, or None without a
    cache)."""
    B, S, D = x.shape
    H, Dh = cfg.n_heads, cfg.d_head
    dx = _token_shift(x, None if cache is None else cache[0]) - x
    # the data-dependent five-way mix (r, k, v, g, w): Finch's dynamic lerp
    mix = p["mu"][:, None, None] + _lora_apply(p["mix_lora"], x).reshape(
        B, S, 5, D).permute(2, 0, 1, 3)
    xr, xk, xv, xg, xw = [x + mix[i] * dx for i in range(5)]

    r = (xr @ p["wr"]).reshape(B, S, H, Dh)
    k = (xk @ p["wk"]).reshape(B, S, H, Dh)
    v = (xv @ p["wv"]).reshape(B, S, H, Dh)
    g = F.silu(xg @ p["wg"])
    d_t = p["decay_base"][None, None] + _lora_apply(
        p["decay_lora"], xw).float()
    w_log = -torch.exp(d_t).reshape(B, S, H, Dh)   # log w_t = -exp(d_t) <= 0

    new_cache = None
    if cache is not None and S == 1:
        y, state = rwkv6_sequential(r, k, v, w_log, p["u"], state0=cache[1])
        new_cache = (x[:, -1:], state)
    else:
        pad = (-S) % cfg.chunk
        if pad:
            r, k, v, w_log = (_pad_tokens(t, pad) for t in (r, k, v, w_log))
        y, state = rwkv6_chunked(r, k, v, w_log, p["u"], cfg.chunk,
                                 None if cache is None else cache[1])
        y = y[:, :S]
        if cache is not None:
            new_cache = (x[:, -1:], state)

    # per-head group norm (population variance, as jnp.var), the output
    # gate
    y32 = y.reshape(B, S, H, Dh).float()
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    y = ((y32 - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, D)
    y = (y * p["ln_out"]).to(x.dtype) * g
    return y @ p["wo"], new_cache


def channel_mix_params(gen: torch.Generator, cfg: RWKV6Cfg,
                       device="cpu") -> Params:
    d, dt = cfg.d_model, cfg.dtype
    mu = _uniform(gen, (2, d), device).to(dt)
    return {"mu": mu,
            "wk": common.dense_init(gen, d, cfg.d_ff, dt, None, device),
            "wv": common.dense_init(gen, cfg.d_ff, d, dt, None, device),
            "wr": common.dense_init(gen, d, d, dt, None, device)}


def channel_mix_apply(p: Params, x: Tensor,
                      x_prev: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Optional[Tensor]]:
    """x: (B, S, D); `x_prev` (B, 1, D) of a cached call.  Returns (out,
    the new x_prev, or None without one)."""
    dx = _token_shift(x, x_prev) - x
    xk = x + p["mu"][0] * dx
    xr = x + p["mu"][1] * dx
    kk = F.relu(xk @ p["wk"])
    out = (kk * kk) @ p["wv"]
    return (torch.sigmoid(xr @ p["wr"]) * out,
            x[:, -1:] if x_prev is not None else None)


def layer_params(gen: torch.Generator, cfg: RWKV6Cfg, device="cpu") -> Params:
    return {"ln1": torch.zeros(cfg.d_model, dtype=cfg.dtype, device=device),
            "ln2": torch.zeros(cfg.d_model, dtype=cfg.dtype, device=device),
            "tmix": time_mix_params(gen, cfg, device),
            "cmix": channel_mix_params(gen, cfg, device)}


def layer_apply(p: Params, cfg: RWKV6Cfg, x: Tensor, cache=None):
    """cache = (x_prev_t, state, x_prev_c) for serving, else None."""
    tc = None if cache is None else (cache[0], cache[1])
    h, new_t = time_mix_apply(p["tmix"], cfg, common.rms_norm(x, p["ln1"]),
                              cache=tc)
    x = x + h
    h, new_c = channel_mix_apply(p["cmix"], common.rms_norm(x, p["ln2"]),
                                 x_prev=None if cache is None else cache[2])
    x = x + h
    return x, (None if cache is None else (new_t[0], new_t[1], new_c))


def init_layer_cache(cfg: RWKV6Cfg, batch: int, dtype=None,
                     device="cpu") -> Tuple[Tensor, Tensor, Tensor]:
    """(x_prev_t (batch, 1, D), S (batch, H, Dk, Dv) f32, x_prev_c), zero."""
    dtype = dtype or cfg.dtype
    row = (batch, 1, cfg.d_model)
    return (torch.zeros(row, dtype=dtype, device=device),
            torch.zeros((batch, cfg.n_heads, cfg.d_head, cfg.d_head),
                        dtype=torch.float32, device=device),
            torch.zeros(row, dtype=dtype, device=device))
