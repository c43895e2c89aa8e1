"""The Mamba2 (SSD) mixer of zamba2-2.7b, the JAX package's
`models/ssm.py` in PyTorch.

The state-space dual algorithm of Mamba-2 (Dao & Gu 2024,
arXiv:2405.21060): within chunks of Q tokens the recurrence

    h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t,   y_t = C_t h_t

is computed in its quadratic, attention-like form (products under a
causal decay mask; `segsum` puts -inf above the diagonal before the
exponential, so no exponent is positive), and the chunk-boundary states
run through a loop over the chunks (the JAX `lax.scan`): O(S Q) work,
O(S / Q) sequential steps.  `ssd_sequential` is the per-token recurrence
(the decode step; the tests' oracle).  Plain PyTorch, as the JAX package
computes them in plain jnp: there is no Pallas kernel to port.

`mamba2_apply` with a cache and one token runs the per-token recurrence,
as the JAX decode does; with a cache and more tokens (prefill) it runs the
chunked form from the cache's state and returns its final state and the
last d_conv - 1 inputs of the convolution, the same function as the JAX
package's per-token prefill.  A padded tail step has dt = 0 (no decay, no
input), so the final state is the state at the last real token; the
convolution's state comes from the real inputs, before any padding.

The cache is the tuple (conv_state (B, d_conv - 1, conv_dim) in the
config's dtype, ssm_state (B, H, N, P) f32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from . import common
from .common import Params

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Mamba2Cfg:
    d_model: int
    d_state: int = 64
    d_head: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    dtype: Any = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def segsum(x: Tensor) -> Tensor:
    """x: (..., Q) -> (..., Q, Q), out[i, j] = sum_{k=j+1..i} x[k] for i
    >= j, -inf above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.full_like(out, -torch.inf))


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                chunk: int, state0: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """x: (b, s, h, p); dt: (b, s, h); A: (h,) (negative); B, C: (b, s, h,
    n) (already expanded over the heads); s a multiple of `chunk`.
    Returns (y (b, s, h, p) in x's dtype, the final state (b, h, n, p)
    f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xb = (x * dt[..., None]).to(f32)                       # dt-weighted input
    dA = dt.to(f32) * A.to(f32)                            # (b, s, h)

    xc = xb.reshape(b, nc, chunk, h, p)
    Bc = B.to(f32).reshape(b, nc, chunk, h, n)
    Cc = C.to(f32).reshape(b, nc, chunk, h, n)
    dAc = dA.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)  # (b, nc, h, Q)
    dA_cum = torch.cumsum(dAc, dim=-1)                     # inclusive
    dA_sum = dA_cum[..., -1]                               # (b, nc, h)

    # intra-chunk: the quadratic, attention-like form
    L = torch.exp(segsum(dAc))                             # (b, nc, h, Q, Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc) * L
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xc)

    # chunk summary states: sum_j exp(dA_sum - dA_cum[j]) B_j xb_j
    decay_states = torch.exp(dA_sum[..., None] - dA_cum)   # (b, nc, h, Q)
    states = torch.einsum("bchj,bcjhn,bcjhp->bchnp", decay_states, Bc, xc)

    S = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
         if state0 is None else state0.to(f32))
    S_prev = []                                            # entering chunk c
    for c in range(nc):
        S_prev.append(S)
        S = torch.exp(dA_sum[:, c])[..., None, None] * S + states[:, c]
    S_prev = torch.stack(S_prev, dim=1)                    # (b, nc, h, n, p)

    # the entering state's contribution to each position
    state_decay = torch.exp(dA_cum)                        # (b, nc, h, Q)
    y_off = torch.einsum("bcihn,bchi,bchnp->bcihp", Cc, state_decay, S_prev)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), S


def ssd_sequential(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                   state0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The per-token recurrence (decode; the tests' oracle): the shapes of
    `ssd_chunked`, any s."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    S = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
         if state0 is None else state0.to(f32))
    A32 = A.to(f32)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t].to(f32) * A32)             # (b, h)
        S = S * dA[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", B[:, t].to(f32),
            (x[:, t] * dt[:, t][..., None]).to(f32))
        ys.append(torch.einsum("bhn,bhnp->bhp", C[:, t].to(f32), S))
    return torch.stack(ys, dim=1).to(x.dtype), S


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def mamba2_params(gen: torch.Generator, cfg: Mamba2Cfg,
                  device="cpu") -> Params:
    """The JAX init's leaves and scales, drawn from `gen`: dt_bias the
    softplus inverse of dt ~ log-uniform in [1e-3, 1e-1], A_log the logs of
    1..16 spaced over the heads, D ones."""
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.d_state + cfg.n_heads
    dt = cfg.dtype
    in_proj = common.dense_init(gen, cfg.d_model, d_in_proj, dt, None, device)
    conv_w = torch.randn((cfg.d_conv, cfg.conv_dim), generator=gen,
                         dtype=torch.float32, device=gen.device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * torch.rand(
        (cfg.n_heads,), generator=gen, dtype=torch.float32,
        device=gen.device))
    out_proj = common.dense_init(gen, cfg.d_inner, cfg.d_model, dt, None,
                                 device)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w / math.sqrt(cfg.d_conv)).to(device=device,
                                                      dtype=dt),
        "conv_b": torch.zeros(cfg.conv_dim, dtype=dt, device=device),
        "dt_bias": torch.log(torch.expm1(dt0)).to(device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, cfg.n_heads,
                                          device=device)),
        "D": torch.ones(cfg.n_heads, dtype=torch.float32, device=device),
        "norm": torch.zeros(cfg.d_inner, dtype=dt, device=device),
        "out_proj": out_proj}


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 conv_state: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C).  Returns (y, the
    last K - 1 inputs, the decode state)."""
    K = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K)) + b
    return y, (xp[:, -(K - 1):, :] if K > 1 else None)


def _softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)) as `jax.nn.softplus` computes it (logaddexp(x, 0),
    no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_apply(p: Params, cfg: Mamba2Cfg, x: Tensor,
                 cache: Optional[Tuple[Tensor, Tensor]] = None
                 ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """x: (B, S, D); cache = (conv_state (B, K - 1, conv_dim), ssm_state
    (B, H, N, P)).  Returns (out, the cache after the last token, or None
    without one)."""
    B_, S, _ = x.shape
    H, P, N = cfg.n_heads, cfg.d_head, cfg.d_state
    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = torch.split(
        zxbcdt, [cfg.d_inner, cfg.conv_dim, H], dim=-1)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 None if cache is None else cache[0])
    xBC = F.silu(xBC)
    xs, Bmat, Cmat = torch.split(xBC, [cfg.d_inner, N, N], dim=-1)
    xs = xs.reshape(B_, S, H, P)
    Bh = Bmat[:, :, None, :].expand(B_, S, H, N)
    Ch = Cmat[:, :, None, :].expand(B_, S, H, N)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    new_cache = None
    if cache is not None and S == 1:                        # decode
        y, state = ssd_sequential(xs, dt, A, Bh, Ch, state0=cache[1])
        new_cache = (new_conv, state)
    else:
        pad = (-S) % cfg.chunk
        xq, dtq, Bq, Cq = xs, dt, Bh, Ch
        if pad:
            xq, Bq, Cq = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, Bh, Ch))
            dtq = F.pad(dt, (0, 0, 0, pad))
        y, state = ssd_chunked(xq, dtq, A, Bq, Cq, cfg.chunk,
                               None if cache is None else cache[1])
        y = y[:, :S]
        if cache is not None:
            new_cache = (new_conv, state)

    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, cfg.d_inner)
    y = common.rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], new_cache


def init_mamba_cache(cfg: Mamba2Cfg, batch: int, dtype=None,
                     device="cpu") -> Tuple[Tensor, Tensor]:
    """(conv_state (batch, d_conv - 1, conv_dim), ssm_state (batch, H, N,
    P) f32), zero."""
    dtype = dtype or cfg.dtype
    return (torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim), dtype=dtype,
                        device=device),
            torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.d_head),
                        dtype=torch.float32, device=device))
