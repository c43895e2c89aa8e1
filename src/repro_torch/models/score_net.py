"""Score networks: the DiT (patchified transformer with adaLN-zero time
conditioning, Peebles & Xie 2023) for image-shaped states, and the small
residual MLP for low-dimensional toy data (the paper's mixture
experiments).

A net consumes the state u (CLD: (B, 2, H, W, C); otherwise (B, H, W, C))
and a continuous time t (B,), and returns an eps prediction of u's shape —
both channels for CLD, the paper's Eq. 80 parameterization.  The public
layout is the JAX package's; the 24 layers that JAX stacks along a leading
axis are an `nn.ModuleList` here.  Weights are (d_in, d_out) and applied as
`x @ W`, so `convert.from_jax_params` carries a JAX param tree across
without transposes.  The compute dtype is the config's (bf16 at full
width): the input is cast to it after patchify and the norms compute in f32
and cast back, where the JAX package casts.  A DiT handed params of
another dtype (a low-precision class, `models/quantize.py`) keeps those
casts as rounding points and computes in the params' dtype, as JAX's
promotion does.

Weights are created with `requires_grad=False`, so serving builds no
autograd graph; training turns gradients on with `net.requires_grad_()`.
Under grad mode with `DiTCfg.remat` (the JAX default; full-width configs
keep it, reduced ones turn it off) each DiT layer runs under
`torch.utils.checkpoint` (non-reentrant), the counterpart of the JAX
package's `jax.checkpoint(..., nothing_saveable)`: the layer's forward
runs again in the backward pass, so a training step launches each
layer's attention kernel twice.  With grad off the forward is the same
ops as ever.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common

Tensor = torch.Tensor


def timestep_embedding(t: Tensor, dim: int, max_period: float = 1e4) -> Tensor:
    """Sinusoidal features of continuous t in [0, 1]: (B,) -> (B, dim),
    cos then sin, angle t * freq * 1000."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


@dataclasses.dataclass(frozen=True)
class DiTCfg:
    img_size: int = 32
    channels: int = 3                  # data channels (CLD doubles via state_mult)
    state_mult: int = 1                # 2 for CLD (x, v stacked on the channel axis)
    patch: int = 4
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    dtype: Any = torch.float32
    remat: bool = True

    @property
    def n_tokens(self) -> int:
        return (self.img_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.channels * self.state_mult

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Residual MLP (toy data)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLPScoreCfg:
    state_shape: Tuple[int, ...]       # per-example state shape, e.g. (2,) or (2, 2)
    hidden: int = 256
    n_blocks: int = 4
    t_dim: int = 64
    dtype: Any = torch.float32

    @property
    def state_dim(self) -> int:
        return int(np.prod(self.state_shape))


class MLPScore(nn.Module):
    """The JAX package's residual MLP score net: [u, t-embedding] -> silu
    dense -> blocks of h + dense(silu(dense([h, te]))) -> dense, reshaped
    to u's shape.  `forward(u, t)` -> eps of u's shape."""

    def __init__(self, cfg: MLPScoreCfg,
                 gen: Optional[torch.Generator] = None, device="cpu"):
        super().__init__()
        self.cfg = cfg
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        dt, H, T = cfg.dtype, cfg.hidden, cfg.t_dim
        init = lambda a, b, s=None: _param(
            common.dense_init(gen, a, b, dt, s, device))
        zeros = lambda n: _param(torch.zeros(n, dtype=dt, device=device))
        self.w_in = init(cfg.state_dim + T, H)
        self.b_in = zeros(H)
        self.w_out = init(H, cfg.state_dim, 1e-3)
        self.b_out = zeros(cfg.state_dim)
        self.blocks = nn.ModuleList(nn.ParameterDict({
            "w1": init(H + T, H), "b1": zeros(H),
            "w2": init(H, H), "b2": zeros(H)}) for _ in range(cfg.n_blocks))

    def forward(self, u: Tensor, t: Tensor) -> Tensor:
        B = u.shape[0]
        te = timestep_embedding(t, self.cfg.t_dim).to(u.dtype)
        h = torch.cat([u.reshape(B, -1), te], dim=-1)
        h = F.silu(h @ self.w_in + self.b_in)
        for blk in self.blocks:
            z = torch.cat([h, te], dim=-1)
            z = F.silu(z @ blk["w1"] + blk["b1"])
            h = h + z @ blk["w2"] + blk["b2"]
        out = h @ self.w_out + self.b_out
        return out.reshape(u.shape)


# ---------------------------------------------------------------------------
# DiT (image-shaped states)
# ---------------------------------------------------------------------------

class _DiTLayer(nn.Module):
    def __init__(self, cfg: DiTCfg, gen: torch.Generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        init = lambda a, b, s=None: _param(
            common.dense_init(gen, a, b, dt, s, device))
        self.attn = nn.ParameterDict({
            "wq": init(d, d), "wk": init(d, d), "wv": init(d, d),
            "wo": init(d, d, 1.0 / math.sqrt(d))})
        self.mlp = nn.ParameterDict({"w_up": init(d, 4 * d),
                                     "w_down": init(4 * d, d)})
        # adaLN-zero: 6 modulation vectors from the time embedding
        self.ada_w = init(d, 6 * d, 1e-3)
        self.ada_b = _param(torch.zeros(6 * d, dtype=dt, device=device))


def _modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    return x * (1.0 + scale[:, None]) + shift[:, None]


class DiT(nn.Module):
    """DiT score net; `forward(u, t)` -> eps of u's shape and dtype."""

    def __init__(self, cfg: DiTCfg, gen: Optional[torch.Generator] = None,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        d, dt = cfg.d_model, cfg.dtype
        init = lambda a, b, s=None: _param(
            common.dense_init(gen, a, b, dt, s, device))
        self.patch_in = init(cfg.patch_dim, d)
        self.pos = init(cfg.n_tokens, d, 0.02)
        self.t_mlp1 = init(256, d)
        self.t_mlp2 = init(d, d)
        self.layers = nn.ModuleList(_DiTLayer(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.final_ada_w = init(d, 2 * d, 1e-3)
        self.final_ada_b = _param(torch.zeros(2 * d, dtype=dt, device=device))
        # zero-init output projection (adaLN-zero)
        self.patch_out = _param(torch.zeros(d, cfg.patch_dim, dtype=dt,
                                            device=device))

    def _layer(self, lp: _DiTLayer, h: Tensor, te_act: Tensor, ones: Tensor,
               zeros: Tensor) -> Tensor:
        cfg = self.cfg
        mod = te_act @ lp.ada_w + lp.ada_b
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
        z = _modulate(common.layer_norm(h, ones, zeros), sh1, sc1)
        a, _ = common.attn_apply(lp.attn, z, n_heads=cfg.n_heads,
                                 n_kv=cfg.n_heads, d_head=cfg.d_head,
                                 causal=False)
        h = h + g1[:, None] * a
        z = _modulate(common.layer_norm(h, ones, zeros), sh2, sc2)
        return h + g2[:, None] * common.mlp_apply(lp.mlp, z, act="gelu")

    def forward(self, u: Tensor, t: Tensor) -> Tensor:
        cfg = self.cfg
        B = u.shape[0]
        P, n_side = cfg.patch, cfg.img_size // cfg.patch
        cm = cfg.channels * cfg.state_mult
        if u.dim() == 5:          # CLD state (B, state_mult, H, W, C)
            x = u.permute(0, 1, 4, 2, 3).reshape(B, cm, cfg.img_size,
                                                 cfg.img_size)
        else:                     # (B, H, W, C)
            x = u.permute(0, 3, 1, 2)
        # patchify: (B, cm, H, W) -> (B, T, patch_dim)
        x = x.reshape(B, cm, n_side, P, n_side, P).permute(0, 2, 4, 1, 3, 5)
        # the casts to cfg.dtype are rounding points; the compute dtype is
        # the params' (an int8-class eval at full width hands f32 params,
        # models/quantize.py), equal to cfg.dtype otherwise
        cd = self.patch_in.dtype
        x = x.reshape(B, n_side * n_side, cm * P * P).to(cfg.dtype).to(cd)

        h = x @ self.patch_in + self.pos[None]
        te = timestep_embedding(t, 256).to(cfg.dtype).to(cd)
        te = F.silu(te @ self.t_mlp1)
        te = F.silu(te @ self.t_mlp2)                          # (B, d)
        te_act = F.silu(te)

        d = h.shape[-1]
        ones = torch.ones(d, dtype=cfg.dtype, device=h.device)
        zeros = torch.zeros(d, dtype=cfg.dtype, device=h.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in self.layers:
            if remat:
                h = checkpoint(self._layer, lp, h, te_act, ones, zeros,
                               use_reentrant=False)
            else:
                h = self._layer(lp, h, te_act, ones, zeros)

        mod = te_act @ self.final_ada_w + self.final_ada_b
        sh, sc = torch.chunk(mod, 2, dim=-1)
        h = _modulate(common.layer_norm(h, ones, zeros), sh, sc)
        out = h @ self.patch_out                               # (B, T, patch_dim)
        # unpatchify straight into u's layout, so that eps comes out
        # contiguous: the sampler hands its rows to ei_update by address
        if u.dim() == 5:
            out = out.reshape(B, n_side, n_side, cfg.state_mult,
                              cfg.channels, P, P).permute(0, 3, 1, 5, 2, 6, 4)
        else:
            out = out.reshape(B, n_side, n_side, cm, P, P).permute(
                0, 1, 4, 2, 5, 3)
        return out.reshape(u.shape).to(
            u.dtype, memory_format=torch.contiguous_format)
