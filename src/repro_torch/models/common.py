"""Shared neural components of the DiT: layer norm, the non-gated GELU MLP
and the non-causal attention block.

Parameters keep the JAX package's orientation: a dense weight is
(d_in, d_out) and is applied as `x @ W`.  Norms compute in f32 and cast
back to the activation dtype, as in the JAX package; attention dispatches
through `kernels.attention.ops` (the plain version on a CPU tensor, the
CUDA kernel on a CUDA tensor).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels.attention import ops as attn_ops

Tensor = torch.Tensor


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, device="cpu") -> Tensor:
    """N(0, 1/d_in) weight (or N(0, scale^2)), drawn in f32 then cast."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
    return (w * s).to(device=device, dtype=dtype)


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor,
               eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis in f32 (biased variance, like
    `jnp.var`), cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(),
                        eps).to(x.dtype)


def mlp_apply(p: Dict[str, Tensor], x: Tensor, act: str = "gelu") -> Tensor:
    """Non-gated MLP, up -> activation -> down.  `gelu` is the tanh
    approximation, `jax.nn.gelu`'s default."""
    if act != "gelu":
        raise ValueError(f"only the DiT's gelu MLP is ported, got {act!r}")
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def attn_apply(p: Dict[str, Tensor], x: Tensor, *, n_heads: int,
               d_head: int) -> Tensor:
    """Non-causal self-attention without rotary embedding or cache (the DiT
    form): (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, d_head)
    k = (x @ p["wk"]).reshape(B, S, n_heads, d_head)
    v = (x @ p["wv"]).reshape(B, S, n_heads, d_head)
    out = attn_ops.attention(q, k, v, causal=False)
    return out.reshape(B, S, n_heads * d_head) @ p["wo"]
