"""Plain-torch attention: the version CPU tensors run and the CUDA kernel
(`csrc/attention.cu`) is held against on the card.

GQA, causal and sliding-window masks as in the JAX package's
`attention_ref`; scores and softmax in f32, output in q's dtype.  Beside
it, `attention_bwd_ref`, the plain gradient of the DiT form: the backward
of the port's DiT attention on both devices.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0) -> Tensor:
    """q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh); Hq % Hkv == 0."""
    B, Sq, Hq, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    rep = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, Dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) \
        / math.sqrt(float(Dh))
    q_pos = (q_offset + torch.arange(Sq, device=q.device))[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    # fully-masked rows (tiny windows) -> zeros, not NaN
    w = torch.where(torch.isfinite(scores).any(-1, keepdim=True), w, 0.0)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v.float())
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


def attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, do: Tensor):
    """Gradients (dq, dk, dv) of the DiT form of `attention_ref`
    (non-causal, no window, Hq == Hkv) for the output gradient `do`, each
    in its input's dtype.  P is recomputed from q and k in f32 and every
    product is f32:

        S = q k^T / sqrt(Dh),  P = softmax(S),  dV = P^T dO,
        dP = dO V^T,  dS = P * (dP - rowsum(dP * P)),
        dQ = dS K / sqrt(Dh),  dK = dS^T Q / sqrt(Dh).

    The JAX package takes this gradient through its `attention_ref` (its
    Pallas kernel has no backward), so this is the reference of the
    port's DiT attention backward on either device."""
    if q.shape != k.shape or k.shape != v.shape or do.shape != q.shape:
        raise ValueError("attention_bwd_ref: the DiT form takes q, k, v and "
                         "do of one shape (B, S, H, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(do.shape)}")
    scale = math.sqrt(float(q.shape[-1]))
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q32, k32) / scale,
                      dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) / scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) / scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
