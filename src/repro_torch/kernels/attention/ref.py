"""Plain-torch attention: the version CPU tensors run and the CUDA kernel
(`csrc/attention.cu`) is held against on the card.

GQA, causal and sliding-window masks as in the JAX package's
`attention_ref`; scores and softmax in f32, output in q's dtype.  Beside
it, `attention_bwd_ref`, the plain gradient of the forms that train, at
q_offset 0: non-causal without a window (any Sq and Sk, GQA) and the
causal / window / GQA form at Sq == Sk.  It is the backward of the
port's attention on both devices.
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


def attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, do: Tensor, *,
                      causal: bool = False, window: Optional[int] = None):
    """Gradients (dq, dk, dv) of `attention_ref` for the output gradient
    `do`, each in its input's dtype, at q_offset 0 in the forms that
    train: non-causal without a window (the DiT; the encoder-decoder's
    self- and cross-attention, any Sq and Sk, GQA), and causal with an
    optional window and GQA (Hkv dividing Hq) at Sq == Sk.  P is
    recomputed from q and k in f32 under `attention_ref`'s masks and every
    product is f32:

        S = q k^T / sqrt(Dh),  P = softmax(S),  dV = P^T dO,
        dP = dO V^T,  dS = P * (dP - rowsum(dP * P)),
        dQ = dS K / sqrt(Dh),  dK = dS^T Q / sqrt(Dh).

    A fully masked row has P = 0, so it gives nothing; under GQA dK and
    dV sum over the rep = Hq / Hkv query heads of each kv head.  The JAX
    package takes this gradient through its `attention_ref` (its Pallas
    kernel has no backward), so this is the reference of the port's
    attention backward on either device."""
    B, Sq, Hq, Dh = q.shape
    if k.shape != v.shape or do.shape != q.shape or k.dim() != 4 \
            or k.shape[0] != B or k.shape[3] != Dh or Hq % k.shape[2] \
            or (causal and k.shape[1] != Sq):
        raise ValueError("attention_bwd_ref: q and do of shape (B, Sq, Hq, "
                         "Dh), k and v (B, Sk, Hkv, Dh) with Hkv dividing "
                         "Hq, Sk == Sq when causal; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(do.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = math.sqrt(float(Dh))
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    if not causal and window is None and Hkv == Hq:
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q32, k32) / scale,
                          dim=-1)
        dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) / scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) / scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    rep = Hq // Hkv
    qg = q32.reshape(B, Sq, Hkv, rep, Dh)
    dog = do32.reshape(B, Sq, Hkv, rep, Dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k32) / scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    dv = torch.einsum("bhrqk,bqhrd->bkhd", p, dog)
    dp = torch.einsum("bqhrd,bkhd->bhrqk", dog, v32)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, k32) / scale
    dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qg) / scale
    return (dq.reshape(B, Sq, Hq, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
