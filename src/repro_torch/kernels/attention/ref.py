"""Plain-torch attention: the version CPU tensors run and the CUDA kernel
(`csrc/attention.cu`) is held against on the card.

GQA, causal and sliding-window masks as in the JAX package's
`attention_ref`; scores and softmax in f32, output in q's dtype.
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
