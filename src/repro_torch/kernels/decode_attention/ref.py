"""Plain-torch decode attention: the version CPU tensors run and the CUDA
kernel (`csrc/decode_attention.cu`) is held against on the card.

q: (B, Hq, Dh) — one new token per row; k/v: (B, S, Hkv, Dh) — the
pre-allocated cache.  Row b attends its first `cache_len[b]` entries
(`cache_len` a scalar or (B,)); `window` keeps only the trailing `window`
of them (the query sits at position cache_len - 1); GQA broadcast
Hq = rep * Hkv.  Scores and softmax in f32, a fully masked row gives 0,
the output has q's dtype — as the JAX package's `decode_attention_ref`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor


def decode_attention_ref(q: Tensor, k: Tensor, v: Tensor, cache_len,
                         window: Optional[int] = None) -> Tensor:
    B, Hq, Dh = q.shape
    _, S, Hkv, _ = k.shape
    rep = Hq // Hkv
    qg = q.reshape(B, Hkv, rep, Dh).float()
    scores = torch.einsum("bhrd,bshd->bhrs", qg, k.float())
    scores = scores / math.sqrt(float(Dh))
    n_valid = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    k_pos = torch.arange(S, device=q.device)[None]                  # (1, S)
    mask = k_pos < n_valid                                          # (B|1, S)
    if window is not None:
        mask = mask & (k_pos >= n_valid - window)
    mask = mask.expand(B, S)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = torch.where(torch.isfinite(scores).any(-1, keepdim=True), w, 0.0)
    out = torch.einsum("bhrs,bshd->bhrd", w, v.float())
    return out.reshape(B, Hq, Dh).to(q.dtype)
