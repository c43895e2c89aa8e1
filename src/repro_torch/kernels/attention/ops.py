"""Attention dispatch: a CPU tensor runs the plain version, a CUDA tensor
the hand-written flash kernel (`csrc/attention.cu`).

The kernel covers the DiT form — non-causal, no window, Hq == Hkv,
q_offset 0, head width 32, 64 or 128, f32 or bf16.  A CUDA call outside
that form raises: it is never sent to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import cuda
from .ref import attention_ref

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_WIDTHS = (32, 64, 128)
# q, k, v, o, B, S, H, Dh, dtype, scale, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
    [ctypes.c_float, ctypes.c_void_p]


def flash_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """The CUDA kernel: q/k/v (B, S, H, Dh) on one card, same dtype ->
    (B, S, H, Dh) in that dtype."""
    B, S, H, Dh = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{list(_DTYPES)}")
    if Dh not in _HEAD_WIDTHS:
        raise ValueError(f"flash_attention: head width {Dh} not in "
                         f"{_HEAD_WIDTHS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda.require(t, name, q.dtype, (B, S, H, Dh), q.device)
    fn = cuda.function("attention", "repro_flash_attention", _ARGTYPES)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, Dh, _DTYPES[q.dtype], 1.0 / math.sqrt(Dh),
            cuda.stream_ptr(q))
    cuda.check("attention", rc, "flash_attention")
    cuda.count_launch("flash_attention")
    return out


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: Optional[int] = None, q_offset: int = 0) -> Tensor:
    """Multi-head attention, q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh)."""
    if cuda.device_of(q) == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if causal or window is not None or q_offset != 0 \
            or q.shape != k.shape or k.shape != v.shape:
        raise NotImplementedError(
            "the CUDA attention kernel covers the non-causal, window-free, "
            "Hq == Hkv, Sq == Sk form (the DiT); the causal/window/GQA form "
            "is not ported yet")
    return flash_attention(q, k, v)
