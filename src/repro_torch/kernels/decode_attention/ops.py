"""Decode-attention dispatch: a CPU tensor runs the plain version, a CUDA
tensor the hand-written kernel of `csrc/decode_attention.cu`, one launch
a call (counted as `decode_attention`).

The call is bound by latency, not bytes (~1.4 MB at gemma3-1b's decode
shape).  The kernel splits each row's live band over a cluster of up to
16 blocks, each block reading `cache_len` on the device (no host sync)
and taking an even share (bf16 on the tensor cores, f32 on the CUDA
cores), and merges the blocks' partial softmax sums through distributed
shared memory: no second launch and no scratch buffers.  The cluster's
size depends on S alone (`cluster_blocks`), so the grid never depends on
`cache_len`.

The kernel takes q (B, Hq, Dh) and a cache k/v (B, S, Hkv, Dh) of one
dtype (f32 or bf16), Dh in 16/32/64/80/128/256 (80: zamba2-2.7b's
shared block, its cache never padded), rep = Hq / Hkv up to 16, a
scalar or (B,) `cache_len` and an optional window.  A CUDA call outside
that form raises: it is never sent to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import cuda
from .ref import decode_attention_ref

Tensor = torch.Tensor

MAX_BLOCKS = 16                 # blocks per cluster (16: non-portable)
MAX_REP = 16
HEAD_WIDTHS = (16, 32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
# q k v cache_len o | B S Hkv rep Dh window dtype | scale | nb | stream
_ARGS = [_VP] * 5 + [_I] * 7 + [ctypes.c_float, _I, _VP]


def cluster_blocks(S: int) -> int:
    """Blocks sharing one (row, kv head)'s live band: a power of two, about
    one per 8 cache positions, at most MAX_BLOCKS (a function of S alone,
    never of the device-side cache_len)."""
    want = -(-S // 8)
    return min(MAX_BLOCKS, 1 << max(0, want - 1).bit_length())


def _cache_len_rows(cache_len, B: int, device) -> Tensor:
    """Scalar or (B,) valid lengths -> a contiguous (B,) int32 device
    tensor (no host round trip for a tensor already on the card)."""
    cl = torch.as_tensor(cache_len, device=device)
    if cl.dim() > 1 or (cl.dim() == 1 and cl.shape[0] != B):
        raise ValueError(f"cache_len: shape {tuple(cl.shape)}, expected () "
                         f"or ({B},)")
    return cl.to(torch.int32).reshape(-1).expand(B).contiguous()


def decode_attention_kernel(q: Tensor, k: Tensor, v: Tensor, cache_len,
                            window: Optional[int] = None) -> Tensor:
    """The CUDA kernel, one launch, on one card."""
    B, Hq, Dh = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not in "
                        f"{list(_DTYPES)}")
    if Dh not in HEAD_WIDTHS:
        raise ValueError(f"decode_attention: head width {Dh} not in "
                         f"{HEAD_WIDTHS}")
    if k.dim() != 4:
        raise ValueError(f"decode_attention: cache of shape "
                         f"{tuple(k.shape)}, expected (B, S, Hkv, Dh)")
    S, Hkv = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_REP:
        raise ValueError(f"decode_attention: Hq {Hq} over Hkv {Hkv}; the "
                         f"kernel takes rep = Hq / Hkv up to {MAX_REP}")
    rep = Hq // Hkv
    cuda.require(q, "q", q.dtype)
    for name, t in (("k", k), ("v", v)):
        cuda.require(t, name, q.dtype, (B, S, Hkv, Dh), q.device)
    cl = _cache_len_rows(cache_len, B, q.device)
    w = 0 if window is None else int(window)
    if window is not None and w <= 0:
        raise ValueError(f"decode_attention: window {window} must be >= 1")
    out = torch.empty_like(q)
    fn = cuda.function("decode_attention", "repro_decode_attention", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
            out.data_ptr(), B, S, Hkv, rep, Dh, w, _DTYPES[q.dtype],
            1.0 / math.sqrt(Dh), cluster_blocks(S), cuda.stream_ptr(q))
    cuda.check("decode_attention", rc, "decode_attention")
    cuda.count_launch("decode_attention")
    return out


def decode_attention(q: Tensor, k: Tensor, v: Tensor, cache_len,
                     window: Optional[int] = None) -> Tensor:
    """q: (B, Hq, Dh); k/v: (B, S, Hkv, Dh); cache_len: scalar or (B,)."""
    if cuda.device_of(q) == "cpu":
        return decode_attention_ref(q, k, v, cache_len, window=window)
    return decode_attention_kernel(q, k, v, cache_len, window=window)
