"""Attention dispatch: a CPU tensor runs the plain version, a CUDA tensor
one of the two forms of the hand-written flash kernel
(`csrc/attention.cu`), each launch counted as `flash_attention` (a
causal one also as `flash_attention:window` or `flash_attention:global`,
a non-causal general one also as `flash_attention:cross`, an f32 one
of either form also as `flash_attention:f32`):

  * the DiT form — non-causal, no window, Hq == Hkv, Sq == Sk, q_offset 0,
    head width 32, 64 or 128 (the DiT; whisper's encoder);
  * the general form — causal (LM prefill) or not (cross-attention: the
    encoder-decoder's decoder queries over the encoder memory), an
    optional window, GQA (Hkv dividing Hq), Sq != Sk, q_offset an int or
    a device scalar, head width 16, 32, 64, 80, 128 or 256.  A
    non-causal call outside the DiT form runs it.

Both take bf16, which runs on the tensor cores (`flash_dit_wgmma_kernel`
and `flash_lm_wgmma_kernel` at head width 64, 128 or 256;
`flash_dit_mma_kernel` and `flash_lm_mma_kernel`, mma.sync, at 16 or 32,
and `flash_lm_mma_kernel` at 80: zamba2-2.7b's shared block, never padded
to 128),
and f32, which runs on the CUDA cores (`flash_fwd_kernel`,
`flash_lm_kernel`).  q, k and v of different dtypes are promoted to a
common one and the output cast back to q's, as the plain version (and the
JAX reference) computes them in f32 and returns q's dtype: the encoder-
decoder's decode step attends bf16 queries over the f32 memory pool's
keys, which runs the f32 kernel.  A CUDA call outside these forms raises:
it is never sent to the plain version.

Gradients: where grad mode is on and q, k or v requires a gradient, the
forms that train run as the autograd Function `FlashAttention`, whose
forward is the form's kernel (the plain version on a CPU tensor) and
whose backward is the plain `attention_bwd_ref` from the saved q, k, v,
on either device (the JAX package's Pallas kernel has no backward to
port): the non-causal form without a window at q_offset 0 (the DiT, and
the encoder-decoder's self- and cross-attention: any Sq and Sk, GQA),
and the causal form at q_offset 0 and Sq == Sk (LM training; an
optional window, GQA), q, k and v of one dtype.  With grad off the path
is the forward alone.  A CUDA call that needs a gradient in any other
form raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from .. import cuda
from .ref import attention_bwd_ref, attention_ref

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_WIDTHS = (32, 64, 128)
LM_HEAD_WIDTHS = (16, 32, 64, 80, 128, 256)
# the causal form's launches are also counted by instance: with a window
# (the band skip) or without
WINDOW_COUNT, GLOBAL_COUNT = ("flash_attention:window",
                              "flash_attention:global")
# and every f32 launch (the CUDA-core kernels: a DiT whose config is bf16
# runs the DiT form's under the int8 precision class, models/quantize.py;
# the encoder-decoder's decode step the general form's over the f32 memory
# pool)
F32_COUNT = "flash_attention:f32"
# the general form's non-causal launches (cross-attention)
CROSS_COUNT = "flash_attention:cross"
_VP, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, B, S, H, Dh, dtype, scale, stream
_ARGTYPES = [_VP] * 4 + [_I] * 5 + [ctypes.c_float, _VP]
# q k v o q_off_ptr | q_off B Sq Sk Hq Hkv Dh window causal dtype | scale
# stream
_LM_ARGTYPES = [_VP] * 5 + [_I] * 10 + [ctypes.c_float, _VP]


def _check_dtype(q: Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{list(_DTYPES)}")


def flash_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """The CUDA kernel, DiT form: q/k/v (B, S, H, Dh) on one card, same
    dtype -> (B, S, H, Dh) in that dtype."""
    B, S, H, Dh = q.shape
    _check_dtype(q)
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
    if q.dtype == torch.float32:
        cuda.count_launch(F32_COUNT)
    return out


def flash_attention_causal(q: Tensor, k: Tensor, v: Tensor, *,
                           window: Optional[int] = None,
                           q_offset: Union[int, Tensor] = 0) -> Tensor:
    """The CUDA kernel, general form, causal (LM prefill): q (B, Sq, Hq,
    Dh) over k/v (B, Sk, Hkv, Dh), query i at absolute position q_offset +
    i, keys in (q_pos - window, q_pos] when a window is given."""
    return _flash_general(q, k, v, True, window, q_offset)


def flash_attention_cross(q: Tensor, k: Tensor, v: Tensor, *,
                          window: Optional[int] = None,
                          q_offset: Union[int, Tensor] = 0) -> Tensor:
    """The CUDA kernel, general form, non-causal (cross-attention): q (B,
    Sq, Hq, Dh) over every key of k/v (B, Sk, Hkv, Dh), or those with
    k_pos > q_offset + i - window when a window is given."""
    return _flash_general(q, k, v, False, window, q_offset)


def _flash_general(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                   window: Optional[int],
                   q_offset: Union[int, Tensor]) -> Tensor:
    B, Sq, Hq, Dh = q.shape
    _check_dtype(q)
    if Dh not in LM_HEAD_WIDTHS:
        raise ValueError(f"flash_attention: head width {Dh} not in "
                         f"{LM_HEAD_WIDTHS} (general form)")
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: k of shape {tuple(k.shape)} "
                         f"for q of shape {tuple(q.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hkv {Hkv} does not divide Hq "
                         f"{Hq}")
    cuda.require(q, "q", q.dtype)
    for name, t in (("k", k), ("v", v)):
        cuda.require(t, name, q.dtype, (B, Sk, Hkv, Dh), q.device)
    w = 0 if window is None else int(window)
    if window is not None and w <= 0:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    q_off_ptr, q_off = 0, 0
    if torch.is_tensor(q_offset):
        if q_offset.numel() != 1:
            raise ValueError("flash_attention: q_offset must be a scalar")
        q_off_t = q_offset.to(device=q.device, dtype=torch.int32).reshape(1)
        q_off_ptr = q_off_t.data_ptr()
    else:
        q_off = int(q_offset)
    fn = cuda.function("attention", "repro_flash_attention_lm", _LM_ARGTYPES)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_off_ptr, q_off, B, Sq, Sk, Hq, Hkv, Dh, w, int(causal),
            _DTYPES[q.dtype], 1.0 / math.sqrt(Dh), cuda.stream_ptr(q))
    cuda.check("attention", rc, "flash_attention (causal)" if causal
               else "flash_attention (cross)")
    cuda.count_launch("flash_attention")
    if causal:
        cuda.count_launch(WINDOW_COUNT if w else GLOBAL_COUNT)
    else:
        cuda.count_launch(CROSS_COUNT)
    if q.dtype == torch.float32:
        cuda.count_launch(F32_COUNT)
    return out


class FlashAttention(torch.autograd.Function):
    """The forms that train, with a gradient: non-causal without a window
    (the DiT; the encoder-decoder's self- and cross-attention, any Sq and
    Sk, GQA) or causal at Sq == Sk with an optional window and GQA (LM
    training), q_offset 0.  The forward is the kernel of that form
    (`_forward`: counted as `flash_attention`; `attention_ref` for a CPU
    tensor), the backward the plain `attention_bwd_ref`, recomputed from
    the saved q, k, v."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                window: Optional[int]) -> Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window, 0)

    @staticmethod
    def backward(ctx, do: Tensor):
        return (*attention_bwd_ref(*ctx.saved_tensors, do, causal=ctx.causal,
                                   window=ctx.window), None, None)


def _dit_form(q: Tensor, k: Tensor, v: Tensor, causal: bool, window,
              q_offset) -> bool:
    return (not causal and window is None
            and isinstance(q_offset, int) and q_offset == 0
            and q.shape == k.shape and k.shape == v.shape
            and q.shape[-1] in _HEAD_WIDTHS)


def _train_form(q: Tensor, k: Tensor, v: Tensor, causal: bool, window,
                q_offset) -> bool:
    """A form `FlashAttention` takes: q_offset 0, one dtype, GQA shapes;
    non-causal without a window (any Sq, Sk), or causal at Sq == Sk."""
    return (isinstance(q_offset, int) and q_offset == 0
            and q.dtype == k.dtype == v.dtype
            and k.shape == v.shape and k.dim() == q.dim() == 4
            and q.shape[0] == k.shape[0] and q.shape[3] == k.shape[3]
            and q.shape[2] % k.shape[2] == 0
            and (q.shape[1] == k.shape[1] if causal else window is None))


def _forward(q: Tensor, k: Tensor, v: Tensor, causal: bool, window,
             q_offset) -> Tensor:
    """The forward of one call, q, k, v of one dtype: the plain version on
    a CPU tensor, else the kernel of its form."""
    if cuda.device_of(q) == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if causal:
        return flash_attention_causal(q, k, v, window=window,
                                      q_offset=q_offset)
    if _dit_form(q, k, v, causal, window, q_offset):
        return flash_attention(q, k, v)
    return flash_attention_cross(q, k, v, window=window, q_offset=q_offset)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              q_offset: Union[int, Tensor] = 0) -> Tensor:
    """Multi-head attention, q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh)."""
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if needs_grad and _train_form(q, k, v, causal, window, q_offset):
        return FlashAttention.apply(q, k, v, causal, window)
    if cuda.device_of(q) == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if needs_grad:
        raise NotImplementedError(
            "flash_attention has a gradient at q_offset 0 with q, k, v of "
            "one dtype, non-causal without a window or causal at Sq == Sk; "
            "not in this form")
    if not q.dtype == k.dtype == v.dtype:
        # as the plain version: computed in the promoted dtype, returned
        # in q's
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        return _forward(q.to(dt), k.to(dt), v.to(dt), causal, window,
                        q_offset).to(q.dtype)
    return _forward(q, k, v, causal, window, q_offset)
