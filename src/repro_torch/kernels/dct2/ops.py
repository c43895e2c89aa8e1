"""Dispatch for the 2-D DCT and the fused BDM EI update.

Both dispatch on the tensor's device: a CPU tensor runs the plain version
(`ref.py`), a CUDA tensor the hand-written kernel of `csrc/dct2.cu`, one
launch each, or raises.  The kernels take f32 channels-last (B, H, W, Ch)
tiles with H, W <= 64.  The dct2 kernel computes A X B^T, one block per
(b, channel, band of output rows); the wrapper hands it the direction's
matrices (C_h, C_w^T forward; C_h^T, C_w inverse).  The bdm_ei_update
kernel runs a thread-block cluster of `cluster_blocks(tiles, H)` blocks
per (b, channel) tile, each on a band of output rows, and takes all four
matrices.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import cuda
from ...sde.base import dct_matrix
from .ref import bdm_ei_update_ref, dct2_ref, idct2_ref

Tensor = torch.Tensor

MAX_SIDE = 64
_VP, _I = ctypes.c_void_p, ctypes.c_int
# x y a bt | B H W Ch | stream
_DCT2_ARGS = [_VP] * 4 + [_I] * 4 + [_VP]
# u eps psi C out ch cht cw cwt | B H W Ch q R | stream
_BDM_ARGS = [_VP] * 9 + [_I] * 6 + [_VP]
MAX_CLUSTER = 8                 # bdm_ei_update: blocks per tile


@functools.lru_cache(maxsize=None)
def dct_matrix_f32(n: int, device: torch.device,
                   transpose: bool = False) -> Tensor:
    """The orthonormal DCT-II matrix (or its transpose) as a contiguous f32
    device buffer, cached per (n, device, transpose): the host float64
    matrix cast once, the values the plain version multiplies by."""
    c = dct_matrix(n)
    return torch.as_tensor(c.T if transpose else c, dtype=torch.float32,
                           device=device).contiguous()


def _check_rank(x: Tensor, name: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, W, Ch), got "
                         f"{tuple(x.shape)}")


def _check_image(x: Tensor, name: str) -> Tuple[int, ...]:
    _check_rank(x, name)
    cuda.require(x, name, torch.float32)
    B, H, W, Ch = x.shape
    if not (1 <= H <= MAX_SIDE and 1 <= W <= MAX_SIDE):
        raise ValueError(f"{name}: H, W = {H}, {W}; the kernel takes "
                         f"sides up to {MAX_SIDE}")
    return B, H, W, Ch


def dct2_kernel(x: Tensor, inverse: bool = False) -> Tensor:
    """One launch of the dct2 kernel on a CUDA (B, H, W, Ch) f32 tensor."""
    B, H, W, Ch = _check_image(x, "x")
    y = torch.empty_like(x)
    fn = cuda.function("dct2", "repro_dct2", _DCT2_ARGS)
    a = dct_matrix_f32(H, x.device, transpose=inverse)
    bt = dct_matrix_f32(W, x.device, transpose=not inverse)
    rc = fn(x.data_ptr(), y.data_ptr(), a.data_ptr(), bt.data_ptr(), B, H, W,
            Ch, cuda.stream_ptr(x))
    cuda.check("dct2", rc, "dct2")
    cuda.count_launch("dct2")
    return y


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def cluster_blocks(tiles: int, H: int, sms: int) -> int:
    """Blocks per (b, channel) tile of the bdm_ei_update kernel: a power
    of two, at most MAX_CLUSTER and at most H, the least that gives each of
    `sms` SMs a block (a function of the tile count, H and the card alone):
    on an H100's 132, 8 at the engine's 12 tiles and 1 at path A's 192."""
    want = -(-sms // tiles)
    R = min(MAX_CLUSTER, 1 << max(0, want - 1).bit_length())
    while R > H:
        R //= 2
    return R


def _launch_bdm(u: Tensor, eps_hist: Tensor, psi: Tensor, C: Tensor,
                out: Tensor, blocks: int) -> None:
    """The bdm_ei_update kernel at `blocks` per tile, on checked arguments,
    without a launch count."""
    B, H, W, Ch = u.shape
    dev = u.device
    fn = cuda.function("dct2", "repro_bdm_ei_update", _BDM_ARGS)
    rc = fn(u.data_ptr(), eps_hist.data_ptr(), psi.data_ptr(), C.data_ptr(),
            out.data_ptr(), dct_matrix_f32(H, dev).data_ptr(),
            dct_matrix_f32(H, dev, transpose=True).data_ptr(),
            dct_matrix_f32(W, dev).data_ptr(),
            dct_matrix_f32(W, dev, transpose=True).data_ptr(), B, H, W, Ch,
            eps_hist.shape[0], blocks, cuda.stream_ptr(u))
    cuda.check("dct2", rc, f"bdm_ei_update ({blocks} blocks per tile)")


def bdm_ei_update_kernel(u: Tensor, eps_hist: Tensor, psi: Tensor,
                         C: Tensor) -> Tensor:
    """One launch of the fused BDM update kernel: u (B, H, W, Ch),
    eps_hist (q, B, H, W, Ch), psi (H, W, 1), C (q, H, W, 1), all f32."""
    B, H, W, Ch = _check_image(u, "u")
    q = eps_hist.shape[0]
    dev = u.device
    cuda.require(eps_hist, "eps_hist", torch.float32, (q, B, H, W, Ch), dev)
    cuda.require(psi, "psi", torch.float32, (H, W, 1), dev)
    cuda.require(C, "C", torch.float32, (q, H, W, 1), dev)
    out = torch.empty_like(u)
    _launch_bdm(u, eps_hist, psi, C, out,
                cluster_blocks(B * Ch, H, sm_count(dev)))
    cuda.count_launch("bdm_ei_update")
    return out


def dct2(x: Tensor, inverse: bool = False) -> Tensor:
    """Orthonormal 2-D DCT-II (or its inverse) of (B, H, W, Ch) images;
    any other rank raises, on either device."""
    _check_rank(x, "x")
    if cuda.device_of(x) == "cpu":
        return idct2_ref(x) if inverse else dct2_ref(x)
    return dct2_kernel(x, inverse=inverse)


def bdm_ei_update(u: Tensor, eps_hist: Tensor, psi: Tensor,
                  C: Tensor) -> Tensor:
    """IDCT(psi * DCT(u) + sum_j C_j * DCT(eps_j)) per (b, channel) tile."""
    _check_rank(u, "u")
    if cuda.device_of(u) == "cpu":
        return bdm_ei_update_ref(u, eps_hist, psi, C)
    return bdm_ei_update_kernel(u, eps_hist, psi, C)
