"""Plain-torch version of the 2-D DCT kernels (BDM frequency basis).

dct2_ref / idct2_ref: orthonormal DCT-II / its inverse along the two
leading spatial axes of (B, H, W, C) images, H first, then W.

bdm_ei_update_ref: the BDM gDDIM q-step update done in frequency space
with per-frequency diagonal coefficients,

    u_next = IDCT( psi * DCT(u) + sum_j C_j * DCT(eps_j) ),

psi (H, W, 1) and C (q, H, W, 1) broadcast against the channel axis.
"""
from __future__ import annotations

import torch

from ...sde.base import dct_nd, idct_nd

Tensor = torch.Tensor


def dct2_ref(x: Tensor) -> Tensor:
    return dct_nd(x, axes=(1, 2))


def idct2_ref(x: Tensor) -> Tensor:
    return idct_nd(x, axes=(1, 2))


def bdm_ei_update_ref(u: Tensor, eps_hist: Tensor, psi: Tensor,
                      C: Tensor) -> Tensor:
    """u (B, H, W, Ch); eps_hist (q, B, H, W, Ch); psi (H, W, 1);
    C (q, H, W, 1)."""
    y = dct2_ref(u.float()) * psi
    for j in range(eps_hist.shape[0]):
        y = y + dct2_ref(eps_hist[j].float()) * C[j]
    return idct2_ref(y).to(u.dtype)
