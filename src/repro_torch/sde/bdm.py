"""Blurring diffusion model (Hoogeboom & Salimans 2022; paper Eq. 11, App. B.1).

Forward noising in DCT frequency space with per-frequency signal schedule:

    p(y_t | y_0) = N(alpha_{t,k} y_0, sigma_t^2 I),   y = V^T x  (DCT)

with  alpha_{t,k} = a_t * exp(-lam_k * tau_t)   (blur dissipation) and the
variance-preserving scalar pair (a_t, sigma_t) = (cos, sin)(pi t / 2)
(cosine schedule), tau_t = (sigma_B_max * sin^2(pi t / 2))^2 / 2, and
heat-equation eigenvalues lam_k = pi^2 (kx^2/W^2 + ky^2/H^2).

As an SDE (paper Eq. 11):

    F_t = d log alpha_t / dt        (freq-diagonal)
    G_t^2 = d sigma_t^2/dt - 2 F_t sigma_t^2        (freq-diagonal, >= 0)

Sigma_t = sigma_t^2 I is isotropic even though the drift is not, so
R_t = sigma_t I already satisfies Eq. 17 and K_t = R_t = L_t.  The gDDIM
gain on BDM is the exponential integrator over the non-isotropic
semi-linear drift (per-frequency Psi).

The schedule is host float64 numpy; `apply`, `to_freq` and `from_freq` run
the plain `dct_nd` in torch, and the serving engine's hooks
(`canonicalize` / `decanonicalize`) go through the `dct2` kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from .base import LinearSDE, FreqDiagOps, _apply_factored_canonical, \
    dct_nd, idct_nd

Tensor = torch.Tensor


@dataclasses.dataclass
class BDM(LinearSDE):
    data_shape: Tuple[int, ...] = (32, 32, 3)   # (H, W, C); see _dct2
    sigma_blur_max: float = 3.0
    min_scale: float = 0.001                    # floor on frequency scaling
    # T is clipped below 1 so alpha_T = cos(pi T/2) stays > 0 (the cosine
    # schedule reaches zero SNR at t = 1)
    T: float = 0.999
    t_min: float = 1e-3

    def __post_init__(self):
        spatial = self.data_shape[:-1] if len(self.data_shape) >= 2 \
            else self.data_shape
        self.spatial_axes_in_data = tuple(range(len(spatial)))
        self._freq_shape = tuple(spatial) + \
            (1,) * (len(self.data_shape) - len(spatial))
        self._ops = FreqDiagOps(self._freq_shape)

    @property
    def ops(self):
        return self._ops

    @functools.cached_property
    def lam(self) -> np.ndarray:
        """Heat-dissipation eigenvalues on the DCT grid, shaped `freq_shape`."""
        spatial = self._freq_shape[:len(self.spatial_axes_in_data)]
        grids = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in spatial],
                            indexing="ij")
        lam = sum((np.pi * g / n) ** 2 for g, n in zip(grids, spatial))
        return lam.reshape(self._freq_shape)

    # ---- scalar schedule pieces ----------------------------------------------
    def a(self, t):
        return np.cos(np.pi * t / 2.0)

    def sigma2(self, t):
        return np.sin(np.pi * t / 2.0) ** 2

    def dlog_a(self, t):
        return -(np.pi / 2.0) * np.tan(np.pi * t / 2.0)

    def dsigma2(self, t):
        return np.pi * np.sin(np.pi * t / 2.0) * np.cos(np.pi * t / 2.0)

    def tau(self, t):
        s = np.sin(np.pi * t / 2.0)
        return (self.sigma_blur_max * s * s) ** 2 / 2.0

    def dtau(self, t):
        s, c = np.sin(np.pi * t / 2.0), np.cos(np.pi * t / 2.0)
        return self.sigma_blur_max ** 2 * np.pi * (s ** 3) * c

    # ---- freq-diag coefficients ------------------------------------------------
    def alpha_k(self, t) -> np.ndarray:
        """Per-frequency signal coefficient alpha_{t,k} (with min-scale floor)."""
        d = np.exp(-self.lam * self.tau(t))
        d = (1.0 - self.min_scale) * d + self.min_scale
        return self.a(t) * d

    def F_np(self, t):
        # d log alpha_k/dt = dlog a - lam * dtau * d/(d + floor-correction)
        d_raw = np.exp(-self.lam * self.tau(t))
        d = (1.0 - self.min_scale) * d_raw + self.min_scale
        dd = -(1.0 - self.min_scale) * self.lam * self.dtau(t) * d_raw
        return self.dlog_a(t) + dd / d

    def G2_np(self, t):
        g2 = self.dsigma2(t) - 2.0 * self.F_np(t) * self.sigma2(t)
        return np.maximum(g2, 0.0)

    def Psi_np(self, t, s):
        return self.alpha_k(t) / self.alpha_k(s)

    def Sigma_np(self, t):
        return np.broadcast_to(np.float64(self.sigma2(t)),
                               self._freq_shape).copy()

    def R_np(self, t):
        # sigma_t I solves Eq. 17 here because Sigma_t is isotropic
        return np.sqrt(self.Sigma_np(t))

    def ancestral_coeffs(self, ts: np.ndarray):
        """Discrete ancestral-sampling coefficients (HS22's original
        sampler), per frequency, for each step t -> s of a decreasing grid:
        the DDPM-style Gaussian posterior q(y_s | y_t, y_0) of the
        frequency-space process.  Returns the stacked (coef_ut, coef_u0,
        alpha_t, sigma_t, std) arrays (host float64), one row per step."""
        outs = []
        for t, s in zip(ts[:-1], ts[1:]):
            a_t, a_s = self.alpha_k(t), self.alpha_k(s)
            s2_t, s2_s = self.sigma2(t), self.sigma2(s)
            a_ts = a_t / a_s
            s2_ts = np.maximum(s2_t - a_ts ** 2 * s2_s, 1e-20)
            denom = np.maximum(s2_t, 1e-20)
            coef_ut = a_ts * s2_s / denom
            coef_u0 = a_s * s2_ts / denom
            var = s2_ts * s2_s / denom
            # u0-prediction from eps: u0 = (u_t - sigma_t eps)/alpha_t  (per freq)
            outs.append((coef_ut, coef_u0, a_t, np.sqrt(s2_t), np.sqrt(var)))
        return [np.stack([o[i] for o in outs]) for i in range(5)]

    # ---- device side -------------------------------------------------------------
    @property
    def _axes(self) -> Tuple[int, ...]:
        return tuple(a + 1 for a in self.spatial_axes_in_data)   # skip batch

    def apply(self, coeff, u: Tensor) -> Tensor:
        """u: (B, *data_shape); coeff: freq_shape (or stacked ... x
        freq_shape)."""
        coeff = torch.as_tensor(coeff, dtype=u.dtype, device=u.device)
        return idct_nd(dct_nd(u, self._axes) * coeff, self._axes)

    def apply_batched(self, coeff, u: Tensor) -> Tensor:
        # coeff: (B, *freq_shape) broadcasts against the per-example spectrum
        return self.apply(coeff, u)

    def apply_factored(self, blk, diag, u: Tensor) -> Tensor:
        """Factored-coefficient application in the DCT frequency basis:
        `factor_coeff` gives freq-diagonal coefficients the e00 block and
        the real (D,) diagonal, so this is idct(diag * dct(u))."""
        y = self.to_freq(u)
        z = y.reshape(y.shape[0], 1, -1)
        out = _apply_factored_canonical(blk, diag, z)
        return self.from_freq(out.reshape(y.shape))

    def to_freq(self, u: Tensor) -> Tensor:
        return dct_nd(u, self._axes)

    def from_freq(self, y: Tensor) -> Tensor:
        return idct_nd(y, self._axes)

    # ---- canonical packed layout: BDM is frequency-resident -------------------
    # The (B, 1, D) canonical state holds DCT coefficients, so every bank
    # coefficient acts elementwise over D; a round pays one inverse DCT
    # (model input) and one DCT (eps) per eval.  Only these hooks go
    # through the dct2 kernel; to_freq / from_freq stay on dct_nd, as in
    # the JAX package.
    # The dct2 wrapper takes (B, H, W, Ch) images and raises for any other
    # shape, so these hooks serve image-shaped BDMs only.
    def _dct2(self, u: Tensor, inverse: bool) -> Tensor:
        # the kernel takes contiguous tensors only; a BDM slot in a pool
        # packed for CLD (K 2) reaches here as a strided view of its row
        from ..kernels.dct2.ops import dct2
        return dct2(u.contiguous(), inverse=inverse)

    # canonicalize is a DCT, not a reshape: the round kernel cannot draw
    # this family's Eq. 22 noise in canonical layout; it is streamed in
    canonical_noise_is_reshape = False

    def canonicalize(self, u: Tensor) -> Tensor:
        return self._dct2(u, inverse=False).reshape(u.shape[0], 1, -1)

    def decanonicalize(self, z: Tensor, data_shape: Tuple[int, ...]) -> Tensor:
        return self._dct2(z.reshape((z.shape[0],) + tuple(data_shape)),
                          inverse=True)
