r"""VPSDE / continuous-time DDPM (paper Eq. 8).

    F_t = 1/2 dlog(alpha_t)/dt * I,   G_t = sqrt(-dlog(alpha_t)/dt) * I

with alpha_t = exp(-\int_0^t beta(s) ds) the *squared* signal coefficient
(paper's alpha_t == DDPM's alpha-bar).  Linear beta schedule beta(t) =
beta_0 + t (beta_1 - beta_0) (Song et al. 2020b defaults 0.1 -> 20).

Everything is closed form, host float64 numpy; only `apply` and
`apply_batched` run on the device.  On VPSDE gDDIM *is* DDIM (paper
Thm 1); `ddim_step_reference` is DDIM's own update, the oracle of that
statement.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import LinearSDE, ScalarOps

Tensor = torch.Tensor


@dataclasses.dataclass
class VPSDE(LinearSDE):
    beta0: float = 0.1
    beta1: float = 20.0
    T: float = 1.0
    t_min: float = 1e-3

    _ops = ScalarOps()

    @property
    def ops(self):
        return self._ops

    # ---- schedule -----------------------------------------------------------
    def log_alpha(self, t):
        # \int_0^t beta = beta0 t + (beta1-beta0) t^2/2
        return -(self.beta0 * t + 0.5 * (self.beta1 - self.beta0) * t * t)

    def alpha(self, t):
        return np.exp(self.log_alpha(t))

    def beta(self, t):
        return self.beta0 + (self.beta1 - self.beta0) * t

    # ---- coefficients (scalar family) ---------------------------------------
    def F_np(self, t):
        return np.float64(-0.5 * self.beta(t))

    def G2_np(self, t):
        return np.float64(self.beta(t))

    def Psi_np(self, t, s):
        return np.sqrt(self.alpha(t) / self.alpha(s))

    def Sigma_np(self, t):
        return np.float64(1.0 - self.alpha(t))

    def R_np(self, t):
        # K_t = sqrt(1 - alpha_t): the unique solution of Eq. 17 from Sigma_0=0.
        return np.sqrt(1.0 - self.alpha(t))

    def L_np(self, t):
        return self.R_np(t)  # isotropic => R == L == sqrt(Sigma)

    def Psi_hat_np(self, t, s, lam: float):
        """Closed-form lambda-family transition (paper Eq. 61)."""
        at, as_ = self.alpha(t), self.alpha(s)
        return ((1.0 - at) / (1.0 - as_)) ** (0.5 * (1.0 + lam * lam)) * \
               (as_ / at) ** (0.5 * lam * lam)

    def P_np(self, s, t, lam: float):
        """Closed-form injected variance (paper Thm 1 covariance)."""
        at, as_ = self.alpha(t), self.alpha(s)
        return (1.0 - at) * (1.0 - ((1.0 - at) / (1.0 - as_)) ** (lam * lam) *
                             (as_ / at) ** (lam * lam))

    # ---- device side ---------------------------------------------------------
    def apply(self, coeff, u: Tensor) -> Tensor:
        coeff = torch.as_tensor(coeff, dtype=u.dtype, device=u.device)
        return coeff * u

    def apply_batched(self, coeff, u: Tensor) -> Tensor:
        c = torch.as_tensor(coeff, dtype=u.dtype, device=u.device)
        return c.reshape((-1,) + (1,) * (u.dim() - 1)) * u

    def state_shape(self, data_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return data_shape

    def ddim_step_reference(self, u, eps, t, t_prev, sigma=0.0):
        """Song et al. (2020a) DDIM update, Eq. 9 — the oracle for Thm 1."""
        a_t, a_p = self.alpha(t), self.alpha(t_prev)
        c1 = np.sqrt(a_p / a_t)
        c2 = np.sqrt(max(1.0 - a_p - sigma**2, 0.0)) - np.sqrt(1.0 - a_t) * c1
        return c1 * u + c2 * eps
