"""Critically-damped Langevin diffusion (Dockhorn et al. 2021; paper Eq. 10).

State u = (x, v) with a velocity channel: u has shape (B, 2, *data_shape).

    dx =  beta M^{-1} v dt
    dv = -beta x dt - Gamma beta M^{-1} v dt + sqrt(2 Gamma beta) dw

so, as channel-block coefficients,

    F = beta [[0, M^{-1}], [-1, -Gamma M^{-1}]],   G G^T = [[0,0],[0, 2 Gamma beta]].

Critical damping means Gamma^2 = 4 M; defaults Gamma=1, M^{-1}=4, beta=4,
per CLD-SGM.  Sigma_t has a closed form (Van Loan); R_t, the gDDIM choice
solving dR/dt = (F + 1/2 G G^T Sigma^{-1}) R (Eq. 17), is integrated on a
stiff-aware float64 grid (App. C.3).  All of it is host-side numpy; only
`apply` runs on the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import scipy.linalg
import torch

from .base import LinearSDE, BlockOps
from . import solve

Tensor = torch.Tensor


@dataclasses.dataclass
class CLD(LinearSDE):
    beta: float = 4.0
    M_inv: float = 4.0
    Gamma: float = 1.0
    gamma: float = 0.04          # initial velocity variance scale: v0 ~ N(0, gamma M)
    T: float = 1.0
    t_min: float = 1e-3
    grid_substeps: int = 8

    _ops = BlockOps(2)

    @property
    def ops(self):
        return self._ops

    @property
    def state_ndim_prefix(self) -> int:
        return 1

    def state_shape(self, data_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return (2,) + tuple(data_shape)

    # ---- constant-rate generator --------------------------------------------
    @functools.cached_property
    def A(self) -> np.ndarray:
        return self.beta * np.array([[0.0, self.M_inv],
                                     [-1.0, -self.Gamma * self.M_inv]], np.float64)

    def F_np(self, t):
        return self.A

    def G2_np(self, t):
        g2 = 2.0 * self.Gamma * self.beta
        return np.array([[0.0, 0.0], [0.0, g2]], np.float64)

    def Sigma0_np(self):
        return np.array([[0.0, 0.0], [0.0, self.gamma / self.M_inv]], np.float64)

    def Psi_np(self, t, s):
        return scipy.linalg.expm(self.A * (t - s))

    # ---- grid-solved Sigma_t and R_t ----------------------------------------
    @functools.cached_property
    def _grid(self) -> np.ndarray:
        return solve.make_grid(1e-6, self.T)

    def _sigma_exact(self, t: float) -> np.ndarray:
        """Closed-form Sigma_t via the Van Loan augmented exponential:
        expm(t [[A, Q], [0, -A^T]]) = [[e^{At}, e^{At} V(t)], [0, e^{-A^T t}]]
        so Sigma_t = e^{At} Sigma_0 e^{A^T t} + F12 F11^T."""
        Q = self.G2_np(0.0)
        B = np.zeros((4, 4))
        B[:2, :2] = self.A
        B[:2, 2:] = Q
        B[2:, 2:] = -self.A.T
        E = scipy.linalg.expm(B * t)
        F11, F12 = E[:2, :2], E[:2, 2:]
        return F11 @ self.Sigma0_np() @ F11.T + F12 @ F11.T

    @functools.cached_property
    def _R_grid(self) -> solve.GridFn:
        """Solve Eq. 17 outward from an anchor at t = 1e-4, started at the
        principal symmetric square root of Sigma there (Sigma^{-1} grows
        like t^{-3} toward the origin); below the anchor R is sym-sqrt
        (Sigma)."""
        G2 = self.G2_np(0.0)
        t_anchor = 1e-4
        grid = self._grid[self._grid >= t_anchor]
        grid = np.concatenate([[t_anchor], grid]) if grid[0] > t_anchor else grid
        R0 = self.ops.sqrt_psd(self.Sigma_np(float(grid[0])))

        def rhs(t, R):
            S = self._sigma_exact(float(t))
            return (self.A + 0.5 * G2 @ np.linalg.inv(S)) @ R

        return solve.solve_on_grid(rhs, R0, grid, self.grid_substeps)

    def Sigma_np(self, t):
        return self._sigma_exact(float(t))

    def R_np(self, t):
        t = float(t)
        if t < float(self._R_grid.ts[0]):
            return self.ops.sqrt_psd(self.Sigma_np(t))
        return self._R_grid(t)

    # ---- device side ---------------------------------------------------------
    def apply(self, coeff, u: Tensor) -> Tensor:
        """coeff (2, 2) against u (B, 2, *data) -> (B, 2, *data)."""
        coeff = torch.as_tensor(coeff, dtype=u.dtype, device=u.device)
        return torch.einsum("ij,bj...->bi...", coeff, u)

    def apply_batched(self, coeff, u: Tensor) -> Tensor:
        """coeff (B, 2, 2) against u (B, 2, *data)."""
        coeff = torch.as_tensor(coeff, dtype=u.dtype, device=u.device)
        return torch.einsum("bij,bj...->bi...", coeff, u)

    def augment_data(self, x: Tensor, key: Tensor | None = None) -> Tensor:
        """(B, *data) -> (B, 2, *data): v0 = 0 without a key (the training
        loss's mean lift: Sigma_t carries the v0 noise), else v0 ~ N(0,
        gamma M) drawn from `key` (HSM init)."""
        if key is None:
            v = torch.zeros_like(x)
        else:
            v_std = float(np.sqrt(self.gamma / self.M_inv))
            v = v_std * self.noise_like(key, tuple(x.shape), x.dtype)
        return torch.stack([x, v], dim=1)

    def project_data(self, u: Tensor) -> Tensor:
        return u[:, 0]
