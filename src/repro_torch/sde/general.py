"""A general anisotropic 2x2-block linear SDE: gDDIM's generality witness.

The paper claims gDDIM works for ANY du = F_t u dt + G_t dw (Sec. 4).  The
three built-in families all have special structure (scalar / critically
damped / freq-diagonal).  This SDE has none: an arbitrary constant F
(possibly non-normal, rotating) and a full-rank anisotropic G, so

  * Sigma_t is a dense 2x2 (per data dim) with no closed form,
  * L_t (Cholesky) genuinely differs from R_t (Eq. 17),
  * Psi = expm(F t) mixes channels.

Stage I is host float64 numpy, the JAX package's own code; the state is
(B, 2, *data) as for CLD, coefficients act through `BlockOps(2)`, so the
sampler's path A update is `ei_update` at k = 2.
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
class GeneralSDE(LinearSDE):
    """du = F u dt + G dw with arbitrary constant 2x2 F, G."""
    F: Tuple[Tuple[float, float], Tuple[float, float]] = ((-0.5, 1.2), (-1.2, -0.5))
    G: Tuple[Tuple[float, float], Tuple[float, float]] = ((0.8, 0.0), (0.3, 1.1))
    T: float = 1.0
    t_min: float = 1e-3
    grid_substeps: int = 8

    _ops = BlockOps(2)

    def __post_init__(self):
        self._F = np.asarray(self.F, np.float64)
        self._G = np.asarray(self.G, np.float64)

    @property
    def ops(self):
        return self._ops

    @property
    def state_ndim_prefix(self) -> int:
        return 1

    def state_shape(self, data_shape):
        return (2,) + tuple(data_shape)

    def F_np(self, t):
        return self._F

    def G2_np(self, t):
        return self._G @ self._G.T

    def Psi_np(self, t, s):
        return scipy.linalg.expm(self._F * (t - s))

    def Sigma0_np(self):
        return np.zeros((2, 2))

    def _sigma_exact(self, t: float) -> np.ndarray:
        # Van Loan augmented exponential (as in cld.py)
        Q = self.G2_np(0.0)
        B = np.zeros((4, 4))
        B[:2, :2] = self._F
        B[:2, 2:] = Q
        B[2:, 2:] = -self._F.T
        E = scipy.linalg.expm(B * t)
        return E[:2, 2:] @ E[:2, :2].T

    def Sigma_np(self, t):
        return self._sigma_exact(float(t))

    @functools.cached_property
    def _R_grid(self) -> solve.GridFn:
        grid = solve.make_grid(1e-6, self.T)
        t0 = 1e-4
        grid = grid[grid >= t0]
        grid = np.concatenate([[t0], grid]) if grid[0] > t0 else grid
        R0 = self.ops.sqrt_psd(self.Sigma_np(float(grid[0])))
        G2 = self.G2_np(0.0)

        def rhs(t, R):
            S = self._sigma_exact(float(t))
            return (self._F + 0.5 * G2 @ np.linalg.inv(S)) @ R

        return solve.solve_on_grid(rhs, R0, grid, self.grid_substeps)

    def R_np(self, t):
        t = float(t)
        if t < float(self._R_grid.ts[0]):
            return self.ops.sqrt_psd(self.Sigma_np(t))
        return self._R_grid(t)

    # ---- device side ---------------------------------------------------------
    def apply(self, coeff, u: Tensor) -> Tensor:
        coeff = torch.as_tensor(coeff, dtype=u.dtype, device=u.device)
        return torch.einsum("ij,bj...->bi...", coeff, u)

    def apply_batched(self, coeff, u: Tensor) -> Tensor:
        coeff = torch.as_tensor(coeff, dtype=u.dtype, device=u.device)
        return torch.einsum("bij,bj...->bi...", coeff, u)

    def augment_data(self, x: Tensor, key=None) -> Tensor:
        return torch.stack([x, torch.zeros_like(x)], dim=1)

    def project_data(self, u: Tensor) -> Tensor:
        return u[:, 0]
