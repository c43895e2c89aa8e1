"""DSM / HSM training losses with the gDDIM score parameterization, and
the sampler glue that turns an eps-model into eps_fn(u, i).

Paper Eq. 5 (DSM, eps-parameterization) and Eq. 77 (HSM for CLD with
K_t = R_t).  The weight is the paper's: R_t^{-1} Lambda_t R_t^{-T} = I,
a plain MSE on the predicted noise, with both channels of eps supervised
for CLD (Eq. 80), unlike Dockhorn et al.'s L_t-parameterization, which
trains the velocity channel only (Eq. 79).

Time-dependent coefficients (Psi(t, 0), K_t) are computed on the host in
float64 over a dense table, cast to f32 (bitwise the JAX package's
tables) and gathered per example on the device: the device never solves
ODEs (the Stage-I / Stage-II split, paper App. C.3/C.4).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import random as prng
from ..sde.base import LinearSDE

Tensor = torch.Tensor


class PerturbTables(NamedTuple):
    """Dense coefficient tables over a uniform t-grid in [t_min, T]."""
    ts: Tensor         # (n_table,)
    psi: Tensor        # (n_table, *coeff)   Psi(t, 0)
    K: Tensor          # (n_table, *coeff)   chosen K_t (R/L/sqrt)
    K_invT: Tensor     # (n_table, *coeff)   K_t^{-T} = Sigma^{-1} K
    lam_w: Tensor      # (n_table, *coeff)   loss weight factor (identity)

    def to(self, device) -> "PerturbTables":
        return PerturbTables(*(t.to(device) for t in self))


def K_invT_np(sde: LinearSDE, K: np.ndarray, t: float) -> np.ndarray:
    """K_t^{-T} = Sigma_t^{-1} K_t (Sigma = K K^T), host float64."""
    ops = sde.ops
    return np.asarray(ops.mul(ops.inv(sde.Sigma_np(t)), K), np.float64)


def build_perturb_tables(sde: LinearSDE, kt: str = "R",
                         n_table: int = 1024) -> PerturbTables:
    """The tables on the host (CPU tensors), float64 cast once to f32."""
    from ..core.coeffs import _K_fn
    ops = sde.ops
    K_fn = _K_fn(sde, kt)
    ts = np.linspace(sde.t_min, sde.T, n_table)
    psi, K, KiT = [], [], []
    for t in ts:
        t = float(t)
        psi.append(np.asarray(sde.Psi_np(t, 0.0), np.float64))
        Kt = np.asarray(K_fn(t), np.float64)
        K.append(Kt)
        KiT.append(K_invT_np(sde, Kt, t))
    f32 = lambda x: torch.from_numpy(np.stack(x).astype(np.float32))
    eye = np.broadcast_to(np.asarray(ops.eye()), np.stack(K).shape)
    return PerturbTables(torch.from_numpy(ts.astype(np.float32)), f32(psi),
                         f32(K), f32(KiT),
                         torch.from_numpy(eye.astype(np.float32)))


def table_index(tables: PerturbTables, t: Tensor) -> Tensor:
    """Nearest table row of each time (round half to even, clipped)."""
    ts = tables.ts
    frac = (t - ts[0]) / (ts[-1] - ts[0])
    idx = torch.round(frac * (ts.shape[0] - 1)).to(torch.int32)
    return torch.clamp(idx, 0, ts.shape[0] - 1)


def dsm_loss(
    sde: LinearSDE,
    tables: PerturbTables,
    eps_model: Callable[[Tensor, Tensor], Tensor],
    x0: Tensor,
    key: Tensor,
) -> Tensor:
    """E_t E_eps || eps - eps_theta(Psi_t u0 + K_t eps, t) ||^2 (Eq. 5/77).

    `tables` on x0's device; `key` a `random.PRNGKey` split as the JAX loss
    splits it: (t, aug, eps), t ~ U[t_min, T) per example, eps the state's
    normal draw.  `eps_model(u, t)` takes the state and the continuous
    time.  For CLD the data is lifted with v0 = 0: the v0 noise is carried
    by Sigma_t (Sigma_0 = diag(0, gamma M), see cld.py)."""
    k_t, _k_aug, k_eps = prng.split(key.to(x0.device), 3)
    B = x0.shape[0]
    t = prng.uniform(k_t, (B,), minval=sde.t_min, maxval=sde.T)
    u0 = sde.augment_data(x0, None)
    idx = table_index(tables, t).long()
    psi = tables.psi[idx]
    K = tables.K[idx]
    eps = sde.noise_like(k_eps, tuple(u0.shape), u0.dtype)
    u_t = sde.apply_batched(psi, u0) + sde.apply_batched(K, eps)
    pred = eps_model(u_t, t)
    return torch.mean(torch.square(pred - eps))


def score_fn_from_model(sde: LinearSDE,
                        model: Callable[[Tensor, Tensor], Tensor],
                        kt: str = "R") -> Callable[[Tensor, float], Tensor]:
    """score(u, t) = -K_t^{-T} eps_theta(u, t) (paper Eq. 4 inverted),
    K_t^{-T} formed as `build_perturb_tables` forms it (host float64, cast
    to f32) at the python float t: the score the likelihood integrates."""
    from ..core.coeffs import _K_fn
    K_fn = _K_fn(sde, kt)

    def score(u: Tensor, t: float) -> Tensor:
        t = float(t)
        KiT = torch.as_tensor(
            K_invT_np(sde, np.asarray(K_fn(t), np.float64), t)
            .astype(np.float32), device=u.device).to(u.dtype)
        tt = torch.full((u.shape[0],), t, dtype=u.dtype, device=u.device)
        return -sde.apply(KiT, model(u, tt))

    return score


def make_eps_fn_from_model(
    sde: LinearSDE,
    model: Callable[[Tensor, Tensor], Tensor],
    ts_grid: np.ndarray,
):
    """Adapt an eps-model to the sampler contract eps_fn(u, i): the model
    evaluated at the f32 grid time ts[i], broadcast over the batch on u's
    device."""
    ts32 = np.asarray(ts_grid, np.float32)

    def eps_fn(u: Tensor, i: int) -> Tensor:
        t = torch.full((u.shape[0],), float(ts32[int(i)]), dtype=u.dtype,
                       device=u.device)
        return model(u, t)

    return eps_fn
