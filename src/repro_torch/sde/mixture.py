"""Exact scores for Gaussian-mixture data under any structured linear SDE.

A Gaussian mixture stays a Gaussian mixture under a linear SDE, so the
score is closed form for all three families (VPSDE / CLD / BDM):

    p_t(u) = sum_m w_m N(u; Psi(t,0) mu~_m, C_m(t)),
    C_m(t) = Psi(t,0) S0_m Psi(t,0)^T + Sigma_t,
    score  = sum_m gamma_m(u) * (-C_m(t)^{-1} (u - Psi mu~_m)),

with S0_m the per-mode data covariance (s_m^2 on the data channels) and
Sigma_t the SDE marginal covariance (which for CLD already includes the
gamma*M velocity initialization).  This is the exact-score oracle of the
sampler tests: sampling quality measured with no trained weights.

Time-dependent constants are host float64 numpy, computed per sampling
grid and shipped to the caller's device as stacked f32 tables (the paper's
Stage-I / Stage-II split); `score_np` stays host float64 throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from .. import random as prng
from .base import LinearSDE, dct_axes_np, sde_apply_np_freq

Tensor = torch.Tensor


def _quad_form(sde: LinearSDE, cinv: Tensor, delta: Tensor) -> Tensor:
    """delta^T C^{-1} delta, batched over axis 0."""
    fam = sde.ops.family
    axes = tuple(range(1, delta.dim()))
    if fam == "scalar":
        return cinv * torch.sum(delta * delta, dim=axes)
    if fam == "block":
        tmp = torch.einsum("ij,bj...->bi...", cinv, delta)
        return torch.sum(delta * tmp, dim=axes)
    if fam == "freqdiag":
        dh = sde.to_freq(delta)
        return torch.sum(dh * dh * cinv, dim=axes)
    raise ValueError(fam)


def _apply_sym(sde: LinearSDE, coeff: Tensor, delta: Tensor) -> Tensor:
    """Apply a symmetric family coeff (e.g. C^{-1}) to a batched state."""
    if sde.ops.family == "freqdiag":
        return sde.from_freq(sde.to_freq(delta) * coeff)
    return sde.apply(coeff, delta)


def _logdet(sde: LinearSDE, C, data_shape) -> float:
    fam = sde.ops.family
    D = int(np.prod(data_shape))
    if fam == "scalar":
        return D * float(np.log(C))
    if fam == "block":
        return D * float(np.log(np.linalg.det(C)))
    if fam == "freqdiag":
        full = np.broadcast_to(C, data_shape)
        return float(np.sum(np.log(full)))
    raise ValueError(fam)


@dataclasses.dataclass
class GaussianMixture:
    """Mixture of isotropic Gaussians in data space."""

    means: np.ndarray          # (M, *data_shape)
    stds: np.ndarray           # (M,)
    weights: np.ndarray        # (M,)

    def __post_init__(self):
        self.means = np.asarray(self.means, np.float64)
        self.stds = np.asarray(self.stds, np.float64)
        self.weights = np.asarray(self.weights, np.float64)
        self.weights = self.weights / self.weights.sum()

    @property
    def data_shape(self):
        return self.means.shape[1:]

    def sample(self, key: Tensor, n: int,
               dtype: torch.dtype = torch.float32) -> Tensor:
        """n draws on the key's device, as the JAX package draws them:
        the mode by `jax.random.choice` with probabilities `weights` (f32
        cumulative sum, inverse-CDF search), then mean + std * normal."""
        km, kn = prng.split(key)
        p_cuml = torch.cumsum(torch.as_tensor(
            self.weights, dtype=torch.float32, device=key.device), dim=0)
        r = p_cuml[-1] * (1.0 - prng.uniform(km, (n,)))
        idx = torch.searchsorted(p_cuml, r).clamp_max(len(self.weights) - 1)
        mu = torch.as_tensor(self.means, dtype=dtype, device=key.device)[idx]
        sd = torch.as_tensor(self.stds, dtype=dtype, device=key.device)[idx]
        sd = sd.reshape((n,) + (1,) * len(self.data_shape))
        return mu + sd * prng.normal(kn, tuple(mu.shape), dtype)


class ExactScore:
    """Exact score / epsilon oracle for GaussianMixture data under `sde`."""

    def __init__(self, sde: LinearSDE, mixture: GaussianMixture):
        self.sde = sde
        self.mix = mixture
        self.data_shape = mixture.data_shape

    # ---- host-side per-time constants ---------------------------------------
    def _mode_constants(self, t: float):
        """Per-mode (mean_state, C_inv, logdet, logw) at time t (numpy)."""
        sde, ops = self.sde, self.sde.ops
        psi = sde.Psi_np(t, 0.0)
        sig = sde.Sigma_np(t)
        out = []
        for m in range(len(self.mix.weights)):
            s2 = float(self.mix.stds[m]) ** 2
            if ops.family == "scalar":
                S0 = np.float64(s2)
            elif ops.family == "block":
                S0 = np.array([[s2, 0.0], [0.0, 0.0]])  # data channel only
            else:  # freqdiag (orthonormal DCT preserves isotropy)
                S0 = s2 * ops.eye()
            C = ops.mul(ops.mul(psi, S0), ops.transpose(psi)) + sig
            Cinv = ops.inv(C)
            # state-space mean: lift data mean, push through Psi (host numpy)
            mu = self._augment_np(self.mix.means[m][None])  # (1, *state)
            mu_state = self._apply_np(psi, mu)[0]
            logdet = _logdet(self.sde, C, self._state_data_shape())
            out.append((mu_state, Cinv, logdet,
                        float(np.log(self.mix.weights[m]))))
        return psi, out

    @property
    def _freq_axes(self):
        return tuple(a + 1 for a in self.sde.spatial_axes_in_data)

    def _apply_np(self, coeff, u: np.ndarray) -> np.ndarray:
        """Host-side float64 twin of sde.apply."""
        fam = self.sde.ops.family
        if fam == "scalar":
            return coeff * u
        if fam == "block":
            return np.einsum("ij,bj...->bi...", coeff, u)
        return sde_apply_np_freq(self.sde, coeff, u)

    def _augment_np(self, x: np.ndarray) -> np.ndarray:
        if self.sde.state_ndim_prefix == 1:
            return np.stack([x, np.zeros_like(x)], axis=1)
        return x

    def _state_data_shape(self):
        return self.sde.state_shape(self.data_shape)

    # ---- host-side float64 score (RK45 baselines, oracle checks) -----------
    def score_np(self, u: np.ndarray, t: float) -> np.ndarray:
        """Exact grad log p_t(u) in float64 numpy (batched over axis 0)."""
        _, consts = self._mode_constants(float(t))
        u = np.asarray(u, np.float64)
        fam = self.sde.ops.family
        logps, deltas = [], []
        for mu, Cinv, logdet, logw in consts:
            delta = u - mu[None]
            if fam == "scalar":
                qf = Cinv * np.sum(delta * delta,
                                   axis=tuple(range(1, delta.ndim)))
            elif fam == "block":
                tmp = np.einsum("ij,bj...->bi...", Cinv, delta)
                qf = np.sum(delta * tmp, axis=tuple(range(1, delta.ndim)))
            else:
                dh = dct_axes_np(delta, self._freq_axes, False)
                qf = np.sum(dh * dh * Cinv, axis=tuple(range(1, delta.ndim)))
            logps.append(logw - 0.5 * qf - 0.5 * logdet)
            deltas.append(delta)
        logp = np.stack(logps)
        gam = np.exp(logp - logp.max(0, keepdims=True))
        gam = gam / gam.sum(0, keepdims=True)
        out = np.zeros_like(u)
        for m, (mu, Cinv, _, _) in enumerate(consts):
            g = gam[m].reshape((-1,) + (1,) * (u.ndim - 1))
            out = out - g * self._apply_np(Cinv, deltas[m])
        return out

    # ---- device-side score -------------------------------------------------
    def _score_dev(self, u: Tensor, mus, cinvs, logdets, logws) -> Tensor:
        """The mixture score from one time's per-mode tables (on u's
        device): softmax responsibilities over the modes' log densities."""
        sde, dtype = self.sde, u.dtype
        logp, deltas = [], []
        for m in range(mus.shape[0]):
            delta = u - mus[m][None].to(dtype)
            qf = _quad_form(sde, cinvs[m].to(dtype), delta)
            logp.append(logws[m] - 0.5 * qf - 0.5 * logdets[m])
            deltas.append(delta)
        gam = torch.softmax(torch.stack(logp, 0), dim=0)
        score = torch.zeros_like(u)
        for m in range(mus.shape[0]):
            g = gam[m].reshape((-1,) + (1,) * (u.dim() - 1)).to(dtype)
            score = score - g * _apply_sym(sde, cinvs[m].to(dtype), deltas[m])
        return score

    def _tables(self, ts, K_np_fn):
        """Stacked f32 host tables over the grid: per-mode means, C^{-1},
        log-determinants and log-weights, and K_t^T."""
        mus, cinvs, logdets, logws, KTs = [], [], [], [], []
        for t in ts:
            _, consts = self._mode_constants(float(t))
            mus.append(np.stack([c[0] for c in consts]))
            cinvs.append(np.stack([np.asarray(c[1]) for c in consts]))
            logdets.append(np.array([c[2] for c in consts]))
            logws.append(np.array([c[3] for c in consts]))
            KTs.append(np.asarray(self.sde.ops.transpose(K_np_fn(float(t)))))
        f32 = lambda a: torch.as_tensor(np.stack(a), dtype=torch.float32)
        return dict(mus=f32(mus), cinvs=f32(cinvs), logdets=f32(logdets),
                    logws=f32(logws), KTs=f32(KTs))

    def score(self, u: Tensor, t: float) -> Tensor:
        """Exact grad log p_t(u) on u's device; `t` a python float."""
        tab = {k: v[0].to(u.device) for k, v in
               self._tables([t], self.sde.R_np).items()}
        return self._score_dev(u, tab["mus"], tab["cinvs"], tab["logdets"],
                               tab["logws"])

    def eps(self, u: Tensor, t: float,
            K_np_fn: Callable[[float], np.ndarray] | None = None) -> Tensor:
        """epsilon_GT(u, t) = -K_t^T score (paper Eq. 4); default K = R_t."""
        K = K_np_fn(float(t)) if K_np_fn is not None else \
            self.sde.R_np(float(t))
        KT = torch.as_tensor(np.asarray(self.sde.ops.transpose(K)),
                             dtype=u.dtype, device=u.device)
        return -self.sde.apply(KT, self.score(u, t))

    def eps_model(self, K_np_fn: Callable[[float], np.ndarray] | None = None
                  ) -> Callable[[Tensor, Tensor], Tensor]:
        """The exact epsilon in the score net's calling convention, model(u,
        t) with a time per example (what `dsm_loss` and
        `DiffusionSpec.sample` call): each example's epsilon at its own
        time; one batched call where the times are equal."""
        def model(u: Tensor, t: Tensor) -> Tensor:
            ts = [float(s) for s in t.detach().cpu().tolist()]
            if len(set(ts)) == 1:
                return self.eps(u, ts[0], K_np_fn)
            return torch.cat([self.eps(u[i:i + 1], s, K_np_fn)
                              for i, s in enumerate(ts)])

        return model

    def eps_fn_for_grid(self, ts: Sequence[float],
                        K_np_fn: Callable[[float], np.ndarray] | None = None):
        """Build eps(u, i) for a static time grid, every constant computed
        up front.  Returns (eps_fn, n_points); eps_fn(u, i) runs on u's
        device (the tables are copied there at its first call on that
        device)."""
        sde = self.sde
        host = self._tables(ts, K_np_fn or sde.R_np)
        placed: Dict[torch.device, dict] = {}

        def eps_fn(u: Tensor, i: int) -> Tensor:
            tab = placed.get(u.device)
            if tab is None:
                tab = placed[u.device] = {k: v.to(u.device)
                                          for k, v in host.items()}
            score = self._score_dev(u, tab["mus"][i], tab["cinvs"][i],
                                    tab["logdets"][i], tab["logws"][i])
            return -sde.apply(tab["KTs"][i].to(u.dtype), score)

        return eps_fn, len(ts)
