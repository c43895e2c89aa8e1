"""Host-side numerical solvers for the Stage-I coefficient pipeline.

The paper (App. C.3) computes every sampler coefficient offline:

  Type I  — matrix ODEs: R_t (Eq. 17), Psi_hat(t, s) (Eq. 81), P_st (Eq. 23),
            Sigma_t (Lyapunov, Eq. 27) — solved with RK4 on a fine grid.
  Type II — definite integrals: the exponential-integrator predictor /
            corrector constants pC, cC (Eqs. 41/46) — composite quadrature.

Everything here is pure numpy float64 and runs once per (SDE, time grid);
results are cached and then shipped to the device as stacked tensors.
The per-family coefficients are tiny (scalar / 2x2 / per-frequency diag), so
even the paper's 1e-6-step RK4 is cheap; we default to a log+linear grid with
RK4 substeps which matches the paper's accuracy at far lower cost (validated
in tests against closed forms on VPSDE).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def rk4_step(rhs: Callable, t: float, y, h: float):
    k1 = rhs(t, y)
    k2 = rhs(t + 0.5 * h, y + 0.5 * h * k1)
    k3 = rhs(t + 0.5 * h, y + 0.5 * h * k2)
    k4 = rhs(t + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def integrate_ode(rhs: Callable, y0, t0: float, t1: float, n_steps: int):
    """RK4 from t0 to t1 (t1 may be < t0) in n_steps equal steps."""
    h = (t1 - t0) / n_steps
    t, y = t0, y0
    for _ in range(n_steps):
        y = rk4_step(rhs, t, y, h)
        t += h
    return y


def make_grid(t_lo: float, t_hi: float, n_log: int = 2048, n_lin: int = 2048) -> np.ndarray:
    """Time grid dense near t_lo (where CLD's Sigma_t^{-1} is stiff, and where
    R^{-1} amplifies interpolation error) + linear body.  The log segment
    spans t_lo..0.1*t_hi so the near-origin spacing is ~1e-5."""
    knee = min(0.1 * t_hi, t_hi)
    lo = np.geomspace(max(t_lo, 1e-8), knee, n_log)
    lin = np.linspace(knee, t_hi, n_lin)
    g = np.unique(np.concatenate([lo, lin]))
    return g


class GridFn:
    """Piecewise-linear interpolant of a coeff-valued function on a grid.

    Values are stacked along axis 0; linear interpolation in t (the paper
    interpolates its RK4 output the same way, App. C.3 Type I).
    """

    def __init__(self, ts: np.ndarray, values: np.ndarray):
        self.ts = np.asarray(ts, np.float64)
        self.values = np.asarray(values, np.float64)

    def __call__(self, t):
        t = np.asarray(t, np.float64)
        idx = np.clip(np.searchsorted(self.ts, t) - 1, 0, len(self.ts) - 2)
        t0, t1 = self.ts[idx], self.ts[idx + 1]
        w = np.where(t1 > t0, (t - t0) / np.where(t1 > t0, t1 - t0, 1.0), 0.0)
        v0, v1 = self.values[idx], self.values[idx + 1]
        w = w.reshape(w.shape + (1,) * (self.values.ndim - 1 - t.ndim))
        return (1.0 - w) * v0 + w * v1


def solve_on_grid(rhs: Callable, y0, ts: np.ndarray, substeps: int = 8) -> GridFn:
    """Integrate dy/dt = rhs(t, y) across the grid, `substeps` RK4 steps/interval."""
    ys = [np.asarray(y0, np.float64)]
    y = ys[0]
    for a, b in zip(ts[:-1], ts[1:]):
        y = integrate_ode(rhs, y, float(a), float(b), substeps)
        ys.append(y)
    return GridFn(ts, np.stack(ys))


def simpson_nodes(a: float, b: float, n: int):
    """Composite-Simpson nodes & weights on [a, b] (n even panels)."""
    if n % 2:
        n += 1
    xs = np.linspace(a, b, n + 1)
    w = np.ones(n + 1)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    w *= (b - a) / (3.0 * n)
    return xs, w


def quad_coeff(integrand: Callable[[float], np.ndarray], a: float, b: float,
               n: int = 64, adaptive: bool = True, rtol: float = 1e-7,
               n_max: int = 1536) -> np.ndarray:
    """Definite integral of a coeff-valued integrand via composite Simpson.

    Used for the exponential-integrator constants pC/cC (paper Eqs. 41/46)
    and the single-step EI coefficient (Eq. 18). Signed interval (b < a ok).
    With `adaptive`, panel count doubles until the result is stable to
    `rtol` — needed on stiff intervals reaching toward t_min where the
    integrand grows like Sigma^{-1} ~ t^{-3} (CLD).
    """
    def run(m):
        xs, w = simpson_nodes(a, b, m)
        acc = None
        for x, wx in zip(xs, w):
            v = wx * np.asarray(integrand(float(x)), np.float64)
            acc = v if acc is None else acc + v
        return acc

    out = run(n)
    if not adaptive:
        return out
    while n < n_max:
        n *= 2
        nxt = run(n)
        scale = max(np.max(np.abs(nxt)), 1e-12)
        if np.max(np.abs(nxt - out)) <= rtol * scale:
            return nxt
        out = nxt
    return out


def lagrange_basis(nodes: Sequence[float], j: int) -> Callable[[float], float]:
    """The j-th Lagrange basis polynomial over `nodes` (paper Eq. 39/44)."""
    nodes = [float(x) for x in nodes]

    def ell(tau: float) -> float:
        num, den = 1.0, 1.0
        for k, tk in enumerate(nodes):
            if k == j:
                continue
            num *= tau - tk
            den *= nodes[j] - tk
        return num / den

    return ell
