"""Stage II — the lockstep gDDIM samplers (paper Sec. 4, Alg. 1).

All samplers share the same contract:

    eps_fn(u, i) -> epsilon prediction at grid index i (i in 0..N, ts[i])

where `eps_fn` is either the exact-score oracle (`sde.mixture`) or a score
network wrapped by `train.losses.make_eps_fn_from_model`.  The whole batch
steps in lockstep on one Stage-I coefficient set, so a step's state update
is one linear form psi u + sum_j C_j eps_j with coefficients shared by the
batch, and each such update is ONE kernel launch:

  * scalar / block families (VPSDE k = 1, CLD k = 2): the state is packed
    to (B, k, D) and `kernels.ei_update.ops.ei_update` applies the form,
    reading the eps rows where they lie;
  * BDM (freq-diagonal coefficients): `kernels.dct2.ops.bdm_ei_update`
    applies it in the DCT basis, on the (B, H, W, C) state.

The step loop is a Python loop: one eps eval and one update launch per
step (two of each with the corrector).  The baselines — Euler-Maruyama,
Heun and BDM ancestral sampling — stay on plain tensor ops, as in the JAX
package.

Implemented:
  * deterministic gDDIM, q-step exponential multistep predictor (Eq. 19)
  * optional q-step corrector (Eq. 45; PC = predictor-corrector, Alg. 1)
  * stochastic gDDIM for any lambda (Eq. 22, covariance Eq. 23)
  * baselines: Euler--Maruyama on the lambda-SDE (Eq. 6), probability-flow
    Euler & Heun (2nd order, Karras-style), BDM ancestral sampling
    (Hoogeboom & Salimans), and host-side RK45 probability flow.

Keys follow the JAX package's split order: one `random.split` per step,
the carried key first, so the samplers draw the JAX package's noise.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from .. import random as prng
from ..kernels.dct2.ops import bdm_ei_update
from ..kernels.ei_update.ops import ei_update, pack_state, unpack_state
from ..sde.base import LinearSDE, sde_apply_np_freq
from .coeffs import SamplerCoeffs

Tensor = torch.Tensor
EpsFn = Callable[[Tensor, int], Tensor]


def _update(sde: LinearSDE, u: Tensor, eps: Sequence[Tensor], psi: Tensor,
            C: Tensor) -> Tensor:
    """psi u + sum_j C[j] eps[j] for one coefficient set shared by the
    batch: one `ei_update` launch on the packed state, which reads the eps
    rows where they lie (packed views, no stack: the update is one device
    kernel), or for BDM one `bdm_ei_update` launch on the stacked history
    (psi and C then already on u's device)."""
    q = len(eps)
    if sde.ops.family == "freqdiag":
        return bdm_ei_update(u.contiguous(), torch.stack(list(eps)), psi, C)
    k = sde.packed_k
    z, shape = pack_state(u, k)
    # .contiguous() copies only a row that eps_fn returned strided
    rows = [e.reshape(z.shape).contiguous() for e in eps]
    out = ei_update(z.contiguous(), rows, psi.reshape(k, k),
                    C.reshape(q, k, k))
    return unpack_state(out, shape)


def _placed(sde: LinearSDE, coeffs: SamplerCoeffs, device) -> SamplerCoeffs:
    """The coefficient stacks where the update reads them: on the state's
    device for BDM (the bdm_ei_update kernel reads one value per
    frequency), on the host otherwise (ei_update takes its handful of
    scalars by value with the launch)."""
    if sde.ops.family != "freqdiag":
        return coeffs
    return coeffs._replace(**{nm: getattr(coeffs, nm).to(device) for nm in
                              ("psi", "pC", "cC", "B", "P_chol")})


def _family_stack(sde: LinearSDE, fn, ts: Tensor, device) -> Tensor:
    """F or G2 at every grid point, host float64 cast to f32, on device."""
    return torch.as_tensor(
        np.stack([np.asarray(fn(float(t)), np.float64) for t in ts]),
        dtype=torch.float32).to(device)


# ---------------------------------------------------------------------------
# Deterministic gDDIM: exponential multistep predictor(-corrector)
# ---------------------------------------------------------------------------
def sample_gddim(
    sde: LinearSDE,
    coeffs: SamplerCoeffs,
    eps_fn: EpsFn,
    u_T: Tensor,
    q: int,
    corrector: bool = False,
) -> Tensor:
    """Run the full sampling loop from u(T) to u(t_min).

    NFE = N for predictor-only, 2N - 1 for predictor-corrector (the final
    corrector re-evaluation at t_0 is skipped, matching Alg. 1 / Tab. 8).
    """
    N = coeffs.psi.shape[0]
    co = _placed(sde, coeffs, u_T.device)
    u = u_T
    hist: List[Tensor] = [torch.zeros_like(u_T)] * q     # newest first
    for k in range(N):
        i = N - k
        hist = [eps_fn(u, i)] + hist[:-1]
        # predictor (Eq. 19a): u_pred = Psi u + sum_j pC[k,j] eps(t_{i+j})
        u_pred = _update(sde, u, hist, co.psi[k], co.pC[k])
        # Alg. 1 runs the corrector after every predictor step except the
        # last (which would waste an NFE on t_0 output refinement)
        if corrector and k < N - 1:
            eps_im1 = eps_fn(u_pred, i - 1)
            u = _update(sde, u, [eps_im1] + hist[:-1], co.psi[k], co.cC[k])
        else:
            u = u_pred
    return u


# ---------------------------------------------------------------------------
# Stochastic gDDIM (Eq. 22)
# ---------------------------------------------------------------------------
def sample_gddim_stochastic(
    sde: LinearSDE,
    coeffs: SamplerCoeffs,
    eps_fn: EpsFn,
    u_T: Tensor,
    key: Tensor,
) -> Tensor:
    """u(t) ~ N(Psi u(s) + (Psi_hat - Psi) R_s eps_theta(u(s), s),  P_st)."""
    N = coeffs.psi.shape[0]
    co = _placed(sde, coeffs, u_T.device)
    u = u_T
    for k in range(N):
        i = N - k
        key, sub = prng.split(key)
        eps_i = eps_fn(u, i)
        noise = sde.noise_like(sub, tuple(u.shape), u.dtype)
        u = _update(sde, u, [eps_i, noise], co.psi[k],
                    torch.stack([co.B[k], co.P_chol[k]]))
    return u


# ---------------------------------------------------------------------------
# Baseline: Euler--Maruyama on the lambda-family SDE (Eq. 6)
# ---------------------------------------------------------------------------
def sample_em(
    sde: LinearSDE,
    coeffs: SamplerCoeffs,
    eps_fn: EpsFn,
    u_T: Tensor,
    key: Tensor,
    lam: float,
) -> Tensor:
    """du = [F u - (1+lam^2)/2 G2 s_theta] dt + lam G dw, Euler discretized
    on the same grid (reverse time; dt < 0)."""
    N = coeffs.psi.shape[0]
    dev = u_T.device
    ts = coeffs.ts.to(dev)
    F_stack = _family_stack(sde, sde.F_np, coeffs.ts, dev)
    G2_stack = _family_stack(sde, sde.G2_np, coeffs.ts, dev)
    R_invT = coeffs.R_invT.to(dev)
    u = u_T
    for k in range(N):
        i = N - k
        key, sub = prng.split(key)
        dt = ts[i - 1] - ts[i]                      # negative
        eps_i = eps_fn(u, i)
        score = -sde.apply(R_invT[i], eps_i)
        drift = sde.apply(F_stack[i], u) - 0.5 * (1.0 + lam * lam) * \
            sde.apply(G2_stack[i], score)
        u_next = u + drift * dt
        if lam > 0.0:
            noise = sde.noise_like(sub, tuple(u.shape), u.dtype)
            # lam * G * sqrt(|dt|) * noise; G = sqrt(G2) family-wise
            g = torch.sqrt(torch.clamp_min(G2_stack[i], 0.0))
            u_next = u_next + lam * torch.sqrt(-dt) * sde.apply(g, noise)
        u = u_next
    return u


# ---------------------------------------------------------------------------
# Baseline: probability-flow Euler / Heun (2nd order)
# ---------------------------------------------------------------------------
def sample_heun(
    sde: LinearSDE,
    coeffs: SamplerCoeffs,
    eps_fn: EpsFn,
    u_T: Tensor,
    second_order: bool = True,
) -> Tensor:
    """Explicit Euler / Heun on du/dt = F u - 1/2 G2 score (Eq. 7).

    NFE = N (Euler) or 2N - 1 (Heun; final step falls back to Euler)."""
    N = coeffs.psi.shape[0]
    dev = u_T.device
    ts = coeffs.ts.to(dev)
    F_stack = _family_stack(sde, sde.F_np, coeffs.ts, dev)
    G2_stack = _family_stack(sde, sde.G2_np, coeffs.ts, dev)
    R_invT = coeffs.R_invT.to(dev)

    def ode_rhs(u, i):
        score = -sde.apply(R_invT[i], eps_fn(u, i))
        return sde.apply(F_stack[i], u) - 0.5 * sde.apply(G2_stack[i], score)

    u = u_T
    for k in range(N):
        i = N - k
        dt = ts[i - 1] - ts[i]
        d1 = ode_rhs(u, i)
        u_euler = u + dt * d1
        if second_order and k < N - 1:
            d2 = ode_rhs(u_euler, i - 1)
            u = u + dt * 0.5 * (d1 + d2)
        else:
            u = u_euler
    return u


# ---------------------------------------------------------------------------
# Baseline: BDM ancestral sampling (Hoogeboom & Salimans 2022)
# ---------------------------------------------------------------------------
def sample_ancestral_bdm(sde, eps_fn: EpsFn, u_T: Tensor, ts: np.ndarray,
                         key: Tensor) -> Tensor:
    """Frequency-space DDPM-style ancestral sampler — the original (slow)
    BDM sampler the paper accelerates >20x (Tab. 3)."""
    coef_ut, coef_u0, a_t, sig_t, std = [
        torch.as_tensor(c, dtype=torch.float32).to(u_T.device)
        for c in sde.ancestral_coeffs(np.asarray(ts)[::-1])]
    N = coef_ut.shape[0]
    u = u_T
    for k in range(N):
        i = N - k  # grid index into increasing ts
        key, sub = prng.split(key)
        eps = eps_fn(u, i)
        y = sde.to_freq(u)
        ehat = sde.to_freq(eps)
        y0 = (y - sig_t[k] * ehat) / a_t[k]
        mean = coef_ut[k] * y + coef_u0[k] * y0
        noise = prng.normal(sub, tuple(u.shape), u.dtype)
        y_next = mean + std[k] * sde.to_freq(noise)
        u = sde.from_freq(y_next)
    return u


# ---------------------------------------------------------------------------
# Baseline: host-side adaptive RK45 on the probability flow (exact score)
# ---------------------------------------------------------------------------
def sample_rk45_np(sde, score_np, u_T: np.ndarray, rtol=1e-4, atol=1e-4):
    """scipy RK45 over the probability-flow ODE with a host score oracle.
    Returns (samples, nfe).  Used for the 'Prob.Flow, RK45' rows of Tab. 3.
    Host float64 throughout; no device."""
    import scipy.integrate

    shape = u_T.shape
    nfe = [0]

    def rhs(t, y):
        nfe[0] += 1
        u = y.reshape(shape)
        sc = score_np(u, float(t))
        F = sde.F_np(float(t))
        G2 = sde.G2_np(float(t))
        if sde.ops.family == "block":
            du = np.einsum("ij,bj...->bi...", F, u) - 0.5 * np.einsum(
                "ij,bj...->bi...", G2, sc)
        elif sde.ops.family == "scalar":
            du = F * u - 0.5 * G2 * sc
        else:  # freqdiag — host numpy DCT path
            du = sde_apply_np_freq(sde, F, u) - \
                0.5 * sde_apply_np_freq(sde, G2, sc)
        return du.reshape(-1)

    sol = scipy.integrate.solve_ivp(
        rhs, (sde.T, sde.t_min), np.asarray(u_T, np.float64).reshape(-1),
        method="RK45", rtol=rtol, atol=atol)
    return sol.y[:, -1].reshape(shape), nfe[0]
