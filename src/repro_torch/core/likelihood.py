"""Probability-flow log-likelihood (paper App. C.8).

Integrating the instantaneous change of variables along Eq. (7):

    log p_0(u_0) = log p_T(u_T) + int_0^T div f(u_t, t) dt,
    f(u, t) = F_t u - 1/2 G_t G_t^T s_theta(u, t)

with Heun steps on a uniform grid in [t_min, T].  The divergence is exact
for low-dimensional states: the trace of each example's Jacobian, one
reverse-mode product per state dimension (the JAX package takes a
forward-mode Jacobian; the trace is the same).  At image scale,
`hutchinson=True` uses the Skilling-Hutchinson estimate eps^T J eps with
a Rademacher eps, taken here as (J^T eps) . eps by one reverse-mode
product (JAX: J eps by `jvp`, then . eps: the same number), so a score
net's gradient runs through its attention backward.  For CLD this gives
log p(x0, v0); `cld_nll_bound` gives the paper's marginal bound
log p(x0) >= E_v0[log p(x0, v0)] + H(p(v0)).

`score_fn(u, t)` takes the state and a python float time and must be
differentiable in u by torch autograd (`sde.mixture.ExactScore.score` is;
so is a score net through `train.losses.score_fn_from_model`), and must
treat the examples of the batch independently.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import random as prng
from ..sde.base import LinearSDE
from ..sde.mixture import _logdet, _quad_form

Tensor = torch.Tensor


def _flow_rhs(sde: LinearSDE, score_fn: Callable, u: Tensor,
              t: float) -> Tensor:
    F = torch.as_tensor(np.asarray(sde.F_np(float(t))), dtype=u.dtype,
                        device=u.device)
    G2 = torch.as_tensor(np.asarray(sde.G2_np(float(t))), dtype=u.dtype,
                         device=u.device)
    return sde.apply(F, u) - 0.5 * sde.apply(G2, score_fn(u, float(t)))


def _rhs_and_div(sde: LinearSDE, score_fn: Callable, u: Tensor, t: float,
                 eps: Optional[Tensor]):
    """(f(u, t), div f(u, t)) from one evaluation of the score: exact
    (per-example Jacobian trace) when `eps` is None, else eps^T J eps."""
    B = u.shape[0]
    with torch.enable_grad():
        x = u.detach().requires_grad_(True)
        f = _flow_rhs(sde, score_fn, x, t).reshape(B, -1)
        if eps is not None:
            (g,) = torch.autograd.grad(f, x, grad_outputs=eps.reshape(f.shape))
            div = torch.sum(g.reshape(B, -1) * eps, dim=-1)
        else:
            D = f.shape[1]
            div = torch.zeros(B, dtype=f.dtype, device=f.device)
            for i in range(D):
                (g,) = torch.autograd.grad(f[:, i].sum(), x,
                                           retain_graph=i < D - 1)
                div = div + g.reshape(B, -1)[:, i]
    return f.detach().reshape(u.shape), div.detach()


def log_likelihood(
    sde: LinearSDE,
    score_fn: Callable[[Tensor, float], Tensor],
    u0: Tensor,
    n_steps: int = 200,
    hutchinson: bool = False,
    key: Optional[Tensor] = None,
) -> Tensor:
    """log p_0(u0), (B,) f32, by Heun integration of the flow and its
    divergence.  `u0`: (B, *state).  With `hutchinson`, the probes are
    drawn from `key` (a `random.PRNGKey`; None: PRNGKey(0)) as the JAX
    package draws them: one split and one Rademacher (B, D) draw a step,
    shared by the step's two evaluations."""
    B = u0.shape[0]
    D = int(np.prod(u0.shape[1:]))
    ts = np.linspace(sde.t_min, sde.T, n_steps + 1)
    if hutchinson:
        key = (prng.PRNGKey(0) if key is None else key).to(u0.device)

    u = u0
    logdet = torch.zeros((B,), dtype=torch.float32, device=u0.device)
    for i in range(n_steps):
        t0, t1 = float(ts[i]), float(ts[i + 1])
        dt = t1 - t0
        eps = None
        if hutchinson:
            key, sub = prng.split(key)
            eps = prng.rademacher(sub, (B, D))
        k1, d1 = _rhs_and_div(sde, score_fn, u, t0, eps)
        u_mid = u + dt * k1
        k2, d2 = _rhs_and_div(sde, score_fn, u_mid, t1, eps)
        u = u + 0.5 * dt * (k1 + k2)
        logdet = logdet + 0.5 * dt * (d1 + d2)

    # prior at T: N(0, Sigma_T) with the SDE's structured covariance
    sig = sde.Sigma_np(sde.T)
    sinv = torch.as_tensor(np.asarray(sde.ops.inv(sig)), dtype=u.dtype,
                           device=u.device)
    qf = _quad_form(sde, sinv, u)
    ld = _logdet(sde, sig, u.shape[1:] if sde.state_ndim_prefix == 0
                 else u.shape[2:])
    logpT = -0.5 * qf - 0.5 * ld - 0.5 * D * np.log(2 * np.pi)
    return logpT + logdet


def cld_nll_bound(sde, score_fn, x0: Tensor, key: Tensor, n_v: int = 4,
                  n_steps: int = 200, hutchinson: bool = False) -> Tensor:
    """Paper App. C.8: log p(x0) >= E_{v0 ~ N(0, gamma M)}[log p(x0, v0)]
    + H(p(v0)), averaged over `n_v` velocity draws from `key` (split as the
    JAX package splits it; with `hutchinson`, one more split a draw gives
    its probes' key)."""
    d = int(np.prod(x0.shape[1:]))
    v_var = sde.gamma / sde.M_inv
    ent = 0.5 * d * (1.0 + np.log(2 * np.pi * v_var))
    v_std = float(np.sqrt(np.float32(v_var)))
    key = key.to(x0.device)
    vals = []
    for _ in range(n_v):
        key, sub = prng.split(key)
        hk = None
        if hutchinson:
            key, hk = prng.split(key)
        v0 = v_std * prng.normal(sub, tuple(x0.shape), x0.dtype)
        u0 = torch.stack([x0, v0], dim=1)
        vals.append(log_likelihood(sde, score_fn, u0, n_steps=n_steps,
                                   hutchinson=hutchinson, key=hk))
    return torch.mean(torch.stack(vals), dim=0) + ent
