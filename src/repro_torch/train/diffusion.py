"""DiffusionSpec: binds (SDE family, score network, K_t choice) into the
surface the serving engine uses.

    init(seed, device)             -> the score net (an nn.Module), weights
                                      drawn from a torch.Generator seeded
                                      with `seed`
    eps_model(net, u, t)           -> eps prediction of u's shape
    sample(net, key, n, nfe, ...)  -> n samples from the lockstep gDDIM
                                      sampler (or an EM / Heun baseline)

The losses, perturbation tables and the training step belong to a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .. import random as prng
from ..core import build_sampler_coeffs, time_grid
from ..core.gddim import (sample_em, sample_gddim, sample_gddim_stochastic,
                          sample_heun)
from ..models import score_net
from ..sde.base import LinearSDE
from . import losses


@dataclasses.dataclass
class DiffusionSpec:
    name: str
    sde: LinearSDE
    data_shape: Tuple[int, ...]
    score_family: str               # "dit"
    score_cfg: Any
    kt: str = "R"                   # the gDDIM choice; "L" = Dockhorn baseline

    def init(self, seed: int = 0, device="cuda") -> torch.nn.Module:
        if self.score_family != "dit":
            raise ValueError(f"score family {self.score_family!r} is not "
                             "ported")
        gen = torch.Generator().manual_seed(int(seed))
        return score_net.DiT(self.score_cfg, gen, device=device).eval()

    def eps_model(self, net: torch.nn.Module, u: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        return net(u, t)

    # ---- sampling ------------------------------------------------------------
    def make_eps_fn(self, net: torch.nn.Module, ts: np.ndarray) -> Callable:
        return losses.make_eps_fn_from_model(
            self.sde, lambda u, t: self.eps_model(net, u, t), ts)

    @torch.no_grad()
    def sample(self, net: torch.nn.Module, key: Optional[torch.Tensor],
               n: int, nfe: int, *, q: int = 2, lam: float = 0.0,
               corrector: bool = False, method: str = "gddim",
               grid: str = "quadratic", device="cuda") -> torch.Tensor:
        """n samples in data space, the whole batch in lockstep on one
        Stage-I coefficient set: `method` "gddim" (stochastic Eq. 22 when
        lam > 0, else the q-step predictor with the optional corrector),
        "em" (Euler-Maruyama at lambda max(lam, 1)) or "heun".  `key` is a
        `random.PRNGKey` (None: PRNGKey(0)); the prior and the step noise
        are drawn on `device` from it as the JAX package draws them, and
        `net` must already live there."""
        device = torch.device(device)
        ts = time_grid(self.sde, nfe, grid)
        co = build_sampler_coeffs(self.sde, ts, q=q, lam=lam, kt=self.kt)
        eps_fn = self.make_eps_fn(net, ts)
        key = prng.PRNGKey(0, device) if key is None else key.to(device)
        k1, k2 = prng.split(key)
        u_T = self.sde.prior_sample(k1, n, tuple(self.data_shape))
        if method == "gddim":
            if lam > 0:
                u0 = sample_gddim_stochastic(self.sde, co, eps_fn, u_T, k2)
            else:
                u0 = sample_gddim(self.sde, co, eps_fn, u_T, q=q,
                                  corrector=corrector)
        elif method == "em":
            u0 = sample_em(self.sde, co, eps_fn, u_T, k2, lam=max(lam, 1.0))
        elif method == "heun":
            u0 = sample_heun(self.sde, co, eps_fn, u_T)
        else:
            raise ValueError(method)
        return self.sde.project_data(u0)
