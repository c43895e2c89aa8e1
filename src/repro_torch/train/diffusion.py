"""DiffusionSpec: binds (SDE family, score network, K_t choice) into the
surface the serving engine and the training loop use.

    init(seed, device)             -> the score net (an nn.Module: the DiT
                                      or the MLP), weights drawn from a
                                      torch.Generator seeded with `seed`
    eps_model(net, u, t)           -> eps prediction of u's shape
    tables                         -> the DSM perturbation tables (host
                                      float64 cast to f32, built once)
    loss(net, x0, key)             -> the DSM/HSM scalar (paper Eq. 5/77)
    sample(net, key, n, nfe, ...)  -> n samples from the lockstep gDDIM
                                      sampler (or an EM / Heun baseline)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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
    score_family: str               # "mlp" | "dit"
    score_cfg: Any
    kt: str = "R"                   # the gDDIM choice; "L" = Dockhorn baseline
    _tables: Dict[str, losses.PerturbTables] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def init(self, seed: int = 0, device="cuda") -> torch.nn.Module:
        gen = torch.Generator().manual_seed(int(seed))
        if self.score_family == "mlp":
            net = score_net.MLPScore(self.score_cfg, gen, device=device)
        elif self.score_family == "dit":
            net = score_net.DiT(self.score_cfg, gen, device=device)
        else:
            raise ValueError(f"unknown score family {self.score_family!r}")
        return net.eval()

    def eps_model(self, net: torch.nn.Module, u: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        return net(u, t)

    # ---- training ---------------------------------------------------------------
    @property
    def tables(self) -> losses.PerturbTables:
        """The perturbation tables as CPU tensors (built on first use)."""
        return self.tables_on("cpu")

    def tables_on(self, device) -> losses.PerturbTables:
        """The perturbation tables on `device`, one copy per device."""
        name = str(torch.device(device))
        if name not in self._tables:
            host = self._tables.get("cpu")
            if host is None:
                host = self._tables["cpu"] = losses.build_perturb_tables(
                    self.sde, kt=self.kt)
            self._tables[name] = host.to(device)
        return self._tables[name]

    def loss(self, net: torch.nn.Module, x0: torch.Tensor,
             key: torch.Tensor) -> torch.Tensor:
        """The DSM/HSM loss of `net` on the batch x0 (on x0's device)."""
        return losses.dsm_loss(self.sde, self.tables_on(x0.device),
                               lambda u, t: self.eps_model(net, u, t),
                               x0, key)

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
