"""DiffusionSpec: binds (SDE family, score network, K_t choice) into the
surface the serving engine uses.

    init(seed, device)             -> the score net (an nn.Module), weights
                                      drawn from a torch.Generator seeded
                                      with `seed`
    eps_model(net, u, t)           -> eps prediction of u's shape

The losses, perturbation tables and the training step belong to a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..models import score_net
from ..sde.base import LinearSDE


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
