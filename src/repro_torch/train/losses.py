"""Sampler glue from the JAX package's `train/losses.py`: the adapter that
turns an eps-model into the sampler contract eps_fn(u, i).  The losses and
perturbation tables belong to the training slice of the port."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..sde.base import LinearSDE

Tensor = torch.Tensor


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
