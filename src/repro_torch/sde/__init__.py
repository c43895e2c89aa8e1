"""Linear-SDE substrate: the diffusion processes gDDIM generalizes over."""
from .base import (LinearSDE, ScalarOps, BlockOps, FreqDiagOps, family_name,
                   dct_matrix, dct_nd, idct_nd)
from .vpsde import VPSDE
from .cld import CLD
from .bdm import BDM
from .general import GeneralSDE
from .mixture import GaussianMixture, ExactScore
from . import solve

__all__ = ["LinearSDE", "ScalarOps", "BlockOps", "FreqDiagOps",
           "family_name", "dct_matrix", "dct_nd", "idct_nd", "VPSDE", "CLD",
           "BDM", "GeneralSDE", "GaussianMixture", "ExactScore", "solve"]
