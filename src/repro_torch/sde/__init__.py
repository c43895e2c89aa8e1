"""Linear-SDE substrate: the diffusion processes gDDIM generalizes over."""
from .base import (LinearSDE, ScalarOps, BlockOps, FreqDiagOps, family_name,
                   dct_matrix, dct_nd, idct_nd)
from .cld import CLD
from .bdm import BDM
from . import solve

__all__ = ["LinearSDE", "ScalarOps", "BlockOps", "FreqDiagOps",
           "family_name", "dct_matrix", "dct_nd", "idct_nd", "CLD", "BDM",
           "solve"]
