"""Linear-SDE substrate: the diffusion processes gDDIM generalizes over."""
from .base import LinearSDE, ScalarOps, BlockOps, family_name
from .cld import CLD
from . import solve

__all__ = ["LinearSDE", "ScalarOps", "BlockOps", "family_name", "CLD",
           "solve"]
