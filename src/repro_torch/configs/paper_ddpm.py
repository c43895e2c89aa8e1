"""Paper config: continuous-time DDPM / VPSDE baseline on CIFAR10-shaped
data (paper Tab. 3 DDPM rows; gDDIM reduces exactly to DDIM here — Thm 1).
The score net is a DiT at the JAX package's width (img 32, patch 2 -> 256
tokens, d_model 768, 24 layers, 12 heads, bf16) over the (B, 32, 32, 3)
state; `reduced` gives the small f32 size the CPU tests run."""
import torch

from ..sde import VPSDE
from ..models.score_net import DiTCfg
from ..train.diffusion import DiffusionSpec


def make(reduced: bool = False, kt: str = "R") -> DiffusionSpec:
    if reduced:
        score = DiTCfg(img_size=8, channels=3, state_mult=1, patch=4,
                       d_model=64, n_layers=2, n_heads=2, remat=False)
        shape = (8, 8, 3)
    else:
        score = DiTCfg(img_size=32, channels=3, state_mult=1, patch=2,
                       d_model=768, n_layers=24, n_heads=12,
                       dtype=torch.bfloat16)
        shape = (32, 32, 3)
    return DiffusionSpec(name="cifar10-ddpm", sde=VPSDE(), data_shape=shape,
                         score_family="dit", score_cfg=score, kt=kt)
