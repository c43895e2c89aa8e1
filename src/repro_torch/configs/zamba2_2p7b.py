"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_head=80 d_ff=10240
vocab=32000, ssm_state=64 — a Mamba2 backbone and a shared attention
block after every 6 layers [arXiv:2411.15242; hf].  The full and reduced
configs are the JAX package's."""
import torch

from ..models.registry import ArchSpec
from ..models.zoo import Zamba2Cfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = Zamba2Cfg(name="zamba2-2.7b-smoke", n_layers=4, d_model=64,
                        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
                        vocab=256, ssm_state=16, share_every=2, chunk=32,
                        dtype=torch.float32, remat=False)
    else:
        cfg = Zamba2Cfg(name="zamba2-2.7b", n_layers=54, d_model=2560,
                        n_heads=32, n_kv_heads=32, d_head=80, d_ff=10240,
                        vocab=32000, ssm_state=64, share_every=6, chunk=128,
                        dtype=dtype)
    return ArchSpec(name="zamba2-2.7b", family="zamba", cfg=cfg)
