"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; hf].  The full and
reduced configs are the JAX package's."""
import torch

from ..models.registry import ArchSpec
from ..models.zoo import RWKV6LMCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = RWKV6LMCfg(name="rwkv6-7b-smoke", n_layers=2, d_model=64,
                         n_heads=4, d_ff=128, vocab=256, chunk=16,
                         dtype=torch.float32, remat=False)
    else:
        cfg = RWKV6LMCfg(name="rwkv6-7b", n_layers=32, d_model=4096,
                         n_heads=64, d_ff=14336, vocab=65536, chunk=16,
                         dtype=dtype)
    return ArchSpec(name="rwkv6-7b", family="rwkv", cfg=cfg)
