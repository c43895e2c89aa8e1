"""gemma3-1b [dense]: 26L d_model=1152 4H (MQA kv=1) d_head=256 d_ff=6912
vocab=262144 — 5:1 local:global sliding-window pattern (window 512),
rope_theta 1e6, bf16 [hf:google/gemma-3-1b-pt; unverified].  The full and
reduced configs are the JAX package's."""
import torch

from ..models.registry import ArchSpec
from ..models.transformer import TransformerCfg

_WINDOWS = (512, 512, 512, 512, 512, None)   # 5 local : 1 global


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = TransformerCfg(name="gemma3-1b-smoke", n_layers=6, d_model=64,
                             n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
                             vocab=256, layer_windows=(16, 16, 16, 16, 16, None),
                             layer_moe=(False,) * 6,
                             dtype=torch.float32, remat=False)
    else:
        cfg = TransformerCfg(name="gemma3-1b", n_layers=26, d_model=1152,
                             n_heads=4, n_kv_heads=1, d_head=256, d_ff=6912,
                             vocab=262144, layer_windows=_WINDOWS,
                             layer_moe=(False,) * 6, rope_theta=1_000_000.0,
                             dtype=dtype)
    return ArchSpec(name="gemma3-1b", family="transformer", cfg=cfg)
