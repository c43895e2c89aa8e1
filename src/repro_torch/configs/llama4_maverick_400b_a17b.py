"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_head=128, dense d_ff=16384, expert d_ff=8192, vocab=202048; MoE 128
experts top-1 plus a shared expert, dense and MoE layers alternating,
sorted dispatch; early fusion with the image frontend a stub
[hf:meta-llama/Llama-4-*; unverified].  The full and reduced configs are
the JAX package's (the reduced one keeps MoECfg's default dense
dispatch)."""
import torch

from ..models.registry import ArchSpec
from ..models.transformer import MoECfg, TransformerCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = TransformerCfg(name="llama4-maverick-smoke", n_layers=4,
                             d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                             d_ff=128, vocab=256,
                             layer_windows=(None, None),
                             layer_moe=(False, True),
                             moe=MoECfg(n_experts=8, top_k=1, d_ff=32,
                                        n_shared=1, d_ff_shared=32),
                             dtype=torch.float32, remat=False)
    else:
        cfg = TransformerCfg(name="llama4-maverick-400b-a17b", n_layers=48,
                             d_model=5120, n_heads=40, n_kv_heads=8,
                             d_head=128, d_ff=16384, vocab=202048,
                             layer_windows=(None, None),
                             layer_moe=(False, True),
                             moe=MoECfg(n_experts=128, top_k=1, d_ff=8192,
                                        n_shared=1, d_ff_shared=8192,
                                        impl="sorted"),
                             dtype=dtype)
    return ArchSpec(name="llama4-maverick-400b-a17b", family="transformer",
                    cfg=cfg)
