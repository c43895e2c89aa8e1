"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_head=128
expert d_ff=768 vocab=151936, MoE 128 experts top-8, every layer, sorted
dispatch [hf:Qwen/Qwen3-30B-A3B; hf].  The full and reduced configs are
the JAX package's (the reduced one keeps MoECfg's default dense
dispatch)."""
import torch

from ..models.registry import ArchSpec
from ..models.transformer import MoECfg, TransformerCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = TransformerCfg(name="qwen3-moe-smoke", n_layers=2, d_model=64,
                             n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                             vocab=256, layer_windows=(None,),
                             layer_moe=(True,),
                             moe=MoECfg(n_experts=8, top_k=2, d_ff=32),
                             dtype=torch.float32, remat=False)
    else:
        cfg = TransformerCfg(name="qwen3-moe-30b-a3b", n_layers=48,
                             d_model=2048, n_heads=32, n_kv_heads=4,
                             d_head=128, d_ff=768, vocab=151936,
                             layer_windows=(None,), layer_moe=(True,),
                             moe=MoECfg(n_experts=128, top_k=8, d_ff=768,
                                        impl="sorted"),
                             dtype=dtype)
    return ArchSpec(name="qwen3-moe-30b-a3b", family="transformer", cfg=cfg)
