"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_head=64 d_ff=4864
vocab=151655 — InternViT + InternLM2 backbone; the ViT frontend is a
stub: training and prefill may feed precomputed patch embeddings (B, S, D)
in place of token ids, and decode drives the LM decoder on tokens
[arXiv:2404.16821; hf].  The full and reduced configs are the JAX
package's."""
import torch

from ..models.registry import ArchSpec
from ..models.transformer import TransformerCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = TransformerCfg(name="internvl2-1b-smoke", n_layers=2,
                             d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                             d_ff=128, vocab=256, dtype=torch.float32,
                             remat=False)
    else:
        cfg = TransformerCfg(name="internvl2-1b", n_layers=24, d_model=896,
                             n_heads=14, n_kv_heads=2, d_head=64, d_ff=4864,
                             vocab=151655, dtype=dtype)
    return ArchSpec(name="internvl2-1b", family="transformer", cfg=cfg,
                    input_mode="embeddings")
