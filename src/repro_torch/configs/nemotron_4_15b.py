"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_head=128
d_ff=24576 vocab=256000 — GQA, squared-ReLU, ungated FFN [arXiv:2402.16819;
unverified].  The full and reduced configs are the JAX package's."""
import torch

from ..models.registry import ArchSpec
from ..models.transformer import TransformerCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = TransformerCfg(name="nemotron-4-15b-smoke", n_layers=4,
                             d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
                             d_ff=128, vocab=256, act="relu2",
                             gated_mlp=False, dtype=torch.float32,
                             remat=False)
    else:
        cfg = TransformerCfg(name="nemotron-4-15b", n_layers=32,
                             d_model=6144, n_heads=48, n_kv_heads=8,
                             d_head=128, d_ff=24576, vocab=256000,
                             act="relu2", gated_mlp=False, dtype=dtype)
    return ArchSpec(name="nemotron-4-15b", family="transformer", cfg=cfg)
