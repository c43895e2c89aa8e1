"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_head=128
d_ff=19200 vocab=32256 — llama-arch [arXiv:2401.14196; hf].  The full and
reduced configs are the JAX package's."""
import torch

from ..models.registry import ArchSpec
from ..models.transformer import TransformerCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = TransformerCfg(name="deepseek-coder-33b-smoke", n_layers=4,
                             d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
                             d_ff=128, vocab=256, dtype=torch.float32,
                             remat=False)
    else:
        cfg = TransformerCfg(name="deepseek-coder-33b", n_layers=62,
                             d_model=7168, n_heads=56, n_kv_heads=8,
                             d_head=128, d_ff=19200, vocab=32256,
                             dtype=dtype)
    return ArchSpec(name="deepseek-coder-33b", family="transformer", cfg=cfg)
