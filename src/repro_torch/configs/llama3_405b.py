"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_head=128
d_ff=53248 vocab=128256 — GQA, 128k vocab, rope_theta 5e5
[arXiv:2407.21783; unverified].  The full and reduced configs are the JAX
package's."""
import torch

from ..models.registry import ArchSpec
from ..models.transformer import TransformerCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = TransformerCfg(name="llama3-405b-smoke", n_layers=4,
                             d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
                             d_ff=192, vocab=512, dtype=torch.float32,
                             remat=False)
    else:
        cfg = TransformerCfg(name="llama3-405b", n_layers=126,
                             d_model=16384, n_heads=128, n_kv_heads=8,
                             d_head=128, d_ff=53248, vocab=128256,
                             rope_theta=500000.0, dtype=dtype)
    return ArchSpec(name="llama3-405b", family="transformer", cfg=cfg)
