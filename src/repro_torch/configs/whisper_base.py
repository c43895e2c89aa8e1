"""whisper-base [audio]: 6L (enc) + 6L (dec) d_model=512 8H d_ff=2048
vocab=51865 — encoder-decoder, the conv frontend a stub: requests and
batches carry precomputed frame embeddings (B, 1500, d) [arXiv:2212.04356;
unverified].  The full and reduced configs are the JAX package's."""
import torch

from ..models.registry import ArchSpec
from ..models.zoo import EncDecCfg


def make(reduced: bool = False, dtype=torch.bfloat16) -> ArchSpec:
    if reduced:
        cfg = EncDecCfg(name="whisper-base-smoke", n_enc_layers=2,
                        n_dec_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_head=16, d_ff=128, vocab=256, n_audio_ctx=32,
                        dtype=torch.float32, remat=False)
    else:
        cfg = EncDecCfg(name="whisper-base", n_enc_layers=6, n_dec_layers=6,
                        d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
                        d_ff=2048, vocab=51865, n_audio_ctx=1500, dtype=dtype)
    return ArchSpec(name="whisper-base", family="encdec", cfg=cfg,
                    input_mode="tokens", frontend_ctx=cfg.n_audio_ctx)
