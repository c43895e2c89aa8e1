"""Parity of the port's attention with the JAX package's, in the two forms
the CUDA kernel covers: non-causal (the DiT) and causal with a window, GQA,
q_offset and Sq != Sk (LM prefill).

The port's plain version is held against JAX's `attention_ref` and the
Pallas `flash_attention(..., interpret=True)` on the CPU.  Tier: f32,
rtol = atol = 2e-6 (values of order 1; dense softmax vs online softmax
differ only in summation order); bf16 inputs compare after the f32
softmax and the final cast, within one bf16 ulp (rtol 8e-3).  The CUDA
kernel is held against the plain version on the card, by
tests/test_torch_cuda.py and by chip_smoke.py at the DiT's full shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.kernel import flash_attention as jflash
from repro.kernels.attention.ref import attention_ref
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import attention_ref as tref

jref = jax.jit(attention_ref, static_argnames=("causal", "window"))

# (B, S, H, Dh): the reduced DiT (4 tokens, d_head 32), a ragged S, and a
# full-width head (d_head 64)
SHAPES = [(3, 4, 2, 32), (2, 24, 3, 32), (1, 64, 2, 64)]


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_attention_matches_jax_ref(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = np.asarray(jref(*map(jnp.asarray, (q, k, v)), causal=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_plain_attention_matches_jax_pallas_interpret(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=False,
                             block_q=8, block_k=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_plain_attention_bf16_matches_jax_ref():
    q, k, v = _qkv((2, 16, 2, 64), seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.attention(tq, tk, tv, causal=False)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jref(jq, jk, jv, causal=False).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=8e-3)


def test_plain_attention_masks_match_jax():
    """The plain version keeps the reference's causal/window/GQA forms."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    for kw in (dict(causal=True), dict(causal=True, window=3),
               dict(causal=False, window=2)):
        got = tref(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
        want = np.asarray(jref(*map(jnp.asarray, (q, k, v)), **kw))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("q_offset", [0, 9])
def test_plain_causal_attention_matches_jax_pallas_interpret(q_offset, window,
                                                             rep):
    """The LM prefill form: 12 queries at absolute positions q_offset ..
    q_offset + 11 over a 32-key cache (Sq != Sk, the tail beyond the last
    query hidden by the causal mask alone), Hq 4 over Hkv 4 / rep or the
    MQA Hkv 1, window none or 6 (keys in (q_pos - 6, q_pos]).  Pallas
    blocks of 4 x 8, so whole key blocks are skipped; every row keeps at
    least its own key."""
    rng = np.random.default_rng(q_offset + rep + (window or 0))
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 4 // rep, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 4 // rep, 16)).astype(np.float32)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=window, q_offset=q_offset)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)),
                             q_offset=q_offset, causal=True, window=window,
                             block_q=4, block_k=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    # a device-scalar q_offset gives the same numbers as the int
    got_t = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          window=window, q_offset=torch.tensor(q_offset))
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


def test_kernel_refuses_what_it_does_not_cover():
    """Dispatch never guesses: a tensor that is neither on the CPU nor on a
    card is refused, and the kernel wrapper refuses a CPU tensor rather
    than computing on it (no card needed)."""
    q = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError):
        ops.attention(q, q, q, causal=False)     # neither cpu nor cuda
    x = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(x, x, x)             # a CPU tensor is no kernel input
    with pytest.raises(ValueError):
        ops.flash_attention_causal(x, x, x)      # either form
