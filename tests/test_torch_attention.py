"""Parity of the port's attention with the JAX package's, in the forms
the CUDA kernel covers: non-causal (the DiT; cross-attention with Sq != Sk,
GQA, a window and q_offset) and causal with a window, GQA, q_offset and Sq
!= Sk (LM prefill), and the non-causal gradient through `FlashAttention`.

The port's plain version is held against JAX's `attention_ref` and the
Pallas `flash_attention(..., interpret=True)` on the CPU.  Tier: f32,
rtol = atol = 2e-6 (values of order 1; dense softmax vs online softmax
differ only in summation order); bf16 inputs compare after the f32
softmax and the final cast, within one bf16 ulp (rtol 8e-3).  The CUDA
kernel is held against the plain version on the card, by
tests/test_torch_cuda.py and by chip_smoke.py at the DiT's full shapes;
here a torch emulation of its bf16 tensor-core arithmetic (the split P)
is held within 2 bf16 ulp of the plain version and the Pallas kernel.
"""
import math

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


# the non-causal general form (cross-attention): Sq != Sk with a ragged
# key count, GQA, a window and q_offset (rep, window, q_offset)
CROSS_CASES = [(1, None, 0), (4, None, 0), (2, 6, 9), (4, 5, 0)]


def _cross_inputs(rep, seed, sq=5, sk=37):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 4 // rep, 16)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("rep,window,q_offset", CROSS_CASES)
def test_plain_cross_attention_matches_jax_ref(rep, window, q_offset):
    """5 queries over 37 keys, the window counted from query position
    q_offset + i (keys in (q_pos - window, Sk): no causal bound)."""
    q, k, v = _cross_inputs(rep, seed=rep + (window or 0))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                        window=window, q_offset=q_offset)
    want = np.asarray(jref(*map(jnp.asarray, (q, k, v)), causal=False,
                           window=window, q_offset=q_offset))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_plain_cross_attention_matches_jax_pallas_interpret():
    """The Pallas kernel's non-causal form at Sk = 40 (a multiple of its
    key block: at whisper's Sk = 1500 it refuses, F13), GQA rep 2, window
    6, q_offset 9."""
    q, k, v = _cross_inputs(2, seed=1, sq=8, sk=40)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                        window=6, q_offset=9)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), q_offset=9,
                             causal=False, window=6, block_q=4, block_k=8,
                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("rep", [1, 4])
def test_cross_attention_gradient_matches_jax(rep):
    """The non-causal form with a gradient (Sq 5 != Sk 37, GQA) runs
    `FlashAttention` on the CPU too (forward `attention_ref`, backward
    `attention_bwd_ref`): dq, dk, dv within 1e-5 of each gradient's max
    |g| of `jax.vjp` through the JAX package's `attention_ref`."""
    q, k, v = _cross_inputs(rep, seed=20 + rep)
    do = np.random.default_rng(rep).standard_normal(q.shape).astype(
        np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.attention(*leaves, causal=False)
    assert "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    want = jax.jit(lambda *a: jax.vjp(lambda x, y, z: attention_ref(
        x, y, z, causal=False), *a[:3])[1](a[3]))(q, k, v, do)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * np.abs(w).max()


def test_mixed_dtypes_compute_in_f32_and_return_q_dtype():
    """bf16 queries over f32 keys and values (the encoder-decoder's decode
    step over its f32 memory): computed in f32, returned in bf16, within
    one bf16 ulp of JAX's `attention_ref` on the same dtypes (f32 sums in
    another order, one rounding to bf16)."""
    q, k, v = _cross_inputs(1, seed=30)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = ops.attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                        causal=False)
    want = jref(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
                causal=False)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _bf16_ulps(got, torch.from_numpy(
        np.asarray(want.astype(jnp.float32)))) <= 1


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
    with pytest.raises(ValueError):
        ops.flash_attention_cross(x, x, x)


# ---- the numerical design of the bf16 tensor-core kernel -------------------
# A torch emulation of the kernel's arithmetic (never called by any path):
# bf16 q and k with f32 scores, 64-key tiles with the online rescale in
# exp2 form, and P V with P split into bf16 hi and lo halves, each product
# summed in f32.  Held within 2 bf16 ulp, the card tests' and chip_smoke's
# tolerance, of the plain version and of the Pallas kernel; with P rounded
# to one bf16 instead, the same inputs exceed 2 ulp: the reason the kernel
# splits P.

# (q shape, k shape, causal, window, q_offset, Pallas block_q): a DiT-like
# case (two key tiles) and a causal/window/GQA case (rep 4, q_offset 16,
# every row keeping its own key)
TC_CASES = {"dit": ((2, 128, 2, 64), (2, 128, 2, 64), False, None, 0, 64),
            "causal": ((1, 96, 4, 32), (1, 128, 1, 32), True, 40, 16, 32)}


def _tc_emulation(q, k, v, *, causal, window, q_offset, split, tile=64):
    B, Sq, Hq, Dh = q.shape
    Sk, rep = k.shape[1], Hq // k.shape[2]
    sl2 = math.log2(math.e) / math.sqrt(Dh)
    qf = q.float().transpose(1, 2)                          # (B, Hq, Sq, Dh)
    kf, vf = (x.float().transpose(1, 2).repeat_interleave(rep, 1)
              for x in (k, v))
    m = torch.full((B, Hq, Sq, 1), -math.inf)
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, Dh)
    q_pos = q_offset + torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)   # f32 sums
        k_pos = torch.arange(k0, min(k0 + tile, Sk))[None]
        keep = torch.ones_like(k_pos <= q_pos)
        if causal:
            keep &= k_pos <= q_pos
        if window is not None:
            keep &= k_pos > q_pos - window
        s = s.masked_fill(~keep, -math.inf)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(mx == -math.inf, 0.0, mx * sl2)
        alpha = torch.exp2(m * sl2 - mu)
        p = torch.exp2(s * sl2 - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + tile]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + tile]
        acc = acc * alpha + pv
        m = mx
    o = acc / torch.where(l == 0, 1.0, l)
    return o.transpose(1, 2).bfloat16()


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of want at max(|want|, max|want| /
    1024), the measure of chip_smoke.py's ulp_err."""
    w = want.float()
    _, e = torch.frexp(w.abs().clamp_min(float(w.abs().max()) / 1024))
    return float(((got.float() - w).abs() / torch.ldexp(torch.ones_like(w),
                                                          e - 8)).max())


def _tc_inputs(case):
    qs, ks, causal, window, q_off, bq = TC_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in (qs, ks, ks))
    return q, k, v, dict(causal=causal, window=window, q_offset=q_off), bq


@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_arithmetic_within_2_ulp(case):
    q, k, v, kw, bq = _tc_inputs(case)
    got = _tc_emulation(q, k, v, split=True, **kw)
    assert _bf16_ulps(got, tref(q, k, v, **kw)) <= 2
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v))
    want = jflash(jq, jk, jv, block_q=bq, block_k=64, interpret=True, **kw)
    assert _bf16_ulps(got, torch.from_numpy(
        np.array(want.astype(jnp.float32)))) <= 2


@pytest.mark.parametrize("case", list(TC_CASES))
def test_single_bf16_p_exceeds_2_ulp(case):
    q, k, v, kw, _ = _tc_inputs(case)
    got = _tc_emulation(q, k, v, split=False, **kw)
    assert _bf16_ulps(got, tref(q, k, v, **kw)) > 2
