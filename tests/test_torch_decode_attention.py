"""Parity of the port's decode attention (its plain version, which CPU
tensors run) with the JAX package's: the Pallas `decode_attention` kernel
in interpret mode (block_k 8, so whole blocks are skipped) and
`decode_attention_ref`.

One call covers four valid lengths at once: per-row `cache_len` = 1, 8 (a
block edge), 5 (below the window of 6) and 29 (above it, and above the
block edges); the scalar form uses 13 for every row.  Window none or 6;
rep 1 (Hq == Hkv == 2) and 4 (MQA, Hkv 1); f32 and bf16.

Tiers: f32 within 1e-5 absolute (values of order 1; dense softmax against
the online form differ only in summation order); bf16 within 2 bf16 ulp of
the output (both sides compute in f32 and round once at the end).  The
CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention as jpallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref as tref

jref = jax.jit(decode_attention_ref, static_argnames=("window",))

B, S, DH = 4, 32, 16
PER_ROW = np.array([1, 8, 5, 29], np.int32)
SCALAR = 13


def _inputs(rep, seed):
    hkv = 2 if rep == 1 else 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, hkv * rep, DH)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, DH)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, DH)).astype(np.float32)
    return q, k, v


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in bf16 ulps of want, the ulp taken at
    max(|want|, max|want| / 1024) so a value next to zero does not read as
    millions."""
    floor = np.abs(want).max() / 1024
    mag = np.maximum(np.abs(want), floor)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
def test_plain_decode_attention_matches_jax(per_row, window, rep, dtype):
    q, k, v = _inputs(rep, seed=rep * 10 + (window or 0))
    cl = PER_ROW if per_row else np.int32(SCALAR)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(np.asarray(cl)),
                               window=window)
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    for want in (jref(jq, jk, jv, jnp.asarray(cl), window=window),
                 jpallas(jq, jk, jv, jnp.asarray(cl), block_k=8,
                         window=window, interpret=True)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(want).max() > 0.1
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert bf16_ulps(got, want) <= 2


def test_masked_rows_give_zero_and_python_scalars_work():
    """cache_len 0 masks every key: the row is 0, not NaN (the reference's
    isfinite guard); a Python int cache_len is the scalar form."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, seed=0))
    out = tref(q, k, v, torch.tensor([0, 3, 0, 9]))
    assert torch.isfinite(out).all()
    assert not out[[0, 2]].any() and out[[1, 3]].abs().max() > 0.1
    torch.testing.assert_close(
        ops.decode_attention(q, k, v, 11, window=4),
        tref(q, k, v, torch.full((B,), 11), window=4),
        rtol=0, atol=0)


def test_cuda_kernel_wrapper_refuses_cpu_tensors():
    """Dispatch never guesses: the kernel wrapper refuses a CPU tensor
    rather than computing on it (no card needed), and a device that is
    neither cpu nor cuda is refused by the dispatch."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, seed=0))
    with pytest.raises(ValueError):
        ops.decode_attention_kernel(q, k, v, torch.tensor(PER_ROW))
    m = torch.empty((B, 4, DH), device="meta")
    with pytest.raises(ValueError):
        ops.decode_attention(m, m, m, 3)
