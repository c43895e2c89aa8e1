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


# --- the CUDA kernel's arithmetic, emulated in plain torch ----------------
# csrc/decode_attention.cu cannot run here, so its order of summation and
# merging is replayed on the CPU in f32 (each fused multiply-add as a
# product then a sum: one rounding more than the kernel) and held against
# the JAX Pallas kernel in interpret mode.  One cluster of
# `ops.cluster_blocks(S)` blocks per (row, kv head, group of 4 query rows);
# each block an even share of the live band, each of its warps an even
# share of the block's, in steps of WK keys, with a running max per warp.
#   * bf16 (tensor cores; 4 warps, 16 keys a step): each score is two
#     chains of 16-wide k-step sums (even and odd k-steps) added; P is
#     split into bf16 hi + lo halves, each multiplied into the f32
#     accumulator (the tensor core sums in its own order: here a matrix
#     product); l per lane over keys g and g + 8, then pairwise over g.
#   * f32 (CUDA cores; 8 warps, WK <= 8): the lanes of a key group sum
#     their 16-byte chunks in order and meet in a pairwise tree (the
#     highest lane bit first); each key slot accumulates its keys' p and
#     p V, and the slots are summed pairwise (lowest slot bit first).
# The warps and then the blocks are merged with weights exp(m - M): L
# pairwise (lowest warp or block bit first; blocks u and u + 8 added in
# one lane first), the elements in warp, then block order.

KROWS = 4


def _layout(dh: int, itemsize: int):
    """Cfg<DH, T> of csrc/decode_attention.cu."""
    if itemsize == 2:
        return dict(nw=4, wk=16)
    row = dh * itemsize
    vec = 16 // itemsize
    ng = dh // vec
    lpk = min(ng, 32)
    kpw = 32 // lpk
    stages = 2 if row <= 256 else 1
    wk = max(kpw, min(8, 4096 // (row * stages)))
    return dict(nw=8, vec=vec, lpk=lpk, kpw=kpw, cpl=ng // lpk, wk=wk,
                u=wk // kpw)


def _pairwise(x: torch.Tensor, dim: int, high_first: bool) -> torch.Tensor:
    """Sum over `dim` (a power of two long) as a pairwise tree: pairs
    differing in the highest index bit first, or in the lowest."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:] if high_first else x[0::2] + x[1::2]
    return x[0]


def _warp_mma(qg, kk, vv, w0, w1, scale, split=True):
    """One warp of the tensor-core path: (m, l, acc) for rows 0..3; with
    split False, P is rounded to bf16 once."""
    Dh = qg.shape[1]
    m = torch.full((KROWS,), -np.inf)
    lg = torch.zeros(8, KROWS)                # per lane g: keys g, g + 8
    acc = torch.zeros(KROWS, Dh)
    for j0 in range(w0, w1, 16):
        nk = min(16, w1 - j0)
        kt = torch.zeros(16, Dh)
        vt = torch.zeros(16, Dh)
        kt[:nk], vt[:nk] = kk[j0:j0 + nk], vv[j0:j0 + nk]
        steps = (kt.reshape(16, Dh // 16, 16)[:, None]
                 * qg.reshape(KROWS, Dh // 16, 16)[None]).sum(-1)
        chains = [steps[..., c::2] for c in (0, 1)]    # (keys, rows, kd/2)
        sums = []
        for ch in chains:
            tot = torch.zeros(16, KROWS)
            for i in range(ch.shape[-1]):
                tot = tot + ch[..., i]
            sums.append(tot)
        sc = (sums[0] + sums[1]) * scale
        sc[nk:] = -np.inf
        m_new = torch.maximum(m, sc.max(0).values)
        alpha = torch.exp(m - m_new)
        m = m_new
        p = torch.exp(sc - m_new)                     # (16 keys, rows)
        lg = lg * alpha + (p[:8] + p[8:])
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float() if split else 0 * hi
        acc = acc * alpha[:, None] + hi.T @ vt + lo.T @ vt
    return m, _pairwise(lg, 0, False), acc


def _warp_fma(qg, kk, vv, w0, w1, scale, L):
    """One warp of the CUDA-core path: (m, l, acc) for rows 0..3."""
    Dh = qg.shape[1]
    vec, lpk, kpw, cpl, wk, u_n = (L[n] for n in ("vec", "lpk", "kpw",
                                                  "cpl", "wk", "u"))
    # element d = chunk * vec + e, chunk = c0 + i * lpk: lane c0 sums its
    # (i, e) terms in order
    lane_d = torch.tensor([[(c0 + i * lpk) * vec + e for i in range(cpl)
                            for e in range(vec)] for c0 in range(lpk)])
    m = torch.full((KROWS,), -np.inf)
    lsum = torch.zeros(kpw, KROWS)
    acc = torch.zeros(kpw, KROWS, Dh)
    for j0 in range(w0, w1, wk):
        nk = min(wk, w1 - j0)
        keys = torch.arange(wk)
        kt = kk[torch.clamp(j0 + keys, max=kk.shape[0] - 1)]
        vt = vv[torch.clamp(j0 + keys, max=kk.shape[0] - 1)]
        terms = qg[None, :, lane_d] * kt[:, None][:, :, lane_d]
        part = terms[..., 0]
        for t in range(1, terms.shape[-1]):
            part = part + terms[..., t]
        sc = _pairwise(part, 2, high_first=True) * scale
        sc = torch.where((keys < nk)[:, None], sc, -np.inf)
        m_new = torch.maximum(m, sc.max(0).values)
        alpha = torch.exp(m - m_new)
        m = m_new
        p = torch.exp(sc - m_new)                      # (wk, rows)
        lsum = lsum * alpha
        acc = acc * alpha[None, :, None]
        for jj in range(nk):                           # slot s: keys s U + u
            slot = jj // u_n
            lsum[slot] = lsum[slot] + p[jj]
            acc[slot] = acc[slot] + p[jj][:, None] * vt[jj]
    return m, _pairwise(lsum, 0, False), _pairwise(acc, 0, False)


def _emulate_decode(q, k, v, cache_len, window, itemsize, split=True):
    """q (B, Hq, Dh), k/v (B, S, Hkv, Dh) f32 tensors holding the kernel's
    inputs; returns the f32 output before its final rounding."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    L = _layout(Dh, itemsize)
    nw = L["nw"]
    nb = ops.cluster_blocks(S)
    scale = torch.tensor(1.0 / np.sqrt(Dh), dtype=torch.float32)
    out = torch.zeros(B, Hq, Dh)
    for b in range(B):
        n_live = int(cache_len[b])
        hi = min(n_live, S)
        lo = max(0, n_live - window) if window else 0
        n = max(0, hi - lo)
        for h in range(Hkv):
            for g in range(-(-rep // KROWS)):
                rows = min(KROWS, rep - g * KROWS)
                r0 = h * rep + g * KROWS
                qg = torch.zeros(KROWS, Dh)
                qg[:rows] = q[b, r0:r0 + rows]
                blocks = []
                for rank in range(nb):
                    k0 = lo + n * rank // nb
                    nbk = lo + n * (rank + 1) // nb - k0
                    warps = []
                    for w in range(nw):
                        w0 = k0 + nbk * w // nw
                        w1 = k0 + nbk * (w + 1) // nw
                        warps.append(
                            _warp_mma(qg, k[b, :, h], v[b, :, h], w0, w1,
                                      scale, split) if itemsize == 2 else
                            _warp_fma(qg, k[b, :, h], v[b, :, h], w0, w1,
                                      scale, L))
                    wm = torch.stack([x[0] for x in warps])     # (W, rows)
                    M = wm.max(0).values
                    wt = torch.where(torch.isfinite(M), torch.exp(wm - M),
                                     torch.zeros(()))
                    Lb = _pairwise(torch.stack([x[1] for x in warps]) * wt,
                                   0, False)
                    a = torch.zeros(KROWS, Dh)
                    for i, x in enumerate(warps):
                        a = a + x[2] * wt[i][:, None]
                    blocks.append((M, Lb, a))
                pad = 16 - nb
                bm = torch.stack([x[0] for x in blocks]
                                 + [torch.full((KROWS,), -np.inf)] * pad)
                bl = torch.stack([x[1] for x in blocks]
                                 + [torch.zeros(KROWS)] * pad)
                M = bm.max(0).values
                cw = torch.where(torch.isfinite(M), torch.exp(bm - M),
                                 torch.zeros(()))
                Lc = _pairwise(bl[8:] * cw[8:] + bl[:8] * cw[:8], 0, False)
                a = torch.zeros(KROWS, Dh)
                for u, x in enumerate(blocks):
                    a = a + x[2] * cw[u][:, None]
                o = torch.where(Lc[:, None] > 0, a / Lc[:, None],
                                torch.zeros(()))
                out[b, r0:r0 + rows] = o[:rows]
    return out


# (B, Hq, Hkv, Dh, S, cache_len per row, window): a window with per-row
# lengths (cache_len 0 and past S among them), rep 1 and 4, and a band of
# two steps per warp
EMU_CASES = [(4, 4, 1, 16, 32, [0, 8, 29, 40], 6),
             (4, 2, 2, 16, 32, [1, 32, 17, 5], None),
             (2, 4, 1, 32, 2048, [2000, 2048], None),
             (2, 4, 1, 32, 2048, [2000, 90], 1500)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", EMU_CASES)
def test_kernel_arithmetic_matches_jax_pallas(case, dtype):
    B, Hq, Hkv, Dh, S, lens, window = case
    rng = np.random.default_rng(S + Dh)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    tdt, jdt, size = {"f32": (torch.float32, jnp.float32, 4),
                      "bf16": (torch.bfloat16, jnp.bfloat16, 2)}[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(tdt).float() for x in (q, k, v))
    got = _emulate_decode(tq, tk, tv, lens, window, size).to(tdt).float()
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = jpallas(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                   block_k=min(S, 512), window=window, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = got.numpy()
    dead = [i for i, n in enumerate(lens) if n == 0]
    assert not got[dead].any() and not want[dead].any()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert bf16_ulps(got, want) <= 2


def test_one_bf16_p_would_miss_the_2_ulp_check():
    """Why the tensor-core path splits P into bf16 hi + lo: with P rounded
    to bf16 once, the same emulation leaves the 2-ulp band."""
    B, Hq, Hkv, Dh, S, lens, window = EMU_CASES[2]
    rng = np.random.default_rng(S + Dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16).float()
               for s in ((B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    want = tref(q, k, v, torch.tensor(lens), window=window).numpy()
    one = _emulate_decode(q, k, v, lens, window, 2, split=False)
    assert bf16_ulps(one.to(torch.bfloat16).float().numpy(), want) > 2
