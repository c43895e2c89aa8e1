"""Parity of the port's 2-D DCT and fused BDM update with the JAX package,
on CPU tensors (the plain versions; the CUDA kernels are held against them
on the card by chip_smoke.py and tests/test_torch_cuda.py).

Inputs are made with numpy from a seed.  The JAX side runs both its plain
reference (`dct_nd`, `bdm_ei_update_ref`) and its Pallas kernels in
interpret mode.

Tiers:
  * the DCT matrix: BITWISE (the same float64 numpy in both packages);
  * dct2 / idct2 / bdm_ei_update: max |port - jax| <= 1e-6 of max |x|.
    The sums run in different orders (torch's and XLA's matrix products,
    and the Pallas kernel multiplies along W first), so the results agree
    to f32 rounding, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dct2 import kernel as jkernel
from repro.kernels.dct2 import ref as jref
from repro.sde.base import dct_matrix as jdct_matrix
from repro_torch.kernels.dct2 import ops as tops
from repro_torch.sde.base import dct_matrix as tdct_matrix

SHAPES = [(2, 32, 32, 3), (2, 8, 8, 3)]
TOL = 1e-6


def _close(got, want, scale, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("n", [8, 32, 64])
def test_dct_matrix_bitwise(n):
    np.testing.assert_array_equal(tdct_matrix(n), jdct_matrix(n))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_dct2_matches_jax_and_pallas_interpret(shape, inverse):
    x = np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(np.float32)
    got = tops.dct2(torch.from_numpy(x), inverse=inverse).numpy()
    jx = jnp.asarray(x)
    want = (jref.idct2_ref if inverse else jref.dct2_ref)(jx)
    pallas = jkernel.dct2(jx, inverse=inverse, interpret=True)
    scale = float(np.abs(x).max())
    _close(got, want, scale, "vs JAX dct_nd")
    _close(got, pallas, scale, "vs Pallas interpret")
    # orthonormal: the inverse undoes the transform
    back = tops.dct2(torch.from_numpy(got), inverse=not inverse).numpy()
    _close(back, x, scale, "round trip")


@pytest.mark.parametrize("q", [1, 2])
def test_bdm_ei_update_matches_jax_and_pallas_interpret(q):
    rng = np.random.default_rng(q)
    B, H, W, Ch = 2, 8, 8, 3
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, eps = f32(B, H, W, Ch), f32(q, B, H, W, Ch)
    psi, C = f32(H, W, 1), f32(q, H, W, 1)
    got = tops.bdm_ei_update(*map(torch.from_numpy, (u, eps, psi, C)))
    jargs = [jnp.asarray(a) for a in (u, eps, psi, C)]
    want = jref.bdm_ei_update_ref(*jargs)
    pallas = jkernel.bdm_ei_update(*jargs, interpret=True)
    scale = float(np.abs(np.asarray(want)).max())
    _close(got.numpy(), want, scale, "vs JAX ref")
    _close(got.numpy(), pallas, scale, "vs Pallas interpret")


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """Dispatch is by device alone: a CPU tensor runs the plain version,
    and the kernel wrappers refuse anything but a CUDA tensor."""
    def boom(*a, **k):
        raise AssertionError("CPU tensors must not reach the kernel")

    x = torch.zeros(1, 8, 8, 3)
    monkeypatch.setattr(tops, "dct2_kernel", boom)
    monkeypatch.setattr(tops, "bdm_ei_update_kernel", boom)
    tops.dct2(x)
    tops.bdm_ei_update(x, x[None], torch.ones(8, 8, 1),
                       torch.ones(1, 8, 8, 1))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        tops.dct2_kernel(x)
    with pytest.raises(ValueError, match="CUDA"):
        tops.bdm_ei_update_kernel(x, x[None], torch.ones(8, 8, 1),
                                  torch.ones(1, 8, 8, 1))


@pytest.mark.parametrize("data_shape", [(16,), (16, 3)])
def test_non_image_shapes_are_refused(data_shape):
    """The wrappers take (B, H, W, Ch) images only, on either device, so a
    BDM over 1-D data has no second, plain DCT path in its engine hooks."""
    from repro_torch.sde.bdm import BDM
    sde = BDM(data_shape=data_shape)
    u = torch.zeros((2,) + data_shape)
    with pytest.raises(ValueError, match=r"\(B, H, W, Ch\)"):
        sde.canonicalize(u)
    with pytest.raises(ValueError, match=r"\(B, H, W, Ch\)"):
        tops.bdm_ei_update(u, u[None], torch.ones(16, 1), torch.ones(1, 16, 1))
    # to_freq stays on the plain dct_nd over the data's spatial axes
    assert sde.to_freq(u).shape == u.shape


# --- the CUDA dct2 kernel's arithmetic, emulated in plain torch -----------
# csrc/dct2.cu's dct2_kernel cannot run here, so its order of summation is
# replayed on the CPU in f32 (each fused multiply-add as a product then a
# sum) and held against the JAX package: Y = A X B^T with A = C_h, B^T =
# C_w^T (forward) or A = C_h^T, B^T = C_w (inverse); one block per (b,
# channel, band of output rows), min(H, 8) bands; each output's sum in
# four accumulators (term i into accumulator i mod 4), combined as (a0 +
# a1) + (a2 + a3).

def _band_rows(H: int) -> int:
    bands = min(H, 8)
    return -(-H // bands)


def _product4(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a (..., r, n) @ m (..., n, c) in the kernel's order."""
    acc = [torch.zeros(a.shape[:-1] + m.shape[-1:]) for _ in range(4)]
    for i in range(a.shape[-1]):
        acc[i % 4] = acc[i % 4] + a[..., :, i:i + 1] * m[..., i:i + 1, :]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _emulate_dct2(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    B, H, W, Ch = x.shape
    ch = torch.as_tensor(tdct_matrix(H), dtype=torch.float32)
    cw = torch.as_tensor(tdct_matrix(W), dtype=torch.float32)
    a, bt = (ch.T, cw) if inverse else (ch, cw.T)
    tiles = x.permute(0, 3, 1, 2)                     # (B, Ch, H, W)
    R = _band_rows(H)
    bands = [_product4(_product4(a[h0:h0 + R], tiles), bt)
             for h0 in range(0, H, R)]
    return torch.cat(bands, dim=2).permute(0, 2, 3, 1)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(1, 13, 20, 2)])
def test_kernel_arithmetic_matches_jax(shape, inverse):
    x = np.random.default_rng(sum(shape) + 1).standard_normal(shape) \
        .astype(np.float32)
    got = _emulate_dct2(torch.from_numpy(x), inverse).numpy()
    jx = jnp.asarray(x)
    scale = float(np.abs(x).max())
    _close(got, (jref.idct2_ref if inverse else jref.dct2_ref)(jx), scale,
           "vs JAX dct_nd")
    _close(got, jkernel.dct2(jx, inverse=inverse, interpret=True), scale,
           "vs Pallas interpret")


# --- the CUDA bdm_ei_update kernel's arithmetic, emulated in plain torch ---
# csrc/dct2.cu's bdm_ei_update_kernel, replayed on the CPU in f32 (each
# fused multiply-add as a product then a sum): a cluster of R =
# cluster_blocks(B * Ch, H, 132) blocks per (b, channel) tile (an H100's
# SMs; the split changes no bit), block r on output
# rows [r BR, r BR + BR); passes of up to 5 tiles; per pass the forward
# H-axis product over the panel [X_j0 | X_j0+1 | ...] (T = C_h[band] panel),
# then the W-axis step with the coefficients, y = psi * (T_0 C_w^T), then
# y + C_j * (T_j C_w^T) left to right; the inverse Z[band] = Y[band] C_w,
# gathered from every band, and out[band] = C_h^T[band] Z.  Every output
# of every product is one multiply-add chain over the sum index in order
# (a thread's patch of outputs is several such chains side by side).

def _chain(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a (..., r, n) @ m (..., n, c), one chain per output, term i in
    order."""
    acc = a[..., :, :1] * m[..., :1, :]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., :, i:i + 1] * m[..., i:i + 1, :]
    return acc


def _emulate_bdm(u, eps, psi, C, max_pass: int = 5) -> torch.Tensor:
    B, H, W, Ch = u.shape
    ch = torch.as_tensor(tdct_matrix(H), dtype=torch.float32)
    cw = torch.as_tensor(tdct_matrix(W), dtype=torch.float32)
    tiles = torch.cat([u[None], eps]).permute(0, 1, 4, 2, 3)  # (q+1,B,Ch,H,W)
    coefs = torch.cat([psi[None], C])[..., 0]                  # (q+1, H, W)
    R = tops.cluster_blocks(B * Ch, H, 132)
    BR = -(-H // R)
    bands = [(h0, min(h0 + BR, H)) for h0 in range(0, H, BR)]
    z = []
    for h0, h1 in bands:
        y = None
        for j0 in range(0, len(tiles), max_pass):
            js = range(j0, min(j0 + max_pass, len(tiles)))
            panel = torch.cat([tiles[j] for j in js], dim=-1)  # (B,Ch,H,nW)
            t = _chain(ch[h0:h1], panel)
            for k, j in enumerate(js):
                v = _chain(t[..., k * W:(k + 1) * W], cw.T) * coefs[j, h0:h1]
                y = v if y is None else y + v
        z.append(_chain(y, cw))
    z = torch.cat(z, dim=-2)
    out = torch.cat([_chain(ch.T[h0:h1], z) for h0, h1 in bands], dim=-2)
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape,q", [(s, q) for s in [(1, 32, 32, 3),
                                                      (2, 13, 20, 2)]
                                     for q in range(5)]
                         + [((2, 13, 20, 2), 6)])
def test_bdm_kernel_arithmetic_matches_jax(shape, q):
    rng = np.random.default_rng(sum(shape) + q)
    B, H, W, Ch = shape
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, eps = f32(*shape), f32(q, *shape)
    psi, C = f32(H, W, 1), f32(q, H, W, 1)
    got = _emulate_bdm(*map(torch.from_numpy, (u, eps, psi, C))).numpy()
    want = jref.bdm_ei_update_ref(*map(jnp.asarray, (u, eps, psi, C)))
    if q == 0:
        # the Pallas kernel takes no zero-sized block: one zero eps row
        # with a zero coefficient adds +0 to every frequency, the same
        # function of u and psi
        eps, C = np.zeros((1,) + shape, np.float32), np.zeros((1, H, W, 1),
                                                              np.float32)
    pallas = jkernel.bdm_ei_update(*map(jnp.asarray, (u, eps, psi, C)),
                                   interpret=True)
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, scale, "vs JAX ref")
    _close(got, pallas, scale, "vs Pallas interpret")


def test_cluster_blocks_fill_the_card():
    """A power of two, at most 8 and at most H; on an H100's 132 SMs, 8 at
    the engine's 12 tiles, 1 at path A's 192."""
    assert tops.cluster_blocks(12, 32, 132) == 8
    assert tops.cluster_blocks(192, 32, 132) == 1
    assert tops.cluster_blocks(12, 32, 48) == 4
    for tiles in (1, 3, 12, 48, 66, 132, 192, 264, 1000):
        for H in (1, 2, 3, 8, 13, 32, 64):
            R = tops.cluster_blocks(tiles, H, 132)
            assert R & (R - 1) == 0 and 1 <= R <= min(8, H)
