"""Parity of the port's fused EI update and factored coefficient apply with
the JAX package, on CPU tensors (the plain versions; the CUDA kernels are
held against them on the card by chip_smoke.py and tests/test_torch_cuda.py).

Inputs are made with numpy from a seed, at the shapes and dtypes of
tests/test_kernels.py.  The JAX side runs its plain references
(`ei_update_ref`, `apply_factored_ref`) and, on one shape each, its Pallas
kernels in interpret mode.

Tiers:
  * apply_factored: BITWISE against the JAX reference for k = 1 (one
    product per element); for k = 2 within one f32 rounding (2 ulp of the
    sum's scale): the port sums the two terms as separate products and an
    add, the JAX reference's einsum may contract them into a fused
    multiply-add.  Within 1e-6 of the dense one-einsum oracle
    `apply_packed`;
  * ei_update: within the JAX file's `tol(dtype)` (f32 2e-5, bf16 2e-2):
    the JAX reference sums with two einsums in another order;
  * the packing layer (`pad_channels`, `pack_state`, `unpack_state`):
    BITWISE (pure data movement).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ei_update import kernel as jkernel
from repro.kernels.ei_update import ops as jops
from repro.kernels.ei_update.ref import apply_factored_ref as japply_ref
from repro.kernels.ei_update.ref import ei_update_ref as jei_ref
from repro_torch.kernels.ei_update import ops as tops
from repro_torch.kernels.round_fused import ref as trf_ref

EI_CASES = [(2, 1, 128, 1), (2, 1, 2048, 3), (3, 2, 300, 2), (1, 2, 4096, 4)]
AF_CASES = [(2, 1, 128), (2, 1, 2048), (3, 2, 300), (1, 2, 4096)]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def tol(dtype: str):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _ei_inputs(B, k, D, q, dtype, seed=3):
    """numpy inputs; u and eps rounded to the working dtype first, so both
    packages start from the same values."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][1]
    u = torch.from_numpy(rng.standard_normal((B, k, D)).astype(np.float32))
    eh = torch.from_numpy(
        rng.standard_normal((q, B, k, D)).astype(np.float32))
    u, eh = u.to(tdt), eh.to(tdt)
    psi = rng.standard_normal((k, k)).astype(np.float32)
    C = rng.standard_normal((q, k, k)).astype(np.float32)
    return u, eh, psi, C


def _jax(t: torch.Tensor, dtype: str):
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][2])


def _ei_check(B, k, D, q, dtype, pallas: bool, form: str = "tensor"):
    """The port's ei_update with the history as one (q, B, k, D) tensor or
    as a list of q separate (B, k, D) rows, against the JAX reference (and
    the Pallas kernel) on the stacked JAX array."""
    u, eh, psi, C = _ei_inputs(B, k, D, q, dtype)
    hist = eh if form == "tensor" else [eh[j].clone() for j in range(q)]
    got = tops.ei_update(u, hist, torch.from_numpy(psi), torch.from_numpy(C))
    assert got.dtype == u.dtype and got.shape == (B, k, D)
    ju, jeh = _jax(u, dtype), _jax(eh, dtype)
    want = jei_ref(ju, jeh, jnp.asarray(psi), jnp.asarray(C))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))
    if pallas:
        pal = jkernel.ei_update(ju, jeh, jnp.asarray(psi), jnp.asarray(C),
                                block_d=256, interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(pal, np.float32), **tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,k,D,q", EI_CASES)
def test_ei_update_matches_jax_ref(B, k, D, q, dtype):
    _ei_check(B, k, D, q, dtype, pallas=False)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ei_update_matches_pallas_interpret(dtype):
    _ei_check(3, 2, 300, 2, dtype, pallas=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,k,D,q", EI_CASES)
def test_ei_update_rows_match_jax_ref(B, k, D, q, dtype):
    """The history as a list of rows, as the sampler passes it."""
    _ei_check(B, k, D, q, dtype, pallas=False, form="list")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ei_update_rows_match_pallas_interpret(dtype):
    _ei_check(3, 2, 300, 2, dtype, pallas=True, form="list")


def _bad_history(fault: str, form: str, B=2, k=2, D=16, q=2):
    """A history that the wrapper must refuse: one row strided, of another
    dtype or of another shape; as a tensor or as a list of rows."""
    if fault == "strided":
        wide = torch.zeros(q, B, k, 2 * D)
        return wide[..., ::2] if form == "tensor" else list(wide[..., ::2])
    if fault == "dtype":
        eh = torch.zeros(q, B, k, D, dtype=torch.float64)
        return eh if form == "tensor" else [torch.zeros(B, k, D),
                                            eh[1]]
    eh = torch.zeros(q, B, k, D + 1)
    return eh if form == "tensor" else [torch.zeros(B, k, D), eh[1]]


@pytest.mark.parametrize("form", ["tensor", "list"])
@pytest.mark.parametrize("fault,exc", [("strided", ValueError),
                                       ("dtype", TypeError),
                                       ("shape", ValueError)])
def test_ei_update_refuses_bad_rows(fault, exc, form):
    """Rows go to the kernel by address, so the wrapper refuses a strided
    row, a row of another dtype and a row of another shape (the same check
    runs before the plain version on the CPU)."""
    u = torch.zeros(2, 2, 16)
    with pytest.raises(exc):
        tops.ei_update(u, _bad_history(fault, form), torch.eye(2),
                       torch.zeros(2, 2, 2))
    with pytest.raises(ValueError):                      # q = 5 > 4
        tops.ei_update(u, [torch.zeros(2, 2, 16)] * 5, torch.eye(2),
                       torch.zeros(5, 2, 2))


@pytest.mark.parametrize("source", ["randn", "net"])
@pytest.mark.parametrize("name", ["cifar10-ddpm", "cifar10-cld"])
def test_gddim_update_passes_the_rows_uncopied(name, source, monkeypatch):
    """`core.gddim._update` on VPSDE and CLD hands ei_update the sampler's
    eps tensors themselves (packed views sharing their storage, no stack),
    with the stacked call's result bitwise: on random rows and on path A's
    rows, the score net's outputs (the DiT returns them contiguous, in the
    state's layout).  A strided eps is made contiguous first, with the same
    result."""
    from repro_torch.configs import get_diffusion
    from repro_torch.core import gddim, time_grid
    spec = get_diffusion(name, reduced=True)
    sde, k, q = spec.sde, spec.sde.packed_k, 2
    g = torch.Generator().manual_seed(k)
    shape = (3,) + sde.state_shape(spec.data_shape)
    u = torch.randn(shape, generator=g)
    if source == "net":
        net = spec.init(seed=0, device="cpu")
        with torch.no_grad():
            net.patch_out.normal_(generator=g)   # zero-init: eps would be 0
            eps_fn = spec.make_eps_fn(net, time_grid(sde, 4))
            eps = [eps_fn(u, i) for i in (1, 2)]
        assert float(eps[0].abs().max()) > 0.1
    else:
        eps = [torch.randn(shape, generator=g) for _ in range(q)]
    assert all(e.is_contiguous() and e.shape == shape for e in eps)
    psi, C = torch.randn(k, k, generator=g), torch.randn(q, k, k, generator=g)
    seen = []

    def spy(z, rows, psi_, C_):
        seen.append(rows)
        return tops.ei_update(z, rows, psi_, C_)

    monkeypatch.setattr(gddim, "ei_update", spy)
    z, _ = tops.pack_state(u, k)

    def stacked(rows):
        return tops.unpack_state(tops.ei_update(z, torch.stack(
            [e.reshape(z.shape) for e in rows]), psi, C), shape)

    got = gddim._update(sde, u, eps, psi, C)
    assert isinstance(seen[0], list) and len(seen[0]) == q
    assert [r.data_ptr() for r in seen[0]] == [e.data_ptr() for e in eps]
    assert torch.equal(got, stacked(eps))
    strided = [eps[0], torch.randn(shape[::-1], generator=g).permute(
        *range(len(shape) - 1, -1, -1))]
    assert not strided[1].is_contiguous()
    assert torch.equal(gddim._update(sde, u, strided, psi, C),
                       stacked(strided))


def _af_inputs(B, k, D, seed=11):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, k, D)).astype(np.float32)
    blk = rng.standard_normal((B, k, k)).astype(np.float32)
    diag = rng.standard_normal((B, D)).astype(np.float32)
    return z, blk, diag


def _f32_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in f32 ulps of the output's largest value."""
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / float(np.spacing(np.float32(
        scale)))


@pytest.mark.parametrize("B,k,D", AF_CASES)
def test_apply_factored_matches_jax_ref(B, k, D):
    z, blk, diag = _af_inputs(B, k, D)
    got = tops.apply_factored(torch.from_numpy(blk), torch.from_numpy(diag),
                              torch.from_numpy(z)).numpy()
    want = np.asarray(japply_ref(jnp.asarray(blk), jnp.asarray(diag),
                                 jnp.asarray(z)))
    if k == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _f32_ulps(got, want) <= 2
    # the dense one-einsum oracle
    dense = torch.from_numpy(blk)[..., None] * torch.from_numpy(diag)[
        :, None, None, :]
    np.testing.assert_allclose(
        tops.apply_packed(dense, torch.from_numpy(z)).numpy(), got,
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_apply_factored_matches_pallas_interpret(dtype):
    """The JAX file's form: bf16 z and diag against f32 blocks (f32 inputs
    are held to the JAX reference above)."""
    B, k, D = 3, 2, 300
    z, blk, diag = _af_inputs(B, k, D)
    tdt = DTYPES[dtype][1]
    tz, tdiag = torch.from_numpy(z).to(tdt), torch.from_numpy(diag).to(tdt)
    got = tops.apply_factored(torch.from_numpy(blk), tdiag, tz).float()
    jz, jdiag = _jax(tz, dtype), _jax(tdiag, dtype)
    pal = jkernel.apply_factored(jnp.asarray(blk), jdiag, jz, block_d=256,
                                 interpret=True)
    want = japply_ref(jnp.asarray(blk), jdiag, jz)
    for ref in (pal, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                                   **tol(dtype))


def test_packing_layer_matches_jax():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((3, 2, 4, 4, 3)).astype(np.float32)
    tz, shape = tops.pack_state(torch.from_numpy(u), 2, k_pad=3)
    jz, jshape = jops.pack_state(jnp.asarray(u), 2, k_pad=3)
    assert shape == tuple(jshape) and tz.shape == (3, 3, 48)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(
        tops.unpack_state(tz, shape, k=2).numpy(),
        np.asarray(jops.unpack_state(jz, jshape, k=2)))
    assert torch.equal(tops.pad_channels(tz, 3), tz)
    with pytest.raises(ValueError):
        tops.pad_channels(tz, 2)
    # round_fused's plain chain uses this module's pieces, no copy of them
    assert trf_ref.pad_channels is tops.pad_channels
    assert trf_ref.apply_factored_ref is tops.apply_factored_ref


def test_ei_update_is_the_gddim_step():
    """One ei_update call on the packed state equals one sample_gddim
    predictor step on CLD (q = 2, warm start), on the exact-score oracle.
    K_t = L_t (Cholesky) spares the R_t grid solve; the step's form is the
    same for any K_t."""
    from repro_torch import random as prng
    from repro_torch.core import build_sampler_coeffs, time_grid
    from repro_torch.sde import CLD, ExactScore, GaussianMixture
    sde = CLD(grid_substeps=1)
    ts = time_grid(sde, 6)
    co = build_sampler_coeffs(sde, ts, q=2, kt="L")
    mix = GaussianMixture(np.array([[0.4, -0.2]]), np.array([0.05]),
                          np.array([1.0]))
    eps_fn, _ = ExactScore(sde, mix).eps_fn_for_grid(ts, sde.L_np)
    u = sde.prior_sample(prng.PRNGKey(0), 4, (2,))          # (B, 2, 2)
    N = co.psi.shape[0]
    e0 = eps_fn(u, N)
    hist = torch.stack([e0, torch.zeros_like(e0)])          # q=2, warm start
    u_ref = sde.apply(co.psi[0], u) + sde.apply(co.pC[0, 0], hist[0]) \
        + sde.apply(co.pC[0, 1], hist[1])
    up, shape = tops.pack_state(u, 2)
    ep = torch.stack([tops.pack_state(h, 2)[0] for h in hist])
    out = tops.unpack_state(tops.ei_update(up, ep, co.psi[0], co.pC[0]),
                            shape)
    np.testing.assert_allclose(out.numpy(), u_ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """Dispatch is by device alone: CPU tensors run the plain versions and
    the kernel wrappers are not called."""
    def boom(*a, **k):
        raise AssertionError("CPU tensors must not reach the kernel")

    monkeypatch.setattr(tops, "ei_update_kernel", boom)
    monkeypatch.setattr(tops, "apply_factored_kernel", boom)
    u, eh, psi, C = _ei_inputs(2, 2, 16, 2, "float32")
    tops.ei_update(u, eh, torch.from_numpy(psi), torch.from_numpy(C))
    z, blk, diag = _af_inputs(2, 2, 16)
    tops.apply_factored(torch.from_numpy(blk), torch.from_numpy(diag),
                        torch.from_numpy(z))
