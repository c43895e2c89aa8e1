"""Linear-SDE substrate for gDDIM (Zhang, Tao & Chen, ICLR 2023).

Every diffusion model in the paper is a linear SDE

    du = F_t u dt + G_t dw,   t in [0, T]                      (paper Eq. 1)

whose coefficient matrices are structured: scalar multiples of the identity
(VPSDE), 2x2 channel blocks (CLD), or diagonal in a DCT basis (BDM).  Each
family gives

  * host-side float64 algebra (`CoeffOps`: compose / invert / transpose /
    sqrt / Cholesky) used by the offline Stage-I pipeline (paper App. C.3),
    in numpy, and
  * device-side application of a coefficient to a batched state, in torch.

Coefficient shapes per family:

  scalar   : ()          applied as  c * u
  block    : (k, k)      applied as  einsum('ij,bj...->bi...') (CLD: k = 2,
                         the channel axis right after batch)
  freqdiag : freq_shape  applied as  IDCT(c * DCT(u)) over the spatial axes
                         (BDM)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from .. import random as prng

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Host-side coefficient algebra (numpy, float64).
# ---------------------------------------------------------------------------
class CoeffOps:
    """Family-specific algebra over structured coefficients: numpy float64
    arrays of the family's coeff shape, possibly with leading stack axes."""

    family: str = "abstract"

    def mul(self, a, b):            # matrix product a @ b
        raise NotImplementedError

    def add(self, a, b):
        return a + b

    def scale(self, s, a):
        return s * a

    def inv(self, a):
        raise NotImplementedError

    def transpose(self, a):
        raise NotImplementedError

    def sqrt_psd(self, a):
        """Symmetric PSD square root (principal)."""
        raise NotImplementedError

    def chol(self, a):
        """Lower-triangular Cholesky factor (paper's L_t for CLD, Eq. 78)."""
        raise NotImplementedError

    def eye(self):
        raise NotImplementedError

    def zeros(self):
        raise NotImplementedError


class ScalarOps(CoeffOps):
    family = "scalar"

    def mul(self, a, b):
        return a * b

    def inv(self, a):
        return 1.0 / a

    def transpose(self, a):
        return a

    def sqrt_psd(self, a):
        return np.sqrt(a)

    chol = sqrt_psd

    def eye(self):
        return np.float64(1.0)

    def zeros(self):
        return np.float64(0.0)


class BlockOps(CoeffOps):
    """k x k channel-block coefficients (CLD: k=2, channels (x, v))."""

    family = "block"

    def __init__(self, k: int = 2):
        self.k = k

    def mul(self, a, b):
        return a @ b

    def inv(self, a):
        return np.linalg.inv(a)

    def transpose(self, a):
        return np.swapaxes(a, -1, -2)

    def sqrt_psd(self, a):
        w, v = np.linalg.eigh(a)
        w = np.clip(w, 0.0, None)
        return (v * np.sqrt(w)[..., None, :]) @ np.swapaxes(v, -1, -2)

    def chol(self, a):
        # Guard tiny negative eigenvalues from round-off.
        jitter = 1e-30 * np.eye(self.k)
        return np.linalg.cholesky(a + jitter)

    def eye(self):
        return np.eye(self.k)

    def zeros(self):
        return np.zeros((self.k, self.k))


class FreqDiagOps(CoeffOps):
    """Diagonal-in-DCT-basis coefficients (BDM): arrays broadcastable
    against the frequency grid `freq_shape` (the data's spatial dims, with
    a trailing 1 for the channel axis)."""

    family = "freqdiag"

    def __init__(self, freq_shape: Tuple[int, ...]):
        self.freq_shape = tuple(freq_shape)

    def mul(self, a, b):
        return a * b

    def inv(self, a):
        return 1.0 / a

    def transpose(self, a):
        return a

    def sqrt_psd(self, a):
        return np.sqrt(a)

    chol = sqrt_psd

    def eye(self):
        return np.ones(self.freq_shape)

    def zeros(self):
        return np.zeros(self.freq_shape)


def _apply_factored_canonical(blk, diag, z: Tensor) -> Tensor:
    """The factored-coefficient core on a canonical (B, kf, D) state: the
    block contraction as one multiply-reduce over a broadcast of the block
    factor, then the diagonal elementwise.  Every family's
    `apply_factored` routes through this one implementation, so the
    factored form has a single arithmetic (the form of the dense einsum it
    replaced)."""
    kf = z.shape[1]
    blk = torch.as_tensor(blk, dtype=z.dtype, device=z.device)[:kf, :kf]
    coeff = blk[None, :, :, None].expand(z.shape[0], kf, kf, z.shape[-1])
    out = (coeff * z[:, None, :, :]).sum(dim=2)
    return out * torch.as_tensor(diag, dtype=z.dtype,
                                 device=z.device)[None, None, :]


def family_name(sde) -> str:
    """Canonical short name of an SDE family instance ('vpsde' | 'cld' |
    'bdm'): the request-surface key of multi-family serving."""
    return type(sde).__name__.lower()


# ---------------------------------------------------------------------------
# Orthonormal DCT-II helpers (BDM basis).  V^T = DCT, V = IDCT, V^T V = I.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix of size (n, n), host float64: y = C @ x."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    c = c * np.sqrt(2.0 / n)
    c[0] *= np.sqrt(0.5)
    return c.astype(np.float64)


def dct_axes_np(x: np.ndarray, axes: Sequence[int],
                inverse: bool = False) -> np.ndarray:
    """Host float64 orthonormal DCT-II (or its inverse) along `axes`, one
    axis at a time in the order given."""
    for ax in axes:
        c = dct_matrix(x.shape[ax])
        c = c.T if inverse else c
        x = np.moveaxis(np.tensordot(c, np.moveaxis(x, ax, 0), axes=1), 0, ax)
    return x


def sde_apply_np_freq(sde, coeff, u) -> np.ndarray:
    """Host float64 IDCT(coeff * DCT(u)) over a frequency-diagonal SDE's
    spatial axes, for a batch of states (B, *data)."""
    axes = tuple(a + 1 for a in sde.spatial_axes_in_data)
    y = dct_axes_np(np.asarray(u, np.float64), axes)
    return dct_axes_np(y * coeff, axes, inverse=True)


def _dct_axes(x: Tensor, axes: Sequence[int], inverse: bool) -> Tensor:
    for ax in axes:
        c = dct_matrix(x.shape[ax])
        c = torch.as_tensor(c.T if inverse else c, dtype=x.dtype,
                            device=x.device)
        x = torch.tensordot(c, x.movedim(ax, 0), dims=1).movedim(0, ax)
    return x


def dct_nd(x: Tensor, axes: Sequence[int]) -> Tensor:
    """Orthonormal DCT-II along `axes`, one axis at a time in the order
    given (a matrix product per axis, as the JAX package's `dct_nd`)."""
    return _dct_axes(x, axes, inverse=False)


def idct_nd(x: Tensor, axes: Sequence[int]) -> Tensor:
    """Inverse of `dct_nd` (the transposed matrices, same axis order)."""
    return _dct_axes(x, axes, inverse=True)


# ---------------------------------------------------------------------------
# The abstract linear SDE.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LinearSDE:
    """A linear SDE du = F_t u dt + G_t dw with structured coefficients.

    Subclasses provide host-side float64 closed forms (or grid solvers, see
    `solve.GridFn`) for F, G G^T, Psi, Sigma, R, and the device-side
    `apply` for their coefficient family.
    """

    T: float = 1.0
    t_min: float = 1e-3

    # ---- family plumbing ---------------------------------------------------
    @property
    def ops(self) -> CoeffOps:
        raise NotImplementedError

    @property
    def state_ndim_prefix(self) -> int:
        """Structural channel axes between batch and data dims (CLD: 1)."""
        return 0

    def state_shape(self, data_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return data_shape

    # ---- canonical packed layout --------------------------------------------
    # The serving engine keeps every slot's state in ONE layout, (B, k, D):
    # k structural channel rows (VPSDE/BDM 1, CLD 2) by D = prod(data_shape)
    # flattened data entries, in the basis where the family's coefficients
    # act blockwise (pixel space for VPSDE/CLD, the DCT frequency basis for
    # BDM, which overrides these hooks).

    @property
    def packed_k(self) -> int:
        """Channel rows of the canonical (B, k, D) packed state."""
        return getattr(self.ops, "k", 1)

    # True when `canonicalize` is a pure reshape (VPSDE/CLD): i.i.d. normal
    # noise drawn directly in canonical (B, k, D) layout is then the same
    # bits as noise_like(state_shape) -> canonicalize, which lets the round
    # kernel draw the Eq. 22 noise itself.  BDM's canonicalize is a DCT, so
    # its noise is drawn in state space, transformed, and streamed in.
    canonical_noise_is_reshape = True

    def canonicalize(self, u: Tensor) -> Tensor:
        """(B, *state_shape) -> (B, packed_k, D) in the linear basis."""
        return u.reshape(u.shape[0], self.packed_k, -1)

    def decanonicalize(self, z: Tensor, data_shape: Tuple[int, ...]) -> Tensor:
        """(B, packed_k, D) -> (B, *state_shape) back in state space."""
        return z.reshape((z.shape[0],) + self.state_shape(tuple(data_shape)))

    # ---- host-side coefficient functions (numpy float64) -------------------
    def F_np(self, t: float):
        raise NotImplementedError

    def G2_np(self, t: float):
        """G_t G_t^T as a family coeff."""
        raise NotImplementedError

    def Psi_np(self, t: float, s: float):
        """Transition matrix of F: dPsi/dt = F_t Psi, Psi(s,s)=I (Eq. 36)."""
        raise NotImplementedError

    def Sigma_np(self, t: float):
        """Marginal covariance of p_{0t}(u_t | u_0) as a family coeff."""
        raise NotImplementedError

    def R_np(self, t: float):
        """gDDIM parameterization matrix solving Eq. 17."""
        raise NotImplementedError

    def L_np(self, t: float):
        """Cholesky factor of Sigma_t (Dockhorn et al.'s K_t choice)."""
        return self.ops.chol(self.Sigma_np(t))

    def Sigma0_np(self):
        """Initial per-data-point covariance."""
        return self.ops.zeros()

    # ---- device-side application -------------------------------------------
    def apply(self, coeff, u: Tensor) -> Tensor:
        """Apply one coefficient to a batched state u."""
        raise NotImplementedError

    def apply_batched(self, coeff, u: Tensor) -> Tensor:
        """Apply a *per-example* coefficient (leading batch axis) to u:
        coeff (B, *coeff_shape), u (B, *state_shape)."""
        raise NotImplementedError

    def apply_factored(self, blk, diag, u: Tensor) -> Tensor:
        """Apply a factored canonical coefficient — a (k_max, k_max) block
        factor and a (D,) diagonal factor (`core.coeffs.factor_coeff`) — to
        a state u (B, *state_shape), as two contractions."""
        z = self.canonicalize(u)
        return _apply_factored_canonical(blk, diag, z).reshape(u.shape)

    def noise_like(self, key: Tensor, u_shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.float32) -> Tensor:
        """`jax.random.normal(key, u_shape)` on the key's device."""
        return prng.normal(key, u_shape, dtype)

    # ---- conveniences -------------------------------------------------------
    def prior_sample(self, key: Tensor, batch: int,
                     data_shape: Tuple[int, ...],
                     dtype: torch.dtype = torch.float32) -> Tensor:
        """Sample u(T) ~ N(0, Sigma_T) on the key's device."""
        shape = (batch,) + self.state_shape(tuple(data_shape))
        eps = self.noise_like(key, shape, dtype)
        chol_T = torch.as_tensor(
            np.asarray(self.ops.chol(self.Sigma_np(self.T))), dtype=dtype,
            device=key.device)
        return self.apply(chol_T, eps)

    def augment_data(self, x: Tensor, key: Tensor | None = None) -> Tensor:
        """Lift data into SDE state space (identity except CLD)."""
        return x

    def project_data(self, u: Tensor) -> Tensor:
        """Project SDE state back to data space (identity except CLD)."""
        return u

    def perturb(self, key: Tensor, u0: Tensor, t,
                K_np_fn: Callable[[float], np.ndarray]
                ) -> Tuple[Tensor, Tensor]:
        """Forward-perturb data: u_t = Psi(t, 0) u0 + K_t eps with eps
        drawn from `key`; returns (u_t, eps).  `t` is one time for the
        whole batch (a python float or 0-d tensor; the coefficients come
        from the host); the losses gather per-example coefficients from
        stacked tables instead (`train.losses`)."""
        t = float(t)
        psi = torch.as_tensor(np.asarray(self.Psi_np(t, 0.0)),
                              dtype=u0.dtype, device=u0.device)
        K = torch.as_tensor(np.asarray(K_np_fn(t)), dtype=u0.dtype,
                            device=u0.device)
        eps = self.noise_like(key, tuple(u0.shape), u0.dtype)
        return self.apply(psi, u0) + self.apply(K, eps), eps
