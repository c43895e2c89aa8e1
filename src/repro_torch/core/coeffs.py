"""Stage I — offline computation of every gDDIM sampler coefficient.

Mirrors the paper's App. C.3 pipeline:

  Step 1  pick the (decreasing) sampling grid {t_i}, i = 0..N, t_0 = t_min,
          t_N = T.
  Step 2  transition matrices Psi(t_{i-1}, t_i)            (closed form/expm)
  Step 3  R_t via Eq. 17                                   (from the SDE)
  Step 4  EI multistep predictor/corrector constants pC/cC (Eqs. 41/46,
          composite-Simpson quadrature), and for stochastic gDDIM the
          lambda-family transition Psi_hat (Eq. 81) and injected covariance
          P_st (Eq. 23) via RK4 per step.

Stage I is numpy float64 on the host; its results are cast to float32 once
(`SamplerCoeffs`, host tensors) and stacked into the serving engine's
`FactoredBank` on the engine's device.  Every float32 leaf is the same cast
of the same float64 value as in the JAX package, so the bank is bitwise
identical to the JAX bank built from the same configs.

Warm start: at step i the usable history is q_cur = min(q, N-i+1) points
(Alg. 1); the lower-order Lagrange coefficients of the first steps are
zero-padded to q slots, so the device step is branch-free.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple, Union

import numpy as np
import torch

from ..sde.base import LinearSDE, family_name
from ..sde import solve

Tensor = torch.Tensor


def _f32(x) -> Tensor:
    """float64 host array -> float32 host tensor (round to nearest, as
    XLA's convert does)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x), np.float32))


class SamplerCoeffs(NamedTuple):
    """Stacked per-step coefficients (float32 host tensors).  Axis 0: step
    k = 0..N-1, where step k advances t_i -> t_{i-1} with i = N - k."""
    ts: Tensor            # (N+1,) the grid, ts[0]=t_min .. ts[N]=T
    psi: Tensor           # (N, *coeff)  Psi(t_{i-1}, t_i)
    pC: Tensor            # (N, q, *coeff)  predictor coeffs, slot j ~ eps(t_{i+j})
    cC: Tensor            # (N, q, *coeff)  corrector coeffs, slot 0 ~ eps(t_{i-1}),
                          #                  slot j>=1 ~ eps(t_{i+j-1})
    psi_hat: Tensor       # (N, *coeff)  lambda-family transition Psi_hat
    B: Tensor             # (N, *coeff)  (Psi_hat - Psi) R_{t_i}   (Eq. 22 mean)
    P_chol: Tensor        # (N, *coeff)  chol of injected covariance P (Eq. 23)
    R: Tensor             # (N+1, *coeff) R_{t_i} on the grid
    R_invT: Tensor        # (N+1, *coeff) R_{t_i}^{-T}
    Sigma: Tensor         # (N+1, *coeff)
    lam: float = 0.0
    pM: Tensor = None     # (N, *coeff)  first-moment EI quadrature
                          #   int ei_core(t_{i-1}, tau) (tau - t_i) dtau


def time_grid(sde: LinearSDE, n_steps: int, kind: str = "quadratic") -> np.ndarray:
    """Sampling grid t_min..T (increasing).  'quadratic' concentrates steps
    near t_min like the DDIM/EDM conventions; 'uniform' is linear."""
    x = np.linspace(0.0, 1.0, n_steps + 1)
    if kind == "quadratic":
        x = x**2
    elif kind != "uniform":
        raise ValueError(kind)
    return sde.t_min + (sde.T - sde.t_min) * x


def _K_fn(sde: LinearSDE, kt: str) -> Callable[[float], np.ndarray]:
    """The paper's K_t choices: 'R' (gDDIM), 'L' (Cholesky), 'sqrt' (sym-sqrt)."""
    if kt == "R":
        return sde.R_np
    if kt == "L":
        return sde.L_np
    if kt == "sqrt":
        return lambda t: sde.ops.sqrt_psd(sde.Sigma_np(t))
    raise ValueError(kt)


def build_sampler_coeffs(
    sde: LinearSDE,
    ts: Sequence[float],
    q: int = 2,
    lam: float = 0.0,
    kt: str = "R",
    quad_points: int = 48,
    rk_substeps: int = 32,
) -> SamplerCoeffs:
    """Compute all Stage-I constants for grid `ts` (increasing, len N+1)."""
    ops = sde.ops
    ts = np.asarray(ts, np.float64)
    N = len(ts) - 1
    K = _K_fn(sde, kt)

    def KinvT(tau: float) -> np.ndarray:
        # K^{-T} = Sigma^{-1} K exactly (K K^T = Sigma), which keeps the
        # interpolation error of the gridded R_t linear instead of
        # amplified through an explicit inverse near the stiff origin.
        return ops.mul(ops.inv(sde.Sigma_np(tau)), K(tau))

    # integrand core 1/2 Psi(t_e, tau) G2(tau) K(tau)^{-T}.  A pure function
    # of (t_e, tau): every quadrature of one step (pC_j, pM, cC_j) samples
    # it at the same Simpson nodes, so it is evaluated once per node.  The
    # memo returns the same float64 values, so the coefficients are
    # unchanged bit for bit.
    core_memo: Dict[Tuple[float, float], np.ndarray] = {}

    def ei_core(t_end: float, tau: float) -> np.ndarray:
        key = (t_end, tau)
        val = core_memo.get(key)
        if val is None:
            val = core_memo[key] = 0.5 * ops.mul(
                ops.mul(sde.Psi_np(t_end, tau), sde.G2_np(tau)), KinvT(tau))
        return val

    coeff_shape = np.shape(np.asarray(ops.eye()))
    psi, pC, cC, pM = [], [], [], []
    psi_hat, B, P_chol = [], [], []

    # generator of the lambda-family SDE (Eq. 51): F_hat = F + (1+lam^2)/2 G2 Sigma^{-1}
    def F_hat(tau: float) -> np.ndarray:
        return sde.F_np(tau) + 0.5 * (1.0 + lam * lam) * ops.mul(
            sde.G2_np(tau), ops.inv(sde.Sigma_np(tau)))

    for k in range(N):
        i = N - k                      # step from t_i down to t_{i-1}
        t_i, t_im1 = float(ts[i]), float(ts[i - 1])
        psi.append(np.asarray(sde.Psi_np(t_im1, t_i), np.float64))

        # ---- predictor coefficients (Eq. 41), history nodes t_i..t_{i+q_cur-1}
        q_cur = min(q, N - i + 1)
        nodes_p = [float(ts[min(i + j, N)]) for j in range(q_cur)]
        row_p = np.zeros((q,) + coeff_shape)
        for j in range(q_cur):
            ell = solve.lagrange_basis(nodes_p, j)
            row_p[j] = solve.quad_coeff(
                lambda tau: ei_core(t_im1, tau) * ell(tau), t_i, t_im1, quad_points)
        pC.append(row_p)

        # ---- first moment of the EI kernel about t_i (accel correction)
        pM.append(solve.quad_coeff(
            lambda tau: ei_core(t_im1, tau) * (tau - t_i), t_i, t_im1,
            quad_points))

        # ---- corrector coefficients (Eq. 46), nodes t_{i-1}, t_i, .., t_{i+q_cur-2}
        q_corr = min(q, N - i + 2)
        nodes_c = [t_im1] + [float(ts[min(i + j, N)]) for j in range(q_corr - 1)]
        row_c = np.zeros((q,) + coeff_shape)
        for j in range(q_corr):
            ell = solve.lagrange_basis(nodes_c, j)
            row_c[j] = solve.quad_coeff(
                lambda tau: ei_core(t_im1, tau) * ell(tau), t_i, t_im1, quad_points)
        cC.append(row_c)

        # ---- stochastic pieces: Psi_hat (Eq. 81) and P (Eq. 23) over [t_i, t_im1]
        def psi_hat_rhs(tau, Y):
            return ops.mul(F_hat(tau), Y)

        ph = solve.integrate_ode(psi_hat_rhs, ops.eye() + 0.0, t_i, t_im1, rk_substeps)
        psi_hat.append(np.asarray(ph, np.float64))
        B.append(ops.mul(ph - psi[-1], np.asarray(K(t_i), np.float64)))

        if lam > 0.0:
            # Eq. 23 in the reverse-time parameterization sigma = s - tau:
            #   dP/dsigma = -(F_hat P + P F_hat^T) + lam^2 G2,  P(0) = 0.
            G2c = lam * lam

            def p_rhs(sig, P):
                tau = t_i - sig
                fh = F_hat(tau)
                return -(ops.mul(fh, P) + ops.mul(P, ops.transpose(fh))) \
                    + G2c * sde.G2_np(tau)

            P = solve.integrate_ode(p_rhs, ops.zeros() + 0.0, 0.0, t_i - t_im1,
                                    rk_substeps)
            # integrating backward in time leaves tiny asymmetry/negativity
            if ops.family == "block":
                P = 0.5 * (P + ops.transpose(P))
                P = P + 1e-14 * np.trace(P) * np.eye(P.shape[-1])
            else:
                P = np.maximum(P, 0.0)
            P_chol.append(ops.chol(P))
        else:
            P_chol.append(np.zeros(coeff_shape))

    R_stack = np.stack([np.asarray(K(float(t)), np.float64) for t in ts])
    RinvT_stack = np.stack([np.asarray(KinvT(float(t)), np.float64) for t in ts])
    Sig_stack = np.stack([np.asarray(sde.Sigma_np(float(t)), np.float64) for t in ts])

    return SamplerCoeffs(
        ts=_f32(ts), psi=_f32(np.stack(psi)), pC=_f32(np.stack(pC)),
        cC=_f32(np.stack(cC)), psi_hat=_f32(np.stack(psi_hat)),
        B=_f32(np.stack(B)), P_chol=_f32(np.stack(P_chol)),
        R=_f32(R_stack), R_invT=_f32(RinvT_stack), Sigma=_f32(Sig_stack),
        lam=float(lam), pM=_f32(np.stack(pM)))


# ---------------------------------------------------------------------------
# Bucketed banks: many sampler configs, one step program shape.
# ---------------------------------------------------------------------------
C_BUCKET_MIN = 4      # config slots
N_BUCKET_MIN = 8      # sampler steps (NFE)
Q_BUCKET_MIN = 2      # multistep order
DIAG_BUCKET_MIN = 1   # diag-pool rows


def bucket_size(n: int, minimum: int) -> int:
    """Smallest power-of-two multiple of `minimum` that holds `n`."""
    b = minimum
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# The sampler-algorithm axis: per-request update rules beyond gDDIM.
# ---------------------------------------------------------------------------
# Every algorithm is a transform of the Stage-I stacks into different
# FactoredBank rows (plus, for 'gmm', a different in-step noise law):
#
#   gddim  the paper's update family (Eqs. 19/22/45) — the identity.
#   gmm    moment-matched two-component mixture reverse kernel: the Eq. 22
#          Gaussian innovation becomes sqrt(1 - rho^2) (z + c s), z ~ N(0,1),
#          s = +-1, c = rho / sqrt(1 - rho^2), with the same first two
#          moments.  sqrt(1-rho^2) lands in the P_chol rows; (z + c s) is
#          the per-slot noise transform keyed by GMM_SALT.  Needs lam > 0.
#   accel  a half-damped backward-difference correction of the eps slope,
#          whose exact EI quadrature is the first moment pM: with
#          delta = t_i - t_{i+1}, slot0 += pM/(2 delta), slot1 = -pM/(2 delta).
#          Needs q == 1, lam == 0, corrector off; consumes 2 history slots.
ALGORITHMS = ("gddim", "gmm", "accel")
ALG_GDDIM, ALG_GMM, ALG_ACCEL = 0, 1, 2

GMM_RHO = 0.5                                  # mixture separation rho
GMM_SCALE = float(np.sqrt(1.0 - GMM_RHO * GMM_RHO))   # f64, host-side
GMM_C = np.float32(GMM_RHO / np.sqrt(1.0 - GMM_RHO * GMM_RHO))
GMM_SALT = 0x6A66                              # second-stream fold ('jf')


def effective_q(cfg: "SamplerConfig") -> int:
    """History slots the device step consumes for `cfg` (accel spends one
    extra slot on the previous step's eps; cfg.q stays 1)."""
    return 2 if cfg.algorithm == "accel" else cfg.q


def algorithm_coeff_stacks(co: SamplerCoeffs, cfg: "SamplerConfig",
                           coeff_shape: Tuple[int, ...]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-algorithm transform of the Stage-I stacks into the float64 rows
    the bank stores: (pC, cC, P_chol) shaped (N, q_eff, *coeff) /
    (N, q_eff, *coeff) / (N, *coeff).  Reads the float32 Stage-I leaves
    back as float64, as the JAX package does."""
    N, q, qe = cfg.nfe, cfg.q, effective_q(cfg)
    pC = co.pC.numpy().astype(np.float64)
    cC = co.cC.numpy().astype(np.float64)
    P = co.P_chol.numpy().astype(np.float64)
    if cfg.algorithm == "gddim":
        return pC, cC, P
    if cfg.algorithm == "gmm":
        return pC, cC, GMM_SCALE * P
    if cfg.algorithm == "accel":
        ts = co.ts.numpy().astype(np.float64)
        pM = co.pM.numpy().astype(np.float64)
        out = np.zeros((N, qe) + coeff_shape, np.float64)
        out[:, 0] = pC[:, 0]          # k = 0 (i = N): no history yet
        for k in range(1, N):
            i = N - k
            delta = float(ts[i] - ts[i + 1])     # t_i - t_{i+1} (< 0)
            corr = 0.5 * pM[k] / delta
            out[k, 0] = pC[k, 0] + corr
            out[k, 1] = -corr
        cc = np.zeros((N, qe) + coeff_shape, np.float64)
        cc[:, :q] = cC
        return out, cc, P
    raise ValueError(f"unknown algorithm {cfg.algorithm!r}")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """One point in gDDIM's sampler family (the per-request surface).

    nfe        number of grid steps N
    q          exponential-multistep order (Eq. 19/41); must be 1 when lam > 0
    corrector  run the Eq. 45 corrector after every predictor step but the
               last (Alg. 1)
    lam        stochasticity level lambda of Eq. 22 (0 = deterministic)
    grid       time-grid kind ('quadratic' | 'uniform')
    family     SDE family name (None = the cache's default family)
    algorithm  sampler update rule ('gddim' | 'gmm' | 'accel')
    """
    nfe: int
    q: int = 1
    corrector: bool = False
    lam: float = 0.0
    grid: str = "quadratic"
    family: Optional[str] = None
    algorithm: str = "gddim"

    def __post_init__(self):
        if self.nfe < 1:
            raise ValueError(f"nfe must be >= 1, got {self.nfe}")
        if self.q < 1:
            raise ValueError(f"q must be >= 1, got {self.q}")
        if self.lam < 0.0:
            raise ValueError(f"lam must be >= 0, got {self.lam}")
        if self.lam > 0.0 and (self.q != 1 or self.corrector):
            raise ValueError(
                "stochastic gDDIM (lam > 0, Eq. 22) is single-step: "
                "q must be 1 and corrector off")
        if self.grid not in ("quadratic", "uniform"):
            raise ValueError(f"unknown grid kind {self.grid!r}")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; "
                             f"choose from {ALGORITHMS}")
        if self.algorithm == "gmm" and self.lam <= 0.0:
            raise ValueError(
                "algorithm='gmm' reshapes the injected Eq. 22 noise, so "
                "it needs a stochastic config (lam > 0)")
        if self.algorithm == "accel" and (
                self.q != 1 or self.lam > 0.0 or self.corrector):
            raise ValueError(
                "algorithm='accel' is a deterministic single-step "
                "correction: q must be 1, lam 0, corrector off")


# ---------------------------------------------------------------------------
# Canonical factored coefficients: one bank for every SDE family.
# ---------------------------------------------------------------------------
def factor_coeff(ops, coeff, data_shape: Tuple[int, ...],
                 k_max: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Exact factored form of a family coefficient: a (k_max, k_max) block
    factor and an optional (D,) diagonal factor with
    dense[i, j, d] = blk[i, j] * diag[d]:

      scalar   c        ->  c e00       x  None  (the all-ones diagonal)
      block    M (k,k)  ->  M (padded)  x  None
      freqdiag d        ->  e00         x  d broadcast over data_shape

    `None` means the shared all-ones pool row (slot 0 of
    `FactoredBank.diag`); an all-zero freq-diagonal coefficient is the
    zero block on that row."""
    blk = np.zeros((k_max, k_max), np.float64)
    coeff = np.asarray(coeff, np.float64)
    if ops.family == "scalar":
        blk[0, 0] = float(coeff)
        return blk, None
    if ops.family == "block":
        k = coeff.shape[-1]
        blk[:k, :k] = coeff
        return blk, None
    if ops.family == "freqdiag":
        if not np.any(coeff):
            return blk, None                   # zero block annihilates
        blk[0, 0] = 1.0
        diag = np.broadcast_to(coeff, data_shape).reshape(-1)
        return blk, np.ascontiguousarray(diag, np.float64)
    raise ValueError(f"unknown coeff family {ops.family!r}")


class FactoredBank(NamedTuple):
    """Multi-family coefficient bank in factored form: every coefficient is
    a (K, K) block factor times a (D,) diagonal factor from a deduplicated
    pool.  Tensors live on the engine's device.

      t_cur/t_nxt  (C, Nb)             model-eval / corrector-eval times
      psi_blk      (C, Nb, K, K)       transition Psi(t_{i-1}, t_i)
      pC_blk       (C, Nb, Qb, K, K)   predictor coeffs (Eq. 41)
      cC_blk       (C, Nb, Qb, K, K)   corrector coeffs (Eq. 46)
      B_blk        (C, Nb, K, K)       (Psi_hat - Psi) R_{t_i} (Eq. 22)
      P_chol_blk   (C, Nb, K, K)       chol of injected covariance (Eq. 23)
      *_di         int32, the matching *_blk leaf minus its (K, K) dims —
                                       diag-pool row ids
      diag         (Pb, D)             the deduplicated diagonal pool; row 0
                                       is all-ones
      n_steps      (C,) int32          true N_c per config
      stochastic   (C,) bool           lam > 0 (selects the Eq. 22 update)
      corrector    (C,) bool           Eq. 45 corrector enabled
      fam          (C,) int32          family index of each config row
      alg          (C,) int32          algorithm id (index into ALGORITHMS)

    Deterministic configs store zero B/P_chol factors (their Eq. 22 branch
    is masked off); padding rows are zero blocks on pool row 0, so padded
    terms vanish exactly.
    """
    t_cur: Tensor
    t_nxt: Tensor
    psi_blk: Tensor
    psi_di: Tensor
    pC_blk: Tensor
    pC_di: Tensor
    cC_blk: Tensor
    cC_di: Tensor
    B_blk: Tensor
    B_di: Tensor
    P_chol_blk: Tensor
    P_chol_di: Tensor
    diag: Tensor
    n_steps: Tensor
    stochastic: Tensor
    corrector: Tensor
    fam: Tensor
    alg: Tensor

    @property
    def shape_key(self) -> Tuple[int, int, int, int, int, int]:
        """(Cb, Nb, Qb, K, D, Pb)."""
        return (self.psi_blk.shape[0], self.psi_blk.shape[1],
                self.pC_blk.shape[2], self.psi_blk.shape[2],
                self.diag.shape[1], self.diag.shape[0])


class CoeffCache:
    """Host-side Stage-I coefficient cache keyed by
    (sde family, grid kind, NFE, q, corrector, lambda, algorithm).

    `get(cfg)` memoizes `build_sampler_coeffs` per (family, grid, NFE, q,
    lambda) — the corrector and algorithm toggles share one Stage-I result.
    `index_of(cfg)` assigns the config a stable slot in the stacked
    `factored_bank`, which pads every entry to power-of-two bucketed shapes
    so one step program serves any mix of cached configs.

    Registration is incremental: per-config factored rows are memoized, a
    first-seen config appends its rows into the padded host mirror, and
    only a bucket overflow re-pads every row.  `bank_restack_rows` counts
    the config rows (re)written since construction.
    """

    def __init__(self, sdes: Union[LinearSDE, Mapping[str, LinearSDE]],
                 kt: Union[str, Mapping[str, str]] = "R",
                 quad_points: int = 48, rk_substeps: int = 32,
                 data_shape: Optional[Tuple[int, ...]] = None,
                 device: Union[str, torch.device] = "cpu"):
        if isinstance(sdes, LinearSDE):
            sdes = {family_name(sdes): sdes}
        self.sdes: Dict[str, LinearSDE] = dict(sdes)
        if not self.sdes:
            raise ValueError("CoeffCache needs at least one SDE family")
        if not isinstance(kt, str):
            kt = dict(kt)
            missing = set(self.sdes) - set(kt)
            if missing:
                raise ValueError(f"kt mapping missing families {sorted(missing)}")
        self.kt = kt
        self.data_shape = None if data_shape is None else tuple(data_shape)
        self.quad_points = quad_points
        self.rk_substeps = rk_substeps
        self.device = torch.device(device)
        self._coeffs: Dict[tuple, SamplerCoeffs] = {}
        self._configs: List[SamplerConfig] = []
        self._slots: Dict[tuple, int] = {}
        self._row_memo: Dict[tuple, dict] = {}
        self._pool: List[np.ndarray] = []
        self._pool_ids: Dict[bytes, int] = {}
        self._fa_host: Dict[str, np.ndarray] | None = None
        self._fa_built = 0
        self._fa_pool_built = 0
        self._fa_pool_cap = 0
        self._factored: FactoredBank | None = None
        self.bank_restack_rows = 0

    # ---- family plumbing ----------------------------------------------------
    @property
    def families(self) -> List[str]:
        """Resident family names, in registration order (= family id)."""
        return list(self.sdes)

    @property
    def default_family(self) -> str:
        return next(iter(self.sdes))

    @property
    def k_max(self) -> int:
        """Canonical packed channel width over the resident families."""
        return max(s.packed_k for s in self.sdes.values())

    def fam_index(self, name: str) -> int:
        return self.families.index(name)

    def resolve(self, cfg: SamplerConfig) -> str:
        """Concrete family name of `cfg` (validated against the residents)."""
        name = cfg.family if cfg.family is not None else self.default_family
        if name not in self.sdes:
            raise ValueError(f"unknown SDE family {name!r}; resident "
                             f"families: {self.families}")
        return name

    def _kt_of(self, name: str) -> str:
        return self.kt if isinstance(self.kt, str) else self.kt[name]

    # ---- Stage-I memoization ------------------------------------------------
    def key_of(self, cfg: SamplerConfig) -> tuple:
        """Full config key (the bank-slot identity)."""
        return (self.resolve(cfg), cfg.grid, cfg.nfe, cfg.q,
                cfg.corrector, cfg.lam, cfg.algorithm)

    def _coeff_key(self, cfg: SamplerConfig) -> tuple:
        return (self.resolve(cfg), cfg.grid, cfg.nfe, cfg.q, cfg.lam)

    def __len__(self) -> int:
        return len(self._configs)

    @property
    def configs(self) -> List[SamplerConfig]:
        return list(self._configs)

    def get(self, cfg: SamplerConfig) -> SamplerCoeffs:
        """Stage-I coefficients for `cfg`; computed once per key."""
        key = self._coeff_key(cfg)
        if key not in self._coeffs:
            name = self.resolve(cfg)
            sde = self.sdes[name]
            ts = time_grid(sde, cfg.nfe, cfg.grid)
            self._coeffs[key] = build_sampler_coeffs(
                sde, ts, q=cfg.q, lam=cfg.lam, kt=self._kt_of(name),
                quad_points=self.quad_points, rk_substeps=self.rk_substeps)
        return self._coeffs[key]

    def index_of(self, cfg: SamplerConfig) -> int:
        """Bank slot of `cfg` (registers the config if new)."""
        key = self.key_of(cfg)
        if key not in self._slots:
            self.get(cfg)
            self._slots[key] = len(self._configs)
            self._configs.append(cfg)
        return self._slots[key]

    def _bucket_shapes(self) -> Tuple[int, int, int]:
        if not self._configs:
            raise ValueError("CoeffCache bank: no configs registered "
                             "(call index_of first)")
        Cb = bucket_size(len(self._configs), C_BUCKET_MIN)
        Nb = bucket_size(max(c.nfe for c in self._configs), N_BUCKET_MIN)
        Qb = bucket_size(max(effective_q(c) for c in self._configs),
                         Q_BUCKET_MIN)
        return Cb, Nb, Qb

    # ---- factored bank --------------------------------------------------------
    def _diag_slot(self, diag: Optional[np.ndarray]) -> int:
        """Pool slot of a diagonal factor (None -> the shared all-ones row
        0; real rows are deduplicated by float32 value, never evicted)."""
        if not self._pool:
            ones = np.ones((int(np.prod(self.data_shape)),), np.float32)
            self._pool.append(ones)
            self._pool_ids[ones.tobytes()] = 0
        if diag is None:
            return 0
        row = np.ascontiguousarray(diag, np.float32)
        key = row.tobytes()
        slot = self._pool_ids.get(key)
        if slot is None:
            slot = len(self._pool)
            self._pool.append(row)
            self._pool_ids[key] = slot
        return slot

    def _factor_rows(self, cfg: SamplerConfig) -> dict:
        """Memoized per-config factored rows (float32 block factors + pool
        ids)."""
        key = self.key_of(cfg)
        got = self._row_memo.get(key)
        if got is not None:
            return got
        co = self.get(cfg)
        ops = self.sdes[self.resolve(cfg)].ops
        coeff_shape = np.shape(np.asarray(ops.eye()))
        K, N, q = self.k_max, cfg.nfe, effective_q(cfg)
        pC_alg, cC_alg, P_alg = algorithm_coeff_stacks(co, cfg, coeff_shape)

        def rows(stack, n_lead):
            """Factor a stacked f64 coeff array into (blk f32, di i32)."""
            blk = np.zeros(n_lead + (K, K), np.float32)
            di = np.zeros(n_lead, np.int32)
            for idx in np.ndindex(*n_lead):
                b, d = factor_coeff(ops, stack[idx], self.data_shape, K)
                blk[idx] = b
                di[idx] = self._diag_slot(d)
            return blk, di

        psi_blk, psi_di = rows(co.psi.numpy().astype(np.float64), (N,))
        pC_blk, pC_di = rows(pC_alg, (N, q))
        cC_blk, cC_di = rows(cC_alg, (N, q))
        if cfg.lam > 0.0:
            B_blk, B_di = rows(co.B.numpy().astype(np.float64), (N,))
            P_blk, P_di = rows(P_alg, (N,))
        else:
            B_blk = np.zeros((N, K, K), np.float32)
            B_di = np.zeros((N,), np.int32)
            P_blk, P_di = B_blk, B_di
        ts = co.ts.numpy()
        row = dict(
            t_cur=ts[N - np.arange(N)], t_nxt=ts[N - 1 - np.arange(N)],
            psi_blk=psi_blk, psi_di=psi_di, pC_blk=pC_blk, pC_di=pC_di,
            cC_blk=cC_blk, cC_di=cC_di, B_blk=B_blk, B_di=B_di,
            P_chol_blk=P_blk, P_chol_di=P_di)
        self._row_memo[key] = row
        return row

    def _alloc_factored_host(self, Cb: int, Nb: int, Qb: int
                             ) -> Dict[str, np.ndarray]:
        K = self.k_max
        return dict(
            t_cur=np.zeros((Cb, Nb), np.float32),
            t_nxt=np.zeros((Cb, Nb), np.float32),
            psi_blk=np.zeros((Cb, Nb, K, K), np.float32),
            psi_di=np.zeros((Cb, Nb), np.int32),
            pC_blk=np.zeros((Cb, Nb, Qb, K, K), np.float32),
            pC_di=np.zeros((Cb, Nb, Qb), np.int32),
            cC_blk=np.zeros((Cb, Nb, Qb, K, K), np.float32),
            cC_di=np.zeros((Cb, Nb, Qb), np.int32),
            B_blk=np.zeros((Cb, Nb, K, K), np.float32),
            B_di=np.zeros((Cb, Nb), np.int32),
            P_chol_blk=np.zeros((Cb, Nb, K, K), np.float32),
            P_chol_di=np.zeros((Cb, Nb), np.int32),
            n_steps=np.ones((Cb,), np.int32),
            stochastic=np.zeros((Cb,), bool),
            corrector=np.zeros((Cb,), bool),
            fam=np.zeros((Cb,), np.int32),
            alg=np.zeros((Cb,), np.int32))

    def _write_factored_row(self, H: Dict[str, np.ndarray], c: int,
                            cfg: SamplerConfig, row: dict) -> None:
        # q from the memoized row: accel widens it to effective_q(cfg)
        N, q = cfg.nfe, row["pC_blk"].shape[1]
        H["t_cur"][c, :N] = row["t_cur"]
        H["t_cur"][c, N:] = row["t_cur"][-1]
        H["t_nxt"][c, :N] = row["t_nxt"]
        H["t_nxt"][c, N:] = row["t_nxt"][-1]
        for name in ("psi", "B", "P_chol"):
            H[name + "_blk"][c, :N] = row[name + "_blk"]
            H[name + "_di"][c, :N] = row[name + "_di"]
        for name in ("pC", "cC"):
            H[name + "_blk"][c, :N, :q] = row[name + "_blk"]
            H[name + "_di"][c, :N, :q] = row[name + "_di"]
        H["n_steps"][c] = N
        H["stochastic"][c] = cfg.lam > 0.0
        H["corrector"][c] = cfg.corrector
        H["fam"][c] = self.fam_index(self.resolve(cfg))
        H["alg"][c] = ALGORITHMS.index(cfg.algorithm)

    @property
    def factored_bank(self) -> FactoredBank:
        """The canonical bank on `self.device` (requires `data_shape`).
        Returns the identical object while nothing changed, so a caller
        can tell a refresh by identity."""
        if self.data_shape is None:
            raise ValueError("CoeffCache.factored_bank needs data_shape= "
                             "(the shared per-sample data shape)")
        Cb, Nb, Qb = self._bucket_shapes()
        rows = [self._factor_rows(cfg) for cfg in self._configs]
        Pb = bucket_size(len(self._pool), DIAG_BUCKET_MIN)

        H = self._fa_host
        if H is None or H["psi_blk"].shape[:2] != (Cb, Nb) \
                or H["pC_blk"].shape[2] != Qb:
            H = self._fa_host = self._alloc_factored_host(Cb, Nb, Qb)
            self._fa_built = 0
        for c in range(self._fa_built, len(rows)):
            self._write_factored_row(H, c, self._configs[c], rows[c])
            self.bank_restack_rows += 1
        appended = len(rows) - self._fa_built
        self._fa_built = len(rows)

        pool_stale = (self._fa_pool_built != len(self._pool)
                      or self._fa_pool_cap != Pb)
        if not appended and not pool_stale and self._factored is not None:
            return self._factored
        pool = np.zeros((Pb, int(np.prod(self.data_shape))), np.float32)
        for i, r in enumerate(self._pool):
            pool[i] = r
        self._fa_pool_built, self._fa_pool_cap = len(self._pool), Pb

        dev = self.device
        put = lambda x: torch.from_numpy(np.array(x)).to(dev)
        self._factored = FactoredBank(
            diag=put(pool), **{name: put(a) for name, a in H.items()})
        return self._factored


def ddim_closed_form_check(sde, ts) -> np.ndarray:
    """Closed-form deterministic-DDIM eps coefficient on VPSDE (paper Eq.
    12): sqrt(1 - a_{t-1}) - sqrt(1 - a_t) sqrt(a_{t-1} / a_t), one per
    step, newest time first; the quadrature path's pC[:, 0] must reproduce
    it (Prop 2)."""
    out = []
    N = len(ts) - 1
    for k in range(N):
        i = N - k
        t, s = float(ts[i]), float(ts[i - 1])
        a_t, a_s = sde.alpha(t), sde.alpha(s)
        out.append(np.sqrt(1 - a_s) - np.sqrt(1 - a_t) * np.sqrt(a_s / a_t))
    return np.asarray(out)
