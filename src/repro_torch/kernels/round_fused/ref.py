"""Plain-torch version of the fused gDDIM round update.

The post-score-eval chain of the serving step, op for op as the JAX
package's reference chain: the same gathers, the same factor applies in
the same order, the same left-associated term sums, the same selects.  It
is what a CPU tensor runs, and what the CUDA kernels (`csrc/round_fused.cu`)
are held against on the card.

Split in two because the Eq. 45 corrector needs a second score eval at the
predictor iterate, between the history shift and the commit:

  * `round_predict_ref` — Eq. 19a predictor only: eps-history shift,
    u_lin + pC terms -> u_pred (the corrector eval's input).
  * `round_update_ref`  — the full commit: shift, predictor, Eq. 22
    stochastic branch (noise keyed by fold_in(fold_in(key, alg), kc),
    `draw_step_noise`), corrector select, family/precision retire masking,
    k-advance.
"""
from __future__ import annotations

import torch

from ... import random as prng
from ...core.coeffs import ALG_GMM, GMM_C, GMM_SALT
from ..ei_update.ops import pad_channels
from ..ei_update.ref import apply_factored_ref

Tensor = torch.Tensor


def draw_step_noise(keys: Tensor, kc: Tensor, alg: Tensor,
                    state_shape, dtype=torch.float32) -> Tensor:
    """Per-slot Eq. 22 noise, algorithm-aware — the noise law of the
    serving tier.  keys (B, 2) int32 key words; kc, alg (B,).

    Chain per slot: key -> fold_in(alg) -> fold_in(kc) -> normal z over
    the slot's state shape.  For algorithm 'gmm' a second stream
    fold_in(step_key, GMM_SALT) draws s and the innovation is
    z + GMM_C * sign(s)."""
    n = 1
    for s in state_shape:
        n *= int(s)
    key = prng.from_int32_bits(keys)
    step_key = prng.fold_in(prng.fold_in(key, alg), kc)          # (B, 2)
    f = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    z = prng.bits_to_normal(prng.bits_at(step_key[:, None], f, n))
    gkey = prng.fold_in(step_key, GMM_SALT)
    s_norm = prng.bits_to_normal(prng.bits_at(gkey[:, None], f, n))
    s = torch.where(s_norm >= 0, 1.0, -1.0)
    noise = torch.where((alg == ALG_GMM)[:, None], z + float(GMM_C) * s, z)
    return noise.reshape((keys.shape[0],) + tuple(state_shape)).to(dtype)


def _gat(bank, nm, cfg, kc, kf):
    """One factor pair gathered by (cfg, kc): the (B, kf, kf) block and the
    (B, D) diagonal pool row its id points at."""
    return (getattr(bank, nm + "_blk")[cfg, kc][:, :kf, :kf],
            bank.diag[getattr(bank, nm + "_di")[cfg, kc]])


def _gatq(bank, nm, j, cfg, kc, kf):
    return (getattr(bank, nm + "_blk")[cfg, kc, j][:, :kf, :kf],
            bank.diag[getattr(bank, nm + "_di")[cfg, kc, j]])


def _shift_hist(hist: Tensor, eps_c: Tensor, K: int) -> Tensor:
    """q-step eps-history shift: hist[:, 0] <- pad(eps_c), rest slide."""
    return torch.cat([pad_channels(eps_c, K)[:, None], hist[:, :-1]], dim=1)


def _predict(u, hist2, kc, cfg, bank, *, kf):
    """Eq. 19a on an already-shifted history: u_lin + sum_j pC_j hist_j."""
    u_lin = apply_factored_ref(*_gat(bank, "psi", cfg, kc, kf), u[:, :kf])
    u_pred = u_lin
    for j in range(hist2.shape[1]):
        u_pred = u_pred + apply_factored_ref(
            *_gatq(bank, "pC", j, cfg, kc, kf), hist2[:, j, :kf])
    return u_lin, u_pred


def round_predict_ref(u, hist, kc, cfg, bank, eps_c, *, kf: int):
    """Predictor iterate u_pred (B, kf, D) — the corrector eval's input."""
    hist2 = _shift_hist(hist, eps_c, u.shape[1])
    return _predict(u, hist2, kc, cfg, bank, kf=kf)[1]


def round_update_ref(u, hist, k, kc, cfg, fam, prec, keys, active, bank,
                     eps_c, *, sde, state_shape, kf: int, fam_index: int = 0,
                     prec_index: int = 0, with_corrector: bool = False,
                     eps_n_c=None, noise_c=None):
    """The full post-score-eval round commit; returns
    (u_next, hist_next, k_next, active_next).

    `eps_c` is this round's canonical score eval; `eps_n_c` (required iff
    `with_corrector`) the canonical corrector eval at `round_predict_ref`'s
    iterate.  The Eq. 22 noise is drawn in state space and canonicalized
    by `sde` (a DCT for BDM), unless the caller passes it canonical as
    `noise_c` (B, kf, D).  Slots whose (active, fam, prec) do not match
    this variant are frozen verbatim."""
    K = u.shape[1]
    hist2 = _shift_hist(hist, eps_c, K)
    u_lin, u_pred = _predict(u, hist2, kc, cfg, bank, kf=kf)

    if noise_c is None:
        noise = draw_step_noise(keys, kc, bank.alg[cfg], state_shape,
                                u.dtype)
        noise_c = sde.canonicalize(noise)
    u_sto = u_lin + apply_factored_ref(*_gat(bank, "B", cfg, kc, kf), eps_c) \
        + apply_factored_ref(*_gat(bank, "P_chol", cfg, kc, kf), noise_c)
    bmask = lambda m: m.reshape(-1, 1, 1)
    u_next = torch.where(bmask(bank.stochastic[cfg]), u_sto, u_pred)

    if with_corrector:
        if eps_n_c is None:
            raise ValueError("with_corrector=True needs eps_n_c (the "
                             "canonical corrector eval at u_pred)")
        u_corr = u_lin + apply_factored_ref(
            *_gatq(bank, "cC", 0, cfg, kc, kf), eps_n_c)
        for j in range(1, hist2.shape[1]):
            u_corr = u_corr + apply_factored_ref(
                *_gatq(bank, "cC", j, cfg, kc, kf), hist2[:, j - 1, :kf])
        # Alg. 1: no corrector on the final step (k == N_c - 1)
        use_c = bank.corrector[cfg] & (kc < bank.n_steps[cfg] - 1)
        u_next = torch.where(bmask(use_c), u_corr, u_next)

    u_full = torch.cat([u_next, u[:, kf:]], dim=1)
    mine = active & (fam == fam_index) & (prec == prec_index)
    rmask = lambda x: mine.reshape((-1,) + (1,) * (x.ndim - 1))
    k_next = torch.where(mine, k + 1, k)
    return (torch.where(rmask(u), u_full, u),
            torch.where(rmask(hist), hist2, hist),
            k_next,
            torch.where(mine, k_next < bank.n_steps[cfg], active))
