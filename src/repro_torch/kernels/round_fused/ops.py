"""Dispatch for the fused gDDIM round commit and its predictor.

`round_update(...)` is the serving engine's whole post-score-eval state
update — factor applies, q-step eps-history shift, Eq. 22 stochastic
branch with its noise, corrector select, (active, fam, prec) retire
masking and k-advance.  `round_predict(...)` is the Eq. 19a predictor
iterate the corrector's second eval consumes.  Both dispatch on the
state's device:

  * CPU tensors run the plain version (`ref.py`);
  * CUDA tensors run the hand-written kernels of `csrc/round_fused.cu`, one
    launch each, after staging this round's factor pairs (`_stage_factors`)
    and per-slot integers — or raise.

The commit kernel draws the Eq. 22 noise itself when the family's
canonical layout is a reshape of its state (VPSDE, CLD).  Otherwise (BDM,
whose canonicalize is a DCT) the noise is streamed: `step_noise` draws it
in state space with the same in-kernel threefry, `sde.canonicalize` (the
dct2 kernel) transforms it, and the commit reads it (`noise_c`).

`fused_round_cost(...)` is the analytic bytes/FLOPs model of one launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import cuda
from .ref import draw_step_noise, round_predict_ref, round_update_ref

Tensor = torch.Tensor

N_INTS = 8      # per-slot ints: [kc, k, n_steps, mine, stoch, use_c, active, alg]

_VP, _I = ctypes.c_void_p, ctypes.c_int
# ints keys blks dis pool u hist eps eps_n noise_c | u_out hist_out k_out
# act_out | B K Qb kf C D n with_corrector gen_noise stream
_FUSED_ARGS = [_VP] * 14 + [_I] * 6 + [ctypes.c_longlong, _I, _I, _VP]
# blks dis pool u hist eps out | B K Qb kf C D stream
_PREDICT_ARGS = [_VP] * 7 + [_I] * 6 + [_VP]
# keys kc alg bits z | B n stream
_NOISE_ARGS = [_VP] * 5 + [_I, ctypes.c_longlong, _VP]


def _stage_factors(bank, cfg, kc, kf: int, with_corrector: bool,
                   predict_only: bool = False):
    """Gather this round's factor pairs into the kernels' layout: blks
    (B, C, kf, kf) f32 and dis (B, C) int32 diag-pool ids, slot order
    psi | B | P_chol | pC_j | cC_j (predict: psi | pC_j)."""
    blk = lambda nm: getattr(bank, nm + "_blk")[cfg, kc][:, None, :kf, :kf]
    di = lambda nm: getattr(bank, nm + "_di")[cfg, kc][:, None]
    pC_b = bank.pC_blk[cfg, kc][:, :, :kf, :kf]          # (B, Qb, kf, kf)
    pC_i = bank.pC_di[cfg, kc]                           # (B, Qb)
    if predict_only:
        parts_b, parts_i = [blk("psi"), pC_b], [di("psi"), pC_i]
    else:
        parts_b = [blk("psi"), blk("B"), blk("P_chol"), pC_b]
        parts_i = [di("psi"), di("B"), di("P_chol"), pC_i]
        if with_corrector:
            parts_b.append(bank.cC_blk[cfg, kc][:, :, :kf, :kf])
            parts_i.append(bank.cC_di[cfg, kc])
    return (torch.cat(parts_b, dim=1).float().contiguous(),
            torch.cat(parts_i, dim=1).to(torch.int32).contiguous())


def _stage_ints(k, kc, cfg, fam, prec, active, bank, *, fam_index: int,
                prec_index: int, with_corrector: bool) -> Tensor:
    """The per-slot int32 row [kc, k, n_steps, mine, stoch, use_c, active,
    alg] (B, N_INTS), computed on the device."""
    mine = active & (fam == fam_index) & (prec == prec_index)
    if with_corrector:
        use_c = bank.corrector[cfg] & (kc < bank.n_steps[cfg] - 1)
    else:
        use_c = torch.zeros_like(active)
    cols = [kc, k, bank.n_steps[cfg], mine, bank.stochastic[cfg], use_c,
            active, bank.alg[cfg]]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1).contiguous()


def round_fused(ints, keys, blks, dis, pool, u, hist, eps_c, eps_n_c=None,
                noise_c=None, *, kf: int, n: int,
                with_corrector: bool = False):
    """One launch of the round-commit kernel.  ints (B, 8) int32, keys
    (B, 2) int32 key words, blks (B, C, kf, kf) f32, dis (B, C) int32,
    pool (Pb, D) f32, u (B, K, D), hist (B, Qb, K, D), eps_c / eps_n_c /
    noise_c (B, kf, D) f32.  Given the canonical Eq. 22 noise `noise_c`
    the kernel reads it (streamed mode); without, it draws the noise
    itself.  Returns (u_next, hist_next, k_next int32, active_next
    int32)."""
    B, K, D = u.shape
    Qb = hist.shape[1]
    C = blks.shape[1]
    dev = u.device
    want_c = 3 + Qb + (Qb if with_corrector else 0)
    if C != want_c:
        raise ValueError(f"round_fused: {C} factor slots, expected {want_c}")
    cuda.require(ints, "ints", torch.int32, (B, N_INTS), dev)
    cuda.require(keys, "keys", torch.int32, (B, 2), dev)
    cuda.require(blks, "blks", torch.float32, (B, C, kf, kf), dev)
    cuda.require(dis, "dis", torch.int32, (B, C), dev)
    cuda.require(pool, "pool", torch.float32, (pool.shape[0], D), dev)
    cuda.require(u, "u", torch.float32, (B, K, D), dev)
    cuda.require(hist, "hist", torch.float32, (B, Qb, K, D), dev)
    cuda.require(eps_c, "eps_c", torch.float32, (B, kf, D), dev)
    if with_corrector:
        if eps_n_c is None:
            raise ValueError("with_corrector=True needs eps_n_c")
        cuda.require(eps_n_c, "eps_n_c", torch.float32, (B, kf, D), dev)
    gen_noise = noise_c is None
    if not gen_noise:
        cuda.require(noise_c, "noise_c", torch.float32, (B, kf, D), dev)
    if not 1 <= kf <= min(K, 2):
        raise ValueError(f"round_fused: kf {kf} must be 1 or 2 and <= K {K}")
    u_out = torch.empty_like(u)
    hist_out = torch.empty_like(hist)
    k_out = torch.empty((B,), dtype=torch.int32, device=dev)
    act_out = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = cuda.function("round_fused", "repro_round_fused", _FUSED_ARGS)
    rc = fn(ints.data_ptr(), keys.data_ptr(), blks.data_ptr(), dis.data_ptr(),
            pool.data_ptr(), u.data_ptr(), hist.data_ptr(), eps_c.data_ptr(),
            eps_n_c.data_ptr() if with_corrector else None,
            None if gen_noise else noise_c.data_ptr(),
            u_out.data_ptr(), hist_out.data_ptr(), k_out.data_ptr(),
            act_out.data_ptr(), B, K, Qb, kf, C, D, int(n),
            int(with_corrector), int(gen_noise), cuda.stream_ptr(u))
    cuda.check("round_fused", rc, "round_fused")
    cuda.count_launch("round_fused")
    return u_out, hist_out, k_out, act_out


def round_predict_kernel(blks, dis, pool, u, hist, eps_c, *, kf: int) -> Tensor:
    """One launch of the predictor kernel: blks (B, 1 + Qb, kf, kf) stacked
    [psi, pC_0..pC_{Qb-1}], dis (B, 1 + Qb); returns u_pred (B, kf, D)."""
    B, K, D = u.shape
    Qb = hist.shape[1]
    C = blks.shape[1]
    dev = u.device
    if C != 1 + Qb:
        raise ValueError(f"round_predict: {C} factor slots, expected {1 + Qb}")
    cuda.require(blks, "blks", torch.float32, (B, C, kf, kf), dev)
    cuda.require(dis, "dis", torch.int32, (B, C), dev)
    cuda.require(pool, "pool", torch.float32, (pool.shape[0], D), dev)
    cuda.require(u, "u", torch.float32, (B, K, D), dev)
    cuda.require(hist, "hist", torch.float32, (B, Qb, K, D), dev)
    cuda.require(eps_c, "eps_c", torch.float32, (B, kf, D), dev)
    if not 1 <= kf <= min(K, 2):
        raise ValueError(f"round_predict: kf {kf} must be 1 or 2 and <= K {K}")
    out = torch.empty((B, kf, D), dtype=torch.float32, device=dev)
    fn = cuda.function("round_fused", "repro_round_predict", _PREDICT_ARGS)
    rc = fn(blks.data_ptr(), dis.data_ptr(), pool.data_ptr(), u.data_ptr(),
            hist.data_ptr(), eps_c.data_ptr(), out.data_ptr(), B, K, Qb, kf,
            C, D, cuda.stream_ptr(u))
    cuda.check("round_fused", rc, "round_predict")
    cuda.count_launch("round_predict")
    return out


def step_noise_kernel(keys: Tensor, kc: Tensor, alg: Tensor, *, n: int,
                      with_bits: bool = False):
    """One launch of the round kernel's Eq. 22 draw on its own: (B, n) f32
    innovations over each slot's flat state index, the law of
    `ref.draw_step_noise` (keys (B, 2) int32 key words, kc and alg (B,)
    int32).  With `with_bits` also returns the threefry bits (B, n) as
    int32 patterns."""
    B = keys.shape[0]
    dev = keys.device
    cuda.require(keys, "keys", torch.int32, (B, 2))
    cuda.require(kc, "kc", torch.int32, (B,), dev)
    cuda.require(alg, "alg", torch.int32, (B,), dev)
    z = torch.empty((B, n), dtype=torch.float32, device=dev)
    bits = torch.empty((B, n), dtype=torch.int32, device=dev) \
        if with_bits else None
    fn = cuda.function("round_fused", "repro_step_noise", _NOISE_ARGS)
    rc = fn(keys.data_ptr(), kc.data_ptr(), alg.data_ptr(),
            None if bits is None else bits.data_ptr(), z.data_ptr(), B,
            int(n), cuda.stream_ptr(keys))
    cuda.check("round_fused", rc, "step_noise")
    cuda.count_launch("step_noise")
    return (z, bits) if with_bits else z


def step_noise(keys: Tensor, kc: Tensor, alg: Tensor, *, n: int) -> Tensor:
    """The per-slot Eq. 22 innovations (B, n) over each slot's flat state
    index: the plain `draw_step_noise` for CPU keys, the `step_noise`
    kernel for CUDA ones."""
    if cuda.device_of(keys) == "cpu":
        return draw_step_noise(keys, kc, alg, (n,))
    return step_noise_kernel(keys, kc, alg, n=n)


def round_predict(u, hist, kc, cfg, bank, eps_c, *, kf: int) -> Tensor:
    """Eq. 19a predictor iterate u_pred (B, kf, D)."""
    if cuda.device_of(u) == "cpu":
        return round_predict_ref(u, hist, kc, cfg, bank, eps_c, kf=kf)
    blks, dis = _stage_factors(bank, cfg, kc, kf, False, predict_only=True)
    return round_predict_kernel(blks, dis, bank.diag, u, hist, eps_c, kf=kf)


def round_update(u, hist, k, kc, cfg, fam, prec, keys, active, bank, eps_c,
                 *, sde, state_shape, kf: int, fam_index: int = 0,
                 prec_index: int = 0, with_corrector: bool = False,
                 eps_n_c: Optional[Tensor] = None):
    """The whole post-score-eval round commit; returns
    (u_next, hist_next, k_next, active_next bool).  Arguments as
    `ref.round_update_ref`; `keys` are (B, 2) int32 key words."""
    if cuda.device_of(u) == "cpu":
        return round_update_ref(
            u, hist, k, kc, cfg, fam, prec, keys, active, bank, eps_c,
            sde=sde, state_shape=state_shape, kf=kf, fam_index=fam_index,
            prec_index=prec_index, with_corrector=with_corrector,
            eps_n_c=eps_n_c)
    n = int(np.prod(state_shape))
    noise_c = None
    if not sde.canonical_noise_is_reshape:
        z = step_noise_kernel(keys, kc, bank.alg[cfg], n=n)
        noise_c = sde.canonicalize(
            z.reshape((u.shape[0],) + tuple(state_shape))).contiguous()
    ints = _stage_ints(k, kc, cfg, fam, prec, active, bank,
                       fam_index=fam_index, prec_index=prec_index,
                       with_corrector=with_corrector)
    blks, dis = _stage_factors(bank, cfg, kc, kf, with_corrector)
    u2, h2, k2, a2 = round_fused(ints, keys, blks, dis, bank.diag, u, hist,
                                 eps_c, eps_n_c, noise_c, kf=kf, n=n,
                                 with_corrector=with_corrector)
    return u2, h2, k2, a2.bool()


def fused_round_cost(*, B: int, K: int, Qb: int, kf: int, D: int,
                     pool_rows: int, with_corrector: bool = False,
                     gen_noise: bool = True, itemsize: int = 4) -> dict:
    """Analytic per-launch cost of one fused round commit: bytes moved
    (every stream read or written exactly once) and the FLOPs of the
    factor applies."""
    state = B * K * D
    hist = B * Qb * K * D
    eps = B * kf * D
    streams_in = state + hist + eps + pool_rows * D
    if with_corrector:
        streams_in += eps
    if not gen_noise:
        streams_in += eps
    n_coef = 3 + Qb + (Qb if with_corrector else 0)
    smem = B * (N_INTS + 2 + n_coef * (kf * kf + 1))
    bytes_moved = itemsize * (streams_in + state + hist) + 4 * 2 * B
    applies = (1 + Qb) + 2 + (Qb if with_corrector else 0)
    flops = B * kf * kf * D * 3 * applies + B * kf * D * 2 * (applies + 2)
    return {"bytes_moved": int(bytes_moved + itemsize * smem),
            "flops": int(flops),
            "kernel_launches": 1,
            "n_coef": n_coef}
