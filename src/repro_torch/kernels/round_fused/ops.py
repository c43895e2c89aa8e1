"""Dispatch for the fused gDDIM round commit and its predictor.

`round_update(...)` is the serving engine's whole post-score-eval state
update — factor applies, q-step eps-history shift, Eq. 22 stochastic
branch with its noise, corrector select, (active, fam, prec) retire
masking and k-advance.  `round_predict(...)` is the Eq. 19a predictor
iterate the corrector's second eval consumes.  Both dispatch on the
state's device:

  * CPU tensors run the plain version (`ref.py`);
  * CUDA tensors run the hand-written kernels of `csrc/round_fused.cu` —
    or raise.  The kernels read the state's own tensors and the
    FactoredBank's tables and resolve each slot's indices, flags, factor
    blocks and key themselves: a commit is one launch (VPSDE, CLD), the
    predictor one launch.  History buckets Qb 2, 4 and 8 have instances of
    their own; any other bucket runs the kernels' general instance.

The commit kernel draws the Eq. 22 noise itself when the family's
canonical layout is a reshape of its state (VPSDE, CLD).  Otherwise (BDM,
whose canonicalize is a DCT) the noise is streamed: `step_noise` draws it
in state space with the same in-kernel threefry, `sde.canonicalize` (the
dct2 kernel) transforms it, and the commit reads it (`noise_c`): three
launches.

`_stage_factors` / `_stage_ints` are the plain statement of the per-slot
layout the kernels resolve (the counterpart of the JAX package's
`ops._stage_factors`); `factor_layout` is the factor-slot layout the
kernels follow (the source's `factor_slot`) and `factor_offsets` the flat
offsets a block computes into the bank tables the wrapper hands it.
`fused_round_cost(...)` is the analytic bytes/FLOPs model of one launch.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import cuda
from .ref import draw_step_noise, round_predict_ref, round_update_ref

Tensor = torch.Tensor

N_INTS = 8      # per-slot ints: [kc, k, n_steps, mine, stoch, use_c, active, alg]
MAX_K = 2       # state rows the kernels take
# history buckets with an instance of their own (the history in registers);
# any other bucket runs the general instance
QB_SIZES = (2, 4, 8)
# neighbouring elements a thread of the commit that reads its noise (BDM),
# the faster of chip_smoke.py's sweep; every other launch takes one
STREAMED_ELEMS = 2

_VP, _I = ctypes.c_void_p, ctypes.c_int


# the bank's tables in the kernels' order (csrc/round_fused.cu kTables)
TABLES = ("psi_blk", "psi_di", "B_blk", "B_di", "P_chol_blk", "P_chol_di",
          "pC_blk", "pC_di", "cC_blk", "cC_di", "n_steps", "stochastic",
          "corrector", "alg")


class _RoundArgs(ctypes.Structure):
    """csrc/round_fused.cu's RoundArgs, field for field."""
    _fields_ = [(nm, _VP) for nm in ("cfg", "kc", "tables")] + [
        (nm, _I) for nm in ("K", "C", "Nb", "D", "Pb", "Qb", "fam_index",
                            "prec_index", "with_corrector", "gen_noise")] + [
        (nm, _VP) for nm in ("keys", "k", "fam", "prec", "active")] + [
        ("n", ctypes.c_longlong)] + [(nm, _VP) for nm in (
            "u", "hist", "eps", "eps_n", "noise_c", "diag", "u_out",
            "hist_out", "k_out", "act_out")]


_TABLE_LISTS = {}


def table_list(bank, dev) -> Tensor:
    """The bank's table addresses in `TABLES` order, as an int64 tensor on
    `dev` that the kernels read: made once per set of tables (a bank's
    tensors are not written after it is built, so their addresses name
    it) with one host-to-device copy, then reused."""
    ptrs = tuple(getattr(bank, nm).data_ptr() for nm in TABLES)
    key = (dev, ptrs)
    t = _TABLE_LISTS.get(key)
    if t is None:
        if len(_TABLE_LISTS) >= 16:
            _TABLE_LISTS.clear()
        t = _TABLE_LISTS[key] = torch.tensor(ptrs, dtype=torch.int64).to(dev)
    return t


# RoundArgs* | B kf elems | stream
_FUSED_ARGS = [ctypes.POINTER(_RoundArgs), _I, _I, _I, _VP]
# RoundArgs* | B kf | stream
_PREDICT_ARGS = [ctypes.POINTER(_RoundArgs), _I, _I, _VP]
# keys kc cfg alg bits z | B n | stream
_NOISE_ARGS = [_VP] * 6 + [_I, ctypes.c_longlong, _VP]


def _stage_factors(bank, cfg, kc, kf: int, with_corrector: bool,
                   predict_only: bool = False):
    """Gather this round's factor pairs into the kernels' slot layout: blks
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
    alg] (B, N_INTS): what a kernel block resolves for its slot."""
    mine = active & (fam == fam_index) & (prec == prec_index)
    if with_corrector:
        use_c = bank.corrector[cfg] & (kc < bank.n_steps[cfg] - 1)
    else:
        use_c = torch.zeros_like(active)
    cols = [kc, k, bank.n_steps[cfg], mine, bank.stochastic[cfg], use_c,
            active, bank.alg[cfg]]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1).contiguous()


def factor_layout(Qb: int, with_corrector: bool,
                  predict_only: bool = False) -> List[Tuple[str, int, int]]:
    """The kernels' factor slots in order, each as (bank table, entries
    per (cfg, kc), entry j): psi | B | P_chol | pC_j | cC_j, or psi | pC_j
    for the predictor.  Slot c's block is the top-left kf x kf of
    `<table>_blk`'s element (cfg * Nb + kc) * stride + j, its pool id
    `<table>_di`'s same element (`factor_offsets`)."""
    one = lambda nm: [(nm, 1, 0)]
    per_j = lambda nm: [(nm, Qb, j) for j in range(Qb)]
    if predict_only:
        return one("psi") + per_j("pC")
    return (one("psi") + one("B") + one("P_chol") + per_j("pC")
            + (per_j("cC") if with_corrector else []))


def factor_offsets(layout, cfg: Tensor, kc: Tensor, *, Nb: int, K: int,
                   kf: int) -> Tuple[Tensor, Tensor]:
    """The flat offsets a kernel block computes for its slot from the
    descriptors of `layout`: into each slot's `<table>_blk` (B, C, kf, kf)
    and `<table>_di` (B, C), int64."""
    e = torch.stack([(cfg.long() * Nb + kc.long()) * stride + j
                     for _, stride, j in layout], dim=1)         # (B, C)
    rc = torch.arange(kf)
    within = (rc[:, None] * K + rc[None, :]).to(e.device)        # (kf, kf)
    return e[:, :, None, None] * (K * K) + within, e


def pick_elems(want: int, n: int, *tensors) -> int:
    """The largest E <= `want` (1 or 2) with n % E == 0 and every tensor's
    address aligned to E floats: the commit's vector width."""
    e = want
    while e > 1 and (n % e or any(t is not None and t.data_ptr() % (4 * e)
                                  for t in tensors)):
        e //= 2
    return e


def _require_bank(bank, *, K: int, Qb: int, D: int, dev) -> Tuple[int, int]:
    """Check every table the kernels read; returns (Cb, Nb)."""
    Cb, Nb = bank.psi_blk.shape[:2]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    for nm in ("psi", "B", "P_chol"):
        cuda.require(getattr(bank, nm + "_blk"), nm + "_blk", f32,
                     (Cb, Nb, K, K), dev)
        cuda.require(getattr(bank, nm + "_di"), nm + "_di", i32, (Cb, Nb), dev)
    for nm in ("pC", "cC"):
        cuda.require(getattr(bank, nm + "_blk"), nm + "_blk", f32,
                     (Cb, Nb, Qb, K, K), dev)
        cuda.require(getattr(bank, nm + "_di"), nm + "_di", i32,
                     (Cb, Nb, Qb), dev)
    cuda.require(bank.diag, "diag", f32, (bank.diag.shape[0], D), dev)
    for nm, dt in (("n_steps", i32), ("stochastic", b8), ("corrector", b8),
                   ("alg", i32)):
        cuda.require(getattr(bank, nm), nm, dt, (Cb,), dev)
    return Cb, Nb


def _round_args(bank, layout, u, hist, eps_c, kc, cfg, *,
                Nb: int) -> _RoundArgs:
    """The arguments both kernels read: the streams, the slot's row, the
    bank's pool and its table list (slot c of `layout` is the kernel's
    `factor_slot` c)."""
    B, K, D = u.shape
    return _RoundArgs(u=u.data_ptr(), hist=hist.data_ptr(),
                      eps=eps_c.data_ptr(), kc=kc.data_ptr(),
                      cfg=cfg.data_ptr(), diag=bank.diag.data_ptr(),
                      tables=table_list(bank, u.device).data_ptr(), K=K, D=D,
                      C=len(layout), Nb=Nb, Pb=bank.diag.shape[0],
                      Qb=hist.shape[1])


def _check_shapes(name: str, u, hist, eps_c, kf: int) -> None:
    B, K, D = u.shape
    Qb = hist.shape[1]
    dev = u.device
    if not 1 <= kf <= min(K, MAX_K):
        raise ValueError(f"{name}: kf {kf} must be 1 or 2 and <= K {K}")
    if Qb < 1:
        raise ValueError(f"{name}: history bucket Qb {Qb} < 1")
    cuda.require(u, "u", torch.float32, (B, K, D), dev)
    cuda.require(hist, "hist", torch.float32, (B, Qb, K, D), dev)
    cuda.require(eps_c, "eps_c", torch.float32, (B, kf, D), dev)


def round_fused(*args, **kw):
    """One launch of the round-commit kernel on the state's own tensors:
    (u, hist, k, kc, cfg, fam, prec, keys, active, bank, eps_c, eps_n_c =
    None, noise_c = None, *, kf, n, fam_index = 0, prec_index = 0,
    with_corrector = False) with u (B, K, D), hist (B, Qb, K, D) f32; k,
    kc, cfg, fam, prec (B,) int32; keys (B, 2) int32 key words; active (B,)
    bool; the FactoredBank's tables; eps_c / eps_n_c / noise_c (B, kf, D)
    f32.  Given the canonical Eq. 22 noise `noise_c` the kernel reads it
    (streamed mode, two elements a thread); without, it draws the noise
    itself over a flat state of `n` elements.  Returns (u_next, hist_next,
    k_next int32, active_next bool)."""
    return _round_fused(*args, elems=None, **kw)


def _round_fused(u, hist, k, kc, cfg, fam, prec, keys, active, bank, eps_c,
                 eps_n_c=None, noise_c=None, *, kf: int, n: int,
                 fam_index: int = 0, prec_index: int = 0,
                 with_corrector: bool = False, elems: Optional[int] = None):
    """`round_fused` at `elems` neighbouring elements a thread (1 or 2;
    None: the mode's own), for chip_smoke.py's sweep and the card tests."""
    _check_shapes("round_fused", u, hist, eps_c, kf)
    B, K, D = u.shape
    Qb = hist.shape[1]
    dev = u.device
    for t, nm in ((k, "k"), (kc, "kc"), (cfg, "cfg"), (fam, "fam"),
                  (prec, "prec")):
        cuda.require(t, nm, torch.int32, (B,), dev)
    cuda.require(active, "active", torch.bool, (B,), dev)
    cuda.require(keys, "keys", torch.int32, (B, 2), dev)
    if with_corrector:
        if eps_n_c is None:
            raise ValueError("with_corrector=True needs eps_n_c")
        cuda.require(eps_n_c, "eps_n_c", torch.float32, (B, kf, D), dev)
    gen_noise = noise_c is None
    if not gen_noise:
        cuda.require(noise_c, "noise_c", torch.float32, (B, kf, D), dev)
    _, Nb = _require_bank(bank, K=K, Qb=Qb, D=D, dev=dev)
    u_out = torch.empty_like(u)
    hist_out = torch.empty_like(hist)
    k_out = torch.empty((B,), dtype=torch.int32, device=dev)
    act_out = torch.empty((B,), dtype=torch.bool, device=dev)
    if elems is None:
        elems = 1 if gen_noise or Qb not in QB_SIZES else STREAMED_ELEMS
    e = pick_elems(elems, D, u, hist, eps_c,
                   eps_n_c if with_corrector else None, noise_c, bank.diag)
    a = _round_args(bank, factor_layout(Qb, with_corrector), u, hist, eps_c,
                    kc, cfg, Nb=Nb)
    a.eps_n = eps_n_c.data_ptr() if with_corrector else None
    a.noise_c = None if gen_noise else noise_c.data_ptr()
    for nm, t in (("k", k), ("fam", fam), ("prec", prec),
                  ("active", active), ("keys", keys), ("u_out", u_out),
                  ("hist_out", hist_out), ("k_out", k_out),
                  ("act_out", act_out)):
        setattr(a, nm, t.data_ptr())
    a.n, a.fam_index, a.prec_index = int(n), int(fam_index), int(prec_index)
    a.with_corrector, a.gen_noise = int(with_corrector), int(gen_noise)
    fn = cuda.function("round_fused", "repro_round_fused", _FUSED_ARGS)
    rc = fn(ctypes.byref(a), B, kf, e, cuda.stream_ptr(u))
    cuda.check("round_fused", rc, "round_fused")
    cuda.count_launch("round_fused")
    return u_out, hist_out, k_out, act_out


def round_predict_kernel(u, hist, kc, cfg, bank, eps_c, *,
                         kf: int) -> Tensor:
    """One launch of the predictor kernel on the state's own tensors (kc,
    cfg (B,) int32) and the bank's psi / pC tables; returns u_pred (B, kf,
    D)."""
    _check_shapes("round_predict", u, hist, eps_c, kf)
    B, K, D = u.shape
    Qb = hist.shape[1]
    dev = u.device
    cuda.require(kc, "kc", torch.int32, (B,), dev)
    cuda.require(cfg, "cfg", torch.int32, (B,), dev)
    _, Nb = _require_bank(bank, K=K, Qb=Qb, D=D, dev=dev)
    out = torch.empty((B, kf, D), dtype=torch.float32, device=dev)
    a = _round_args(bank, factor_layout(Qb, False, predict_only=True), u,
                    hist, eps_c, kc, cfg, Nb=Nb)
    a.u_out = out.data_ptr()
    fn = cuda.function("round_fused", "repro_round_predict", _PREDICT_ARGS)
    rc = fn(ctypes.byref(a), B, kf, cuda.stream_ptr(u))
    cuda.check("round_fused", rc, "round_predict")
    cuda.count_launch("round_predict")
    return out


def step_noise_kernel(keys: Tensor, kc: Tensor, cfg: Tensor, alg: Tensor, *,
                      n: int, with_bits: bool = False):
    """One launch of the round kernel's Eq. 22 draw on its own: (B, n) f32
    innovations over each slot's flat state index, the law of
    `ref.draw_step_noise` (keys (B, 2) int32 key words, kc (B,) int32),
    for the slot's algorithm alg[cfg] (cfg (B,) int32 rows of the bank's
    (Cb,) int32 table).  With `with_bits` also returns the threefry bits
    (B, n) as int32 patterns."""
    B = keys.shape[0]
    dev = keys.device
    cuda.require(keys, "keys", torch.int32, (B, 2))
    cuda.require(kc, "kc", torch.int32, (B,), dev)
    cuda.require(cfg, "cfg", torch.int32, (B,), dev)
    cuda.require(alg, "alg", torch.int32, (alg.shape[0],), dev)
    z = torch.empty((B, n), dtype=torch.float32, device=dev)
    bits = torch.empty((B, n), dtype=torch.int32, device=dev) \
        if with_bits else None
    fn = cuda.function("round_fused", "repro_step_noise", _NOISE_ARGS)
    rc = fn(keys.data_ptr(), kc.data_ptr(), cfg.data_ptr(), alg.data_ptr(),
            None if bits is None else bits.data_ptr(), z.data_ptr(), B,
            int(n), cuda.stream_ptr(keys))
    cuda.check("round_fused", rc, "step_noise")
    cuda.count_launch("step_noise")
    return (z, bits) if with_bits else z


def step_noise(keys: Tensor, kc: Tensor, cfg: Tensor, alg: Tensor, *,
               n: int) -> Tensor:
    """The per-slot Eq. 22 innovations (B, n) over each slot's flat state
    index, for algorithm alg[cfg]: the plain `draw_step_noise` for CPU
    keys, the `step_noise` kernel for CUDA ones."""
    if cuda.device_of(keys) == "cpu":
        return draw_step_noise(keys, kc, alg[cfg], (n,))
    return step_noise_kernel(keys, kc, cfg, alg, n=n)


def round_predict(u, hist, kc, cfg, bank, eps_c, *, kf: int) -> Tensor:
    """Eq. 19a predictor iterate u_pred (B, kf, D)."""
    if cuda.device_of(u) == "cpu":
        return round_predict_ref(u, hist, kc, cfg, bank, eps_c, kf=kf)
    return round_predict_kernel(u, hist, kc, cfg, bank, eps_c, kf=kf)


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
        z = step_noise_kernel(keys, kc, cfg, bank.alg, n=n)
        noise_c = sde.canonicalize(
            z.reshape((u.shape[0],) + tuple(state_shape))).contiguous()
    return round_fused(u, hist, k, kc, cfg, fam, prec, keys, active, bank,
                       eps_c, eps_n_c, noise_c, kf=kf, n=n,
                       fam_index=fam_index, prec_index=prec_index,
                       with_corrector=with_corrector)


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
