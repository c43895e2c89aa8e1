"""Dispatch for the fused EI update and the factored coefficient apply, and
the canonical packing layer.

`ei_update(u, eps_hist, psi, C)` with state (B, k, D) is the lockstep
sampler's state update (`core/gddim.py`: predictor, corrector and the
stochastic step); `apply_factored(blk, diag, z)` is one factor apply of the
pre-fusion serving step (`launch/steps.py`, bank mode).  Both dispatch on
the state's device: a CPU tensor runs the plain version (`ref.py`), a CUDA
tensor the hand-written kernel of `csrc/ei_update.cu`, one launch each, or
raises.  `ei_update` takes the eps history as a stacked (q, B, k, D)
tensor or as a list of q (B, k, D) rows; the kernel reads the rows where
they lie, so a caller holding separate rows stacks nothing.

The packing layer:

  * `pad_channels(z, k_pad)` zero-pads a packed (B, k, D) state's channel
    axis (the engine's prior admission and the serving step's eps packing);
  * `pack_state(u, k, k_pad=None)` flattens (B, [k,] *data) to (B, k, D);
  * `unpack_state(z, shape, k=None)` inverts it, dropping padding rows;
  * `apply_packed(coeff, z)` applies a per-example dense canonical
    coefficient (B, k, k, D) — the one-einsum oracle `apply_factored` is
    held against.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .. import cuda
from .ref import apply_factored_ref, ei_update_ref

Tensor = torch.Tensor
EpsHist = Union[Tensor, Sequence[Tensor]]

MAX_K, MAX_Q = 2, 4
EI_THREADS = 256            # ei_update's block (compare_calls.py's sweep)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
# u eps(host array of q row pointers) out psi C | B k D q dtype elems
# threads | stream
_EI_ARGS = [_VP] * 5 + [_I] * 7 + [_VP]
# blk diag z out | B k D | stream
_FACTORED_ARGS = [_VP] * 4 + [_I] * 3 + [_VP]


def pad_channels(z: Tensor, k_pad: int) -> Tensor:
    """Zero-pad a packed (B, k, D) state's channel axis to k_pad rows."""
    k = z.shape[1]
    if k_pad < k:
        raise ValueError(f"k_pad {k_pad} < k {k}")
    if k_pad == k:
        return z
    return torch.cat([z, z.new_zeros((z.shape[0], k_pad - k) + z.shape[2:])],
                     dim=1)


def pack_state(u: Tensor, k: int, k_pad: Optional[int] = None,
               ) -> Tuple[Tensor, Tuple[int, ...]]:
    """(B, [k,] *data) -> (B, k_pad or k, D) plus the original shape for
    unpack.  Padding rows (k..k_pad) are zeros."""
    shape = tuple(u.shape)
    z = u.reshape(shape[0], k, -1)
    if k_pad is not None:
        z = pad_channels(z, k_pad)
    return z, shape


def unpack_state(u: Tensor, shape: Tuple[int, ...],
                 k: Optional[int] = None) -> Tensor:
    """Invert `pack_state`: drop padding rows (when the packed `u` is wider
    than the original k rows) and restore `shape`."""
    if k is not None and u.shape[1] > k:
        u = u[:, :k]
    return u.reshape(shape)


def apply_packed(coeff: Tensor, z: Tensor) -> Tensor:
    """Per-example DENSE canonical coefficient application:
    coeff (B, k, k, D) x z (B, k, D) -> (B, k, D).  The oracle
    `apply_factored` is held against; no serving path runs it."""
    return torch.einsum("bijd,bjd->bid", coeff, z)


def _host_f32(x, n: int, name: str):
    """A small coefficient tensor (or array) as a ctypes float array on the
    host: Stage-I coefficients are host tensors, so this copies nothing
    from the card."""
    flat = torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    if flat.numel() != n:
        raise ValueError(f"{name}: {flat.numel()} values, expected {n}")
    return (ctypes.c_float * max(n, 1))(*flat.cpu().tolist())


def history_rows(u: Tensor, eps_hist: EpsHist) -> List[Tensor]:
    """The q rows of an eps history, checked against the state u (B, k, D):
    a (q, B, k, D) tensor gives its views eps_hist[j], a sequence of (B, k,
    D) tensors itself.  Each row must lie on u's device with u's dtype and
    shape, contiguous; anything else raises (the rows' addresses go to the
    kernel as they are)."""
    if isinstance(eps_hist, Tensor):
        if eps_hist.dim() != 4:
            raise ValueError(f"eps_hist: expected (q, B, k, D), got "
                             f"{tuple(eps_hist.shape)}")
        rows = list(eps_hist.unbind(0))
    else:
        rows = list(eps_hist)
    if len(rows) > MAX_Q:
        raise ValueError(f"ei_update: q {len(rows)} must be 0..{MAX_Q}")
    for j, row in enumerate(rows):
        if not isinstance(row, Tensor):
            raise TypeError(f"eps_hist[{j}]: expected a tensor, got "
                            f"{type(row).__name__}")
        if row.device != u.device:
            raise ValueError(f"eps_hist[{j}]: on {row.device}, expected "
                             f"{u.device}")
        if row.dtype != u.dtype:
            raise TypeError(f"eps_hist[{j}]: dtype {row.dtype}, expected "
                            f"{u.dtype}")
        if row.shape != u.shape:
            raise ValueError(f"eps_hist[{j}]: shape {tuple(row.shape)}, "
                             f"expected {tuple(u.shape)}")
        if not row.is_contiguous():
            raise ValueError(f"eps_hist[{j}]: must be contiguous")
    return rows


def vector_elems(u: Tensor, rows: Sequence[Tensor], out: Tensor) -> int:
    """d a thread of the ei_update instance that takes these tensors: one
    16-byte access (4 f32, 8 bf16) when every address is 16-byte aligned
    and that divides D, else 1 (the scalar instance)."""
    v = 16 // u.element_size()
    if u.shape[-1] % v or any(t.data_ptr() % 16 for t in (u, out, *rows)):
        return 1
    return v


def ei_update_kernel(u: Tensor, eps_hist: EpsHist, psi, C) -> Tensor:
    """One launch of the EI-update kernel: u (B, k, D) f32 or bf16 on the
    card, eps_hist (q, B, k, D) of its dtype or a sequence of q such (B, k,
    D) rows (read where they lie: no stack), psi (k, k) and C (q, k, k)
    (host values, passed by value with the launch), k <= 2, q <= 4."""
    return _ei_update(u, eps_hist, psi, C)


def _ei_update(u: Tensor, eps_hist: EpsHist, psi, C, *,
               elems: Optional[int] = None,
               threads: int = EI_THREADS) -> Tensor:
    """`ei_update_kernel` at `elems` d a thread (1, or one 16-byte access;
    None: `vector_elems`) and `threads` a block, for the card tests and
    the block sweep of `scripts/compare_calls.py ei`."""
    if u.dim() != 3:
        raise ValueError(f"u: expected (B, k, D), got {tuple(u.shape)}")
    B, k, D = u.shape
    if u.dtype not in _DTYPES:
        raise TypeError(f"ei_update: dtype {u.dtype} not in {list(_DTYPES)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ei_update: k {k} must be 1..{MAX_K}")
    cuda.require(u, "u", u.dtype)
    rows = history_rows(u, eps_hist)
    q = len(rows)
    psi_h = _host_f32(psi, k * k, "psi")
    C_h = _host_f32(C, q * k * k, "C")
    out = torch.empty_like(u)
    if elems is None:
        elems = vector_elems(u, rows, out)
    ptrs = (ctypes.c_void_p * MAX_Q)(*[r.data_ptr() for r in rows])
    fn = cuda.function("ei_update", "repro_ei_update", _EI_ARGS)
    rc = fn(u.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(),
            ctypes.addressof(psi_h), ctypes.addressof(C_h), B, k, D, q,
            _DTYPES[u.dtype], elems, threads, cuda.stream_ptr(u))
    cuda.check("ei_update", rc, "ei_update")
    cuda.count_launch("ei_update")
    return out


def apply_factored_kernel(blk: Tensor, diag: Tensor, z: Tensor) -> Tensor:
    """One launch of the factored-apply kernel: blk (B, k, k), diag (B, D),
    z (B, k, D), all f32 on the card, k <= 2."""
    if z.dim() != 3:
        raise ValueError(f"z: expected (B, k, D), got {tuple(z.shape)}")
    B, k, D = z.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"apply_factored: k {k} must be 1..{MAX_K}")
    cuda.require(z, "z", torch.float32)
    cuda.require(blk, "blk", torch.float32, (B, k, k), z.device)
    cuda.require(diag, "diag", torch.float32, (B, D), z.device)
    out = torch.empty_like(z)
    fn = cuda.function("ei_update", "repro_apply_factored", _FACTORED_ARGS)
    rc = fn(blk.data_ptr(), diag.data_ptr(), z.data_ptr(), out.data_ptr(),
            B, k, D, cuda.stream_ptr(z))
    cuda.check("ei_update", rc, "apply_factored")
    cuda.count_launch("apply_factored")
    return out


def ei_update(u: Tensor, eps_hist: EpsHist, psi, C) -> Tensor:
    """psi u + sum_j C_j eps_hist[j] over a packed state: u (B, k, D);
    eps_hist a (q, B, k, D) tensor or a sequence of q (B, k, D) rows, each
    of u's device, dtype and shape and contiguous (`history_rows`); psi
    (k, k); C (q, k, k)."""
    if cuda.device_of(u) == "cpu":
        history_rows(u, eps_hist)
        return ei_update_ref(u, eps_hist, psi, C)
    return ei_update_kernel(u, eps_hist, psi, C)


def apply_factored(blk: Tensor, diag: Tensor, z: Tensor) -> Tensor:
    """Per-example factored coefficient application (the bank-gather form
    of the serving step): blk (B, k, k), diag (B, D), z (B, k, D) ->
    (B, k, D), each term (blk[c, c2] * diag) * z[c2], summed left to
    right."""
    if cuda.device_of(z) == "cpu":
        return apply_factored_ref(blk, diag, z)
    return apply_factored_kernel(blk.contiguous(), diag.contiguous(),
                                 z.contiguous())
