"""Plain-torch version of the fused gDDIM exponential-integrator update and
of the factored coefficient apply.

The q-step predictor update (paper Eq. 19a) for scalar/block families:

    u_next[c] = sum_c' Psi[c,c'] u[c'] + sum_j sum_c' C[j,c,c'] eps_hist[j,c']

State layout: (B, k, D) with k the structural channel count (VPSDE: k=1,
CLD: k=2) and D the flattened data dims.  eps_hist: a (q, B, k, D) tensor
or a sequence of q (B, k, D) rows.
Coefficients: psi (k, k); C (q, k, k).

Both functions spell their sums out term by term, left to right, each term
one f32 multiply and each sum one f32 add: the CUDA kernels
(`csrc/ei_update.cu`) repeat that arithmetic without fused multiply-adds,
so on the card they agree with these bit for bit.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

Tensor = torch.Tensor


def ei_update_ref(u: Tensor, eps_hist: Union[Tensor, Sequence[Tensor]],
                  psi: Tensor, C: Tensor) -> Tensor:
    """u (B, k, D) f32 or bf16; eps_hist (q, B, k, D) of u's dtype, or a
    sequence of q (B, k, D) rows; psi (k, k), C (q, k, k).  Computed in
    f32, returned in u's dtype."""
    k = u.shape[1]
    u32, e32 = u.float(), [e.float() for e in eps_hist]
    psi = torch.as_tensor(psi, dtype=torch.float32, device=u.device)
    C = torch.as_tensor(C, dtype=torch.float32, device=u.device)
    rows = []
    for c in range(k):
        row = psi[c, 0] * u32[:, 0]
        for c2 in range(1, k):
            row = row + psi[c, c2] * u32[:, c2]
        for j, e in enumerate(e32):
            for c2 in range(k):
                row = row + C[j, c, c2] * e[:, c2]
        rows.append(row)
    return torch.stack(rows, dim=1).to(u.dtype)


def apply_factored_ref(blk: Tensor, diag: Tensor, z: Tensor) -> Tensor:
    """Factored per-example coefficient application: blk (B, k, k), diag
    (B, D), z (B, k, D) -> (B, k, D).  Each term is (blk[c, c2] * diag) *
    z[c2] and the terms are summed left to right — the multiply-reduce of
    the dense coefficient blk (x) diag, and the arithmetic the CUDA kernels
    (`apply_factored`, and the round kernels' factor applies) repeat bit for
    bit."""
    coeff = blk[..., None] * diag[:, None, None, :]          # (B, k, k, D)
    out = coeff[:, :, 0] * z[:, None, 0]
    for c2 in range(1, z.shape[1]):
        out = out + coeff[:, :, c2] * z[:, None, c2]
    return out
