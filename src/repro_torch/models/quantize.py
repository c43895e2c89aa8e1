"""Low-precision score-net serving: bf16 and int8 weight-quantized params.

The diffusion round has two costs, the score-net eval and the state
update.  The update (`kernels/round_fused`) never reads the params; the
eval's weights are what a precision class changes.  A request picks its
class (`ServeRequest.precision`, engine default `DiffusionEngine(...,
precision=)`), and each class keeps a resident copy of every family's
params in its own form:

  * "f32" — the net itself: `quantize_tree` and `wrap_eps_model` are the
    identity, so the f32 class runs exactly the ops of a single-class
    engine;
  * "bf16" — every float leaf cast to bf16;
  * "int8" — every float leaf with ndim >= 2 a `QTensor` (int8 `q` and
    an f32 per-output-channel `scale`), the other leaves as they are.  The
    resident copy stays int8; each eval dequantizes it.

The tree is the JAX package's param layout (`convert.jax_tree`: the
DiT's layers stacked along a leading axis), because that layout sets the
numbers: a stacked (L, d_in, d_out) weight has one scale per output
column shared by its L layers, and a stacked (L, n) vector is a matrix,
so it is quantized too — as the JAX package quantizes them.

The compute dtype follows the JAX package's promotion rule (jnp promotes a
mixed-dtype product, torch raises): an eval runs the net with each float
param cast to promote(cfg.dtype, its dtype after dequantization), and the
net's own casts to cfg.dtype (the patchified input, the time embedding)
stay where they are as rounding points.  So

  * at full width (cfg bf16) the bf16 class equals the f32 class bitwise;
  * at full width the int8 class computes in f32 on inputs rounded through
    bf16 — the DiT's attention then runs the f32 flash kernel;
  * at reduced width (cfg f32) the bf16 class computes in f32 on
    bf16-rounded weights.

The eps comes back f32 in every class, so the state update downstream sees
the f32 class's contract.  The net-layer error against the f32 eval is
bounded by `NET_TOLERANCES` (relative to the eps output's scale).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.func import functional_call

from .. import convert

Tensor = torch.Tensor

PRECISIONS = ("f32", "bf16", "int8")

# bounded error of the net layer against the f32 eval, relative to the eps
# output's scale: bf16 carries ~8 mantissa bits; int8 weight rounding is
# ~scale/2 per weight, amplified by depth (the JAX package's numbers)
NET_TOLERANCES = {
    "bf16": {"rtol": 3e-2, "atol": 3e-2},
    "int8": {"rtol": 2e-1, "atol": 2e-1},
}


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"choose from {PRECISIONS}")
    return precision


def prec_index(precision: str) -> int:
    """The `state.prec` class id of a precision name."""
    return PRECISIONS.index(check_precision(precision))


class QTensor(NamedTuple):
    """Per-output-channel symmetric int8 weight: w ~ q * scale, q int8 in
    [-127, 127], scale f32 of shape (w.shape[-1],)."""
    q: Tensor
    scale: Tensor

    def dequant(self) -> Tensor:
        return self.q.float() * self.scale


def _quantize_leaf_int8(w: Tensor) -> QTensor:
    # the JAX package's arithmetic: amax over every axis but the last,
    # scale = max(amax, 1e-12) / 127 in f32, q = clip(round(w / scale));
    # both round half to even
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = amax.clamp_min(1e-12).float() / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def _named(params: Any) -> Dict[str, Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def quantize_tree(params: Any, precision: str) -> Any:
    """The `precision` resident form of a net's params (an nn.Module, or
    its name -> tensor mapping).  "f32" returns `params` itself; "bf16" and
    "int8" a new tree in the JAX layout (`convert.jax_tree`), its float
    leaves bf16, or `QTensor`s where ndim >= 2 (int8)."""
    check_precision(precision)
    if precision == "f32":
        return params
    with torch.no_grad():
        tree = convert.jax_tree(_named(params))
        if precision == "bf16":
            return convert._map(tree, lambda x: x.to(torch.bfloat16)
                                if x.is_floating_point() else x)
        return convert._map(tree, lambda x: _quantize_leaf_int8(x)
                            if x.is_floating_point() and x.dim() >= 2 else x)


def dequantize_tree(tree: Any) -> Dict[str, Tensor]:
    """A resident tree -> the net's parameters by name (the layers
    unstacked again): `QTensor` leaves dequantized to f32, the rest as they
    are."""
    def leaf(x):
        return x.dequant() if isinstance(x, QTensor) else x
    return convert._unstack(convert._map(tree, leaf))


def wrap_eps_model(eps_model, precision: str, net: torch.nn.Module):
    """The round step's eval for a precision class: `eval(params, u, t)`
    where `params` is `quantize_tree(net, precision)`.  "f32" returns
    `eps_model` itself.  Otherwise the eval dequantizes the resident tree,
    casts each float param to promote(net.cfg.dtype, its dtype) (the JAX
    package's promotion; see the module docstring), calls `net` with those
    params in place of its own (`DiffusionSpec.eps_model` is the net's
    call), and returns f32 eps."""
    check_precision(precision)
    if precision == "f32":
        return eps_model
    cfg_dtype = net.cfg.dtype

    def eval_lowp(params, u, t):
        named = {n: x.to(torch.promote_types(cfg_dtype, x.dtype))
                 if x.is_floating_point() else x
                 for n, x in dequantize_tree(params).items()}
        return functional_call(net, named, (u, t)).float()

    return eval_lowp
