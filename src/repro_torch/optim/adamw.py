"""AdamW with mixed precision, global-norm clipping, EMA and LR schedules:
the JAX package's `optim/adamw.py` over a list of parameters.

The arithmetic is the JAX package's, operation for operation (not
`torch.optim.AdamW`, which divides by sqrt(bc2) outside the square root and
adds eps after it):

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    new = base - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd base)

Compute params may be bf16; their gradients are then bf16 too.  The state
keeps f32 masters and f32 (m, v); `adamw_update` updates the masters in
f32 and re-casts them into the params.  Everything is updated in place:
the state's tensors and the params' storage (the JAX step donates both
buffers to the same effect).  The step count and the schedule are 0-d
tensors on the params' device, so a step reads nothing back to the host.
The elementwise work runs through `torch._foreach_*` ops, one op of the
formula at a time.  Every python constant enters as its f32 value, as JAX
takes a python scalar (torch's CPU ops may apply a python float at double
precision).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _f32(x: float) -> float:
    """The f32 value of a python scalar, as a python float."""
    return float(np.float32(x))


def _sqrt_(ts: List[Tensor]) -> None:
    """Correctly rounded f32 square roots, in place.  On the card (and in
    XLA) f32 sqrt is; torch's vectorized CPU sqrt is within an ulp only,
    so a CPU tensor goes through f64 (exact to f32 after one rounding)."""
    if ts and ts[0].device.type == "cpu":
        for t in ts:
            t.copy_(torch.sqrt(t.double()))
    else:
        torch._foreach_sqrt_(ts)


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_frac: float = 0.1
    master_f32: bool = True


class AdamWState(NamedTuple):
    step: Tensor                      # 0-d int32
    m: List[Tensor]
    v: List[Tensor]
    master: List[Tensor]              # f32 masters (0-d zeros without)


def adamw_init(params: Sequence[Tensor], cfg: AdamWCfg) -> AdamWState:
    """Zero moments and f32 masters, each a buffer of its own (a master is
    a copy even where the param is f32 already)."""
    params = list(params)
    dev = params[0].device if params else torch.device("cpu")
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    if cfg.master_f32:
        master = [p.detach().to(torch.float32, copy=True) for p in params]
    else:
        master = [torch.zeros((), dtype=torch.float32, device=p.device)
                  for p in params]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=[z.clone() for z in zeros], master=master)


def lr_at(cfg: AdamWCfg, step: Tensor) -> Tensor:
    """The schedule at `step` (a 0-d tensor), in f32 as the JAX package
    evaluates it: linear warmup, then cosine / linear decay to
    min_lr_frac, or constant."""
    s = step.to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = _f32(cfg.min_lr_frac) + _f32((1 - cfg.min_lr_frac) * 0.5) * (
            1 + torch.cos(_f32(math.pi) * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - _f32(1 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones_like(s)
    return _f32(cfg.lr) * warm * decay


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt of the sum over tensors of each one's f32 sum of squares (the
    squares in one multi-tensor op, the per-tensor sums added at once)."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    g32 = [t.to(torch.float32) for t in tensors]
    sums = [torch.sum(sq) for sq in torch._foreach_mul(g32, g32)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float
                        ) -> Tuple[List[Tensor], Tensor]:
    """Scale by min(1, max_norm / max(norm, 1e-12)) in f32, then back to
    each gradient's dtype; returns (clipped, norm)."""
    g32 = [g.to(torch.float32) for g in grads]
    norm = global_norm(g32)
    scale = torch.clamp_max(
        _f32(max_norm) / torch.clamp_min(norm, _f32(1e-12)), 1.0)
    scaled = torch._foreach_mul(g32, scale)
    return [s.to(g.dtype) for s, g in zip(scaled, grads)], norm


def adamw_update(grads: Sequence[Tensor], state: AdamWState,
                 params: Sequence[Tensor], cfg: AdamWCfg) -> Dict[str, Tensor]:
    """One AdamW step, in place: `state` (step, m, v, masters) and the
    params' values (a bf16 param receives its f32 master rounded).
    Returns {"lr", "grad_norm"} as 0-d device tensors."""
    params = list(params)
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    g32 = [g.to(torch.float32) for g in grads]
    if not cfg.clip_norm:
        gnorm = global_norm(g32)
    state.step.add_(1)
    lr = lr_at(cfg, state.step)
    s = state.step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.b1), s)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2), s)

    torch._foreach_mul_(state.m, _f32(cfg.b1))
    torch._foreach_add_(state.m, torch._foreach_mul(g32, _f32(1 - cfg.b1)))
    torch._foreach_mul_(state.v, _f32(cfg.b2))
    sq = torch._foreach_mul(g32, g32)
    torch._foreach_mul_(sq, _f32(1 - cfg.b2))
    torch._foreach_add_(state.v, sq)
    den = torch._foreach_div(state.v, bc2)           # vhat
    _sqrt_(den)
    torch._foreach_add_(den, _f32(cfg.eps))
    upd = torch._foreach_div(state.m, bc1)           # mhat
    torch._foreach_div_(upd, den)
    base = state.master if cfg.master_f32 else \
        [p.detach().to(torch.float32) for p in params]
    if cfg.weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(base,
                                                    _f32(cfg.weight_decay)))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(base, upd)
    with torch.no_grad():
        torch._foreach_copy_(params, base)
    return {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# EMA (paper Tab. 4 uses EMA rate 0.9999 on CIFAR10)
# ---------------------------------------------------------------------------
def ema_init(params: Sequence[Tensor]) -> List[Tensor]:
    return [p.detach().to(torch.float32, copy=True) for p in params]


def ema_update(ema: Sequence[Tensor], params: Sequence[Tensor],
               rate: float) -> List[Tensor]:
    """rate * e + (1 - rate) * p in f32, written into `ema` in place."""
    for e, p in zip(ema, params):
        e.mul_(_f32(rate)).add_(p.detach().to(torch.float32)
                                * _f32(1.0 - rate))
    return list(ema)
