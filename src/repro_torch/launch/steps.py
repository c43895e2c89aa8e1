"""Step factories: the programs the serving engines run.

  make_prefill_step(arch, max_len)       batched prompt prefill -> (last
                                         position's logits, fresh caches)
  make_token_round_step(arch)            one greedy decode token for every
                                         slot of a TokenState, with the
                                         per-slot bookkeeping on the device
  make_diffusion_round_step(spec, fam)   bank-mode gDDIM round over a
                                         DiffusionState: score eval, the
                                         Eq. 45 predictor + corrector eval
                                         where asked for, and the fused
                                         post-eval commit (one CUDA launch
                                         on the card, the plain version on
                                         a CPU state)
"""
from __future__ import annotations

import torch


def make_prefill_step(arch, max_len: int):
    def prefill_step(params, batch):
        return arch.prefill(params, batch, max_len)

    return prefill_step


def make_token_round_step(arch):
    """One serving round over a device-resident `TokenState`: decode every
    slot at its own position `state.pos`, then the per-slot bookkeeping —
    append the token to the slot's output row, advance `pos`/`n_out`, and
    retire (clear `active`) on eos or when the budget is spent.  Retired
    rows are frozen: every update is masked by `state.active`, so a
    finished slot's outputs survive until the host fetches them.  Decode
    still runs on frozen rows and writes their K/V at their own, in-range
    `pos` (row-local garbage that admission overwrites), as in the JAX
    package.  The JAX step writes an inactive row's token at an
    out-of-range column and drops it; an out-of-range index is a device
    assert in torch, so here an inactive row writes its own current value
    back at column 0 instead.  Nothing is read back to the host; the caches
    are updated in place."""
    from ..serve.state import TokenState

    @torch.no_grad()
    def round_step(params, state, caches, eos: int):
        logits, caches = arch.decode(params, state.last, caches, state.pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)          # (B,)
        act = state.active
        rows = torch.arange(state.out.shape[0], device=act.device)
        col = torch.where(act, state.n_out, 0).long()
        out = state.out
        out[rows, col] = torch.where(act, nxt, out[rows, col])
        n_out = torch.where(act, state.n_out + 1, state.n_out)
        done_now = act & ((nxt == eos) | (n_out >= state.budget))
        return TokenState(
            last=torch.where(act[:, None], nxt[:, None], state.last),
            pos=torch.where(act, state.pos + 1, state.pos),
            n_out=n_out, budget=state.budget, out=out,
            active=act & ~done_now), caches

    return round_step


def make_diffusion_round_step(spec, fam_index: int = 0, prec_index: int = 0):
    """Bank-mode gDDIM step over a device-resident `DiffusionState`: the
    Eq. 19/22/45 update plus the per-slot bookkeeping — advance `k`, retire
    (clear `active`) when a slot reaches its config's NFE, and freeze
    retired and foreign rows so a finished sample survives until the host
    fetches it.

    The step evaluates this spec's score net over the packed batch, and
    commits only to active slots whose `state.fam` and
    `state.prec` match this variant (`fam_index`/`prec_index`).  Everything
    stays on the state's device: no value is read back to the host."""
    from ..kernels.round_fused import ops as rf
    from ..serve.state import DiffusionState

    sde = spec.sde
    kf = sde.packed_k
    data_shape = tuple(spec.data_shape)
    state_shape = sde.state_shape(data_shape)
    model = spec.eps_model

    @torch.no_grad()
    def round_step(params, state, bank, with_corrector: bool = False):
        kc = torch.minimum(state.k.clamp_min(0),
                           bank.n_steps[state.cfg] - 1)
        t = bank.t_cur[state.cfg, kc]
        ub = state.u[:, :kf]
        eps = model(params, sde.decanonicalize(ub, data_shape), t)
        eps_c = sde.canonicalize(eps).contiguous()
        eps_n_c = None
        if with_corrector:
            # Eq. 45: second eval at the predictor iterate
            u_pred = rf.round_predict(state.u, state.hist, kc, state.cfg,
                                      bank, eps_c, kf=kf)
            eps_n = model(params, sde.decanonicalize(u_pred, data_shape),
                          bank.t_nxt[state.cfg, kc])
            eps_n_c = sde.canonicalize(eps_n).contiguous()
        u2, h2, k2, a2 = rf.round_update(
            state.u, state.hist, state.k, kc, state.cfg, state.fam,
            state.prec, state.keys, state.active, bank, eps_c,
            sde=sde, state_shape=state_shape, kf=kf, fam_index=fam_index,
            prec_index=prec_index, with_corrector=with_corrector,
            eps_n_c=eps_n_c)
        return DiffusionState(u=u2, hist=h2, k=k2, cfg=state.cfg,
                              fam=state.fam, prec=state.prec,
                              keys=state.keys, active=a2)

    return round_step
