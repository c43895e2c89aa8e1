"""Step factories: the programs the serving engine runs each round.

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
