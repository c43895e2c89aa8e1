"""Step factories: the programs the serving engines and the training loop
run.

  make_train_step(arch, opt)             one LM training step: the causal-LM
                                         loss, its gradient over the
                                         params' flat list, AdamW
                                         (clipping, f32 masters), in place
  make_prefill_step(arch, max_len)       batched prompt prefill -> (last
                                         position's logits, fresh caches);
                                         an encdec batch carries the
                                         encoder's "memory" or "frames"
  make_serve_step(arch)                  one-token greedy decode against
                                         fixed caches (scalar or per-slot
                                         cache_len), and an encdec arch's
                                         memory
  make_token_round_step(arch)            one greedy decode token for every
                                         slot of a TokenState, with the
                                         per-slot bookkeeping on the device
  make_mask_snapshot()                   a host copy of the token done /
                                         progress mask, taken before the
                                         online poll's look-ahead round
  make_diffusion_round_step(spec, fam,   bank-mode gDDIM round over a
                            prec)        DiffusionState: score eval, the
                                         Eq. 45 predictor + corrector eval
                                         where asked for, and the fused
                                         post-eval commit (one CUDA launch
                                         on the card, the plain version on
                                         a CPU state)
  make_diffusion_serve_step(spec,        one gDDIM step: single-config
                            coeffs)      mode over one Stage-I set, or bank
                                         mode over the packed slot state,
                                         every factor apply one
                                         `apply_factored` launch
  make_diffusion_round_step_stitched(    the pre-fusion round: bank mode
      spec, fam)                         plus the retire masking — the
                                         independent composition the fused
                                         round step is held against
  make_diffusion_train_step(spec, opt)   one DSM/HSM training step: loss,
                                         gradient through the score net,
                                         AdamW (clipping, f32 masters), all
                                         in place
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def make_diffusion_train_step(spec, opt_cfg):
    """A step (net, opt_state, batch, key) -> {"loss", "lr", "grad_norm"}
    (0-d device tensors) that takes the DSM/HSM loss of `net` on
    batch["x0"] with the `random.PRNGKey` `key`, its gradient with respect
    to `list(net.parameters())` (which must require grad:
    `net.requires_grad_()`), and one AdamW update of the params and of
    `opt_state` (an `optim.adamw.AdamWState` over the same list) in place,
    as the JAX step returns them new."""
    from ..optim.adamw import adamw_update
    spec.tables                          # Stage I, on the host, once

    def train_step(net, opt_state, batch, key):
        params = list(net.parameters())
        with torch.enable_grad():
            loss = spec.loss(net, batch["x0"], key)
            grads = torch.autograd.grad(loss, params)
        metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss.detach()
        return metrics

    return train_step


def make_train_step(arch, opt_cfg):
    """A step (params, opt_state, batch) -> {"loss", "lr", "grad_norm"}
    (0-d device tensors) that takes `arch.loss` of `batch` ("labels", and
    "tokens" or "embeddings"), its gradient with respect to
    `transformer.param_list(params)` (whose tensors must require grad),
    and one AdamW update of the params and of `opt_state` (an
    `optim.adamw.AdamWState` over the same list) in place, as the JAX step
    returns them new."""
    from ..models.transformer import param_list
    from ..optim.adamw import adamw_update

    def train_step(params, opt_state, batch):
        leaves = param_list(params)
        with torch.enable_grad():
            loss = arch.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        metrics = adamw_update(grads, opt_state, leaves, opt_cfg)
        metrics["loss"] = loss.detach()
        return metrics

    return train_step


def make_prefill_step(arch, max_len: int):
    def prefill_step(params, batch):
        return arch.prefill(params, batch, max_len)

    return prefill_step


def make_serve_step(arch):
    """One-token greedy decode: (params, token (B, 1), caches, cache_len,
    memory=None) -> (next_token (B, 1) int32, logits (B, vocab), caches).
    `cache_len` is a scalar (every row at one position) or a (B,) per-slot
    tensor; `memory` the encoder memory of an encdec arch; the caches are
    updated in place."""
    @torch.no_grad()
    def serve_step(params, token, caches, cache_len, memory=None):
        logits, caches = arch.decode(params, token, caches, cache_len,
                                     memory=memory)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, caches

    return serve_step


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
    are updated in place.  `memory` is the encoder memory pool of an
    encdec arch (one row a slot)."""
    from ..serve.state import TokenState

    @torch.no_grad()
    def round_step(params, state, caches, eos: int, memory=None):
        logits, caches = arch.decode(params, state.last, caches, state.pos,
                                     memory=memory)
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


class MaskSnapshot(NamedTuple):
    """The token done / progress mask as the double-buffered poll reads
    it: host copies of `state.active` and `state.n_out`, and on the card
    the event recorded after the copies (None on the CPU)."""
    active: torch.Tensor
    n_out: torch.Tensor
    ready: Optional[torch.cuda.Event]

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        """Block until the copies landed; (active bool, n_out int32)."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.active.numpy(), self.n_out.numpy()


def make_mask_snapshot():
    """A snapshot (active, n_out) -> `MaskSnapshot` for the double-buffered
    online poll (`ServeLoop.serve_stream`).  The loop takes it before it
    queues the look-ahead round, then waits on it: on the card the mask is
    copied into pinned host memory without blocking and an event is
    recorded after the copy, so the wait ends when the copy lands and round
    k + 1 runs meanwhile (a `.cpu()` at the wait would also wait for round
    k + 1, queued on the same stream before it).  On the CPU it is a
    copy."""
    def snap(active: torch.Tensor, n_out: torch.Tensor) -> MaskSnapshot:
        if active.device.type != "cuda":
            return MaskSnapshot(active.clone(), n_out.clone(), None)
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in (active, n_out)]
        for h, x in zip(host, (active, n_out)):
            h.copy_(x, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(active.device))
        return MaskSnapshot(host[0], host[1], ready)

    return snap


def make_diffusion_round_step(spec, fam_index: int = 0, prec_index: int = 0,
                              eps_model=None):
    """Bank-mode gDDIM step over a device-resident `DiffusionState`: the
    Eq. 19/22/45 update plus the per-slot bookkeeping — advance `k`, retire
    (clear `active`) when a slot reaches its config's NFE, and freeze
    retired and foreign rows so a finished sample survives until the host
    fetches it.

    The step evaluates this spec's score net — `eps_model` overrides it for
    a low-precision class (`models.quantize.wrap_eps_model`) — over the
    packed batch, and commits only to active slots whose `state.fam` and
    `state.prec` match this variant (`fam_index`/`prec_index`).  Everything
    stays on the state's device: no value is read back to the host."""
    from ..kernels.round_fused import ops as rf
    from ..serve.state import DiffusionState

    sde = spec.sde
    kf = sde.packed_k
    data_shape = tuple(spec.data_shape)
    state_shape = sde.state_shape(data_shape)
    model = spec.eps_model if eps_model is None else eps_model

    @torch.no_grad()
    def round_step(params, state, bank, with_corrector: bool = False):
        kc = torch.minimum(state.k.clamp_min(0),
                           bank.n_steps[state.cfg] - 1)
        t = bank.t_cur[state.cfg, kc]
        # a VPSDE or BDM family (kf 1) in a pool packed for CLD (K 2): the
        # slice is a strided view.  The DiT copies its input in patchify,
        # and BDM's decanonicalize copies it before the dct2 kernel, which
        # takes contiguous tensors only (`BDM._dct2`); at K == kf the slice
        # is the whole, contiguous tensor
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


def make_diffusion_round_step_stitched(spec, fam_index: int = 0):
    """The PRE-FUSION round step: `make_diffusion_serve_step`'s bank-mode
    chain plus the retire masking, as the JAX engine ran it before the
    fused round kernel.  Same signature and result as
    `make_diffusion_round_step`, so an engine serves through it when its
    `_steps` table holds it: the differential oracle of the fused step (on
    the CPU the two are bitwise equal; on the card each factor apply is an
    `apply_factored` launch and the noise a `step_noise` launch)."""
    from ..serve.state import DiffusionState

    bank_step = make_diffusion_serve_step(spec)

    @torch.no_grad()
    def round_step(params, state, bank, with_corrector: bool = False):
        u_next, hist_next = bank_step(
            params, state.u, state.hist, state.k, state.cfg, state.keys,
            bank, with_corrector=with_corrector)
        mine = state.active & (state.fam == fam_index)
        rmask = lambda x: mine.reshape((-1,) + (1,) * (x.dim() - 1))
        k = torch.where(mine, state.k + 1, state.k)
        return DiffusionState(
            u=torch.where(rmask(state.u), u_next, state.u),
            hist=torch.where(rmask(state.hist), hist_next, state.hist),
            k=k, cfg=state.cfg, fam=state.fam, prec=state.prec,
            keys=state.keys,
            active=torch.where(mine, k < bank.n_steps[state.cfg],
                               state.active))

    return round_step


def make_diffusion_serve_step(spec, coeffs=None):
    """One gDDIM step — the inner loop of a sampling service.  Two modes:

    * **single-config** (Stage-I `coeffs` given): a deterministic q=1
      predictor step over one coefficient set, `serve_step(params, u, k)`
      with `k` the step index 0..N-1 (advancing t_{N-k} -> t_{N-k-1}): an
      int (or 0-d tensor) when the batch steps in lockstep, or a (B,)
      tensor of per-slot indices.  Plain tensor ops (`sde.apply`,
      `sde.apply_batched`).

    * **bank mode** (`coeffs=None`): the heterogeneous-config step over
      the canonical packed slot layout, `u` (B, K, D) and `hist`
      (B, Qb, K, D), with the stacked `FactoredBank` as an argument:

          u, hist = step(params, u, hist, k, cfg, keys, bank,
                         with_corrector=...)

      with `k` / `cfg` (B,) int32 and `keys` (B, 2) int32 key words.
      Every slot b gathers its psi / pC / cC / B / P_chol factor pairs by
      (cfg[b], k[b]) — a (kf, kf) block sliced to this family's width and
      the (B, D) diagonal pool row its id points at — and applies each
      with `kernels.ei_update.ops.apply_factored` (one launch per apply on
      the card).  The Eq. 22 noise is the serving law (keyed key -> alg ->
      kc, drawn in state space by `kernels.round_fused.ops.step_noise`)
      and canonicalized by the family (BDM: the dct2 kernel).  The
      stochastic branch is computed for every slot and selected per slot;
      the corrector (`with_corrector`) is applied only to slots whose
      config asks for it and never on a slot's final step (Alg. 1).
      Slots of other families ride along and are discarded by the round
      step's family mask."""
    sde = spec.sde
    if coeffs is not None:
        N = coeffs.psi.shape[0]

        @torch.no_grad()
        def serve_step(params, u, k):
            if not torch.is_tensor(k) or k.dim() == 0:
                k = int(k)
                t = torch.full((u.shape[0],), float(coeffs.ts[N - k]),
                               dtype=torch.float32, device=u.device)
                eps = spec.eps_model(params, u, t)
                return sde.apply(coeffs.psi[k].to(u.device), u) + \
                    sde.apply(coeffs.pC[k, 0].to(u.device), eps)
            kc = k.clamp(0, N - 1).to(u.device).long()
            t = coeffs.ts.to(u.device)[N - kc]
            eps = spec.eps_model(params, u, t)
            return sde.apply_batched(coeffs.psi.to(u.device)[kc], u) + \
                sde.apply_batched(coeffs.pC.to(u.device)[kc, 0], eps)

        return serve_step

    from ..kernels.ei_update.ops import apply_factored, pad_channels
    from ..kernels.round_fused.ops import step_noise

    kf = sde.packed_k                       # this family's channel rows
    data_shape = tuple(spec.data_shape)
    state_shape = sde.state_shape(data_shape)
    n = 1
    for s_ in state_shape:
        n *= int(s_)

    @torch.no_grad()
    def bank_step(params, u, hist, k, cfg, keys, bank, with_corrector=False):
        B, K = u.shape[0], u.shape[1]
        kc = torch.minimum(k.clamp_min(0), bank.n_steps[cfg] - 1)
        t = bank.t_cur[cfg, kc]
        # this family's slice of the packed state and of each gathered
        # factor pair: (B, kf, kf) block + the (B, D) pool row it points at
        ub = u[:, :kf]
        gat = lambda nm: (getattr(bank, nm + "_blk")[cfg, kc][:, :kf, :kf],
                          bank.diag[getattr(bank, nm + "_di")[cfg, kc]])
        gatq = lambda nm, j: (
            getattr(bank, nm + "_blk")[cfg, kc, j][:, :kf, :kf],
            bank.diag[getattr(bank, nm + "_di")[cfg, kc, j]])

        eps = spec.eps_model(params, sde.decanonicalize(ub, data_shape), t)
        eps_c = sde.canonicalize(eps)                         # (B, kf, D)
        hist = torch.cat([pad_channels(eps_c, K)[:, None], hist[:, :-1]],
                         dim=1)
        Qb = hist.shape[1]

        u_lin = apply_factored(*gat("psi"), ub)
        # predictor (Eq. 19a): slots with q_c < Qb hit zero-padded pC rows
        u_pred = u_lin
        for j in range(Qb):
            u_pred = u_pred + apply_factored(*gatq("pC", j), hist[:, j, :kf])
        # stochastic branch (Eq. 22/23), computed for every slot
        noise = step_noise(keys, kc, cfg, bank.alg, n=n).reshape(
            (B,) + tuple(state_shape)).to(u.dtype)
        u_sto = u_lin + apply_factored(*gat("B"), eps_c) \
            + apply_factored(*gat("P_chol"), sde.canonicalize(noise))
        bmask = lambda m: m.reshape(-1, 1, 1)
        u_next = torch.where(bmask(bank.stochastic[cfg]), u_sto, u_pred)

        if with_corrector:
            eps_n = spec.eps_model(
                params, sde.decanonicalize(u_pred, data_shape),
                bank.t_nxt[cfg, kc])
            u_corr = u_lin + apply_factored(*gatq("cC", 0),
                                            sde.canonicalize(eps_n))
            for j in range(1, Qb):
                u_corr = u_corr + apply_factored(*gatq("cC", j),
                                                 hist[:, j - 1, :kf])
            # Alg. 1: no corrector on the final step (k == N_c - 1)
            use_c = bank.corrector[cfg] & (kc < bank.n_steps[cfg] - 1)
            u_next = torch.where(bmask(use_c), u_corr, u_next)
        # re-attach the padding rows
        return torch.cat([u_next, u[:, kf:]], dim=1), hist

    return bank_step
