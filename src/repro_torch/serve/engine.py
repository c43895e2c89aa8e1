"""Continuous-batching engines on one device: token decoding and gDDIM
sampling.

`TokenEngine` decodes one greedy token for every active slot per round.
Admission runs a batched prefill of each wave (its prompts share one
length), width-bucketed to the wave's power-of-two size, and scatters the
wave's cache rows into the slots' caches; the round step decodes every
slot at its own position (`TokenState.pos`), appends to the slot's output
row and retires on eos or budget, all on the device.  The host polls the
small done/progress mask at most every `SYNC_EVERY` rounds — exactly at
the next possible retirement when no eos intervenes — and fetches the
output row of each finished slot.  On the card each layer's prefill
attention is the causal flash kernel and each decode round's attention
the one-launch `decode_attention` kernel.

`DiffusionEngine` runs one gDDIM update for every active slot per round,
each slot at its own step index k and with its own sampler config (NFE,
multistep order q, corrector, stochasticity lambda, algorithm).  Per-slot
Psi/pC/cC/B/P_chol factor pairs are gathered from the `FactoredBank` by
(state.cfg[b], state.k[b]); the bank lives on the engine's device and is
re-placed only when a new config grows it.

A round is: the score-net eval (the DiT, whose attention is the hand-written
flash kernel on the card), for corrector configs the Eq. 19a predictor
iterate (the `round_predict` kernel) and a second eval, and one fused commit
(the `round_fused` kernel, which also draws the Eq. 22 noise, or for BDM
reads it from the `step_noise` and `dct2` kernels).  BDM's canonical state
holds DCT coefficients: its `canonicalize` / `decanonicalize` around every
eval, on the prior and on each finished sample are the `dct2` kernel.
Nothing is read back to the host inside a round: the host shadow knows
exactly when a slot retires (a slot admitted at k = 0 with NFE n retires
after n rounds), so the only device->host traffic is each finished
sample.

Samples are a pure function of (request seed, sampler config): admission
draws the prior from PRNGKey(seed) and keys the step noise by
fold_in(PRNGKey(seed), _NOISE_SALT), exactly as the JAX engine does, and
every per-row computation is row-independent.

A diffusion engine serves one SDE family (VPSDE, CLD or BDM), the "f32"
precision class (the score net runs in its config's dtype — bf16 at full
width — and returns f32 eps); a token engine the transformer family.  Both
serve closed request lists (`serve`) on one device; mesh mode,
encoder-decoder memory and streaming with preemption are not ported.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import random as prng
from ..core import CoeffCache, SamplerConfig
from ..kernels.ei_update.ops import pad_channels
from ..launch import steps as steps_lib
from ..sde.base import family_name
from .api import ServeRequest
from .loop import ServeLoop, bucket_pow2
from .scheduler import Scheduler
from .state import diffusion_state_init, token_state_init

PRECISIONS = ("f32",)


def _place(tree: Any, device: torch.device) -> Any:
    """A nested dict/list of tensors, each moved to `device` (no copy for
    one already there)."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    return tree.to(device)


class TokenEngine(ServeLoop):
    """Continuous-batching greedy decode over a transformer `Arch`.

        engine = TokenEngine(arch, params, batch_size=4, max_len=1024)
        results = engine.serve([ServeRequest(rid=0, workload="token",
                                             tokens=prompt, max_new=32)])
        # results[rid] -> np.ndarray of generated token ids (the prefill's
        # token first), at most max_new of them

    The engine is persistent: repeated `serve()` calls reuse the allocated
    caches.  `device` defaults to "cuda"; the CPU tests pass device="cpu"
    and then every kernel wrapper runs its plain version.
    """

    def __init__(self, arch: Any, params: Any, batch_size: int, max_len: int,
                 eos_id: int = 1, device="cuda"):
        super().__init__(batch_size,
                         Scheduler(group_key=lambda r: r.prompt_len))
        self.device = torch.device(device)
        self.arch = arch
        self.max_len = max_len
        self.eos_id = int(eos_id)
        self.params = _place(params, self.device)
        self.caches = arch.init_cache(batch_size, max_len, device=self.device)
        self.state = token_state_init(batch_size, max_len, device=self.device)
        self._prefill = steps_lib.make_prefill_step(arch, max_len)
        self._decode = steps_lib.make_token_round_step(arch)
        # throughput counters
        self.n_decode_steps = 0
        self.n_prefill_calls = 0
        self.n_tokens_out = 0
        # recent admission-wave widths (bounded: the engine is persistent)
        self.prefill_widths: deque = deque(maxlen=256)

    # ---- ServeLoop hooks ----------------------------------------------------
    def _validate(self, r: ServeRequest) -> None:
        if r.workload != "token":
            raise ValueError(f"request {r.rid}: workload {r.workload!r}, "
                             "this engine decodes tokens")
        if r.frames is not None:
            raise ValueError(f"request {r.rid}: encoder frames are not "
                             "served (no encdec arch is ported)")
        if r.prompt_len < 1:
            raise ValueError(f"request {r.rid}: empty prompt")
        if r.max_new < 1:
            raise ValueError(f"request {r.rid}: max_new must be >= 1 "
                             f"(got {r.max_new})")
        if r.prompt_len + r.max_new > self.max_len:
            raise ValueError(
                f"request {r.rid}: prompt_len {r.prompt_len} + max_new "
                f"{r.max_new} exceeds max_len {self.max_len}")

    @torch.no_grad()
    def _admit_wave(self, group: List[ServeRequest], free: List[int]) -> None:
        # prefill width-bucketed to the wave's power-of-two size: a small
        # wave does not pay full-batch prefill FLOPs; padded rows (zero
        # prompts) are computed and dropped at the scatter
        L, n = group[0].prompt_len, len(group)
        G = bucket_pow2(n, self.batch_size)
        toks = np.zeros((G, L), np.int32)
        for g, req in enumerate(group):
            toks[g] = req.tokens
        logits_last, caches_g = self._prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)})
        self.n_prefill_calls += 1
        self.prefill_widths.append(G)

        # row scatter: row g of the wave -> slot free[g]
        meta = torch.tensor([free[:n], [r.max_new for r in group]],
                            dtype=torch.int32).to(self.device)
        ids, budgets = meta[0].long(), meta[1]
        for (dk, dv), (sk, sv) in zip(self.caches, caches_g):
            dk[ids] = sk[:n].to(dk.dtype)
            dv[ids] = sv[:n].to(dv.dtype)
        # a slot born done (budget 1, or the prefill token is already eos)
        # starts inactive; the first poll retires it without a round
        first = torch.argmax(logits_last[:n], dim=-1).to(torch.int32)
        st = self.state
        st.last[ids, 0] = first
        st.pos[ids] = L
        st.n_out[ids] = 1
        st.budget[ids] = budgets
        st.out[ids, 0] = first
        st.active[ids] = (budgets > 1) & (first != self.eos_id)
        for g, req in enumerate(group):
            # host shadow: n_out paces polls (it may overshoot the device
            # count after an early eos — resynced at every poll, and an
            # overshoot only makes the next poll earlier, never later)
            self.slots.assign(free[g], req, n_out=1, budget=req.max_new)

    def _round(self) -> None:
        self.state, self.caches = self._decode(self.params, self.state,
                                               self.caches, self.eos_id)
        self.n_decode_steps += 1
        for s in self.slots.active():
            s.data["n_out"] += 1

    @torch.no_grad()
    def _poll(self, results: Dict[int, np.ndarray]) -> int:
        busy = self.slots.active()
        if not busy:
            return 0
        # the one steady-state device fetch: the done/progress mask
        snap = torch.stack([self.state.active.to(torch.int32),
                            self.state.n_out]).cpu().numpy()
        active, n_out = snap[0].astype(bool), snap[1]
        finished = [s for s in busy if not active[s.index]]
        if finished:
            # retired rows are frozen, so the live out buffer is exact
            out = self.state.out.cpu().numpy()
            for s in finished:
                n = int(n_out[s.index])
                results[s.request.rid] = out[s.index, :n].astype(np.int32)
                self.n_tokens_out += n
                self.slots.release(s.index)
        for s in self.slots.active():
            s.data["n_out"] = int(n_out[s.index])
        return len(finished)

    def _remaining_lb(self, slot) -> int:
        return slot.data["budget"] - slot.data["n_out"]


class DiffusionEngine(ServeLoop):
    """Continuous-batching gDDIM sampling over a heterogeneous sampler
    family.

        engine = DiffusionEngine(spec, net, batch_size=16, nfe=50)
        results = engine.serve([
            ServeRequest(rid=0, seed=0),                      # defaults
            ServeRequest(rid=1, seed=1, nfe=10),              # fast preview
            ServeRequest(rid=2, seed=2, nfe=50, q=2, corrector=True),
            ServeRequest(rid=3, seed=3, nfe=20, lam=0.5),     # stochastic
        ])
        # results[rid] -> np.ndarray sample in data space

    `device` defaults to "cuda"; the CPU tests pass device="cpu" and then
    every kernel wrapper runs its plain version.
    """

    _NOISE_SALT = 0x5EED              # separates step noise from the prior
    greedy_admit = False              # one cost-class wave per admission
                                      # cycle (see ServeLoop.greedy_admit)

    def __init__(self, spec: Any, params: torch.nn.Module, batch_size: int,
                 nfe: Optional[int] = None,
                 default_config: Optional[SamplerConfig] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if default_config is None:
            default_config = SamplerConfig(nfe=20 if nfe is None else nfe)
        elif nfe is not None:
            raise ValueError("pass either nfe or default_config, not both")
        super().__init__(batch_size,
                         Scheduler(group_key=lambda r: self._class_of(r)))
        name = family_name(spec.sde)
        self.specs = {name: spec}
        self.spec = spec
        self._data_shape = tuple(spec.data_shape)
        self.cache = CoeffCache({name: spec.sde}, kt={name: spec.kt},
                                data_shape=self._data_shape,
                                device=self.device)
        if default_config.family not in (None, name):
            raise ValueError(f"default_config.family "
                             f"{default_config.family!r} is not resident; "
                             f"families: {list(self.specs)}")
        self.default_config = dataclasses.replace(default_config, family=name)
        self.cache.index_of(self.default_config)

        self.precision = PRECISIONS[0]
        self.params = params.to(self.device)
        self.state = diffusion_state_init(
            batch_size, self.cache.k_max, int(np.prod(self._data_shape)),
            self.cache.factored_bank.pC_blk.shape[2], device=self.device)
        self._bank_src = None
        self._bank = None
        self._refresh_bank()

        self._steps = {
            (name, prec): steps_lib.make_diffusion_round_step(
                spec, fam_index=self.cache.fam_index(name), prec_index=pi)
            for pi, prec in enumerate(PRECISIONS)}

        self.n_steps = 0                # step-program dispatches
        self.n_rounds = 0               # serving rounds (>= 1 dispatch each)
        self.n_samples_out = 0

    @staticmethod
    def _check_precision(precision: str) -> str:
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: this engine serves "
                             f"{PRECISIONS}")
        return precision

    def config_of(self, req: ServeRequest) -> SamplerConfig:
        d = self.default_config
        pick = lambda v, dv: dv if v is None else v
        fam = pick(req.family, d.family)
        if fam not in self.specs:
            raise ValueError(f"unknown SDE family {fam!r}; resident "
                             f"families: {list(self.specs)}")
        return SamplerConfig(
            nfe=pick(req.nfe, d.nfe), q=pick(req.q, d.q),
            corrector=pick(req.corrector, d.corrector),
            lam=pick(req.lam, d.lam), grid=pick(req.grid, d.grid),
            family=fam, algorithm=pick(req.algorithm, d.algorithm))

    def precision_of(self, req: ServeRequest) -> str:
        return self._check_precision(
            self.precision if req.precision is None else req.precision)

    def _class_of(self, req: ServeRequest):
        """The admission-wave cost class: (family, corrector, precision)."""
        cfg = self.config_of(req)
        return (cfg.family, cfg.corrector, self.precision_of(req))

    # ---- coefficient-bank placement ----------------------------------------
    def _refresh_bank(self) -> None:
        """Pick up the bank when the CoeffCache grew it, and grow the
        state's eps-history bucket if the bank's Qb bucket grew."""
        bank = self.cache.factored_bank
        if bank is self._bank_src:
            return
        self._bank_src = self._bank = bank
        qb = bank.pC_blk.shape[2]
        hist = self.state.hist
        if hist.shape[1] < qb:
            pad = hist.new_zeros((self.batch_size, qb - hist.shape[1])
                                 + tuple(hist.shape[2:]))
            self.state = self.state._replace(
                hist=torch.cat([hist, pad], dim=1).contiguous())

    # ---- ServeLoop hooks ----------------------------------------------------
    def _validate(self, r: ServeRequest) -> None:
        try:
            self.config_of(r)
            self.precision_of(r)
        except ValueError as e:
            raise ValueError(f"request {r.rid}: {e}") from None

    def _prepare(self, requests: List[ServeRequest]) -> None:
        """Register every request's config before anything is admitted, so
        the bank restacks (and re-buckets) once up front."""
        for r in requests:
            self.cache.index_of(self.config_of(r))

    def _prior_row(self, key: torch.Tensor) -> torch.Tensor:
        """(K, D) packed prior sample u(T) ~ N(0, Sigma_T) for one slot."""
        sde = self.spec.sde
        u = sde.canonicalize(sde.prior_sample(key, 1, self._data_shape))
        return pad_channels(u, self.cache.k_max)[0]

    @torch.no_grad()
    def _admit_wave(self, group: List[ServeRequest], free: List[int]) -> None:
        cfgs = [self.config_of(req) for req in group]
        idx = [self.cache.index_of(cfg) for cfg in cfgs]
        self._refresh_bank()
        st = self.state
        for req, cfg, ci in zip(group, cfgs, idx):
            i = free.pop(0)
            prec = self.precision_of(req)
            base = prng.PRNGKey(req.seed, device=self.device)
            st.u[i] = self._prior_row(base)
            st.hist[i] = 0.0
            st.k[i] = 0
            st.cfg[i] = ci
            st.fam[i] = self.cache.fam_index(cfg.family)
            st.prec[i] = PRECISIONS.index(prec)
            st.keys[i] = prng.to_int32_bits(prng.fold_in(base,
                                                         self._NOISE_SALT))
            st.active[i] = True
            self.slots.assign(i, req, k=0, cfg=ci, nfe=cfg.nfe,
                              family=cfg.family, pc=cfg.corrector, prec=prec)

    def _round(self) -> None:
        # one step dispatch per (family, precision) class present among the
        # active slots, with the corrector variant if any of them wants it
        # — read from the host shadow, no device fetch
        want: Dict[tuple, bool] = {}
        for s in self.slots.active():
            cls = (s.data["family"], s.data["prec"])
            want[cls] = want.get(cls, False) or s.data["pc"]
        for cls, step in self._steps.items():
            if cls not in want:
                continue
            self.state = step(self.params, self.state, self._bank,
                              with_corrector=want[cls])
            self.n_steps += 1
        self.n_rounds += 1
        for s in self.slots.active():
            s.data["k"] += 1

    @torch.no_grad()
    def _poll(self, results: Dict[int, np.ndarray]) -> int:
        done = [s for s in self.slots.active() if s.data["k"] >= s.data["nfe"]]
        if not done:
            return 0
        sde, kf = self.spec.sde, self.spec.sde.packed_k
        rows = torch.stack([self.state.u[s.index, :kf] for s in done])
        samples = sde.project_data(sde.decanonicalize(rows, self._data_shape))
        samples = samples.cpu().numpy()
        for s, x in zip(done, samples):
            results[s.request.rid] = x
            self.n_samples_out += 1
            self.slots.release(s.index)
        return len(done)

    def _remaining_lb(self, slot) -> int:
        return slot.data["nfe"] - slot.data["k"]
