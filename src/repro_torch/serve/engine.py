"""Continuous-batching engines on one device: token decoding and gDDIM
sampling.

`TokenEngine` decodes one greedy token for every active slot per round.
Admission runs a batched prefill of each wave (its prompts share one
length), width-bucketed to the wave's power-of-two size, and scatters the
wave's cache rows into the slots' caches; the round step decodes every
slot at its own position (`TokenState.pos`), appends to the slot's output
row and retires on eos or budget, all on the device.  The host polls the
small done/progress mask at most every `sync_every` rounds — exactly at
the next possible retirement when no eos intervenes — and fetches the
output row of each finished slot.  On the card each layer's prefill
attention is the causal flash kernel and each decode round's attention
the one-launch `decode_attention` kernel.  The caches are lists of
batch-leading tensors, whatever the family: the admission scatter, the
parking and the resume map over every leaf, each leaf keeping its own
dtype (rwkv's S and zamba's SSM states f32, the token-shift and
convolution states and the K/V in the config's dtype).  The recurrent
states of frozen and retired rows go on advancing every round: that is
row-local garbage, as a frozen row's K/V write is, which an admission
overwrites and a resume restores.  rwkv runs no attention kernel; zamba's
shared block runs the flash kernel once a group in prefill and
`decode_attention` once a group a round.  An encoder-decoder arch
(whisper-base) also keeps an f32 encoder-memory pool, one (frontend_ctx,
d_model) row a slot, as the JAX engine does: each admission wave's frames
are encoded once at the wave's width, its prefill reads the fresh memory
in the config's dtype, and the wave's rows are merged into the pool,
which every decode round reads (so a bf16 config's decode cross-
attention runs over f32 keys); the row travels with the slot through
suspend and resume.

`DiffusionEngine` runs one gDDIM update for every active slot per round,
each slot at its own step index k and with its own sampler config (SDE
family, NFE, multistep order q, corrector, stochasticity lambda,
algorithm) and score-net precision class.  One resident engine serves
several families at once — a VPSDE preview, a CLD predictor-corrector
render and a BDM sample — in one slot pool packed at K = k_max (CLD 2;
VPSDE and BDM rows padded).  Per-slot Psi/pC/cC/B/P_chol factor pairs are
gathered from the multi-family `FactoredBank` by (state.cfg[b],
state.k[b]); the bank lives on the engine's device and is re-placed only
when a new config grows it.

A round dispatches one round step per (family, precision) class present
among the active slots, in (family registration order) x (`PRECISIONS`
order), each with the corrector variant if any of its slots wants it.  A
step is: the score-net eval of its family at its precision (the DiT, whose
attention is the hand-written flash kernel on the card), for corrector
configs the Eq. 19a predictor iterate (the `round_predict` kernel) and a
second eval, and one fused commit (the `round_fused` kernel, which also
draws the Eq. 22 noise, or for BDM reads it from the `step_noise` and
`dct2` kernels) that writes only the class's own slots.  BDM's canonical
state holds DCT coefficients: its `canonicalize` / `decanonicalize` around
every eval, on the prior and on each finished sample are the `dct2`
kernel.  Nothing is read back to the host inside a round: the host shadow
knows exactly when a slot retires, so the only device->host traffic is
each finished sample.

Samples are a pure function of (request seed, sampler config, precision):
admission draws the prior from PRNGKey(seed) and keys the step noise by
fold_in(PRNGKey(seed), _NOISE_SALT), exactly as the JAX engine does, and
every per-row computation is row-independent.  So a request's sample does
not depend on its neighbours, on their families or precisions, or on a
preemption: `serve_stream` (loop.py) parks a preempted slot's rows on the
host (`_suspend_slot`) and restores them bitwise (`_resume_slot`).

Both engines serve closed request lists (`serve`) and arrival streams with
deadline admission and preemption (`serve_stream`) on one device; mesh
mode is not ported.
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
from ..models import quantize as qtz
from ..sde.base import family_name
from .api import ServeRequest
from .loop import ServeLoop, bucket_pow2
from .parking import row_fetch, row_restore, rows_scatter
from .scheduler import Scheduler
from .state import diffusion_state_init, token_state_init


def _place(tree: Any, device: torch.device) -> Any:
    """A nested dict/list of tensors, each moved to `device` (no copy for
    one already there)."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    return tree.to(device)


class TokenEngine(ServeLoop):
    """Continuous-batching greedy decode over an `Arch` of any family (an
    encoder-decoder's requests carry `frames`).

        engine = TokenEngine(arch, params, batch_size=4, max_len=1024)
        results = engine.serve([ServeRequest(rid=0, workload="token",
                                             tokens=prompt, max_new=32)])
        # results[rid] -> np.ndarray of generated token ids (the prefill's
        # token first), at most max_new of them

    The engine is persistent: repeated `serve()` / `serve_stream()` calls
    reuse the allocated caches.  `device` defaults to "cuda"; the CPU tests
    pass device="cpu" and then every kernel wrapper runs its plain version.
    """

    def __init__(self, arch: Any, params: Any, batch_size: int, max_len: int,
                 eos_id: int = 1, sync_every: int = 8, device="cuda"):
        super().__init__(batch_size,
                         Scheduler(group_key=lambda r: r.prompt_len),
                         sync_every=sync_every)
        self.device = torch.device(device)
        self.arch = arch
        self.max_len = max_len
        self.eos_id = int(eos_id)
        self.params = _place(params, self.device)
        self.caches = arch.init_cache(batch_size, max_len, device=self.device)
        self.state = token_state_init(batch_size, max_len, device=self.device)
        self.memory = None
        if arch.encdec:
            self.memory = torch.zeros(
                (batch_size, arch.spec.frontend_ctx, arch.cfg.d_model),
                dtype=torch.float32, device=self.device)
        self._prefill = steps_lib.make_prefill_step(arch, max_len)
        self._decode = steps_lib.make_token_round_step(arch)
        self._snapshot = steps_lib.make_mask_snapshot()
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
        if r.prompt_len < 1:
            raise ValueError(f"request {r.rid}: empty prompt")
        if r.max_new < 1:
            raise ValueError(f"request {r.rid}: max_new must be >= 1 "
                             f"(got {r.max_new})")
        if r.prompt_len + r.max_new > self.max_len:
            raise ValueError(
                f"request {r.rid}: prompt_len {r.prompt_len} + max_new "
                f"{r.max_new} exceeds max_len {self.max_len}")
        if self.memory is not None:
            if r.frames is None:
                raise ValueError(f"request {r.rid}: encdec arch needs "
                                 "frames")
            if r.frames.shape != self.memory.shape[1:]:
                raise ValueError(f"request {r.rid}: frames of shape "
                                 f"{r.frames.shape}, the encoder takes "
                                 f"{tuple(self.memory.shape[1:])}")

    @torch.no_grad()
    def _admit_wave(self, group: List[ServeRequest], free: List[int]) -> None:
        # prefill width-bucketed to the wave's power-of-two size: a small
        # wave does not pay full-batch prefill FLOPs; padded rows (zero
        # prompts, zero frames) are computed and dropped at the scatter
        L, n = group[0].prompt_len, len(group)
        G = bucket_pow2(n, self.batch_size)
        toks = np.zeros((G, L), np.int32)
        for g, req in enumerate(group):
            toks[g] = req.tokens
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.memory is not None:
            # one encode a wave; its prefill reads the memory in the
            # config's dtype, the pool keeps it in f32
            frames = np.zeros((G,) + tuple(self.memory.shape[1:]),
                              np.float32)
            for g, req in enumerate(group):
                frames[g] = req.frames
            batch["memory"] = self.arch.encode_memory(
                self.params, torch.from_numpy(frames).to(self.device))
        logits_last, caches_g = self._prefill(self.params, batch)
        self.n_prefill_calls += 1
        self.prefill_widths.append(G)

        # row scatter: row g of the wave -> slot free[g]
        meta = torch.tensor([free[:n], [r.max_new for r in group]],
                            dtype=torch.int32).to(self.device)
        ids, budgets = meta[0].long(), meta[1]
        rows_scatter(self.caches, caches_g, ids, n)
        if self.memory is not None:
            self.memory[ids] = batch["memory"][:n].to(self.memory.dtype)
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
                                               self.caches, self.eos_id,
                                               memory=self.memory)
        self.n_decode_steps += 1
        for s in self.slots.active():
            s.data["n_out"] += 1

    @torch.no_grad()
    def _poll(self, results: Dict[int, np.ndarray], snap=None,
              lag: int = 0) -> int:
        busy = self.slots.active()
        if not busy:
            return 0
        # the one steady-state device fetch: the done/progress mask (in the
        # double-buffered online poll, the snapshot taken before the
        # look-ahead round: waiting on it overlaps that round's compute)
        if snap is None:
            snap = self._snapshot(self.state.active, self.state.n_out)
        active, n_out = snap.wait()
        finished = [s for s in busy if not active[s.index]]
        if finished:
            # retired rows are frozen, so the live out buffer is exact even
            # with a look-ahead round in flight
            out = self.state.out.cpu().numpy()
            for s in finished:
                n = int(n_out[s.index])
                results[s.request.rid] = out[s.index, :n].astype(np.int32)
                self.n_tokens_out += n
                self.slots.release(s.index)
        for s in self.slots.active():
            # resync the shadow from the snapshot, plus the rounds
            # dispatched after it (`lag`: the online look-ahead)
            s.data["n_out"] = int(n_out[s.index]) + lag
        return len(finished)

    def _poll_snapshot(self):
        return self._snapshot(self.state.active, self.state.n_out)

    @torch.no_grad()
    def _suspend_slot(self, slot):
        # the state row (fetched while still active), the row of every
        # cache leaf and the memory row of an encdec arch; then the device
        # row stops advancing
        i = slot.index
        payload = (row_fetch(self.state, i), row_fetch(self.caches, i),
                   None if self.memory is None else row_fetch(self.memory, i))
        self.state.active[i] = False
        return payload

    @torch.no_grad()
    def _resume_slot(self, request: ServeRequest, shadow: dict, payload,
                     index: int) -> None:
        state_row, cache_row, mem_row = payload
        row_restore(self.caches, cache_row, index)
        row_restore(self.state, state_row, index)
        if mem_row is not None:
            row_restore(self.memory, mem_row, index)

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
            ServeRequest(rid=4, seed=4, precision="int8"),    # int8 weights
        ])
        # results[rid] -> np.ndarray sample in data space

    Several families: pass ordered dicts `{family_name: spec}` /
    `{family_name: net}` (names per `sde.base.family_name`; the first is
    the default family), and requests pick theirs:

        engine = DiffusionEngine({"vpsde": spec_v, "cld": spec_c,
                                  "bdm": spec_b},
                                 {"vpsde": net_v, "cld": net_c,
                                  "bdm": net_b}, batch_size=16, nfe=20)
        engine.serve([ServeRequest(rid=0, seed=0),            # vpsde
                      ServeRequest(rid=1, seed=1, family="cld"),
                      ServeRequest(rid=2, seed=2, family="bdm", nfe=10)])

    All families share one `data_shape`.  Each family's net lives on the
    device from construction; a precision class's resident copy of it
    (`models/quantize.py`) is made on first use and kept.  `device`
    defaults to "cuda"; the CPU tests pass device="cpu" and then every
    kernel wrapper runs its plain version.
    """

    _NOISE_SALT = 0x5EED              # separates step noise from the prior
    greedy_admit = False              # one cost-class wave per admission
                                      # cycle (see ServeLoop.greedy_admit)

    def __init__(self, spec: Any, params: Any, batch_size: int,
                 nfe: Optional[int] = None,
                 default_config: Optional[SamplerConfig] = None,
                 precision: str = "f32", sync_every: int = 8,
                 device="cuda"):
        self.device = torch.device(device)
        if isinstance(spec, dict):
            specs = dict(spec)
            if not isinstance(params, dict) or set(params) != set(specs):
                raise ValueError("multi-family DiffusionEngine needs params "
                                 "as a dict with the same family names as "
                                 "spec")
            params = {n: params[n] for n in specs}     # align the orders
        else:
            name = family_name(spec.sde)
            specs, params = {name: spec}, {name: params}
        shapes = {n: tuple(s.data_shape) for n, s in specs.items()}
        if len(set(shapes.values())) != 1:
            raise ValueError("all families of one engine must share a "
                             f"data_shape; got {shapes}")
        if default_config is None:
            default_config = SamplerConfig(nfe=20 if nfe is None else nfe)
        elif nfe is not None:
            raise ValueError("pass either nfe or default_config, not both")
        super().__init__(batch_size,
                         Scheduler(group_key=lambda r: self._class_of(r)),
                         sync_every=sync_every)
        self.specs = specs
        self.spec = next(iter(specs.values()))         # the default family
        self._data_shape = next(iter(shapes.values()))
        self.cache = CoeffCache({n: s.sde for n, s in specs.items()},
                                kt={n: s.kt for n, s in specs.items()},
                                data_shape=self._data_shape,
                                device=self.device)
        if default_config.family not in (None, *specs):
            raise ValueError(f"default_config.family "
                             f"{default_config.family!r} is not resident; "
                             f"families: {list(specs)}")
        if default_config.family is None:
            default_config = dataclasses.replace(
                default_config, family=self.cache.default_family)
        self.default_config = default_config
        self.cache.index_of(self.default_config)

        self.precision = qtz.check_precision(precision)
        self.params = {n: p.to(self.device) for n, p in params.items()}
        # each (family, precision) class's resident params: the f32 class
        # is the net itself, the others are made on first use
        self._params_prec: Dict[tuple, Any] = {
            (n, "f32"): p for n, p in self.params.items()}
        self.state = diffusion_state_init(
            batch_size, self.cache.k_max, int(np.prod(self._data_shape)),
            self.cache.factored_bank.pC_blk.shape[2], device=self.device)
        self._bank_src = None
        self._bank = None
        self._refresh_bank()

        self._steps = {
            (n, prec): steps_lib.make_diffusion_round_step(
                s, fam_index=self.cache.fam_index(n), prec_index=pi,
                eps_model=qtz.wrap_eps_model(s.eps_model, prec,
                                             self.params[n]))
            for n, s in specs.items()
            for pi, prec in enumerate(qtz.PRECISIONS)}

        self.n_steps = 0                # step-program dispatches
        self.n_rounds = 0               # serving rounds (>= 1 dispatch each)
        self.n_samples_out = 0

    @property
    def families(self) -> List[str]:
        return list(self.specs)

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
        """The request's score-net precision class (the engine default when
        unset); never part of the SamplerConfig, so coefficients are the
        same at every precision."""
        return qtz.check_precision(
            self.precision if req.precision is None else req.precision)

    def _class_of(self, req: ServeRequest):
        """The admission-wave cost class: (family, corrector, precision)."""
        cfg = self.config_of(req)
        return (cfg.family, cfg.corrector, self.precision_of(req))

    def _params_for(self, fam: str, prec: str):
        """The (family, precision) class's resident params: quantized from
        the family's net on first use, then kept."""
        key = (fam, prec)
        if key not in self._params_prec:
            self._params_prec[key] = qtz.quantize_tree(self.params[fam],
                                                       prec)
        return self._params_prec[key]

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

    def _prior_row(self, fam: str, key: torch.Tensor) -> torch.Tensor:
        """(K, D) packed prior sample u(T) ~ N(0, Sigma_T) of family `fam`
        for one slot, padded to the pool's K."""
        sde = self.specs[fam].sde
        u = sde.canonicalize(sde.prior_sample(key, 1, self._data_shape))
        return pad_channels(u, self.cache.k_max)[0]

    def _project_row(self, fam: str, i: int) -> torch.Tensor:
        """Slot i's packed row -> its sample in data space, by its family."""
        sde = self.specs[fam].sde
        u = self.state.u[i:i + 1, :sde.packed_k]
        return sde.project_data(sde.decanonicalize(u, self._data_shape))[0]

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
            st.u[i] = self._prior_row(cfg.family, base)
            st.hist[i] = 0.0
            st.k[i] = 0
            st.cfg[i] = ci
            st.fam[i] = self.cache.fam_index(cfg.family)
            st.prec[i] = qtz.prec_index(prec)
            st.keys[i] = prng.to_int32_bits(prng.fold_in(base,
                                                         self._NOISE_SALT))
            st.active[i] = True
            self.slots.assign(i, req, k=0, cfg=ci, nfe=cfg.nfe,
                              family=cfg.family, pc=cfg.corrector, prec=prec)

    def _round(self) -> None:
        # one step dispatch per (family, precision) class present among the
        # active slots, with the corrector variant if any of them wants it
        # — read from the host shadow, no device fetch.  The order is (family
        # registration order) x (PRECISIONS order), as the JAX engine's
        want: Dict[tuple, bool] = {}
        for s in self.slots.active():
            cls = (s.data["family"], s.data["prec"])
            want[cls] = want.get(cls, False) or s.data["pc"]
        for fam in self.families:
            for prec in qtz.PRECISIONS:
                cls = (fam, prec)
                if cls not in want:
                    continue
                self.state = self._steps[cls](
                    self._params_for(fam, prec), self.state, self._bank,
                    with_corrector=want[cls])
                self.n_steps += 1
        self.n_rounds += 1
        for s in self.slots.active():
            s.data["k"] += 1

    @torch.no_grad()
    def _poll(self, results: Dict[int, np.ndarray], snap=None,
              lag: int = 0) -> int:
        # retirement is exactly predictable from the host shadow; `lag`
        # discounts the rounds dispatched after the poll's observation
        # point (the online look-ahead), so a slot that finishes inside the
        # look-ahead round retires at the next poll.  A finished row is
        # frozen on the device, so reading the live state is exact
        done = [s for s in self.slots.active()
                if s.data["k"] - lag >= s.data["nfe"]]
        for s in done:
            row = self._project_row(s.data["family"], s.index)
            # a copy: on the CPU the projection may be a view of the state,
            # whose row the next admission overwrites
            results[s.request.rid] = row.to("cpu", copy=True).numpy()
            self.n_samples_out += 1
            self.slots.release(s.index)
        return len(done)

    @torch.no_grad()
    def _suspend_slot(self, slot):
        # every DiffusionState leaf is batch-leading: the row (fetched while
        # still active) is u, hist, k, cfg, fam, prec, keys, active; then
        # the device row stops advancing
        row = row_fetch(self.state, slot.index)
        self.state.active[slot.index] = False
        return row

    @torch.no_grad()
    def _resume_slot(self, request: ServeRequest, shadow: dict, payload,
                     index: int) -> None:
        qb = self.state.hist.shape[1]
        hist = payload.hist
        if hist.shape[0] < qb:
            # the bank's Qb bucket grew while the row was parked: pad with
            # zeros, as `_refresh_bank` padded every resident row, so
            # resumed == never suspended, bitwise, across the regrowth
            pad = hist.new_zeros((qb - hist.shape[0],) + tuple(hist.shape[1:]))
            payload = payload._replace(hist=torch.cat([hist, pad], dim=0))
        row_restore(self.state, payload, index)

    def _remaining_lb(self, slot) -> int:
        return slot.data["nfe"] - slot.data["k"]
