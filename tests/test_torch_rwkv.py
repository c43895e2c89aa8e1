"""The port's rwkv family (rwkv6-7b, RWKV6 "Finch") against the JAX
package's, on the CPU.

Both packages get the same weights — a numpy tree of the reduced config
(2 layers, d_model 64, 4 heads of 16) drawn from a seed with a random
non-zero value in every leaf, carried into the port by
`convert.from_jax_rwkv` — and the same numpy inputs.

Tiers:
  * the configs: `get_arch` gives the JAX configs' fields and parameter
    counts, full and reduced (both families);
  * the conversion: to the port and back, bitwise;
  * the recurrence: `rwkv6_chunked` and `rwkv6_sequential` (with an
    entering state) within 1e-5 of the JAX functions' scale, and the
    port's chunked form within 1e-5 of the JAX per-token form;
  * the blocks: `time_mix_apply` without a cache (padded to a whole
    chunk), with a cache and one token (the per-token step), with a cache
    and a prompt (the port's chunked prefill against JAX's per-token one),
    and `channel_mix_apply` with and without its x_prev: within 1e-5 of
    scale;
  * the model (shared with `test_torch_zamba.py` through the helpers
    below): `Arch.loss` within 1e-5 relative of the JAX loss, remat off
    and on; each gradient leaf of the port's chunked form within 1e-4 of
    its max |g| of the same model run through `rwkv6_sequential` (the
    per-token recurrence), and within GRAD_TOL = 2e-3 of
    `jax.value_and_grad` of the JAX loss.  That tolerance is the f32
    gradient's conditioning, not the port's: at the first token of a
    sequence y_0 = (r_0 . u . k_0) v_0, and where that head's variance
    is near the group norm's eps (1e-5) the normalization's derivative
    amplifies rounding in r and k — a 1-ulp perturbation of the embedding
    moves the port's own layer-0 gradients by 1.0-1.5e-4 of their scale,
    and the two frameworks' f32 products differ by several ulps (measured:
    5.6e-4 at most);  `rwkv6_chunked`'s gradient alone, with no group
    norm after it, within 1e-5 of `jax.vjp` of the JAX one;
    `Arch.prefill` (the port's chunked forms against JAX's
    per-token prefill) last logits and every cache leaf, after
    `convert.from_jax_cache`, within 1e-4 of its scale, then three decode
    steps' logits within 1e-4;
  * the `TokenEngine`: the waves, rounds, polls and greedy tokens of the
    JAX engine for the same requests (the smallest top-2 logit gap met is
    printed), and a preempted slot's stream bitwise equal to the request
    served alone;
  * `train_lm`: a preempted run resumes bitwise; its checkpoint in the
    JAX layout is read back by the JAX store leaf for leaf; a JAX train
    state, made by driving the JAX launcher's loop by hand (the JAX
    `train_lm` fails under jax 0.9, ROADMAP.md F11), resumes in the port
    and gives the next loss within 1e-5.
"""
import dataclasses
import functools
import math
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import CheckpointStore as JStore
from repro.configs import get_arch as jget
from repro.launch import steps as jsteps
from repro.models import rwkv6 as jrwkv
from repro.models.registry import Arch as JArch
from repro.optim import adamw as jadamw
from repro.serve import Arrival as JArrival
from repro.serve import ServeRequest as JRequest
from repro.serve import TokenEngine as JEngine
from repro.serve import TraceTraffic as JTrace
from repro_torch import convert
from repro_torch.ckpt.store import tree_flatten
from repro_torch.configs import get_arch as tget
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.registry import Arch as TArch
from repro_torch.models.transformer import param_list
from repro_torch.serve import (Arrival, ServeRequest, TokenEngine,
                               TraceTraffic)
from repro_torch.serve.parking import row_fetch

from tests.test_torch_lm import random_tree

TOL, MODEL_TOL, GRAD_TOL = 1e-5, 1e-4, 2e-3
NAME = "rwkv6-7b"


def max_rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def archs(name, **cfg_kw):
    """(JAX Arch, port Arch) of the reduced config, `cfg_kw` replaced on
    both (torch dtypes are never passed: every case here is f32)."""
    jspec, tspec = jget(name, reduced=True), tget(name, reduced=True)
    if cfg_kw:
        jspec = dataclasses.replace(
            jspec, cfg=dataclasses.replace(jspec.cfg, **cfg_kw))
        tspec = dataclasses.replace(
            tspec, cfg=dataclasses.replace(tspec.cfg, **cfg_kw))
    return JArch(jspec), TArch(tspec)


@functools.lru_cache(maxsize=None)
def tree(name, seed=4, **cfg_kw):
    return random_tree(archs(name, **cfg_kw)[0].param_shapes(), seed)


def port_params(name, **cfg_kw):
    return convert.from_jax_lm(tree(name, **cfg_kw),
                               archs(name, **cfg_kw)[1].cfg)


def jparams(name, **cfg_kw):
    return jax.tree.map(jnp.asarray, tree(name, **cfg_kw))


def leaves(t) -> list:
    """The tensor leaves of a nested tuple / list (a cache), in order."""
    if torch.is_tensor(t):
        return [t]
    return [x for item in t for x in leaves(item)]


# ---------------------------------------------------------------------------
# the configs, the conversion and the recurrence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [NAME, "zamba2-2.7b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_are_the_jax_numbers(name, reduced):
    """`get_arch` gives the JAX config's fields (dtypes by name), family
    and parameter count, full and reduced."""
    j, t = jget(name, reduced=reduced), tget(name, reduced=reduced)
    assert (t.name, t.family, t.input_mode) == (j.name, j.family,
                                                j.input_mode)
    jf, tf = dataclasses.asdict(j.cfg), dataclasses.asdict(t.cfg)
    assert jnp.dtype(jf.pop("dtype")).name == str(tf.pop("dtype")).split(
        ".")[-1]
    assert tf == jf
    assert t.cfg.param_count() == j.cfg.param_count()


def test_conversion_roundtrip():
    cfg = archs(NAME)[1].cfg
    params = convert.from_jax_rwkv(tree(NAME), cfg)
    assert len(params["layers"]) == cfg.n_layers
    back = convert.to_jax_rwkv(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree(NAME))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree(NAME))):
        np.testing.assert_array_equal(a, b)


def _recurrence_inputs(S=48, H=3, D=8, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = n(2, S, H, D), n(2, S, H, D), n(2, S, H, D)
    w_log = -np.exp(0.5 * n(2, S, H, D) - 1.0)
    return r, k, v, w_log, n(H, D), n(2, H, D, D)


def test_recurrence_cores_match_jax():
    r, k, v, w, u, s0 = _recurrence_inputs()
    J = [jnp.asarray(x) for x in (r, k, v, w, u)]
    T = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    jy, jS = jax.jit(jrwkv.rwkv6_chunked, static_argnums=5)(
        *J, 16, jnp.asarray(s0))
    ty, tS = trwkv.rwkv6_chunked(*T, 16, torch.from_numpy(s0))
    assert max_rel(ty, jy) <= TOL and max_rel(tS, jS) <= TOL
    jy2, jS2 = jax.jit(jrwkv.rwkv6_sequential)(*J, jnp.asarray(s0))
    ty2, tS2 = trwkv.rwkv6_sequential(*T, torch.from_numpy(s0))
    assert max_rel(ty2, jy2) <= TOL and max_rel(tS2, jS2) <= TOL
    # the chunked form is the per-token one (prefill takes it)
    assert max_rel(ty, jy2) <= TOL and max_rel(tS, jS2) <= TOL


def test_chunked_gradient_matches_jax_through_the_mask():
    """The pairwise decay is masked to -inf above the diagonal before the
    exponential: the gradient through `torch.where` stays finite, within
    1e-5 of `jax.vjp` of the JAX chunked form and 1e-4 of the port's
    per-token form's."""
    r, k, v, w, u, _ = _recurrence_inputs(S=32)
    rng = np.random.default_rng(3)
    dy = rng.standard_normal(r.shape).astype(np.float32)
    dS = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    _, vjp = jax.vjp(jax.jit(lambda *a: jrwkv.rwkv6_chunked(*a, 16)),
                     *(jnp.asarray(x) for x in (r, k, v, w, u)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dS)))
    grads = []
    for fn in (lambda *a: trwkv.rwkv6_chunked(*a, 16),
               trwkv.rwkv6_sequential):
        xs = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
        y, S = fn(*xs)
        grads.append(torch.autograd.grad(
            (y, S), xs, (torch.from_numpy(dy), torch.from_numpy(dS))))
    for a, b, c in zip(*grads, want):
        assert torch.isfinite(a).all()
        assert max_rel(a, c) <= TOL and max_rel(a, b) <= MODEL_TOL


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
def _layer0(name=NAME):
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), tree(name)["layers"])
    return jl, port_params(name)["layers"][0]


@pytest.mark.parametrize("mode", ["no cache", "decode", "prefill"])
def test_time_mix_matches_jax(mode):
    jarch, tarch = archs(NAME)
    jl, tl = _layer0()
    rng = np.random.default_rng(1)
    S = 1 if mode == "decode" else 37                # 37: padded to 48
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    cache = None
    if mode != "no cache":
        cache = (rng.standard_normal((2, 1, 64)).astype(np.float32),
                 rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    jout, jc = jax.jit(jrwkv.time_mix_apply, static_argnums=1)(
        jl["tmix"], jarch.cfg.block, jnp.asarray(x),
        None if cache is None else tuple(map(jnp.asarray, cache)))
    tout, tc = trwkv.time_mix_apply(
        tl["tmix"], tarch.cfg.block, torch.from_numpy(x),
        None if cache is None else tuple(map(torch.from_numpy, cache)))
    assert max_rel(tout, jout) <= TOL
    if cache is None:
        assert tc is None and jc is None
    else:
        for a, b in zip(tc, jc):
            assert tuple(a.shape) == b.shape and max_rel(a, b) <= TOL


def test_channel_mix_matches_jax():
    jl, tl = _layer0()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    xp = rng.standard_normal((2, 1, 64)).astype(np.float32)
    for prev in (None, xp):
        jout, jn = jrwkv.channel_mix_apply(
            jl["cmix"], jnp.asarray(x),
            None if prev is None else jnp.asarray(prev))
        tout, tn = trwkv.channel_mix_apply(
            tl["cmix"], torch.from_numpy(x),
            None if prev is None else torch.from_numpy(prev))
        assert max_rel(tout, jout) <= TOL
        assert (tn is None) == (prev is None)
        if prev is not None:
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


# ---------------------------------------------------------------------------
# the model (helpers shared with test_torch_zamba.py)
# ---------------------------------------------------------------------------
def check_loss_and_grad(name, core, grad_tol, **cfg_kw):
    """`Arch.loss` and its gradient against `jax.value_and_grad` of the
    JAX loss (one jitted program; each leaf within `grad_tol` of its max
    |g|), the port with remat off and on; and the port's gradient against
    the same port model with its chunked core `core` ((module, name,
    per-token function)) swapped for the per-token recurrence, within
    MODEL_TOL."""
    jarch = archs(name, **cfg_kw)[0]
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 256, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 40)).astype(np.int32)}
    jl, jg = jax.jit(jax.value_and_grad(jarch.loss))(
        jparams(name, **cfg_kw), {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for remat in (False, True):
        tarch = archs(name, **{**cfg_kw, "remat": remat})[1]
        params = convert.from_jax_lm(tree(name, **cfg_kw), tarch.cfg)
        ps = param_list(params)
        for t in ps:
            t.requires_grad_()
        tl = tarch.loss(params, tb)
        grads = torch.autograd.grad(tl, ps)
        assert abs(float(tl.detach()) - float(jl)) <= TOL * abs(float(jl))
        mine = {k: v for k, v in zip(_jax_names(params, tarch.cfg), grads)}
        theirs = _named_jax(jg)
        assert sorted(mine) == sorted(theirs)
        for key, g in mine.items():
            b = theirs[key]
            assert np.abs(b).max() > 0, key
            assert max_rel(g, b) <= grad_tol, key
    module, fn_name, per_token = core
    chunked = getattr(module, fn_name)
    setattr(module, fn_name, per_token)
    try:
        seq = torch.autograd.grad(tarch.loss(params, tb), ps)
    finally:
        setattr(module, fn_name, chunked)
    for key, a, b in zip(mine, grads, seq):
        assert max_rel(a, b) <= MODEL_TOL, key


def _jax_names(params, cfg) -> list:
    """Each `param_list(params)` tensor's path in the JAX tree, with the
    layer index where the JAX tree stacks it."""
    names, _ = zip(*_walk(params))
    return list(names)


def _walk(node, prefix=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], f"{prefix}{k}/")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), node


def _named_jax(jtree) -> dict:
    """The JAX gradient tree's leaves by the port's paths: the stacked
    `layers` leaves sliced per layer."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [p.key for p in path]
        a = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(a.shape[0]):
                out["/".join(["layers", str(i)] + keys[1:])] = a[i]
        else:
            out["/".join(keys)] = a
    return out


def check_prefill_and_decode(name, max_len=48, **cfg_kw):
    """Prefill of two 37-token prompts, then three decode steps: the last
    logits and every cache leaf after `from_jax_cache` within MODEL_TOL
    of its scale (the port prefills through the chunked forms, JAX through
    its per-token ones)."""
    jarch, tarch = archs(name, **cfg_kw)
    params, jp = port_params(name, **cfg_kw), jparams(name, **cfg_kw)
    toks = np.random.default_rng(2).integers(2, 256, (2, 37)).astype(
        np.int32)
    jlog, jc = jax.jit(jarch.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, max_len)
    tlog, tc = tarch.prefill(params, {"tokens": torch.from_numpy(toks)},
                             max_len)
    assert max_rel(tlog, jlog) <= MODEL_TOL
    want = leaves(convert.from_jax_cache(jax.tree.map(np.asarray, jc),
                                         tarch.cfg))
    got = leaves(tc)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if float(b.abs().max()) > 0:
            assert max_rel(a, b) <= MODEL_TOL
        else:                                   # the K/V past the prompt
            assert float(a.abs().max()) == 0
    pos = np.array([37, 37], np.int32)
    tok = np.array([[5], [9]], np.int32)
    jdec = jax.jit(jarch.decode)
    for _ in range(3):
        jlog, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        tlog, tc = tarch.decode(params, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos.copy()))
        assert max_rel(tlog, jlog) <= MODEL_TOL
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


def test_loss_and_grad_match_jax():
    check_loss_and_grad(NAME, (trwkv, "rwkv6_chunked", lambda r, k, v, w, u,
                               chunk, state0=None: trwkv.rwkv6_sequential(
                                   r, k, v, w, u, state0)), GRAD_TOL)


def test_prefill_caches_and_decode_match_jax():
    check_prefill_and_decode(NAME)


# ---------------------------------------------------------------------------
# the token engine
# ---------------------------------------------------------------------------
# batch 2; a closed list of prompts of one length (waves of width 1 and 2),
# then a stream in which request 2 arrives urgent while both slots are
# busy and preempts one
LIST_NEW = [6, 4, 6, 3, 5]
STREAM = [(0.0, 12, {}), (0.0, 12, {}),
          (3.0, 8, dict(priority=3, deadline=20.0))]


class GapArch(TArch):
    """The port's Arch, recording the smallest gap between the two largest
    logits of any row it returns (how near a greedy choice came to a
    tie)."""
    min_gap = math.inf

    def _gap(self, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        self.min_gap = min(self.min_gap, float((top[:, 0] - top[:, 1]).min()))
        return logits

    def prefill(self, *a, **k):
        logits, caches = super().prefill(*a, **k)
        return self._gap(logits), caches

    def decode(self, *a, **k):
        logits, caches = super().decode(*a, **k)
        return self._gap(logits), caches


def _requests():
    rng = np.random.default_rng(0)
    closed = [ServeRequest(rid=i, workload="token", max_new=m,
                           tokens=rng.integers(2, 256, 6).astype(np.int32))
              for i, m in enumerate(LIST_NEW)]
    stream = [ServeRequest(rid=i, workload="token", max_new=m, **kw,
                           tokens=rng.integers(2, 256, 6).astype(np.int32))
              for i, (_, m, kw) in enumerate(STREAM)]
    return closed, stream


def run_engines(name):
    """Both engines over the closed list, then the stream; each request of
    the stream served alone on the port's engine."""
    jarch, tarch = archs(name)
    closed, stream = _requests()
    jeng = JEngine(jarch, jparams(name), batch_size=2, max_len=24,
                   sync_every=4)
    garch = GapArch(tarch.spec)
    teng = TokenEngine(garch, port_params(name), batch_size=2, max_len=24,
                       sync_every=4, device="cpu")
    out = {}
    for key, eng, conv, trace in (
            ("jax", jeng, lambda rs: [JRequest.from_wire(r.to_wire())
                                      for r in rs], (JTrace, JArrival)),
            ("port", teng, list, (TraceTraffic, Arrival))):
        listed = eng.serve(conv(closed))
        counts = (eng.n_decode_steps, eng.n_prefill_calls, eng.n_polls,
                  eng.n_tokens_out, list(eng.prefill_widths))
        cls, arr = trace
        streamed = eng.serve_stream(cls([arr(t, r) for (t, *_), r in
                                         zip(STREAM, conv(stream))]))
        out[key] = (eng, counts, listed, streamed)
    print(f"{name}: smallest top-2 logit gap met by the port's engine "
          f"{garch.min_gap:.3e}")
    alone = {r.rid: teng.serve([r])[r.rid] for r in stream}
    return out, alone


def check_engine(out):
    (_, jcounts, jlisted, _), (_, tcounts, tlisted, _) = out["jax"], \
        out["port"]
    assert tcounts == jcounts
    assert 1 in tcounts[4] and 2 in tcounts[4]     # waves of width 1 and 2
    assert sorted(tlisted) == sorted(jlisted) == list(range(len(LIST_NEW)))
    for rid in jlisted:
        np.testing.assert_array_equal(tlisted[rid], np.asarray(jlisted[rid]),
                                      err_msg=f"request {rid}")


def check_stream(out, alone):
    jeng, _, _, jstreamed = out["jax"]
    teng, _, _, tstreamed = out["port"]
    assert teng.n_preemptions == jeng.n_preemptions == 1
    assert teng.n_resumes == jeng.n_resumes == 1
    assert teng.preemption_log == jeng.preemption_log
    assert len(teng.parking) == 0
    for rid in jstreamed:
        np.testing.assert_array_equal(tstreamed[rid],
                                      np.asarray(jstreamed[rid]))
        np.testing.assert_array_equal(tstreamed[rid], alone[rid])


@pytest.fixture(scope="module")
def engines():
    return run_engines(NAME)


def test_engine_serve_matches_jax(engines):
    check_engine(engines[0])


def test_engine_stream_preempts_an_rwkv_slot(engines):
    check_stream(*engines)


def test_engine_cache_rows_keep_their_dtypes(engines):
    """Every cache leaf is batch-leading and keeps its dtype through the
    admission scatter: the recurrent state S f32, the token shifts in the
    config's (here f32: the row's dtypes are those of init_cache)."""
    teng = engines[0]["port"][0]
    fresh = teng.arch.init_cache(2, 24, device="cpu")
    for live, new in zip(leaves(teng.caches), leaves(fresh)):
        assert live.dtype == new.dtype and live.shape == new.shape
    row = leaves(row_fetch(teng.caches, 1))
    assert [tuple(t.shape) for t in row] == [tuple(t.shape[1:])
                                             for t in leaves(fresh)]


# ---------------------------------------------------------------------------
# train_lm and its checkpoints
# ---------------------------------------------------------------------------
def train_args(name, **kw):
    base = dict(arch=name, reduced=True, steps=4, batch=2, seq_len=16,
                lr=3e-4, seed=0, ckpt_dir=None, ckpt_every=0, resume=False,
                log_every=0, device="cpu")
    return types.SimpleNamespace(**{**base, **kw})


def check_train_resumes(name):
    """A run preempted at step 3 (checkpoint at 2 and 3) and resumed to 4
    ends bitwise where the straight run does; the checkpoint of the JAX
    layout is read back by the JAX store, leaf for leaf equal."""
    straight = ttrain.train_lm(train_args(name))
    with tempfile.TemporaryDirectory() as d:
        cut = ttrain.train_lm(train_args(name, ckpt_dir=d, ckpt_every=2),
                              on_step=lambda s, *_: s >= 3)
        assert cut["step"] == 3
        jarch = archs(name)[0]
        like = jarch.init(jax.random.PRNGKey(0))
        step, (jp, jo) = JStore(d).restore_latest(
            (like, jadamw.adamw_init(like, jadamw.AdamWCfg())))
        assert step == 3 and int(jo.step) == 3
        mine = convert.lm_train_state_tree(cut["params"], cut["opt_state"],
                                           archs(name)[1].cfg)
        mine_leaves = [convert._to_numpy(t) for t in tree_flatten(mine)[0]]
        theirs = [np.asarray(x) for x in jax.tree.leaves((jp, jo))]
        assert len(mine_leaves) == len(theirs)
        for a, b in zip(mine_leaves, theirs):
            np.testing.assert_array_equal(a, b)
        resumed = ttrain.train_lm(train_args(name, ckpt_dir=d, resume=True))
    assert resumed["step"] == 4
    assert resumed["last_loss"] == straight["last_loss"]
    for a, b in zip(param_list(straight["params"]),
                    param_list(resumed["params"])):
        assert torch.equal(a, b)


def check_jax_state_resumes(name):
    """The JAX launcher's loop driven by hand (its init from
    PRNGKey(seed), AdamW as `train_lm` sets it, the pipeline, the jitted
    `make_train_step`): 2 steps checkpointed by the JAX store, then a
    third; the port's `train_lm --resume` restores step 2 and takes the
    third: its loss within 1e-5 of JAX's."""
    args = train_args(name, steps=5)
    jarch = archs(name)[0]
    cfg = jadamw.AdamWCfg(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    step = jax.jit(jsteps.make_train_step(jarch, cfg))
    jp = jarch.init(jax.random.PRNGKey(args.seed))
    jo = jadamw.adamw_init(jp, cfg)
    pipe = TokenPipeline(jarch.cfg.vocab, args.seq_len, args.batch,
                         args.seed)
    with tempfile.TemporaryDirectory() as d:
        for s in range(3):
            if s == 2:
                JStore(d).save(s, (jp, jo), blocking=True)
            tokens, labels = pipe.batch_at(s)
            jp, jo, jm = step(jp, jo, {"tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels)})
        run = ttrain.train_lm(train_args(name, steps=5, ckpt_dir=d,
                                         resume=True),
                              on_step=lambda s, *_: s >= 3)
    assert run["step"] == 3 and run["first_loss"] == run["last_loss"]
    assert abs(run["last_loss"] - float(jm["loss"])) \
        <= TOL * float(jm["loss"])


def test_train_lm_resumes_and_its_checkpoint_reads_in_jax():
    check_train_resumes(NAME)


def test_jax_train_state_resumes_in_the_port():
    check_jax_state_resumes(NAME)
