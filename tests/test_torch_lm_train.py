"""The port's LM training path against the JAX package's, on the CPU: the
causal / window / GQA attention backward, the causal-LM loss and its
gradient on every reduced dense config, the training step, the training
loop and its checkpoints across the two packages, the CLI, and the
one-token serve step.

Both packages get the same weights — a numpy tree drawn from a seed with
a random non-zero value in every leaf, carried into the port by
`convert.from_jax_transformer` — and the same numpy-seeded batches.

Tiers:
  * `attention_bwd_ref` (causal, window 16 or global, S 40, rep 1 / 4 /
    7, head width 16 / 64) within 1e-5 of each gradient's max |g| of
    `jax.vjp` through the JAX package's `attention_ref` and of torch
    autograd through the port's (f32 sums in other orders);
  * `Arch.loss` within 1e-5 relative and each gradient leaf within 1e-4
    of its max |g| of `jax.value_and_grad` of the JAX `Arch.loss`, on
    every reduced dense config (internvl2-1b through `embeddings`), and
    with remat on; `causal_lm_loss` with ignored labels and `relu2`
    within 1e-6;
  * five steps of `make_train_step` against JAX's jitted one: losses
    within 1e-5 relative, grad norms within 1e-4 (the same f32 maths in
    other orders; AdamW's first steps move each parameter by about lr *
    sign(g), so the trajectories stay close), the schedule's lr within
    1e-6 (XLA's and torch's f32 cos differ by an ulp);
  * bitwise: a restart from the port's checkpoint (the mirror of
    `tests/test_train_integration.py::test_checkpoint_restart_exact`, on
    reduced deepseek-coder-33b), a preempted and resumed `train_lm`, the
    port's checkpoint leaves read by the JAX store; a checkpoint of the
    JAX launcher's loop resumed by the port gives the next loss within
    1e-5;
  * `make_serve_step` on every ported arch: equal next tokens, logits
    within 1e-5 of max |logits|.
"""
import dataclasses
import functools
import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import CheckpointStore as JStore
from repro.configs import get_arch as jget
from repro.kernels.attention.ref import attention_ref as jattention_ref
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models.registry import Arch as JArch
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.ckpt.store import (CheckpointStore, tree_flatten,
                                    tree_unflatten)
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_arch as tget
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_bwd_ref, attention_ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models.registry import Arch as TArch
from repro_torch.models.registry import ArchSpec
from repro_torch.models.transformer import param_list
from repro_torch.optim import adamw as tadamw

DENSE = ["gemma3-1b", "deepseek-coder-33b", "nemotron-4-15b", "llama3-405b",
         "internvl2-1b"]


def max_rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def random_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(leaf):
        fan_in = leaf.shape[-2] if leaf.ndim >= 2 else 8
        return (rng.standard_normal(leaf.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, shapes)


def archs(name, **cfg_kw):
    """(JAX Arch, port Arch) of the reduced config, with `cfg_kw` replaced
    on both."""
    jspec, tspec = jget(name, reduced=True), tget(name, reduced=True)
    if cfg_kw:
        jspec = dataclasses.replace(
            jspec, cfg=dataclasses.replace(jspec.cfg, **cfg_kw))
        tspec = dataclasses.replace(
            tspec, cfg=dataclasses.replace(tspec.cfg, **cfg_kw))
    return JArch(jspec), TArch(tspec)


@functools.lru_cache(maxsize=None)
def weights(name, seed=3, **cfg_kw):
    """(jarch, tarch, the numpy tree): one set of weights for both."""
    jarch, tarch = archs(name, **cfg_kw)
    return jarch, tarch, random_tree(jarch.param_shapes(), seed)


def port_params(tarch, tree, grad=False):
    params = convert.from_jax_lm(tree, tarch.cfg)
    for t in param_list(params):
        t.requires_grad_(grad)
    return params


def lm_batch(spec, seed, B=2, S=16):
    """numpy batch: tokens and labels from the pipeline, or embeddings
    for an "embeddings" arch."""
    tokens, labels = TokenPipeline(spec.cfg.vocab, S, B, seed).batch_at(0)
    if spec.input_mode == "embeddings":
        emb = (0.02 * np.random.default_rng(seed).standard_normal(
            (B, S, spec.cfg.d_model))).astype(np.float32)
        return {"embeddings": emb, "labels": labels}
    return {"tokens": tokens, "labels": labels}


def grads_jax_layout(tarch, params, grads):
    """The port's flat gradient list -> the JAX tree's numpy leaves."""
    structure = tree_flatten(params)[1]
    return jax.tree.leaves(convert.to_jax_transformer(
        tree_unflatten(structure, list(grads)), tarch.cfg))


# ---------------------------------------------------------------------------
# attention backward: the causal / window / GQA form
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,rep,dh", [
    (None, 1, 16), (16, 1, 64), (None, 4, 64), (16, 4, 16), (None, 7, 16),
    (16, 7, 64)])
def test_attention_bwd_causal_against_jax(window, rep, dh):
    B, S, Hkv = 2, 40, 2
    rng = np.random.default_rng(rep * 100 + dh)
    q, do = (rng.standard_normal((B, S, Hkv * rep, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
            for _ in range(2))
    mine = attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v, do)),
                             causal=True, window=window)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    attention_ref(*leaves, causal=True, window=window).backward(
        torch.from_numpy(do))
    theirs = jax.jit(lambda *a: jax.vjp(lambda x, y, z: jattention_ref(
        x, y, z, causal=True, window=window), *a[:3])[1](a[3]))(q, k, v, do)
    for m, auto, t in zip(mine, leaves, theirs):
        assert m.dtype == torch.float32 and m.shape == auto.shape
        assert max_rel(m, auto.grad) <= 1e-5
        assert max_rel(m, t) <= 1e-5


def test_attention_bwd_window_one_and_dit_form():
    """The DiT form keeps its formula bit for bit; at window 1 every row
    attends itself only, so dq and dk are 0 and dv is dO summed over the
    query heads of each kv head."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 16, 2, 32)).astype(np.float32)) for _ in range(4))
    dq, dk, dv = attention_bwd_ref(q, k, v, do)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32.0),
                      dim=-1)
    assert torch.equal(dv, torch.einsum("bhqk,bqhd->bkhd", p, do))
    kk, vv = k[:, :, :1], v[:, :, :1]
    dq, dk, dv = attention_bwd_ref(q, kk, vv, do, causal=True, window=1)
    assert float(dq.abs().max()) == 0 and float(dk.abs().max()) == 0
    torch.testing.assert_close(dv[:, :, 0], do.sum(2), rtol=0, atol=1e-6)


def test_lm_attention_goes_through_the_function():
    """On the CPU the causal form with grad at q_offset 0 and Sq == Sk
    runs `FlashAttention` (forward `attention_ref`, backward
    `attention_bwd_ref`); without grad the plain forward alone, the same
    values bit for bit; a prefill-shaped call (Sq != Sk) with grad goes
    through autograd of the plain version."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 12, 4, 16, generator=gen)
    k = torch.randn(2, 12, 2, 16, generator=gen)
    ql = q.clone().requires_grad_()
    out = attn_ops.attention(ql, k, k, causal=True, window=5)
    assert "FlashAttention" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(out, attn_ops.attention(q, k, k, causal=True,
                                                   window=5))
    g, = torch.autograd.grad(out, ql, torch.ones_like(out))
    want = attention_bwd_ref(q, k, k, torch.ones_like(out), causal=True,
                             window=5)[0]
    assert torch.equal(g, want)
    pre = attn_ops.attention(ql[:, :4], k, k, causal=True, q_offset=3)
    assert "Function" not in type(pre.grad_fn).__name__


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------
def test_causal_lm_loss_with_ignored_labels_and_relu2():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 5] = -1
    for lab in (labels, np.full_like(labels, -1)):
        want = float(jcommon.causal_lm_loss(jnp.asarray(logits),
                                            jnp.asarray(lab)))
        got = float(tcommon.causal_lm_loss(torch.from_numpy(logits),
                                           torch.from_numpy(lab)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (got, want)
    assert got == 0.0
    x = rng.standard_normal(50).astype(np.float32) * 2
    np.testing.assert_allclose(
        tcommon.activation("relu2", torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.activation("relu2", jnp.asarray(x))), rtol=1e-6,
        atol=0)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grad(name):
    """`jax.value_and_grad` of the JAX `Arch.loss`, jitted once per arch."""
    return jax.jit(jax.value_and_grad(weights(name)[0].loss))


@pytest.mark.parametrize("name,remat", [(n, False) for n in DENSE]
                         + [("gemma3-1b", True)])
def test_loss_and_grad_against_jax(name, remat):
    """remat=True runs the port's per-layer checkpointing (its values do
    not depend on it) against the same JAX program."""
    jarch, tarch, tree = weights(name)
    if remat:
        tarch = TArch(dataclasses.replace(tarch.spec, cfg=dataclasses.replace(
            tarch.cfg, remat=True)))
    batch = lm_batch(tarch.spec, seed=7)
    jl, jg = jax_loss_and_grad(name)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = port_params(tarch, tree, grad=True)
    tl = tarch.loss(params, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    grads = torch.autograd.grad(tl, param_list(params))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    mine = grads_jax_layout(tarch, params, grads)
    theirs = jax.tree.leaves(jg)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape and np.abs(np.asarray(b)).max() > 0
        assert max_rel(a, b) <= 1e-4


def test_conversion_roundtrip_with_remainder_layers():
    """8 layers of the 6-wide pattern: one group and two remainder
    layers, laid out and back bit for bit."""
    jarch, tarch, tree = weights("gemma3-1b", n_layers=8)
    back = convert.to_jax_transformer(
        convert.from_jax_transformer(tree, tarch.cfg), tarch.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the training step and loop
# ---------------------------------------------------------------------------
# AdamW as `train_lm` sets it for 5 steps: warmup 5, the default weight
# decay; one jitted JAX step shared by the step and checkpoint tests
STEPS = 5
STEP_CFG = dict(lr=3e-4, warmup_steps=max(STEPS // 20, 5), total_steps=STEPS)


@functools.lru_cache(maxsize=None)
def jax_train_step():
    jarch = weights("gemma3-1b")[0]
    return jax.jit(jsteps.make_train_step(jarch, jadamw.AdamWCfg(
        **STEP_CFG)))


def test_train_steps_against_jax():
    jarch, tarch, tree = weights("gemma3-1b")
    pipe = TokenPipeline(tarch.cfg.vocab, 16, 2, seed=1)
    jstep = jax_train_step()
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw.adamw_init(jp, jadamw.AdamWCfg(**STEP_CFG))
    cfg = tadamw.AdamWCfg(**STEP_CFG)
    params = port_params(tarch, tree, grad=True)
    st = tadamw.adamw_init(param_list(params), cfg)
    step = tsteps.make_train_step(tarch, cfg)
    for i in range(STEPS):
        tokens, labels = pipe.batch_at(i)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(labels)})
        m = step(params, st, {"tokens": torch.from_numpy(tokens),
                              "labels": torch.from_numpy(labels)})
        assert abs(float(m["loss"]) - float(jm["loss"])) \
            <= 1e-5 * float(jm["loss"]), i
        assert abs(float(m["lr"]) - float(jm["lr"])) \
            <= 1e-6 * float(jm["lr"])            # XLA's and torch's f32 cos
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-4 * float(jm["grad_norm"])
    assert int(st.step) == STEPS


def _run_steps(arch, params, opt, step_fn, pipe, start, n):
    losses = []
    for s in range(start, start + n):
        tokens, labels = pipe.batch_at(s)
        m = step_fn(params, opt, {"tokens": torch.from_numpy(tokens),
                                  "labels": torch.from_numpy(labels)})
        losses.append(float(m["loss"]))
    return losses


def _fresh(arch, seed, cfg):
    params = arch.init(seed=seed, device="cpu")
    for t in param_list(params):
        t.requires_grad_()
    return params, tadamw.adamw_init(param_list(params), cfg)


def test_lm_loss_decreases():
    """`tests/test_train_integration.py::test_lm_loss_decreases` on the
    port: reduced gemma3-1b, 40 steps, the last 5 losses 0.3 below the
    first 5."""
    arch = TArch(tget("gemma3-1b", reduced=True))
    cfg = tadamw.AdamWCfg(lr=1e-3, warmup_steps=5, total_steps=60,
                          weight_decay=0.0)
    params, opt = _fresh(arch, 0, cfg)
    pipe = TokenPipeline(vocab=arch.cfg.vocab, seq_len=32, global_batch=8)
    losses = _run_steps(arch, params, opt,
                        tsteps.make_train_step(arch, cfg), pipe, 0, 40)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::8]


def test_checkpoint_restart_exact():
    """`tests/test_train_integration.py::test_checkpoint_restart_exact` on
    the port: reduced deepseek-coder-33b, 6 steps == (3 steps, save,
    restore into fresh weights, 3 steps) bit for bit."""
    arch = TArch(tget("deepseek-coder-33b", reduced=True))
    cfg = tadamw.AdamWCfg(lr=1e-3, warmup_steps=2, total_steps=10,
                          weight_decay=0.0)
    pipe = TokenPipeline(vocab=arch.cfg.vocab, seq_len=16, global_batch=4)
    step_fn = tsteps.make_train_step(arch, cfg)
    pA, oA = _fresh(arch, 1, cfg)
    _run_steps(arch, pA, oA, step_fn, pipe, 0, 6)
    with tempfile.TemporaryDirectory() as d:
        store = CheckpointStore(d)
        pB, oB = _fresh(arch, 1, cfg)
        _run_steps(arch, pB, oB, step_fn, pipe, 0, 3)
        store.save(3, convert.lm_train_state_tree(pB, oB, arch.cfg),
                   blocking=True)
        pC, oC = _fresh(arch, 2, cfg)
        step, restored = store.restore_latest(
            convert.lm_train_state_tree(pC, oC, arch.cfg))
        assert step == 3
        convert.load_lm_train_state(pC, oC, restored, arch.cfg)
        _run_steps(arch, pC, oC, step_fn, pipe, 3, 3)
    for a, b in zip(param_list(pA), param_list(pC)):
        assert torch.equal(a, b)
    assert int(oA.step) == int(oC.step) == 6


def _args(**kw):
    base = dict(arch="gemma3-1b", reduced=True, steps=6, batch=2,
                seq_len=16, lr=3e-4, seed=0, ckpt_dir=None, ckpt_every=0,
                resume=False, log_every=0, device="cpu")
    return types.SimpleNamespace(**{**base, **kw})


def test_train_lm_preempted_run_resumes_bitwise():
    straight = ttrain.train_lm(_args())
    with tempfile.TemporaryDirectory() as d:
        cut = ttrain.train_lm(_args(ckpt_dir=d, ckpt_every=2),
                              on_step=lambda s, *_: s >= 3)
        assert cut["step"] == 3 and int(cut["opt_state"].step) == 3
        assert sorted(n for n in os.listdir(d) if n.startswith("step_")) \
            == ["step_2", "step_3"]
        resumed = ttrain.train_lm(_args(ckpt_dir=d, resume=True))
    assert resumed["step"] == 6 and resumed["last_loss"] == \
        straight["last_loss"]
    for a, b in zip(param_list(straight["params"]),
                    param_list(resumed["params"])):
        assert torch.equal(a, b)


def test_train_lm_embeddings_arch_and_other_families():
    """internvl2-1b trains through its stub embeddings (drawn from the
    step's key); a spec of a family the port does not have is refused."""
    run = ttrain.train_lm(_args(arch="internvl2-1b", steps=2))
    assert np.isfinite(run["last_loss"])
    other = ArchSpec(name="mlp-mixer", family="mixer", cfg=None)
    with pytest.raises(NotImplementedError, match="not a family"):
        ttrain.train_lm(_args(), spec=other)


def test_train_main_runs_and_resumes():
    with tempfile.TemporaryDirectory() as d:
        common = ["--arch", "gemma3-1b", "--reduced", "--seq-len", "16",
                  "--batch", "2", "--ckpt-dir", d, "--log-every", "0",
                  "--device", "cpu"]
        assert ttrain.main(common + ["--steps", "4", "--ckpt-every", "2"]) \
            == 0
        assert sorted(n for n in os.listdir(d) if n.startswith("step_")) \
            == ["step_2", "step_4"]
        assert ttrain.main(common + ["--steps", "6", "--resume"]) == 0
        assert open(os.path.join(d, "latest")).read() == "step_6"


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
def test_jax_checkpoint_resumes_in_the_port():
    """The JAX launcher's loop on reduced gemma3-1b — its init from
    PRNGKey(seed), AdamW as `train_lm` sets it, the pipeline, the jitted
    `make_train_step` — takes 2 steps and checkpoints them with the JAX
    store, then a third; the port's `train_lm --resume` restores step 2
    and takes the third (then stops): its loss within 1e-5 of JAX's.  (The JAX
    `train_lm` itself fails under jax 0.9 before its first step, F11.)"""
    args = _args(steps=STEPS)
    jarch = weights(args.arch)[0]
    cfg = jadamw.AdamWCfg(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    assert cfg == jadamw.AdamWCfg(**STEP_CFG)
    jp = jarch.init(jax.random.PRNGKey(args.seed))
    jo = jadamw.adamw_init(jp, cfg)
    pipe = TokenPipeline(jarch.cfg.vocab, args.seq_len, args.batch,
                         args.seed)
    with tempfile.TemporaryDirectory() as d:
        for s in range(3):
            if s == 2:
                JStore(d).save(s, (jp, jo), blocking=True)
            tokens, labels = pipe.batch_at(s)
            jp, jo, jm = jax_train_step()(
                jp, jo, {"tokens": jnp.asarray(tokens),
                         "labels": jnp.asarray(labels)})
        run = ttrain.train_lm(_args(steps=STEPS, ckpt_dir=d, resume=True),
                              on_step=lambda step, *_: step >= 3)
    assert run["step"] == 3 and run["first_loss"] == run["last_loss"]
    assert abs(run["last_loss"] - float(jm["loss"])) \
        <= 1e-5 * float(jm["loss"])


def test_port_checkpoint_restores_in_jax():
    """The port's `train_lm` checkpoint, read by the JAX store into the
    JAX tree of (params, AdamWState): every leaf equal to the port's."""
    with tempfile.TemporaryDirectory() as d:
        run = ttrain.train_lm(_args(steps=2, ckpt_dir=d))
        jarch = JArch(jget("gemma3-1b", reduced=True))
        cfg = jadamw.AdamWCfg()
        like = jarch.init(jax.random.PRNGKey(0))
        step, (jp, jo) = JStore(d).restore_latest(
            (like, jadamw.adamw_init(like, cfg)))
    assert step == 2 and int(jo.step) == 2
    tcfg = TArch(tget("gemma3-1b", reduced=True)).cfg
    mine = convert.lm_train_state_tree(run["params"], run["opt_state"],
                                       tcfg)
    theirs = (jp, jo)
    mine_leaves = [convert._to_numpy(t) for t in tree_flatten(mine)[0]]
    their_leaves = [np.asarray(x) for x in jax.tree.leaves(theirs)]
    assert len(mine_leaves) == len(their_leaves)
    for a, b in zip(mine_leaves, their_leaves):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the one-token serve step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCH_IDS)
def test_serve_step_matches_jax(name):
    """Four greedy steps from empty caches, the rows at their own
    positions (0 and 3), through both packages' `make_serve_step` (an
    encdec arch's with one numpy memory): equal next tokens, logits within
    1e-5 of max |logits|."""
    jarch, tarch, tree = weights(name)
    jstep = jax.jit(jsteps.make_serve_step(jarch))
    tstep = tsteps.make_serve_step(tarch)
    params = port_params(tarch, tree)
    jp = jax.tree.map(jnp.asarray, tree)
    jc, tc = jarch.init_cache(2, 8), tarch.init_cache(2, 8, device="cpu")
    mem = None
    if tarch.spec.family == "encdec":
        mem = np.random.default_rng(0).standard_normal(
            (2, tarch.spec.frontend_ctx, tarch.cfg.d_model)).astype(
                np.float32)
    jmem, tmem = ((None, None) if mem is None
                  else (jnp.asarray(mem), torch.from_numpy(mem)))
    tok = np.array([[5], [9]], np.int32)
    pos = np.array([0, 3], np.int32)
    jt, tt = tok, tok
    for _ in range(4):
        jt, jl, jc = jstep(jp, jnp.asarray(jt), jc, jnp.asarray(pos), jmem)
        tt, tl, tc = tstep(params, torch.from_numpy(np.asarray(tt)), tc,
                           torch.from_numpy(pos), tmem)
        assert tt.dtype == torch.int32 and tt.shape == (2, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert max_rel(tl, jl) <= 1e-5
        pos = pos + 1
