"""The port's optimizer, data pipelines and checkpoint store against the
JAX package's (`repro.optim.adamw`, `repro.data.pipeline`,
`repro.ckpt.store`), on the CPU.

Tiers:
  * bitwise: both pipelines (the same numpy function of (seed, step,
    process index)), the schedule's warmup/decay points that are exact in
    f32, checkpoint leaves and their order across the two packages;
  * bitwise: AdamW params, masters and moments on equal gradients without
    clipping against JAX's eager update (op by op, each correctly
    rounded; the port takes python constants at their f32 values and a
    correctly rounded sqrt), and EMA; within 1 ulp: the schedule (XLA's
    and torch's own f32 cos).  With clipping the two global norms are sums in
    another order, so the clipped gradients differ by an ulp: params and
    masters stay within 1 ulp, the moments (which cancel towards zero)
    within 1e-6 of their scale;
  * the port's own store mirrors `tests/test_optim_ckpt_data.py`
    (roundtrip, async then wait, an uncommitted step ignored, keep/gc).
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import CheckpointStore as JStore
from repro.configs import get_diffusion as jget
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.ckpt.store import SENTINEL, CheckpointStore, tree_flatten
from repro_torch.configs import get_diffusion as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw


def ulps(a, b) -> int:
    """Largest distance between two f32 arrays in units of the last place
    (from the bit patterns; the values compared agree in sign)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
SHAPES = [(5, 3), (7,), (2, 2, 4)]


def _run_adamw(cfg, dtype, n_steps=6, seed=0, grad_scale=1.0):
    """The same params and grads through both optimizers; returns the
    (params, masters, m, v) of each side as numpy f32."""
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[(grad_scale * rng.standard_normal(s)).astype(np.float32)
           for s in SHAPES] for _ in range(n_steps)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = [jnp.asarray(p, jdt) for p in p0]
    jst = jadamw.adamw_init(jp, cfg)
    tp = [torch.from_numpy(p).to(dtype) for p in p0]
    tst = tadamw.adamw_init(tp, cfg)
    for g in gs:
        jg = [jnp.asarray(x, jdt) for x in g]
        jp, jst, jm = jadamw.adamw_update(jg, jst, jp, cfg)
        tm = tadamw.adamw_update([torch.from_numpy(x).to(dtype) for x in g],
                                 tst, tp, cfg)
        assert ulps(np.asarray(jm["lr"]), tm["lr"].numpy()) <= 1
        np.testing.assert_allclose(np.asarray(jm["grad_norm"]),
                                   tm["grad_norm"].numpy(), rtol=1e-6)
    j = [np.concatenate([np.asarray(x.astype(jnp.float32)).ravel()
                         for x in xs])
         for xs in (jp, jst.master, jst.m, jst.v)]
    t = [np.concatenate([x.float().numpy().ravel() for x in xs])
         for xs in (tp, tst.master, tst.m, tst.v)]
    assert int(jst.step) == int(tst.step) == n_steps
    return j, t


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_f32_bitwise(schedule):
    cfg = jadamw.AdamWCfg(lr=1e-2, warmup_steps=2, total_steps=8,
                          schedule=schedule, clip_norm=0.0,
                          weight_decay=0.1)
    j, t = _run_adamw(cfg, torch.float32, grad_scale=3.0)
    for name, a, b in zip(("params", "master", "m", "v"), j, t):
        assert ulps(a, b) == 0, name


def test_adamw_f32_clipped():
    """Clipping: the clipped gradients within 1 ulp of JAX's; after six
    clipped steps params and masters within 2 ulp, moments within 1e-6 of
    their scale."""
    rng = np.random.default_rng(3)
    g = [(3 * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
    jc, jn = jadamw.clip_by_global_norm([jnp.asarray(x) for x in g], 1.0)
    tc, tn = tadamw.clip_by_global_norm([torch.from_numpy(x) for x in g],
                                        1.0)
    assert ulps(jn, tn.numpy()) <= 1
    for a, b in zip(jc, tc):
        assert ulps(a, b.numpy()) <= 1
    cfg = jadamw.AdamWCfg(lr=1e-2, warmup_steps=2, total_steps=8,
                          clip_norm=1.0, weight_decay=0.1)
    j, t = _run_adamw(cfg, torch.float32, grad_scale=3.0)
    for name, a, b in zip(("params", "master", "m", "v"), j, t):
        if name in ("m", "v"):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())
        else:
            assert ulps(a, b) <= 2, name


def test_adamw_bf16_params_f32_masters():
    """bf16 compute params, f32 masters: masters and moments within 1 ulp,
    the bf16 params equal to their masters rounded (and to JAX's)."""
    cfg = jadamw.AdamWCfg(lr=1e-3, warmup_steps=0, total_steps=100,
                          schedule="constant", clip_norm=1.0,
                          weight_decay=0.0)
    j, t = _run_adamw(cfg, torch.bfloat16)
    for name, a, b in zip(("master", "m", "v"), j[1:], t[1:]):
        assert ulps(a, b) <= 1, name
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(t[0], bf(t[1]))
    mismatched = np.flatnonzero(j[0] != t[0])
    # a bf16 param differs only where its master sat on a rounding tie
    for i in mismatched:
        assert ulps(j[1][i], t[1][i]) == 1


def test_adamw_lr_schedule_and_clip_and_ema():
    cfg = tadamw.AdamWCfg(lr=1.0, warmup_steps=10, total_steps=100,
                          schedule="cosine", min_lr_frac=0.1)
    at = lambda s: float(tadamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
    assert at(0) == 0.0 and at(10) == pytest.approx(1.0)
    assert at(100) == pytest.approx(0.1, rel=1e-5)
    jcfg = jadamw.AdamWCfg(lr=1.0, warmup_steps=10, total_steps=100,
                           schedule="cosine", min_lr_frac=0.1)
    for s in (0, 3, 10, 37, 99, 100, 150):
        assert ulps(jadamw.lr_at(jcfg, jnp.int32(s)), at(s)) <= 1
    clipped, norm = tadamw.clip_by_global_norm([torch.ones(10) * 10.0], 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(tadamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    e = tadamw.ema_init([torch.ones(2)])
    tadamw.ema_update(e, [torch.zeros(2)], 0.9)
    je = jadamw.ema_update(jadamw.ema_init({"w": jnp.ones(2)}),
                           {"w": jnp.zeros(2)}, 0.9)
    np.testing.assert_array_equal(e[0].numpy(), np.asarray(je["w"]))


def test_adamw_converges_on_quadratic():
    cfg = tadamw.AdamWCfg(lr=0.1, weight_decay=0.0, warmup_steps=1,
                          total_steps=200, clip_norm=0.0)
    w = torch.tensor([3.0, -2.0])
    st = tadamw.adamw_init([w], cfg)
    for _ in range(200):
        tadamw.adamw_update([2 * (w - 1.0)], st, [w], cfg)
    np.testing.assert_allclose(w.numpy(), [1.0, 1.0], atol=1e-2)


# ---------------------------------------------------------------------------
# data pipelines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 3, 12])
@pytest.mark.parametrize("proc", [0, 1])
def test_pipelines_bitwise(step, proc):
    kw = dict(seed=7, n_process=2, process_index=proc)
    jt = jpipe.TokenPipeline(vocab=100, seq_len=16, global_batch=8, **kw)
    tt = tpipe.TokenPipeline(vocab=100, seq_len=16, global_batch=8, **kw)
    for a, b in zip(jt.batch_at(step), tt.batch_at(step)):
        np.testing.assert_array_equal(a, b)
    batch = next(tt.iterator(step, device="cpu"))
    assert batch["tokens"].dtype == torch.int32 and batch["step"] == step
    np.testing.assert_array_equal(batch["tokens"].numpy(), jt.batch_at(step)[0])
    means = np.random.default_rng(1).uniform(-1, 1, (4, 8, 8, 3))
    mk = dict(means=means, stds=np.full(4, 0.05), weights=np.ones(4),
              global_batch=8, **kw)
    jm, tm = jpipe.MixturePipeline(**mk), tpipe.MixturePipeline(**mk)
    np.testing.assert_array_equal(jm.batch_at(step), tm.batch_at(step))
    x = next(tm.iterator(step, device="cpu"))["x0"]
    np.testing.assert_array_equal(x.numpy(), np.asarray(
        next(jm.iterator(step))["x0"]))


def test_token_labels_are_next_tokens():
    toks, labels = tpipe.TokenPipeline(vocab=100, seq_len=16,
                                       global_batch=2).batch_at(0)
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])


# ---------------------------------------------------------------------------
# checkpoint store
# ---------------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 4, generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "h": torch.randn(3, generator=g).to(torch.bfloat16)}}


@pytest.mark.parametrize("blocking", [True, False])
def test_store_roundtrip(blocking):
    with tempfile.TemporaryDirectory() as d:
        s = CheckpointStore(d)
        t = _tree()
        s.save(5, t, blocking=blocking)
        if not blocking:
            s.wait()
        assert s.latest_step() == 5
        like = {"a": torch.zeros(4, 4), "b": {
            "c": torch.zeros(10, dtype=torch.int32),
            "h": torch.zeros(3, dtype=torch.bfloat16)}}
        step, r = s.restore_latest(like)
        assert step == 5
        for a, b in zip(tree_flatten(t)[0], tree_flatten(r)[0]):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


def test_store_uncommitted_ignored_and_keep_gc():
    with tempfile.TemporaryDirectory() as d:
        s = CheckpointStore(d, keep=2)
        s.save(1, _tree(), blocking=True)
        os.makedirs(os.path.join(d, "step_2"))       # a crashed later write
        with open(os.path.join(d, "latest"), "w") as f:
            f.write("step_2")
        assert s.latest_step() == 1
        for i in range(3, 6):
            s.save(i, _tree(i), blocking=True)
        kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        assert kept == ["step_4", "step_5"]
        assert all(os.path.exists(os.path.join(d, n, SENTINEL)) for n in kept)


@pytest.fixture(scope="module")
def train_states():
    """A reduced f32 CLD (params, AdamWState) of each package at step 1,
    every leaf of the JAX one a distinct seeded numpy draw."""
    jspec, tspec = jget("cifar10-cld", reduced=True), tget("cifar10-cld",
                                                           reduced=True)
    rng = np.random.default_rng(0)
    draw = lambda shapes: jax.tree.map(
        lambda l: rng.standard_normal(l.shape).astype(np.float32), shapes)
    shapes = jspec.param_shapes()
    jst = jadamw.AdamWState(step=np.int32(1), m=draw(shapes),
                            v=draw(shapes), master=draw(shapes))
    net = tspec.init(seed=0, device="cpu")
    cfg = tadamw.AdamWCfg(warmup_steps=1)
    tst = tadamw.adamw_init(net.parameters(), cfg)
    tadamw.adamw_update([torch.full_like(p, 0.2) for p in net.parameters()],
                        tst, list(net.parameters()), cfg)
    return (draw(shapes), jst), (net, tst), tspec


def _numpy_leaves(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_flatten(tree)[0]]


def test_ckpt_jax_to_port(train_states):
    """The JAX store's checkpoint restores in the port equal to the JAX
    tree, leaf for leaf in the JAX flatten order."""
    jtree, _, tspec = train_states
    with tempfile.TemporaryDirectory() as d:
        JStore(d).save(3, jtree, blocking=True)
        net = tspec.init(seed=5, device="cpu")
        st = tadamw.adamw_init(net.parameters(), tadamw.AdamWCfg())
        step, tree = CheckpointStore(d).restore_latest(
            convert.train_state_tree(net, st))
        convert.load_train_state(net, st, tree)
    assert step == 3 and int(st.step) == 1
    mine = _numpy_leaves(convert.train_state_tree(net, st))
    theirs = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        net.state_dict()["layers.1.attn.wq"].numpy(),
        np.asarray(jtree[0]["layers"]["attn"]["wq"][1]))


def test_ckpt_port_to_jax(train_states):
    """The port's checkpoint restores in the JAX store equal to the port's
    state in the JAX layout."""
    jtree, (net, st), _ = train_states
    with tempfile.TemporaryDirectory() as d:
        CheckpointStore(d).save(4, convert.train_state_tree(net, st),
                                blocking=True)
        step, restored = JStore(d).restore_latest(
            jax.tree.map(jnp.zeros_like, jtree))
    assert step == 4
    mine = _numpy_leaves(convert.train_state_tree(net, st))
    for a, b in zip(mine, jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(restored[1].step) == 1


def test_ckpt_bf16_leaf_from_jax():
    """A bf16 leaf saved by the JAX store (numpy writes it as 2-byte void
    records) restores in the port byte for byte; JAX's own restore of it
    fails (ROADMAP F10)."""
    x = (jax.random.normal(jax.random.PRNGKey(0), (6, 5)) * 3
         ).astype(jnp.bfloat16)
    tree = {"w": x, "s": jnp.int32(7)}
    with tempfile.TemporaryDirectory() as d:
        JStore(d).save(1, tree, blocking=True)
        _, r = CheckpointStore(d).restore_latest(
            {"w": torch.zeros(6, 5, dtype=torch.bfloat16),
             "s": torch.zeros((), dtype=torch.int32)})
        with pytest.raises(ValueError):
            JStore(d).restore(1, tree)
    assert r["w"].dtype == torch.bfloat16 and int(r["s"]) == 7
    np.testing.assert_array_equal(
        r["w"].view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))
