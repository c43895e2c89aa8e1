"""The port's diffusion training path against the JAX package's, on the CPU:
the attention backward, the perturbation tables, the DSM/HSM loss and its
gradient and one training step (`test_torch_train_run.py` has the
training run and the CLI).

Tiers:
  * bitwise: `build_perturb_tables` (host float64 cast to f32) on VPSDE,
    CLD and BDM; the uniform and Rademacher bits;
  * `attention_bwd_ref` within 1e-5 of each gradient's scale (max |g|) of
    torch autograd through the port's `attention_ref` and of `jax.vjp`
    through the JAX package's (f32 sums in other orders);
  * the loss within 1e-5 relative and each gradient leaf within 1e-4 of
    its scale of `jax.value_and_grad` of the JAX loss, on the same
    weights (every leaf a non-zero seeded draw, carried by
    `convert.from_jax_params`), data and key, for the DiT (reduced CLD)
    and the MLP (VPSDE, 2-D data): the same f32 maths in other orders, and
    normals within 2 ulp (F2);
  * the AdamW update of a training step bitwise JAX's (eager, op by op),
    fed JAX's gradients, clipped by JAX, on both sides.  Fed each its own
    gradients, the updates could not be held so: AdamW's first step is
    close to lr * sign(g), so a gradient near 0 whose sign differs between
    the packages moves a parameter by 2 lr without any fault of the port;
    and the clip scale's global norm sums in another order.
The JAX side draws under `jax.threefry_partitionable(False)` (F1).  CLD
runs with `grid_substeps=1` on both sides: its R_t grid solve (Eq. 17)
costs ~9 s a CLD instance at the default 8 substeps and is the same host
float64 code in both packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sde as jsde
from repro.configs import get_diffusion as jget
from repro.kernels.attention.ref import attention_ref as jattention_ref
from repro.launch import steps as jsteps
from repro.models.score_net import MLPScoreCfg as JMLPCfg
from repro.optim import adamw as jadamw
from repro.train import losses as jlosses
from repro.train.diffusion import DiffusionSpec as JSpec
import repro_torch.sde as tsde
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.configs import get_diffusion as tget
from repro_torch.kernels.attention.ref import attention_bwd_ref, attention_ref
from repro_torch.launch import steps as tsteps
from repro_torch.models.score_net import MLPScoreCfg as TMLPCfg
from repro_torch.optim import adamw as tadamw
from repro_torch.train import losses as tlosses
from repro_torch.train.diffusion import DiffusionSpec as TSpec

NOPART = jax.threefry_partitionable(False)


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


def mlp_specs():
    mk = lambda Spec, Cfg, sde: Spec(
        name="mix2d", sde=sde, data_shape=(2,), score_family="mlp",
        score_cfg=Cfg(state_shape=(2,), hidden=32, n_blocks=2, t_dim=16))
    return mk(JSpec, JMLPCfg, jsde.VPSDE()), mk(TSpec, TMLPCfg, tsde.VPSDE())


@functools.lru_cache(maxsize=None)
def specs(name):
    """(JAX spec, port spec), shared by the tests of this module."""
    if name == "mlp":
        return mlp_specs()
    jspec, tspec = jget(name, reduced=True), tget(name, reduced=True)
    if name == "cifar10-cld":
        jspec = dataclasses.replace(jspec, sde=jsde.CLD(grid_substeps=1))
        tspec = dataclasses.replace(tspec, sde=tsde.CLD(grid_substeps=1))
    return jspec, tspec


def nets(name, seed=11):
    """(jspec, tspec, JAX params, the port's net on the same weights)."""
    jspec, tspec = specs(name)
    tree = random_tree(jspec.param_shapes(), seed)
    net = tspec.init(seed=0, device="cpu").requires_grad_()
    net.load_state_dict(convert.from_jax_params(tree), strict=True)
    return jspec, tspec, jax.tree.map(jnp.asarray, tree), net


STEP_CFG = jadamw.AdamWCfg(lr=1e-3, warmup_steps=2, total_steps=10,
                           weight_decay=0.0)


@functools.lru_cache(maxsize=None)
def jax_grad_and_step(name):
    """One jitted JAX program for the module, compiled once: (params, x0,
    key) -> ((loss, grads) of the JAX loss, the metrics of JAX's
    `make_diffusion_train_step` under STEP_CFG from a fresh AdamW state)."""
    jspec = specs(name)[0]
    jspec.tables                         # host Stage I, outside the trace
    step = jsteps.make_diffusion_train_step(jspec, STEP_CFG)

    def fn(p, x0, key):
        vg = jax.value_and_grad(lambda q: jspec.loss(q, x0, key))(p)
        _, _, metrics = step(p, jadamw.adamw_init(p, STEP_CFG), {"x0": x0},
                             key)
        return vg, metrics

    return jax.jit(fn)


def batch(spec, n, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n,) + tuple(spec.data_shape)).astype(np.float32)


def grad_tree(net, grads):
    names = [n for n, _ in net.named_parameters()]
    return jax.tree.map(lambda t: t.numpy(),
                        convert.jax_tree(dict(zip(names, grads))))


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 16, 2, 32), (1, 4, 3, 16)])
def test_attention_bwd_ref(shape):
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    dq, dk, dv = attention_bwd_ref(*(torch.from_numpy(x)
                                     for x in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    attention_ref(tq, tk, tv, causal=False).backward(torch.from_numpy(do))
    jg = jax.jit(lambda *a: jax.vjp(
        lambda x, y, z: jattention_ref(x, y, z, causal=False),
        *a[:3])[1](a[3]))(q, k, v, do)
    for mine, auto, theirs in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad),
                                  jg):
        assert mine.dtype == torch.float32
        assert max_rel(mine, auto) <= 1e-5
        assert max_rel(mine, theirs) <= 1e-5


def test_attention_autograd_goes_through_the_function():
    """On the CPU the DiT form with grad runs `FlashAttention` (forward
    `attention_ref`, backward `attention_bwd_ref`); without grad, the plain
    forward alone, bit for bit the same values."""
    from repro_torch.kernels.attention import ops
    x = torch.randn(2, 8, 2, 16, generator=torch.Generator().manual_seed(1))
    q = x.clone().requires_grad_()
    out = ops.attention(q, x, x, causal=False)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(out, ops.attention(x, x, x, causal=False))


# ---------------------------------------------------------------------------
# PRNG draws the loss uses
# ---------------------------------------------------------------------------
def test_uniform_bounds_and_rademacher_bitwise():
    with NOPART:
        jk = jax.random.PRNGKey(5)
        ju = jax.random.uniform(jk, (4099,), minval=1e-3, maxval=1.0)
        jr = jax.random.rademacher(jk, (33, 7), jnp.float32)
    tk = prng.PRNGKey(5)
    np.testing.assert_array_equal(
        prng.uniform(tk, (4099,), minval=1e-3, maxval=1.0).numpy(),
        np.asarray(ju))
    np.testing.assert_array_equal(prng.rademacher(tk, (33, 7)).numpy(),
                                  np.asarray(jr))


# ---------------------------------------------------------------------------
# perturbation tables, augment_data, perturb
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["cifar10-ddpm", "cifar10-cld",
                                  "cifar10-bdm"])
def test_perturb_tables_bitwise(name):
    jspec, tspec = specs(name)
    jt = jlosses.build_perturb_tables(jspec.sde, kt=jspec.kt, n_table=96)
    tt = tlosses.build_perturb_tables(tspec.sde, kt=tspec.kt, n_table=96)
    for field in tlosses.PerturbTables._fields:
        np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                      np.asarray(getattr(jt, field)), field)
    t = np.linspace(0, 1, 37, dtype=np.float32)
    np.testing.assert_array_equal(
        tlosses.table_index(tt, torch.from_numpy(t)).numpy(),
        np.asarray(jlosses.table_index(jt, jnp.asarray(t))))


def test_augment_and_perturb():
    jsd, tsd = specs("cifar10-cld")[0].sde, specs("cifar10-cld")[1].sde
    x = np.random.default_rng(2).standard_normal((3, 4, 2)).astype(np.float32)
    with NOPART:
        ju = jsd.augment_data(jnp.asarray(x), jax.random.PRNGKey(3))
        jz = jsd.augment_data(jnp.asarray(x), None)
        jpt, jeps = jsd.perturb(jax.random.PRNGKey(4), jz, 0.3, jsd.R_np)
    tu = tsd.augment_data(torch.from_numpy(x), prng.PRNGKey(3))
    tz = tsd.augment_data(torch.from_numpy(x), None)
    tpt, teps = tsd.perturb(prng.PRNGKey(4), tz, 0.3, tsd.R_np)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tpt.numpy(), np.asarray(jpt), rtol=1e-5,
                               atol=1e-6)
    vp = tsde.VPSDE()
    assert vp.augment_data(tz[:, 0]) is not None
    assert torch.equal(vp.augment_data(tz[:, 0]), tz[:, 0])


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["cifar10-cld", "mlp"])
def test_dsm_loss_and_grad(name):
    jspec, tspec, params, net = nets(name)
    x0 = batch(jspec, 6, seed=3)
    with NOPART:
        (jl, jg), _ = jax_grad_and_step(name)(params, jnp.asarray(x0),
                                              jax.random.PRNGKey(9))
    check_loss_and_grad(tspec, net, x0, 9, jl, jg)


def check_loss_and_grad(tspec, net, x0, seed, jl, jg):
    """The port's loss and gradient on (x0, PRNGKey(seed)) against JAX's:
    the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
    scale."""
    tl = tspec.loss(net, torch.from_numpy(x0), prng.PRNGKey(seed))
    tg = torch.autograd.grad(tl, list(net.parameters()))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    mine = jax.tree.leaves(grad_tree(net, tg))
    theirs = jax.tree.leaves(jg)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert np.abs(np.asarray(b)).max() > 0
        assert max_rel(a, b) <= 1e-4


def test_train_step_against_jax():
    jspec, tspec, params, net = nets("cifar10-cld", seed=4)
    cfg = STEP_CFG
    x0 = batch(jspec, 6, seed=5)
    with NOPART:
        (jl, jg), jm = jax_grad_and_step("cifar10-cld")(
            params, jnp.asarray(x0), jax.random.PRNGKey(2))
    check_loss_and_grad(tspec, net, x0, 2, jl, jg)
    # the port's step: loss and grad norm as JAX's step reports them
    st = tadamw.adamw_init(net.parameters(), cfg)
    m = tsteps.make_diffusion_train_step(tspec, cfg)(
        net, st, {"x0": torch.from_numpy(x0)}, prng.PRNGKey(2))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        <= 1e-4 * float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"])
    assert int(st.step) == 1
    # the update on JAX's own gradients, clipped by JAX, from the same start
    _, _, _, fresh = nets("cifar10-cld", seed=4)
    cfg0 = dataclasses.replace(cfg, clip_norm=0.0)
    jc, _ = jax.jit(lambda g: jadamw.clip_by_global_norm(g, cfg.clip_norm))(jg)
    # JAX's update, eager (op by op) over the leaves laid end to end: the
    # update is elementwise, and one flat leaf dispatches a few ops only
    flat = lambda tree: jnp.concatenate([jnp.ravel(x)
                                         for x in jax.tree.leaves(tree)])
    (jp,), _, _ = jadamw.adamw_update(
        [flat(jc)], jadamw.adamw_init([flat(params)], cfg0), [flat(params)],
        cfg0)
    fst = tadamw.adamw_init(fresh.parameters(), cfg0)
    names = [n for n, _ in fresh.named_parameters()]
    jc_named = convert.from_jax_params(jax.tree.map(np.asarray, jc))
    tadamw.adamw_update([jc_named[n] for n in names], fst,
                        list(fresh.parameters()), cfg0)
    mine = jax.tree.leaves(convert.to_jax_params(fresh.state_dict()))
    np.testing.assert_array_equal(np.concatenate([a.ravel() for a in mine]),
                                  np.asarray(jp))
