"""The port's MoE layers and MoE transformers against the JAX package's,
on the CPU.

Layer: the three dispatch forms (dense, capacity, sorted) on 24 tokens,
8 experts, top-2, with a capacity of 1 (so choices are dropped) and two
router columns made equal (so every token ties experts 3 and 5, and some
tokens tie them at the top-k boundary); the sorted form also with a
shared expert.
Models: the reduced qwen3-moe-30b-a3b (every layer MoE) and
llama4-maverick-400b-a17b (dense / MoE alternating, a shared expert), and
qwen3 in the sorted form its full config runs at a capacity factor that
drops, with the same random non-zero weights in both packages (carried by
`convert.from_jax_transformer`).

Tiers:
  * routing: the expert ids equal `jax.lax.top_k` of JAX's router
    probabilities, and the kept / dropped choices equal JAX's placement
    (the capacity form's per-choice cumsum, the sorted form's stable
    argsort and run positions), bitwise;
  * outputs: within 1e-5 of max |JAX| (f32 sums in other orders);
  * prefill and per-slot decode logits within 1e-5 of max |logits|, the
    loss within 1e-5 relative, each gradient leaf within 1e-4 of its max
    |g| (of `jax.value_and_grad` of the JAX `Arch.loss`), except a leaf
    whose true gradient is 0 (llama4's top-1 router: the gate v / v = 1),
    rounding noise in both, held below 1e-7;
  * `train_lm` takes 2 reduced steps of qwen3-moe (finite losses).
"""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import common as jcommon
from repro.models.registry import Arch as JArch
from repro_torch import convert
from repro_torch.ckpt.store import tree_flatten, tree_unflatten
from repro_torch.configs import get_arch as tget
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models.registry import Arch as TArch
from repro_torch.models.transformer import param_list

from tests.test_torch_lm import random_tree

TOL = 1e-5
N_TOK, D, E, F, K = 24, 16, 8, 12, 2
CAP_FACTOR = 0.3              # int(0.3 * 24 * 2 / 8) = 1: cap 1
TIE = (3, 5)                  # router columns made equal
# below this a gradient leaf is rounding noise: top-1 routing renormalizes
# the gate to v / v = 1, so the router's true gradient is 0
NOISE = 1e-7
JAX_FNS = {"dense": jcommon.moe_apply, "capacity": jcommon.moe_capacity_apply,
           "sorted": jcommon.moe_sorted_apply}


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def layer_inputs(shared: bool):
    rng = np.random.default_rng(11 + shared)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    p = {"router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F),
         "w_down": w(E, F, D)}
    p["router"][:, TIE[1]] = p["router"][:, TIE[0]]
    if shared:
        p["shared"] = {"w_gate": w(D, F), "w_up": w(D, F), "w_down": w(F, D)}
    x = rng.standard_normal((2, N_TOK // 2, D)).astype(np.float32)
    return p, x


def jax_placement(p, x, impl):
    """JAX's (expert ids, kept) for x, by the JAX functions' own lines."""
    xt = jnp.asarray(x).reshape(-1, D)
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    cap = max(1, int(CAP_FACTOR * N_TOK * K / E))
    if impl == "dense":
        return np.asarray(idx), np.ones(idx.shape, bool)
    if impl == "capacity":
        kept = []
        for kk in range(K):
            e = idx[:, kk]
            oh = jax.nn.one_hot(e, E, dtype=jnp.int32)
            pos = jnp.cumsum(oh, axis=0) * oh - 1
            kept.append(jnp.take_along_axis(pos, e[:, None], axis=1)[:, 0]
                        < cap)
        return np.asarray(idx), np.asarray(jnp.stack(kept, 1))
    eid = idx.reshape(-1)
    order = jnp.argsort(eid, stable=True)
    counts = jnp.bincount(eid[order], length=E)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(eid.size) - starts[eid[order]]
    kept = np.empty(eid.size, bool)
    kept[np.asarray(order)] = np.asarray(pos < cap)
    return np.asarray(idx), kept.reshape(idx.shape)


@pytest.mark.parametrize("impl,shared", [
    ("dense", False), ("capacity", False), ("sorted", False),
    ("sorted", True)])
def test_moe_layer_matches_jax(impl, shared):
    p, x = layer_inputs(shared)
    tp = convert.from_jax_params(p)
    tp = {k: v for k, v in tp.items() if not k.startswith("shared.")}
    if shared:
        tp["shared"] = {k: torch.from_numpy(v) for k, v in
                        p["shared"].items()}
    idx, kept = tcommon.moe_routing(tp, torch.from_numpy(x), top_k=K,
                                    impl=impl, capacity_factor=CAP_FACTOR)
    jidx, jkept = jax_placement(p, x, impl)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(kept.numpy(), jkept)
    # the case list does what it claims: ties at the top-k boundary (the
    # lower id taken), and drops where there is a capacity
    boundary = (idx == TIE[0]).any(1) & ~(idx == TIE[1]).any(1)
    assert bool(boundary.any())
    assert bool((~kept).any()) == (impl != "dense")
    got = tcommon.MOE_IMPLS[impl](tp, torch.from_numpy(x), top_k=K,
                                  capacity_factor=CAP_FACTOR)
    want = jax.jit(functools.partial(
        JAX_FNS[impl], top_k=K, capacity_factor=CAP_FACTOR))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert got.shape == x.shape and max_rel(got, want) <= TOL


def test_moe_params_keep_the_router_f32():
    gen = torch.Generator().manual_seed(0)
    p = tcommon.moe_params(gen, 8, 4, 3, torch.bfloat16, n_shared=1,
                           d_ff_shared=6)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (3, 8, 4) and p["w_down"].shape == (3, 4, 8)
    assert p["w_up"].dtype == torch.bfloat16
    assert p["shared"]["w_gate"].shape == (8, 6)


# ---------------------------------------------------------------------------
# the MoE transformers
# ---------------------------------------------------------------------------
MODELS = {"qwen3": ("qwen3-moe-30b-a3b", {}),
          "llama4": ("llama4-maverick-400b-a17b", {}),
          "qwen3-sorted": ("qwen3-moe-30b-a3b", dict(impl="sorted",
                                                     capacity_factor=0.5))}


@functools.lru_cache(maxsize=None)
def model(case):
    name, moe_kw = MODELS[case]
    jspec, tspec = jget(name, reduced=True), tget(name, reduced=True)
    if moe_kw:
        jspec = dataclasses.replace(jspec, cfg=dataclasses.replace(
            jspec.cfg, moe=dataclasses.replace(jspec.cfg.moe, **moe_kw)))
        tspec = dataclasses.replace(tspec, cfg=dataclasses.replace(
            tspec.cfg, moe=dataclasses.replace(tspec.cfg.moe, **moe_kw)))
    jarch, tarch = JArch(jspec), TArch(tspec)
    tree = random_tree(jarch.param_shapes(), seed=len(case))
    return jarch, tarch, tree


@pytest.mark.parametrize("case", list(MODELS))
def test_moe_prefill_and_decode_match_jax(case):
    """Prefill of two 12-token prompts into a 24-long cache, then two
    per-slot decode steps at different positions."""
    jarch, tarch, tree = model(case)
    params = convert.from_jax_transformer(tree, tarch.cfg)
    assert params["layers"][-1]["moe"]["router"].dtype == torch.float32
    toks = np.random.default_rng(1).integers(2, 256, (2, 12)).astype(np.int32)
    jlog, jc = jax.jit(jarch.prefill, static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)}, 24)
    tlog, tc = tarch.prefill(params, {"tokens": torch.from_numpy(toks)}, 24)
    assert max_rel(tlog, jlog) <= TOL
    pos, tok = np.array([12, 9], np.int32), np.array([[7], [200]], np.int32)
    jdec = jax.jit(jarch.decode)
    for _ in range(2):
        jlog, jc = jdec(jax.tree.map(jnp.asarray, tree), jnp.asarray(tok), jc,
                        jnp.asarray(pos))
        tlog, tc = tarch.decode(params, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        assert max_rel(tlog, jlog) <= TOL
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("case", ["qwen3", "llama4"])
def test_moe_loss_and_grad_match_jax(case):
    jarch, tarch, tree = model(case)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 16)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(jarch.loss))(
        jax.tree.map(jnp.asarray, tree),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    params = convert.from_jax_transformer(tree, tarch.cfg)
    leaves = param_list(params)
    for t in leaves:
        t.requires_grad_()
    tl = tarch.loss(params, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= TOL * abs(float(jl))
    mine = jax.tree.leaves(convert.to_jax_transformer(
        tree_unflatten(tree_flatten(params)[1], list(grads)), tarch.cfg))
    theirs = jax.tree.leaves(jg)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape
        if np.abs(np.asarray(b)).max() > NOISE:
            assert max_rel(a, b) <= 1e-4
        else:            # llama4's top-1 router: gate = v / v, gradient 0
            assert np.abs(a).max() <= NOISE


def test_train_lm_runs_qwen3_moe():
    args = argparse.Namespace(
        arch="qwen3-moe-30b-a3b", reduced=True, steps=2, batch=2, seq_len=16,
        lr=3e-4, seed=0, ckpt_dir=None, ckpt_every=0, resume=False,
        log_every=0, device="cpu")
    run = ttrain.train_lm(args)
    assert run["step"] == 2 and np.isfinite(run["last_loss"])
    assert "moe" in run["params"]["layers"][0]
