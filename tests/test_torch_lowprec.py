"""The port's score-net precision classes (`models/quantize.py`) against
the JAX package's, on the CPU, with the same random non-zero DiT weights
in both packages (carried by `repro_torch.convert`).

Tiers:
  * the resident forms: the bf16 cast bitwise; int8 `q` bitwise and
    `scale` equal (both round half to even, over the same stacked layout);
  * the eval at each class against JAX's eval at that class: within 1e-5
    of the eps output's scale, where both compute in f32 (the reduced DiT
    at f32 / bf16 / int8; a narrow DiT with dtype bf16 at int8, which pins
    the promotion rule: bf16 rounding points, f32 compute);
  * a narrow bf16 DiT: the bf16 class equals the f32 class bitwise;
  * each class's eval within `NET_TOLERANCES` of the f32 eval;
  * the engine over a mixed-precision list against JAX's engine: samples
    within 1e-5 of scale, counters equal; the f32 class unperturbed by
    low-precision neighbours, bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_diffusion as jget
from repro.models import quantize as jqtz
from repro.serve import DiffusionEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch import convert
from repro_torch.configs import get_diffusion as tget
from repro_torch.models import quantize as tqtz
from repro_torch.serve import DiffusionEngine, ServeRequest

from tests.test_torch_lm import random_tree

BOUND = 1e-5
REQS = [dict(), dict(precision="bf16"), dict(precision="int8", q=2),
        dict(precision="int8", lam=0.5), dict(lam=0.5)]


def _specs(dtype=None):
    """The reduced cifar10-ddpm spec in both packages; `dtype` "bf16"
    narrows nothing but sets the DiT's config dtype to bf16."""
    jspec, tspec = jget("cifar10-ddpm", reduced=True), tget("cifar10-ddpm",
                                                            reduced=True)
    if dtype == "bf16":
        jspec = dataclasses.replace(jspec, score_cfg=dataclasses.replace(
            jspec.score_cfg, dtype=jnp.bfloat16))
        tspec = dataclasses.replace(tspec, score_cfg=dataclasses.replace(
            tspec.score_cfg, dtype=torch.bfloat16))
    return jspec, tspec


def _models(dtype=None, seed=3):
    jspec, tspec = _specs(dtype)
    tree = random_tree(jspec.param_shapes(), seed=seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    if dtype == "bf16":
        jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    net = tspec.init(seed=0, device="cpu")
    net.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jparams)))
    return jspec, jparams, tspec, net


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def resident(models):
    """JAX's resident form of each class, made op by op as its engine
    makes it (`DiffusionEngine._params_for`; jitted, a few int8 scales
    come out an ulp apart)."""
    return {p: jqtz.quantize_tree(models[1], p) for p in jqtz.PRECISIONS}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = np.asarray([0.9, 0.5, 0.1, 0.02], np.float32)
    return u, t


def _leaves(tree):
    """(path, leaf) pairs of a nested dict / list, QTensors as leaves."""
    if isinstance(tree, (jqtz.QTensor, tqtz.QTensor)):
        return [((), tree)]
    if isinstance(tree, dict):
        return [((k,) + p, x) for k in sorted(tree)
                for p, x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [((i,) + p, x) for i, v in enumerate(tree)
                for p, x in _leaves(v)]
    return [((), tree)]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      np.asarray(x, np.float32))


def test_f32_is_the_identity(models):
    jspec, _, tspec, net = models
    assert tqtz.quantize_tree(net, "f32") is net
    assert tqtz.wrap_eps_model(tspec.eps_model, "f32", net) \
        == tspec.eps_model
    with pytest.raises(ValueError, match="unknown precision"):
        tqtz.quantize_tree(net, "fp4")
    assert tqtz.PRECISIONS == jqtz.PRECISIONS
    assert tqtz.NET_TOLERANCES == jqtz.NET_TOLERANCES


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_resident_form_is_the_jax_packages(models, resident, precision):
    net = models[3]
    got = _leaves(tqtz.quantize_tree(net, precision))
    want = _leaves(resident[precision])
    assert [p for p, _ in got] == [p for p, _ in want]
    n_q = 0
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, jqtz.QTensor):
            n_q += 1
            assert isinstance(g, tqtz.QTensor) and g.q.dtype == torch.int8
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q),
                                          err_msg=f"{path} q")
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale),
                                          err_msg=f"{path} scale")
        else:
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=str(path))
    # the stacked layout sets the numbers: a stacked per-layer vector is a
    # matrix, so it is quantized; a top-level vector is not
    kinds = {p: isinstance(g, tqtz.QTensor) for p, g in got}
    assert (n_q > 0) == (precision == "int8")
    assert kinds[("layers", "ada_b")] == (precision == "int8")
    assert not kinds[("final_ada_b",)]


def _port_eval(tspec, net, precision, u, t):
    with torch.no_grad():
        return tqtz.wrap_eps_model(tspec.eps_model, precision, net)(
            tqtz.quantize_tree(net, precision), torch.from_numpy(u),
            torch.from_numpy(t))


def _jax_eval(jspec, qparams, precision, u, t, jit=True):
    """JAX's eval at `precision` on its resident params, jitted (one
    compile in place of an eager dispatch per op) or op by op."""
    ev = jqtz.wrap_eps_model(jspec.eps_model, precision)
    out = (jax.jit(ev) if jit else ev)(qparams, jnp.asarray(u),
                                       jnp.asarray(t))
    return np.asarray(out, np.float32)


@pytest.fixture(scope="module")
def evals(models, resident, inputs):
    jspec, _, tspec, net = models
    return {p: (_port_eval(tspec, net, p, *inputs),
                _jax_eval(jspec, resident[p], p, *inputs))
            for p in tqtz.PRECISIONS}


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_eval_at_each_class_matches_jax(evals, precision):
    got, want = evals[precision]
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BOUND * np.abs(want).max())
    if precision != "f32":
        ref = evals["f32"][0]
        tol = tqtz.NET_TOLERANCES[precision]
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * ref.abs().max().item())


def test_bf16_dit_promotion_rule(inputs):
    """A DiT whose config dtype is bf16 (as at full width): the int8 class
    computes in f32 on inputs rounded through bf16, in both packages; the
    bf16 class is the f32 class, bitwise.

    The reference runs op by op here: jitted, XLA's CPU backend may keep
    excess precision across the casts to bf16 (its
    `xla_allow_excess_precision`), which moves the rounding points this
    test pins.  The time embedding is such a point: its f32 cos / sin
    differ between the packages by an ulp here and there, and one of the
    (4, 256) values then rounds to the neighbouring bf16 value, which moves
    the eps by ~3e-5 of its scale.  So the rows where the embedding is
    exact in both packages (t = 0: cos 0 = 1, sin 0 = 0) are held within
    1e-5 of scale, the others within 2e-4; computing in bf16 instead of
    f32 misses by ~8e-3 of scale, 40x that."""
    jspec, jparams, tspec, net = _models("bf16", seed=4)
    u, t = inputs
    t = np.where(np.arange(len(t)) % 2 == 0, 0.0, t).astype(np.float32)
    got = _port_eval(tspec, net, "int8", u, t).numpy()
    want = _jax_eval(jspec, jqtz.quantize_tree(jparams, "int8"), "int8", u,
                     t, jit=False)
    scale = np.abs(want).max()
    assert scale > 0.1
    for rows, bound in ((t == 0, BOUND), (t != 0, 2e-4)):
        np.testing.assert_allclose(got[rows], want[rows], rtol=0,
                                   atol=bound * scale)
    assert torch.equal(_port_eval(tspec, net, "bf16", u, t),
                       _port_eval(tspec, net, "f32", u, t))


@pytest.fixture(scope="module")
def engines(models):
    jspec, jparams, tspec, net = models
    wire = [ServeRequest(rid=i, seed=40 + i, **kw).to_wire()
            for i, kw in enumerate(REQS)]
    jeng = JEngine(jspec, jparams, batch_size=4, nfe=4)
    with jax.threefry_partitionable(False):
        want = jeng.serve([JRequest.from_wire(w) for w in wire])
    teng = DiffusionEngine(tspec, net, batch_size=4, nfe=4, device="cpu")
    got = teng.serve([ServeRequest.from_wire(w) for w in wire])
    return jeng, want, teng, got


def test_mixed_precision_engine_matches_jax(engines):
    jeng, want, teng, got = engines
    for attr in ("n_rounds", "n_steps", "n_polls", "n_samples_out"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert teng.wave_log == jeng.wave_log
    assert sorted(got) == sorted(want) == list(range(len(REQS)))
    for rid in want:
        a, b = np.asarray(want[rid]), got[rid]
        assert np.abs(a).max() > 0.1
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=BOUND * np.abs(a).max(),
                                   err_msg=f"request {rid} {REQS[rid]}")


def test_f32_class_unperturbed_by_lowprec_neighbours(engines):
    _, _, teng, got = engines
    for rid in (0, 4):
        alone = teng.serve([ServeRequest(rid=rid, seed=40 + rid,
                                         **REQS[rid])])
        np.testing.assert_array_equal(got[rid], alone[rid])
    with pytest.raises(ValueError, match="unknown precision"):
        teng.serve([ServeRequest(rid=0, precision="fp4")])
