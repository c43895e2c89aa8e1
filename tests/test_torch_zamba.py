"""The port's zamba family (zamba2-2.7b: Mamba2 SSD layers and a shared
attention block) against the JAX package's, on the CPU.

Both packages get the same weights — a numpy tree of the reduced config
(4 Mamba2 layers in 2 groups, d_model 64, the shared block's 4 heads of
16) drawn from a seed with a random non-zero value in every leaf, carried
into the port by `convert.from_jax_zamba` — and the same numpy inputs.
The model, engine and training checks are `test_torch_rwkv.py`'s helpers.

Tiers:
  * the conversion: to the port and back, bitwise;
  * the SSD core: `segsum` (its -inf above the diagonal included),
    `ssd_chunked` and `ssd_sequential` (with an entering state) within
    1e-5 of the JAX functions' scale, the port's chunked form within 1e-5
    of the JAX per-token form, and `ssd_chunked`'s gradient within 1e-5 of
    `jax.vjp` of the JAX one; `_causal_conv` with and without a
    convolution state, and `mamba2_apply` without a cache (padded to a
    whole chunk), with a cache and one token, and with a cache and a
    prompt (the port's chunked prefill against JAX's per-token one):
    within 1e-5 of scale;
  * the model: `Arch.loss` within 1e-5 relative, each gradient leaf within
    GRAD_TOL = 3e-4 of its max |g| of `jax.value_and_grad` of the JAX loss
    and within 1e-4 of the port's model run through `ssd_sequential`,
    remat off and on.  That tolerance is the f32 gradient's conditioning:
    a 1-ulp perturbation of the embedding moves the port's own gradient by
    up to 1e-4 of a leaf's scale (the 2-element dt_bias, D and A_log
    leaves of a layer: sums over every token with cancellation), and the
    JAX gradient differs from the port's by 1.1e-4 at most;
    `Arch.prefill`'s last logits and every cache leaf (the Mamba2 states
    and each group's K/V), after `convert.from_jax_cache`, within 1e-4 of
    scale, then three decode steps' logits within 1e-4; the same on a
    narrow config at zamba2-2.7b's head width, 2 heads of 80, through
    the plain attention;
  * the `TokenEngine` and `train_lm`: as for rwkv.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.models import ssm as tssm

from tests.test_torch_rwkv import (TOL, archs,
                                   check_jax_state_resumes, check_engine,
                                   check_loss_and_grad,
                                   check_prefill_and_decode, check_stream,
                                   check_train_resumes, max_rel, run_engines,
                                   tree)

NAME = "zamba2-2.7b"
GRAD_TOL = 3e-4
# zamba2-2.7b's shared block at its head width: 2 heads of 80
DH80 = dict(n_heads=2, n_kv_heads=2, d_head=80)


def test_conversion_roundtrip():
    cfg = archs(NAME)[1].cfg
    params = convert.from_jax_zamba(tree(NAME), cfg)
    assert len(params["layers"]) == cfg.n_layers
    assert set(params["shared"]) == {"ln_attn", "ln_mlp", "attn", "mlp"}
    back = convert.to_jax_zamba(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree(NAME))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree(NAME))):
        np.testing.assert_array_equal(a, b)


def _ssd_inputs(S=64, H=3, P=8, N=4, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = n(2, S, H, P)
    dt = np.log1p(np.exp(n(2, S, H) - 1.0)).astype(np.float32)
    A = -np.exp(0.5 * n(H))
    return x, dt, A, n(2, S, H, N), n(2, S, H, N), n(2, H, N, P)


def test_ssd_core_matches_jax():
    seg = np.random.default_rng(5).standard_normal((2, 3, 8)).astype(
        np.float32)
    js, ts = jssm.segsum(jnp.asarray(seg)), tssm.segsum(torch.from_numpy(seg))
    fin = np.isfinite(np.asarray(js))
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
    assert max_rel(ts.numpy()[fin], np.asarray(js)[fin]) <= TOL
    x, dt, A, B, C, s0 = _ssd_inputs()
    J = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    T = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    jy, jS = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *J, 16, jnp.asarray(s0))
    ty, tS = tssm.ssd_chunked(*T, 16, torch.from_numpy(s0))
    assert max_rel(ty, jy) <= TOL and max_rel(tS, jS) <= TOL
    jy2, jS2 = jax.jit(jssm.ssd_sequential)(*J, jnp.asarray(s0))
    ty2, tS2 = tssm.ssd_sequential(*T, torch.from_numpy(s0))
    assert max_rel(ty2, jy2) <= TOL and max_rel(tS2, jS2) <= TOL
    assert max_rel(ty, jy2) <= TOL and max_rel(tS, jS2) <= TOL


def test_ssd_chunked_gradient_matches_jax():
    """segsum masks to -inf above the diagonal before the exponential: the
    gradient through `torch.where` stays finite, within 1e-5 of `jax.vjp`
    of the JAX chunked form."""
    x, dt, A, B, C, _ = _ssd_inputs(S=32)
    rng = np.random.default_rng(3)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dS = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    _, vjp = jax.vjp(jax.jit(lambda *a: jssm.ssd_chunked(*a, 16)),
                     *(jnp.asarray(a) for a in (x, dt, A, B, C)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dS)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    got = torch.autograd.grad(tssm.ssd_chunked(*xs, 16), xs,
                              (torch.from_numpy(dy), torch.from_numpy(dS)))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and max_rel(a, b) <= TOL


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, jn = jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                                   None if state is None
                                   else jnp.asarray(state))
        ty, tn = tssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)),
                                   None if state is None
                                   else torch.from_numpy(state))
        assert max_rel(ty, jy) <= TOL
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("mode", ["no cache", "decode", "prefill"])
def test_mamba2_matches_jax(mode):
    jarch, tarch = archs(NAME)
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), tree(NAME)["layers"])
    tl = convert.from_jax_zamba(tree(NAME), tarch.cfg)["layers"][0]
    m = tarch.cfg.mamba
    rng = np.random.default_rng(1)
    S = 1 if mode == "decode" else 37                # 37: padded to 64
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    cache = None
    if mode != "no cache":
        cache = (rng.standard_normal((2, m.d_conv - 1, m.conv_dim)).astype(
                     np.float32),
                 rng.standard_normal((2, m.n_heads, m.d_state,
                                      m.d_head)).astype(np.float32))
    jout, jc = jax.jit(jssm.mamba2_apply, static_argnums=1)(
        jl["mamba"], jarch.cfg.mamba, jnp.asarray(x),
        None if cache is None else tuple(map(jnp.asarray, cache)))
    tout, tc = tssm.mamba2_apply(
        tl["mamba"], m, torch.from_numpy(x),
        None if cache is None else tuple(map(torch.from_numpy, cache)))
    assert max_rel(tout, jout) <= TOL
    if cache is None:
        assert tc is None and jc is None
    else:
        for a, b in zip(tc, jc):
            assert tuple(a.shape) == b.shape and max_rel(a, b) <= TOL


_SEQ_CORE = (tssm, "ssd_chunked", lambda x, dt, A, B, C, chunk, state0=None:
             tssm.ssd_sequential(x, dt, A, B, C, state0))


def test_loss_and_grad_match_jax():
    check_loss_and_grad(NAME, _SEQ_CORE, GRAD_TOL)


def test_prefill_caches_and_decode_match_jax():
    check_prefill_and_decode(NAME)


def test_head_width_80_matches_jax():
    """zamba2-2.7b's shared-block head width (80, never padded) on the
    reduced widths, through the plain attention: the model's loss and
    gradient, its prefill caches and decode logits."""
    assert archs(NAME, **DH80)[1].cfg.d_head == 80
    check_loss_and_grad(NAME, _SEQ_CORE, GRAD_TOL, **DH80)
    check_prefill_and_decode(NAME, **DH80)


@pytest.fixture(scope="module")
def engines():
    return run_engines(NAME)


def test_engine_serve_matches_jax(engines):
    check_engine(engines[0])


def test_engine_stream_preempts_a_zamba_slot(engines):
    check_stream(*engines)


def test_train_lm_resumes_and_its_checkpoint_reads_in_jax():
    check_train_resumes(NAME)


def test_jax_train_state_resumes_in_the_port():
    check_jax_state_resumes(NAME)
