"""Parity of the port's token path with the JAX package's, on the CPU:
the reduced `gemma3-1b` transformer (prefill and per-slot decode logits)
and the `TokenEngine` end to end.

Both packages get the same weights — a numpy tree drawn from a seed with a
random non-zero value in every leaf, norms included — carried into the port
by `repro_torch.convert.from_jax_transformer`.  Two depths: the reduced
config's 6 layers (one pattern group) and 8 (one group of 6 plus 2
remainder layers, so the remainder's order and windows are exercised).
Prompts of 20 tokens against the reduced window of 16, so the windowed
layers mask in prefill and in decode.

Tiers:
  * logits: f32, max |port - jax| <= 1e-5 of max |jax| (both sides compute
    in f32; matmul and reduction order and the transcendental
    implementations differ by a few ulp through 8 layers);
  * rotary embedding at gemma3's theta (1e6) and positions to 1023: within
    2e-6 absolute on inputs of order 1 (the same f32 angles; cos/sin
    differ by an ulp);
  * the engine: token streams and the engine's counters identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import common as jcommon
from repro.models.registry import Arch as JArch
from repro.serve import ServeRequest as JRequest
from repro.serve import TokenEngine as JEngine
from repro_torch import convert
from repro_torch.configs import get_arch as tget
from repro_torch.models import common as tcommon
from repro_torch.models.registry import Arch as TArch
from repro_torch.serve import ServeRequest, TokenEngine, bucket_pow2

LOGIT_TOL = 1e-5


def random_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(leaf):
        fan_in = leaf.shape[-2] if leaf.ndim >= 2 else 8
        return (rng.standard_normal(leaf.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _archs(n_layers):
    jspec, tspec = jget("gemma3-1b", reduced=True), tget("gemma3-1b",
                                                         reduced=True)
    if n_layers != jspec.cfg.n_layers:
        jspec = dataclasses.replace(
            jspec, cfg=dataclasses.replace(jspec.cfg, n_layers=n_layers))
        tspec = dataclasses.replace(
            tspec, cfg=dataclasses.replace(tspec.cfg, n_layers=n_layers))
    return JArch(jspec), TArch(tspec)


@pytest.fixture(scope="module", params=[6, 8], ids=["6L", "8L"])
def models(request):
    jarch, tarch = _archs(request.param)
    tree = random_tree(jarch.param_shapes(), seed=request.param)
    params = convert.from_jax_transformer(tree, tarch.cfg)
    return jarch, jax.tree.map(jnp.asarray, tree), tarch, params


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0.1, what
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale,
                               err_msg=what)


def test_conversion_orders_layers_as_jax_runs_them(models):
    jarch, jparams, tarch, params = models
    cfg = tarch.cfg
    assert len(params["layers"]) == cfg.n_layers
    P = cfg.pattern
    for layer, lp in enumerate(params["layers"]):
        if layer < cfg.n_groups * P:
            g, pos = divmod(layer, P)
            want = np.asarray(jparams["layer_stacks"][pos]["attn"]["wq"][g])
        else:
            want = np.asarray(
                jparams["rem_layers"][layer - cfg.n_groups * P]["attn"]["wq"])
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(), want)
        assert cfg.window(layer) == jarch.cfg.layer_windows[layer % P]


def test_prefill_and_per_slot_decode_logits_match_jax(models):
    """Prefill of two 20-token prompts into a 32-long cache, then two
    per-slot decode steps with the rows at different positions (row 1
    rewinds to 15, so its window and its causal tail differ from row 0's)."""
    jarch, jparams, tarch, params = models
    rng = np.random.default_rng(1)
    toks = rng.integers(2, 256, size=(2, 20)).astype(np.int32)
    max_len = 32
    jprefill = jax.jit(jarch.prefill, static_argnums=2)
    jdecode = jax.jit(jarch.decode)
    jlog, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    tlog, tcache = tarch.prefill(params, {"tokens": torch.from_numpy(toks)},
                                 max_len)
    _close(tlog, jlog, "prefill logits")
    # the caches hold the same K/V (window layers included)
    P = tarch.cfg.pattern
    jk_first = np.asarray(jcache[0][0][0])                # group 0, pos 0
    _close(tcache[0][0], jk_first, "layer 0 K cache")
    jk_last = np.asarray(jcache[-1][0]) if tarch.cfg.n_rem else \
        np.asarray(jcache[P - 1][0][-1])
    _close(tcache[-1][0], jk_last, "last layer's K cache")

    pos = np.array([20, 15], np.int32)
    tok = np.array([[7], [200]], np.int32)
    for step in range(2):
        jlog, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                               jnp.asarray(pos))
        tlog, tcache = tarch.decode(params, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        _close(tlog, jlog, f"decode step {step} logits")
        tok = np.asarray(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
        pos = pos + 1


def test_forward_without_cache_matches_jax(models):
    """The uncached forward (every position's logits, causal self-attention
    over the prompt alone, the window masking the first 4 positions out of
    the last rows' reach)."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    jarch, jparams, tarch, params = models
    toks = np.random.default_rng(5).integers(2, 256, size=(2, 20)).astype(
        np.int32)
    jfwd = jax.jit(lambda p, t: jtf.forward(p, jarch.cfg, t)[0])
    want = jfwd(jparams, jnp.asarray(toks))
    got, caches = ttf.forward(params, tarch.cfg, torch.from_numpy(toks))
    assert caches is None and got.shape == (2, 20, 256)
    _close(got, want, "forward logits")


def test_rope_matches_jax_at_gemma_theta():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 4, 256)).astype(np.float32)
    positions = np.array([[0, 1, 511, 512, 700, 1000, 1022, 1023],
                          [3, 97, 640, 641, 900, 901, 1010, 1020]], np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(positions), 1e6)
    got = tcommon.apply_rope(torch.from_numpy(x), tcommon.rope_table(
        torch.from_numpy(positions), 256, 1e6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_bucket_pow2_matches_jax():
    from repro.serve.loop import bucket_pow2 as jbucket
    for n in range(1, 10):
        for cap in (1, 3, 4, 8):
            assert bucket_pow2(n, cap) == jbucket(n, cap)


# ---------------------------------------------------------------------------
# the engine end to end
# ---------------------------------------------------------------------------
# batch 3, more requests than slots, two prompt lengths in runs (so waves of
# 1-3 rows and prefill widths 1, 2 and 4 occur), and an eos id that
# requests 1 and 3 emit early (found by a serve without eos on these
# seeded weights)
ENGINE_LENS = [5, 5, 9, 5, 9, 9, 9, 5]
ENGINE_MAX_NEW = [6, 4, 6, 6, 1, 6, 5, 6]
EOS = 237


@pytest.fixture(scope="module")
def engines():
    jarch, tarch = _archs(6)
    tree = random_tree(jarch.param_shapes(), seed=6)
    rng = np.random.default_rng(3)
    wire = [ServeRequest(rid=i, workload="token",
                         tokens=rng.integers(2, 256, size=L).astype(np.int32),
                         max_new=m).to_wire()
            for i, (L, m) in enumerate(zip(ENGINE_LENS, ENGINE_MAX_NEW))]
    jeng = JEngine(jarch, jax.tree.map(jnp.asarray, tree), batch_size=3,
                   max_len=24, eos_id=EOS)
    want = jeng.serve([JRequest.from_wire(w) for w in wire])
    teng = TokenEngine(tarch, convert.from_jax_transformer(tree, tarch.cfg),
                       batch_size=3, max_len=24, eos_id=EOS, device="cpu")
    got = teng.serve([ServeRequest.from_wire(w) for w in wire])
    return jeng, want, teng, got


def test_token_engine_streams_match_jax(engines):
    jeng, want, teng, got = engines
    assert sorted(got) == sorted(want) == list(range(len(ENGINE_LENS)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"request {rid}")
        assert got[rid].dtype == np.int32
    # the case list does what it claims: request 4 is born done (budget
    # 1), requests 1 and 3 stop at eos before their budget, the rest run
    # their budget out
    assert len(got[4]) == 1
    for r in (1, 3):
        assert len(got[r]) < ENGINE_MAX_NEW[r] and got[r][-1] == EOS
    assert all(len(got[r]) == ENGINE_MAX_NEW[r] for r in got
               if r not in (1, 3))


def test_token_engine_bookkeeping_matches_jax(engines):
    jeng, _, teng, _ = engines
    assert teng.n_decode_steps == jeng.n_decode_steps
    assert teng.n_prefill_calls == jeng.n_prefill_calls
    assert teng.n_tokens_out == jeng.n_tokens_out
    assert teng.n_polls == jeng.n_polls
    assert teng.wave_log == jeng.wave_log
    assert list(teng.prefill_widths) == list(jeng.prefill_widths)


def test_token_engine_rejects_bad_requests(engines):
    _, _, teng, _ = engines
    prompt = np.arange(2, 10, dtype=np.int32)
    for kw in (dict(max_new=0), dict(max_new=17)):
        with pytest.raises(ValueError):
            teng.serve([ServeRequest(rid=0, workload="token", tokens=prompt,
                                     **kw)])
    with pytest.raises(ValueError):
        teng.serve([ServeRequest(rid=0, workload="diffusion")])


def test_other_families_are_refused():
    from repro_torch.models.registry import ArchSpec
    with pytest.raises(NotImplementedError, match="not a family"):
        TArch(ArchSpec(name="mlp-mixer", family="mixer", cfg=None))
