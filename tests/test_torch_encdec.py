"""The port's encoder-decoder (whisper-base) against the JAX package's, on
the CPU.

Both packages get the same weights — a numpy tree of the reduced
whisper-base config (2 + 2 layers, d_model 64, 4 heads of 16, 32 audio
frames) drawn from a seed with a random non-zero value in every leaf,
carried into the port by `repro_torch.convert.from_jax_encdec` — and the
same numpy frames and prompts.

Tiers:
  * the conversion: to the port and back, bitwise;
  * `encode`, `decode_forward` without caches, prefill and per-slot
    decode logits (the decoder's self-attention against its caches, the
    cross-attention over the memory): f32, within 1e-5 of max |JAX|;
  * bf16 (the full config's dtype, on the reduced widths): the engine's
    dtypes — prefill reads the freshly encoded bf16 memory, decode the f32
    pool's, so the decode step's cross-attention K/V are f32 under bf16
    weights and q bf16 (asserted), the output cast back to bf16 — logits
    within 2e-2 of max |JAX| (bf16 rounding at other places in the two
    frameworks, through 2 + 2 layers);
  * the `TokenEngine`: greedy token streams and the engine's counters
    equal to JAX's engine's, over a closed list and over a `serve_stream`
    that preempts a whisper slot; the preempted stream equals each
    request served alone, bitwise;
  * `Arch.loss` within 1e-5 relative and each gradient leaf within 1e-4
    of its max |g| of `jax.value_and_grad` of the JAX `Arch.loss`, remat
    off and on;
  * `train_lm`: its per-step frames are JAX's draw bit for bit (the JAX
    launcher's fold_in(key, step) normal * 0.02, under the counter layout
    the port implements); 2 reduced steps run; the serving CLI serves.
"""
import argparse
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import zoo as jzoo
from repro.models.registry import Arch as JArch
from repro.serve import Arrival as JArrival
from repro.serve import ServeRequest as JRequest
from repro.serve import TokenEngine as JEngine
from repro.serve import TraceTraffic as JTrace
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.ckpt.store import tree_flatten, tree_unflatten
from repro_torch.configs import get_arch as tget
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import zoo as tzoo
from repro_torch.models.registry import Arch as TArch
from repro_torch.models.transformer import param_list
from repro_torch.serve import (Arrival, ServeRequest, TokenEngine,
                               TraceTraffic)

from tests.test_torch_lm import random_tree

TOL, BF16_TOL = 1e-5, 2e-2
CTX, D_MODEL = 32, 64


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def archs(remat=False, dtype="f32"):
    jspec, tspec = jget("whisper-base", reduced=True), tget("whisper-base",
                                                           reduced=True)
    kw = dict(remat=remat)
    if dtype == "bf16":
        jspec = dataclasses.replace(jspec, cfg=dataclasses.replace(
            jspec.cfg, dtype=jnp.bfloat16, **kw))
        tspec = dataclasses.replace(tspec, cfg=dataclasses.replace(
            tspec.cfg, dtype=torch.bfloat16, **kw))
    else:
        jspec = dataclasses.replace(jspec, cfg=dataclasses.replace(
            jspec.cfg, **kw))
        tspec = dataclasses.replace(tspec, cfg=dataclasses.replace(
            tspec.cfg, **kw))
    return JArch(jspec), TArch(tspec)


@functools.lru_cache(maxsize=None)
def tree():
    return random_tree(archs()[0].param_shapes(), seed=4)


def frames(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, CTX, D_MODEL)).astype(np.float32)


def test_conversion_roundtrip():
    _, tarch = archs()
    params = convert.from_jax_encdec(tree(), tarch.cfg)
    assert len(params["enc_layers"]) == 2 and len(params["dec_layers"]) == 2
    back = convert.to_jax_encdec(params, tarch.cfg)
    want, got = jax.tree.leaves(tree()), jax.tree.leaves(back)
    assert jax.tree.structure(back) == jax.tree.structure(tree())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _prefill_decode(jarch, tarch, jp, params, fr, record=None):
    """Prefill of two 9-token prompts into a 20-long cache, then two
    per-slot decode steps at positions 9 and 6, the engine's way: prefill
    over the memory in the config's dtype, decode over an f32 memory.
    Returns [(port logits, JAX logits)] of the three calls."""
    toks = np.random.default_rng(2).integers(2, 256, (2, 9)).astype(np.int32)
    jmem = jax.jit(jarch.encode_memory)(jp, jnp.asarray(fr))
    jlog, jc = jax.jit(jarch.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks), "memory": jmem}, 20)
    mem = tarch.encode_memory(params, torch.from_numpy(fr))
    tlog, tc = tarch.prefill(params, {"tokens": torch.from_numpy(toks),
                                      "memory": mem}, 20)
    out = [(tlog, jlog)]
    jmem32, mem32 = jmem.astype(jnp.float32), mem.float()
    pos, tok = np.array([9, 6], np.int32), np.array([[7], [200]], np.int32)
    jdec = jax.jit(jarch.decode)
    for _ in range(2):
        jlog, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jmem32)
        if record is not None:
            record.clear()
        tlog, tc = tarch.decode(params, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos), memory=mem32)
        out.append((tlog, jlog))
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
        pos = pos + 1
    return out


def test_prefill_and_decode_match_jax():
    jarch, tarch = archs()
    params = convert.from_jax_encdec(tree(), tarch.cfg)
    for got, want in _prefill_decode(jarch, tarch,
                                     jax.tree.map(jnp.asarray, tree()),
                                     params, frames(2, seed=3)):
        assert max_rel(got, want) <= TOL


def test_bf16_decode_cross_attends_f32_memory(monkeypatch):
    """Trouble spot of the bf16 configs: the decode step's cross-attention
    reads the f32 memory pool, so its K/V are f32 and q bf16; the output
    comes back in bf16."""
    jarch, tarch = archs(dtype="bf16")
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree())
    params = convert.from_jax_encdec(jax.tree.map(np.asarray, bf), tarch.cfg)
    assert params["embed"].dtype == torch.bfloat16
    seen = []
    real = attn_ops.attention

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if not kw.get("causal", True):
            seen.append((q.dtype, k.dtype, v.dtype, out.dtype, k.shape[1]))
        return out

    monkeypatch.setattr(attn_ops, "attention", spy)
    calls = _prefill_decode(jarch, tarch, bf, params, frames(2, seed=5),
                            record=seen)
    for got, want in calls:
        assert got.dtype == torch.bfloat16
        assert max_rel(got.float(), want.astype(jnp.float32)) <= BF16_TOL
    # the last decode step's calls: every decoder layer's cross-attention
    f32, bf16 = torch.float32, torch.bfloat16
    assert seen == [(bf16, f32, f32, bf16, CTX)] * 2


def test_encoder_decoder_loss_and_grad_match_jax():
    """One JAX program: the memory, the uncached decoder's logits, the loss
    and its gradient; the port's with remat off and on."""
    jarch, _ = archs()
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 256, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 12)).astype(np.int32),
             "frames": frames(2, seed=8)}

    def jfwd(p, b):
        mem = jzoo.encode(p, jarch.cfg, b["frames"])
        logits = jzoo.decode_forward(p, jarch.cfg, b["tokens"], mem)[0]
        return mem, logits, jax.value_and_grad(jarch.loss)(p, b)

    jmem, jlog, (jl, jg) = jax.jit(jfwd)(
        jax.tree.map(jnp.asarray, tree()),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for remat in (False, True):
        tarch = archs(remat=remat)[1]
        params = convert.from_jax_encdec(tree(), tarch.cfg)
        if not remat:
            mem = tzoo.encode(params, tarch.cfg, tb["frames"])
            log, caches = tzoo.decode_forward(params, tarch.cfg,
                                              tb["tokens"], mem)
            assert caches is None and log.shape == (2, 12, 256)
            assert max_rel(mem, jmem) <= TOL
            assert max_rel(log, jlog) <= TOL
        leaves = param_list(params)
        for t in leaves:
            t.requires_grad_()
        tl = tarch.loss(params, tb)
        grads = torch.autograd.grad(tl, leaves)
        assert abs(float(tl.detach()) - float(jl)) <= TOL * abs(float(jl))
        mine = jax.tree.leaves(convert.to_jax_encdec(
            tree_unflatten(tree_flatten(params)[1], list(grads)),
            tarch.cfg))
        theirs = jax.tree.leaves(jg)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape and np.abs(np.asarray(b)).max() > 0
            assert max_rel(a, b) <= 1e-4


# ---------------------------------------------------------------------------
# the token engine with encoder memory
# ---------------------------------------------------------------------------
# batch 2; a closed list of prompts of one length (waves of width 1 and 2,
# padded rows with zero frames; one length, so the JAX engine compiles few
# prefill shapes), then a stream in which request 2 arrives
# urgent while both slots are busy and preempts one
LIST_LENS, LIST_NEW = [6] * 5, [6, 4, 6, 3, 5]
STREAM = [(0.0, 12, {}), (0.0, 12, {}),
          (3.0, 8, dict(priority=3, deadline=20.0))]


def _requests():
    rng = np.random.default_rng(0)
    fr = frames(len(LIST_LENS) + len(STREAM), seed=9)
    closed = [ServeRequest(rid=i, workload="token", max_new=m, frames=fr[i],
                           tokens=rng.integers(2, 256, L).astype(np.int32))
              for i, (L, m) in enumerate(zip(LIST_LENS, LIST_NEW))]
    n = len(closed)
    stream = [ServeRequest(rid=i, workload="token", max_new=m,
                           frames=fr[n + i], **kw,
                           tokens=rng.integers(2, 256, 6).astype(np.int32))
              for i, (_, m, kw) in enumerate(STREAM)]
    return closed, stream


def _jax(reqs):
    return [JRequest.from_wire(r.to_wire()) for r in reqs]


def _trace(reqs, cls=TraceTraffic, arrival=Arrival):
    return cls([arrival(t, r) for (t, *_), r in zip(STREAM, reqs)])


@pytest.fixture(scope="module")
def engines():
    jarch, tarch = archs()
    closed, stream = _requests()
    jeng = JEngine(jarch, jax.tree.map(jnp.asarray, tree()), batch_size=2,
                   max_len=24, sync_every=4)
    params = convert.from_jax_encdec(tree(), tarch.cfg)
    teng = TokenEngine(tarch, params, batch_size=2, max_len=24, sync_every=4,
                       device="cpu")
    out = {}
    for name, eng, conv in (("jax", jeng, _jax), ("port", teng, list)):
        counts0 = (eng.n_decode_steps, eng.n_prefill_calls, eng.n_polls,
                   eng.n_tokens_out, list(eng.prefill_widths))
        listed = eng.serve(conv(closed))
        counts = (eng.n_decode_steps, eng.n_prefill_calls, eng.n_polls,
                  eng.n_tokens_out, list(eng.prefill_widths))
        tr = _trace(conv(stream), *((JTrace, JArrival) if name == "jax"
                                    else ()))
        streamed = eng.serve_stream(tr)
        out[name] = (eng, counts0, counts, listed, streamed)
    alone = {r.rid: teng.serve([r])[r.rid] for r in stream}
    return out, alone


def test_engine_serve_matches_jax(engines):
    out, _ = engines
    (_, _, jcounts, jlisted, _), (_, _, tcounts, tlisted, _) = \
        out["jax"], out["port"]
    assert tcounts == jcounts
    assert sorted(tlisted) == sorted(jlisted) == list(range(len(LIST_LENS)))
    for rid in jlisted:
        np.testing.assert_array_equal(tlisted[rid], np.asarray(jlisted[rid]),
                                      err_msg=f"request {rid}")
    assert 1 in tcounts[4] and 2 in tcounts[4]     # waves of width 1 and 2


def test_engine_stream_preempts_a_whisper_slot(engines):
    out, alone = engines
    jeng, _, _, _, jstreamed = out["jax"]
    teng, _, _, _, tstreamed = out["port"]
    assert teng.n_preemptions == jeng.n_preemptions == 1
    assert teng.n_resumes == jeng.n_resumes == 1
    assert teng.preemption_log == jeng.preemption_log
    assert len(teng.parking) == 0
    for rid in jstreamed:
        np.testing.assert_array_equal(tstreamed[rid],
                                      np.asarray(jstreamed[rid]))
        np.testing.assert_array_equal(tstreamed[rid], alone[rid])


def test_engine_refuses_a_request_without_frames(engines):
    teng = engines[0]["port"][0]
    prompt = np.arange(2, 8, dtype=np.int32)
    with pytest.raises(ValueError, match="frames"):
        teng.serve([ServeRequest(rid=0, workload="token", tokens=prompt)])
    with pytest.raises(ValueError, match="frames"):
        teng.serve([ServeRequest(rid=0, workload="token", tokens=prompt,
                                 frames=np.zeros((3, D_MODEL), np.float32))])


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def test_train_lm_frames_are_jax_draws_and_steps_run():
    spec = tget("whisper-base", reduced=True)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    key = prng.PRNGKey(0, "cpu")
    got = ttrain.lm_batch(spec, batch, key, 3)["frames"]
    with jax.threefry_partitionable(False):
        want = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), 3),
                                 (2, CTX, D_MODEL)) * 0.02
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    args = argparse.Namespace(
        arch="whisper-base", reduced=True, steps=2, batch=2, seq_len=16,
        lr=3e-4, seed=0, ckpt_dir=None, ckpt_every=0, resume=False,
        log_every=0, device="cpu")
    run = ttrain.train_lm(args)
    assert run["step"] == 2 and math.isfinite(run["last_loss"])


def test_serve_cli_serves_whisper(capsys):
    assert tserve.main(["--arch", "whisper-base", "--reduced", "--batch",
                        "3", "--requests", "4", "--prompt-len", "8",
                        "--max-new", "4", "--max-len", "32", "--device",
                        "cpu"]) == 0
    assert "served 4 requests" in capsys.readouterr().out
