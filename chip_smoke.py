"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from src/repro_torch/csrc, then drives the
three main paths through the port's engines, each at full width with
random weights from a seed:

  * `cifar10-cld` (DiffusionEngine; DiT img 32 / patch 2 / d_model 768 /
    24 layers / 12 heads, bf16; state (B, 2, 32, 32, 3)): round_fused with
    in-kernel noise, round_predict (kf = 2), flash_attention (DiT form);
  * `cifar10-bdm` (the same DiT over a (B, 32, 32, 3) state held as DCT
    coefficients): dct2 around every eval, step_noise + dct2 + round_fused
    with streamed noise, round_predict (kf = 1), flash_attention;
  * `gemma3-1b` (TokenEngine; 26 layers, d_model 1152, 4 query heads over 1
    KV head of width 256, vocab 262144, bf16, window 512 on 5 layers of 6;
    batch 4, max_len 1024; 8 requests with prompts of 96 and 640 tokens,
    48 new tokens each): flash_attention in its causal/window/GQA form for
    every prefill, decode_attention (split pass and merge pass) in every
    layer of every decode round.

Each path is served once with the launch counts set to 0 just before and
read just after; every kernel of the path must have launched, and the
results must be well formed (finite samples; max_new token ids in
[0, vocab) per request).  Then each kernel is held against its plain
PyTorch version at the path's shapes (bdm_ei_update, which no path runs,
on its own), timed beside its plain version, a library call where one
computes the same function, and its bound; the reduced configs on the card
are checked against the plain versions on the CPU (samples; gemma3-1b's
logits and token streams); and one serve of each path runs under a CUPTI
trace.  It prints:

    <card name>, <power limit>                       (nvidia-smi)
    {"kernels": [...]}                               per-kernel record
    {"ok": true, "device": {...}}                    last line

Any failed check exits non-zero before the last line.  Without a CUDA
device, or outside a checkout, it fails.  Needs one card.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
F32_FLOPS = 67e12               # f32 outside the tensor cores
MIX = ["nfe=10,q=2", "nfe=10,q=2,corrector", "nfe=10,lam=0.5",
       "nfe=10,lam=0.5,algorithm=gmm"]
N_REQUESTS, BATCH, SEED = 8, 4, 0
DATA = (32, 32, 3)
PATH_KERNELS = {
    "cifar10-cld": ("round_fused", "round_predict", "flash_attention"),
    "cifar10-bdm": ("dct2", "step_noise", "round_fused", "round_predict",
                    "flash_attention"),
}
LM_ARCH = "gemma3-1b"
LM_LENS = (96, 640)             # prompt lengths, alternating by request
LM_MAX_NEW, LM_MAX_LEN = 48, 1024
LM_KERNELS = ("flash_attention", "decode_attention", "decode_attention_merge")
LIBRARIES = ("round_fused", "attention", "dct2", "decode_attention")


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_events(prof):
    """Device-side events (kernels, copies, fills) of a profiler trace."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def time_ms(fn, iters: int = 50, warmup: int = 5, kernel: str = ""):
    """(device ms, wall ms) per call.  Device time comes from a CUPTI trace
    (torch.profiler), so host dispatch gaps between launches do not count:
    with `kernel` (a substring of one kernel's name) it is the median
    duration of that kernel's launches; without, the mean device time of
    everything one call launches (the multi-kernel plain versions).  Wall
    time is CUDA events around `iters` back-to-back calls.  Warm L2: the
    serving path hands each kernel inputs it has just written.  Traces
    without the device events asked for fail the run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    # CUPTI may drop a launch at the edge of the trace window, and once (in
    # one run of this script, for bdm_ei_update; not reproduced, cause not
    # known) it delivered a whole trace without the kernel's events: up to
    # three traces are taken before the run fails, and every retry is logged
    for attempt in range(1, 4):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = kernel_events(prof)
        durs = [e.time_range.elapsed_us() / 1e3 for e in events
                if kernel in e.name]
        if len(durs) >= (iters // 2 if kernel else 1):
            if attempt > 1:
                log(f"  trace {attempt} holds {len(durs)} device events"
                    f"{' named ' + kernel if kernel else ''}")
            break
        log(f"  trace of {iters} calls holds {len(durs)} device events"
            f"{' named ' + kernel if kernel else ''} (of {len(events)}: "
            f"{sorted({e.name[:60] for e in events})[:4]}); tracing again")
    check(len(durs) >= (iters // 2 if kernel else 1),
          f"{len(durs)} device events{' named ' + kernel if kernel else ''} "
          f"traced for {iters} calls: no device time measured")
    if kernel:
        return float(np.median(durs)), wall
    return sum(durs) / iters, wall


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place, from the f32 bit
    patterns (for values that agree in sign, as the noise draws do)."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def ulp_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of the last place of b's dtype (f32 or
    bf16) at max(|b|, max|b| / 1024): near zero the unit is that of the
    scale, so a cancellation next to zero does not read as millions."""
    bits = 8 if b.dtype == torch.bfloat16 else 24
    b32 = b.float()
    floor = float(b32.abs().max()) / 1024
    _, e = torch.frexp(b32.abs().clamp_min(max(floor, 1e-30)))
    ulp = torch.ldexp(torch.ones_like(b32), e - bits)
    return float(((a.float() - b32).abs() / ulp).max())


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def fused_round_need(ints, dis, *, K, Qb, kf, D, streamed=False):
    """(bytes, f32 ops) that one round_fused launch needs on these staged
    inputs, slot by slot as csrc/round_fused.cu reads them.  Every slot
    reads u, eps, its ints row and writes u, the history, k and active.  A
    slot of this variant (`mine`) reads history rows 0..Qb-2 (the shift
    drops row Qb-1), any other slot all Qb rows.  Stochastic slots add the
    B / P_chol applies and either the key (in-kernel noise) or their kf
    rows of streamed canonical noise; corrector slots (`use_c`) their
    eps_n rows and the cC applies.  Each factor block and pool id used is
    read once, each distinct pool row once.  Ops: kf (3 kf - 1) per
    element and apply plus the kf-wide sums; the in-kernel noise draw's
    threefry (integer) and erf_inv work is not counted, and leaves the
    launch bound by bytes."""
    st, di = ints.cpu().tolist(), dis.cpu().tolist()
    rows, nbytes, ops = set(), 0, 0
    for s, d in zip(st, di):
        mine, stoch, use_c = bool(s[3]), bool(s[4]), bool(s[5])
        used = [0] + [3 + j for j in range(Qb)]                # psi, pC_j
        sums = Qb
        if stoch:
            used += [1, 2]                                     # B, P_chol
            sums += 2
        if use_c:
            used += [3 + Qb + j for j in range(Qb)]            # cC_j
            sums += Qb
        rows.update(d[c] for c in used)
        h_read = Qb - 1 if mine else Qb
        noise_rows = kf if (stoch and streamed) else 0
        nbytes += 4 * D * (K + h_read * K + kf + (kf if use_c else 0)
                           + noise_rows)
        nbytes += 4 * D * (K + Qb * K)
        nbytes += 4 * (len(s) + (2 if stoch and not streamed else 0)
                       + len(used) * (kf * kf + 1) + 2)
        ops += D * (len(used) * kf * (3 * kf - 1) + sums * kf)
    return nbytes + 4 * D * len(rows), ops


def fast_dct2_ops(H: int, W: int) -> int:
    """Operations of one orthonormal 2-D DCT of an H x W tile done the
    fastest known way: H transforms of length W and W of length H, each
    n-point transform (n a power of two) costing (n/2) log2 n multiplies
    and (3n/2) log2 n - n + 1 adds (Lee's fast DCT-II).  The kernel does
    dense products (2 n^2 per transform); the bound counts the least."""
    def one(n: int) -> int:
        m = max(1, (n - 1).bit_length())           # log2 n, rounded up
        return (n // 2) * m + (3 * n // 2) * m - n + 1
    return H * one(W) + W * one(H)


def bound(nbytes: float, ops: float, peak: float):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def requests(mix_parsed, seed0):
    from repro_torch.serve import ServeRequest
    return [ServeRequest(rid=i, seed=seed0 + i, **mix_parsed[i % len(MIX)])
            for i in range(N_REQUESTS)]


def randomize_score(net, d_model: int, seed: int) -> None:
    """patch_out and the adaLN weights (zero / 1e-3 scale at init) get
    N(0, 1/d) values, so the round kernels see a real, non-zero score."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in [net.patch_out, net.final_ada_w] + \
                [lp.ada_w for lp in net.layers]:
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(d_model))


def make_engine(name: str, dev, reduced: bool = False, seed: int = SEED):
    """The spec, seeded weights and a batch-4 engine for config `name`."""
    from repro_torch.configs import get_diffusion
    from repro_torch.core import SamplerConfig
    from repro_torch.serve import DiffusionEngine
    spec = get_diffusion(name, reduced=reduced)
    net = spec.init(seed=seed, device=dev)
    randomize_score(net, spec.score_cfg.d_model, seed + 1)
    engine = DiffusionEngine(spec, net, batch_size=BATCH,
                             default_config=SamplerConfig(nfe=10),
                             device=dev)
    return spec, net, engine


def drive_path(name: str, dev, mix, card: str):
    """One main path: a warm-up serve, the launch counts set to 0, one
    measured serve of the mix, the counts read right after.  Checks the
    counts, the results' shapes and finiteness; returns (spec, net,
    engine, counts)."""
    from repro_torch.kernels import cuda as kc
    t0 = time.perf_counter()
    spec, net, engine = make_engine(name, dev)
    log(f"[{name}] engine: Stage I + weights "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    engine.serve(requests(mix, 1000))              # warm-up (other seeds)
    torch.cuda.synchronize()
    log(f"[{name}] warm-up serve: {time.perf_counter() - t0:.2f}s")
    rounds0 = engine.n_rounds
    kc.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests(mix, SEED))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    rounds = engine.n_rounds - rounds0
    log(f"[{name}] serve: {len(results)} samples in {dt:.4f}s, {rounds} "
        f"rounds, {len(results) / dt:.3f} samples/s ({card}); launches "
        f"{counts}")
    check(sorted(results) == list(range(N_REQUESTS)), f"{name}: missing "
          "results")
    for rid, x in results.items():
        check(x.shape == DATA, f"{name}: sample {rid} shape {x.shape}")
        check(bool(np.isfinite(x).all()), f"{name}: sample {rid} not finite")
    for k in PATH_KERNELS[name]:
        check(counts.get(k, 0) > 0, f"{name}: {k} never launched on the path")
    return spec, net, engine, counts


def profile_serve(name: str, serve, out: Path, unit: str) -> None:
    """Where the time goes: one more serve under a CUPTI trace (`serve()`
    returns how many `unit`s it produced); the device time by kernel lands
    in `out`."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    log(f"[{name}] profile: serve wall {wall:.4f}s, {n / wall:.3f} {unit}/s "
        f"under the trace, device busy {busy:.4f}s ({100 * busy / wall:.1f}% "
        f"busy, {100 - 100 * busy / wall:.1f}% idle), {len(events)} device "
        f"events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for kname, us in top[:8]:
        log(f"  {us / 1e3:9.3f} ms  {100 * us / 1e6 / busy:5.1f}%  "
            f"{kname[:90]}")
    out.write_text("".join(f"{us:.1f}\t{kname}\n" for kname, us in top))


def timed_record(name, path, source, replaces, launches, err, kernel_fn,
                 kernel, plain_fn, nbytes, ops, peak, library_fn=None):
    """One entry of the `kernels` line, timed now."""
    ms, wall = time_ms(kernel_fn, kernel=kernel)
    plain_ms, pwall = time_ms(plain_fn, 20)
    library_ms = time_ms(library_fn)[0] if library_fn is not None else None
    bound_ms, bound_by = bound(nbytes, ops, peak)
    log(f"  {name} [{path}]: device {ms:.5f} ms / wall {wall:.5f} ms per "
        f"call; plain {plain_ms:.5f} / {pwall:.5f}; library {library_ms}; "
        f"bound {bound_ms:.6f} by {bound_by} ({nbytes} B, {ops} ops); "
        f"{launches} launches on the path")
    return dict(name=name, path=path, route="cuda", source=source,
                replaces=replaces, launches=launches, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def slot_inputs(engine, mix, dev, gen):
    """Random state, history and evals at the path's shapes, one slot per
    config of the mix, at step indices 0, 4, 8, 9 (the corrector slot
    mid-trajectory, the gmm slot on its final step)."""
    bank = engine._bank
    cfg_ids = torch.tensor([engine.cache.index_of(engine.config_of(r))
                            for r in requests(mix, 0)[:BATCH]], device=dev)
    K, Qb = engine.state.u.shape[1], engine.state.hist.shape[1]
    kf = engine.spec.sde.packed_k
    D = int(np.prod(DATA))
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    kstep = torch.tensor([0, 4, 8, 9], dtype=torch.int32, device=dev)
    return dict(bank=bank, cfg=cfg_ids, K=K, Qb=Qb, kf=kf, D=D,
                u=rnd(BATCH, K, D), hist=rnd(BATCH, Qb, K, D),
                eps_c=rnd(BATCH, kf, D), eps_n=rnd(BATCH, kf, D),
                k=kstep, kc=torch.minimum(kstep, bank.n_steps[cfg_ids] - 1),
                zeros=torch.zeros(BATCH, dtype=torch.int32, device=dev),
                active=torch.ones(BATCH, dtype=torch.bool, device=dev))


def round_records(path, engine, x, keys, counts, streamed: bool):
    """Check round_fused and round_predict against their plain versions at
    the path's shapes, and time them.  In streamed mode (BDM) the commit
    kernel is given the plain canonical noise (plain draw, plain DCT), so
    it must agree with the plain commit bit for bit; the whole wrapper
    (step_noise, dct2, round_fused) is held within 1e-5."""
    from repro_torch.kernels.dct2.ref import dct2_ref
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    sde, bank = engine.spec.sde, x["bank"]
    kf, K, Qb, D = x["kf"], x["K"], x["Qb"], x["D"]
    state_shape = sde.state_shape(DATA)
    n = int(np.prod(state_shape))
    args = (x["u"], x["hist"], x["k"], x["kc"], x["cfg"], x["zeros"],
            x["zeros"], keys, x["active"], bank, x["eps_c"])
    kw = dict(sde=sde, state_shape=state_shape, kf=kf, with_corrector=True,
              eps_n_c=x["eps_n"])
    ints = rf._stage_ints(x["k"], x["kc"], x["cfg"], x["zeros"], x["zeros"],
                          x["active"], bank, fam_index=0, prec_index=0,
                          with_corrector=True)
    blks, dis = rf._stage_factors(bank, x["cfg"], x["kc"], kf, True)
    noise_c = None
    if streamed:
        noise = rf_ref.draw_step_noise(keys, x["kc"], bank.alg[x["cfg"]],
                                       state_shape)
        noise_c = dct2_ref(noise).reshape(BATCH, kf, D)
        kw_ref = dict(kw, noise_c=noise_c)
    else:
        kw_ref = kw

    got = rf.round_update(*args, **kw)
    want = rf_ref.round_update_ref(*args, **kw_ref)
    kern = rf.round_fused(ints, keys, blks, dis, bank.diag, x["u"],
                          x["hist"], x["eps_c"], x["eps_n"], noise_c, kf=kf,
                          n=n, with_corrector=True)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
          f"[{path}] round_fused k/active differ from the plain version")
    check(torch.equal(kern[2], want[2]) and torch.equal(kern[3].bool(),
                                                        want[3]),
          f"[{path}] round_fused kernel k/active differ")
    err_fused = max(max_err(a, b) for a, b in zip(kern[:2], want[:2]))
    err_wrap = max(max_err(a, b) for a, b in zip(got[:2], want[:2]))
    det = ~bank.stochastic[x["cfg"]]
    bitwise = torch.equal(kern[0][det], want[0][det]) if not streamed \
        else torch.equal(kern[0], want[0]) and torch.equal(kern[1], want[1])
    log(f"[{path}] round_fused vs plain: kernel max abs err {err_fused:.3e}"
        f" (tol 1e-5), max {ulp_err(kern[0], want[0]):.1f} ulp, "
        f"{'all' if streamed else 'deterministic'} slots bitwise: "
        f"{bitwise}; through round_update {err_wrap:.3e} (tol 1e-5); "
        f"k/active exact")
    check(err_fused <= 1e-5 and err_wrap <= 1e-5,
          f"[{path}] round_fused beyond tolerance")
    if streamed:
        check(bitwise, f"[{path}] streamed round_fused not bitwise on the "
              "same canonical noise")

    pred = rf.round_predict(x["u"], x["hist"], x["kc"], x["cfg"], bank,
                            x["eps_c"], kf=kf)
    pred_ref = rf_ref.round_predict_ref(x["u"], x["hist"], x["kc"],
                                        x["cfg"], bank, x["eps_c"], kf=kf)
    torch.cuda.synchronize()
    err_pred = max_err(pred, pred_ref)
    log(f"[{path}] round_predict vs plain: max abs err {err_pred:.3e} (tol "
        f"1e-5), max {ulp_err(pred, pred_ref):.1f} ulp")
    check(err_pred <= 1e-5, f"[{path}] round_predict beyond tolerance")

    f_bytes, f_ops = fused_round_need(ints, dis, K=K, Qb=Qb, kf=kf, D=D,
                                      streamed=streamed)
    every = rf.fused_round_cost(B=BATCH, K=K, Qb=Qb, kf=kf, D=D,
                                pool_rows=int(torch.unique(dis).numel()),
                                with_corrector=True,
                                gen_noise=not streamed)["bytes_moved"]
    log(f"[{path}] round_fused on the timed inputs needs {f_bytes} B and "
        f"{f_ops} f32 ops (fused_round_cost, every stream counted: "
        f"{every} B)")
    pblks, pdis = rf._stage_factors(bank, x["cfg"], x["kc"], kf, False,
                                    predict_only=True)
    # predictor: reads u[:, :kf], the Qb - 1 history rows it uses, eps, its
    # factor blocks, pool ids and pool rows; writes (B, kf, D)
    p_bytes = 4 * (BATCH * kf * D * (1 + (Qb - 1) + 1 + 1) + pblks.numel()
                   + pdis.numel() + int(torch.unique(pdis).numel()) * D)
    p_ops = BATCH * D * ((1 + Qb) * kf * (3 * kf - 1) + Qb * kf)
    src = "src/repro_torch/csrc/round_fused.cu"
    sfx = "[streamed]" if streamed else ""
    return [
        timed_record(
            "round_fused" + sfx, path, src,
            "src/repro/kernels/round_fused/kernel.py:293",
            counts.get("round_fused", 0), err_fused,
            lambda: rf.round_fused(ints, keys, blks, dis, bank.diag, x["u"],
                                   x["hist"], x["eps_c"], x["eps_n"],
                                   noise_c, kf=kf, n=n, with_corrector=True),
            "round_fused_kernel",
            lambda: rf_ref.round_update_ref(*args, **kw_ref),
            f_bytes, f_ops, F32_FLOPS),
        timed_record(
            f"round_predict[kf={kf}]" if streamed else "round_predict",
            path, src, "src/repro/kernels/round_fused/kernel.py:362",
            counts.get("round_predict", 0), err_pred,
            lambda: rf.round_predict_kernel(pblks, pdis, bank.diag, x["u"],
                                            x["hist"], x["eps_c"], kf=kf),
            "round_predict_kernel",
            lambda: rf_ref.round_predict_ref(x["u"], x["hist"], x["kc"],
                                             x["cfg"], bank, x["eps_c"],
                                             kf=kf),
            p_bytes, p_ops, F32_FLOPS)]


def attention_record(path, spec, net, counts, gen, dev):
    """flash_attention at the DiT's shape (B, 256, 12, 64) bf16 against
    its plain version, and the DiT's eps with the kernel against the plain
    attention."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    cfg = spec.score_cfg
    H, S, Dh = cfg.n_heads, cfg.n_tokens, cfg.d_head
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, k, v = (rnd(BATCH, S, H, Dh).to(torch.bfloat16) for _ in range(3))
    att = attn_ops.attention(q, k, v, causal=False)
    att_ref = attention_ref(q, k, v, causal=False)
    q32, k32, v32 = q.float(), k.float(), v.float()
    att32 = attn_ops.attention(q32, k32, v32, causal=False)
    att32_ref = attention_ref(q32, k32, v32, causal=False)
    torch.cuda.synchronize()
    err_att = max_err(att, att_ref)
    ulp_att = ulp_err(att, att_ref)
    err_att32 = max_err(att32, att32_ref)
    log(f"[{path}] flash_attention vs plain: bf16 max {ulp_att:.1f} bf16 ulp"
        f" (tol 2: both round the same f32 sums once), max abs err "
        f"{err_att:.3e} at max|o| {float(att_ref.float().abs().max()):.3e}; "
        f"f32 {err_att32:.3e} (tol 2e-5, max {ulp_err(att32, att32_ref):.1f}"
        f" ulp)")
    check(ulp_att <= 2 and err_att32 <= 2e-5,
          f"[{path}] flash_attention beyond tolerance")

    # the DiT at full width, bf16: kernel attention vs the plain version
    x = rnd(BATCH, *spec.sde.state_shape(DATA))
    tt = torch.rand(BATCH, generator=gen, device=dev)
    with torch.no_grad():
        eps_kernel = net(x, tt)
        orig = attn_ops.attention
        attn_ops.attention = lambda q_, k_, v_, **kw: attention_ref(
            q_, k_, v_, **kw)
        try:
            eps_plain = net(x, tt)
        finally:
            attn_ops.attention = orig
    torch.cuda.synchronize()
    scale = float(eps_plain.abs().max())
    err_dit = max_err(eps_kernel, eps_plain) / scale
    log(f"[{path}] DiT bf16 eps, kernel vs plain attention: max abs err / "
        f"max|eps| = {err_dit:.3e} (tol 5e-2), max|eps| {scale:.3e}")
    check(math.isfinite(scale) and err_dit <= 5e-2,
          f"[{path}] DiT eps beyond tolerance")

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return timed_record(
        "flash_attention" if path == "cifar10-cld" else "flash_attention[bdm]",
        path, "src/repro_torch/csrc/attention.cu",
        "src/repro/kernels/attention/kernel.py:109",
        counts.get("flash_attention", 0), err_att,
        lambda: attn_ops.attention(q, k, v, causal=False), "flash_fwd_kernel<64",
        lambda: attention_ref(q, k, v, causal=False),
        4 * BATCH * S * H * Dh * 2,                  # q, k, v read; o written
        4 * BATCH * H * S * S * Dh, BF16_FLOPS,      # QK^T and PV
        library_fn=lambda: sdpa(qh, kh, vh))


def dct_records(counts, gen, dev):
    """dct2 (both directions) and bdm_ei_update against their plain
    versions at the BDM path's shape (4, 32, 32, 3) f32, and timed.  The
    library yardstick for dct2 is one einsum over both axes (TF32 off)."""
    from repro_torch.kernels.dct2 import ops as dct_ops
    from repro_torch.kernels.dct2 import ref as dct_ref
    H, W, Ch = DATA
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    x = rnd(BATCH, H, W, Ch)
    errs = []
    for inverse in (False, True):
        got = dct_ops.dct2(x, inverse=inverse)
        want = (dct_ref.idct2_ref if inverse else dct_ref.dct2_ref)(x)
        torch.cuda.synchronize()
        errs.append(max_err(got, want))
    scale = float(x.abs().max())
    log(f"[cifar10-bdm] dct2 vs plain: max abs err forward {errs[0]:.3e}, "
        f"inverse {errs[1]:.3e} at max|x| {scale:.3e} (tol 1e-6 of max|x|:"
        f" two 32-term f32 sums per element, in another order than cuBLAS)")
    check(max(errs) <= 1e-6 * scale, "dct2 beyond tolerance")

    q = 2
    u, eps = rnd(BATCH, H, W, Ch), rnd(q, BATCH, H, W, Ch)
    psi = torch.rand(H, W, 1, generator=gen, device=dev)
    C = rnd(q, H, W, 1)
    got = dct_ops.bdm_ei_update(u, eps, psi, C)
    want = dct_ref.bdm_ei_update_ref(u, eps, psi, C)
    torch.cuda.synchronize()
    err_bdm = max_err(got, want)
    oscale = float(want.abs().max())
    log(f"bdm_ei_update (q = {q}) vs plain: max abs err {err_bdm:.3e} at "
        f"max|out| {oscale:.3e} (tol 1e-6 of max|out|)")
    check(err_bdm <= 1e-6 * oscale, "bdm_ei_update beyond tolerance")

    # bytes: each input read once and the output written once (the DCT
    # matrices are constants of the function, not inputs); operations: a
    # fast DCT's, so the bound is the least the card could take
    tile_ops = fast_dct2_ops(H, W)
    img = 4 * x.numel()
    ch = dct_ops.dct_matrix_f32(H, dev)
    cw = dct_ops.dct_matrix_f32(W, dev)
    src = "src/repro_torch/csrc/dct2.cu"
    return [
        timed_record(
            "dct2", "cifar10-bdm", src, "src/repro/kernels/dct2/kernel.py:98",
            counts.get("dct2", 0), max(errs),
            lambda: dct_ops.dct2(x), "dct2_kernel",
            lambda: dct_ref.dct2_ref(x), 2 * img,
            BATCH * Ch * tile_ops, F32_FLOPS,
            library_fn=lambda: torch.einsum("hi,bijc,wj->bhwc", ch, x, cw)),
        timed_record(
            "bdm_ei_update", None, src, "src/repro/kernels/dct2/kernel.py:53",
            0, err_bdm, lambda: dct_ops.bdm_ei_update(u, eps, psi, C),
            "bdm_ei_update_kernel",
            lambda: dct_ref.bdm_ei_update_ref(u, eps, psi, C),
            (q + 2) * img + 4 * (psi.numel() + C.numel()),
            BATCH * Ch * ((q + 2) * tile_ops + (2 * q + 1) * H * W),
            F32_FLOPS)]


def noise_check(keys64, keys, kcs, algs, n):
    """step_noise (the round kernel's threefry draw on its own) against the
    plain PRNG: bits exact, normals within 2 ulp; returns the max abs
    difference of the normals."""
    from repro_torch import random as prng
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    z_k, bits_k = rf.step_noise(keys, kcs, algs, n=n, with_bits=True)
    step_key = prng.fold_in(prng.fold_in(keys64, algs), kcs)
    f = torch.arange(n, device=keys.device)[None]
    bits_p = prng.bits_at(step_key[:, None], f, n)
    z_p = rf_ref.draw_step_noise(keys, kcs, algs, (n,))
    torch.cuda.synchronize()
    check(torch.equal(prng.from_int32_bits(bits_k), bits_p),
          f"step_noise bits differ from the plain PRNG (n = {n})")
    ulp = ulp_diff(z_k, z_p)
    log(f"noise (n = {n}): bits exact over {bits_k.numel()} draws, normals "
        f"within {ulp} ulp (tol 2)")
    check(ulp <= 2, "step_noise normals beyond 2 ulp")
    return max_err(z_k, z_p)


def reduced_check(name, mix):
    """The reduced config's samples on the card (kernels) against the plain
    version on the CPU, within 1e-3 of the sample scale."""
    outs = {}
    for d in ("cuda", "cpu"):
        _, _, reng = make_engine(name, d, reduced=True, seed=5)
        outs[d] = reng.serve(requests(mix, 50))
    rel = max(float(np.abs(outs["cuda"][r] - outs["cpu"][r]).max()
                    / np.abs(outs["cpu"][r]).max()) for r in outs["cpu"])
    log(f"reduced {name}, card (kernels) vs CPU (plain): max abs err / "
        f"max|sample| = {rel:.3e} (tol 1e-3)")
    check(rel <= 1e-3, f"reduced {name}: samples on the card disagree with "
          "the CPU")


def lm_requests(vocab: int, seed0: int, n: int = N_REQUESTS, lens=None,
                max_new=None):
    """n token requests (seeds 0..n-1) with prompts of random ids drawn
    from numpy seed `seed0`, lengths cycling through `lens` (default
    LM_LENS), max_new tokens each (default LM_MAX_NEW)."""
    from repro_torch.serve import ServeRequest
    lens = LM_LENS if lens is None else lens
    max_new = LM_MAX_NEW if max_new is None else max_new
    rng = np.random.default_rng(seed0)
    return [ServeRequest(rid=i, workload="token", seed=i, max_new=max_new,
                         tokens=rng.integers(2, vocab, size=lens[i % len(lens)])
                         .astype(np.int32)) for i in range(n)]


def drive_lm_path(dev, card: str):
    """The token path: full-width gemma3-1b on a batch-4 TokenEngine (no
    eos, so every request runs its budget), a warm-up serve, the launch
    counts set to 0, one measured serve, the counts read right after.
    Returns (arch, engine, counts)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda as kc
    from repro_torch.models.registry import Arch
    from repro_torch.serve import TokenEngine
    t0 = time.perf_counter()
    arch = Arch(get_arch(LM_ARCH))
    params = arch.init(seed=SEED, device=dev)
    engine = TokenEngine(arch, params, batch_size=BATCH, max_len=LM_MAX_LEN,
                         eos_id=-1, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["ln_f"]]) + \
        sum(t.numel() for lp in params["layers"] for t in
            [lp["ln_attn"], lp["ln_mlp"], *lp["attn"].values(),
             *lp["mlp"].values()])
    vocab = arch.cfg.vocab
    log(f"[{LM_ARCH}] engine: {n_params} parameters drawn on the card, "
        f"caches {BATCH} x {LM_MAX_LEN}: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    engine.serve(lm_requests(vocab, 1000))          # warm-up (other prompts)
    torch.cuda.synchronize()
    log(f"[{LM_ARCH}] warm-up serve: {time.perf_counter() - t0:.2f}s")
    rounds0, prefills0, toks0 = (engine.n_decode_steps,
                                 engine.n_prefill_calls, engine.n_tokens_out)
    kc.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(lm_requests(vocab, SEED))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    n_tok = engine.n_tokens_out - toks0
    log(f"[{LM_ARCH}] serve: {len(results)} requests, {n_tok} tokens in "
        f"{dt:.4f}s, {engine.n_decode_steps - rounds0} decode rounds, "
        f"{engine.n_prefill_calls - prefills0} prefill calls, "
        f"{n_tok / dt:.3f} tokens/s ({card}); launches {counts}")
    check(sorted(results) == list(range(N_REQUESTS)),
          f"{LM_ARCH}: missing results")
    for rid, ids in results.items():
        check(len(ids) == LM_MAX_NEW, f"{LM_ARCH}: request {rid} returned "
              f"{len(ids)} tokens, expected {LM_MAX_NEW}")
        check(bool(((ids >= 0) & (ids < vocab)).all()),
              f"{LM_ARCH}: request {rid} has ids outside [0, {vocab})")
    for k in LM_KERNELS:
        check(counts.get(k, 0) > 0, f"{LM_ARCH}: {k} never launched on the "
              "path")
    return arch, engine, counts


def causal_pairs(Sq: int, Sk: int, window, q_offset: int = 0) -> int:
    """(query, key) pairs the causal/window mask keeps: the work prefill
    attention needs on these inputs."""
    n = 0
    for i in range(Sq):
        qp = q_offset + i
        lo = 0 if window is None else max(0, qp - window + 1)
        n += max(0, min(qp, Sk - 1) - lo + 1)
    return n


def lm_records(engine, counts, gen, dev):
    """decode_attention and the causal flash_attention at the token path's
    shapes (bf16; window 512 and global), each against its plain version
    (at most 2 bf16 ulp; f32 inputs within 1e-5 / 2e-5) and timed beside
    it, its bound and SDPA with the same boolean mask."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    cfg = engine.arch.cfg
    Hq, Hkv, Dh, S = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, LM_MAX_LEN
    rep = Hq // Hkv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    bf = torch.bfloat16
    records = []

    # decode: the rows mid-serve, 24 tokens past prompts of 96 and 640
    lens = [LM_LENS[b % 2] + 24 for b in range(BATCH)]
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q32, k32, v32 = rnd(BATCH, Hq, Dh), rnd(BATCH, S, Hkv, Dh), \
        rnd(BATCH, S, Hkv, Dh)
    q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
    for window in (512, None):
        got = dec_ops.decode_attention(q, k, v, cl, window=window)
        want = decode_attention_ref(q, k, v, cl, window=window)
        got32 = dec_ops.decode_attention(q32, k32, v32, cl, window=window)
        want32 = decode_attention_ref(q32, k32, v32, cl, window=window)
        torch.cuda.synchronize()
        ulp, err32 = ulp_err(got, want), max_err(got32, want32)
        log(f"[{LM_ARCH}] decode_attention (window {window}) vs plain: bf16 "
            f"max {ulp:.1f} bf16 ulp (tol 2), max abs err "
            f"{max_err(got, want):.3e}; f32 {err32:.3e} (tol 1e-5)")
        check(ulp <= 2 and err32 <= 1e-5,
              f"decode_attention (window {window}) beyond tolerance")
        n_keys = sum(min(n, window or n) for n in lens)
        nbytes = 2 * (q.numel() + 2 * n_keys * Hkv * Dh + q.numel()) \
            + 4 * BATCH
        ops = 4 * n_keys * rep * Hkv * Dh
        keep = torch.arange(S, device=dev)[None] < cl[:, None]
        if window is not None:
            keep &= torch.arange(S, device=dev)[None] >= cl[:, None] - window
        qh = q[:, :, None]                                  # (B, Hq, 1, Dh)
        kh = k.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        vh = v.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        mask = keep[:, None, None, :]
        split_ms = time_ms(lambda: dec_ops.decode_attention(
            q, k, v, cl, window=window), kernel="decode_split_kernel")[0]
        merge_ms = time_ms(lambda: dec_ops.decode_attention(
            q, k, v, cl, window=window), kernel="decode_merge_kernel")[0]
        log(f"  decode_attention passes: split {split_ms:.5f} ms, merge "
            f"{merge_ms:.5f} ms (median launch durations)")
        rec = timed_record(
            "decode_attention" + ("[global]" if window is None else ""),
            LM_ARCH, "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:93",
            counts.get("decode_attention", 0), max_err(got, want),
            lambda: dec_ops.decode_attention(q, k, v, cl, window=window), "",
            lambda: decode_attention_ref(q, k, v, cl, window=window),
            nbytes, ops, BF16_FLOPS,
            library_fn=lambda: sdpa(qh, kh, vh, attn_mask=mask))
        rec.update(launches_merge=counts.get("decode_attention_merge", 0),
                   split_ms=split_ms, merge_ms=merge_ms)
        records.append(rec)

    # prefill: one 640-token prompt into the 1024-long cache (G = 1, as the
    # alternating prompt lengths make every admission wave)
    L = LM_LENS[1]
    q32, k32, v32 = rnd(1, L, Hq, Dh), rnd(1, S, Hkv, Dh), rnd(1, S, Hkv, Dh)
    q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
    for window in (512, None):
        kw = dict(causal=True, window=window, q_offset=0)
        got = attn_ops.attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        got32 = attn_ops.attention(q32, k32, v32, **kw)
        want32 = attention_ref(q32, k32, v32, **kw)
        torch.cuda.synchronize()
        ulp, err32 = ulp_err(got, want), max_err(got32, want32)
        log(f"[{LM_ARCH}] flash_attention causal (window {window}) vs plain: "
            f"bf16 max {ulp:.1f} bf16 ulp (tol 2), max abs err "
            f"{max_err(got, want):.3e}; f32 {err32:.3e} (tol 2e-5)")
        check(ulp <= 2 and err32 <= 2e-5,
              f"causal flash_attention (window {window}) beyond tolerance")
        pairs = causal_pairs(L, S, window)
        # q and o, and the keys/values up to the last query (the causal
        # mask hides the rest of the cache)
        nbytes = 2 * (2 * q.numel() + 2 * L * Hkv * Dh)
        ops = 4 * pairs * Hq * Dh
        qp = torch.arange(L, device=dev)[:, None]
        kp = torch.arange(S, device=dev)[None]
        keep = kp <= qp
        if window is not None:
            keep &= kp > qp - window
        qh = q.transpose(1, 2).contiguous()
        kh = k.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        vh = v.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        records.append(timed_record(
            "flash_attention[causal" + (",global]" if window is None
                                        else ",window]"),
            LM_ARCH, "src/repro_torch/csrc/attention.cu",
            "src/repro/kernels/attention/kernel.py:109",
            counts.get("flash_attention", 0), max_err(got, want),
            lambda: attn_ops.attention(q, k, v, **kw), "flash_lm_kernel",
            lambda: attention_ref(q, k, v, **kw), nbytes, ops, BF16_FLOPS,
            library_fn=lambda: sdpa(qh, kh, vh, attn_mask=keep)))
    return records


def lm_model_check(engine, gen, dev):
    """Full-width gemma3-1b, bf16: the last prompt position's logits and
    one per-slot decode step with the kernels against the same model with
    the plain attention versions (tol 5e-2 of max |logits|: bf16 rounding
    through 26 layers)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    arch, params = engine.arch, engine.params
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        2, arch.cfg.vocab, size=(2, LM_LENS[1]))).to(dev)
    pos = torch.tensor([LM_LENS[1], LM_LENS[1] - 3], dtype=torch.int32,
                       device=dev)

    def run():
        logits, caches = arch.prefill(params, {"tokens": toks}, LM_MAX_LEN)
        nxt = torch.argmax(logits, -1)[:, None]
        logits2, _ = arch.decode(params, nxt, caches, pos)
        return logits.float(), logits2.float()

    kern = run()
    orig = attn_ops.attention, dec_ops.decode_attention
    attn_ops.attention = lambda q_, k_, v_, **kw: attention_ref(q_, k_, v_,
                                                                **kw)
    dec_ops.decode_attention = decode_attention_ref
    try:
        plain = run()
    finally:
        attn_ops.attention, dec_ops.decode_attention = orig
    torch.cuda.synchronize()
    for what, a, b in zip(("prefill", "decode"), kern, plain):
        scale = float(b.abs().max())
        err = max_err(a, b) / scale
        log(f"[{LM_ARCH}] bf16 {what} logits, kernels vs plain attention: "
            f"max abs err / max|logits| = {err:.3e} (tol 5e-2), max|logits| "
            f"{scale:.3e}")
        check(math.isfinite(scale) and err <= 5e-2,
              f"{LM_ARCH}: {what} logits beyond tolerance")


def reduced_lm_check():
    """The reduced gemma3-1b (f32) with the same seeded weights on the card
    (kernels) and on the CPU (plain versions): prefill and per-slot decode
    logits within 1e-4 of max |logits|, and a TokenEngine serve (batch 3,
    prompts of 20 and 9 tokens against the reduced window of 16) giving
    equal token streams."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import Arch
    from repro_torch.serve import TokenEngine
    arch = Arch(get_arch(LM_ARCH, reduced=True))
    toks = np.random.default_rng(4).integers(2, arch.cfg.vocab, size=(2, 20))
    logits, streams = {}, {}
    for d in ("cuda", "cpu"):
        eng = TokenEngine(arch, arch.init(seed=5, device="cpu"), batch_size=3,
                          max_len=32, device=d)
        t = torch.from_numpy(toks).to(d)
        lg, caches = arch.prefill(eng.params, {"tokens": t}, 32)
        pos = torch.tensor([20, 14], dtype=torch.int32, device=d)
        out = [lg]
        for _ in range(3):
            lg, caches = arch.decode(eng.params, torch.argmax(
                out[0], -1)[:, None].to(torch.int32), caches, pos)
            out.append(lg)
            pos = pos + 1
        logits[d] = [x.float().cpu() for x in out]
        streams[d] = eng.serve(lm_requests(arch.cfg.vocab, 50, n=7,
                                           lens=(20, 9), max_new=8))
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(logits["cuda"], logits["cpu"]))
    same = all(np.array_equal(streams["cuda"][r], streams["cpu"][r])
               for r in streams["cpu"])
    log(f"reduced {LM_ARCH}, card (kernels) vs CPU (plain): logits max abs "
        f"err / max|logits| = {rel:.3e} (tol 1e-4); token streams of "
        f"{len(streams['cpu'])} requests equal: {same}")
    check(rel <= 1e-4, f"reduced {LM_ARCH}: logits on the card disagree")
    check(same and sorted(streams["cuda"]) == list(range(7)),
          f"reduced {LM_ARCH}: token streams on the card differ from the CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch import random as prng
    from repro_torch.kernels import cuda as kc
    from repro_torch.launch.serve import parse_sampler_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    # ---- 1. build every kernel, in parallel ------------------------------
    t0 = time.perf_counter()
    reports = kc.build_all(LIBRARIES)
    log(f"build: {time.perf_counter() - t0:.2f}s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    # ---- 2. the kernel's noise draw against the plain PRNG --------------
    g = torch.Generator().manual_seed(3)
    keys64 = torch.randint(0, 2**32, (BATCH, 2), generator=g).to(dev)
    keys = prng.to_int32_bits(keys64)
    kcs = torch.tensor([0, 3, 7, 9], dtype=torch.int32, device=dev)
    algs = torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=dev)
    noise_check(keys64, keys, kcs, algs, 2 * 3072)       # CLD's state
    err_noise = noise_check(keys64, keys, kcs, algs, 3072)       # BDM's

    # ---- 3. the main paths, counts read around each ----------------------
    mix = [parse_sampler_spec(s) for s in MIX]
    paths = {}
    for name in PATH_KERNELS:
        paths[name] = drive_path(name, dev, mix, card)
        eng = paths[name][2]
        profile_serve(name, lambda: len(eng.serve(requests(mix, 2000))),
                      out_dir / f"serve_profile_{name.split('-')[1]}.txt",
                      "samples")
    _, lm_engine, lm_counts = drive_lm_path(dev, card)
    vocab = lm_engine.arch.cfg.vocab

    def lm_serve():
        n0 = lm_engine.n_tokens_out
        lm_engine.serve(lm_requests(vocab, 2000))
        return lm_engine.n_tokens_out - n0

    profile_serve(LM_ARCH, lm_serve, out_dir / "serve_profile_lm.txt",
                  "tokens")

    # ---- 4. each kernel against its plain version, timed -----------------
    records = []
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, (spec, net, engine, counts) in paths.items():
        x = slot_inputs(engine, mix, dev, gen)
        records += round_records(name, engine, x, keys, counts,
                                 streamed=name == "cifar10-bdm")
        records.append(attention_record(name, spec, net, counts, gen, dev))
    bdm_counts = paths["cifar10-bdm"][3]
    records += dct_records(bdm_counts, gen, dev)
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    n = 3072
    records.append(timed_record(
        "step_noise", "cifar10-bdm", "src/repro_torch/csrc/round_fused.cu",
        "src/repro/kernels/round_fused/kernel.py:110",
        bdm_counts.get("step_noise", 0), err_noise,
        lambda: rf.step_noise(keys, kcs, algs, n=n), "step_noise_kernel",
        lambda: rf_ref.draw_step_noise(keys, kcs, algs, (n,)),
        4 * (BATCH * (2 + 2) + BATCH * n), 0, F32_FLOPS))

    records += lm_records(lm_engine, lm_counts, gen, dev)
    lm_model_check(lm_engine, gen, dev)
    names = [r["name"] for r in records]
    check("flash_attention" in names and any(
        n.startswith("flash_attention[causal") for n in names),
        "the kernels record lacks a form of flash_attention")

    # ---- 5. reduced configs: the card vs the plain version on the CPU ----
    for name in PATH_KERNELS:
        reduced_check(name, mix)
    reduced_lm_check()

    log(smi())
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
