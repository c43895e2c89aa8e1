"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from src/repro_torch/csrc, then drives the
two main paths through `repro_torch.serve.DiffusionEngine`, each at full
width with random weights from a seed (DiT img 32 / patch 2 / d_model 768 /
24 layers / 12 heads, bf16):

  * `cifar10-cld` (state (B, 2, 32, 32, 3)): round_fused with in-kernel
    noise, round_predict (kf = 2), flash_attention;
  * `cifar10-bdm` (state (B, 32, 32, 3), canonical DCT coefficients):
    dct2 around every eval, step_noise + dct2 + round_fused with streamed
    noise, round_predict (kf = 1), flash_attention.

Each path is served once with the launch counts set to 0 just before and
read just after; every kernel of the path must have launched, and the
samples must be finite.  Then each kernel is held against its plain
PyTorch version at the path's shapes (bdm_ei_update, which no path runs,
on its own), timed beside its plain version, a library call where one
computes the same function, and its bound; the reduced configs' samples on
the card are checked against the plain version on the CPU; and one serve
of each path runs under a CUPTI trace.  It prints:

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


def profile_serve(name: str, engine, mix, out: Path) -> None:
    """Where the time goes: one more serve of the mix under a CUPTI trace;
    the device time by kernel lands in `out`."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(requests(mix, 2000))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    log(f"[{name}] profile: serve wall {wall:.4f}s, device busy {busy:.4f}s "
        f"({100 * busy / wall:.1f}% busy, {100 - 100 * busy / wall:.1f}% "
        f"idle), {len(events)} device events")
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
        attn_ops.attention = lambda q_, k_, v_, causal: attention_ref(
            q_, k_, v_, causal=causal)
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
    reports = kc.build_all(["round_fused", "attention", "dct2"])
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
        profile_serve(name, paths[name][2], mix,
                      out_dir / f"serve_profile_{name.split('-')[1]}.txt")

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

    # ---- 5. reduced configs: samples on the card vs the plain version ----
    for name in PATH_KERNELS:
        reduced_check(name, mix)

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
