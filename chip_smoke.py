"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from src/repro_torch/csrc, serves a
full-width `cifar10-cld` request mix (DiT img 32 / patch 2 / d_model 768 /
24 layers / 12 heads, bf16, random weights from a seed) through
`repro_torch.serve.DiffusionEngine`, checks that the serving path went
through every kernel (launch counts > 0) and that the samples are finite,
holds each kernel against its plain PyTorch version at the path's shapes,
times kernel / plain version / library call, checks the reduced config's
samples on the card against the plain version on the CPU, and prints:

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
    serving path hands each kernel inputs it has just written.  A trace
    without the device events asked for fails the run."""
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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() / 1e3 for e in kernel_events(prof)
            if kernel in e.name]
    check(bool(durs), f"no device events{' named ' + kernel if kernel else ''}"
          " in the trace: no device time measured")
    if kernel:
        # CUPTI may drop a launch at the edge of the trace window
        check(len(durs) >= iters // 2, f"{kernel}: {len(durs)} launches "
              f"traced for {iters} calls")
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


def fused_round_need(ints, dis, *, K, Qb, kf, D):
    """(bytes, f32 ops) that one round_fused launch needs on these staged
    inputs, slot by slot as csrc/round_fused.cu reads them.  Every slot
    reads u, eps, its ints row and writes u, the history, k and active.  A
    slot of this variant (`mine`) reads history rows 0..Qb-2 (the shift
    drops row Qb-1), any other slot all Qb rows.  Stochastic slots add the
    key and the B / P_chol applies, corrector slots (`use_c`) their eps_n
    rows and the cC applies.  Each factor block and pool id used is read
    once, each distinct pool row once.  Ops: kf (3 kf - 1) per element and
    apply plus the kf-wide sums; the noise draw's threefry (integer) and
    erf_inv work is not counted, and leaves the launch bound by bytes."""
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
        nbytes += 4 * D * (K + h_read * K + kf + (kf if use_c else 0))
        nbytes += 4 * D * (K + Qb * K)
        nbytes += 4 * (len(s) + (2 if stoch else 0)
                       + len(used) * (kf * kf + 1) + 2)
        ops += D * (len(used) * kf * (3 * kf - 1) + sums * kf)
    return nbytes + 4 * D * len(rows), ops


def requests(mix_parsed, seed0):
    from repro_torch.serve import ServeRequest
    return [ServeRequest(rid=i, seed=seed0 + i, **mix_parsed[i % len(MIX)])
            for i in range(N_REQUESTS)]


def full_width_engine(dev):
    """The full-width cifar10-cld spec with seeded weights; patch_out and
    the adaLN weights (zero / 1e-3 scale at init) get N(0, 1/d) values so
    the round kernels see a real, non-zero score."""
    from repro_torch.configs import get_diffusion
    from repro_torch.core import SamplerConfig
    from repro_torch.serve import DiffusionEngine
    spec = get_diffusion("cifar10-cld")
    net = spec.init(seed=SEED, device=dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    d = spec.score_cfg.d_model
    with torch.no_grad():
        for p in [net.patch_out, net.final_ada_w] + \
                [lp.ada_w for lp in net.layers]:
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(d))
    engine = DiffusionEngine(spec, net, batch_size=BATCH,
                             default_config=SamplerConfig(nfe=10),
                             device=dev)
    return spec, net, engine


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    from repro_torch.launch.serve import parse_sampler_spec
    from repro_torch import random as prng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build every kernel, in parallel ------------------------------
    t0 = time.perf_counter()
    reports = kc.build_all(["round_fused", "attention"])
    log(f"build: {time.perf_counter() - t0:.2f}s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    # ---- 2. the in-kernel noise draw against the plain PRNG -------------
    B, kf, D = BATCH, 2, 32 * 32 * 3
    n = kf * D
    g = torch.Generator().manual_seed(3)
    keys64 = torch.randint(0, 2**32, (B, 2), generator=g)
    keys = prng.to_int32_bits(keys64).to(dev)
    kcs = torch.tensor([0, 3, 7, 9], dtype=torch.int32, device=dev)
    algs = torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=dev)
    bits_k, z_k = rf.noise_probe(keys, kcs, algs, kf=kf, D=D, n=n)
    step_key = prng.fold_in(prng.fold_in(keys64.to(dev), algs), kcs)
    f = torch.arange(n, device=dev)[None]
    bits_p = prng.bits_at(step_key[:, None], f, n).reshape(B, kf, D)
    z_p = rf_ref.draw_step_noise(keys, kcs, algs, (2, 32, 32, 3)).reshape(
        B, kf, D)
    torch.cuda.synchronize()
    check(torch.equal(prng.from_int32_bits(bits_k), bits_p),
          "round kernel noise bits differ from the plain PRNG")
    noise_ulp = ulp_diff(z_k, z_p)
    log(f"noise: bits exact over {bits_k.numel()} draws, normals within "
        f"{noise_ulp} ulp")
    check(noise_ulp <= 2, "round kernel normals beyond 2 ulp")

    # ---- 3. the main path: full-width cifar10-cld serving ---------------
    mix = [parse_sampler_spec(s) for s in MIX]
    t0 = time.perf_counter()
    spec, net, engine = full_width_engine(dev)
    log(f"engine: Stage I + weights {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    engine.serve(requests(mix, 1000))              # warm-up (other seeds)
    torch.cuda.synchronize()
    log(f"warm-up serve: {time.perf_counter() - t0:.2f}s")
    rounds0 = engine.n_rounds
    kc.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(requests(mix, SEED))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    rounds = engine.n_rounds - rounds0
    log(f"serve: {len(results)} samples in {dt:.4f}s, {rounds} rounds, "
        f"{len(results) / dt:.3f} samples/s ({card}); launches {counts}")
    check(sorted(results) == list(range(N_REQUESTS)), "missing results")
    for rid, x in results.items():
        check(x.shape == (32, 32, 3), f"sample {rid} shape {x.shape}")
        check(bool(np.isfinite(x).all()), f"sample {rid} not finite")
    for name in ("round_fused", "round_predict", "flash_attention"):
        check(counts.get(name, 0) > 0, f"{name} never launched on the path")

    # where the time goes: one more serve of the mix under a CUPTI trace
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(requests(mix, 2000))
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    events = kernel_events(prof)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    log(f"profile: serve wall {wall_p:.4f}s, device busy {busy:.4f}s "
        f"({100 * busy / wall_p:.1f}% busy, {100 - 100 * busy / wall_p:.1f}% "
        f"idle), {len(events)} device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:8]:
        log(f"  {us / 1e3:9.3f} ms  {100 * us / 1e6 / busy:5.1f}%  {name[:90]}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "serve_profile.txt").write_text("".join(
        f"{us:.1f}\t{name}\n" for name, us in top))

    # ---- 4. each kernel against its plain version at the path's shapes --
    records = []
    cfg_ids = torch.tensor([engine.cache.index_of(engine.config_of(r))
                            for r in requests(mix, 0)[:B]], device=dev)
    bank = engine._bank
    K, Qb = engine.state.u.shape[1], engine.state.hist.shape[1]
    gen = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    u, hist = rnd(B, K, D), rnd(B, Qb, K, D)
    eps_c, eps_n = rnd(B, kf, D), rnd(B, kf, D)
    kstep = torch.tensor([0, 4, 8, 9], dtype=torch.int32, device=dev)
    kcl = torch.minimum(kstep, bank.n_steps[cfg_ids] - 1)
    zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    state_shape = (2, 32, 32, 3)
    upd_args = (u, hist, kstep, kcl, cfg_ids, zeros_i, zeros_i, keys,
                active, bank, eps_c)
    upd_kw = dict(state_shape=state_shape, kf=kf, with_corrector=True,
                  eps_n_c=eps_n)

    got = rf.round_update(*upd_args, **upd_kw)
    want = rf_ref.round_update_ref(*upd_args, **upd_kw)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
          "round_fused k/active differ from the plain version")
    err_fused = max(float((a - b).abs().max()) for a, b in zip(got[:2],
                                                               want[:2]))
    det = ~bank.stochastic[cfg_ids]
    bitwise_det = torch.equal(got[0][det], want[0][det])
    log(f"round_fused vs plain: max abs err {err_fused:.3e} (tol 1e-5), "
        f"max {ulp_err(got[0], want[0]):.1f} ulp, k/active exact, "
        f"deterministic slots bitwise: {bitwise_det}")
    check(err_fused <= 1e-5, "round_fused beyond tolerance")

    pred = rf.round_predict(u, hist, kcl, cfg_ids, bank, eps_c, kf=kf)
    pred_ref = rf_ref.round_predict_ref(u, hist, kcl, cfg_ids, bank, eps_c,
                                        kf=kf)
    torch.cuda.synchronize()
    err_pred = float((pred - pred_ref).abs().max())
    log(f"round_predict vs plain: max abs err {err_pred:.3e} (tol 1e-5), "
        f"max {ulp_err(pred, pred_ref):.1f} ulp")
    check(err_pred <= 1e-5, "round_predict beyond tolerance")

    H, S, Dh = spec.score_cfg.n_heads, spec.score_cfg.n_tokens, \
        spec.score_cfg.d_head
    q, k, v = (rnd(B, S, H, Dh).to(torch.bfloat16) for _ in range(3))
    att = attn_ops.attention(q, k, v, causal=False)
    att_ref = attention_ref(q, k, v, causal=False)
    q32, k32, v32 = q.float(), k.float(), v.float()
    att32 = attn_ops.attention(q32, k32, v32, causal=False)
    att32_ref = attention_ref(q32, k32, v32, causal=False)
    torch.cuda.synchronize()
    err_att = float((att.float() - att_ref.float()).abs().max())
    ulp_att = ulp_err(att, att_ref)
    err_att32 = float((att32 - att32_ref).abs().max())
    log(f"flash_attention vs plain: bf16 max {ulp_att:.1f} bf16 ulp (tol 2: "
        f"both round the same f32 sums once), max abs err {err_att:.3e} at "
        f"max|o| {float(att_ref.float().abs().max()):.3e}; f32 "
        f"{err_att32:.3e} (tol 2e-5, max {ulp_err(att32, att32_ref):.1f} "
        f"ulp)")
    check(ulp_att <= 2 and err_att32 <= 2e-5,
          "flash_attention beyond tolerance")

    # DiT at full width, bf16: kernel attention vs the plain version
    x = rnd(B, 2, 32, 32, 3)
    tt = torch.rand(B, generator=gen, device=dev)
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
    err_dit = float((eps_kernel - eps_plain).abs().max()) / scale
    log(f"DiT bf16 eps, kernel vs plain attention: max abs err / max|eps| "
        f"= {err_dit:.3e} (tol 5e-2), max|eps| {scale:.3e}")
    check(math.isfinite(scale) and err_dit <= 5e-2, "DiT eps beyond tolerance")

    # ---- 5. times: kernel, plain version, library call, bound -----------
    # kernels timed alone, on inputs staged once as the wrapper stages them
    ints = rf._stage_ints(kstep, kcl, cfg_ids, zeros_i, zeros_i, active,
                          bank, fam_index=0, prec_index=0,
                          with_corrector=True)
    blks, dis = rf._stage_factors(bank, cfg_ids, kcl, kf, True)
    pblks, pdis = rf._stage_factors(bank, cfg_ids, kcl, kf, False,
                                    predict_only=True)
    f_bytes, f_flops = fused_round_need(ints, dis, K=K, Qb=Qb, kf=kf, D=D)
    every = rf.fused_round_cost(B=B, K=K, Qb=Qb, kf=kf, D=D,
                                pool_rows=int(torch.unique(dis).numel()),
                                with_corrector=True)["bytes_moved"]
    log(f"round_fused on the timed inputs needs {f_bytes} B and {f_flops} "
        f"f32 ops (fused_round_cost, every stream counted: {every} B)")
    bound_fused = max(f_bytes / HBM_BYTES_PER_S, f_flops / F32_FLOPS) * 1e3
    records.append(dict(
        name="round_fused", route="cuda",
        source="src/repro_torch/csrc/round_fused.cu",
        replaces="src/repro/kernels/round_fused/kernel.py:293",
        launches=counts.get("round_fused", 0), max_abs_err=err_fused,
        ms=time_ms(lambda: rf.round_fused(ints, keys, blks, dis, bank.diag,
                                          u, hist, eps_c, eps_n, kf=kf, n=n,
                                          with_corrector=True),
                   kernel="round_fused_kernel"),
        plain_ms=time_ms(lambda: rf_ref.round_update_ref(*upd_args,
                                                          **upd_kw), 20),
        bound_ms=bound_fused,
        bound_by="bytes" if f_bytes / HBM_BYTES_PER_S
        >= f_flops / F32_FLOPS else "operations",
        library_ms=None))
    # predictor: reads u[:, :kf], the Qb - 1 history rows it uses, eps, its
    # factor blocks, pool ids and pool rows; writes (B, kf, D)
    p_bytes = 4 * (B * kf * D * (1 + (Qb - 1) + 1 + 1) + pblks.numel()
                   + pdis.numel() + int(torch.unique(pdis).numel()) * D)
    p_flops = B * D * ((1 + Qb) * kf * (3 * kf - 1) + Qb * kf)
    records.append(dict(
        name="round_predict", route="cuda",
        source="src/repro_torch/csrc/round_fused.cu",
        replaces="src/repro/kernels/round_fused/kernel.py:362",
        launches=counts.get("round_predict", 0), max_abs_err=err_pred,
        ms=time_ms(lambda: rf.round_predict_kernel(pblks, pdis, bank.diag, u,
                                                   hist, eps_c, kf=kf),
                   kernel="round_predict_kernel"),
        plain_ms=time_ms(lambda: rf_ref.round_predict_ref(
            u, hist, kcl, cfg_ids, bank, eps_c, kf=kf), 20),
        bound_ms=max(p_bytes / HBM_BYTES_PER_S, p_flops / F32_FLOPS) * 1e3,
        bound_by="bytes" if p_bytes / HBM_BYTES_PER_S >= p_flops / F32_FLOPS
        else "operations",
        library_ms=None))
    a_bytes = 4 * B * S * H * Dh * 2               # q, k, v read; o written
    a_flops = 4 * B * H * S * S * Dh               # QK^T and PV
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/attention.cu",
        replaces="src/repro/kernels/attention/kernel.py:109",
        launches=counts.get("flash_attention", 0), max_abs_err=err_att,
        ms=time_ms(lambda: attn_ops.attention(q, k, v, causal=False),
                   kernel="flash_fwd_kernel<64"),
        plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=False), 20),
        bound_ms=max(a_bytes / HBM_BYTES_PER_S, a_flops / BF16_FLOPS) * 1e3,
        bound_by="bytes" if a_bytes / HBM_BYTES_PER_S >= a_flops / BF16_FLOPS
        else "operations",
        library_ms=time_ms(lambda: sdpa(qh, kh, vh))))
    for r in records:
        (r["ms"], wall), (r["plain_ms"], pwall) = r["ms"], r["plain_ms"]
        lib = r["library_ms"]
        if lib is not None:
            r["library_ms"], lwall = lib
        log(f"  {r['name']}: device {r['ms']:.5f} ms / wall {wall:.5f} ms per "
            f"call; plain {r['plain_ms']:.5f} / {pwall:.5f}; library "
            f"{r['library_ms']}; bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']}; {r['launches']} launches on the path")

    # ---- 6. reduced config: samples on the card vs the plain version ----
    from repro_torch.configs import get_diffusion
    from repro_torch.core import SamplerConfig
    from repro_torch.serve import DiffusionEngine
    rspec = get_diffusion("cifar10-cld", reduced=True)
    outs = {}
    for d in ("cuda", "cpu"):
        rnet = rspec.init(seed=5, device=d)
        with torch.no_grad():
            rg = torch.Generator().manual_seed(6)
            for p in [rnet.patch_out, rnet.final_ada_w] + \
                    [lp.ada_w for lp in rnet.layers]:
                p.copy_(torch.randn(p.shape, generator=rg)
                        / math.sqrt(rspec.score_cfg.d_model))
        reng = DiffusionEngine(rspec, rnet, batch_size=BATCH,
                               default_config=SamplerConfig(nfe=10),
                               device=d)
        outs[d] = reng.serve(requests(mix, 50))
    rel = max(float(np.abs(outs["cuda"][r] - outs["cpu"][r]).max()
                    / np.abs(outs["cpu"][r]).max()) for r in outs["cpu"])
    log(f"reduced cifar10-cld, card (kernels) vs CPU (plain): max abs err "
        f"/ max|sample| = {rel:.3e} (tol 1e-3)")
    check(rel <= 1e-3, "reduced samples on the card disagree with the CPU")

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
