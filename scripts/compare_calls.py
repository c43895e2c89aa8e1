"""One suite of calls on the card, to compare two checkouts.

    python3 scripts/compare_calls.py SUITE [--src DIR] [--save F] [--against F]

The script runs the `repro_torch` package of the checkout at DIR (default:
this one) with chip_smoke.py's inputs and seeds, and checks no limit, so a
checkout from before a redesign can be read too.  With `--save F` it
writes the suite's results to F; with `--against F` it compares them bit
for bit with a file that another checkout wrote.  Parent and change in one
call:

    python3 scripts/compare_calls.py SUITE --src <parent> --save p.pt
    python3 scripts/compare_calls.py SUITE --against p.pt

SUITE is one of

  round  On each engine path of chip_smoke.py (cifar10-cld, cifar10-bdm,
         cifar10-ddpm: full width, the engines' own banks) one traced
         round_update call (with the corrector) and one round_predict call:
         device events, summed device time and the median duration of each
         round kernel in them.  Results: the calls' outputs and a
         step_noise draw of 2^20 elements a slot (gddim and gmm slots).
  ei     At path A's shape (n 64, D 3072, f32) on VPSDE (cifar10-ddpm, k 1)
         and CLD (cifar10-cld, k 2): one traced `core.gddim._update` call at
         q 2 on eps rows that the config's score net returned (device
         events, device time, median ei_update_kernel launch), and one
         traced sampler loop (`core.gddim.sample_gddim`, nfe 10, q 2, its
         coefficients built beforehand: device events and time); the kernel
         alone (median traced launch) at q 2 for k 1 and 2 and at q 1-4 for
         k 1, on rows (stacked first where the checkout's wrapper takes only
         a stacked history); at q 2 the kernel at 64, 128 and 256 threads a
         block (where the checkout's private override takes `threads`) and
         PyTorch's addcmul over the same four streams (u and two rows read,
         one output written) as a yardstick; and, by cuobjdump of the built
         library, each ei_update_kernel instance's global loads (LDG) and
         whether every one comes before the first f32 multiply (FMUL).

Prints one JSON line last; exits 1 if a comparison differs.  Needs one
card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

ROUND_KERNELS = ("round_fused_kernel", "round_predict_kernel",
                 "step_noise_kernel")
EI_KERNEL = "ei_update_kernel"


def median_ms(events, kernel: str):
    durs = [e.time_range.elapsed_us() / 1e3 for e in events
            if kernel in e.name]
    return statistics.median(durs) if durs else None


def round_suite(dev, card: str):
    """(results, report) of the round commit on each engine path."""
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.launch.serve import parse_sampler_spec
    smoke.log(f"package: {Path(rf.__file__).resolve()}")
    mix = [parse_sampler_spec(s) for s in smoke.MIX]
    _, keys, kcs, algs = smoke.noise_inputs(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    outs, report = {}, {}
    for name in smoke.PATH_KERNELS:
        _, _, engine = smoke.make_engine(name, dev)
        engine._prepare(smoke.requests(mix, 0))
        engine._refresh_bank()
        x = smoke.slot_inputs(engine, mix, dev, gen)
        update, predict, _, _ = smoke.round_calls_of(engine, x, keys)
        report[name] = {}
        for what, fn in (("round_update", update),
                         ("round_predict", predict)):
            n, ms, events = smoke.call_trace(fn)
            kernels = {k: median_ms(events, k) for k in ROUND_KERNELS
                       if any(k in e.name for e in events)}
            smoke.log(f"[{name}] one {what} call: {n} device events, {ms} "
                      f"ms of device time ({card}); median launch {kernels}; "
                      f"{sorted({e.name[:60] for e in events})}")
            report[name][what] = dict(kernels=n, ms=ms, kernel_ms=kernels)
        outs[name] = [t.cpu() for t in update()] + [predict().cpu()]
    n = 1 << 20
    if "cfg" in inspect.signature(rf.step_noise_kernel).parameters:
        cfgs = torch.arange(len(algs), dtype=torch.int32, device=dev)
        z = rf.step_noise_kernel(keys, kcs, cfgs, algs, n=n)
    else:                   # a checkout whose draw takes alg per slot
        z = rf.step_noise_kernel(keys, kcs, algs, n=n)
    outs["step_noise"] = [z.cpu()]
    return outs, report


def sass_report(lib: Path) -> dict:
    """{instance: (LDGs, index of the last LDG, index of the first FMUL)}
    for each ei_update_kernel in the library, by instruction order."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        smoke.log("cuobjdump not found: no SASS report")
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if EI_KERNEL not in name or "bdm" in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", block)
        ldg = [i for i, op in enumerate(ops) if op.startswith("LDG")]
        fmul = [i for i, op in enumerate(ops) if op.startswith("FMUL")]
        out[smoke.kernel_label(name)] = (
            len(ldg), ldg[-1] if ldg else None, fmul[0] if fmul else None)
    return out


def sampler_loop(spec, net, gen, dev):
    """Path A's deterministic sampler loop (`core.gddim.sample_gddim`, nfe
    10, q 2) on n = A_N states, its coefficients built beforehand."""
    from repro_torch.core import build_sampler_coeffs, gddim, time_grid
    ts = time_grid(spec.sde, 10)
    co = build_sampler_coeffs(spec.sde, ts, q=2, lam=0.0, kt=spec.kt)
    eps_fn = spec.make_eps_fn(net, ts)
    u_T = torch.randn((smoke.A_N,) + tuple(spec.sde.state_shape(smoke.DATA)),
                      generator=gen, device=dev)

    @torch.no_grad()
    def loop():
        return gddim.sample_gddim(spec.sde, co, eps_fn, u_T, q=2)
    return loop


def ei_suite(dev, card: str):
    """(results, report) of one path A state update and the ei_update
    kernel."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels.ei_update import ops
    smoke.log(f"package: {Path(ops.__file__).resolve()}")
    rows_form = hasattr(ops, "history_rows")
    gen = torch.Generator(device=dev).manual_seed(7)
    outs, report = {}, {}
    for name in ("cifar10-ddpm", "cifar10-cld"):
        spec, net = smoke.make_sampler(name, dev)
        call = smoke.update_call(spec, net, gen, dev, q=2)
        n, ms, events = smoke.call_trace(call)
        med = median_ms(events, EI_KERNEL)
        smoke.log(f"[{name}] one core.gddim._update call on the net's eps "
                  f"rows: {n} device events, {ms} ms of device time, "
                  f"median {EI_KERNEL} {med} ms ({card}); "
                  f"{sorted({e.name[:60] for e in events})}")
        report[name] = dict(call_events=n, call_ms=ms, call_kernel_ms=med)
        outs[name] = [call().cpu()]
        loop = sampler_loop(spec, net, gen, dev)
        n, ms, _ = smoke.call_trace(loop, calls=2, lead=1)
        smoke.log(f"[{name}] one path A sampler loop (nfe 10, q 2, n "
                  f"{smoke.A_N}, Stage I outside): {n} device events, {ms} "
                  f"ms of device time ({card})")
        report[name].update(loop_events=n, loop_ms=ms)
        outs[name].append(loop().cpu())
        del net
    override = getattr(ops, "_ei_update", None)
    threads_arg = override is not None and \
        "threads" in inspect.signature(override).parameters
    for k, qs in ((1, (1, 2, 3, 4)), (2, (2,))):
        for q in qs:
            u, rows, psi, C = smoke.ei_rows(k, q, gen, dev)
            hist = rows if rows_form else torch.stack(rows)
            ms = smoke.time_ms(lambda: ops.ei_update(u, hist, psi, C),
                               kernel=EI_KERNEL)[0]
            smoke.log(f"ei_update k {k} q {q}: median launch {ms:.6f} ms "
                      f"({'rows' if rows_form else 'pre-stacked'}; {card})")
            report[f"ei_update[k={k},q={q}]"] = ms
            outs[f"k{k}q{q}"] = [ops.ei_update(u, hist, psi, C).cpu()]
            if q != 2:
                continue
            if threads_arg:
                sweep = {t: smoke.time_ms(
                    lambda: override(u, hist, psi, C, threads=t),
                    kernel=EI_KERNEL)[0] for t in (64, 128, 256)}
                smoke.log(f"ei_update k {k} q 2 by threads a block: {sweep}")
                report[f"block_sweep[k={k}]"] = sweep
            o = torch.empty_like(u)
            add = smoke.time_ms(lambda: torch.addcmul(u, rows[0], rows[1],
                                                      out=o),
                                kernel="addcmul")[0]
            smoke.log(f"addcmul over the same four streams (k {k}): "
                      f"{add:.6f} ms")
            report[f"addcmul[k={k}]"] = add
    sass = sass_report(kc._lib_path("ei_update"))
    for label, (n_ldg, last, first) in sorted(sass.items()):
        ahead = last is not None and first is not None and last < first
        smoke.log(f"SASS {label}: {n_ldg} LDG, last at instruction {last}, "
                  f"first FMUL at {first}: every LDG before the first FMUL: "
                  f"{ahead}")
    report["sass"] = sass
    return outs, report


SUITES = {"round": round_suite, "ei": ei_suite}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("suite", choices=sorted(SUITES))
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="checkout whose repro_torch package runs")
    ap.add_argument("--save", help="write the results here")
    ap.add_argument("--against", help="compare the results with this file")
    opt = ap.parse_args()
    sys.path.insert(0, str(opt.src.resolve() / "src"))
    if not torch.cuda.is_available():
        print("compare_calls: no CUDA device", file=sys.stderr)
        return 2
    card = smoke.smi()
    smoke.log(card)
    outs, report = SUITES[opt.suite](torch.device("cuda"), card)
    if opt.save:
        torch.save(outs, opt.save)
    same = None
    if opt.against:
        ref = torch.load(opt.against)
        same = {k: len(v) == len(ref[k])
                and all(torch.equal(a, b) for a, b in zip(v, ref[k]))
                for k, v in outs.items()}
        smoke.log(f"results bitwise equal to {opt.against}: {same}")
    print(json.dumps({"suite": opt.suite, "report": report, "bitwise": same,
                      "card": card}), flush=True)
    return 0 if same is None or all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
