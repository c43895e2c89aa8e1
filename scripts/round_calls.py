"""The round commit one call at a time on the card, to compare two checkouts.

    python3 scripts/round_calls.py [--src DIR] [--save F] [--against F]

On each engine path of chip_smoke.py (cifar10-cld, cifar10-bdm,
cifar10-ddpm: full width, the engines' own banks, chip_smoke's inputs and
seeds) it traces one round_update call (with the corrector) and one
round_predict call and logs their device events, summed device time and
the median duration of each round kernel in them (round_fused_kernel,
round_predict_kernel, step_noise_kernel: parent and change timed at the
same inputs, whatever their wrappers' signatures).
No limit is checked, so a checkout from before the one-launch commit can be
read too: the script runs the `repro_torch` package of the checkout at DIR
(default: this one).  With `--save F` it writes the calls' results and a
step_noise draw of 2^20 elements a slot (gddim and gmm slots) to F; with
`--against F` it compares them bit for bit with a file that another
checkout wrote.  Parent and change in one call:

    python3 scripts/round_calls.py --src <parent> --save p.pt
    python3 scripts/round_calls.py --against p.pt

Prints one JSON line last; exits 1 if a comparison differs.  Needs one card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

KERNELS = ("round_fused_kernel", "round_predict_kernel", "step_noise_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="checkout whose repro_torch package runs")
    ap.add_argument("--save", help="write the results here")
    ap.add_argument("--against", help="compare the results with this file")
    opt = ap.parse_args()
    sys.path.insert(0, str(opt.src.resolve() / "src"))
    if not torch.cuda.is_available():
        print("round_calls: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.launch.serve import parse_sampler_spec
    dev = torch.device("cuda")
    card = smoke.smi()
    smoke.log(card)
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
            kernels = {k: statistics.median(
                e.time_range.elapsed_us() / 1e3 for e in events
                if k in e.name) for k in KERNELS
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
    if opt.save:
        torch.save(outs, opt.save)
    same = None
    if opt.against:
        ref = torch.load(opt.against)
        same = {k: len(v) == len(ref[k])
                and all(torch.equal(a, b) for a, b in zip(v, ref[k]))
                for k, v in outs.items()}
        smoke.log(f"results bitwise equal to {opt.against}: {same}")
    print(json.dumps({"round_calls": report, "bitwise": same,
                      "card": card}), flush=True)
    return 0 if same is None or all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
