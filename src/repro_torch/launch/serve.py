"""Serving CLI over the `repro_torch.serve` engines, on one card.

Token decoding (greedy, continuous batching, batched prefill):

    python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
        --batch 3 --requests 6 --prompt-len 8 --max-new 6 --max-len 32

gDDIM sampling as a service:

    python -m repro_torch.launch.serve --diffusion cifar10-cld --reduced \
        --batch 4 --requests 8 --nfe 10 \
        --mix nfe=10,q=2 nfe=10,q=2,corrector nfe=10,lam=0.5 \
              nfe=10,lam=0.5,algorithm=gmm

Token prompts are random ids from --seed (`numpy` default_rng, ids in
[2, vocab)), as the JAX package's CLI draws them.  Diffusion requests cycle
through the --mix specs (ServeRequest sampler fields as key=value; keys not
named fall back to --nfe/--q/--corrector/--lam/--grid/--algorithm).
Weights are random, drawn from --seed.  The engine runs on --device
(default cuda: the hand-written kernels); --device cpu runs the plain
versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, DIFFUSION_MODULES, get_arch, get_diffusion
from ..core import SamplerConfig
from ..models.registry import Arch
from ..serve import DiffusionEngine, ServeRequest, TokenEngine


def parse_sampler_spec(spec: str) -> dict:
    """Parse one --mix item: 'nfe=50,q=2,corrector,lam=0.5,grid=uniform,
    algorithm=gmm'.  Bare flags ('corrector') mean True; 'lambda' is
    accepted for 'lam'."""
    def parse_bool(v: str) -> bool:
        v = v.strip().lower()
        if v in ("", "1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(v)

    convert = {"nfe": int, "q": int, "lam": float, "grid": str.strip,
               "corrector": parse_bool, "family": str.strip,
               "algorithm": str.strip}
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip().replace("-", "_")
        if key == "lambda":
            key = "lam"
        if key not in convert:
            raise ValueError(f"unknown sampler-config key {key!r} in {spec!r}")
        try:
            out[key] = convert[key](val)
        except ValueError:
            raise ValueError(
                f"bad value {val!r} for {key} in {spec!r}") from None
    return out


def serve_tokens(args) -> int:
    device = torch.device(args.device)
    arch = Arch(get_arch(args.arch, reduced=args.reduced))
    params = arch.init(seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    requests = [ServeRequest(
        rid=rid, workload="token",
        tokens=rng.integers(2, arch.cfg.vocab,
                            size=args.prompt_len).astype(np.int32),
        max_new=args.max_new) for rid in range(args.requests)]
    engine = TokenEngine(arch, params, batch_size=args.batch,
                         max_len=args.max_len, device=device)
    t0 = time.perf_counter()
    results = engine.serve(requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"served {len(results)} requests in {dt:.3f}s on {device} "
          f"({engine.n_decode_steps} decode rounds, {engine.n_prefill_calls} "
          f"prefill calls, {engine.n_polls} polls, batch {args.batch}, "
          f"{engine.n_tokens_out / max(dt, 1e-9):.1f} tok/s, wall clock "
          f"incl. first-call set-up)")
    for rid in sorted(results)[:4]:
        print(f"  req{rid}: {results[rid][:12].tolist()}...")
    return 0


def serve_samples(args) -> int:
    spec = get_diffusion(args.diffusion, reduced=args.reduced)
    device = torch.device(args.device)
    net = spec.init(seed=args.seed, device=device)
    engine = DiffusionEngine(spec, net, batch_size=args.batch,
                             default_config=args.default_config,
                             device=device)
    mix = args.mix_parsed
    requests = [ServeRequest(rid=i, workload="diffusion", seed=args.seed + i,
                             **(mix[i % len(mix)] if mix else {}))
                for i in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.serve(requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"sampled {len(results)} requests in {dt:.3f}s on {device} "
          f"({engine.n_rounds} gDDIM rounds / {engine.n_steps} step "
          f"dispatches, {len(engine.cache)} sampler configs, batch "
          f"{args.batch}, {engine.n_samples_out / max(dt, 1e-9):.2f} "
          f"samples/s, wall clock incl. first-call set-up)")
    for cfg in engine.cache.configs:
        print(f"  config: nfe={cfg.nfe} q={cfg.q} corrector={cfg.corrector} "
              f"lam={cfg.lam} grid={cfg.grid} algorithm={cfg.algorithm}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serving CLI over the repro_torch.serve engines (token "
                    "decoding or gDDIM sampling) on PyTorch/CUDA; request "
                    "flags mirror repro_torch.serve.ServeRequest")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--diffusion", choices=list(DIFFUSION_MODULES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64,
                    help="token workload: cache length per slot")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="token workload: synthetic prompt length")
    ap.add_argument("--max-new", type=int, default=24,
                    help="token workload: ServeRequest.max_new")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nfe", type=int, default=20)
    ap.add_argument("--q", type=int, default=1)
    ap.add_argument("--corrector", action="store_true")
    ap.add_argument("--lam", "--lambda", type=float, default=0.0, dest="lam")
    ap.add_argument("--grid", choices=("quadratic", "uniform"),
                    default="quadratic")
    ap.add_argument("--algorithm", choices=("gddim", "gmm", "accel"),
                    default="gddim")
    ap.add_argument("--mix", nargs="+", metavar="SPEC",
                    help="per-request sampler configs to cycle through, "
                         "e.g. --mix nfe=10,q=2 nfe=10,lam=0.5")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if (args.arch is None) == (args.diffusion is None):
        ap.error("pass exactly one of --arch / --diffusion")
    if args.arch is not None:
        if args.mix:
            ap.error("--mix only applies to --diffusion serving")
        return serve_tokens(args)
    try:
        args.default_config = SamplerConfig(
            nfe=args.nfe, q=args.q, corrector=args.corrector, lam=args.lam,
            grid=args.grid, algorithm=args.algorithm)
        args.mix_parsed = [parse_sampler_spec(s) for s in (args.mix or [])]
        for kw in args.mix_parsed:
            SamplerConfig(**{**dataclasses.asdict(args.default_config), **kw})
    except ValueError as e:
        ap.error(str(e))
    return serve_samples(args)


if __name__ == "__main__":
    raise SystemExit(main())
