"""Serving CLI over the `repro_torch.serve` engines, on one card.

Token decoding (greedy, continuous batching, batched prefill):

    python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
        --batch 3 --requests 6 --prompt-len 8 --max-new 6 --max-len 32

gDDIM sampling as a service:

    python -m repro_torch.launch.serve --diffusion cifar10-cld --reduced \
        --batch 4 --requests 8 --nfe 10 \
        --mix nfe=10,q=2 nfe=10,q=2,corrector nfe=10,lam=0.5 \
              nfe=10,lam=0.5,algorithm=gmm

One engine serves several families when --diffusion lists them (the
first is the default), and --mix specs pick a family and a score-net
precision class per request:

    python -m repro_torch.launch.serve --reduced --batch 4 --requests 9 \
        --diffusion cifar10-ddpm,cifar10-cld,cifar10-bdm \
        --mix family=vpsde,nfe=10 family=cld,nfe=8,corrector \
              family=bdm,nfe=8,precision=int8 --device cpu

--replicas N routes the requests through `repro_torch.serve.Router` over N
engines in this process (request i arrives at virtual time i); the results
are those of one engine, bitwise.  --sync-every bounds the rounds between
two host polls.

Token prompts are random ids from --seed (`numpy` default_rng, ids in
[2, vocab)), as the JAX package's CLI draws them; an encoder-decoder arch
(whisper-base) also gets standard-normal frames (frontend_ctx, d_model)
from the same stream, drawn before each prompt, as the JAX CLI does.  Diffusion requests cycle
through the --mix specs (ServeRequest fields as key=value; keys not named
fall back to --nfe/--q/--corrector/--lam/--grid/--algorithm, and the
precision to f32).  Weights are random, drawn from --seed.  The engine
runs on --device (default cuda: the hand-written kernels); --device cpu
runs the plain versions.
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
from ..models.quantize import check_precision
from ..serve import (Arrival, DiffusionEngine, ReplicaSpec, Router,
                     RouterConfig, ServeRequest, TokenEngine, TraceTraffic)


def parse_sampler_spec(spec: str) -> dict:
    """Parse one --mix item: 'family=cld,nfe=50,q=2,corrector,lam=0.5,
    grid=uniform,algorithm=gmm,precision=int8' into `ServeRequest` field
    values.  Bare flags ('corrector') mean True; 'lambda' is accepted for
    'lam'."""
    def parse_bool(v: str) -> bool:
        v = v.strip().lower()
        if v in ("", "1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(v)

    convert = {"nfe": int, "q": int, "lam": float, "grid": str.strip,
               "corrector": parse_bool, "family": str.strip,
               "algorithm": str.strip, "precision": str.strip}
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
    requests = []
    for rid in range(args.requests):
        # an encdec arch's frames first, then the prompt, from one stream
        frames = None
        if arch.encdec:
            frames = rng.standard_normal(
                (arch.spec.frontend_ctx, arch.cfg.d_model)).astype(np.float32)
        requests.append(ServeRequest(
            rid=rid, workload="token",
            tokens=rng.integers(2, arch.cfg.vocab,
                                size=args.prompt_len).astype(np.int32),
            max_new=args.max_new, frames=frames))
    engine = TokenEngine(arch, params, batch_size=args.batch,
                         max_len=args.max_len, sync_every=args.sync_every,
                         device=device)
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
    from ..sde.base import family_name
    device = torch.device(args.device)
    specs = {}
    for name in args.diffusion_names:
        spec = get_diffusion(name, reduced=args.reduced)
        fam = family_name(spec.sde)
        if fam in specs:
            raise SystemExit(f"--diffusion lists family {fam!r} twice")
        specs[fam] = spec
    mix = args.mix_parsed
    for kw in mix:
        if kw.get("family") not in (None, *specs):
            raise SystemExit(f"--mix family {kw['family']!r} is not served; "
                             f"--diffusion provides {list(specs)}")
    nets = {fam: spec.init(seed=args.seed, device=device)
            for fam, spec in specs.items()}
    if len(specs) == 1:
        specs, nets = next(iter(specs.values())), next(iter(nets.values()))

    def build_engine():
        return DiffusionEngine(specs, nets, batch_size=args.batch,
                               default_config=args.default_config,
                               sync_every=args.sync_every, device=device)

    requests = [ServeRequest(rid=i, workload="diffusion", seed=args.seed + i,
                             **(mix[i % len(mix)] if mix else {}))
                for i in range(args.requests)]
    if args.replicas > 1:
        return serve_routed(args, build_engine, requests, device)
    engine = build_engine()
    t0 = time.perf_counter()
    results = engine.serve(requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"sampled {len(results)} requests in {dt:.3f}s on {device} "
          f"({engine.n_rounds} gDDIM rounds / {engine.n_steps} step "
          f"dispatches, {len(engine.cache)} sampler configs, families "
          f"{engine.families}, batch {args.batch}, "
          f"{engine.n_samples_out / max(dt, 1e-9):.2f} samples/s, wall clock "
          f"incl. first-call set-up)")
    for cfg in engine.cache.configs:
        print(f"  config: family={cfg.family} nfe={cfg.nfe} q={cfg.q} "
              f"corrector={cfg.corrector} lam={cfg.lam} grid={cfg.grid} "
              f"algorithm={cfg.algorithm}")
    return 0


def serve_routed(args, build_engine, requests, device) -> int:
    """--replicas N: the router over N engines in this process, request i
    arriving at virtual time i; the plan is a pure function of (requests,
    replica config)."""
    router = Router([ReplicaSpec(index=i, batch=args.batch)
                     for i in range(args.replicas)],
                    RouterConfig(default_nfe=args.default_config.nfe))
    trace = TraceTraffic([Arrival(float(i), r)
                          for i, r in enumerate(requests)])
    engines = [build_engine() for _ in range(args.replicas)]
    t0 = time.perf_counter()
    results, plan = router.serve(trace, engines)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"routed {len(results)} requests over {args.replicas} replicas "
          f"in {dt:.3f}s on {device} "
          f"({[len(s) for s in plan.sub_traces]} per replica, counters "
          f"{plan.counters}, batch {args.batch}, "
          f"{len(results) / max(dt, 1e-9):.2f} samples/s)")
    for a in plan.assignments[:6]:
        print(f"  t={a['t']:.1f} req{a['rid']} -> replica {a['replica']}"
              + (f" after {a['n_requeues']} requeues"
                 if a["n_requeues"] else ""))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serving CLI over the repro_torch.serve engines (token "
                    "decoding or gDDIM sampling) on PyTorch/CUDA; request "
                    "flags mirror repro_torch.serve.ServeRequest")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--diffusion", metavar="NAME[,NAME...]",
                    help="diffusion config(s) to serve, from "
                         f"{list(DIFFUSION_MODULES)}; a comma-separated "
                         "list builds one multi-family engine (the first "
                         "is the default family)")
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
                         "e.g. --mix nfe=10,q=2 nfe=10,lam=0.5 "
                         "family=cld,precision=int8 (family= needs a "
                         "multi-family --diffusion list)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="most rounds between two host polls")
    ap.add_argument("--replicas", type=int, default=1,
                    help="route the requests over N engine replicas in "
                         "this process (repro_torch.serve.Router; "
                         "diffusion only; the results are those of one "
                         "engine, bitwise)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if (args.arch is None) == (args.diffusion is None):
        ap.error("pass exactly one of --arch / --diffusion")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.sync_every < 1:
        ap.error("--sync-every must be >= 1")
    if args.arch is not None:
        if args.mix:
            ap.error("--mix only applies to --diffusion serving")
        if args.replicas > 1:
            ap.error("--replicas applies to --diffusion serving")
        return serve_tokens(args)
    args.diffusion_names = [n.strip() for n in args.diffusion.split(",")
                            if n.strip()]
    for n in args.diffusion_names:
        if n not in DIFFUSION_MODULES:
            ap.error(f"unknown diffusion config {n!r}; known: "
                     f"{list(DIFFUSION_MODULES)}")
    try:
        args.default_config = SamplerConfig(
            nfe=args.nfe, q=args.q, corrector=args.corrector, lam=args.lam,
            grid=args.grid, algorithm=args.algorithm)
        args.mix_parsed = [parse_sampler_spec(s) for s in (args.mix or [])]
        for kw in args.mix_parsed:
            cfg_kw = {k: v for k, v in kw.items() if k != "precision"}
            SamplerConfig(**{**dataclasses.asdict(args.default_config),
                             **cfg_kw})
            if "precision" in kw:
                check_precision(kw["precision"])
    except ValueError as e:
        ap.error(str(e))
    return serve_samples(args)


if __name__ == "__main__":
    raise SystemExit(main())
