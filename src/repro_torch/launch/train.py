"""Training driver for the paper's diffusion configs (the JAX package's
`launch/train.py`, diffusion side).

Fault-tolerant by construction: atomic checkpoints every --ckpt-every
steps (async writer), --resume restarts exactly (the data stream and the
step keys are pure functions of the step).  Runs on `cuda` unless
--device cpu is given.

    python -m repro_torch.launch.train --diffusion cifar10-cld --reduced \\
        --steps 4 --batch 4 --device cpu [--ckpt-dir D --ckpt-every 2] \\
        [--resume]

LM training (--arch, the JAX package's `train_lm`) is not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import random as prng
from ..ckpt.store import CheckpointStore
from ..configs import get_diffusion
from ..convert import load_train_state, train_state_tree
from ..data.pipeline import MixturePipeline
from ..optim.adamw import AdamWCfg, adamw_init
from . import steps as steps_lib


def diffusion_opt_cfg(lr: float, steps: int) -> AdamWCfg:
    """The JAX driver's AdamW for diffusion: warmup max(steps // 20, 5),
    no weight decay, cosine to `steps`."""
    return AdamWCfg(lr=lr, total_steps=steps,
                    warmup_steps=max(steps // 20, 5), weight_decay=0.0)


def diffusion_pipeline(spec, batch: int, seed: int) -> MixturePipeline:
    """Four seeded mixture means uniform in [-1, 1] of the data's shape,
    std 0.05, equal weights: the JAX driver's data."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, size=(4,) + tuple(spec.data_shape))
    return MixturePipeline(means=means, stds=np.full(4, 0.05),
                           weights=np.ones(4), global_batch=batch, seed=seed)


def train_diffusion(args, *, spec=None, on_step: Optional[Callable] = None
                    ) -> dict:
    """Train `args.diffusion` (or `spec`, a DiffusionSpec whose Stage-I
    tables are then shared) for `args.steps` steps: AdamW as the JAX
    driver sets it, the seeded mixture pipeline, the step key
    fold_in(key, step), a checkpoint every --ckpt-every steps (async) and
    at the end (blocking), --resume from the newest committed one.

    `on_step(step, net, opt_state, metrics)`, where given, is called each
    time the train state stands at `step` steps: once before the first
    step (at the restored step after a resume, metrics None), then after
    each step and its checkpoint.  A true return ends the run there, as a
    preemption would; the end's checkpoint is then taken at that step."""
    device = torch.device(args.device)
    if spec is None:
        spec = get_diffusion(args.diffusion, reduced=args.reduced)
    opt_cfg = diffusion_opt_cfg(args.lr, args.steps)
    key = prng.PRNGKey(args.seed, device)
    net = spec.init(seed=args.seed, device=device).requires_grad_()
    opt_state = adamw_init(net.parameters(), opt_cfg)
    pipe = diffusion_pipeline(spec, args.batch, args.seed)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if store and args.resume:
        latest, restored = store.restore_latest(
            train_state_tree(net, opt_state))
        if latest is not None:
            load_train_state(net, opt_state, restored)
            start_step = latest
            print(f"resumed from step {start_step}")

    step_fn = steps_lib.make_diffusion_train_step(spec, opt_cfg)
    losses = []
    step, saved = start_step, None
    stop = on_step is not None and on_step(step, net, opt_state, None)
    t0 = time.perf_counter()
    it = pipe.iterator(start_step, device=device)
    while step < args.steps and not stop:
        batch = next(it)
        metrics = step_fn(net, opt_state, {"x0": batch["x0"]},
                          prng.fold_in(key, step))
        losses.append(float(metrics["loss"]))
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:5d} dsm-loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        step += 1
        if store and args.ckpt_every and step % args.ckpt_every == 0:
            store.save(step, train_state_tree(net, opt_state))
            saved = step
        stop = on_step is not None and on_step(step, net, opt_state, metrics)
    if store:
        if saved == step:
            store.wait()
        else:
            store.save(step, train_state_tree(net, opt_state), blocking=True)
    dt = time.perf_counter() - t0
    if losses:
        print(f"done: {len(losses)} steps in {dt:.1f}s on {device}; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"done: nothing to train from step {start_step}")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None, "step": step,
            "net": net, "opt_state": opt_state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="LM training: not ported yet")
    ap.add_argument("--diffusion")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.arch:
        raise NotImplementedError(
            "LM training is not ported yet (the JAX package's train_lm); "
            "--diffusion trains the paper's configs")
    if not args.diffusion:
        ap.error("--diffusion required")
    train_diffusion(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
