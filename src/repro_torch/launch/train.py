"""Training entry points for the LM archs and the paper's diffusion configs (the
JAX package's `launch/train.py`).

Fault-tolerant by construction: atomic checkpoints every --ckpt-every
steps (async writer), --resume restarts exactly (the data stream and the
step keys are pure functions of the step).  Runs on `cuda` unless
--device cpu is given.

    python -m repro_torch.launch.train --arch gemma3-1b --reduced \\
        --steps 4 --batch 2 --seq-len 16 --device cpu [--ckpt-dir D \\
        --ckpt-every 2] [--resume]
    python -m repro_torch.launch.train --diffusion cifar10-cld --reduced \\
        --steps 4 --batch 4 --device cpu [--ckpt-dir D --ckpt-every 2] \\
        [--resume]

LM training covers every token arch of `configs.ARCH_IDS`: the dense and
MoE transformers, rwkv6-7b and zamba2-2.7b (token batches; the gradient
runs through their chunked recurrences), and whisper-base's encoder-
decoder, whose batches carry stub frames drawn from the step's key as the
JAX launcher draws them.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import random as prng
from ..ckpt.store import CheckpointStore
from ..configs import ARCH_IDS, get_arch, get_diffusion
from ..convert import (load_lm_train_state, load_train_state,
                       lm_train_state_tree, train_state_tree)
from ..data.pipeline import MixturePipeline, TokenPipeline
from ..models.registry import Arch
from ..models.transformer import param_list
from ..optim.adamw import AdamWCfg, adamw_init
from . import steps as steps_lib

_EMBED_SCALE = float(np.float32(0.02))     # the JAX launcher's, as an f32


def lm_batch(spec, batch: dict, key, step: int) -> dict:
    """The step's loss batch: tokens and labels, or for an "embeddings"
    arch the labels with stub embeddings N(0, 0.02^2) of shape tokens.shape
    + (d_model,), drawn from fold_in(key, step) as the JAX launcher draws
    them; an encdec arch's also carries stub frames N(0, 0.02^2) (batch,
    frontend_ctx, d_model) from the same key, as the JAX launcher's."""
    if spec.input_mode == "embeddings":
        shape = tuple(batch["tokens"].shape) + (spec.cfg.d_model,)
        emb = prng.normal(prng.fold_in(key, step), shape) * _EMBED_SCALE
        return {"embeddings": emb, "labels": batch["labels"]}
    out = {"tokens": batch["tokens"], "labels": batch["labels"]}
    if spec.family == "encdec":
        shape = (batch["tokens"].shape[0], spec.frontend_ctx,
                 spec.cfg.d_model)
        out["frames"] = prng.normal(prng.fold_in(key, step),
                                    shape) * _EMBED_SCALE
    return out


def train_lm(args, *, spec=None, on_step: Optional[Callable] = None) -> dict:
    """Train `args.arch` (or `spec`, an ArchSpec) for `args.steps` steps
    of causal-LM loss: AdamW as the JAX launcher sets it (warmup max(steps
    // 20, 5), the default weight decay, cosine to `steps`), the seeded
    `TokenPipeline` (batch `args.batch` of `args.seq_len` tokens);
    checkpoints, --resume and `on_step(step, params, opt_state, metrics)`
    as `_train_loop` runs them."""
    device = torch.device(args.device)
    if spec is None:
        spec = get_arch(args.arch, reduced=args.reduced)
    arch = Arch(spec)
    opt_cfg = AdamWCfg(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5))
    key = prng.PRNGKey(args.seed, device)
    params = arch.init(seed=args.seed, device=device)
    for t in param_list(params):
        t.requires_grad_()
    opt_state = adamw_init(param_list(params), opt_cfg)
    pipe = TokenPipeline(vocab=spec.cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.batch, seed=args.seed)
    step_fn = steps_lib.make_train_step(arch, opt_cfg)
    out = _train_loop(
        args, pipe, params, opt_state,
        lambda: lm_train_state_tree(params, opt_state, spec.cfg),
        lambda tree: load_lm_train_state(params, opt_state, tree, spec.cfg),
        lambda batch, step: step_fn(params, opt_state,
                                    lm_batch(spec, batch, key, step)),
        on_step, "loss")
    return {**out, "params": params}


def _train_loop(args, pipe, model, opt_state, tree: Callable,
                load: Callable, take_step: Callable,
                on_step: Optional[Callable], what: str) -> dict:
    """The loop both trainers run: --resume from the newest committed
    checkpoint of `tree()` (copied in by `load`), then `take_step(batch,
    step)` on `pipe`'s batches from there to `args.steps`, a checkpoint
    every --ckpt-every steps (async) and at the end (blocking).
    `on_step(step, model, opt_state, metrics)`, where given, is called
    each time the train state stands at `step` steps: once before the
    first step (at the restored step after a resume, metrics None), then
    after each step and its checkpoint.  A true return ends the run
    there, as a preemption would; the end's checkpoint is then taken at
    that step."""
    device = torch.device(args.device)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if store and args.resume:
        latest, restored = store.restore_latest(tree())
        if latest is not None:
            load(restored)
            start_step = latest
            print(f"resumed from step {start_step}")
    losses = []
    step, saved = start_step, None
    stop = on_step is not None and on_step(step, model, opt_state, None)
    t0 = time.perf_counter()
    it = pipe.iterator(start_step, device=device)
    while step < args.steps and not stop:
        metrics = take_step(next(it), step)
        losses.append(float(metrics["loss"]))
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:5d} {what} {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        step += 1
        if store and args.ckpt_every and step % args.ckpt_every == 0:
            store.save(step, tree())
            saved = step
        stop = on_step is not None and on_step(step, model, opt_state,
                                               metrics)
    if store:
        if saved == step:
            store.wait()
        else:
            store.save(step, tree(), blocking=True)
    dt = time.perf_counter() - t0
    if losses:
        print(f"done: {len(losses)} steps in {dt:.1f}s on {device}; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"done: nothing to train from step {start_step}")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None, "step": step,
            "opt_state": opt_state}


def diffusion_opt_cfg(lr: float, steps: int) -> AdamWCfg:
    """The JAX launcher's AdamW for diffusion: warmup max(steps // 20, 5),
    no weight decay, cosine to `steps`."""
    return AdamWCfg(lr=lr, total_steps=steps,
                    warmup_steps=max(steps // 20, 5), weight_decay=0.0)


def diffusion_pipeline(spec, batch: int, seed: int) -> MixturePipeline:
    """Four seeded mixture means uniform in [-1, 1] of the data's shape,
    std 0.05, equal weights: the JAX launcher's data."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, size=(4,) + tuple(spec.data_shape))
    return MixturePipeline(means=means, stds=np.full(4, 0.05),
                           weights=np.ones(4), global_batch=batch, seed=seed)


def train_diffusion(args, *, spec=None, on_step: Optional[Callable] = None
                    ) -> dict:
    """Train `args.diffusion` (or `spec`, a DiffusionSpec whose Stage-I
    tables are then shared) for `args.steps` steps: AdamW as the JAX
    launcher sets it, the seeded mixture pipeline, the step key
    fold_in(key, step), checkpoints, --resume and `on_step(step, net,
    opt_state, metrics)` as `_train_loop` runs them."""
    device = torch.device(args.device)
    if spec is None:
        spec = get_diffusion(args.diffusion, reduced=args.reduced)
    opt_cfg = diffusion_opt_cfg(args.lr, args.steps)
    key = prng.PRNGKey(args.seed, device)
    net = spec.init(seed=args.seed, device=device).requires_grad_()
    opt_state = adamw_init(net.parameters(), opt_cfg)
    pipe = diffusion_pipeline(spec, args.batch, args.seed)
    step_fn = steps_lib.make_diffusion_train_step(spec, opt_cfg)
    out = _train_loop(
        args, pipe, net, opt_state,
        lambda: train_state_tree(net, opt_state),
        lambda tree: load_train_state(net, opt_state, tree),
        lambda batch, step: step_fn(net, opt_state, {"x0": batch["x0"]},
                                    prng.fold_in(key, step)),
        on_step, "dsm-loss")
    return {**out, "net": net}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS,
                    help="LM training of a token arch")
    ap.add_argument("--diffusion")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.diffusion:
        train_diffusion(args)
    elif args.arch:
        train_lm(args)
    else:
        ap.error("--arch or --diffusion required")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
