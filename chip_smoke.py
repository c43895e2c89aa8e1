"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from src/repro_torch/csrc, then drives the
four main paths through the port's engines, each at full width with
random weights from a seed:

  * `cifar10-cld` (DiffusionEngine; DiT img 32 / patch 2 / d_model 768 /
    24 layers / 12 heads, bf16; state (B, 2, 32, 32, 3)): round_fused with
    in-kernel noise (the whole commit one launch), round_predict (kf = 2),
    flash_attention (DiT form);
  * `cifar10-bdm` (the same DiT over a (B, 32, 32, 3) state held as DCT
    coefficients): dct2 around every eval, step_noise + dct2 + round_fused
    with streamed noise, round_predict (kf = 1), flash_attention;
  * `cifar10-ddpm` (the same DiT over a VPSDE state (B, 32, 32, 3)):
    round_fused with in-kernel noise and round_predict at kf = 1,
    flash_attention;
  * `gemma3-1b` (TokenEngine; 26 layers, d_model 1152, 4 query heads over 1
    KV head of width 256, vocab 262144, bf16, window 512 on 5 layers of 6;
    batch 4, max_len 1024; 8 requests with prompts of 96 and 640 tokens,
    48 new tokens each): flash_attention in its causal/window/GQA form for
    every prefill, decode_attention (one launch a call) in every layer of
    every decode round.

Each path is served once with the launch counts set to 0 just before and
read just after; every kernel of the path must have launched, and the
results must be well formed (finite samples; max_new token ids in
[0, vocab) per request).  Then each kernel is held against its plain
PyTorch version at the path's shapes, timed beside its plain version, a
library call where one computes the same function, and its bound; and one
serve of each path runs under a CUPTI trace.  Two more paths follow:

  * path A, the paper's lockstep sampler: `DiffusionSpec.sample` with
    n = 64 at full width on `cifar10-ddpm` (VPSDE), `cifar10-cld` and
    `cifar10-bdm`, runs nfe=10,q=2 / nfe=10,q=2,corrector / nfe=10,lam=0.5,
    counts read around each: one ei_update (VPSDE, CLD) or bdm_ei_update
    (BDM) launch per state update, flash_attention in every eval (and
    held against its plain version at batch 64);
  * path B, the pre-fusion round step: the CLD and BDM engines serve the
    same list through `make_diffusion_round_step_stitched` (apply_factored
    for every factor apply, step_noise for the noise), and must return the
    fused engine's samples bit for bit.

One traced call of round_update and of round_predict is read on each
engine path: exactly 1 device kernel a call (3 for BDM's round_update:
step_noise, dct2, round_fused), or the run fails; BDM's streamed commit is
checked and timed at 1 and 2 elements a thread (bitwise equal).
ei_update is held bitwise against its plain version at q 0-4, k 1-2, f32
and bf16, in both instances (one 16-byte access a thread, and scalar) and
with the history stacked and as separate rows; its records (timed on
rows, as path A calls it) carry its q sweep (1-4), the launch floor, and
one traced `core.gddim._update` call at path A's shape (q 2) on VPSDE and
CLD, on eps rows that the config's score net returned, which must be
exactly 1 device kernel.
apply_factored is held against its plain version and timed; bdm_ei_update
is checked at q 0-4 and at every cluster size at B = 4 and n = 64, and
its records carry the sweep over cluster sizes and its
FMA floor beside the byte bound; the launch floor (PyTorch's fill of a
one-element tensor, timed once) rides on the apply_factored and
bdm_ei_update records; CLD on the exact score of a four-mode 2-D mixture
checks sampling quality with no trained weights.  Then the training
path, "train + likelihood": the DiT attention's gradient (the forward
kernel inside an autograd Function, the plain backward) against autograd
through the plain version at the training shape (32, 256, 12, 64) bf16,
the forward output gated too; the training entry point
`launch.train.train_diffusion` on full-width `cifar10-cld` (bf16, remat
on: 48 flash_attention launches a step, checked) for 40 steps at batch
32, with samples/s, one traced step's device share and peak memory; the
same entry point preempted at step 20 (its checkpoint saved async), then
resumed (the restored bf16 leaves byte for byte) to step 40 against the
uninterrupted run (bitwise, or within the spread of two uninterrupted
runs, printed); 3 reduced steps card vs CPU; the VPSDE exact-score
likelihood against its closed form and the CLD NLL bound (Hutchinson)
through the trained DiT; 64 samples from the trained net, and the
hand-off from the loss to the sampler witnessed by the training data's
exact eps (its loss against the trained net's, zero's and its
negation's; its samples on the data's modes).  Then the reduced configs
on the card are checked against the plain versions on the CPU (engine samples, path A samples;
gemma3-1b's logits and token streams).  Then online serving, "stream":
one DiffusionEngine over the three full-width families (their nets of the
paths above) `serve_stream`s a seeded Poisson trace of 12 requests at NFE
10 (q 2, the corrector, lambda 0.5; the precision class cycling f32 /
bf16 / int8; a minority of higher priority with deadlines, which
preempt), every round's dispatches checked against the host shadow's
(family, precision) classes and every dispatch's launches against its
class (the int8 class runs the f32 flash kernel); every result must equal
the request served alone bitwise, each bf16-class sample the f32 class's,
each family's int8 eps within `NET_TOLERANCES`, the parking table empty;
gemma3-1b's TokenEngine streams five requests with a preemption (each
equal to its uninterrupted run bitwise); `Router.serve` over two
cifar10-ddpm engines equals one engine's `serve_stream` bitwise; and
round_fused / round_predict at kf 1 in the K 2 pool (foreign rows frozen
bitwise), dct2 on the pool's kf slice and the f32 flash kernel at the
DiT's shape are held against their plain versions and timed.  Last, on a card freed of the
earlier paths, "lm-train": the causal / window / GQA attention's
gradient (`FlashAttention`: the forward kernel, the plain backward) against
autograd through the plain version at the training shapes (4, 1024, 4,
256) over 1 kv head, window 512 and global, and (4, 1024, 14, 64) over
2, bf16, within 2 bf16 ulp, timed beside the plain backward and SDPA;
the entry point `launch.train.train_lm` on full-width gemma3-1b (bf16,
remat on) for 30 steps at batch 4 x 1024 (52 flash_attention launches a
step, checked; the step-0 loss within 1 nat of ln(vocab) and falling;
tokens/s, one traced step's device share and peak memory) and on
internvl2-1b for 10 (its stub embeddings; 48 launches a step); reduced
gemma3-1b card vs CPU (losses within 1e-5) and a run preempted at step 3
and resumed (bitwise, or within the spread of two uninterrupted runs,
printed); then the four new configs served on a TokenEngine (internvl2-
1b, nemotron-4-15b and deepseek-coder-33b at full width and the depth
that fits, llama3-405b at 4 of 126 layers), each with its logits against
the plain attention and the records of its (Hq, Hkv, Dh).  Then phase
10, the encoder-decoder and the MoE transformers, each freed before the
next: `[whisper]` serves full-width whisper-base (6 + 6 layers, d_model
512, 1500 frames, bf16; frames from the seed) on a batch-4 TokenEngine,
8 requests of 16 and 48 prompt tokens, 32 new: the waves and rounds
equal the reduced config's CPU schedule, and the launches by form follow
from them (a wave: 6 encoder DiT-form, 6 causal and 6 cross
flash_attention launches; a round: 6 cross over the f32 memory pool and
6 decode_attention); a `serve_stream` with a whisper slot preempted
(its memory row parked and restored) equal to each request served alone,
bitwise; the model with the kernels against the plain attention; the
encoder (Sk 1500: a key tail), the cross prefill and the f32 decode
cross held against their plain versions and timed.  `[whisper-train]`:
the cross-attention gradient at (8, 128, 8, 64) over 1500 keys within 1
bf16 ulp of autograd through the plain version, then `train_lm` on
whisper-base for 20 steps at batch 8 x 128 with frames each step (36
flash_attention launches a step), its loss falling.  `[moe]`:
qwen3-moe-30b-a3b at 12 of 48 layers serves 8 requests (prompts 64 and
256, 32 new) and llama4-maverick-400b-a17b at 2 of 48 (one dense and one
MoE layer with its shared expert) a wave of 4 and 8 decode rounds, the
launches as the CPU schedule predicts; one MoE layer of each, card
(bf16) against the CPU (f32), with identical expert ids and drops; the
reduced MoE configs card vs CPU; then `train_lm` on qwen3-moe at 2
layers, batch 4 x 256, 10 steps, its loss falling.  Then phase 11, the
recurrent-state families: `[rwkv]` serves full-width rwkv6-7b (32
layers, d_model 4096, 64 heads of 64, bf16) and `[zamba]` full-width
zamba2-2.7b (54 Mamba2 layers, d_model 2560, the shared block's 32 heads
of 80 after every 6 layers, bf16) on a batch-4 TokenEngine with
gemma3-1b's request list (8 requests, prompts of 96 and 640, 48 new,
caches of 1024): the waves and rounds equal the reduced config's CPU
schedule; rwkv launches no attention kernel, zamba one causal
flash_attention a group a wave and one decode_attention a group a round
(9 each); tokens/s after a warm-up; a `serve_stream` with a slot
preempted (its recurrent state parked and restored) equal to each
request served alone, bitwise; zamba's model with the kernels against
the plain attention, and both head-width-80 forms held against their
plain versions and timed beside SDPA, with decode_attention's cluster
sweep.  `[rz-train]`: the causal gradient at (4, 1024, 32, 80) within 2
bf16 ulp of autograd through the plain version, then `train_lm` on
zamba2-2.7b at 36 of 54 layers (batch 4 x 1024, 10 steps, 12
flash_attention launches a step) and on rwkv6-7b at 6 of 32 layers
(batch 4 x 256, 10 steps, no attention launch), the last step of each
traced, each loss falling (the depths that fit the AdamW update's ~32
bytes a param on one card); the
reduced configs of both card vs CPU (logits within 1e-4, equal token
streams).  Each depth cut is printed as `reduced` with its reason.  It
prints:

    <card name>, <power limit>                       (nvidia-smi)
    {"kernels": [...]}                               per-kernel record
    {"ok": true, "device": {...}}                    last line

Any failed check exits non-zero before the last line.  Without a CUDA
device, or outside a checkout, it fails.  Needs one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
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
    "cifar10-ddpm": ("round_fused", "round_predict", "flash_attention"),
}
# the name each path's records carry (the CLD path's are unsuffixed)
PATH_TAG = {"cifar10-cld": "", "cifar10-bdm": "[bdm]",
            "cifar10-ddpm": "[ddpm]"}
LM_ARCH = "gemma3-1b"
LM_LENS = (96, 640)             # prompt lengths, alternating by request
LM_MAX_NEW, LM_MAX_LEN = 48, 1024
LM_KERNELS = ("flash_attention", "decode_attention")
LIBRARIES = ("round_fused", "attention", "dct2", "decode_attention",
             "ei_update")
# path A: DiffusionSpec.sample at full width, n = A_N, after a warm-up run
PATH_A = ("cifar10-ddpm", "cifar10-cld", "cifar10-bdm")
A_N = 64
A_RUNS = [dict(nfe=10, q=2), dict(nfe=10, q=2, corrector=True),
          dict(nfe=10, lam=0.5)]
A_KERNEL = {"cifar10-ddpm": "ei_update", "cifar10-cld": "ei_update",
            "cifar10-bdm": "bdm_ei_update"}
# path B: the pre-fusion round step serving MIX
PATH_B_KERNELS = {
    "cifar10-cld": ("apply_factored", "step_noise", "flash_attention"),
    "cifar10-bdm": ("apply_factored", "step_noise", "dct2",
                    "flash_attention"),
}
QUALITY_N = 4096
# every TPU kernel (file:line of the function that reaches pl.pallas_call)
TPU_KERNELS = (
    "src/repro/kernels/round_fused/kernel.py:293",
    "src/repro/kernels/round_fused/kernel.py:362",
    "src/repro/kernels/attention/kernel.py:109",
    "src/repro/kernels/dct2/kernel.py:98",
    "src/repro/kernels/dct2/kernel.py:53",
    "src/repro/kernels/decode_attention/kernel.py:93",
    "src/repro/kernels/ei_update/kernel.py:56",
    "src/repro/kernels/ei_update/kernel.py:96",
)


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
    serving path hands each kernel inputs it has just written.  Where no
    trace holds the device events asked for, device time comes from CUDA
    events instead (event_ms)."""
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
    # CUPTI may drop launches from a trace, or (in a few runs of this
    # script; cause not known) deliver a trace without the kernel's events
    # or with only some of them: up to three traces are taken until one is
    # full (every call launches at least one kernel), every retry is
    # logged, the fullest trace is kept, and if none holds enough of the
    # kernel's events the call is timed by CUDA events (logged).  A
    # multi-kernel call's time is its traced events' sum over the calls,
    # so a partial trace makes it a lower bound (logged).
    need = iters // 2 if kernel else iters
    durs = []
    for attempt in range(1, 4):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = kernel_events(prof)
        traced = [e.time_range.elapsed_us() / 1e3 for e in events
                  if kernel in e.name]
        if len(traced) > len(durs):
            durs = traced
        if len(traced) >= need:
            if attempt > 1:
                log(f"  trace {attempt} holds {len(traced)} device events"
                    f"{' named ' + kernel if kernel else ''}")
            break
        log(f"  trace of {iters} calls holds {len(traced)} device events"
            f"{' named ' + kernel if kernel else ''} (of {len(events)}: "
            f"{sorted({e.name[:60] for e in events})[:4]}); tracing again")
    if len(durs) < (iters // 2 if kernel else 1):
        ms = event_ms(fn, iters)
        what = f" named {kernel}" if kernel else ""
        log(f"  {len(durs)} device events{what} in the fullest of three "
            f"traces of {iters} calls: {ms:.5f} ms a call by CUDA events "
            f"instead (median of {iters}, each call queued behind a spin "
            f"kernel)")
        return ms, wall
    if kernel:
        return float(np.median(durs)), wall
    if len(durs) < iters:
        log(f"  kept a trace of {len(durs)} device events for {iters} "
            f"calls: the time per call below is a lower bound")
    return sum(durs) / iters, wall


def event_ms(fn, iters: int) -> float:
    """Median device time of one call by CUDA events around it, less the
    median of an empty pair of events (their own cost, a few
    microseconds), taken in turns with the calls.  Each pair is queued
    behind a spin kernel (torch.cuda._sleep, ~0.5 ms) so that the host's
    dispatch of the call falls inside the spin and only the card's work is
    timed; on an H100 it reads ~1 us above a trace's kernel duration (the
    launch itself).  The fallback of time_ms when CUPTI traces come back
    without the events."""
    pairs = {True: [], False: []}
    for _ in range(iters):
        for call in (True, False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            start.record()
            if call:
                fn()
            end.record()
            pairs[call].append((start, end))
    torch.cuda.synchronize()
    med = {k: float(np.median([a.elapsed_time(b) for a, b in v]))
           for k, v in pairs.items()}
    return max(0.0, med[True] - med[False])


def kernel_label(mangled: str) -> str:
    """`name<args>` from a kernel template's mangled name in a ptxas
    report (its integer, bool and element-type arguments: enough to tell
    the instances apart); other names are returned cut to 72 characters."""
    m = re.search(r"([a-z_]+_kernel)I(.*?)EEv", mangled)
    if m is None:
        return mangled[:72]
    args = []
    for num, flag, typ in re.findall(r"Li(-?\d+)E|Lb([01])E|(f|13__nv_bf)",
                                     m.group(2)):
        if typ:
            args.append("float" if typ == "f" else "bf16")
        else:
            args.append(num or ("true" if flag == "1" else "false"))
    return f"{m.group(1)}<{', '.join(args)}>"


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


def matrix_dct2_fmas(H: int, W: int) -> int:
    """f32 multiply-adds of one 2-D DCT of an H x W tile as two dense
    matrix products (H x H times H x W, then H x W times W x W), the form
    the kernels compute: the FMA floor beside Lee's count."""
    return H * W * (H + W)


def bdm_floor_ms(tiles: int, q: int, H: int, W: int) -> float:
    """bdm_ei_update's FMA floor: (q + 2) matrix-form 2-D transforms a
    tile, 2 operations per multiply-add, at the f32 peak."""
    return 2 * tiles * (q + 2) * matrix_dct2_fmas(H, W) / F32_FLOPS * 1e3


def launch_floor_ms() -> float:
    """A launch's floor on this card: the median traced duration of
    PyTorch's fill of a one-element CUDA tensor (a yardstick, like
    library_ms; the port never calls it)."""
    one = torch.zeros(1, device="cuda")
    return time_ms(lambda: one.fill_(1.0), kernel="FillFunctor")[0]


def bdm_cluster_sweep(u, eps, psi, C):
    """The bdm_ei_update kernel's median launch time at 1, 2, 4 and 8
    blocks per (b, channel) tile on these inputs (bdm_q_check holds every
    cluster size against the plain version).  The entry point is called
    directly, outside the wrapper and its launch count."""
    from repro_torch.kernels.dct2 import ops as dct_ops
    out = torch.empty_like(u)
    sweep = {}
    for blocks in (1, 2, 4, 8):
        def call():
            dct_ops._launch_bdm(u, eps, psi, C, out, blocks)
        sweep[blocks] = time_ms(call, kernel="bdm_ei_update_kernel")[0]
    return sweep


def bdm_q_check(shape, gen, dev) -> None:
    """bdm_ei_update at `shape` for q 0-6 (q 5 and 6 take passes of up to 5
    tiles): the wrapper (one launch) within 1e-6 of max|out| of the plain
    version, and the kernel at every cluster size bitwise equal to it."""
    from repro_torch.kernels.dct2 import ops as dct_ops
    from repro_torch.kernels.dct2 import ref as dct_ref
    from repro_torch.kernels import cuda as kc
    B, H, W, Ch = shape
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    worst = 0.0
    for q in range(7):
        u, eps, C = rnd(*shape), rnd(q, *shape), rnd(q, H, W, 1)
        psi = torch.rand(H, W, 1, generator=gen, device=dev)
        n0 = kc.launches().get("bdm_ei_update", 0)
        got = dct_ops.bdm_ei_update(u, eps, psi, C)
        want = dct_ref.bdm_ei_update_ref(u, eps, psi, C)
        out = torch.empty_like(u)
        same = True
        for blocks in (1, 2, 4, 8):
            dct_ops._launch_bdm(u, eps, psi, C, out, blocks)
            torch.cuda.synchronize()
            same = same and torch.equal(out, got)
        rel = max_err(got, want) / float(want.abs().max())
        worst = max(worst, rel)
        check(kc.launches()["bdm_ei_update"] == n0 + 1 and rel <= 1e-6
              and same, f"bdm_ei_update at {shape}, q {q}: one launch, "
              f"within 1e-6 of max|out| ({rel:.3e}), every cluster size "
              f"bitwise ({same})")
    log(f"bdm_ei_update at {shape}, q 0-6: max abs err / max|out| "
        f"{worst:.3e} (tol 1e-6), one launch a call, bitwise at 1, 2, 4 "
        f"and 8 blocks per tile")


def bdm_record(rec, u, eps, psi, C, floor):
    """Add the launch floor and the cluster sweep to a bdm_ei_update
    record, and log them beside the FMA floor."""
    from repro_torch.kernels.dct2 import ops as dct_ops
    B, H, W, Ch = u.shape
    q = eps.shape[0]
    sweep = bdm_cluster_sweep(u, eps, psi, C)
    fma = bdm_floor_ms(B * Ch, q, H, W)
    log(f"  bdm_ei_update at ({B}, {H}, {W}, {Ch}), q {q}, by blocks per "
        f"tile (median launch, ms; the wrapper takes "
        f"{dct_ops.cluster_blocks(B * Ch, H, dct_ops.sm_count(u.device))}): "
        f"{sweep}; FMA floor "
        f"{fma:.6f} ms (matrix form at {F32_FLOPS / 1e12:.0f} TFLOP/s), "
        f"byte bound {rec['bound_ms']:.6f} ms, launch floor {floor:.5f} ms")
    rec.update(cluster_sweep_ms=sweep, launch_floor_ms=floor)
    return rec


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
    engine, counts, results)."""
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
    return spec, net, engine, counts, results


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
                            for r in requests(mix, 0)[:BATCH]],
                           dtype=torch.int32, device=dev)
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


def round_calls_of(engine, x, keys):
    """The path's round_update (with the corrector) and round_predict calls
    on the inputs of `slot_inputs`, through the public wrappers, and the
    round_update arguments (args, kw)."""
    from repro_torch.kernels.round_fused import ops as rf
    sde, bank, kf = engine.spec.sde, x["bank"], x["kf"]
    args = (x["u"], x["hist"], x["k"], x["kc"], x["cfg"], x["zeros"],
            x["zeros"], keys, x["active"], bank, x["eps_c"])
    kw = dict(sde=sde, state_shape=sde.state_shape(DATA), kf=kf,
              with_corrector=True, eps_n_c=x["eps_n"])
    return (lambda: rf.round_update(*args, **kw),
            lambda: rf.round_predict(x["u"], x["hist"], x["kc"], x["cfg"],
                                     bank, x["eps_c"], kf=kf), args, kw)


def call_trace(fn, calls: int = 20, tries: int = 6, lead: int = 10):
    """(device events a call, device ms a call, the events) of `fn` from a
    CUPTI trace: every device event (kernels, copies, fills) counts.  CUPTI
    drops the first few device events of a trace on the H100 machine (6 in
    a row seen), so a trace runs `lead` calls first, then a spin kernel
    (torch.cuda._sleep) as a marker, `calls` calls and a second marker, and
    only the events between the markers count.  Traces are taken until that
    window holds a whole, non-zero number of events a call (each other trace
    is logged), at most `tries`; if none does, the events a call are None
    and the events []."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                fn()
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted(kernel_events(prof), key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        window = events[marks[0] + 1:marks[1]] if len(marks) == 2 else []
        if window and len(window) % calls == 0:
            return (len(window) // calls,
                    sum(e.time_range.elapsed_us() for e in window)
                    / calls / 1e3, window)
        log(f"  trace {attempt}: {len(marks)} markers, {len(window)} device "
            f"events between them for {calls} calls; tracing again")
    return None, None, []


def round_call_report(path, update, predict, card: str) -> dict:
    """Log the device kernels and summed device time of one round_update
    and one round_predict call on the path, and fail unless a round_update
    call runs exactly 1 device kernel (3 for BDM: step_noise, dct2,
    round_fused) and a round_predict call 1."""
    out = {}
    for what, fn, want in (("round_update", update,
                            3 if path == "cifar10-bdm" else 1),
                           ("round_predict", predict, 1)):
        n, ms, events = call_trace(fn)
        check(n is not None, f"[{path}] no trace of {what} calls held a "
              "whole, non-zero number of device events a call")
        names = sorted({e.name[:60] for e in events})
        log(f"[{path}] one {what} call: {n} device kernels, {ms:.5f} ms "
            f"of device time ({card}); {names}")
        check(n == want, f"[{path}] a {what} call runs {n} device kernels "
              f"(want {want})")
        out[what] = dict(kernels=n, ms=ms)
    return out


def round_records(path, engine, x, keys, counts, streamed: bool, card: str):
    """Check round_fused and round_predict against their plain versions at
    the path's shapes, trace one call of each, and time them.  In streamed
    mode (BDM) the commit kernel is given the plain canonical noise (plain
    draw, plain DCT), so it must agree with the plain commit bit for bit,
    at 1 and at 2 elements a thread (the latter is the path's, and both are
    timed); the whole wrapper (step_noise, dct2, round_fused) is held
    within 1e-5."""
    from repro_torch.kernels.dct2.ref import dct2_ref
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    bank = x["bank"]
    kf, K, Qb, D = x["kf"], x["K"], x["Qb"], x["D"]
    update, predict, args, kw = round_calls_of(engine, x, keys)
    n = int(np.prod(kw["state_shape"]))
    noise_c = None
    if streamed:
        noise = rf_ref.draw_step_noise(keys, x["kc"], bank.alg[x["cfg"]],
                                       kw["state_shape"])
        noise_c = dct2_ref(noise).reshape(BATCH, kf, D)
        kw_ref = dict(kw, noise_c=noise_c)
    else:
        kw_ref = kw

    def fused(elems=None):
        return rf._round_fused(*args, x["eps_n"], noise_c, kf=kf, n=n,
                               with_corrector=True, elems=elems)

    def predict_kernel():
        return rf.round_predict_kernel(x["u"], x["hist"], x["kc"], x["cfg"],
                                       bank, x["eps_c"], kf=kf)

    got = update()
    want = rf_ref.round_update_ref(*args, **kw_ref)
    kern = fused()
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
          f"[{path}] round_fused k/active differ from the plain version")
    check(torch.equal(kern[2], want[2]) and torch.equal(kern[3], want[3]),
          f"[{path}] round_fused kernel k/active differ")
    err_fused = max(max_err(a, b) for a, b in zip(kern[:2], want[:2]))
    err_wrap = max(max_err(a, b) for a, b in zip(got[:2], want[:2]))
    det = ~bank.stochastic[x["cfg"]]
    bitwise = torch.equal(kern[0][det], want[0][det]) if not streamed \
        else torch.equal(kern[0], want[0]) and torch.equal(kern[1], want[1])
    same_e = not streamed or all(torch.equal(a, b)
                                 for a, b in zip(kern, fused(1)))
    log(f"[{path}] round_fused vs plain: kernel max abs err {err_fused:.3e}"
        f" (tol 1e-5), max {ulp_err(kern[0], want[0]):.1f} ulp, "
        f"{'all' if streamed else 'deterministic'} slots bitwise: "
        f"{bitwise}; through round_update {err_wrap:.3e} (tol 1e-5); "
        f"k/active exact" + ("; 1 and 2 elements a thread bitwise: "
                             f"{same_e}" if streamed else ""))
    check(err_fused <= 1e-5 and err_wrap <= 1e-5,
          f"[{path}] round_fused beyond tolerance")
    check(bitwise, f"[{path}] round_fused not bitwise on the "
          f"{'same canonical noise' if streamed else 'deterministic slots'}")
    check(same_e, f"[{path}] round_fused differs between elements a thread")

    pred = predict()
    pred_ref = rf_ref.round_predict_ref(x["u"], x["hist"], x["kc"],
                                        x["cfg"], bank, x["eps_c"], kf=kf)
    torch.cuda.synchronize()
    err_pred = max_err(pred, pred_ref)
    log(f"[{path}] round_predict vs plain: max abs err {err_pred:.3e} (tol "
        f"1e-5), max {ulp_err(pred, pred_ref):.1f} ulp")
    check(err_pred <= 1e-5, f"[{path}] round_predict beyond tolerance")
    per_call = round_call_report(path, update, predict, card)

    ints = rf._stage_ints(x["k"], x["kc"], x["cfg"], x["zeros"], x["zeros"],
                          x["active"], bank, fam_index=0, prec_index=0,
                          with_corrector=True)
    blks, dis = rf._stage_factors(bank, x["cfg"], x["kc"], kf, True)
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
    fused_name, predict_name = {
        "cifar10-cld": ("round_fused", "round_predict"),
        "cifar10-bdm": ("round_fused[streamed]", f"round_predict[kf={kf}]"),
        "cifar10-ddpm": ("round_fused[ddpm]", "round_predict[ddpm]")}[path]
    recs = [
        timed_record(
            fused_name, path, src,
            "src/repro/kernels/round_fused/kernel.py:293",
            counts.get("round_fused", 0), err_fused, fused,
            "round_fused_kernel",
            lambda: rf_ref.round_update_ref(*args, **kw_ref),
            f_bytes, f_ops, F32_FLOPS),
        timed_record(
            predict_name, path, src,
            "src/repro/kernels/round_fused/kernel.py:362",
            counts.get("round_predict", 0), err_pred, predict_kernel,
            "round_predict_kernel",
            lambda: rf_ref.round_predict_ref(x["u"], x["hist"], x["kc"],
                                             x["cfg"], bank, x["eps_c"],
                                             kf=kf),
            p_bytes, p_ops, F32_FLOPS)]
    recs[0]["call"] = per_call["round_update"]
    recs[1]["call"] = per_call["round_predict"]
    if streamed:
        sweep = {e: time_ms(lambda: fused(e), kernel="round_fused_kernel")[0]
                 for e in (1, 2)}
        log(f"  {fused_name} [{path}] by elements a thread (median launch, "
            f"ms): {sweep}")
        recs[0]["elems_sweep_ms"] = sweep
    return recs


def attention_check(path, cfg, n, gen, dev):
    """flash_attention at the DiT's shape (n, 256, 12, 64) in bf16 and f32
    against its plain version.  Returns the bf16 (q, k, v) and max abs
    err."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    H, S, Dh = cfg.n_heads, cfg.n_tokens, cfg.d_head
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, k, v = (rnd(n, S, H, Dh).to(torch.bfloat16) for _ in range(3))
    att = attn_ops.attention(q, k, v, causal=False)
    att_ref = attention_ref(q, k, v, causal=False)
    q32, k32, v32 = q.float(), k.float(), v.float()
    att32 = attn_ops.attention(q32, k32, v32, causal=False)
    att32_ref = attention_ref(q32, k32, v32, causal=False)
    torch.cuda.synchronize()
    err_att = max_err(att, att_ref)
    ulp_att = ulp_err(att, att_ref)
    err_att32 = max_err(att32, att32_ref)
    log(f"[{path}] flash_attention vs plain at ({n}, {S}, {H}, {Dh}): bf16 "
        f"max {ulp_att:.1f} bf16 ulp (tol 2: both round the same f32 sums "
        f"once), max abs err {err_att:.3e} at max|o| "
        f"{float(att_ref.float().abs().max()):.3e}; f32 {err_att32:.3e} (tol "
        f"2e-5, max {ulp_err(att32, att32_ref):.1f} ulp)")
    check(ulp_att <= 2 and err_att32 <= 2e-5,
          f"[{path}] flash_attention beyond tolerance at batch {n}")
    return q, k, v, err_att


def attention_timed(name, path, q, k, v, launches, err):
    """The kernels-line record of the DiT's flash_attention on (q, k, v),
    with SDPA as the library yardstick."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    n, S, H, Dh = q.shape
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return timed_record(
        name, path, "src/repro_torch/csrc/attention.cu",
        "src/repro/kernels/attention/kernel.py:109", launches, err,
        lambda: attn_ops.attention(q, k, v, causal=False),
        "flash_dit_wgmma_kernel<64",
        lambda: attention_ref(q, k, v, causal=False),
        4 * n * S * H * Dh * 2,                      # q, k, v read; o written
        4 * n * H * S * S * Dh, BF16_FLOPS,          # QK^T and PV
        library_fn=lambda: sdpa(qh, kh, vh))


def attention_record(path, spec, net, counts, gen, dev):
    """flash_attention at the serving DiT's shape (B, 256, 12, 64) against
    its plain version, and the DiT's eps at full width, bf16, with the
    kernel against the plain attention."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    q, k, v, err_att = attention_check(path, spec.score_cfg, BATCH, gen, dev)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
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
    return attention_timed("flash_attention" + PATH_TAG[path], path, q, k, v,
                           counts.get("flash_attention", 0), err_att)


def dct_records(counts, gen, dev, floor):
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

    bdm_q_check((BATCH, H, W, Ch), gen, dev)
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
        bdm_record(timed_record(
            "bdm_ei_update", None, src, "src/repro/kernels/dct2/kernel.py:53",
            0, err_bdm, lambda: dct_ops.bdm_ei_update(u, eps, psi, C),
            "bdm_ei_update_kernel",
            lambda: dct_ref.bdm_ei_update_ref(u, eps, psi, C),
            (q + 2) * img + 4 * (psi.numel() + C.numel()),
            BATCH * Ch * ((q + 2) * tile_ops + (2 * q + 1) * H * W),
            F32_FLOPS), u, eps, psi, C, floor)]


def noise_inputs(dev):
    """The noise check's keys (the uint32 words, and as int32 bit patterns),
    step indices and algorithm ids, one per slot."""
    from repro_torch import random as prng
    g = torch.Generator().manual_seed(3)
    keys64 = torch.randint(0, 2**32, (BATCH, 2), generator=g).to(dev)
    return (keys64, prng.to_int32_bits(keys64),
            torch.tensor([0, 3, 7, 9], dtype=torch.int32, device=dev),
            torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=dev))


def noise_check(keys64, keys, kcs, algs, n):
    """step_noise (the round kernel's threefry draw on its own) against the
    plain PRNG: bits exact, normals within 2 ulp; returns the max abs
    difference of the normals."""
    from repro_torch import random as prng
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    cfgs = torch.arange(len(algs), dtype=torch.int32, device=keys.device)
    z_k, bits_k = rf.step_noise_kernel(keys, kcs, cfgs, algs, n=n,
                                       with_bits=True)
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


# ---- path A: the lockstep gDDIM sampler; path B: the pre-fusion step -------
def sliced_w2(x: np.ndarray, y: np.ndarray, n_proj: int = 128,
              seed: int = 0) -> float:
    """Sliced 2-Wasserstein distance between point clouds (flattened); a
    copy of benchmarks/common.py's."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    y = np.asarray(y, np.float64).reshape(len(y), -1)
    d = x.shape[1]
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((d, n_proj))
    proj /= np.linalg.norm(proj, axis=0, keepdims=True)
    xp = np.sort(x @ proj, axis=0)
    yp = np.sort(y @ proj, axis=0)
    n = min(len(xp), len(yp))
    xq = xp[np.linspace(0, len(xp) - 1, n).astype(int)]
    yq = yp[np.linspace(0, len(yp) - 1, n).astype(int)]
    return float(np.sqrt(np.mean((xq - yq) ** 2)))


def run_name(run: dict) -> str:
    return ",".join(k if v is True else f"{k}={v}" for k, v in run.items())


def updates_of(run: dict) -> int:
    """State updates (= eps evals) one sampler run makes: N, or 2N - 1
    with the corrector (none on the last step)."""
    return 2 * run["nfe"] - 1 if run.get("corrector") else run["nfe"]


def make_sampler(name: str, dev, reduced: bool = False, seed: int = SEED,
                 sde=None):
    """The spec (optionally with another instance of its SDE, to reuse a
    solved R_t grid) and seeded weights for config `name`."""
    from repro_torch.configs import get_diffusion
    spec = get_diffusion(name, reduced=reduced)
    if sde is not None:
        spec = dataclasses.replace(spec, sde=sde)
    net = spec.init(seed=seed, device=dev)
    randomize_score(net, spec.score_cfg.d_model, seed + 1)
    return spec, net


def drive_path_a(name: str, dev, card: str, out: Path):
    """Path A: `DiffusionSpec.sample` at full width, n = A_N, each of
    A_RUNS after a warm-up run, the launch counts set to 0 just before and
    read just after each.  Every state update is one launch of the
    family's update kernel and every eval one flash_attention per layer.
    One more run under a CUPTI trace gives the device share.  Returns
    (spec, net, [per-run dict])."""
    from repro_torch import random as prng
    from repro_torch.core import build_sampler_coeffs, time_grid
    from repro_torch.kernels import cuda as kc
    spec, net = make_sampler(name, dev)
    kernel = A_KERNEL[name]
    layers = spec.score_cfg.n_layers
    t0 = time.perf_counter()
    spec.sample(net, prng.PRNGKey(1000, dev), A_N, device=dev, **A_RUNS[0])
    torch.cuda.synchronize()
    log(f"[{name}] path A warm-up run (CLD's first one solves its R_t "
        f"grid): {time.perf_counter() - t0:.2f}s")
    runs = []
    for r, run in enumerate(A_RUNS):
        t0 = time.perf_counter()
        build_sampler_coeffs(spec.sde, time_grid(spec.sde, run["nfe"]),
                             q=run.get("q", 2), lam=run.get("lam", 0.0),
                             kt=spec.kt)
        stage1 = time.perf_counter() - t0
        kc.reset_launches()
        t0 = time.perf_counter()
        x = spec.sample(net, prng.PRNGKey(SEED + r, dev), A_N, device=dev,
                        **run)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kc.launches()
        n_up = updates_of(run)
        check(x.shape == (A_N,) + DATA and bool(torch.isfinite(x).all()),
              f"[{name}] path A {run_name(run)}: samples malformed")
        check(counts.get(kernel, 0) == n_up, f"[{name}] path A "
              f"{run_name(run)}: {counts.get(kernel, 0)} {kernel} launches "
              f"for {n_up} state updates")
        check(counts.get("flash_attention", 0) == n_up * layers,
              f"[{name}] path A {run_name(run)}: flash_attention launched "
              f"{counts.get('flash_attention', 0)} times, not {n_up} evals "
              f"x {layers} layers")
        log(f"[{name}] path A {run_name(run)}: {A_N} samples in {dt:.4f}s "
            f"(the call builds Stage I on the host: {stage1:.4f}s when "
            f"timed alone just before), {n_up} updates; launches {counts}")
        log(f"path A samples/s [{name} {run_name(run)}]: {A_N / dt:.3f} "
            f"({card})")
        runs.append(dict(run=run_name(run), seconds=dt, stage1=stage1,
                         counts=counts))
    profile_serve(f"{name} path A",
                  lambda: spec.sample(net, prng.PRNGKey(2000, dev), A_N,
                                      device=dev, **A_RUNS[0]).shape[0],
                  out / f"sample_profile_{name.split('-')[1]}.txt",
                  "samples")
    return spec, net, runs


def drive_path_b(name: str, path, mix, card: str):
    """Path B: the engine of `name` serves the same list again through the
    pre-fusion round step (its `_steps` swapped for the stitched step), the
    counts set to 0 just before and read just after.  Every request must
    equal the fused engine's bit for bit: on the card both chains compute
    each factor apply as (blk * diag) * z summed left to right without
    fused multiply-adds, draw the same noise bits (the step_noise device
    code) and run the same evals.  Returns the counts."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.launch.steps import make_diffusion_round_step_stitched
    spec, _, engine, _, fused = path
    fused_steps = engine._steps
    engine._steps = {
        cls: make_diffusion_round_step_stitched(
            spec, fam_index=engine.cache.fam_index(cls[0]))
        for cls in fused_steps}
    try:
        kc.reset_launches()
        t0 = time.perf_counter()
        results = engine.serve(requests(mix, SEED))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = kc.launches()
    finally:
        engine._steps = fused_steps
    log(f"[{name}] path B (stitched round step): {len(results)} samples in "
        f"{dt:.4f}s, {len(results) / dt:.3f} samples/s ({card}); launches "
        f"{counts}")
    check(sorted(results) == sorted(fused), f"[{name}] path B: missing "
          "results")
    for k in PATH_B_KERNELS[name]:
        check(counts.get(k, 0) > 0, f"[{name}] path B: {k} never launched")
    check(counts.get("round_fused", 0) == 0,
          f"[{name}] path B: the fused commit ran on the stitched path")
    same = [rid for rid in fused if np.array_equal(results[rid], fused[rid])]
    rel = max(float(np.abs(results[r] - fused[r]).max()
                    / np.abs(fused[r]).max()) for r in fused)
    log(f"[{name}] path B vs the fused engine: {len(same)} of {len(fused)} "
        f"requests bitwise (tol: bitwise), max abs err / max|sample| "
        f"{rel:.3e}")
    check(len(same) == len(fused), f"[{name}] path B samples differ from the "
          "fused engine's")
    return counts


def ei_q_check(gen, dev) -> None:
    """ei_update at path A's shape (n = A_N, D 3072), k 1-2, q 0-4, f32 and
    bf16, the history stacked and as separate rows: the wrapper (one
    launch, the 16-byte instance) and the scalar instance through the
    private override bitwise equal to the plain version."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels.ei_update import ops as ei_ops
    from repro_torch.kernels.ei_update import ref as ei_ref
    D = int(np.prod(DATA))
    hgen = torch.Generator().manual_seed(17)
    n = 0
    for k in (1, 2):
        for q in range(ei_ops.MAX_Q + 1):
            for dtype in (torch.float32, torch.bfloat16):
                u = torch.randn(A_N, k, D, generator=gen, device=dev)
                eps = torch.randn(q, A_N, k, D, generator=gen, device=dev)
                u, eps = u.to(dtype), eps.to(dtype)
                psi = torch.randn(k, k, generator=hgen)
                C = torch.randn(q, k, k, generator=hgen)
                want = ei_ref.ei_update_ref(u, eps, psi, C)
                for hist in (eps, [eps[j].clone() for j in range(q)]):
                    n0 = kc.launches().get("ei_update", 0)
                    got = ei_ops.ei_update(u, hist, psi, C)
                    torch.cuda.synchronize()
                    check(kc.launches()["ei_update"] == n0 + 1
                          and torch.equal(got, want), f"ei_update (k {k}, "
                          f"q {q}, {dtype}, history as "
                          f"{type(hist).__name__}): one launch, bitwise")
                    got = ei_ops._ei_update(u, hist, psi, C, elems=1)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"ei_update (k {k}, q {q}, "
                          f"{dtype}), scalar instance, differs from its "
                          "plain version")
                    n += 2
    log(f"ei_update vs plain at ({A_N}, k, {D}), k 1-2, q 0-4, f32 and bf16, "
        f"history stacked and as rows, the 16-byte and the scalar instance: "
        f"{n} calls bitwise (tol: bitwise)")


def ei_rows(k: int, q: int, gen, dev):
    """Path A's inputs to one ei_update at (A_N, k, D): u, q history rows
    allocated one by one as the sampler's evals leave them, psi, C."""
    D = int(np.prod(DATA))
    u = torch.randn(A_N, k, D, generator=gen, device=dev)
    rows = [torch.randn(A_N, k, D, generator=gen, device=dev)
            for _ in range(q)]
    hgen = torch.Generator().manual_seed(100 * k + q)
    return u, rows, torch.randn(k, k, generator=hgen), \
        torch.randn(q, k, k, generator=hgen)


def ei_q_sweep(k: int, gen, dev) -> dict:
    """Median launch of the ei_update kernel at (A_N, k, D), f32, on rows,
    at q 1-4."""
    from repro_torch.kernels.ei_update import ops as ei_ops
    q_sweep = {}
    for q in range(1, ei_ops.MAX_Q + 1):
        u, rows, psi, C = ei_rows(k, q, gen, dev)
        q_sweep[q] = time_ms(lambda: ei_ops.ei_update(u, rows, psi, C),
                             kernel="ei_update_kernel")[0]
    return q_sweep


def update_call(spec, net, gen, dev, q: int = 2):
    """One `core.gddim._update` call as path A makes it on config `spec`
    with score net `net`: the state (A_N, *state) and q eps rows as the
    sampler's eps_fn returns them (the net at q grid times), host
    coefficients."""
    from repro_torch.core import gddim, time_grid
    sde = spec.sde
    shape = (A_N,) + tuple(sde.state_shape(DATA))
    k = sde.packed_k
    u = torch.randn(shape, generator=gen, device=dev)
    eps_fn = spec.make_eps_fn(net, time_grid(sde, A_RUNS[0]["nfe"]))
    with torch.no_grad():
        eps = [eps_fn(u, i) for i in range(1, q + 1)]
    hgen = torch.Generator().manual_seed(q)
    psi, C = torch.randn(k, k, generator=hgen), \
        torch.randn(q, k, k, generator=hgen)
    return lambda: gddim._update(sde, u, eps, psi, C)


def ei_records(path_a, b_counts, gen, dev, floor):
    """ei_update at path A's shapes (n = A_N, k 1 and 2, q 0-4, f32 and
    bf16, every instance, the history stacked and as rows) and
    apply_factored at path B's (B = BATCH, k 1 and 2) against their plain
    versions (bitwise: the same unfused products and left-to-right sums),
    then timed beside their bounds and a library call: one einsum over the
    pre-stacked [u; eps] and [psi; C] for ei_update (timed on rows, as path
    A calls it), `torch.bmm(blk, z) * diag` (two calls) for apply_factored;
    the records of both carry the launch floor (`floor`, ms), ei_update's
    its q sweep and one traced `core.gddim._update` call on the net's eps
    rows (device events, which must be 1, and device ms).  bdm_ei_update is
    timed again at path A's shape, with its cluster sweep and floors."""
    from repro_torch.kernels.dct2 import ops as dct_ops
    from repro_torch.kernels.dct2 import ref as dct_ref
    from repro_torch.kernels.ei_update import ops as ei_ops
    from repro_torch.kernels.ei_update import ref as ei_ref
    D = int(np.prod(DATA))
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    ei_q_check(gen, dev)
    af = {}
    for k in (1, 2):
        blk, diag, z = rnd(BATCH, k, k), rnd(BATCH, D), rnd(BATCH, k, D)
        got = ei_ops.apply_factored(blk, diag, z)
        want = ei_ref.apply_factored_ref(blk, diag, z)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"apply_factored (k {k}) differs from "
              "its plain version")
        af[k] = (blk, diag, z, max_err(got, want))
    log(f"apply_factored vs plain at ({BATCH}, k, {D}), k 1-2: bitwise "
        "(tol: bitwise)")

    src = "src/repro_torch/csrc/ei_update.cu"
    records = []
    q = 2
    for name, k in (("cifar10-ddpm", 1), ("cifar10-cld", 2)):
        u, rows, psi, C = ei_rows(k, q, gen, dev)
        stacked = torch.stack([u] + rows)
        coef = torch.cat([psi[None], C]).to(dev)
        err = max_err(ei_ops.ei_update(u, rows, psi, C),
                      ei_ref.ei_update_ref(u, rows, psi, C))
        check(err == 0.0, f"ei_update (k {k}, q {q}) differs from its plain "
              "version on the timed inputs")
        records.append(timed_record(
            f"ei_update[k={k}]", f"{name} (path A)", src,
            "src/repro/kernels/ei_update/kernel.py:96",
            sum(r["counts"].get("ei_update", 0) for r in path_a[name][2]),
            err, lambda: ei_ops.ei_update(u, rows, psi, C),
            "ei_update_kernel",
            lambda: ei_ref.ei_update_ref(u, rows, psi, C),
            4 * (q + 2) * u.numel(), 2 * u.numel() * k * (q + 1), F32_FLOPS,
            library_fn=lambda: torch.einsum("jck,jbkd->bcd", coef,
                                            stacked)))
        q_sweep = ei_q_sweep(k, gen, dev)
        spec, net = path_a[name][:2]
        n_ev, call_ms, events = call_trace(update_call(spec, net, gen, dev,
                                                       q))
        names = sorted({e.name[:60] for e in events})
        log(f"  ei_update[k={k}]: median launch by q (1-4) {q_sweep}; "
            f"launch floor {floor:.5f} ms; one core.gddim._update call on "
            f"{name}'s eps rows: {n_ev} device events, {call_ms} ms of "
            f"device time; {names}")
        check(n_ev == 1, f"[{name}] a core.gddim._update call runs {n_ev} "
              "device kernels (want 1)")
        records[-1].update(
            launches_per_run=[r["counts"].get("ei_update", 0)
                              for r in path_a[name][2]],
            q_sweep_ms=q_sweep, launch_floor_ms=floor, call_events=n_ev,
            call_ms=call_ms)
    for name, k in (("cifar10-cld", 2), ("cifar10-bdm", 1)):
        blk, diag, z, err = af[k]
        records.append(timed_record(
            f"apply_factored[k={k}]", f"{name} (path B)", src,
            "src/repro/kernels/ei_update/kernel.py:56",
            b_counts[name].get("apply_factored", 0), err,
            lambda: ei_ops.apply_factored(blk, diag, z),
            "apply_factored_kernel",
            lambda: ei_ref.apply_factored_ref(blk, diag, z),
            4 * (2 * z.numel() + diag.numel() + blk.numel()),
            BATCH * D * (2 * k * k + k * (k - 1)), F32_FLOPS,
            library_fn=lambda: torch.bmm(blk, z) * diag[:, None]))
        records[-1].update(library_calls=2, launch_floor_ms=floor)
        log(f"  apply_factored[k={k}] at {records[-1]['ms'] / floor:.3f}x "
            f"the launch floor ({floor:.5f} ms; aim: within 1.15x)")

    # bdm_ei_update at path A's shape: (A_N, 32, 32, 3), q = 2
    H, W, Ch = DATA
    bdm_q_check((A_N, H, W, Ch), gen, dev)
    u, eps = rnd(A_N, H, W, Ch), rnd(q, A_N, H, W, Ch)
    psi, C = torch.rand(H, W, 1, generator=gen, device=dev), rnd(q, H, W, 1)
    got = dct_ops.bdm_ei_update(u, eps, psi, C)
    want = dct_ref.bdm_ei_update_ref(u, eps, psi, C)
    torch.cuda.synchronize()
    err = max_err(got, want)
    oscale = float(want.abs().max())
    log(f"bdm_ei_update (n {A_N}, q {q}) vs plain: max abs err {err:.3e} at "
        f"max|out| {oscale:.3e} (tol 1e-6 of max|out|)")
    check(err <= 1e-6 * oscale, "bdm_ei_update beyond tolerance at path A's "
          "shape")
    a_runs = path_a["cifar10-bdm"][2]
    records.append(bdm_record(timed_record(
        f"bdm_ei_update[n={A_N}]", "cifar10-bdm (path A)",
        "src/repro_torch/csrc/dct2.cu", "src/repro/kernels/dct2/kernel.py:53",
        sum(r["counts"].get("bdm_ei_update", 0) for r in a_runs), err,
        lambda: dct_ops.bdm_ei_update(u, eps, psi, C), "bdm_ei_update_kernel",
        lambda: dct_ref.bdm_ei_update_ref(u, eps, psi, C),
        4 * ((q + 2) * u.numel() + psi.numel() + C.numel()),
        A_N * Ch * ((q + 2) * fast_dct2_ops(H, W) + (2 * q + 1) * H * W),
        F32_FLOPS), u, eps, psi, C, floor))
    records[-1]["launches_per_run"] = [
        r["counts"].get("bdm_ei_update", 0) for r in a_runs]
    return records


def quality_check(cld_sde, dev):
    """Sampling quality with no trained weights: CLD on the exact score of
    examples/quickstart.py's four-mode 2-D mixture, QUALITY_N samples on the
    card.  gDDIM (q = 2, NFE 10) must put 15-35% of the samples in each
    mode (nearest centre) with each mode's mean within 0.1 of its centre;
    the sliced W2 of gDDIM and of Euler-Maruyama at NFE 10 against samples
    of the mixture is printed."""
    from repro_torch import random as prng
    from repro_torch.core import (build_sampler_coeffs, sample_em,
                                  sample_gddim, time_grid)
    from repro_torch.kernels import cuda as kc
    from repro_torch.sde import ExactScore, GaussianMixture
    ang = np.linspace(0, 2 * np.pi, 4, endpoint=False)
    centres = np.stack([2.5 * np.cos(ang), 2.5 * np.sin(ang)], -1)
    mix = GaussianMixture(centres, np.full(4, 0.08), np.ones(4))
    ts = time_grid(cld_sde, 10)
    co = build_sampler_coeffs(cld_sde, ts, q=2)
    eps_fn, _ = ExactScore(cld_sde, mix).eps_fn_for_grid(ts)
    k_prior, k_em, k_data = prng.split(prng.PRNGKey(11, dev), 3)
    u_T = cld_sde.prior_sample(k_prior, QUALITY_N, (2,))
    kc.reset_launches()
    x = cld_sde.project_data(sample_gddim(cld_sde, co, eps_fn, u_T, q=2))
    torch.cuda.synchronize()
    check(kc.launches().get("ei_update", 0) == 10, "quality: gDDIM did not "
          "run one ei_update launch per step")
    x_em = cld_sde.project_data(sample_em(cld_sde, co, eps_fn, u_T, k_em,
                                          lam=1.0))
    truth = mix.sample(k_data, 2 * QUALITY_N).cpu().numpy()
    truth, floor_draw = truth[:QUALITY_N], truth[QUALITY_N:]
    x, x_em = x.cpu().numpy(), x_em.cpu().numpy()
    check(bool(np.isfinite(x).all()), "quality: gDDIM samples not finite")
    def modes(y):
        """Each mode's share of y (nearest centre), its mean's distance
        from the centre and the spread within it (the data's is 0.08)."""
        m = np.argmin(((y[:, None] - centres[None]) ** 2).sum(-1), axis=1)
        share = np.bincount(m, minlength=4) / len(y)
        dist = [float(np.linalg.norm(y[m == i].mean(0) - centres[i]))
                if np.any(m == i) else float("inf") for i in range(4)]
        spread = float(np.mean([y[m == i].std(0).mean() for i in range(4)
                                if np.any(m == i)]))
        return share, dist, spread

    share, dist, spread = modes(x)
    share_em, dist_em, spread_em = modes(x_em)
    w2, w2_em = sliced_w2(x, truth), sliced_w2(x_em, truth)
    log(f"quality (CLD, exact score, four modes, {QUALITY_N} samples, NFE "
        f"10): gDDIM q=2 mode shares {np.round(share, 4).tolist()} (15-35%), "
        f"|mean - centre| {np.round(dist, 4).tolist()} (<= 0.1), spread "
        f"within a mode {spread:.4f} (data 0.08); Euler-Maruyama shares "
        f"{np.round(share_em, 4).tolist()}, |mean - centre| max "
        f"{max(dist_em):.4f}, spread {spread_em:.4f}; sliced W2 gDDIM "
        f"{w2:.4f}, Euler-Maruyama {w2_em:.4f}, two draws of the mixture "
        f"itself {sliced_w2(floor_draw, truth):.4f} (the metric's floor at "
        f"this size: a share off by a percent moves mass between modes 3.5 "
        f"apart)")
    check(bool(np.all((share >= 0.15) & (share <= 0.35))),
          f"quality: mode shares {share.tolist()} outside 15-35%")
    check(max(dist) <= 0.1, f"quality: a mode's mean is {max(dist):.3f} from "
          "its centre")


def reduced_sample_check(name: str, sde=None) -> None:
    """Path A on the reduced config: the card (kernels) against the CPU
    (plain versions), same seeded weights and key, within 1e-3 of the
    sample scale, for a corrector run and a stochastic run."""
    from repro_torch import random as prng
    for run in (dict(nfe=5, q=2, corrector=True), dict(nfe=5, lam=0.5)):
        outs = {}
        for d in ("cuda", "cpu"):
            spec, net = make_sampler(name, d, reduced=True, seed=5, sde=sde)
            outs[d] = spec.sample(net, prng.PRNGKey(50, d), 4, device=d,
                                  **run).cpu().numpy()
        rel = float(np.abs(outs["cuda"] - outs["cpu"]).max()
                    / np.abs(outs["cpu"]).max())
        log(f"reduced {name} path A {run_name(run)}, card (kernels) vs CPU "
            f"(plain): max abs err / max|sample| = {rel:.3e} (tol 1e-3)")
        check(rel <= 1e-3, f"reduced {name} path A {run_name(run)}: card "
              "disagrees with the CPU")


def lm_requests(vocab: int, seed0: int, n: int = N_REQUESTS, lens=None,
                max_new=None, frames=None):
    """n token requests (seeds 0..n-1) with prompts of random ids drawn
    from numpy seed `seed0`, lengths cycling through `lens` (default
    LM_LENS), max_new tokens each (default LM_MAX_NEW).  With `frames`
    (frontend_ctx, d_model) each request also carries standard-normal
    frames, drawn before its prompt from the same stream, as the serving
    CLI draws an encoder-decoder's."""
    from repro_torch.serve import ServeRequest
    lens = LM_LENS if lens is None else lens
    max_new = LM_MAX_NEW if max_new is None else max_new
    rng = np.random.default_rng(seed0)
    out = []
    for i in range(n):
        fr = None if frames is None else \
            rng.standard_normal(frames).astype(np.float32)
        out.append(ServeRequest(
            rid=i, workload="token", seed=i, max_new=max_new, frames=fr,
            tokens=rng.integers(2, vocab, size=lens[i % len(lens)])
            .astype(np.int32)))
    return out


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


def decode_cluster_sweep(q, k, v, cl, window):
    """The decode kernel's median launch time at 4, 8 and 16 blocks per
    cluster on the path's inputs, each within 2 bf16 ulp of the wrapper's
    output (the split of the band changes only the order of the sums).
    The entry point is called directly, outside the wrapper and its launch
    count, to show what the wrapper's choice costs against its
    neighbours."""
    import ctypes
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels.decode_attention import ops as dec_ops
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    fn = kc.function("decode_attention", "repro_decode_attention",
                     dec_ops._ARGS)
    want = dec_ops.decode_attention(q, k, v, cl, window=window)
    out = torch.empty_like(q)
    sweep = {}
    for nb in (4, 8, 16):
        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
                    out.data_ptr(), B, S, Hkv, Hq // Hkv, Dh, window or 0,
                    1, ctypes.c_float(1.0 / math.sqrt(Dh)), nb,
                    kc.stream_ptr(q))
            kc.check("decode_attention", rc, f"decode_attention nb {nb}")
        call()
        torch.cuda.synchronize()
        check(ulp_err(out, want) <= 2,
              f"decode_attention at {nb} blocks per cluster disagrees")
        sweep[nb] = time_ms(call, kernel="decode_attention_kernel")[0]
    return sweep


def lm_kernel(Dh: int) -> str:
    """The name of the general form's bf16 kernel at head width Dh: the
    mma.sync tile at 16, 32 and 80, the wgmma one at 64, 128 and 256."""
    return f"flash_lm_{'mma' if Dh in (16, 32, 80) else 'wgmma'}_kernel<{Dh}"


def lm_records(cfg, counts, gen, dev, *, path=LM_ARCH, prompts=LM_LENS,
               max_len=LM_MAX_LEN, windows=(512, None), tag=None, wave=1):
    """decode_attention and the causal flash_attention at a token path's
    shapes (bf16; `cfg`'s heads, each window of `windows`; the prefill of
    a `wave` of the longer prompt), each against its plain version (at
    most 2 bf16 ulp; f32 inputs within 1e-5 / 2e-5) and timed beside it,
    its bound and SDPA with the same boolean mask.  The records of another
    arch than gemma3-1b carry its name as `tag`."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    Hq, Hkv, Dh, S = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, max_len
    rep = Hq // Hkv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    bf = torch.bfloat16
    records = []

    def named(kernel, window):
        if tag is not None:
            return (f"{kernel}[{tag}]" if kernel == "decode_attention"
                    else f"{kernel}[causal,{tag}]")
        if kernel == "decode_attention":
            return kernel + ("[global]" if window is None else "")
        return kernel + ("[causal,global]" if window is None
                         else "[causal,window]")

    # decode: the rows mid-serve, 24 tokens past the prompts
    lens = [prompts[b % 2] + 24 for b in range(BATCH)]
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q32, k32, v32 = rnd(BATCH, Hq, Dh), rnd(BATCH, S, Hkv, Dh), \
        rnd(BATCH, S, Hkv, Dh)
    q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
    for window in windows:
        got = dec_ops.decode_attention(q, k, v, cl, window=window)
        want = decode_attention_ref(q, k, v, cl, window=window)
        got32 = dec_ops.decode_attention(q32, k32, v32, cl, window=window)
        want32 = decode_attention_ref(q32, k32, v32, cl, window=window)
        torch.cuda.synchronize()
        ulp, err32 = ulp_err(got, want), max_err(got32, want32)
        log(f"[{path}] decode_attention (window {window}) vs plain: bf16 "
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
        sweep = decode_cluster_sweep(q, k, v, cl, window)
        log(f"  decode_attention by blocks per cluster (median launch, ms; "
            f"the wrapper takes {dec_ops.cluster_blocks(S)}): {sweep}")
        rec = timed_record(
            named("decode_attention", window),
            path, "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:93",
            counts.get("decode_attention", 0), max_err(got, want),
            lambda: dec_ops.decode_attention(q, k, v, cl, window=window),
            "decode_attention_kernel",
            lambda: decode_attention_ref(q, k, v, cl, window=window),
            nbytes, ops, BF16_FLOPS,
            library_fn=lambda: sdpa(qh, kh, vh, attn_mask=mask))
        rec.update(cluster_sweep_ms=sweep)
        records.append(rec)

    # prefill: `wave` rows of the longer prompt into the cache (the
    # alternating prompt lengths make waves of one length)
    L = prompts[1]
    q32, k32, v32 = (rnd(wave, L, Hq, Dh), rnd(wave, S, Hkv, Dh),
                     rnd(wave, S, Hkv, Dh))
    q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
    for window in windows:
        kw = dict(causal=True, window=window, q_offset=0)
        got = attn_ops.attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        got32 = attn_ops.attention(q32, k32, v32, **kw)
        want32 = attention_ref(q32, k32, v32, **kw)
        torch.cuda.synchronize()
        ulp, err32 = ulp_err(got, want), max_err(got32, want32)
        log(f"[{path}] flash_attention causal (window {window}) vs plain: "
            f"bf16 max {ulp:.1f} bf16 ulp (tol 2), max abs err "
            f"{max_err(got, want):.3e}; f32 {err32:.3e} (tol 2e-5)")
        check(ulp <= 2 and err32 <= 2e-5,
              f"causal flash_attention (window {window}) beyond tolerance")
        pairs = causal_pairs(L, S, window)
        # q and o, and the keys/values up to the last query (the causal
        # mask hides the rest of the cache)
        nbytes = 2 * (2 * q.numel() + 2 * wave * L * Hkv * Dh)
        ops = 4 * wave * pairs * Hq * Dh
        qp = torch.arange(L, device=dev)[:, None]
        kp = torch.arange(S, device=dev)[None]
        keep = kp <= qp
        if window is not None:
            keep &= kp > qp - window
        qh = q.transpose(1, 2).contiguous()
        kh = k.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        vh = v.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        records.append(timed_record(
            named("flash_attention", window),
            path, "src/repro_torch/csrc/attention.cu",
            "src/repro/kernels/attention/kernel.py:109",
            counts.get("flash_attention", 0), max_err(got, want),
            lambda: attn_ops.attention(q, k, v, **kw), lm_kernel(Dh),
            lambda: attention_ref(q, k, v, **kw), nbytes, ops, BF16_FLOPS,
            library_fn=lambda: sdpa(qh, kh, vh, attn_mask=keep)))
    return records


def lm_model_check(arch, params, dev, *, name=LM_ARCH, prompt=LM_LENS[1],
                   max_len=LM_MAX_LEN):
    """`arch` at full width, bf16: the last prompt position's logits and
    one per-slot decode step with the kernels against the same model with
    the plain attention versions (tol 5e-2 of max |logits|: bf16 rounding
    through every layer)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        2, arch.cfg.vocab, size=(2, prompt))).to(dev)
    pos = torch.tensor([prompt, prompt - 3], dtype=torch.int32, device=dev)

    def run():
        logits, caches = arch.prefill(params, {"tokens": toks}, max_len)
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
        log(f"[{name}] bf16 {what} logits, kernels vs plain attention: "
            f"max abs err / max|logits| = {err:.3e} (tol 5e-2), max|logits| "
            f"{scale:.3e}")
        check(math.isfinite(scale) and err <= 5e-2,
              f"{name}: {what} logits beyond tolerance")


def reduced_lm_check(name: str = LM_ARCH, prompt: int = 20,
                     max_len: int = 32):
    """The reduced config of `name` (f32) with the same seeded weights on
    the card (kernels) and on the CPU (plain versions): prefill and
    per-slot decode logits within 1e-4 of max |logits|, and a TokenEngine
    serve (batch 3, prompts of `prompt` and 9 tokens; gemma3-1b's 20
    against its reduced window of 16) giving equal token streams."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import Arch
    from repro_torch.serve import TokenEngine
    arch = Arch(get_arch(name, reduced=True))
    toks = np.random.default_rng(4).integers(2, arch.cfg.vocab,
                                             size=(2, prompt))
    logits, streams = {}, {}
    for d in ("cuda", "cpu"):
        eng = TokenEngine(arch, arch.init(seed=5, device="cpu"), batch_size=3,
                          max_len=max_len, device=d)
        t = torch.from_numpy(toks).to(d)
        lg, caches = arch.prefill(eng.params, {"tokens": t}, max_len)
        pos = torch.tensor([prompt, prompt - 6], dtype=torch.int32, device=d)
        out = [lg]
        for _ in range(3):
            lg, caches = arch.decode(eng.params, torch.argmax(
                out[0], -1)[:, None].to(torch.int32), caches, pos)
            out.append(lg)
            pos = pos + 1
        logits[d] = [x.float().cpu() for x in out]
        streams[d] = eng.serve(lm_requests(arch.cfg.vocab, 50, n=7,
                                           lens=(prompt, 9), max_new=8))
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(logits["cuda"], logits["cpu"]))
    same = all(np.array_equal(streams["cuda"][r], streams["cpu"][r])
               for r in streams["cpu"])
    log(f"reduced {name}, card (kernels) vs CPU (plain): logits max abs "
        f"err / max|logits| = {rel:.3e} (tol 1e-4); token streams of "
        f"{len(streams['cpu'])} requests equal: {same}")
    check(rel <= 1e-4, f"reduced {name}: logits on the card disagree")
    check(same and sorted(streams["cuda"]) == list(range(7)),
          f"reduced {name}: token streams on the card differ from the CPU")


# ---- train + likelihood: the diffusion training path at full width -----------
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE, TRAIN_WARM, TRAIN_LR = 32, 40, 20, 5, 3e-4
NLL_BATCH, NLL_STEPS = 4, 20


def attention_grad_check(cfg, gen, dev):
    """The DiT attention at the training shape (TRAIN_BATCH, 256, 12, 64)
    bf16: the autograd Function's output (the forward kernel) and its
    gradient (the plain backward `attention_bwd_ref` from the saved q, k,
    v, which recomputes P and so never reads the kernel's output) against
    torch autograd through the plain version in f32 on the same values.
    Tolerance: 2 bf16 ulp of the output and of each gradient at max(|g|,
    max|g| / 1024) (each computes in f32 and rounds once).  Times (device
    ms): the forward kernel, the
    plain backward, the Function's forward + backward, and autograd
    through the plain version (forward + backward, f32).  Returns the bf16
    (q, k, v) and the forward's max abs err against the plain forward."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                                   attention_ref)
    H, S, Dh = cfg.n_heads, cfg.n_tokens, cfg.d_head
    rnd = lambda: torch.randn(TRAIN_BATCH, S, H, Dh, generator=gen,
                              device=dev).to(torch.bfloat16)
    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attn_ops.attention(*leaves, causal=False)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = attention_ref(*ref_leaves, causal=False)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    torch.cuda.synchronize()
    err_fwd = max_err(out.detach(), ref_out.detach())
    ulp_fwd = ulp_err(out.detach(), ref_out.detach().to(torch.bfloat16))
    log(f"[train] attention output at {tuple(q.shape)} bf16, the forward "
        f"kernel vs the plain version in f32: max {ulp_fwd:.2f} bf16 ulp "
        f"(tol 2), max abs err {err_fwd:.3e} at max|o| "
        f"{float(ref_out.detach().abs().max()):.3e}")
    check(bool(torch.isfinite(out).all()) and ulp_fwd <= 2,
          "[train] flash_attention beyond tolerance at the training shape")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        ulps, scale = ulp_err(a, b.to(torch.bfloat16)), float(b.abs().max())
        log(f"[train] attention gradient {name} at {tuple(q.shape)} bf16, "
            f"Function vs autograd of the plain version in f32: max "
            f"{ulps:.2f} bf16 ulp (tol 2), max abs err / max|g| "
            f"{max_err(a, b) / scale:.3e}, max|g| {scale:.3e}")
        check(bool(torch.isfinite(a).all()) and ulps <= 2,
              f"[train] attention gradient {name} beyond tolerance")
    fwd_ms = time_ms(lambda: attn_ops.flash_attention(q, k, v),
                     kernel="flash_dit_wgmma_kernel<64")[0]
    bwd_ms = time_ms(lambda: attention_bwd_ref(q, k, v, do), 20)[0]
    fn_ms = time_ms(lambda: torch.autograd.grad(
        attn_ops.attention(*leaves, causal=False), leaves, do), 20)[0]
    plain_ms = time_ms(lambda: torch.autograd.grad(
        attention_ref(*ref_leaves, causal=False), ref_leaves, do.float()),
        20)[0]
    log(f"[train] attention at {tuple(q.shape)}: forward kernel {fwd_ms:.5f}"
        f" ms; plain backward {bwd_ms:.5f} ms; Function forward + backward "
        f"{fn_ms:.5f} ms; autograd through the plain version (f32) forward "
        f"+ backward {plain_ms:.5f} ms (device ms)")
    return q, k, v, err_fwd


def max_param_diff(a, b) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def train_args(spec, **kw) -> argparse.Namespace:
    """`launch.train`'s command line for the phase's runs of `spec`."""
    return argparse.Namespace(**{**dict(
        diffusion=spec.name, reduced=False, steps=TRAIN_STEPS,
        batch=TRAIN_BATCH, lr=TRAIN_LR, seed=SEED, ckpt_dir=None,
        ckpt_every=0, resume=False, log_every=0, device="cuda"), **kw})


class StepClock:
    """A trainer's `on_step` that times its steps: it synchronizes the card
    and stamps each call (the start, then after every step), keeps the
    step metrics and the memory resident at the start, and traces the
    last of `traced` steps where given."""

    def __init__(self, traced: int | None = None):
        self.clock, self.metrics, self.resident = [], [], []
        self.traced = traced
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def __call__(self, step, model, opt_state, m) -> None:
        torch.cuda.synchronize()
        self.clock.append(time.perf_counter())
        if m is None:
            self.resident.append(torch.cuda.memory_allocated() / 2 ** 30)
        else:
            self.metrics.append(m)
        if self.traced is not None and step == self.traced - 1:
            self.prof.start()
        elif self.traced is not None and step == self.traced:
            self.prof.stop()

    def step_seconds(self, warm: int) -> np.ndarray:
        """Wall seconds of the steps from `warm` on, the traced one left
        out."""
        durs = np.diff(self.clock)                  # step i: durs[i]
        return durs[warm:len(durs) - (self.traced is not None)]

    def traced_step(self, top_path: Path):
        """(wall s, device busy s, device events) of the traced step; its
        kernels' device time by name, largest first, into `top_path`."""
        events = kernel_events(self.prof)
        top = {}
        for e in events:
            top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
        top_path.write_text("".join(
            f"{us:.1f}\t{name}\n" for name, us in sorted(
                top.items(), key=lambda kv: -kv[1])))
        return (float(np.diff(self.clock)[-1]), sum(top.values()) / 1e6,
                len(events))


def train_phase(spec, dev, card, gen):
    """Diffusion training at full width (`spec`: cifar10-cld, DiT 24 x 768,
    bf16, remat on) through the entry point `train_diffusion`, random
    weights from SEED: TRAIN_STEPS steps at batch TRAIN_BATCH (AdamW lr
    3e-4, warmup 5, no weight decay; the seeded mixture pipeline), each
    timed by its `on_step` call with the card synchronized; the same run
    preempted at TRAIN_SAVE with its checkpoint, then resumed to the end
    against the uninterrupted run; the same steps on the reduced config
    card vs CPU; the likelihood (VPSDE exact score against the closed
    form, the CLD NLL bound through the trained DiT); samples from the
    trained net and the hand-off witness.  Returns the kernels-line record
    of the training shape's flash_attention."""
    import shutil
    from repro_torch import random as prng
    from repro_torch.kernels import cuda as kc
    from repro_torch.launch.train import diffusion_pipeline, train_diffusion
    t_phase = time.perf_counter()
    q, k, v, err_fwd = attention_grad_check(spec.score_cfg, gen, dev)
    pipe = diffusion_pipeline(spec, TRAIN_BATCH, SEED)
    spec.tables_on(dev)                          # Stage I, before the clock

    watch = StepClock(traced=TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    run = train_diffusion(train_args(spec), spec=spec, on_step=watch)
    counts = kc.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    net = run["net"]
    n_params = sum(p.numel() for p in net.parameters())
    n_layers = spec.score_cfg.n_layers
    flash_train = counts.get("flash_attention", 0)
    losses = [float(m["loss"]) for m in watch.metrics]
    gnorms = [float(m["grad_norm"]) for m in watch.metrics]
    log(f"[train] train_diffusion, cifar10-cld full width ({n_params} "
        f"params, bf16, remat {spec.score_cfg.remat}), batch {TRAIN_BATCH}, "
        f"{len(losses)} steps: launches {counts} ({2 * n_layers} "
        f"flash_attention a step expected: forward and remat recompute per "
        f"layer)")
    check(run["step"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses + gnorms),
          "[train] a loss or grad norm is not finite, or steps are missing")
    check(flash_train == 2 * n_layers * TRAIN_STEPS,
          f"[train] {flash_train} flash_attention launches, expected "
          f"{2 * n_layers * TRAIN_STEPS}")
    timed = watch.step_seconds(TRAIN_WARM)
    wall, busy, n_events = watch.traced_step(ROOT / "chiprun_out"
                                             / "train_profile.txt")
    log(f"[train] loss {losses[0]:.5f} -> {losses[-1]:.5f} (every 5th: "
        f"{[round(x, 5) for x in losses[::5]]}); grad norm {gnorms[0]:.4f} "
        f"-> {gnorms[-1]:.4f}; {TRAIN_BATCH * len(timed) / sum(timed):.3f} "
        f"samples/s over steps {TRAIN_WARM}-{TRAIN_STEPS - 2} (median step "
        f"{1e3 * float(np.median(timed)):.3f} ms); one traced step: wall "
        f"{1e3 * wall:.3f} ms, device busy {1e3 * busy:.3f} ms "
        f"({100 * busy / wall:.1f}% busy, {100 - 100 * busy / wall:.1f}% "
        f"idle), {n_events} device events; peak memory {peak:.3f} GiB "
        f"allocated ({watch.resident[0]:.3f} GiB at step 0, the earlier "
        f"phases' nets and the fresh train state included) ({card})")

    # ---- preempted at TRAIN_SAVE, resumed to the end ------------------------
    ckdir = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    cut = train_diffusion(
        train_args(spec, ckpt_dir=str(ckdir), ckpt_every=TRAIN_SAVE),
        spec=spec, on_step=lambda step, *_: step >= TRAIN_SAVE)
    t_cut = time.perf_counter() - t0
    check(cut["step"] == TRAIN_SAVE, f"[train] the preempted run stopped at "
          f"step {cut['step']}")
    size = sum(f.stat().st_size for f in ckdir.rglob("*.npz")) / 2 ** 30
    restored, resumed_m = {}, []

    def first(step, net_r, st, m):
        if m is not None:
            resumed_m.append(m)
            return
        torch.cuda.synchronize()
        restored.update(step=step, opt_step=int(st.step),
                        t=time.perf_counter(), same=all(
                            a.dtype == torch.bfloat16 and torch.equal(
                                a.detach().view(torch.int16),
                                b.detach().view(torch.int16))
                            for a, b in zip(net_r.parameters(),
                                            cut["net"].parameters())))

    t0 = time.perf_counter()
    res = train_diffusion(train_args(spec, ckpt_dir=str(ckdir), resume=True),
                          spec=spec, on_step=first)
    t_res = time.perf_counter() - t0
    check(restored.get("step") == TRAIN_SAVE
          and restored["opt_step"] == TRAIN_SAVE, f"[train] resumed at step "
          f"{restored.get('step')}, optimizer step {restored.get('opt_step')}")
    check(restored["same"], f"[train] the step-{TRAIN_SAVE} checkpoint's "
          "bf16 leaves did not restore byte for byte")
    losses_b = [float(m["loss"]) for m in resumed_m]
    diff = max_param_diff(net, res["net"])
    log(f"[train] preempted at step {TRAIN_SAVE} ({t_cut:.2f}s, its "
        f"checkpoint {size:.3f} GiB written async and joined), resumed "
        f"(fresh net, restore: {restored['t'] - t0:.2f}s to the first step) "
        f"to step {res['step']} ({t_res:.2f}s, the end's checkpoint "
        f"included); bf16 leaves restored byte for byte; resumed run's last "
        f"loss {losses_b[-1]:.6f} vs {losses[-1]:.6f}, max |params - "
        f"uninterrupted| {diff:.3e}")
    if diff == 0.0 and losses_b == losses[TRAIN_SAVE:]:
        log("[train] resume: bitwise equal to the uninterrupted run")
    else:
        again = train_diffusion(train_args(spec), spec=spec)["net"]
        spread = max_param_diff(net, again)
        log(f"[train] resume not bitwise: two uninterrupted runs differ by "
            f"{spread:.3e} (the card's run-to-run spread), the resumed run "
            f"by {diff:.3e}")
        check(diff <= spread, "[train] the resumed run differs from the "
              "uninterrupted one by more than two uninterrupted runs do")
        del again
    shutil.rmtree(ckdir, ignore_errors=True)
    del cut, res

    reduced_train_check(spec)
    likelihood_checks(spec, net, pipe, dev, card)
    kc.reset_launches()
    x = spec.sample(net, prng.PRNGKey(SEED + 7, dev), A_N, 10, q=2,
                    device=dev)
    torch.cuda.synchronize()
    s_counts = kc.launches()
    check(tuple(x.shape) == (A_N,) + DATA and bool(torch.isfinite(x).all()),
          "[train] samples from the trained net are not finite or well "
          "formed")
    check(s_counts.get("ei_update", 0) == 10 and s_counts.get(
        "flash_attention", 0) == 10 * n_layers, f"[train] sampling from the "
          f"trained net launched {s_counts}")
    log(f"[train] {A_N} samples from the trained net (nfe 10, q 2): shape "
        f"{tuple(x.shape)}, finite; launches {s_counts}")
    handoff_check(spec, net, pipe, x, losses[0], dev)
    log(f"[train] phase {time.perf_counter() - t_phase:.2f}s")
    return attention_timed(
        "flash_attention[train]", "train (cifar10-cld, batch 32)", q, k, v,
        flash_train, err_fwd)


def zero_eps_std(sde, nfe: int) -> float:
    """The std of the data part of Psi(t_min, T) u_T, u_T ~ N(0, Sigma_T):
    what the sampler returns for eps = 0, in closed form (float64)."""
    from repro_torch.core import time_grid
    ts = time_grid(sde, nfe, "quadratic")
    psi = np.asarray(sde.Psi_np(ts[0], ts[-1]), np.float64)
    cov = psi @ np.asarray(sde.Sigma_np(ts[-1]), np.float64) @ psi.T
    return float(np.sqrt(cov[0, 0]))


@torch.no_grad()
def handoff_check(spec, net, pipe, x, first_loss, dev) -> None:
    """Whether the trained net's samples reflect the loss and the sampler
    reading eps alike, on the training data's own mixture, whose exact eps
    (`ExactScore.eps_model`, -K_t^T score) is known.  On step 0's batch
    and key: the exact eps scores the loss's floor, below the trained
    net's, the zero eps's (= the zero-init net's step-0 loss, checked to
    1e-6) and its negation's (1 + 3 E|eps*|^2).  Through
    `DiffusionSpec.sample` (A_N samples, nfe 10, q 2) the exact eps puts
    every sample within the data's mode std (0.05, rms a coordinate) of a
    mode, all four taken.  The trained samples' std is printed against
    S0, the eps = 0 level (CLD's flow run backward amplifies by Psi(t_min,
    T), entries ~5e4), and bounded by 2 S0; the trained eps's error
    against the exact one at the sampler's first time is printed."""
    from repro_torch import random as prng
    from repro_torch.sde import ExactScore, GaussianMixture
    exact = ExactScore(spec.sde, GaussianMixture(
        pipe.means, pipe.stds, pipe.weights)).eps_model()
    x0 = torch.from_numpy(pipe.batch_at(0)).to(dev)
    key = prng.fold_in(prng.PRNGKey(SEED, dev), 0)
    loss = {name: float(spec.loss(fn, x0, key)) for name, fn in (
        ("exact", exact), ("trained", net),
        ("zero", lambda u, t: torch.zeros_like(u)),
        ("negated", lambda u, t: -exact(u, t)))}
    y = spec.sample(exact, prng.PRNGKey(SEED + 7, dev), A_N, 10, q=2,
                    device=dev).cpu().numpy()
    means = np.asarray(pipe.means, np.float32).reshape(len(pipe.means), -1)
    rms = np.sqrt(((y.reshape(A_N, 1, -1) - means[None]) ** 2).mean(-1))
    u_T = spec.sde.prior_sample(prng.PRNGKey(SEED + 8, dev), A_N, DATA)
    t_T = torch.full((A_N,), float(spec.sde.T), device=dev)
    e_star = exact(u_T, t_T)
    rel = float((net(u_T, t_T).float() - e_star).norm() / e_star.norm())
    s0, std = zero_eps_std(spec.sde, 10), float(x.float().std())
    log(f"[train] hand-off on step 0's batch and key: loss of the exact eps "
        f"{loss['exact']:.5f}, the trained net {loss['trained']:.5f}, zero "
        f"{loss['zero']:.5f} (step 0's {first_loss:.5f}), the negated exact"
        f" eps {loss['negated']:.5f}; {A_N} samples of the exact eps "
        f"(nfe 10, q 2): std {float(y.std()):.5f} (data "
        f"{float(pipe.batch_at(0).std()):.5f}), rms to the nearest mode max "
        f"{float(rms.min(1).max()):.5f} (tol 0.05), modes taken "
        f"{np.bincount(rms.argmin(1), minlength=len(means)).tolist()}; the "
        f"trained net's samples: std {std:.4f} against S0 {s0:.4f} (eps = 0;"
        f" bound 2 S0), its eps at t = T off the exact one by {rel:.4f} "
        f"(relative rms)")
    check(abs(loss["zero"] - first_loss) <= 1e-6 and loss["exact"]
          < loss["trained"] < loss["zero"] < loss["negated"],
          f"[train] the loss does not rank the exact eps first: {loss}")
    check(float(rms.min(1).max()) <= 0.05 and len(set(
        rms.argmin(1).tolist())) == len(means), "[train] the exact eps's "
          "samples are off the data's modes")
    check(std <= 2 * s0, f"[train] trained samples' std {std:.1f} above "
          f"2 S0 = {2 * s0:.1f}")


def reduced_train_check(full_spec) -> None:
    """Three training steps of reduced cifar10-cld (f32, remat off) on the
    card and on the CPU from the same weights, batches and keys: losses
    within 1e-4 relative; the params within 2 lr a step everywhere (a
    gradient near 0 of another sign moves AdamW's early update by up to
    2 lr) and within 1e-6 for 99% of them."""
    from repro_torch import random as prng
    from repro_torch.configs import get_diffusion
    from repro_torch.launch import steps
    from repro_torch.launch.train import diffusion_opt_cfg, \
        diffusion_pipeline
    from repro_torch.optim.adamw import adamw_init
    spec = dataclasses.replace(get_diffusion("cifar10-cld", reduced=True),
                               sde=full_spec.sde)
    cfg = diffusion_opt_cfg(TRAIN_LR, 3)
    pipe = diffusion_pipeline(spec, 8, SEED)
    step_fn = steps.make_diffusion_train_step(spec, cfg)
    nets = {d: spec.init(seed=SEED, device=d).requires_grad_()
            for d in ("cuda", "cpu")}
    states = {d: adamw_init(n.parameters(), cfg) for d, n in nets.items()}
    rel = []
    for i in range(3):
        x0 = torch.from_numpy(pipe.batch_at(i))
        key = prng.fold_in(prng.PRNGKey(SEED), i)
        m = {d: step_fn(n, states[d], {"x0": x0.to(d)}, key.to(d))
             for d, n in nets.items()}
        lc, lp = float(m["cuda"]["loss"]), float(m["cpu"]["loss"])
        rel.append(abs(lc - lp) / abs(lp))
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().ravel()
                       for a, b in zip(nets["cuda"].parameters(),
                                       nets["cpu"].parameters())])
    frac = float((diffs > 1e-6).float().mean())
    log(f"reduced cifar10-cld training, 3 steps, card vs CPU: loss rel err "
        f"{[f'{r:.2e}' for r in rel]} (tol 1e-4); params max abs diff "
        f"{float(diffs.max()):.3e} (tol {2 * cfg.lr * 3:.1e}), share above "
        f"1e-6 {frac:.2e} (tol 1e-2)")
    check(max(rel) <= 1e-4 and float(diffs.max()) <= 2 * cfg.lr * 3
          and frac <= 1e-2, "reduced training: the card disagrees with the "
          "CPU")


def likelihood_checks(spec, net, pipe, dev, card) -> None:
    """The probability-flow likelihood on the card: the VPSDE exact-score
    NLL of a single Gaussian (exact divergence, 150 Heun steps) against its
    closed form at the JAX test's tolerance (rtol 1e-2, atol 5e-2); and the
    CLD NLL bound (App. C.8) through the trained full-width DiT, Hutchinson
    (one Rademacher probe a step, taken as (J^T eps) . eps through the
    attention backward), batch NLL_BATCH, one velocity draw, NLL_STEPS
    Heun steps, the score -K_t^{-T} eps_theta: finite, printed in bits per
    dimension of the data as given (no dequantization)."""
    from repro_torch import random as prng
    from repro_torch.core.likelihood import cld_nll_bound, log_likelihood
    from repro_torch.kernels import cuda as kc
    from repro_torch.sde import ExactScore, GaussianMixture, VPSDE
    from repro_torch.train.losses import score_fn_from_model
    vp = VPSDE()
    oracle = ExactScore(vp, GaussianMixture(np.array([[0.2, -0.4]]),
                                            np.array([0.3]), np.array([1.0])))
    x = np.array([[0.2, -0.4], [0.5, 0.0], [-0.1, -0.7]], np.float32)
    t0 = time.perf_counter()
    ll = log_likelihood(vp, oracle.score, torch.from_numpy(x).to(dev),
                        n_steps=150).cpu().numpy()
    dt = time.perf_counter() - t0
    a = vp.alpha(vp.t_min)
    var = a * 0.3 ** 2 + (1 - a)
    d = x - np.sqrt(a) * np.array([0.2, -0.4])
    ref = -0.5 * (d ** 2).sum(-1) / var - np.log(2 * np.pi * var)
    err = np.abs(ll - ref)
    log(f"[likelihood] VPSDE Gaussian, exact score, exact divergence, 150 "
        f"Heun steps on the card: log p {[round(float(y), 5) for y in ll]} "
        f"vs closed form {[round(float(y), 5) for y in ref]}, max |err| "
        f"{float(err.max()):.3e}"
        f" (tol 5e-2 + 1e-2 |ref|); {dt:.2f}s")
    check(bool(np.all(err <= 5e-2 + 1e-2 * np.abs(ref))),
          "[likelihood] VPSDE flow NLL off its closed form")
    x0 = torch.from_numpy(pipe.batch_at(10_000)[:NLL_BATCH]).to(dev)
    score = score_fn_from_model(spec.sde, lambda u, t: net(u, t), spec.kt)
    kc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bound = cld_nll_bound(spec.sde, score, x0, prng.PRNGKey(SEED + 3, dev),
                          n_v=1, n_steps=NLL_STEPS, hutchinson=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    bpd = (-bound / (x0[0].numel() * math.log(2))).cpu().numpy()
    log(f"[likelihood] CLD NLL bound through the trained DiT (Hutchinson, "
        f"batch {NLL_BATCH}, n_v 1, {NLL_STEPS} Heun steps): log p(x0) >= "
        f"{[round(float(y), 3) for y in bound.cpu()]} nats, "
        f"{[round(float(y), 5) for y in bpd]} bits/dim; {dt:.3f}s ({card}); "
        f"launches {counts}")
    check(bool(torch.isfinite(bound).all()), "[likelihood] CLD NLL bound "
          "not finite")
    check(counts.get("flash_attention", 0) > 0, "[likelihood] the bound "
          "did not run the attention kernel")


# ---- stream: online serving at full width ------------------------------------
# a three-family engine serving one seeded arrival stream: by arrival, the
# family, sampler fields and urgency of each request; NFE 10 throughout,
# the precision class cycling f32 / bf16 / int8 by request
STREAM_FAMILIES = {"vpsde": "cifar10-ddpm", "cld": "cifar10-cld",
                   "bdm": "cifar10-bdm"}
STREAM_KINDS = [
    dict(family="cld", q=2), dict(family="vpsde", q=2),
    dict(family="bdm", lam=0.5), dict(family="cld", corrector=True),
    dict(family="vpsde", lam=0.5), dict(family="bdm", q=2),
    dict(family="vpsde", q=2, priority=2),
    dict(family="cld", q=2, corrector=True),
    dict(family="bdm", priority=3), dict(family="cld", lam=0.5),
    dict(family="vpsde", corrector=True, priority=1),
    dict(family="bdm", q=2)]
STREAM_NFE, STREAM_SEED, STREAM_RATE = 10, 3, 0.8
# the token stream: prompts of distinct lengths (so every admission wave is
# one request, its prefill at width 1 as when served alone), the last an
# urgent request that arrives while the four slots are busy
TOKEN_STREAM = [(0.0, 96, 32, {}), (0.0, 97, 32, {}), (1.0, 98, 32, {}),
                (1.0, 99, 32, {}), (6.0, 100, 16,
                                    dict(priority=2, deadline=30.0))]


def stream_requests():
    """The stream's seeded Poisson trace (a new one a call: a trace is
    consumed as it is served)."""
    from repro_torch.models.quantize import PRECISIONS
    from repro_torch.serve import ServeRequest, poisson_trace

    def make(i, rng):
        kw = dict(STREAM_KINDS[i])
        if kw.get("priority"):
            kw["deadline"] = float(rng.integers(15, 30))
        return ServeRequest(rid=i, seed=500 + i, nfe=STREAM_NFE,
                            precision=PRECISIONS[i % len(PRECISIONS)], **kw)

    return poisson_trace(make, n=len(STREAM_KINDS), rate=STREAM_RATE,
                         seed=STREAM_SEED)


def dispatch_want(spec, prec: str, corr: bool) -> dict:
    """The launches one round-step dispatch of class (spec's family, prec)
    makes on the card: one DiT eval (two with the corrector), each layer's
    attention one flash launch (the f32 kernel in the int8 class, whose
    dequantized weights are f32); one commit, one predictor with the
    corrector; BDM adds its noise draw and a dct2 around every eval and on
    the noise."""
    evals = 1 + corr
    layers = spec.score_cfg.n_layers
    bdm = spec.sde.packed_k == 1 and not spec.sde.canonical_noise_is_reshape
    return {"flash_attention": layers * evals,
            "flash_attention:f32": layers * evals if prec == "int8" else 0,
            "round_fused": 1, "round_predict": int(corr),
            "step_noise": int(bdm), "dct2": (2 * evals + 1) if bdm else 0}


def instrument(engine):
    """Record every round-step dispatch of `engine` as (class,
    with_corrector, its launch counts), and fail unless each round
    dispatches exactly the (family, precision) classes of the host
    shadow's active slots, in (family) x (precision) order, each with the
    corrector if one of its slots wants it.  Returns (the dispatch log,
    a function that removes the instrumentation)."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.models.quantize import PRECISIONS
    log_, steps, round_ = [], dict(engine._steps), engine._round

    def wrap(cls, step):
        def dispatch(params, state, bank, with_corrector=False):
            before = kc.launches()
            out = step(params, state, bank, with_corrector=with_corrector)
            after = kc.launches()
            log_.append((cls, with_corrector,
                         {k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)}))
            return out
        return dispatch

    def checked_round():
        want = {}
        for s in engine.slots.active():
            cls = (s.data["family"], s.data["prec"])
            want[cls] = want.get(cls, False) or s.data["pc"]
        order = [(f, p) for f in engine.families for p in PRECISIONS
                 if (f, p) in want]
        n0 = len(log_)
        round_()
        got = [(c, corr) for c, corr, _ in log_[n0:]]
        check(got == [(c, want[c]) for c in order], "[stream] a round "
              f"dispatched {got}, the shadow's classes are {want}")

    engine._steps = {cls: wrap(cls, st) for cls, st in steps.items()}
    engine._round = checked_round

    def remove():
        engine._steps = steps
        del engine._round
    return log_, remove


def stream_kernel_records(engine, dispatches, counts, gen, dev):
    """The new modes of this path's kernels against their plain versions,
    timed: round_fused and round_predict at kf 1 in the K 2 pool with
    foreign (family, precision) rows (VPSDE with the noise drawn in the
    kernel, BDM with it streamed), dct2 on the copied kf slice of the pool,
    and flash_attention in f32 at the DiT's shape (the int8 class)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.dct2 import ops as dct_ops
    from repro_torch.kernels.dct2 import ref as dct_ref
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    bank, st = engine._bank, engine.state
    K, Qb, D = st.u.shape[1], st.hist.shape[1], st.u.shape[2]
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    by_fam = lambda fam, key: sum(c.get(key, 0) for (f, _), _, c in
                                  dispatches if f == fam)
    src = "src/repro_torch/csrc/round_fused.cu"
    recs = []
    for fam in ("vpsde", "bdm"):
        spec = engine.specs[fam]
        sde, fi = spec.sde, engine.cache.fam_index(fam)
        streamed = not sde.canonical_noise_is_reshape
        mine = [c for c in range(len(engine.cache))
                if engine.cache.configs[c].family == fam]
        cfg = i32([mine[j % len(mine)] for j in range(BATCH)])
        kstep = i32([0, 4, 8, 9])
        kc_ = torch.minimum(kstep, bank.n_steps[cfg] - 1)
        # slot 1: another precision class of the family; slot 2: another
        # family (cld); slot 0 retired; slot 3 this variant's
        fam_ = i32([fi, fi, engine.cache.fam_index("cld"), fi])
        prec = i32([0, 2, 0, 0])
        active = torch.tensor([False, True, True, True], device=dev)
        keys = prng_keys(dev)
        u, hist = rnd(BATCH, K, D), rnd(BATCH, Qb, K, D)
        eps_c, eps_n = rnd(BATCH, 1, D), rnd(BATCH, 1, D)
        args = (u, hist, kstep, kc_, cfg, fam_, prec, keys, active, bank,
                eps_c)
        kw = dict(sde=sde, state_shape=sde.state_shape(DATA), kf=1,
                  fam_index=fi, prec_index=0, with_corrector=True,
                  eps_n_c=eps_n)
        noise_c = None
        if streamed:
            noise = rf_ref.draw_step_noise(keys, kc_, bank.alg[cfg],
                                           kw["state_shape"])
            noise_c = dct_ref.dct2_ref(noise).reshape(BATCH, 1, D)
        kw_ref = dict(kw, noise_c=noise_c) if streamed else kw
        fused = lambda: rf.round_fused(*args, eps_n, noise_c, kf=1, n=D,
                                       fam_index=fi, with_corrector=True)
        got, want = fused(), rf_ref.round_update_ref(*args, **kw_ref)
        wrap = rf.round_update(*args, **kw)
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(got[:2], want[:2]))
        err_w = max(max_err(a, b) for a, b in zip(wrap[:2], want[:2]))
        det = ~bank.stochastic[cfg]
        bitwise = torch.equal(got[0], want[0]) and torch.equal(
            got[1], want[1]) if streamed else torch.equal(got[0][det],
                                                          want[0][det])
        frozen = all(torch.equal(got[0][i], u[i]) and torch.equal(
            got[1][i], hist[i]) for i in (0, 1, 2)) and torch.equal(
            got[0][3, 1:], u[3, 1:])
        exact = torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        log(f"[stream] round_fused at kf 1 in K {K} ({fam}, "
            f"{'streamed' if streamed else 'in-kernel'} noise), foreign "
            f"rows (another precision, another family, retired) and the "
            f"padding row frozen bitwise: {frozen}; max abs err {err:.3e} "
            f"(tol 1e-5), through round_update {err_w:.3e}; "
            f"{'all' if streamed else 'deterministic'} slots bitwise: "
            f"{bitwise}; k/active exact: {exact}")
        check(frozen and exact and bitwise and max(err, err_w) <= 1e-5,
              f"[stream] round_fused at kf 1 in K {K} ({fam}) disagrees "
              "with its plain version")
        ints = rf._stage_ints(kstep, kc_, cfg, fam_, prec, active, bank,
                              fam_index=fi, prec_index=0, with_corrector=True)
        blks, dis = rf._stage_factors(bank, cfg, kc_, 1, True)
        nb, ops = fused_round_need(ints, dis, K=K, Qb=Qb, kf=1, D=D,
                                   streamed=streamed)
        recs.append(timed_record(
            f"round_fused[kf=1 in K={K},{fam}]", "stream", src,
            "src/repro/kernels/round_fused/kernel.py:293",
            by_fam(fam, "round_fused"), err, fused, "round_fused_kernel",
            lambda: rf_ref.round_update_ref(*args, **kw_ref), nb, ops,
            F32_FLOPS))
        if fam == "vpsde":
            pred = rf.round_predict(u, hist, kc_, cfg, bank, eps_c, kf=1)
            pred_ref = rf_ref.round_predict_ref(u, hist, kc_, cfg, bank,
                                                eps_c, kf=1)
            torch.cuda.synchronize()
            check(torch.equal(pred, pred_ref), "[stream] round_predict at "
                  f"kf 1 in K {K} is not bitwise its plain version")
            pblks, pdis = rf._stage_factors(bank, cfg, kc_, 1, False,
                                            predict_only=True)
            p_bytes = 4 * (BATCH * D * (1 + (Qb - 1) + 1 + 1) + pblks.numel()
                           + pdis.numel() + int(torch.unique(pdis).numel()) * D)
            p_ops = BATCH * D * ((1 + Qb) * 2 + Qb)
            recs.append(timed_record(
                f"round_predict[kf=1 in K={K}]", "stream", src,
                "src/repro/kernels/round_fused/kernel.py:362",
                by_fam("vpsde", "round_predict") + by_fam("bdm",
                                                          "round_predict"),
                max_err(pred, pred_ref),
                lambda: rf.round_predict_kernel(u, hist, kc_, cfg, bank,
                                                eps_c, kf=1),
                "round_predict_kernel",
                lambda: rf_ref.round_predict_ref(u, hist, kc_, cfg, bank,
                                                 eps_c, kf=1),
                p_bytes, p_ops, F32_FLOPS))

    # dct2 on the kf slice of the pool: the strided slice is refused, BDM's
    # contiguous copy of it (`BDM._dct2`) is transformed
    pool = rnd(BATCH, K, D)
    try:
        dct_ops.dct2(pool[:, :1].reshape(BATCH, *DATA), inverse=True)
        refused = False
    except ValueError:
        refused = True
    x = pool[:, :1].contiguous().reshape(BATCH, *DATA)
    got = dct_ops.dct2(x, inverse=True)
    want = dct_ref.idct2_ref(x)
    torch.cuda.synchronize()
    err = max_err(got, want)
    log(f"[stream] dct2 on the kf slice of the K {K} pool: the strided "
        f"slice refused: {refused}; its copy within {err:.3e} of the plain "
        f"version (tol 1e-6 of max|x| {float(x.abs().max()):.3e})")
    check(refused and err <= 1e-6 * float(x.abs().max()),
          "[stream] dct2 on the pool's kf slice")
    H, W, Ch = DATA
    ch, cw = (dct_ops.dct_matrix_f32(n, dev) for n in (H, W))
    rec = timed_record(
        f"dct2[kf slice of K={K}]", "stream", "src/repro_torch/csrc/dct2.cu",
        "src/repro/kernels/dct2/kernel.py:98", counts.get("dct2", 0), err,
        lambda: dct_ops.dct2(x, inverse=True), "dct2_kernel",
        lambda: dct_ref.idct2_ref(x), 2 * 4 * x.numel(),
        BATCH * Ch * fast_dct2_ops(H, W), F32_FLOPS,
        library_fn=lambda: torch.einsum("ih,bijc,jw->bhwc", ch, x, cw))
    rec["copy_ms"] = time_ms(lambda: pool[:, :1].contiguous())[0]
    log(f"  BDM's copy of the slice: {rec['copy_ms']:.5f} ms")
    recs.append(rec)

    # the DiT's attention in the int8 class at full width: f32 on the CUDA
    # cores; SDPA in f32 the library yardstick
    cfg_ = engine.spec.score_cfg
    n, S, Hh, Dh = BATCH, cfg_.n_tokens, cfg_.n_heads, cfg_.d_head
    q, k, v = (rnd(n, S, Hh, Dh) for _ in range(3))
    got = attn_ops.attention(q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = max_err(got, want)
    log(f"[stream] flash_attention f32 at ({n}, {S}, {Hh}, {Dh}) vs plain: "
        f"max abs err {err:.3e} (tol 2e-5), {ulp_err(got, want):.1f} ulp")
    check(err <= 2e-5, "[stream] f32 flash_attention beyond tolerance")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs.append(timed_record(
        "flash_attention[f32,int8 class]", "stream",
        "src/repro_torch/csrc/attention.cu",
        "src/repro/kernels/attention/kernel.py:109",
        counts.get("flash_attention:f32", 0), err,
        lambda: attn_ops.attention(q, k, v, causal=False), "flash_fwd_kernel",
        lambda: attention_ref(q, k, v, causal=False),
        4 * n * S * Hh * Dh * 4, 4 * n * Hh * S * S * Dh, F32_FLOPS,
        library_fn=lambda: sdpa(qh, kh, vh)))
    return recs


def prng_keys(dev):
    """Four slots' step-noise keys, as the engine derives them."""
    from repro_torch import random as prng
    return torch.stack([prng.to_int32_bits(prng.fold_in(
        prng.PRNGKey(900 + i, device=dev), 0x5EED)) for i in range(BATCH)])


def net_tolerance_check(engine, gen, dev) -> None:
    """Each family's int8-class eps within `NET_TOLERANCES["int8"]` of its
    f32 eval, at full width on the card."""
    from repro_torch.models import quantize as qtz
    tol = qtz.NET_TOLERANCES["int8"]
    for fam, spec in engine.specs.items():
        net = engine.params[fam]
        x = torch.randn(BATCH, *spec.sde.state_shape(DATA), generator=gen,
                        device=dev)
        t = torch.rand(BATCH, generator=gen, device=dev)
        with torch.no_grad():
            ref = spec.eps_model(net, x, t).float()
            lo = qtz.wrap_eps_model(spec.eps_model, "int8", net)(
                engine._params_for(fam, "int8"), x, t)
        scale = float(ref.abs().max())
        excess = float((lo - ref).abs().sub(tol["atol"] * scale
                                            + tol["rtol"] * ref.abs()).max())
        log(f"[stream] {fam} int8 eps vs f32: max abs err / max|eps| "
            f"{max_err(lo, ref) / scale:.3e} (tol: {tol['atol']} of scale + "
            f"{tol['rtol']} relative; worst margin {excess:.3e})")
        check(math.isfinite(scale) and excess <= 0,
              f"[stream] {fam} int8 eps beyond NET_TOLERANCES")


def stream_phase(paths, lm_engine, mix, dev, card, gen):
    """The online serving path at full width: `serve_stream` of a three-
    family engine with preemption and every precision class, the token
    engine's stream with a preemption, and the router over two engines.
    Returns the kernel records of the path's new modes."""
    import dataclasses as dc
    from repro_torch.core import SamplerConfig
    from repro_torch.kernels import cuda as kc
    from repro_torch.serve import (Arrival, DiffusionEngine, ReplicaSpec,
                                   Router, RouterConfig, TraceTraffic,
                                   VirtualClock, serving_metrics)
    t_phase = time.perf_counter()
    specs = {fam: paths[name][0] for fam, name in STREAM_FAMILIES.items()}
    nets = {fam: paths[name][1] for fam, name in STREAM_FAMILIES.items()}
    engine = DiffusionEngine(specs, nets, batch_size=BATCH,
                             default_config=SamplerConfig(nfe=STREAM_NFE),
                             device=dev)
    reqs = [a.request for a in stream_requests().due(math.inf)]
    t0 = time.perf_counter()
    engine._prepare(reqs)                   # Stage I, before the clock
    for fam in engine.families:
        for prec in ("bf16", "int8"):
            engine._params_for(fam, prec)
    torch.cuda.synchronize()
    log(f"[stream] engine {engine.families}, K {engine.state.u.shape[1]}, "
        f"Qb {engine.state.hist.shape[1]}: Stage I of "
        f"{len(engine.cache)} configs and the bf16 / int8 copies "
        f"{time.perf_counter() - t0:.2f}s")
    dispatches, remove = instrument(engine)
    kc.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve_stream(stream_requests())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    remove()
    m = serving_metrics(engine.request_log)
    log(f"[stream] served {len(results)} requests in {dt:.4f}s, "
        f"{len(results) / dt:.3f} samples/s ({card}); {engine.n_rounds} "
        f"rounds, {len(dispatches)} dispatches, {engine.n_polls} polls; "
        f"preemptions {engine.n_preemptions}, resumes {engine.n_resumes}, "
        f"log {engine.preemption_log}; p50 / p99 latency "
        f"{m['p50_latency']} / {m['p99_latency']} rounds, deadline misses "
        f"{m['deadline_misses']}; launches {counts}")
    check(sorted(results) == list(range(len(reqs))), "[stream] missing "
          "results")
    for rid, x in results.items():
        check(x.shape == DATA and bool(np.isfinite(x).all()),
              f"[stream] request {rid}: shape {x.shape} or not finite")
    check(engine.n_resumes == engine.n_preemptions >= 2,
          f"[stream] {engine.n_preemptions} preemptions, "
          f"{engine.n_resumes} resumes (want >= 2, equal)")
    check(len(engine.parking) == 0, "[stream] rows left parked")
    check(all(len(set(w)) == 1 for w in engine.wave_log),
          "[stream] a wave mixed classes")
    for k in ("round_fused", "round_predict", "flash_attention",
              "flash_attention:f32", "dct2", "step_noise"):
        check(counts.get(k, 0) > 0, f"[stream] {k} never launched")
    bad = [(c, corr, got) for c, corr, got in dispatches
           if any(got.get(k, 0) != n for k, n in dispatch_want(
               engine.specs[c[0]], c[1], corr).items())]
    by_cls = {}
    for c, corr, _ in dispatches:
        by_cls[c + (corr,)] = by_cls.get(c + (corr,), 0) + 1
    log(f"[stream] dispatches by (family, precision, corrector): {by_cls}; "
        f"each against its expected launches: {len(bad)} differ")
    check(not bad, f"[stream] dispatches with other launches: {bad[:3]}")

    # every result bitwise that request served alone; bf16 the f32 class
    t0 = time.perf_counter()
    same, same_f32 = 0, 0
    for r in reqs:
        alone = engine.serve([r])[r.rid]
        same += bool(np.array_equal(results[r.rid], alone))
        if r.precision == "bf16":
            f32 = engine.serve([dc.replace(r, precision="f32")])[r.rid]
            same_f32 += bool(np.array_equal(results[r.rid], f32))
    n_bf16 = sum(r.precision == "bf16" for r in reqs)
    log(f"[stream] streamed == served alone: {same} of {len(reqs)} bitwise; "
        f"bf16 class == f32 class: {same_f32} of {n_bf16} bitwise "
        f"({time.perf_counter() - t0:.2f}s)")
    check(same == len(reqs), "[stream] a streamed result differs from the "
          "request served alone")
    check(same_f32 == n_bf16, "[stream] a bf16-class sample differs from "
          "the f32 class")
    net_tolerance_check(engine, gen, dev)
    recs = stream_kernel_records(engine, dispatches, counts, gen, dev)
    del engine
    free_card()

    # the token engine: a preempted and resumed request == served alone
    vocab = lm_engine.arch.cfg.vocab
    rng = np.random.default_rng(77)
    from repro_torch.serve import ServeRequest
    treqs = [ServeRequest(rid=i, workload="token", seed=i, max_new=m,
                          tokens=rng.integers(2, vocab, size=L)
                          .astype(np.int32), **kw)
             for i, (_, L, m, kw) in enumerate(TOKEN_STREAM)]
    trace = TraceTraffic([Arrival(t, r) for (t, *_), r in
                          zip(TOKEN_STREAM, treqs)])
    kc.reset_launches()
    t0 = time.perf_counter()
    toks = lm_engine.serve_stream(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    n_tok = sum(len(v) for v in toks.values())
    log(f"[stream] {LM_ARCH}: {len(toks)} requests, {n_tok} tokens in "
        f"{dt:.4f}s ({n_tok / dt:.3f} tokens/s, {card}); preemptions "
        f"{lm_engine.n_preemptions} {lm_engine.preemption_log}, resumes "
        f"{lm_engine.n_resumes}; launches {counts}")
    for k in LM_KERNELS:
        check(counts.get(k, 0) > 0, f"[stream] {LM_ARCH}: {k} never "
              "launched")
    check(lm_engine.n_preemptions >= 1 and lm_engine.n_resumes ==
          lm_engine.n_preemptions and len(lm_engine.parking) == 0,
          f"[stream] {LM_ARCH}: no preemption, or rows left parked")
    same = sum(bool(np.array_equal(toks[r.rid],
                                   lm_engine.serve([r])[r.rid]))
               for r in treqs)
    log(f"[stream] {LM_ARCH}: streamed (one preempted and resumed) == "
        f"served alone: {same} of {len(treqs)} bitwise")
    check(same == len(treqs), f"[stream] {LM_ARCH}: a resumed request "
          "differs from its uninterrupted run")

    # the router over two full-width cifar10-ddpm engines == one engine
    spec, net = paths["cifar10-ddpm"][:2]
    mk = lambda: DiffusionEngine(spec, net, batch_size=BATCH,
                                 default_config=SamplerConfig(nfe=STREAM_NFE),
                                 device=dev)
    rtrace = lambda: TraceTraffic([Arrival(float(i), r) for i, r in
                                   enumerate(requests(mix, 700))])
    router = Router([ReplicaSpec(index=i, batch=BATCH) for i in (0, 1)],
                    RouterConfig(default_nfe=STREAM_NFE))
    kc.reset_launches()
    t0 = time.perf_counter()
    routed, plan = router.serve(rtrace(), [mk(), mk()])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    solo = mk().serve_stream(rtrace(), clock=VirtualClock())
    same = sum(bool(np.array_equal(routed[r], solo[r])) for r in solo
               if r in routed)
    log(f"[stream] router over 2 cifar10-ddpm engines: {len(routed)} "
        f"samples in {dt:.4f}s ({[len(s) for s in plan.sub_traces]} per "
        f"replica), counters {plan.counters}; == one engine's serve_stream: "
        f"{same} of {len(solo)} bitwise; launches {counts}")
    for k in PATH_KERNELS["cifar10-ddpm"]:
        check(counts.get(k, 0) > 0, f"[stream] router: {k} never launched")
    check(sorted(routed) == sorted(solo) == list(range(N_REQUESTS))
          and same == len(solo), "[stream] the routed results differ from "
          "one engine's")
    log(f"[stream] phase {time.perf_counter() - t_phase:.2f}s")
    return recs


# ---- lm-train: LM training at full width, the dense configs served -----------
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_WARM = 4, 1024, 30, 5
VLM_ARCH, VLM_STEPS = "internvl2-1b", 10
LM_REDUCED_STEPS, LM_REDUCED_SAVE = 5, 3
# the new configs served: 4 requests a list, prompts of 96 and 200 tokens,
# 32 new each, caches of 256; llama3-405b at 4 of its 126 layers (all 126
# hold 810 GB of bf16 weights), the others at the depth that fits
SERVE_ARCHS = ("internvl2-1b", "nemotron-4-15b", "deepseek-coder-33b",
               "llama3-405b")
SERVE_LAYERS = {"llama3-405b": 4}
SERVE_PROMPTS, SERVE_NEW, SERVE_LEN, SERVE_N = (96, 200), 32, 256, 4
GIB = 2 ** 30


def lm_train_args(arch: str, **kw) -> argparse.Namespace:
    """`launch.train`'s command line for the phase's LM runs."""
    return argparse.Namespace(**{**dict(
        arch=arch, reduced=False, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
        seq_len=LM_TRAIN_SEQ, lr=TRAIN_LR, seed=SEED, ckpt_dir=None,
        ckpt_every=0, resume=False, log_every=0, device="cuda"), **kw})


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def lm_grad_check(shape, hkv, window, gen, dev):
    """The causal form with a gradient at a training shape (B, S, Hq, Dh)
    over `hkv` kv heads, bf16: `FlashAttention`'s output (the forward kernel,
    one launch) and its dq, dk, dv (the plain backward from the saved q,
    k, v) against torch autograd through the plain version in f32 on the
    same values, within 2 bf16 ulp at max(|g|, max|g| / 1024).  Times
    (device ms) the plain backward, the Function's forward + backward and
    SDPA's forward + backward (GQA by repeated kv heads; a yardstick, not
    on the path).  Returns (q, k, v, forward max abs err, timings, SDPA's
    mask keywords)."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                                   attention_ref)
    B, S, Hq, Dh = shape
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, do = rnd(B, S, Hq, Dh), rnd(B, S, Hq, Dh)
    k, v = rnd(B, S, hkv, Dh), rnd(B, S, hkv, Dh)
    what = f"{tuple(shape)} over {hkv} kv heads, window {window}"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    inst = attn_ops.WINDOW_COUNT if window else attn_ops.GLOBAL_COUNT
    n0 = [kc.launches().get(c, 0) for c in ("flash_attention", inst)]
    out = attn_ops.attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    check([kc.launches().get(c, 0) for c in ("flash_attention", inst)]
          == [n + 1 for n in n0]
          and "FlashAttention" in type(out.grad_fn).__name__,
          f"[lm-train] the causal gradient at {what} did not run the "
          "forward kernel once inside FlashAttention")
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = attention_ref(*ref_leaves, causal=True, window=window)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    torch.cuda.synchronize()
    err_fwd = max_err(out.detach(), ref_out.detach())
    ulp_fwd = ulp_err(out.detach(), ref_out.detach().to(torch.bfloat16))
    log(f"[lm-train] causal attention output at {what}, bf16: the forward "
        f"kernel vs the plain version in f32: max {ulp_fwd:.2f} bf16 ulp "
        f"(tol 2), max abs err {err_fwd:.3e}")
    check(bool(torch.isfinite(out).all()) and ulp_fwd <= 2,
          f"[lm-train] causal flash_attention beyond tolerance at {what}")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        ulps, scale = ulp_err(a, b.to(torch.bfloat16)), float(b.abs().max())
        log(f"[lm-train] causal attention gradient {name} at {what}: max "
            f"{ulps:.2f} bf16 ulp (tol 2), max abs err / max|g| "
            f"{max_err(a, b) / scale:.3e}")
        check(bool(torch.isfinite(a).all()) and ulps <= 2,
              f"[lm-train] causal attention gradient {name} beyond "
              f"tolerance at {what}")
    del ref_leaves, ref_out, want, got, out
    rep = Hq // hkv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sl = [q.transpose(1, 2).contiguous().requires_grad_()] + [
        t.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
        .requires_grad_() for t in (k, v)]
    doh = do.transpose(1, 2).contiguous()
    pos = torch.arange(S, device=dev)
    mask = None if window is None else (
        (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window))
    kw = dict(is_causal=True) if window is None else dict(attn_mask=mask)
    times = dict(
        plain_bwd_ms=time_ms(lambda: attention_bwd_ref(
            q, k, v, do, causal=True, window=window), 10)[0],
        function_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
            attn_ops.attention(*leaves, causal=True, window=window), leaves,
            do), 10)[0],
        sdpa_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
            sdpa(*sl, **kw), sl, doh), 10)[0])
    log(f"[lm-train] causal attention at {what}: plain backward "
        f"{times['plain_bwd_ms']:.5f} ms; the Function forward + backward "
        f"{times['function_fwd_bwd_ms']:.5f} ms; SDPA forward + backward "
        f"{times['sdpa_fwd_bwd_ms']:.5f} ms (device ms)")
    return q, k, v, err_fwd, times, kw


def lm_train_record(name, path, q, k, v, window, launches, err, times,
                    sdpa_kw):
    """The kernels-line record of the causal flash_attention forward at a
    training shape, SDPA's forward as the library yardstick; the
    backward timings ride along."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    B, S, Hq, Dh = q.shape
    rep = Hq // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).repeat_interleave(rep, 1).contiguous()
              for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = timed_record(
        name, path, "src/repro_torch/csrc/attention.cu",
        "src/repro/kernels/attention/kernel.py:109", launches, err,
        lambda: attn_ops.flash_attention_causal(q, k, v, window=window),
        lm_kernel(Dh),
        lambda: attention_ref(q, k, v, causal=True, window=window),
        2 * (2 * q.numel() + 2 * k.numel()),        # q, k, v read; o written
        4 * B * causal_pairs(S, S, window) * Hq * Dh, BF16_FLOPS,
        library_fn=lambda: sdpa(qh, kh, vh, **sdpa_kw))
    rec.update(times)
    return rec


def lm_train_full(arch_name, steps, dev, card, trace: bool):
    """`launch.train.train_lm` on `arch_name` at full width (bf16, remat
    on), batch LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens, `steps` steps, each
    timed by its `on_step` call with the card synchronized (the last one
    traced where `trace`).  Checks finite losses and 2 flash_attention
    launches a layer a step (forward and remat recompute), counted by
    instance: 2 a windowed layer a step with the window, 2 a global layer
    without.  Returns (losses, launches by name, peak GiB, a dict of
    timings)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch.train import train_lm
    from repro_torch.models.transformer import param_list
    cfg = get_arch(arch_name).cfg
    watch, tree_mem = StepClock(traced=steps if trace else None), {}

    def on_step(step, params, st, m):
        watch(step, params, st, m)
        if trace and step == steps:
            tree_mem.update(state_tree_check(params, st, cfg))
    free_card()
    before = torch.cuda.memory_allocated() / GIB
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    t0 = time.perf_counter()
    run = train_lm(lm_train_args(arch_name, steps=steps), on_step=on_step)
    counts = kc.launches()
    peak = tree_mem.get("train_peak", torch.cuda.max_memory_allocated() / GIB)
    embed = tuple(run["params"]["embed"].shape)
    n_params = sum(t.numel() for t in param_list(run["params"]))
    n_layers = len(run["params"]["layers"])
    del run
    free_card()
    losses = [float(m["loss"]) for m in watch.metrics]
    gnorms = [float(m["grad_norm"]) for m in watch.metrics]
    n_win = sum(cfg.layer_windows[i % cfg.pattern] is not None
                for i in range(n_layers))
    want = {"flash_attention": 2 * n_layers * steps,
            attn_ops.WINDOW_COUNT: 2 * n_win * steps,
            attn_ops.GLOBAL_COUNT: 2 * (n_layers - n_win) * steps}
    got = {name: counts.get(name, 0) for name in want}
    log(f"[lm-train] train_lm {arch_name} full width ({n_params} params, "
        f"embed {embed}, bf16, remat on), batch {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} tokens, {len(losses)} steps in "
        f"{time.perf_counter() - t0:.2f}s (init included): launches "
        f"{counts} ({want} expected: forward and remat recompute, {n_win} "
        f"of {n_layers} layers windowed)")
    check(len(losses) == steps and all(math.isfinite(x)
                                       for x in losses + gnorms),
          f"[lm-train] {arch_name}: a loss or grad norm is not finite, or "
          "steps are missing")
    check(got == want, f"[lm-train] {arch_name}: flash_attention launches "
          f"{got}, expected {want}")
    timed = watch.step_seconds(LM_TRAIN_WARM if trace else 1)
    med = float(np.median(timed))
    out = dict(wall_ms=1e3 * med,
               tokens_per_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ / med)
    line = (f"[lm-train] {arch_name}: loss {losses[0]:.5f} -> "
            f"{losses[-1]:.5f} (every 5th: "
            f"{[round(x, 5) for x in losses[::5]]}); grad norm "
            f"{gnorms[0]:.4f} -> {gnorms[-1]:.4f}; median step "
            f"{out['wall_ms']:.3f} ms, {out['tokens_per_s']:.1f} tokens/s")
    if trace:
        wall, busy, n_events = watch.traced_step(
            ROOT / "chiprun_out" / "train_lm_profile.txt")
        out.update(device_ms=1e3 * busy, traced_wall_ms=1e3 * wall)
        line += (f"; one traced step: wall {1e3 * wall:.3f} ms, device busy "
                 f"{1e3 * busy:.3f} ms ({100 * busy / wall:.1f}% busy), "
                 f"{n_events} device events")
    log(line + f"; peak memory {peak:.3f} GiB allocated ({before:.3f} GiB "
        f"resident before, {watch.resident[0]:.3f} at step 0 with the fresh "
        f"train state) ({card})")
    if tree_mem:
        log(f"[lm-train] {arch_name}: the checkpoint's tree of the trained "
            f"state (lm_train_state_tree, {tree_mem['gib']:.3f} GiB on the "
            f"host, built in {tree_mem['build_s']:.2f}s) and its copy back "
            f"in place (load_lm_train_state, {tree_mem['load_s']:.2f}s, "
            f"params bitwise): device peak {tree_mem['peak']:.3f} GiB above "
            f"the {tree_mem['resident']:.3f} GiB resident ({card})")
    return losses, got, peak, out


def state_tree_check(params, opt_state, cfg) -> dict:
    """What a checkpoint of the trained full-width state costs the card,
    without the disk: `lm_train_state_tree` (the tree `train_lm` saves,
    and the template a resume restores into) and `load_lm_train_state`
    (a resume's copy back in place) of the same values.  Checks that every
    leaf of the tree lies on the host, that the params come back bitwise,
    and that the device peak above the resident state stays under 1 GiB.
    Returns the training's peak (read first) and these numbers."""
    from repro_torch.ckpt.store import tree_flatten
    from repro_torch.convert import lm_train_state_tree, load_lm_train_state
    from repro_torch.models.transformer import param_list
    torch.cuda.synchronize()
    out = dict(train_peak=torch.cuda.max_memory_allocated() / GIB,
               resident=torch.cuda.memory_allocated() / GIB)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = lm_train_state_tree(params, opt_state, cfg)
    leaves = tree_flatten(tree)[0]
    out["build_s"] = time.perf_counter() - t0
    out["gib"] = sum(t.numel() * t.element_size() for t in leaves) / GIB
    check(all(t.device.type == "cpu" for t in leaves), "[lm-train] the "
          "checkpoint tree holds a leaf on the card")
    want = [t.detach().cpu() for t in param_list(params)]
    t0 = time.perf_counter()
    load_lm_train_state(params, opt_state, tree, cfg)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["peak"] = torch.cuda.max_memory_allocated() / GIB - out["resident"]
    check(all(torch.equal(a, b.detach().cpu())
              for a, b in zip(want, param_list(params))),
          "[lm-train] the params did not come back bitwise from the "
          "checkpoint tree")
    check(out["peak"] < 1.0, f"[lm-train] building and loading the "
          f"checkpoint tree took {out['peak']:.3f} GiB of device memory")
    return out


def reduced_lm_train_check() -> None:
    """Reduced gemma3-1b (f32, remat off) through `train_lm`,
    LM_REDUCED_STEPS steps at batch 4 x 64 on the card and on the CPU,
    both resumed from one step-0 checkpoint of the CPU's seeded weights
    (each device's generator draws its own numbers): losses within 1e-5
    relative.  Then on the card the same run preempted at
    LM_REDUCED_SAVE by `on_step` with its checkpoint and resumed with
    --resume: its params and losses bitwise equal to the uninterrupted
    card run (else within the spread of two uninterrupted card runs,
    printed)."""
    import shutil
    from repro_torch.launch.train import train_lm
    from repro_torch.models.transformer import param_list
    top = ROOT / "build" / "ckpt_lm_smoke"
    shutil.rmtree(top, ignore_errors=True)
    args = lambda **kw: lm_train_args(LM_ARCH, reduced=True,
                                      steps=LM_REDUCED_STEPS, batch=4,
                                      seq_len=64, **kw)
    train_lm(args(device="cpu", ckpt_dir=str(top / "start")),
             on_step=lambda *_: True)                # stops at step 0

    def run(name, on_step=None, **kw):
        """A run resumed from the newest checkpoint under `name` (a copy
        of the step-0 one where there is none yet); returns (its result,
        its losses)."""
        if not (top / name).exists():
            shutil.copytree(top / "start", top / name)
        losses = []

        def on(step, p, st, m):
            if m is not None:
                losses.append(float(m["loss"]))
            return on_step is not None and on_step(step)

        out = train_lm(args(ckpt_dir=str(top / name), resume=True, **kw),
                       on_step=on)
        return out, losses

    (card, lc), (_, lp) = run("card"), run("cpu", device="cpu")
    rel = [abs(a - b) / abs(b) for a, b in zip(lc, lp)]
    log(f"reduced {LM_ARCH} train_lm, {LM_REDUCED_STEPS} steps from one "
        f"checkpoint, card vs CPU: loss rel err "
        f"{[f'{r:.2e}' for r in rel]} (tol 1e-5)")
    check(len(lc) == len(lp) == LM_REDUCED_STEPS and max(rel) <= 1e-5,
          f"reduced {LM_ARCH} training: the card disagrees with the CPU")
    cut, _ = run("cut", on_step=lambda step: step >= LM_REDUCED_SAVE,
                 ckpt_every=LM_REDUCED_SAVE)
    check(cut["step"] == LM_REDUCED_SAVE, f"[lm-train] the preempted run "
          f"stopped at step {cut['step']}")
    res, lr_ = run("cut")
    diff = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
        param_list(card["params"]), param_list(res["params"])))
    same = diff == 0.0 and lr_ == lc[LM_REDUCED_SAVE:]
    log(f"reduced {LM_ARCH} train_lm preempted at step {LM_REDUCED_SAVE} "
        f"and resumed on the card: losses {lr_} vs "
        f"{lc[LM_REDUCED_SAVE:]}, max |params - uninterrupted| {diff:.3e}"
        f"{' (bitwise)' if same else ''}")
    if not same:
        again, _ = run("again")
        spread = max(float((a.detach() - b.detach()).abs().max())
                     for a, b in zip(param_list(card["params"]),
                                     param_list(again["params"])))
        log(f"[lm-train] resume not bitwise: two uninterrupted card runs "
            f"differ by {spread:.3e}, the resumed run by {diff:.3e}")
        check(diff <= spread, "[lm-train] the resumed run differs from the "
              "uninterrupted one by more than two uninterrupted runs do")
    shutil.rmtree(top, ignore_errors=True)


def serve_depth(name: str, cfg) -> int:
    """Layers of `name` kept on the card: all of them where the free
    memory holds the bf16 weights, the caches of a batch-BATCH engine of
    SERVE_LEN and 2 GiB besides, else the most that do (and at most
    SERVE_LAYERS[name])."""
    d, a = cfg.d_model, cfg.d_head
    layer = 2 * (d * a * 2 * (cfg.n_heads + cfg.n_kv_heads)
                 + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff + 2 * d)
    cache = 2 * 2 * BATCH * SERVE_LEN * cfg.n_kv_heads * a
    embed = 2 * cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    free = torch.cuda.mem_get_info()[0]
    fit = (free - embed - 2 * GIB) // (layer + cache)
    n = min(cfg.n_layers, SERVE_LAYERS.get(name, cfg.n_layers), int(fit))
    log(f"[serve {name}] {free / GIB:.2f} GiB free; bf16 weights "
        f"{(embed + cfg.n_layers * layer) / GIB:.2f} GiB at full depth "
        f"({cfg.n_layers} layers of {layer / GIB:.3f} GiB, embedding "
        f"{embed / GIB:.3f}): serving {n} of {cfg.n_layers} layers")
    check(n >= 1, f"[serve {name}] not one layer fits")
    return n


def serve_new_arch(name: str, dev, card, gen):
    """A new config at full width (depth cut to what fits, logged) on a
    batch-BATCH TokenEngine: SERVE_N requests of SERVE_NEW tokens, counts
    reset before and read after (flash_attention in prefill,
    decode_attention in decode, each launched), every id in [0, vocab);
    then its logits with the kernels against the plain attention, and the
    records of its (Hq, Hkv, Dh).  Returns (records, layers served)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda as kc
    from repro_torch.models.registry import Arch
    from repro_torch.serve import TokenEngine
    free_card()
    spec = get_arch(name)
    layers = serve_depth(name, spec.cfg)
    if layers < spec.cfg.n_layers:
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, n_layers=layers))
    arch = Arch(spec)
    t0 = time.perf_counter()
    params = arch.init(seed=SEED, device=dev)
    engine = TokenEngine(arch, params, batch_size=BATCH, max_len=SERVE_LEN,
                         eos_id=-1, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    vocab = arch.cfg.vocab
    kc.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(lm_requests(vocab, SEED, n=SERVE_N,
                                       lens=SERVE_PROMPTS,
                                       max_new=SERVE_NEW))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    log(f"[serve {name}] {layers} layers, Hq {arch.cfg.n_heads} over Hkv "
        f"{arch.cfg.n_kv_heads} of {arch.cfg.d_head}: weights drawn in "
        f"{t_init:.2f}s, {torch.cuda.memory_allocated() / GIB:.2f} GiB "
        f"allocated; {len(results)} requests, {SERVE_N * SERVE_NEW} tokens "
        f"in {dt:.3f}s (first serve, nothing warmed) ({card}); launches "
        f"{counts}")
    check(sorted(results) == list(range(SERVE_N)), f"{name}: missing "
          "results")
    for rid, ids in results.items():
        check(len(ids) == SERVE_NEW and bool(((ids >= 0) & (ids < vocab))
                                             .all()),
              f"{name}: request {rid} returned {len(ids)} tokens or ids "
              f"outside [0, {vocab})")
    for kname in LM_KERNELS:
        check(counts.get(kname, 0) > 0, f"{name}: {kname} never launched")
    lm_model_check(arch, params, dev, name=name, prompt=SERVE_PROMPTS[1],
                   max_len=SERVE_LEN)
    del engine, params
    free_card()
    recs = lm_records(arch.cfg, counts, gen, dev, path=name,
                      prompts=SERVE_PROMPTS, max_len=SERVE_LEN,
                      windows=(None,), tag=name)
    return recs, layers


def lm_train_phase(dev, card, gen):
    """LM training on the card through `launch.train.train_lm`: the causal
    gradient at the training shapes; full-width gemma3-1b (30 steps, 52
    flash_attention launches a step, its loss from ln(vocab) down) and
    internvl2-1b (the embeddings branch); reduced gemma3-1b card vs CPU
    and a bitwise resume; then the four new configs served.  Returns the
    kernels-line records."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    t_phase = time.perf_counter()
    g = get_arch(LM_ARCH).cfg
    vl = get_arch(VLM_ARCH).cfg
    shapes = [
        ("gemma3-1b,window", LM_ARCH, (LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                       g.n_heads, g.d_head), g.n_kv_heads,
         max(w or 0 for w in g.layer_windows)),
        ("gemma3-1b,global", LM_ARCH, (LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                       g.n_heads, g.d_head), g.n_kv_heads,
         None),
        (VLM_ARCH, VLM_ARCH, (LM_TRAIN_BATCH, LM_TRAIN_SEQ, vl.n_heads,
                              vl.d_head), vl.n_kv_heads, None)]
    checked = [lm_grad_check(shape, hkv, window, gen, dev)
               for _, _, shape, hkv, window in shapes]
    losses, flash, peak, _ = lm_train_full(LM_ARCH, LM_TRAIN_STEPS, dev,
                                           card, trace=True)
    ln_v = math.log(g.vocab)
    log(f"[lm-train] {LM_ARCH}: step-0 loss {losses[0]:.5f} against ln "
        f"{g.vocab} = {ln_v:.5f} (tol 1 nat); mean of the first 5 "
        f"{np.mean(losses[:5]):.5f}, of the last 5 {np.mean(losses[-5:]):.5f}")
    check(abs(losses[0] - ln_v) <= 1.0, f"[lm-train] {LM_ARCH}: step-0 loss "
          f"{losses[0]:.4f} not within 1 nat of ln(vocab) {ln_v:.4f}")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"[lm-train] {LM_ARCH}: the loss did not fall")
    _, vflash, vpeak, _ = lm_train_full(VLM_ARCH, VLM_STEPS, dev, card,
                                        trace=False)
    # each record's launches: the measured count of its instance
    launches = [flash[attn_ops.WINDOW_COUNT], flash[attn_ops.GLOBAL_COUNT],
                vflash[attn_ops.GLOBAL_COUNT]]
    records = []
    for (tag, path, _, _, window), (q, k, v, err, tms, kw), n in zip(
            shapes, checked, launches):
        records.append(lm_train_record(
            f"flash_attention[train,{tag}]", f"train_lm {path}, batch "
            f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}", q, k, v, window, n, err,
            tms, kw))
    del checked
    reduced_lm_train_check()
    log(f"[lm-train] training: {time.perf_counter() - t_phase:.2f}s; peak "
        f"memory {peak:.3f} GiB ({LM_ARCH}), {vpeak:.3f} GiB ({VLM_ARCH}) "
        f"({card})")
    cut = {}
    for name in SERVE_ARCHS:
        recs, cut[name] = serve_new_arch(name, dev, card, gen)
        records += recs
    log(f"[lm-train] layers served of each new config: {cut}; phase "
        f"{time.perf_counter() - t_phase:.2f}s")
    return records


# ---- whisper / moe: the encoder-decoder and the MoE transformers -------------
WHISPER, QWEN, LLAMA4 = ("whisper-base", "qwen3-moe-30b-a3b",
                         "llama4-maverick-400b-a17b")
# whisper-base served: 8 requests at batch 4, prompts of 16 and 48 tokens by
# turns (so every admission wave is one request wide), 32 new, caches of 128
W_LENS, W_NEW, W_LEN = (16, 48), 32, 128
# its stream: (arrival round, prompt length, max_new, request keywords);
# distinct prompt lengths, so a wave is one request wide as when served
# alone; the fifth, more urgent, preempts a running slot
W_STREAM = [(0.0, 16, 32, {}), (0.0, 17, 32, {}), (1.0, 18, 32, {}),
            (1.0, 19, 32, {}), (6.0, 20, 16, dict(priority=2, deadline=30.0))]
W_TRAIN_BATCH, W_TRAIN_SEQ, W_TRAIN_STEPS = 8, 128, 20
# the MoE configs: qwen3-moe-30b-a3b served at 12 of its 48 layers (8
# requests, prompts of 64 and 256, 32 new, caches of 512) and trained at 2;
# llama4-maverick-400b-a17b at 2 of 48 (a dense layer, then an MoE layer
# with its shared expert): one wave of 4 prompts of 128 and 8 decode rounds
MOE_LAYERS = {QWEN: 12, LLAMA4: 2}
MOE_WHY = {
    QWEN: "the script's 1200 s: 48 layers draw and serve 30.5 B params "
          "(61 GB bf16) on the one card",
    LLAMA4: "one card: 48 layers hold ~400 B params (~800 GB bf16)"}
Q_LENS, Q_NEW, Q_LEN = (64, 256), 32, 512
L4_PROMPT, L4_ROUNDS, L4_LEN = 128, 8, 256
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = \
    2, 4, 256, 10
MOE_TOL = 3e-2          # bf16 layer on the card vs f32 on the CPU, of scale


def token_requests(spec, seed0: int, n: int, lens, max_new: int):
    """`lm_requests` for `spec`: an encdec arch's requests carry frames."""
    frames = ((spec.frontend_ctx, spec.cfg.d_model)
              if spec.family == "encdec" else None)
    return lm_requests(spec.cfg.vocab, seed0, n=n, lens=lens,
                       max_new=max_new, frames=frames)


def cpu_schedule(name: str, n: int, lens, max_new: int, max_len: int,
                 batch: int = BATCH):
    """(admission waves, decode rounds) of a TokenEngine serve of these
    request shapes (no eos), from a run of the reduced config on the CPU:
    the schedule is the host's, so the card's serve must repeat it."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import Arch
    from repro_torch.serve import TokenEngine
    arch = Arch(get_arch(name, reduced=True))
    eng = TokenEngine(arch, arch.init(seed=SEED, device="cpu"),
                      batch_size=batch, max_len=max_len, eos_id=-1,
                      device="cpu")
    eng.serve(token_requests(arch.spec, SEED, n, lens, max_new))
    return eng.n_prefill_calls, eng.n_decode_steps


def depth_cut(name: str, spec, layers: int):
    """`spec` with its depth cut to `layers` (printed as `reduced`, with
    its reason)."""
    log(f"[moe] reduced: {name} at {layers} of {spec.cfg.n_layers} layers "
        f"({MOE_WHY[name]}); widths, heads, experts and vocab as published")
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, n_layers=layers))


def serve_counted(engine, reqs, warm, what: str, card: str):
    """A warm-up serve of `warm`, the launch counts set to 0, one serve of
    `reqs`, the counts read right after: (results, counts, waves, rounds,
    seconds)."""
    from repro_torch.kernels import cuda as kc
    engine.serve(warm)
    torch.cuda.synchronize()
    w0, r0, t0n = (engine.n_prefill_calls, engine.n_decode_steps,
                   engine.n_tokens_out)
    kc.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kc.launches()
    waves, rounds = engine.n_prefill_calls - w0, engine.n_decode_steps - r0
    n_tok = engine.n_tokens_out - t0n
    log(f"[{what}] serve: {len(results)} requests, {n_tok} tokens in "
        f"{dt:.4f}s ({n_tok / dt:.3f} tokens/s, {card}), {waves} admission "
        f"waves, {rounds} decode rounds; launches {counts}")
    vocab = engine.arch.cfg.vocab
    check(sorted(results) == sorted(r.rid for r in reqs),
          f"[{what}] missing results")
    for r in reqs:
        ids = results[r.rid]
        check(len(ids) == r.max_new and bool(((ids >= 0) & (ids < vocab))
                                             .all()),
              f"[{what}] request {r.rid}: {len(ids)} tokens, or ids outside "
              f"[0, {vocab})")
    return results, counts, waves, rounds, dt


def check_counts(what: str, counts: dict, want: dict) -> None:
    got = {k: counts.get(k, 0) for k in want}
    log(f"[{what}] launches by form {got}, predicted {want}")
    check(got == want, f"[{what}] launches {got}, predicted {want}")


def encdec_model_check(arch, params, dev) -> None:
    """Full-width whisper-base, bf16: the encoder memory, the last prompt
    position's logits and one per-slot decode step over the f32 memory
    (as the engine keeps it) with the kernels, against the same model
    with the plain attention (tol 5e-2 of scale: bf16 rounding through
    every layer)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    cfg, L = arch.cfg, W_LENS[1]
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.standard_normal(
        (2, arch.spec.frontend_ctx, cfg.d_model)).astype(np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(2, L))).to(dev)
    pos = torch.tensor([L, L - 3], dtype=torch.int32, device=dev)

    def run():
        mem = arch.encode_memory(params, frames)
        logits, caches = arch.prefill(params, {"tokens": toks,
                                               "memory": mem}, W_LEN)
        nxt = torch.argmax(logits, -1)[:, None]
        logits2, _ = arch.decode(params, nxt, caches, pos,
                                 memory=mem.float())
        return mem.float(), logits.float(), logits2.float()

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
    for what, a, b in zip(("encoder memory", "prefill logits",
                           "decode logits"), kern, plain):
        scale = float(b.abs().max())
        err = max_err(a, b) / scale
        log(f"[whisper] bf16 {what}, kernels vs plain attention: max abs "
            f"err / max|x| = {err:.3e} (tol 5e-2), max|x| {scale:.3e}")
        check(math.isfinite(scale) and err <= 5e-2,
              f"[whisper] {what} beyond tolerance")


def whisper_records(cfg, counts, gen, dev):
    """The three new shapes of flash_attention on whisper-base's path, each
    against its plain version and timed beside it, its bound and SDPA: the
    encoder (BATCH, 1500, 8, 64) bf16 (the DiT form over a key tail:
    1500 = 23 * 64 + 28), the cross-attention of a prefill wave (1, 48, 8,
    64) over (1, 1500, 8, 64) bf16, and of a decode round, bf16 queries
    (BATCH, 1, 8, 64) over the f32 memory pool's keys (the f32 kernel, q
    upcast).  Then decode_attention and the causal prefill at the
    decoder's heads (`lm_records`)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import attention_ref
    H, Dh, S = cfg.n_heads, cfg.d_head, cfg.n_audio_ctx
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    bf = torch.bfloat16
    heads = lambda t: t.transpose(1, 2).contiguous()
    cross, f32 = counts.get(attn_ops.CROSS_COUNT, 0), \
        counts.get(attn_ops.F32_COUNT, 0)
    enc = counts.get("flash_attention", 0) - cross - counts.get(
        attn_ops.GLOBAL_COUNT, 0)
    src = "src/repro_torch/csrc/attention.cu"
    rep_ = "src/repro/kernels/attention/kernel.py:109"
    records = []
    # (name, q, k, v, kernel substring, tolerance in bf16 ulp, launches on
    # the path, bytes, ops, peak)
    q32, k32, v32 = rnd(BATCH, S, H, Dh), rnd(BATCH, S, H, Dh), \
        rnd(BATCH, S, H, Dh)
    Lq = W_LENS[1]
    cq = rnd(1, Lq, H, Dh)
    ck, cv = rnd(1, S, H, Dh), rnd(1, S, H, Dh)
    dq = rnd(BATCH, 1, H, Dh).to(bf)
    cases = [
        ("flash_attention[encoder,whisper-base]", q32.to(bf), k32.to(bf),
         v32.to(bf), f"flash_dit_wgmma_kernel<{Dh}", 2, enc,
         2 * 4 * q32.numel(), 4 * BATCH * S * S * H * Dh, BF16_FLOPS),
        ("flash_attention[cross,whisper-base]", cq.to(bf), ck.to(bf),
         cv.to(bf), f"flash_lm_wgmma_kernel<{Dh}, false", 2, cross - f32,
         2 * (2 * cq.numel() + 2 * ck.numel()), 4 * Lq * S * H * Dh,
         BF16_FLOPS),
        ("flash_attention[cross,f32 memory,whisper-base]", dq, k32, v32,
         f"flash_lm_kernel<{Dh}, false", 1, f32,
         2 * 2 * dq.numel() + 4 * 2 * k32.numel(), 4 * BATCH * S * H * Dh,
         F32_FLOPS)]
    for name, q, k, v, kname, tol, n, nbytes, ops, peak in cases:
        got = attn_ops.attention(q, k, v, causal=False)
        want = attention_ref(q, k, v, causal=False)
        torch.cuda.synchronize()
        ulps, err = ulp_err(got, want), max_err(got, want)
        extra = ""
        if q.dtype == bf and k.dtype == bf:
            got32 = attn_ops.attention(q.float(), k.float(), v.float(),
                                       causal=False)
            want32 = attention_ref(q.float(), k.float(), v.float(),
                                   causal=False)
            torch.cuda.synchronize()
            e32 = max_err(got32, want32)
            extra = f"; f32 inputs {e32:.3e} (tol 2e-5)"
            check(e32 <= 2e-5, f"[whisper] {name}: f32 beyond tolerance")
        log(f"[whisper] {name} {tuple(q.shape)} {q.dtype} over "
            f"{tuple(k.shape)} {k.dtype}: max {ulps:.2f} bf16 ulp (tol "
            f"{tol}), max abs err {err:.3e}{extra}")
        check(got.dtype == bf and bool(torch.isfinite(got).all())
              and ulps <= tol, f"[whisper] {name} beyond tolerance")
        qh = heads(q.to(k.dtype))
        kh, vh = heads(k), heads(v)
        records.append(timed_record(
            name, f"TokenEngine {WHISPER}", src, rep_, n, err,
            lambda q=q, k=k, v=v: attn_ops.attention(q, k, v, causal=False),
            kname, lambda q=q, k=k, v=v: attention_ref(q, k, v,
                                                       causal=False),
            nbytes, ops, peak,
            library_fn=lambda qh=qh, kh=kh, vh=vh: sdpa(qh, kh, vh)))
    records += lm_records(cfg, dict(counts, flash_attention=counts.get(
        attn_ops.GLOBAL_COUNT, 0)), gen, dev, path=f"TokenEngine {WHISPER}",
        prompts=W_LENS, max_len=W_LEN, windows=(None,), tag=WHISPER)
    return records


def token_stream(engine, what: str, card: str, stream, seed: int) -> None:
    """`serve_stream` of `stream` ((arrival round, prompt length, max_new,
    request keywords)) on a TokenEngine, an encdec arch's requests with
    frames drawn before each prompt: the urgent arrival preempts a
    running slot (its cache rows, state row and memory row parked on the
    host, then restored); every request's tokens must equal the request
    served alone, bitwise."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.serve import Arrival, ServeRequest, TraceTraffic
    spec = engine.arch.spec
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (_, L, m, kw) in enumerate(stream):
        frames = None
        if spec.family == "encdec":
            frames = rng.standard_normal(
                (spec.frontend_ctx, spec.cfg.d_model)).astype(np.float32)
        reqs.append(ServeRequest(
            rid=i, workload="token", seed=i, max_new=m, frames=frames,
            tokens=rng.integers(2, spec.cfg.vocab, size=L).astype(np.int32),
            **kw))
    trace = TraceTraffic([Arrival(t, r) for (t, *_), r in
                          zip(stream, reqs)])
    p0, r0 = engine.n_preemptions, engine.n_resumes
    kc.reset_launches()
    t0 = time.perf_counter()
    toks = engine.serve_stream(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in toks.values())
    pre, res = engine.n_preemptions - p0, engine.n_resumes - r0
    log(f"[{what}] stream: {len(toks)} requests, {n_tok} tokens in "
        f"{dt:.4f}s ({n_tok / dt:.3f} tokens/s, {card}); preemptions {pre} "
        f"{engine.preemption_log}, resumes {res}; launches {kc.launches()}")
    check(pre >= 1 and res == pre and len(engine.parking) == 0,
          f"[{what}] stream: no preemption, or rows left parked")
    same = sum(bool(np.array_equal(toks[r.rid], engine.serve([r])[r.rid]))
               for r in reqs)
    log(f"[{what}] stream (a {what} slot preempted and resumed) == served "
        f"alone: {same} of {len(reqs)} bitwise")
    check(same == len(reqs), f"[{what}] a streamed request differs from "
          "the request served alone")


def whisper_serve(dev, card, gen):
    """whisper-base at full width and depth on a batch-BATCH TokenEngine:
    8 requests (prompts of 16 and 48, 32 new, frames from the seed), the
    launches by form gated against the schedule, the stream with a
    preemption, the model with the kernels against the plain attention,
    and the records of the path's shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models.registry import Arch
    from repro_torch.models.transformer import param_list
    from repro_torch.serve import TokenEngine
    free_card()
    t0 = time.perf_counter()
    spec = get_arch(WHISPER)
    arch, cfg = Arch(spec), spec.cfg
    params = arch.init(seed=SEED, device=dev)
    engine = TokenEngine(arch, params, batch_size=BATCH, max_len=W_LEN,
                         eos_id=-1, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in param_list(params))
    log(f"[whisper] {WHISPER}: {n_params} params drawn on the card, "
        f"{cfg.n_enc_layers} + {cfg.n_dec_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, "
        f"{cfg.n_audio_ctx} frames, vocab {cfg.vocab}, {cfg.dtype}; memory "
        f"pool {tuple(engine.memory.shape)} {engine.memory.dtype}: "
        f"{time.perf_counter() - t0:.2f}s; reduced: none")
    waves_p, rounds_p = cpu_schedule(WHISPER, N_REQUESTS, W_LENS, W_NEW,
                                     W_LEN)
    _, counts, waves, rounds, _ = serve_counted(
        engine, token_requests(spec, SEED, N_REQUESTS, W_LENS, W_NEW),
        token_requests(spec, 1000, BATCH, W_LENS, 4), "whisper", card)
    check((waves, rounds) == (waves_p, rounds_p),
          f"[whisper] {waves} waves and {rounds} rounds, the CPU schedule "
          f"{waves_p} and {rounds_p}")
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    check_counts("whisper", counts, {
        "flash_attention": (Le + 2 * Ld) * waves + Ld * rounds,
        attn_ops.GLOBAL_COUNT: Ld * waves,
        attn_ops.CROSS_COUNT: Ld * waves + Ld * rounds,
        attn_ops.F32_COUNT: Ld * rounds,
        "decode_attention": Ld * rounds})
    token_stream(engine, "whisper", card, W_STREAM, 78)
    encdec_model_check(arch, params, dev)
    del engine, params
    free_card()
    return whisper_records(cfg, counts, gen, dev)


def cross_grad_check(shape, sk, gen, dev):
    """The cross-attention with a gradient at whisper-base's training shape
    (B, Sq, H, Dh) over (B, sk, H, Dh) bf16: `FlashAttention` (the forward
    kernel once, the plain backward) against torch autograd through the
    plain version in f32: the output within 2 bf16 ulp, dq, dk, dv within
    1.  Returns (q, k, v, forward max abs err, timings)."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                                   attention_ref)
    B, Sq, H, Dh = shape
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, do = rnd(B, Sq, H, Dh), rnd(B, Sq, H, Dh)
    k, v = rnd(B, sk, H, Dh), rnd(B, sk, H, Dh)
    what = f"{tuple(shape)} over {sk} keys"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = kc.launches().get(attn_ops.CROSS_COUNT, 0)
    out = attn_ops.attention(*leaves, causal=False)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    check(kc.launches().get(attn_ops.CROSS_COUNT, 0) == n0 + 1
          and "FlashAttention" in type(out.grad_fn).__name__,
          f"[whisper-train] the cross gradient at {what} did not run the "
          "forward kernel once inside FlashAttention")
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = attention_ref(*ref_leaves, causal=False)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    torch.cuda.synchronize()
    err_fwd = max_err(out.detach(), ref_out.detach())
    ulp_fwd = ulp_err(out.detach(), ref_out.detach().to(torch.bfloat16))
    log(f"[whisper-train] cross-attention output at {what}, bf16: max "
        f"{ulp_fwd:.2f} bf16 ulp (tol 2), max abs err {err_fwd:.3e}")
    check(bool(torch.isfinite(out).all()) and ulp_fwd <= 2,
          f"[whisper-train] cross flash_attention beyond tolerance at {what}")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        ulps = ulp_err(a, b.to(torch.bfloat16))
        log(f"[whisper-train] cross-attention gradient {name} at {what}: "
            f"max {ulps:.2f} bf16 ulp (tol 1), max abs err / max|g| "
            f"{max_err(a, b) / float(b.abs().max()):.3e}")
        check(bool(torch.isfinite(a).all()) and ulps <= 1,
              f"[whisper-train] cross gradient {name} beyond tolerance")
    del ref_leaves, ref_out, want, got, out
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sl = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    doh = do.transpose(1, 2).contiguous()
    times = dict(
        plain_bwd_ms=time_ms(lambda: attention_bwd_ref(
            q, k, v, do, causal=False), 10)[0],
        function_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
            attn_ops.attention(*leaves, causal=False), leaves, do), 10)[0],
        sdpa_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
            sdpa(*sl), sl, doh), 10)[0])
    log(f"[whisper-train] cross-attention at {what}: plain backward "
        f"{times['plain_bwd_ms']:.5f} ms; the Function forward + backward "
        f"{times['function_fwd_bwd_ms']:.5f} ms; SDPA forward + backward "
        f"{times['sdpa_fwd_bwd_ms']:.5f} ms (device ms)")
    return q, k, v, err_fwd, times


def train_counted(name: str, spec, steps: int, batch: int, seq: int,
                  want_step: dict, card: str, trace: Path | None = None):
    """`launch.train.train_lm` on `spec` (full width, bf16, remat on) for
    `steps` steps at batch x seq tokens, each step timed by `on_step`
    (the last one traced, its kernels into `trace`, where given): finite
    losses that fall (mean of the last 3 below the first 3), the launches
    `want_step` a step.  Returns (losses, launches, peak GiB, median step
    ms)."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.launch.train import train_lm
    from repro_torch.models.transformer import param_list
    watch = StepClock(traced=steps if trace else None)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launches()
    t0 = time.perf_counter()
    run = train_lm(lm_train_args(name, steps=steps, batch=batch,
                                 seq_len=seq), spec=spec, on_step=watch)
    counts = kc.launches()
    peak = torch.cuda.max_memory_allocated() / GIB
    n_params = sum(t.numel() for t in param_list(run["params"]))
    del run
    free_card()
    losses = [float(m["loss"]) for m in watch.metrics]
    med = 1e3 * float(np.median(watch.step_seconds(1)))
    log(f"[{name}] train_lm full width ({n_params} params, bf16, remat "
        f"on), batch {batch} x {seq} tokens, {len(losses)} steps in "
        f"{time.perf_counter() - t0:.2f}s (init included): loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} (every 5th: "
        f"{[round(x, 5) for x in losses[::5]]}); median step {med:.3f} ms, "
        f"{batch * seq / med * 1e3:.1f} tokens/s; peak memory {peak:.3f} "
        f"GiB allocated ({card})")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"[{name}] train_lm: a loss is not finite, or steps are missing")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"[{name}] train_lm: the loss did not fall")
    check_counts(f"{name} train", counts,
                 {k: n * steps for k, n in want_step.items()})
    if trace:
        wall, busy, n_events = watch.traced_step(trace)
        log(f"[{name}] one traced step: wall {1e3 * wall:.3f} ms, device "
            f"busy {1e3 * busy:.3f} ms ({100 * busy / wall:.1f}% busy), "
            f"{n_events} device events; kernels by device time in "
            f"chiprun_out/{trace.name} ({card})")
    return losses, counts, peak, med


def whisper_train(dev, card, gen):
    """The cross-attention gradient at the training shape, then `train_lm`
    on whisper-base (full width, frames drawn each step): 36
    flash_attention launches a step (forward and remat recompute: 6
    encoder DiT-form, 6 causal and 6 cross a pass)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    spec = get_arch(WHISPER)
    cfg = spec.cfg
    shape = (W_TRAIN_BATCH, W_TRAIN_SEQ, cfg.n_heads, cfg.d_head)
    q, k, v, err, times = cross_grad_check(shape, cfg.n_audio_ctx, gen, dev)
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    _, counts, peak, med = train_counted(
        WHISPER, spec, W_TRAIN_STEPS, W_TRAIN_BATCH, W_TRAIN_SEQ,
        {"flash_attention": 2 * (Le + 2 * Ld), attn_ops.GLOBAL_COUNT: 2 * Ld,
         attn_ops.CROSS_COUNT: 2 * Ld}, card)
    from repro_torch.kernels.attention.ref import attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    rec = timed_record(
        "flash_attention[train,cross,whisper-base]",
        f"train_lm {WHISPER}, batch {W_TRAIN_BATCH} x {W_TRAIN_SEQ}",
        "src/repro_torch/csrc/attention.cu",
        "src/repro/kernels/attention/kernel.py:109",
        counts.get(attn_ops.CROSS_COUNT, 0), err,
        lambda: attn_ops.flash_attention_cross(q, k, v),
        f"flash_lm_wgmma_kernel<{cfg.d_head}, false",
        lambda: attention_ref(q, k, v, causal=False),
        2 * (2 * q.numel() + 2 * k.numel()),
        4 * q.shape[0] * q.shape[1] * k.shape[1] * cfg.n_heads * cfg.d_head,
        BF16_FLOPS, library_fn=lambda: sdpa(qh, kh, vh))
    rec.update(times, step_ms=med, peak_gib=peak)
    return [rec]


def moe_layer_check(name: str, p, mcfg, act: str, x) -> None:
    """One full-width MoE layer of `name` (the served bf16 params `p`) on
    x (B, S, D) bf16 on the card against a plain f32 version on the CPU
    on the same values: the routing (expert ids, the choices dropped for
    capacity) identical, the output within MOE_TOL of scale.  The CPU
    side routes with the f32 router and sums each token's kept choices,
    gate times expert MLP, in f32 from the experts' weights (only those
    chosen are copied over)."""
    from repro_torch.models import common
    kw = dict(top_k=mcfg.top_k, capacity_factor=mcfg.capacity_factor)
    B, S, D = x.shape
    idx_d, kept_d = common.moe_routing(p, x, impl=mcfg.impl, **kw)
    out_d = common.MOE_IMPLS[mcfg.impl](p, x, act=act, **kw)
    torch.cuda.synchronize()
    router = p["router"].cpu()
    xc = x.float().cpu()
    idx, kept = common.moe_routing({"router": router}, xc, impl=mcfg.impl,
                                   **kw)
    gate, _ = common.moe_route({"router": router}, xc.reshape(-1, D),
                               mcfg.top_k)
    xt = xc.reshape(-1, D)
    out = torch.zeros_like(xt)
    used = sorted(set(idx[kept].tolist()))
    for e in used:
        rows, cols = torch.nonzero((idx == e) & kept, as_tuple=True)
        wg, wu, wd = (p[n][e].float().cpu() for n in
                      ("w_gate", "w_up", "w_down"))
        xr = xt[rows]
        y = (common.activation(act, xr @ wg) * (xr @ wu)) @ wd
        out.index_add_(0, rows, gate[rows, cols][:, None] * y)
    if "shared" in p:
        out += common.mlp_apply({k: t.float().cpu() for k, t in
                                 p["shared"].items()}, xt, act)
    cap = common.moe_capacity(B * S, mcfg.top_k, mcfg.n_experts,
                              mcfg.capacity_factor)
    same_idx = torch.equal(idx_d.cpu(), idx)
    same_kept = torch.equal(kept_d.cpu(), kept)
    err = max_err(out_d.reshape(-1, D).cpu(), out) / float(out.abs().max())
    log(f"[moe] {name} MoE layer ({mcfg.impl}, {mcfg.n_experts} experts, "
        f"top {mcfg.top_k}, cap {cap}) on {tuple(x.shape)}, card bf16 vs CPU "
        f"f32: expert ids identical {same_idx}, drops identical "
        f"{same_kept} ({int((~kept).sum())} of {kept.numel()} choices "
        f"dropped, {len(used)} experts used); output max abs err / max|y| "
        f"{err:.3e} (tol {MOE_TOL})")
    check(same_idx and same_kept, f"[moe] {name}: the card's routing "
          "differs from the CPU's")
    check(math.isfinite(err) and err <= MOE_TOL,
          f"[moe] {name}: the MoE layer's output beyond tolerance")


def moe_serve(name: str, dev, card, gen, *, n, lens, max_new, max_len):
    """`name` at full width, its depth cut to MOE_LAYERS[name], on a
    batch-BATCH TokenEngine: n requests, the launches gated against the
    CPU schedule, one MoE layer card vs CPU at a prefill and a decode
    shape, then the records of its (Hq, Hkv, Dh)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models.registry import Arch
    from repro_torch.models.transformer import param_list
    from repro_torch.serve import TokenEngine
    free_card()
    spec = depth_cut(name, get_arch(name), MOE_LAYERS[name])
    arch, cfg = Arch(spec), spec.cfg
    t0 = time.perf_counter()
    params = arch.init(seed=SEED, device=dev)
    engine = TokenEngine(arch, params, batch_size=BATCH, max_len=max_len,
                         eos_id=-1, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in param_list(params))
    n_moe = sum(cfg.is_moe(i) for i in range(cfg.n_layers))
    log(f"[moe] {name}: {n_params} params ({n_moe} MoE layers of "
        f"{cfg.moe.n_experts} experts, top {cfg.moe.top_k}, "
        f"{cfg.moe.impl} dispatch) drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / GIB:.2f} GiB allocated")
    waves_p, rounds_p = cpu_schedule(name, n, lens, max_new, max_len)
    _, counts, waves, rounds, _ = serve_counted(
        engine, token_requests(spec, SEED, n, lens, max_new),
        token_requests(spec, 1000, BATCH, lens, 2), f"moe {name}", card)
    check((waves, rounds) == (waves_p, rounds_p),
          f"[moe] {name}: {waves} waves and {rounds} rounds, the CPU "
          f"schedule {waves_p} and {rounds_p}")
    Ln = cfg.n_layers
    check_counts(f"moe {name}", counts, {
        "flash_attention": Ln * waves, attn_ops.GLOBAL_COUNT: Ln * waves,
        "decode_attention": Ln * rounds})
    layer = next(i for i in range(cfg.n_layers) if cfg.is_moe(i))
    p = params["layers"][layer]["moe"]
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(cfg.dtype)
    for shape in ((1, lens[-1] if name == QWEN else 16, cfg.d_model),
                  (BATCH, 1, cfg.d_model)):
        moe_layer_check(name, p, cfg.moe, cfg.act, rnd(*shape))
    del engine, params, p
    free_card()
    return lm_records(cfg, counts, gen, dev, path=f"TokenEngine {name}",
                      prompts=lens, max_len=max_len, windows=(None,),
                      tag=name)


def reduced_moe_check() -> None:
    """The reduced qwen3-moe and llama4 (f32, each in the sorted dispatch
    its full config runs) with the same seeded weights on the card and on
    the CPU: a TokenEngine serve of 6 requests gives equal token
    streams."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import Arch
    from repro_torch.serve import TokenEngine
    for name in (QWEN, LLAMA4):
        spec = get_arch(name, reduced=True)
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, moe=dataclasses.replace(spec.cfg.moe, impl="sorted")))
        arch = Arch(spec)
        params = arch.init(seed=3, device="cpu")
        reqs = token_requests(spec, 60, 6, (20, 9), 8)
        out = {d: TokenEngine(arch, params, batch_size=3, max_len=32,
                              device=d).serve(reqs) for d in ("cuda", "cpu")}
        same = all(np.array_equal(out["cuda"][r.rid], out["cpu"][r.rid])
                   for r in reqs)
        log(f"[moe] reduced {name} (sorted dispatch), card vs CPU: token "
            f"streams of {len(reqs)} requests equal: {same}")
        check(same, f"[moe] reduced {name}: token streams on the card "
              "differ from the CPU")


def encdec_moe_phase(dev, card, gen):
    """Phase 10: `[whisper]` serve, `[whisper-train]`, `[moe]` (qwen3-moe
    served and trained, llama4 served), each phase's weights freed before
    the next.  Returns the kernels-line records."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    t_phase = time.perf_counter()
    records = whisper_serve(dev, card, gen)
    log(f"[whisper] phase {time.perf_counter() - t_phase:.2f}s")
    t0 = time.perf_counter()
    records += whisper_train(dev, card, gen)
    log(f"[whisper-train] phase {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    records += moe_serve(QWEN, dev, card, gen, n=N_REQUESTS, lens=Q_LENS,
                         max_new=Q_NEW, max_len=Q_LEN)
    records += moe_serve(LLAMA4, dev, card, gen, n=BATCH,
                         lens=(L4_PROMPT, L4_PROMPT), max_new=L4_ROUNDS + 1,
                         max_len=L4_LEN)
    reduced_moe_check()
    log(f"[moe] reduced: {QWEN} trained at {MOE_TRAIN_LAYERS} of 48 layers "
        f"(one card: AdamW keeps f32 m, v and masters, 12 bytes a param "
        f"beside the bf16 params and grads)")
    spec = get_arch(QWEN)
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, n_layers=MOE_TRAIN_LAYERS))
    _, _, peak, med = train_counted(
        QWEN, spec, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
        {"flash_attention": 2 * MOE_TRAIN_LAYERS,
         attn_ops.GLOBAL_COUNT: 2 * MOE_TRAIN_LAYERS}, card)
    log(f"[moe] phase {time.perf_counter() - t0:.2f}s; {QWEN} training "
        f"peak {peak:.3f} GiB, median step {med:.3f} ms ({card})")
    log(f"[whisper/moe] phase 10: {time.perf_counter() - t_phase:.2f}s")
    return records


# ---- rwkv / zamba: the recurrent-state families -------------------------------
RWKV, ZAMBA = "rwkv6-7b", "zamba2-2.7b"
RZ_TAGS = {RWKV: "rwkv", ZAMBA: "zamba"}
# both served with gemma3-1b's list: N_REQUESTS at batch BATCH, prompts of
# LM_LENS by turns, LM_MAX_NEW new, caches of LM_MAX_LEN; their streams
# W_STREAM (distinct short prompts; the fifth, urgent, preempts)
# trained at the depth that fits one card: the AdamW update holds ~32
# bytes a param at its peak (bf16 params and grads; f32 m, v, masters; its
# f32 temporaries of the grads, the moments' quotients and the decay)
RZ_TRAIN_STEPS = 10
ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ = 36, 4, 1024
RWKV_TRAIN_LAYERS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ = 6, 4, 256
TRAIN_WHY = ("one card: the AdamW update holds ~32 bytes a param at its "
             "peak (bf16 params and grads; f32 m, v, masters and the "
             "update's f32 temporaries): {full:.0f} GB at {n} layers, "
             "{cut:.0f} GB at {k}")


def round_trace(engine, tag: str, card: str, rounds: int = 5) -> None:
    """What a decode round costs the host: `rounds` round steps on the
    engine's state after a serve (every slot retired: the rows' writes
    are row-local garbage that the next admission overwrites) under a
    CUPTI trace; device events a round (a lower bound: CUPTI may drop a
    trace's first events), device busy against wall; the kernels by
    device time into chiprun_out/round_profile_<tag>.txt."""
    args = (engine.params, engine.state, engine.caches, engine.eos_id)
    engine._decode(*args, memory=engine.memory)             # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            engine._decode(*args, memory=engine.memory)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    log(f"[{tag}] {rounds} traced decode rounds: {len(events) / rounds:.1f} "
        f"device events a round, wall {1e3 * wall / rounds:.3f} ms a round, "
        f"device busy {1e3 * busy / rounds:.3f} ms ({100 * busy / wall:.1f}% "
        f"busy) ({card})")
    (ROOT / "chiprun_out" / f"round_profile_{tag}.txt").write_text("".join(
        f"{us:.1f}\t{k}\n" for k, us in sorted(by_name.items(),
                                                key=lambda kv: -kv[1])))


def recurrent_serve(name: str, dev, card, gen):
    """`name` at full width and depth on a batch-BATCH TokenEngine (bf16):
    gemma3-1b's request list, the waves and rounds of the reduced config's
    CPU schedule, the attention launches (rwkv none; zamba one causal
    flash_attention a group a wave, one decode_attention a group a
    round), tokens/s after a warm-up, the stream with a preemption; for
    zamba the model with the kernels against the plain attention and the
    head-width-80 records.  Returns (records, tokens/s)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models.registry import Arch
    from repro_torch.models.transformer import param_list
    from repro_torch.serve import TokenEngine
    free_card()
    tag = RZ_TAGS[name]
    t0 = time.perf_counter()
    spec = get_arch(name)
    arch, cfg = Arch(spec), spec.cfg
    params = arch.init(seed=SEED, device=dev)
    engine = TokenEngine(arch, params, batch_size=BATCH, max_len=LM_MAX_LEN,
                         eos_id=-1, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in param_list(params))
    state = sum(t.numel() * t.element_size()
                for t in param_list(engine.caches)) / GIB
    log(f"[{tag}] {name}: {n_params} params drawn on the card "
        f"(param_count() {cfg.param_count()}), {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}; caches "
        f"{state:.3f} GiB at batch {BATCH} x {LM_MAX_LEN}; "
        f"{torch.cuda.memory_allocated() / GIB:.2f} GiB allocated: "
        f"{time.perf_counter() - t0:.2f}s; reduced: none")
    waves_p, rounds_p = cpu_schedule(name, N_REQUESTS, LM_LENS, LM_MAX_NEW,
                                     LM_MAX_LEN)
    _, counts, waves, rounds, dt = serve_counted(
        engine, token_requests(spec, SEED, N_REQUESTS, LM_LENS, LM_MAX_NEW),
        token_requests(spec, 1000, BATCH, LM_LENS, 4), tag, card)
    rate = N_REQUESTS * LM_MAX_NEW / dt
    check((waves, rounds) == (waves_p, rounds_p),
          f"[{tag}] {waves} waves and {rounds} rounds, the CPU schedule "
          f"{waves_p} and {rounds_p}")
    G = getattr(cfg, "n_groups", 0)
    check_counts(tag, counts, {
        "flash_attention": G * waves, attn_ops.GLOBAL_COUNT: G * waves,
        "decode_attention": G * rounds})
    widths = list(engine.prefill_widths)[-waves:]
    round_trace(engine, tag, card)
    token_stream(engine, tag, card, W_STREAM, 79)
    records = []
    if G:
        lm_model_check(arch, params, dev, name=tag)
        log(f"[{tag}] admission wave widths {widths}; records at the widest")
        del engine, params
        free_card()
        records = lm_records(cfg, counts, gen, dev, path=f"TokenEngine {name}",
                             windows=(None,), tag=name, wave=max(widths))
    else:
        del engine, params
    free_card()
    return records, rate


def train_depth(name: str, spec, layers: int):
    """`spec` cut to `layers` (printed as `reduced`, with its reason)."""
    full = spec.cfg.param_count() * 32 / 1e9
    cut = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, n_layers=layers))
    log(f"[rz-train] reduced: {name} trained at {layers} of "
        f"{spec.cfg.n_layers} layers (" + TRAIN_WHY.format(
            full=full, n=spec.cfg.n_layers,
            cut=cut.cfg.param_count() * 32 / 1e9, k=layers)
        + "); widths, heads and vocab as published")
    return cut


def recurrent_train(dev, card, gen):
    """The causal gradient at zamba2-2.7b's training shape (4, 1024, 32,
    80) within 2 bf16 ulp of autograd through the plain version, then
    `train_lm` on zamba2-2.7b at ZAMBA_TRAIN_LAYERS layers (batch 4 x
    1024: 2 flash_attention launches a group a step, the forward and the
    remat recompute) and on rwkv6-7b at RWKV_TRAIN_LAYERS (batch 4 x 256:
    no attention launch), the last step of each traced, each loss
    falling.  Returns the training record."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    spec = get_arch(ZAMBA)
    cfg = spec.cfg
    shape = (ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, cfg.n_heads, cfg.d_head)
    q, k, v, err, times, kw = lm_grad_check(shape, cfg.n_kv_heads, None, gen,
                                            dev)
    spec = train_depth(ZAMBA, spec, ZAMBA_TRAIN_LAYERS)
    G = spec.cfg.n_groups
    _, counts, peak, med = train_counted(
        ZAMBA, spec, RZ_TRAIN_STEPS, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ,
        {"flash_attention": 2 * G, attn_ops.GLOBAL_COUNT: 2 * G}, card,
        trace=ROOT / "chiprun_out" / "train_zamba_profile.txt")
    rec = lm_train_record(
        f"flash_attention[train,{ZAMBA}]",
        f"train_lm {ZAMBA} ({ZAMBA_TRAIN_LAYERS} layers), batch "
        f"{ZAMBA_TRAIN_BATCH} x {ZAMBA_TRAIN_SEQ}",
        q, k, v, None, counts.get("flash_attention", 0), err, times, kw)
    rec.update(step_ms=med, peak_gib=peak)
    del q, k, v
    rspec = train_depth(RWKV, get_arch(RWKV), RWKV_TRAIN_LAYERS)
    train_counted(RWKV, rspec, RZ_TRAIN_STEPS, RWKV_TRAIN_BATCH,
                  RWKV_TRAIN_SEQ, {"flash_attention": 0}, card,
                  trace=ROOT / "chiprun_out" / "train_rwkv_profile.txt")
    return rec


def recurrent_phase(dev, card, gen):
    """Phase 11: `[rwkv]` and `[zamba]` served, `[rz-train]`, the reduced
    configs card vs CPU.  Returns the kernels-line records."""
    t_phase = time.perf_counter()
    _, rwkv_rate = recurrent_serve(RWKV, dev, card, gen)
    log(f"[rwkv] phase {time.perf_counter() - t_phase:.2f}s")
    t0 = time.perf_counter()
    records, zamba_rate = recurrent_serve(ZAMBA, dev, card, gen)
    log(f"[zamba] phase {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    records.append(recurrent_train(dev, card, gen))
    for name in (RWKV, ZAMBA):                   # prefill over 2 chunks
        reduced_lm_check(name, prompt=40, max_len=64)
    log(f"[rz-train] phase {time.perf_counter() - t0:.2f}s")
    log(f"[rwkv/zamba] phase 11: {time.perf_counter() - t_phase:.2f}s; "
        f"served {rwkv_rate:.1f} ({RWKV}) and {zamba_rate:.1f} ({ZAMBA}) "
        f"tokens/s ({card})")
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda as kc
    from repro_torch.launch.serve import parse_sampler_spec

    t_start = time.perf_counter()
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
            if "Compiling entry" in line:
                log(f"  ptxas[{name}] {kernel_label(line.split(chr(39))[1])}")
            elif "Used" in line or "spill" in line:
                log(f"  ptxas[{name}]   {line.strip()}")

    # ---- 2. the kernel's noise draw against the plain PRNG --------------
    keys64, keys, kcs, algs = noise_inputs(dev)
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
    for name, (spec, net, engine, counts, _) in paths.items():
        x = slot_inputs(engine, mix, dev, gen)
        records += round_records(name, engine, x, keys, counts,
                                 streamed=name == "cifar10-bdm", card=card)
        records.append(attention_record(name, spec, net, counts, gen, dev))
    bdm_counts = paths["cifar10-bdm"][3]
    floor = launch_floor_ms()
    log(f"launch floor: PyTorch's fill of a one-element tensor, median "
        f"traced launch {floor:.5f} ms ({card})")
    records += dct_records(bdm_counts, gen, dev, floor)
    from repro_torch.kernels.round_fused import ops as rf
    from repro_torch.kernels.round_fused import ref as rf_ref
    n = 3072
    cfgs = torch.arange(BATCH, dtype=torch.int32, device=dev)
    records.append(timed_record(
        "step_noise", "cifar10-bdm", "src/repro_torch/csrc/round_fused.cu",
        "src/repro/kernels/round_fused/kernel.py:110",
        bdm_counts.get("step_noise", 0), err_noise,
        lambda: rf.step_noise_kernel(keys, kcs, cfgs, algs, n=n),
        "step_noise_kernel",
        lambda: rf_ref.draw_step_noise(keys, kcs, algs, (n,)),
        # keys, kc, cfg and alg[cfg] a slot in, the draw out
        4 * (BATCH * (2 + 1 + 1 + 1) + BATCH * n), 0, F32_FLOPS))

    records += lm_records(lm_engine.arch.cfg, lm_counts, gen, dev)
    lm_model_check(lm_engine.arch, lm_engine.params, dev)
    names = [r["name"] for r in records]
    check("flash_attention" in names and any(
        n.startswith("flash_attention[causal") for n in names),
        "the kernels record lacks a form of flash_attention")

    # ---- 5. path A: the lockstep sampler; path B: the pre-fusion step ----
    t_new = time.perf_counter()
    path_a = {name: drive_path_a(name, dev, card, out_dir)
              for name in PATH_A}
    # every path-A eval runs the DiT's attention at batch A_N
    cfg = path_a[PATH_A[0]][0].score_cfg
    check(all((s.score_cfg.n_heads, s.score_cfg.n_tokens, s.score_cfg.d_head)
              == (cfg.n_heads, cfg.n_tokens, cfg.d_head)
              for s, _, _ in path_a.values()), "path A's DiTs differ in "
          "attention shape")
    att = attention_check("path A", cfg, A_N, gen, dev)
    records.append(attention_timed(
        f"flash_attention[n={A_N}]", "path A (ddpm, cld, bdm)", *att[:3],
        sum(r["counts"].get("flash_attention", 0)
            for _, _, runs in path_a.values() for r in runs), att[3]))
    b_counts = {name: drive_path_b(name, paths[name], mix, card)
                for name in PATH_B_KERNELS}
    records += ei_records(path_a, b_counts, gen, dev, floor)
    for rec in records:
        if rec["name"] == "bdm_ei_update":
            rec.update(path="cifar10-bdm (path A; timed at B = 4)",
                       launches=sum(r["counts"].get("bdm_ei_update", 0)
                                    for r in path_a["cifar10-bdm"][2]))
    quality_check(path_a["cifar10-cld"][0].sde, dev)
    covered = {r["replaces"] for r in records}
    check(set(TPU_KERNELS) <= covered, "the kernels record lacks "
          f"{sorted(set(TPU_KERNELS) - covered)}")
    log(f"paths A and B, the ei_update records and the quality check: "
        f"{time.perf_counter() - t_new:.2f}s")

    # ---- 6. train + likelihood: the training path at full width ----------
    records.append(train_phase(paths["cifar10-cld"][0], dev, card, gen))

    # ---- 7. reduced configs: the card vs the plain version on the CPU ----
    for name in PATH_KERNELS:
        reduced_check(name, mix)
    for name in PATH_A:
        reduced_sample_check(name, sde=path_a[name][0].sde
                             if name == "cifar10-cld" else None)
    reduced_lm_check()

    # ---- 8. stream: online serving, the precision classes, the router ---
    records += stream_phase(paths, lm_engine, mix, dev, card, gen)

    # ---- 9. lm-train: LM training and the dense configs served, on a card
    # freed of the earlier paths' nets and engines -------------------------
    del paths, path_a, lm_engine, lm_serve, att
    records += lm_train_phase(dev, card, gen)

    # ---- 10. whisper, whisper-train, moe: the encoder-decoder and the MoE
    # transformers, each phase's weights freed before the next -------------
    records += encdec_moe_phase(dev, card, gen)

    # ---- 11. rwkv, zamba, rz-train: the recurrent-state families --------
    records += recurrent_phase(dev, card, gen)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")
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
