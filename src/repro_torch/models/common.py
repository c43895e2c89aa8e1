"""Shared neural components: initializers, norms, rotary embedding, the
(gated) MLP, the mixture-of-experts layer in its three dispatch forms,
the attention block with its two KV-cache branches and its cross-
attention source, and the causal-LM loss.

Parameters keep the JAX package's orientation: a dense weight is
(d_in, d_out) and is applied as `x @ W`.  Norms compute in f32 and cast
back to the activation dtype, as in the JAX package.  Attention dispatches
through `kernels.attention.ops` and, for one-token decode against a
per-slot cache, through `kernels.decode_attention.ops` (the plain version
on a CPU tensor, the CUDA kernel on a CUDA tensor).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.attention import ops as attn_ops
from ..kernels.decode_attention import ops as decode_ops

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# initializers (the JAX package's scales; torch.Generator draws)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, device="cpu") -> Tensor:
    """N(0, 1/d_in) weight (or N(0, scale^2)), drawn in f32 then cast.  The
    draw happens on the generator's device and lands on `device`."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device="cpu") -> Tensor:
    """N(0, 0.02^2) embedding table (vocab, d)."""
    return dense_init(gen, vocab, d, dtype, 0.02, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor,
               eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis in f32 (biased variance, like
    `jnp.var`), cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], gamma.float(), beta.float(),
                        eps).to(x.dtype)


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm in f32 with the (1 + gamma) scale (gamma zero at init), cast
    back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(d_head: int, theta: float = 10000.0) -> np.ndarray:
    """float64 inverse frequencies, (d_head / 2,)."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))


@functools.lru_cache(maxsize=None)
def _freqs_on(d_head: int, theta: float, device: str) -> Tensor:
    # one upload per (width, theta, device): a pageable host->device copy
    # inside a decode round would stall the host on the card's queue
    return torch.from_numpy(
        rope_frequencies(d_head, theta).astype(np.float32)).to(device)


def rope_table(positions: Tensor, d_head: int,
               theta: float = 10000.0) -> Tuple[Tensor, Tensor]:
    """(cos, sin) of the rotary angles of `positions` ((B, S) or (S,)),
    each (B, S, 1, Dh/2): angles in f32 from the float64 frequencies cast
    to f32, in the JAX package's order.  Every layer of a step shares one
    table, so a forward computes it once."""
    freqs = _freqs_on(d_head, float(theta), str(positions.device))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # (B, S, Dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: Tensor, table: Tuple[Tensor, Tensor]) -> Tensor:
    """x: (B, S, H, Dh) rotated by `rope_table`'s (cos, sin): the two
    halves of the head (not interleaved pairs), in f32."""
    cos, sin = table
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations and MLP
# ---------------------------------------------------------------------------
def activation(name: str, x: Tensor) -> Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                 # jax.nn.gelu's default: tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu2":                # squared ReLU (Primer / nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, dtype,
               gated: bool = True, device="cpu") -> Params:
    """w_up (d_model, d_ff), w_down (d_ff, d_model), and w_gate like w_up
    when `gated`, at the JAX init's scales."""
    init = lambda a, b: dense_init(gen, a, b, dtype, None, device)
    p = {"w_up": init(d_model, d_ff), "w_down": init(d_ff, d_model)}
    if gated:
        p["w_gate"] = init(d_model, d_ff)
    return p


def mlp_apply(p: Params, x: Tensor, act: str = "silu") -> Tensor:
    """up -> activation -> down; gated (act(x W_gate) * x W_up) when the
    params carry `w_gate`."""
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = activation(act, x @ p["w_gate"]) * up
    else:
        up = activation(act, up)
    return up @ p["w_down"]


# ---------------------------------------------------------------------------
# mixture of experts (top-k routing), the JAX package's three dispatch forms
# ---------------------------------------------------------------------------
# Plain PyTorch, as the JAX package computes them outside any Pallas kernel:
# routing in f32, the expert products batched over experts (`bmm` /
# `einsum`).  Every form gives the JAX numbers' semantics exactly, drops
# included:
#
#   * top-k breaks ties toward the lower expert id, as `jax.lax.top_k`
#     does (a stable descending sort; `torch.topk` promises no order);
#   * the capacity max(1, int(capacity_factor * N * k / E)) counts every
#     row the layer is given, padded and inactive ones too;
#   * "capacity" (GShard) counts each of the k choices' positions in its
#     own pass, so the (expert, slot) of a first choice and of a second
#     may coincide: their tokens are summed into one expert input, as the
#     JAX dispatch einsum sums them;
#   * "sorted" orders the (token, choice) pairs by expert with a stable
#     sort, keeps the first `cap` of each expert's run, and adds each
#     token's kept contributions in ascending expert order, from zeros, in
#     x's dtype — the order JAX's `.at[tok].add` takes — by gathers and
#     adds, not by `index_add_`, whose atomics on the card would sum in an
#     order that changes from run to run.
def _expert_stack(gen, n: int, d_in: int, d_out: int, dtype,
                  device) -> Tensor:
    """(n, d_in, d_out) N(0, 1/d_in) experts drawn in f32 and cast, a few
    experts at a time: the f32 draw of a whole stack at full width
    (llama4's (128, 5120, 8192): 21.5 GB) would not fit beside it."""
    out = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    chunk = max(1, (1 << 28) // (d_in * d_out))
    for e in range(0, n, chunk):
        m = min(chunk, n - e)
        w = torch.randn((m, d_in, d_out), generator=gen,
                        dtype=torch.float32, device=gen.device)
        out[e:e + m] = (w / math.sqrt(d_in)).to(device=device, dtype=dtype)
    return out


def moe_params(gen: torch.Generator, d_model: int, d_ff: int,
               n_experts: int, dtype, n_shared: int = 0,
               d_ff_shared: Optional[int] = None, device="cpu") -> Params:
    """The router (d_model, E) in f32 whatever the dtype, the experts'
    w_gate / w_up (E, d_model, d_ff) and w_down (E, d_ff, d_model), and
    with `n_shared` a gated shared expert of d_ff_shared (or d_ff *
    n_shared), at the JAX init's scales."""
    p = {"router": dense_init(gen, d_model, n_experts, torch.float32, None,
                              device),
         "w_gate": _expert_stack(gen, n_experts, d_model, d_ff, dtype,
                                 device),
         "w_up": _expert_stack(gen, n_experts, d_model, d_ff, dtype, device),
         "w_down": _expert_stack(gen, n_experts, d_ff, d_model, dtype,
                                 device)}
    if n_shared:
        p["shared"] = mlp_params(gen, d_model, d_ff_shared or d_ff * n_shared,
                                 dtype, device=device)
    return p


def moe_route(p: Params, xt: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """Token-choice routing of xt (N, D): (gate values (N, k) f32,
    renormalized to sum 1; expert ids (N, k) int64), the k most probable
    experts of softmax(x W_router) in f32, ties to the lower id."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx


def moe_capacity(n_rows: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert: max(1, int(capacity_factor * N * k / E))."""
    return max(1, int(capacity_factor * n_rows * top_k / n_experts))


def moe_routing(p: Params, x: Tensor, *, top_k: int, impl: str,
                capacity_factor: float = 1.25) -> Tuple[Tensor, Tensor]:
    """What the layer of form `impl` decides for x (B, S, D): (expert ids
    (N, k), kept (N, k) bool: false where the choice was dropped for
    capacity).  The dense form drops nothing."""
    xt = x.reshape(-1, x.shape[-1])
    _, idx = moe_route(p, xt, top_k)
    E = p["router"].shape[-1]
    cap = moe_capacity(xt.shape[0], top_k, E, capacity_factor)
    if impl == "dense":
        kept = torch.ones_like(idx, dtype=torch.bool)
    elif impl == "capacity":
        kept = torch.stack([_capacity_slot(idx[:, kk], E)[0] < cap
                            for kk in range(top_k)], dim=1)
    elif impl == "sorted":
        order, _, valid = _sorted_slots(idx, E, cap)
        kept = torch.empty_like(valid)
        kept[order] = valid
        kept = kept.reshape(idx.shape)
    else:
        raise ValueError(impl)
    return idx, kept


def moe_apply(p: Params, x: Tensor, *, top_k: int, act: str = "silu",
              capacity_factor: float = 1.25) -> Tensor:
    """Dense one-hot dispatch: every expert computes every token, masked
    to the tokens that chose it, combined by the gate values (no
    capacity).  (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    gate, idx = moe_route(p, x.reshape(B * S, D), top_k)
    onehot = F.one_hot(idx, E).float()                        # (N, k, E)
    combine = (onehot * gate[..., None]).sum(1).reshape(B, S, E)
    mask = (combine > 0).to(x.dtype)
    xe = mask.permute(2, 0, 1)[..., None] * x[None]           # (E, B, S, D)
    h = torch.einsum("ebsd,edf->ebsf", xe, p["w_gate"])
    h = activation(act, h) * torch.einsum("ebsd,edf->ebsf", xe, p["w_up"])
    y = torch.einsum("ebsf,efd->ebsd", h, p["w_down"])
    out = torch.einsum("ebsd,bse->bsd", y, combine.to(x.dtype))
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, act)
    return out


def _capacity_slot(e: Tensor, E: int) -> Tuple[Tensor, Tensor]:
    """For one choice column e (N,): (each token's position among the
    tokens that chose its expert in this column, the one-hot (N, E))."""
    oh = F.one_hot(e, E)
    pos = torch.cumsum(oh, dim=0) * oh - 1
    return pos.gather(1, e[:, None])[:, 0], oh


def moe_capacity_apply(p: Params, x: Tensor, *, top_k: int,
                       act: str = "silu",
                       capacity_factor: float = 1.25) -> Tensor:
    """GShard capacity dispatch: (tokens x experts x capacity) one-hot
    dispatch and combine; a choice past its expert's capacity is dropped
    (the residual passes through)."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    N = B * S
    cap = moe_capacity(N, top_k, E, capacity_factor)
    xt = x.reshape(N, D)
    gate, idx = moe_route(p, xt, top_k)
    dispatch = torch.zeros((N, E, cap), dtype=torch.bool, device=x.device)
    combine = torch.zeros((N, E, cap), dtype=torch.float32, device=x.device)
    for kk in range(top_k):
        slot, oh = _capacity_slot(idx[:, kk], E)
        ok = slot < cap
        slot_oh = F.one_hot(slot.clamp(max=cap - 1), cap).float() \
            * ok[:, None]
        d_k = oh.float()[:, :, None] * slot_oh[:, None, :]
        dispatch = dispatch | (d_k > 0)
        combine = combine + d_k * gate[:, kk][:, None, None]
    xe = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xt)
    h = torch.bmm(xe, p["w_gate"])
    h = activation(act, h) * torch.bmm(xe, p["w_up"])
    y = torch.bmm(h, p["w_down"])
    out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), y).reshape(B, S, D)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, act)
    return out


def _sorted_slots(idx: Tensor, E: int,
                  cap: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The sorted form's placement of the N k (token, choice) pairs, flat
    in token-major order: (the stable order by expert id, each sorted
    pair's slot eid * cap + position in its expert's run (E * cap where
    dropped), kept (sorted order))."""
    eid = idx.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    eid_s = eid[order]
    starts = torch.searchsorted(eid_s, torch.arange(E, device=eid.device))
    pos = torch.arange(eid.numel(), device=eid.device) - starts[eid_s]
    valid = pos < cap
    slot = torch.where(valid, eid_s * cap + pos,
                       torch.full_like(pos, E * cap))
    return order, slot, valid


def moe_sorted_apply(p: Params, x: Tensor, *, top_k: int, act: str = "silu",
                     capacity_factor: float = 1.25) -> Tensor:
    """Sort-based dispatch: the (token, choice) pairs sorted by expert,
    the first `cap` of each expert's run gathered into an (E, cap, D)
    buffer, batched expert products, then each token's kept
    contributions gathered back and added in ascending expert order."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    N = B * S
    cap = moe_capacity(N, top_k, E, capacity_factor)
    xt = x.reshape(N, D)
    gate, idx = moe_route(p, xt, top_k)
    order, slot, valid = _sorted_slots(idx, E, cap)
    tok_s = order // top_k                                   # owning token
    gv_s = gate.reshape(-1)[order]
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xt[tok_s])        # dropped -> the last row
    xe = buf[:-1].reshape(E, cap, D)
    h = torch.bmm(xe, p["w_gate"])
    h = activation(act, h) * torch.bmm(xe, p["w_up"])
    y = torch.bmm(h, p["w_down"]).reshape(E * cap, D)
    contrib = torch.where(valid, gv_s, 0.0).to(x.dtype)[:, None] \
        * y[slot.clamp(max=E * cap - 1)]
    # each token's k pairs in sorted (= ascending expert) order
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel(), device=x.device)
    where = where.reshape(N, top_k).sort(dim=1).values
    out = torch.zeros((N, D), dtype=x.dtype, device=x.device)
    for kk in range(top_k):
        out = out + contrib[where[:, kk]]
    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, act)
    return out


MOE_IMPLS = {"dense": moe_apply, "capacity": moe_capacity_apply,
             "sorted": moe_sorted_apply}


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------
def attn_params(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                d_head: int, dtype, device="cpu") -> Params:
    init = lambda a, b, s=None: dense_init(gen, a, b, dtype, s, device)
    return {"wq": init(d_model, n_heads * d_head),
            "wk": init(d_model, n_kv * d_head),
            "wv": init(d_model, n_kv * d_head),
            "wo": init(n_heads * d_head, d_model,
                       1.0 / math.sqrt(n_heads * d_head))}


def decode_positions(seq_len: int, cache_len, device) -> Tensor:
    """Absolute positions of a (B, S) input decoded against a cache: a
    per-slot (B,) `cache_len` gives (B, S); a scalar (int or 0-d) gives
    (S,); None gives (S,) from zero."""
    ar = torch.arange(seq_len, device=device)
    if cache_len is None:
        return ar
    if torch.is_tensor(cache_len) and cache_len.dim() == 1:
        return cache_len[:, None].long() + ar[None]
    return ar + cache_len


def _project(x: Tensor, w: Tensor) -> Tensor:
    """x @ w in the promoted dtype of the two, as jnp's matmul promotes
    (the encoder-decoder's f32 memory against bf16 weights: f32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def attn_apply(p: Params, x: Tensor, *, n_heads: int, n_kv: int, d_head: int,
               causal: bool = True, window: Optional[int] = None,
               rope: Optional[Tuple[Tensor, Tensor]] = None,
               kv_cache: Optional[Tuple[Tensor, Tensor]] = None,
               cache_len=None,
               x_kv: Optional[Tensor] = None
               ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """Returns (out, new_kv); new_kv is the cache pair when one was given.

    `rope` is the (cos, sin) table of the rows' positions (`rope_table`);
    None applies no rotary embedding (the DiT, whisper's encoder and its
    cross-attention: the JAX package's rope_theta = 0).

    * `x_kv` (B, Sk, D): cross-attention, K and V projected from x_kv (in
      the dtype x_kv and the weights promote to: the f32 memory pool of
      the token engine gives f32 K/V under bf16 weights), no cache, no
      rotary embedding; the attention promotes q with them and returns
      q's dtype.
    * No cache: self-attention over x (the DiT passes causal=False).
    * Per-slot decode (x (B, 1, D), `cache_len` a (B,) tensor): row b's K/V
      is written at its own position cache_len[b], then one query per row
      attends its first cache_len[b] + 1 entries (`decode_attention`).
    * Prefill / shared position (`cache_len` a scalar): K/V written at
      cache_len, attention over the whole cache with q_offset = cache_len;
      the causal mask hides the unwritten tail.

    The caches are updated in place (the engine owns them; an in-place row
    write spares a copy of every layer's cache each round)."""
    B, Sq, _ = x.shape
    q = (x @ p["wq"]).reshape(B, Sq, n_heads, d_head)
    if x_kv is not None:
        if rope is not None or kv_cache is not None:
            raise ValueError("cross-attention takes no rotary embedding "
                             "and no cache")
        Sk = x_kv.shape[1]
        k = _project(x_kv, p["wk"]).reshape(B, Sk, n_kv, d_head)
        v = _project(x_kv, p["wv"]).reshape(B, Sk, n_kv, d_head)
        out = attn_ops.attention(q, k, v, causal=causal, window=window)
        return out.reshape(B, Sq, n_heads * d_head) @ p["wo"], None
    k = (x @ p["wk"]).reshape(B, Sq, n_kv, d_head)
    v = (x @ p["wv"]).reshape(B, Sq, n_kv, d_head)

    if rope is not None:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)

    per_slot = torch.is_tensor(cache_len) and cache_len.dim() == 1
    if kv_cache is not None and per_slot:
        if Sq != 1:
            raise ValueError("per-slot cache_len supports one-token decode "
                             f"only; got Sq={Sq}")
        ck, cv = kv_cache
        rows = torch.arange(B, device=x.device)
        idx = cache_len.long()
        ck[rows, idx] = k[:, 0].to(ck.dtype)
        cv[rows, idx] = v[:, 0].to(cv.dtype)
        out = decode_ops.decode_attention(q[:, 0], ck, cv, cache_len + 1,
                                          window=window)
        return out.reshape(B, Sq, n_heads * d_head) @ p["wo"], (ck, cv)

    if kv_cache is not None:
        ck, cv = kv_cache
        idx = int(cache_len) if cache_len is not None else ck.shape[1] - Sq
        ck[:, idx:idx + Sq] = k.to(ck.dtype)
        cv[:, idx:idx + Sq] = v.to(cv.dtype)
        k_full, v_full, q_off, new_cache = ck, cv, idx, (ck, cv)
    else:
        k_full, v_full, q_off, new_cache = k, v, 0, None
    # the GQA repeat is left to the attention (h -> h // rep), which gives
    # the numbers of the JAX package's repeat_kv: it is an exact broadcast
    out = attn_ops.attention(q, k_full, v_full, causal=causal, window=window,
                             q_offset=q_off)
    return out.reshape(B, Sq, n_heads * d_head) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def causal_lm_loss(logits: Tensor, labels: Tensor, ignore: int = -1) -> Tensor:
    """Mean cross-entropy over the positions whose label is not `ignore`:
    logits (B, S, V) upcast to f32, labels (B, S) int; the target logit is
    gathered at max(label, 0), and the sum is divided by max(count, 1), as
    in the JAX package."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.gather(logits32, -1,
                       labels.long().clamp_min(0)[..., None])[..., 0]
    valid = (labels != ignore).float()
    return torch.sum((lse - tgt) * valid) / torch.clamp_min(valid.sum(), 1.0)
