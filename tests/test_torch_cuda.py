"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU
mode), carries the `cuda` marker and skips without a card.  The file
imports torch only — no JAX — so it runs on the machine with the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tiers (kernel vs plain version on the same card):
  * round_fused / round_predict: k_next / active_next and the noise's
    uint32 bits exact; deterministic slots bitwise (same unfused f32
    arithmetic); u / hist within rtol = atol = 1e-5 (the in-kernel normals
    are within 2 ulp of the plain PRNG's emulated fused multiply-adds);
    at history buckets 2, 4, 8 (an instance each) and 3, 16, 32 (the
    general instance) and pools of 1, 2 and 5 rows; BDM's commit bitwise
    equal at one and two elements a thread; one traced round_update call
    is 1 device kernel (3 for BDM: step_noise, dct2, round_fused) and one
    round_predict call 1, read from the profiler;
  * round_fused / round_predict at kf 1 in a K 2 pool (a VPSDE or BDM
    family next to CLD in one engine), mixed fam / prec: the same tiers,
    and the foreign rows (another family, another precision class, a
    retired slot) and the padding row bitwise frozen;
  * round_fused in streamed-noise mode (BDM): bitwise against the plain
    version on the same canonical noise; through the whole wrapper (the
    kernel's own draw, the dct2 kernel, the commit) within rtol = atol =
    1e-5 of the plain draw and plain DCT;
  * flash_attention, both forms (the DiT's, and the general one: causal
    (LM prefill) or not (cross-attention, Sq != Sk with a key tail, whisper's
    shapes), window, GQA, q_offset): f32 within 2e-5, bf16 within 2 bf16
    ulp (the ulp at max(|o|, max|o| / 1024), chip_smoke.py's measure);
    bf16 queries over f32 keys run the f32 kernel, within 1 bf16 ulp;
  * MoE layers (dense, capacity, sorted): the card's routing and drops
    identical to the CPU's, outputs within 1e-5 (f32); reduced
    whisper-base's token streams on the card equal the CPU's;
  * decode_attention (one launch: a cluster per row group, merged in
    distributed shared memory; bf16 on the tensor cores with P split into
    bf16 hi + lo, f32 on the CUDA cores): f32 within 1e-5, bf16 within 2
    bf16 ulp (both round the same f32 softmax once, summed in another
    order);
  * dct2 / bdm_ei_update (dct2 also on the kf slice of a K 2 pool, which
    BDM copies first): within 1e-6 of max |x| (max |out| for the
    update) of the plain version, whose products cuBLAS sums in another
    order (f32 throughout: TF32 is off); bdm_ei_update bitwise equal to
    itself at every cluster size;
  * ei_update (f32 and bf16) and apply_factored: BITWISE against the plain
    version (the same unfused products and left-to-right sums, one
    rounding to bf16 at the end); ei_update at q 0-4, the history stacked
    or as separate rows, in the 16-byte and the scalar instance, a
    misaligned row on the scalar one;
  * the attention's gradient in its DiT form, its cross form (Sq != Sk,
    rep 1 and 4) and its causal form (window
    or global, rep 1 and 7; the forward kernel inside an autograd
    Function, the plain backward): dq, dk, dv against torch autograd
    through the plain version in f32, f32 within 1e-5 of each gradient's
    scale, bf16 within 2 bf16 ulp; one kernel launch a forward;
  * head width 80 (zamba2-2.7b's shared block, never padded):
    flash_attention's general form (causal over a cache with q_offset,
    with and without a window, GQA; non-causal) and decode_attention (rep
    1 and 4, at every cluster size) in bf16 and f32, and the causal
    gradient, at the tolerances above; reduced rwkv6-7b and zamba2-2.7b
    on the card against the CPU: prefill logits within 1e-4 of scale,
    equal token streams, the attention launches of each family;
  * three reduced gemma3-1b LM training steps on the card against the
    CPU: losses within 1e-5 relative, params within 2 lr a step and
    within 1e-6 for 99%;
  * three reduced cifar10-cld training steps on the card against the CPU:
    losses within 1e-4 relative, the first gradients within 1e-3 of
    scale, params within 2 lr a step (AdamW's sign-like early update) and
    within 1e-6 for 99%; a train state checkpointed from the card restores
    on the CPU byte for byte.
"""
import pytest
import torch

from repro_torch import random as prng
from repro_torch.core.coeffs import FactoredBank
from repro_torch.kernels import cuda as kc
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.dct2 import ops as dct_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.dct2 import ref as dct_ref
from repro_torch.kernels.ei_update import ops as ei_ops
from repro_torch.kernels.ei_update import ref as ei_ref
from repro_torch.kernels.round_fused import ops as rf
from repro_torch.kernels.round_fused import ref as rf_ref
from repro_torch.sde import BDM, CLD, VPSDE

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(dev, D, K=2, CB=8, NB=8, QB=2, PB=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    f32 = lambda *s: torch.randn(s, generator=g)
    di = lambda *s: torch.randint(0, PB, s, generator=g, dtype=torch.int32)
    rows = [(4, False, False, 0), (5, False, True, 0), (5, True, False, 0),
            (4, True, False, 1), (4, False, False, 2)]
    n_steps = torch.ones(CB, dtype=torch.int32)
    stoch = torch.zeros(CB, dtype=torch.bool)
    corr = torch.zeros(CB, dtype=torch.bool)
    alg = torch.zeros(CB, dtype=torch.int32)
    for c, (n, s, cc, a) in enumerate(rows):
        n_steps[c], stoch[c], corr[c], alg[c] = n, s, cc, a
    bank = FactoredBank(
        t_cur=f32(CB, NB), t_nxt=f32(CB, NB),
        psi_blk=f32(CB, NB, K, K), psi_di=di(CB, NB),
        pC_blk=f32(CB, NB, QB, K, K), pC_di=di(CB, NB, QB),
        cC_blk=f32(CB, NB, QB, K, K), cC_di=di(CB, NB, QB),
        B_blk=f32(CB, NB, K, K), B_di=di(CB, NB),
        P_chol_blk=f32(CB, NB, K, K), P_chol_di=di(CB, NB),
        diag=f32(PB, D), n_steps=n_steps, stochastic=stoch, corrector=corr,
        fam=torch.zeros(CB, dtype=torch.int32), alg=alg)
    return FactoredBank(*(leaf.to(dev) for leaf in bank))


def _state(dev, cfgs, bank, D, K=2, QB=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    B = len(cfgs)
    cfg = torch.tensor(cfgs, dtype=torch.int32, device=dev)
    k = torch.randint(0, 5, (B,), generator=g, dtype=torch.int32).to(dev)
    kc_ = torch.minimum(k, bank.n_steps[cfg] - 1)
    keys = prng.to_int32_bits(torch.randint(0, 2**32, (B, 2), generator=g))
    return dict(
        u=torch.randn(B, K, D, generator=g).to(dev),
        hist=torch.randn(B, QB, K, D, generator=g).to(dev),
        k=k, kc=kc_, cfg=cfg,
        fam=torch.tensor([0, 0, 1, 0][:B], dtype=torch.int32, device=dev),
        prec=torch.zeros(B, dtype=torch.int32, device=dev),
        keys=keys.to(dev),
        active=torch.tensor([True, False, True, True][:B], device=dev),
        eps_c=torch.randn(B, 2, D, generator=g).to(dev),
        eps_n_c=torch.randn(B, 2, D, generator=g).to(dev))


@pytest.mark.parametrize("D", [48, 3072])
@pytest.mark.parametrize("cfgs,corr", [([0, 0, 4, 0], False),
                                       ([1, 1, 0, 1], True),
                                       ([2, 3, 2, 3], False),
                                       ([3, 4, 1, 2], True)])
def test_round_fused_matches_plain_version(dev, D, cfgs, corr):
    bank = _bank(dev, D)
    x = _state(dev, cfgs, bank, D)
    args = (x["u"], x["hist"], x["k"], x["kc"], x["cfg"], x["fam"],
            x["prec"], x["keys"], x["active"], bank, x["eps_c"])
    kw = dict(sde=CLD(), state_shape=(2, D), kf=2, with_corrector=corr,
              eps_n_c=x["eps_n_c"])
    kc.reset_launches()
    got = rf.round_update(*args, **kw)
    want = rf_ref.round_update_ref(*args, **kw)
    torch.cuda.synchronize()
    assert kc.launches()["round_fused"] == 1
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    det = ~bank.stochastic[x["cfg"]]
    assert torch.equal(got[0][det], want[0][det])
    assert torch.equal(got[1], want[1])                 # history: no noise


@pytest.mark.parametrize("D", [48, 3072])
def test_round_predict_matches_plain_version(dev, D):
    bank = _bank(dev, D)
    x = _state(dev, [0, 1, 2, 4], bank, D)
    got = rf.round_predict(x["u"], x["hist"], x["kc"], x["cfg"], bank,
                           x["eps_c"], kf=2)
    want = rf_ref.round_predict_ref(x["u"], x["hist"], x["kc"], x["cfg"],
                                    bank, x["eps_c"], kf=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_noise_bits_exact_and_normals_within_2_ulp(dev):
    B, kf, D = 4, 2, 3072
    n = kf * D
    g = torch.Generator().manual_seed(3)
    keys64 = torch.randint(0, 2**32, (B, 2), generator=g).to(dev)
    keys = prng.to_int32_bits(keys64)
    kcs = torch.tensor([0, 3, 7, 9], dtype=torch.int32, device=dev)
    algs = torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=dev)
    cfgs = torch.arange(B, dtype=torch.int32, device=dev)   # alg[cfg] = algs
    z, bits = rf.step_noise_kernel(keys, kcs, cfgs, algs, n=n,
                                   with_bits=True)
    step = prng.fold_in(prng.fold_in(keys64, algs), kcs)
    f = torch.arange(n, device=dev)[None]
    want_bits = prng.bits_at(step[:, None], f, n)
    want_z = rf_ref.draw_step_noise(keys, kcs, algs, (kf, D)).reshape(B, n)
    assert torch.equal(prng.from_int32_bits(bits), want_bits)
    ulp = (z.view(torch.int32).long() - want_z.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= 2


# (B, S, H, Dh): the reduced DiT, ragged S (24, 100, 200: not multiples of
# the 64-row tile), d_head 32 / 64 / 128, the engine's (4, 256, 12, 64),
# path A's (64, 256, 12, 64) and whisper-base's encoder (S 1500 = 23 * 64
# + 28: a key tail)
@pytest.mark.parametrize("shape", [(3, 4, 2, 32), (2, 24, 3, 32),
                                   (2, 100, 2, 128), (4, 256, 12, 64),
                                   (2, 200, 3, 64), (64, 256, 12, 64),
                                   (2, 1500, 8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(dev, shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype)
               for _ in range(3))
    kc.reset_launches()
    got = attn_ops.attention(q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kc.launches()["flash_attention"] == 1 and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert torch.isfinite(got).all() and _bf16_ulps(got, want) <= 2


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Dh", [32, 64])
def test_bf16_runs_on_the_tensor_core_kernels(dev, causal, Dh):
    """bf16 calls launch the warpgroup (wgmma) kernels at d_head 64 and the
    mma.sync kernels at 32; f32 calls the CUDA-core kernels (names from a
    profiler trace); one launch per call either way."""
    q = torch.randn(2, 80, 4, Dh, device=dev)
    kw = dict(causal=causal, window=30 if causal else None)
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = q.to(dtype)
        attn_ops.attention(x, x, x, **kw)               # build, opt in
        torch.cuda.synchronize()
        kc.reset_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            attn_ops.attention(x, x, x, **kw)
            torch.cuda.synchronize()
        assert kc.launches()["flash_attention"] == 1
        names[dtype] = {e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "flash" in e.name}
    form = "lm" if causal else "dit"
    f32 = "flash_lm_kernel" if causal else "flash_fwd_kernel"
    bf16 = f"flash_{form}_{'wgmma' if Dh == 64 else 'mma'}_kernel"
    assert len(names[torch.float32]) == 1 and f32 in names[torch.float32].pop()
    assert len(names[torch.bfloat16]) == 1 and bf16 in \
        names[torch.bfloat16].pop()


def test_cuda_tensors_never_reach_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(attn_ops, "attention_ref", boom)
    monkeypatch.setattr(dec_ops, "decode_attention_ref", boom)
    q = torch.randn(1, 8, 2, 32, device=dev)
    kc.reset_launches()
    attn_ops.attention(q, q, q, causal=False)
    attn_ops.attention(q, q, q, causal=True, window=3)  # the LM form
    attn_ops.attention(q, q, q, causal=False, window=3)  # the cross form
    attn_ops.attention(q, q[:, :, :1].contiguous(), q[:, :, :1]
                       .contiguous(), causal=False)  # GQA, non-causal
    assert kc.launches()["flash_attention"] == 4
    assert kc.launches()[attn_ops.CROSS_COUNT] == 2
    leaves = [q.clone().requires_grad_() for _ in range(3)]
    with pytest.raises(NotImplementedError):   # no gradient with a window
        attn_ops.attention(*leaves, causal=False, window=3)
    with pytest.raises(TypeError):             # f16 is not a kernel dtype
        attn_ops.attention(*(q.half(),) * 3, causal=False, window=3)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(*(torch.randn(1, 8, 2, 48, device=dev),) * 3)
    with pytest.raises(ValueError):
        attn_ops.attention(*(torch.randn(1, 8, 2, 48, device=dev),) * 3,
                           causal=True)
    k = torch.randn(1, 40, 2, 16, device=dev)
    dec_ops.decode_attention(torch.randn(1, 4, 16, device=dev), k, k, 7)
    with pytest.raises(ValueError):                     # head width 48
        kk = torch.randn(1, 40, 1, 48, device=dev)
        dec_ops.decode_attention(torch.randn(1, 4, 48, device=dev), kk, kk, 7)
    with pytest.raises(ValueError):                     # rep 32 > 16
        kk = torch.randn(1, 40, 1, 16, device=dev)
        dec_ops.decode_attention(torch.randn(1, 32, 16, device=dev), kk, kk, 7)
    with pytest.raises(TypeError):                      # cache dtype differs
        dec_ops.decode_attention(torch.randn(1, 4, 16, device=dev),
                                 k.bfloat16(), k.bfloat16(), 7)
    torch.cuda.synchronize()


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of want, the ulp taken at
    max(|want|, max|want| / 1024)."""
    w = want.float()
    mag = w.abs().clamp_min(float(w.abs().max()) / 1024)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return float(((got.float() - w).abs() / ulp).max())


def _close(got, want, dtype, f32_tol):
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=f32_tol)
    else:
        assert _bf16_ulps(got, want) <= 2


# (B, Hq, Hkv, Dh, S, cache_len per row, window): gemma3-1b's decode shape
# (valid lengths at 1, a tile edge, past the window, near the end), a small
# GQA shape with a ragged cache (S not a multiple of 32), rep 16 (four row
# groups) with cache_len 0 and past S and two steps a warp, and rep 1 with
# a window wider than a row's cache_len
DECODE_CASES = [(4, 4, 1, 256, 1024, [1, 96, 690, 1000], 512),
                (4, 4, 1, 256, 1024, [1, 96, 690, 1000], None),
                (3, 4, 2, 16, 40, [1, 33, 40], 5),
                (3, 4, 2, 16, 40, [0, 7, 39], None),
                (2, 16, 1, 128, 1100, [0, 1500], None),
                (3, 2, 2, 32, 2048, [2048, 5, 1999], 600),
                (4, 32, 32, 80, 1024, [1, 96, 640, 1000], None),
                (3, 8, 2, 80, 300, [0, 77, 300], 50)]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain_version(dev, case, dtype):
    B, Hq, Hkv, Dh, S, lens, window = case
    g = torch.Generator().manual_seed(Dh + S)
    q = torch.randn(B, Hq, Dh, generator=g).to(dev, dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g).to(dev, dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g).to(dev, dtype)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kc.reset_launches()
    got = dec_ops.decode_attention(q, k, v, cl, window=window)
    want = decode_attention_ref(q, k, v, cl, window=window)
    torch.cuda.synchronize()
    n = kc.launches()
    assert n["decode_attention"] == 1 and "decode_attention_merge" not in n
    _close(got, want, dtype, 1e-5)
    # the scalar form is the per-row form with every row alike
    got_s = dec_ops.decode_attention(q, k, v, lens[-1], window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got_s, dec_ops.decode_attention(
            q, k, v, torch.full((B,), lens[-1], device=dev), window=window),
        rtol=0, atol=0)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8,
                      device=t.device)
    off = (-buf.data_ptr()) % 16 + 4
    out = buf[off:off + t.numel() * t.element_size()].view(t.dtype)
    out = out.view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_inputs_take_the_elementwise_loads(dev, dtype):
    """Both kernels stage rows with 16-byte loads when the rows are 16-byte
    aligned and element by element otherwise: the same numbers."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 4, 64, generator=g).to(dev, dtype)
    k = torch.randn(2, 80, 1, 64, generator=g).to(dev, dtype)
    cl = torch.tensor([33, 80], dtype=torch.int32, device=dev)
    want = dec_ops.decode_attention(q, k, k, cl, window=40)
    got = dec_ops.decode_attention(_misaligned(q), _misaligned(k),
                                   _misaligned(k), cl, window=40)
    qq = torch.randn(1, 40, 4, 64, generator=g).to(dev, dtype)
    want2 = attn_ops.attention(qq, k[:1], k[:1], causal=True, window=9)
    got2 = attn_ops.attention(_misaligned(qq), _misaligned(k[:1]),
                              _misaligned(k[:1]), causal=True, window=9)
    torch.cuda.synchronize()
    assert _misaligned(q).data_ptr() % 16 == 4
    assert torch.equal(got, want) and torch.equal(got2, want2)


# (B, Sq, Hq, Sk, Hkv, Dh, window, q_offset): gemma3-1b's prefill of a
# 640- and a 96-token prompt into the 1024-long cache (window layers and
# global layers), a ragged Sq, and a small GQA case with a device q_offset;
# then the edges of the 64 x 64 tiling: S 200 (not a multiple of 64), 37
# queries at a device q_offset of 50, window 1 (each row sees one key), a
# window under the tile size over several tiles, rep 8 GQA, d_head 32 and
# 64, rows with no visible key (q_offset past the window's reach: 0), and a
# block with no key tile at all; then d_head 80 (zamba2-2.7b's shared
# block: its prefill over the cache, a window with a device q_offset, GQA)
CAUSAL_CASES = [(2, 640, 32, 1024, 32, 80, None, 0),
                (2, 70, 4, 130, 2, 80, 30, 7),
(1, 640, 4, 1024, 1, 256, 512, 0),
                (2, 96, 4, 1024, 1, 256, None, 0),
                (2, 50, 4, 64, 1, 128, 20, 0),
                (2, 12, 4, 32, 2, 16, 6, 9),
                (2, 200, 4, 200, 2, 64, None, 0),
                (2, 37, 4, 100, 1, 32, None, 50),
                (1, 130, 2, 130, 2, 64, 1, 0),
                (1, 300, 2, 400, 1, 128, 40, 5),
                (1, 130, 8, 200, 1, 64, 77, 3),
                (1, 20, 2, 32, 1, 16, 5, 30),
                (1, 8, 2, 16, 1, 256, 4, 100)]


@pytest.mark.parametrize("case", CAUSAL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_flash_attention_matches_plain_version(dev, case, dtype):
    B, Sq, Hq, Sk, Hkv, Dh, window, q_off = case
    g = torch.Generator().manual_seed(Sq + Dh)
    q = torch.randn(B, Sq, Hq, Dh, generator=g).to(dev, dtype)
    k = torch.randn(B, Sk, Hkv, Dh, generator=g).to(dev, dtype)
    v = torch.randn(B, Sk, Hkv, Dh, generator=g).to(dev, dtype)
    off = torch.tensor(q_off, device=dev) if q_off else 0
    kc.reset_launches()
    got = attn_ops.attention(q, k, v, causal=True, window=window,
                             q_offset=off)
    want = attention_ref(q, k, v, causal=True, window=window, q_offset=q_off)
    torch.cuda.synchronize()
    assert kc.launches()["flash_attention"] == 1
    _close(got, want, dtype, 2e-5)


# (B, Sq, Hq, Sk, Hkv, Dh, window, q_offset): the non-causal general form
# (cross-attention).  whisper-base's prefill (G, L, 8, 64) over 1500 encoder
# keys (a key tail: 1500 = 23 * 64 + 28) and its decode step (one query a
# row); then GQA, a window with q_offset (a device scalar), d_head 16 / 32
# (mma.sync) / 128 / 256, a ragged Sk under one tile, rows past the window's
# reach (no visible key: 0), and Sq > Sk
CROSS_CASES = [(2, 64, 8, 1500, 8, 64, None, 0),
               (4, 1, 8, 1500, 8, 64, None, 0),
               (2, 37, 4, 200, 1, 128, None, 0),
               (2, 70, 4, 130, 2, 64, 40, 50),
               (1, 20, 2, 37, 1, 16, None, 0),
               (2, 33, 4, 100, 2, 32, 10, 7),
               (1, 16, 4, 40, 2, 256, 8, 60),
               (1, 90, 2, 20, 2, 64, None, 0)]


@pytest.mark.parametrize("case", CROSS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_flash_attention_matches_plain_version(dev, case, dtype):
    B, Sq, Hq, Sk, Hkv, Dh, window, q_off = case
    g = torch.Generator().manual_seed(Sq + Sk + Dh)
    q = torch.randn(B, Sq, Hq, Dh, generator=g).to(dev, dtype)
    k = torch.randn(B, Sk, Hkv, Dh, generator=g).to(dev, dtype)
    v = torch.randn(B, Sk, Hkv, Dh, generator=g).to(dev, dtype)
    off = torch.tensor(q_off, device=dev) if q_off else 0
    kc.reset_launches()
    got = attn_ops.attention(q, k, v, causal=False, window=window,
                             q_offset=off)
    want = attention_ref(q, k, v, causal=False, window=window,
                         q_offset=q_off)
    torch.cuda.synchronize()
    n = kc.launches()
    assert n["flash_attention"] == n[attn_ops.CROSS_COUNT] == 1
    _close(got, want, dtype, 2e-5)


def test_mixed_dtype_cross_attention_runs_the_f32_kernel(dev):
    """whisper's decode step: bf16 queries over the f32 memory pool's keys
    run the f32 kernel (q upcast) and come back bf16, within 1 bf16 ulp of
    the plain version (which computes in f32 too)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(4, 1, 8, 64, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(4, 1500, 8, 64, generator=g).to(dev)
            for _ in range(2))
    kc.reset_launches()
    got = attn_ops.attention(q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kc.launches()[attn_ops.CROSS_COUNT] == 1
    assert got.dtype == torch.bfloat16 and _bf16_ulps(got, want) <= 1


@pytest.mark.parametrize("Dh", [32, 64])
def test_cross_bf16_runs_on_the_tensor_core_kernels(dev, Dh):
    """A bf16 non-causal call with Sq != Sk launches the general form's
    tensor-core kernel (wgmma at d_head 64, mma.sync at 32), an f32 one
    its CUDA-core kernel (names from a profiler trace)."""
    q = torch.randn(2, 40, 4, Dh, device=dev)
    kv = torch.randn(2, 300, 2, Dh, device=dev)
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, y = q.to(dtype), kv.to(dtype)
        attn_ops.attention(x, y, y, causal=False)       # build, opt in
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):       # a trace may drop its first events
                attn_ops.attention(x, y, y, causal=False)
            torch.cuda.synchronize()
        names[dtype] = {e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "flash" in e.name}
    bf16 = f"flash_lm_{'wgmma' if Dh == 64 else 'mma'}_kernel"
    assert len(names[torch.float32]) == 1 and "flash_lm_kernel" in \
        names[torch.float32].pop()
    assert len(names[torch.bfloat16]) == 1 and bf16 in \
        names[torch.bfloat16].pop()


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_gradient_matches_plain_version(dev, rep, dtype):
    """With grad on, the non-causal form at Sq != Sk (the encoder-decoder's
    cross-attention in training) runs `FlashAttention`: the forward kernel
    once (counted as the cross form) and the plain backward; the output
    and dq, dk, dv against torch autograd through the plain version in f32:
    f32 within 2e-5 / 1e-5 of scale, bf16 within 2 bf16 ulp."""
    g = torch.Generator().manual_seed(rep)
    B, Sq, Sk, Hkv, Dh = 2, 96, 300, 2, 64
    q, do = (torch.randn(B, Sq, Hkv * rep, Dh, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, Hkv, Dh, generator=g).to(dev, dtype)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kc.reset_launches()
    out = attn_ops.attention(*leaves, causal=False)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    n = kc.launches()
    assert n["flash_attention"] == n[attn_ops.CROSS_COUNT] == 1
    assert "FlashAttention" in type(out.grad_fn).__name__
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = attention_ref(*ref_leaves, causal=False)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    for a, b, tol in [(out.detach(), ref_out.detach(), 2e-5)] + [
            (a, b, 1e-5) for a, b in zip(got, want)]:
        assert a.dtype == dtype and torch.isfinite(a).all()
        if dtype == torch.float32:
            assert float((a - b).abs().max() / b.abs().max()) <= tol
        else:
            assert _bf16_ulps(a, b.to(dtype)) <= 2


@pytest.mark.parametrize("impl", ["dense", "capacity", "sorted"])
def test_moe_layer_card_matches_cpu(dev, impl):
    """An MoE layer (64 tokens, 16 experts, top-4, a shared expert, cap 4
    so choices drop) on the card against the CPU, f32: expert ids and
    kept choices identical, the output within 1e-5 of scale."""
    from repro_torch.models import common
    g = torch.Generator().manual_seed(1)
    p = common.moe_params(g, 32, 24, 16, torch.float32, n_shared=1,
                          d_ff_shared=24)
    x = torch.randn(4, 16, 32, generator=g)
    pd = {k: (v.to(dev) if torch.is_tensor(v) else
              {kk: vv.to(dev) for kk, vv in v.items()}) for k, v in p.items()}
    kw = dict(top_k=4, capacity_factor=0.3)
    idx, kept = common.moe_routing(p, x, impl=impl, **kw)
    idx_d, kept_d = common.moe_routing(pd, x.to(dev), impl=impl, **kw)
    assert torch.equal(idx_d.cpu(), idx) and torch.equal(kept_d.cpu(), kept)
    want = common.MOE_IMPLS[impl](p, x, **kw)
    got = common.MOE_IMPLS[impl](pd, x.to(dev), **kw)
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-5


def test_reduced_encdec_card_matches_cpu(dev):
    """Reduced whisper-base (f32, d_head 16: the encoder and the cross-
    attention run the general non-causal kernel, the decoder the causal
    one and decode_attention) on the card and on the CPU with the same
    seeded weights: a TokenEngine serve of 5 requests gives equal token
    streams."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import Arch
    from repro_torch.serve import ServeRequest, TokenEngine
    arch = Arch(get_arch("whisper-base", reduced=True))
    params = arch.init(seed=2, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=i, workload="token", max_new=6,
                         frames=rng.standard_normal((32, 64)).astype(
                             np.float32),
                         tokens=rng.integers(2, 256, 5 + i % 2).astype(
                             np.int32)) for i in range(5)]
    out = {}
    for d in ("cuda", "cpu"):
        kc.reset_launches()
        eng = TokenEngine(arch, params, batch_size=2, max_len=24,
                          device=d)
        out[d] = eng.serve(reqs)
        if d == "cuda":
            n = kc.launches()
            assert n[attn_ops.CROSS_COUNT] > 0 and n["decode_attention"] > 0
    for r in reqs:
        np.testing.assert_array_equal(out["cuda"][r.rid], out["cpu"][r.rid])


@pytest.mark.parametrize("cfgs,corr", [([0, 3, 2, 3], False),
                                       ([1, 2, 3, 1], True)])
def test_round_fused_streamed_noise_matches_plain_version(dev, cfgs, corr):
    """BDM's mode: K = kf = 1, real pool rows, canonical noise streamed in."""
    shape = (32, 32, 3)
    D = 3072
    bank = _bank(dev, D, K=1, PB=5)
    x = _state(dev, cfgs, bank, D, K=1)
    x["eps_c"] = x["eps_c"][:, :1].contiguous()
    x["eps_n_c"] = x["eps_n_c"][:, :1].contiguous()
    args = (x["u"], x["hist"], x["k"], x["kc"], x["cfg"], x["fam"],
            x["prec"], x["keys"], x["active"], bank, x["eps_c"])
    sde = BDM(data_shape=shape)
    alg = bank.alg[x["cfg"]]
    noise = rf_ref.draw_step_noise(x["keys"], x["kc"], alg, shape)
    noise_c = dct_ref.dct2_ref(noise).reshape(4, 1, D)
    kw = dict(sde=sde, state_shape=shape, kf=1, with_corrector=corr,
              eps_n_c=x["eps_n_c"])
    want = rf_ref.round_update_ref(*args, noise_c=noise_c, **kw)

    got = rf.round_fused(*args, x["eps_n_c"], noise_c, kf=1, n=D,
                         with_corrector=corr)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])

    kc.reset_launches()
    full = rf.round_update(*args, **kw)
    torch.cuda.synchronize()
    n = kc.launches()
    assert n["step_noise"] == n["dct2"] == n["round_fused"] == 1
    assert torch.equal(full[2], want[2]) and torch.equal(full[3], want[3])
    for a, b in zip(full[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# the engine paths' commit: (sde, data shape, K = kf); BDM streams its noise
def _path(name, D):
    if name == "cld":
        return CLD(), (2, D), 2
    if name == "ddpm":
        return VPSDE(), (D,), 1
    side = {48: 4, 3072: 32}[D]
    return BDM(data_shape=(side, side, 3)), (side, side, 3), 1


def _mixed(dev, name, D, corr, seed=1, PB=5, QB=2):
    """A batch of the path's shape mixing, on CLD's corner configs, a
    retired slot (1), a foreign-family slot (2) and a slot on its final step
    (3: no corrector there, and it retires); a pool of PB rows (the engines'
    VPSDE and CLD banks hold 1), a history bucket of QB."""
    sde, shape, kf = _path(name, D)
    bank = _bank(dev, D, K=kf, PB=PB, QB=QB)
    x = _state(dev, [1, 2, 3, 1] if corr else [0, 3, 2, 4], bank, D, K=kf,
               QB=QB, seed=seed)
    x["k"][3] = bank.n_steps[x["cfg"][3]] - 1
    x["kc"] = torch.minimum(x["k"], bank.n_steps[x["cfg"]] - 1)
    x["eps_c"] = x["eps_c"][:, :kf].contiguous()
    x["eps_n_c"] = x["eps_n_c"][:, :kf].contiguous()
    args = (x["u"], x["hist"], x["k"], x["kc"], x["cfg"], x["fam"],
            x["prec"], x["keys"], x["active"], bank, x["eps_c"])
    kw = dict(sde=sde, state_shape=shape, kf=kf, with_corrector=corr,
              eps_n_c=x["eps_n_c"])
    return bank, x, args, kw


# (path, D, pool rows, history bucket): pools of 1 and 2 rows are read whole
# and picked by value (the engines' VPSDE and CLD banks hold 1), larger
# ones gathered; Qb 2, 4, 8 have instances of their own, any other bucket
# (3, 16, 32) runs the general one
@pytest.mark.parametrize("name,D,pb,qb", [
    ("cld", 48, 5, 2), ("cld", 3070, 5, 2), ("cld", 3072, 5, 2),
    ("ddpm", 48, 5, 2), ("ddpm", 3070, 5, 2), ("ddpm", 3072, 5, 2),
    ("bdm", 48, 5, 2), ("bdm", 3072, 5, 2),
    ("cld", 3072, 1, 2), ("cld", 3070, 2, 2), ("ddpm", 3072, 1, 2),
    ("ddpm", 3070, 2, 2), ("cld", 3072, 1, 4), ("ddpm", 3072, 2, 8),
    ("cld", 3072, 1, 16), ("ddpm", 3070, 2, 16), ("bdm", 3072, 5, 16),
    ("cld", 48, 5, 32), ("ddpm", 48, 1, 3)])
@pytest.mark.parametrize("corr", [False, True])
def test_round_update_on_every_path(dev, name, D, pb, qb, corr):
    """round_update and round_predict on each engine path's layout against
    round_update_ref / round_predict_ref: deterministic slots bitwise (all
    slots for BDM, given the same canonical noise), the rest within 1e-5,
    k / active exact; the frozen slots verbatim."""
    bank, x, args, kw = _mixed(dev, name, D, corr, PB=pb, QB=qb)
    kf = kw["kf"]
    kc.reset_launches()
    got = rf.round_update(*args, **kw)
    pred = rf.round_predict(x["u"], x["hist"], x["kc"], x["cfg"], bank,
                            x["eps_c"], kf=kf)
    want = rf_ref.round_update_ref(*args, **kw)
    pred_ref = rf_ref.round_predict_ref(x["u"], x["hist"], x["kc"],
                                        x["cfg"], bank, x["eps_c"], kf=kf)
    torch.cuda.synchronize()
    n = kc.launches()
    assert n["round_fused"] == 1 and n["round_predict"] == 1
    assert n.get("step_noise", 0) == (name == "bdm")
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert not bool(got[3][3])                     # retired on its last step
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    det = ~bank.stochastic[x["cfg"]]
    assert torch.equal(got[0][det], want[0][det])
    assert torch.equal(got[1], want[1])
    for i in (1, 2):
        assert torch.equal(got[0][i], x["u"][i])
        assert torch.equal(got[1][i], x["hist"][i])
    assert torch.equal(pred, pred_ref)
    if name == "bdm":
        alg = bank.alg[x["cfg"]]
        noise = rf_ref.draw_step_noise(x["keys"], x["kc"], alg,
                                       kw["state_shape"])
        noise_c = kw["sde"].canonicalize(noise).contiguous()
        want_s = rf_ref.round_update_ref(*args, noise_c=noise_c, **kw)
        got_s = rf.round_fused(*args, x["eps_n_c"], noise_c, kf=1, n=D,
                               with_corrector=corr)
        torch.cuda.synchronize()
        for a, b in zip(got_s, want_s):
            assert torch.equal(a, b)


@pytest.mark.parametrize("D", [3072, 48])
@pytest.mark.parametrize("corr", [False, True])
def test_streamed_commit_bitwise_at_one_and_two_elems(dev, D, corr):
    """BDM's commit, which takes two elements a thread, bitwise equal to
    itself at one (the width every other launch takes)."""
    bank, x, args, kw = _mixed(dev, "bdm", D, corr)
    n = int(torch.tensor(kw["state_shape"]).prod())
    z = rf.step_noise_kernel(x["keys"], x["kc"], x["cfg"], bank.alg, n=n)
    noise_c = kw["sde"].canonicalize(
        z.reshape((4,) + kw["state_shape"])).contiguous()
    outs = [rf._round_fused(*args, x["eps_n_c"], noise_c, kf=1, n=n,
                            with_corrector=corr, elems=e) for e in (1, 2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _device_events_of_one_call(call, lead=10):
    """The device events (names) of one `call` from a CUPTI trace: CUPTI
    drops the first few events of a trace, so `lead` calls run first, then
    the call between two spin kernels (torch.cuda._sleep), and only the
    events between them count."""
    cuda_dev = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
            for _ in range(lead):
                call()
            torch.cuda._sleep(1000)
            call()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in p.events() if e.device_type == cuda_dev),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if len(marks) == 2:
            return [e.name for e in events[marks[0] + 1:marks[1]]]
    raise AssertionError("no trace held both marker kernels")


@pytest.mark.parametrize("name", ["cld", "ddpm", "bdm"])
def test_one_traced_call_is_one_device_kernel(dev, name):
    """One round_update call runs 1 device kernel (3 for BDM: step_noise,
    dct2, round_fused) and one round_predict call 1, counted from a CUPTI
    trace (every device event: kernels, copies, fills), not from the
    wrappers' launch counts."""
    bank, x, args, kw = _mixed(dev, name, 3072, True)
    calls = {"round_update": (lambda: rf.round_update(*args, **kw),
                              3 if name == "bdm" else 1),
             "round_predict": (lambda: rf.round_predict(
                 x["u"], x["hist"], x["kc"], x["cfg"], bank, x["eps_c"],
                 kf=kw["kf"]), 1)}
    for what, (call, want) in calls.items():
        call()
        torch.cuda.synchronize()
        events = _device_events_of_one_call(call)
        assert len(events) == want, (what, events)


def test_round_kernels_refuse_what_they_do_not_take(dev):
    bank, x, args, kw = _mixed(dev, "cld", 48, False)
    bad = {"psi_blk": bank.psi_blk.transpose(2, 3),           # strided
           "diag": bank.diag.double(),                         # f64
           "n_steps": bank.n_steps.long(),                     # int64
           "stochastic": bank.stochastic.int()}                # not bool
    errors = {"psi_blk": ValueError, "diag": TypeError, "n_steps": TypeError,
              "stochastic": TypeError}
    for leaf, t in bad.items():
        b2 = bank._replace(**{leaf: t})
        with pytest.raises(errors[leaf]):
            rf.round_update(*args[:9], b2, *args[10:], **kw)
        if leaf in ("psi_blk", "diag"):
            with pytest.raises(errors[leaf]):
                rf.round_predict(x["u"], x["hist"], x["kc"], x["cfg"], b2,
                                 x["eps_c"], kf=2)
    with pytest.raises(TypeError):                          # int64 cfg
        rf.round_update(*args[:4], x["cfg"].long(), *args[5:], **kw)
    with pytest.raises(TypeError):                          # int64 alg
        rf.step_noise_kernel(x["keys"], x["kc"], x["cfg"], bank.alg.long(),
                             n=96)
    with pytest.raises(TypeError):                          # int64 cfg
        rf.step_noise_kernel(x["keys"], x["kc"], x["cfg"].long(), bank.alg,
                             n=96)


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (4, 8, 8, 3),
                                   (2, 64, 48, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_dct2_matches_plain_version(dev, shape, inverse):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to(dev)
    kc.reset_launches()
    got = dct_ops.dct2(x, inverse=inverse)
    want = (dct_ref.idct2_ref if inverse else dct_ref.dct2_ref)(x)
    torch.cuda.synchronize()
    assert kc.launches()["dct2"] == 1
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(x.abs().max())


@pytest.mark.parametrize("q", [1, 2])
def test_bdm_ei_update_matches_plain_version(dev, q):
    g = torch.Generator().manual_seed(q)
    B, H, W, Ch = 4, 32, 32, 3
    u = torch.randn(B, H, W, Ch, generator=g).to(dev)
    eps = torch.randn(q, B, H, W, Ch, generator=g).to(dev)
    psi = torch.rand(H, W, 1, generator=g).to(dev)
    C = torch.randn(q, H, W, 1, generator=g).to(dev)
    kc.reset_launches()
    got = dct_ops.bdm_ei_update(u, eps, psi, C)
    want = dct_ref.bdm_ei_update_ref(u, eps, psi, C)
    torch.cuda.synchronize()
    assert kc.launches()["bdm_ei_update"] == 1
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("shape,q", [
    (s, q) for s in [(64, 32, 32, 3), (2, 13, 20, 2), (2, 64, 64, 3)]
    for q in range(5)] + [
    (s, q) for s in [(4, 32, 32, 3), (64, 32, 32, 3)] for q in (5, 6)])
def test_bdm_ei_update_at_every_cluster_size(dev, shape, q):
    """Path A's shape (and a ragged 13 x 20, and 64 x 64 where shared memory
    splits the tiles into passes) at q 0-4, and the served frame at q 5-6
    (passes of up to 5 tiles; the kernels with bulk copies take one pass,
    so there R 4 and 8 take the general kernel): the wrapper's one launch, and
    the kernel at every cluster size the wrapper can pick (called directly,
    uncounted), each within 1e-6 of max |out| of the plain version; the
    band split changes no bit (every output is one chain in order)."""
    g = torch.Generator().manual_seed(sum(shape) + q)
    B, H, W, Ch = shape
    u = torch.randn(B, H, W, Ch, generator=g).to(dev)
    eps = torch.randn(q, B, H, W, Ch, generator=g).to(dev)
    psi = torch.rand(H, W, 1, generator=g).to(dev)
    C = torch.randn(q, H, W, 1, generator=g).to(dev)
    kc.reset_launches()
    got = dct_ops.bdm_ei_update(u, eps, psi, C)
    want = dct_ref.bdm_ei_update_ref(u, eps, psi, C)
    torch.cuda.synchronize()
    assert kc.launches()["bdm_ei_update"] == 1
    tol = 1e-6 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    for blocks in (1, 2, 4, 8):
        out = torch.full_like(u, float("nan"))
        dct_ops._launch_bdm(u, eps, psi, C, out, blocks)
        torch.cuda.synchronize()
        assert float((out - want).abs().max()) <= tol, blocks
        assert torch.equal(out, got), blocks
    assert kc.launches()["bdm_ei_update"] == 1


def test_dct2_refuses_what_it_does_not_take(dev):
    with pytest.raises(ValueError):
        dct_ops.dct2(torch.zeros(1, 65, 8, 3, device=dev))
    with pytest.raises(TypeError):
        dct_ops.dct2(torch.zeros(1, 8, 8, 3, device=dev,
                                 dtype=torch.float64))
    with pytest.raises(ValueError):
        dct_ops.dct2(torch.zeros(1, 8, 8, 3, device=dev).transpose(1, 2))


def test_both_libraries_build(dev):
    names = ["round_fused", "attention", "dct2", "decode_attention",
             "ei_update"]
    reports = kc.build_all(names)
    assert set(reports) == set(names)
    assert all("error" not in r for r in reports.values())


@pytest.mark.parametrize("form", ["tensor", "list"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,D", [(64, 1, 3072), (64, 2, 3072), (3, 2, 300),
                                   (2, 1, 77)])
@pytest.mark.parametrize("q", range(5))
def test_ei_update_matches_plain_version(dev, B, k, D, q, dtype, form):
    """q 0-4, the history stacked or as separate rows; D 3072 runs the
    16-byte instance, D 300 it for f32 and the scalar one for bf16, D 77
    the scalar one.  The scalar instance, and the 16-byte one where it fits
    the shape, through the private override, are bitwise equal too."""
    g = torch.Generator().manual_seed(B + k + D + q)
    u = torch.randn(B, k, D, generator=g).to(dtype).to(dev)
    eps = torch.randn(q, B, k, D, generator=g).to(dtype).to(dev)
    hist = eps if form == "tensor" else [eps[j].clone() for j in range(q)]
    psi, C = torch.randn(k, k, generator=g), torch.randn(q, k, k, generator=g)
    v = 16 // u.element_size()
    rows = ei_ops.history_rows(u, hist)
    assert ei_ops.vector_elems(u, rows, u) == (1 if D % v else v)
    kc.reset_launches()
    got = ei_ops.ei_update(u, hist, psi, C)
    want = ei_ref.ei_update_ref(u, eps, psi, C)
    torch.cuda.synchronize()
    assert kc.launches()["ei_update"] == 1 and got.dtype == dtype
    assert torch.equal(got, want)
    for elems in (1, v):
        if D % elems == 0:
            out = ei_ops._ei_update(u, hist, psi, C, elems=elems)
            torch.cuda.synchronize()
            assert torch.equal(out, want), elems


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ei_update_misaligned_row_runs_scalar(dev, dtype):
    """A row one element past a 16-byte boundary (contiguous, so the
    wrapper takes it): the scalar instance runs, bitwise; the 16-byte one
    is refused for it by the entry point."""
    B, k, D, q = 64, 2, 3072, 2
    g = torch.Generator().manual_seed(5)
    u = torch.randn(B, k, D, generator=g).to(dtype).to(dev)
    flat = torch.randn(B * k * D + 1, generator=g).to(dtype).to(dev)
    rows = [torch.randn(B, k, D, generator=g).to(dtype).to(dev),
            flat[1:].view(B, k, D)]
    psi, C = torch.randn(k, k, generator=g), torch.randn(q, k, k, generator=g)
    assert rows[1].data_ptr() % 16
    assert ei_ops.vector_elems(u, rows, u) == 1
    kc.reset_launches()
    got = ei_ops.ei_update(u, rows, psi, C)
    want = ei_ref.ei_update_ref(u, rows, psi, C)
    torch.cuda.synchronize()
    assert kc.launches()["ei_update"] == 1
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError):
        ei_ops._ei_update(u, rows, psi, C, elems=16 // u.element_size())


@pytest.mark.parametrize("threads", [64, 128, 256])
def test_ei_update_any_block_size(dev, threads):
    """The block-size override of the sweep: bitwise at 64, 128 and 256
    threads a block, ragged edge included (D / 4 = 770 d groups)."""
    B, k, D, q = 64, 1, 3080, 3
    g = torch.Generator().manual_seed(threads)
    u = torch.randn(B, k, D, generator=g).to(dev)
    rows = [torch.randn(B, k, D, generator=g).to(dev) for _ in range(q)]
    psi, C = torch.randn(k, k, generator=g), torch.randn(q, k, k, generator=g)
    want = ei_ref.ei_update_ref(u, rows, psi, C)
    for elems in (1, 4):
        got = ei_ops._ei_update(u, rows, psi, C, elems=elems,
                                threads=threads)
        torch.cuda.synchronize()
        assert torch.equal(got, want), elems


@pytest.mark.parametrize("elems", [1, 4])
def test_ei_update_batch_past_grid_y_limit(dev, elems):
    """The batch sits on grid.x, so B = 65536 (one past grid.y's limit)
    runs, bitwise, in both instances; the d blocks sit on grid.y, and more
    than 65535 of them are refused."""
    B, k, D, q = 65536, 2, 8, 2
    g = torch.Generator().manual_seed(elems)
    u = torch.randn(B, k, D, generator=g).to(dev)
    rows = [torch.randn(B, k, D, generator=g).to(dev) for _ in range(q)]
    psi, C = torch.randn(k, k, generator=g), torch.randn(q, k, k, generator=g)
    got = ei_ops._ei_update(u, rows, psi, C, elems=elems)
    want = ei_ref.ei_update_ref(u, rows, psi, C)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    D = 65536 * 32 * elems
    u = torch.zeros(1, 1, D, device=dev)
    with pytest.raises(RuntimeError):
        ei_ops._ei_update(u, [], torch.eye(1), torch.zeros(0, 1, 1),
                          elems=elems, threads=32)


@pytest.mark.parametrize("B,k,D", [(4, 1, 3072), (4, 2, 3072), (3, 2, 300),
                                   (4, 1, 3070), (4, 2, 3070)])
def test_apply_factored_matches_plain_version(dev, B, k, D):
    g = torch.Generator().manual_seed(B + k + D)
    z = torch.randn(B, k, D, generator=g).to(dev)
    blk = torch.randn(B, k, k, generator=g).to(dev)
    diag = torch.randn(B, D, generator=g).to(dev)
    kc.reset_launches()
    got = ei_ops.apply_factored(blk, diag, z)
    want = ei_ref.apply_factored_ref(blk, diag, z)
    # a strided state (the serving step's hist[:, j, :kf]) is made
    # contiguous by the wrapper
    wide = torch.cat([z, z], dim=1)[:, :k]
    strided = ei_ops.apply_factored(blk, diag, wide)
    torch.cuda.synchronize()
    assert kc.launches()["apply_factored"] == 2
    assert torch.equal(got, want) and torch.equal(strided, want)


@pytest.mark.parametrize("k", [1, 2])
def test_apply_factored_unaligned_views(dev, k):
    """Views 4 bytes past a 16-byte boundary (contiguous, so the wrapper
    passes them as they are; the kernel assumes no alignment): bitwise."""
    B, D = 4, 3072
    g = torch.Generator().manual_seed(k)
    z = torch.randn(B * k * D + 1, generator=g).to(dev)[1:].view(B, k, D)
    diag = torch.randn(B * D + 1, generator=g).to(dev)[1:].view(B, D)
    blk = torch.randn(B, k, k, generator=g).to(dev)
    assert z.data_ptr() % 16 and diag.data_ptr() % 16
    kc.reset_launches()
    got = ei_ops.apply_factored(blk, diag, z)
    want = ei_ref.apply_factored_ref(blk, diag, z)
    torch.cuda.synchronize()
    assert kc.launches()["apply_factored"] == 1
    assert torch.equal(got, want)


def test_ei_update_refuses_what_it_does_not_take(dev):
    u = torch.zeros(2, 2, 8, device=dev)
    with pytest.raises(ValueError):                      # q = 5 > 4
        ei_ops.ei_update(u, torch.zeros(5, 2, 2, 8, device=dev),
                         torch.eye(2), torch.zeros(5, 2, 2))
    with pytest.raises(ValueError):                      # k = 3 > 2
        ei_ops.ei_update(torch.zeros(2, 3, 8, device=dev),
                         torch.zeros(1, 2, 3, 8, device=dev),
                         torch.eye(3), torch.zeros(1, 3, 3))
    with pytest.raises(TypeError):                       # eps dtype differs
        ei_ops.ei_update(u, torch.zeros(1, 2, 2, 8, device=dev,
                                        dtype=torch.bfloat16),
                         torch.eye(2), torch.zeros(1, 2, 2))
    with pytest.raises(ValueError):                      # C of another q
        ei_ops.ei_update(u, torch.zeros(1, 2, 2, 8, device=dev),
                         torch.eye(2), torch.zeros(2, 2, 2))
    with pytest.raises(TypeError):                       # f64 state
        ei_ops.apply_factored(torch.zeros(2, 2, 2, device=dev),
                              torch.zeros(2, 8, device=dev),
                              torch.zeros(2, 2, 8, device=dev,
                                          dtype=torch.float64))



# ---------------------------------------------------------------------------
# training: the DiT attention's gradient, a training step, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dit_attention_gradient_matches_plain_version(dev, Dh, dtype):
    """With grad on, the DiT form runs the forward kernel once (counted)
    and the plain backward; dq, dk, dv against torch autograd through the
    plain version in f32 on the same values: f32 within 1e-5 of each
    gradient's scale, bf16 within 2 bf16 ulp (the backward computes in f32
    and rounds once).  With grad off the call is the forward alone."""
    g = torch.Generator().manual_seed(Dh)
    shape = (4, 256, 12 if Dh == 64 else 2, Dh)
    q, k, v, do = (torch.randn(shape, generator=g).to(dev, dtype)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kc.reset_launches()
    out = attn_ops.attention(*leaves, causal=False)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert kc.launches()["flash_attention"] == 1
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_leaves, causal=False),
                               ref_leaves, do.float())
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        if dtype == torch.float32:
            assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
        else:
            assert _bf16_ulps(a, b.to(dtype)) <= 2
    with torch.no_grad():
        plain = attn_ops.attention(*leaves, causal=False)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())
    with pytest.raises(NotImplementedError):   # no gradient at q_offset > 0
        attn_ops.attention(leaves[0][:, :8], *leaves[1:], causal=True,
                           q_offset=5)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("rep", [1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_attention_gradient_matches_plain_version(dev, rep, window,
                                                     dtype):
    """With grad on, the causal form at q_offset 0 and Sq == Sk (LM
    training) runs `FlashAttention`: the forward kernel once (counted, and
    counted as its instance, windowed or global) and the plain backward;
    the output and dq, dk, dv against torch autograd through the plain
    version in f32 on the same values: f32 within 2e-5 (output) and 1e-5
    of each gradient's scale, bf16 within 2 bf16 ulp."""
    g = torch.Generator().manual_seed(rep)
    B, S, Hkv, Dh = 2, 160, 2, 64
    q, do = (torch.randn(B, S, Hkv * rep, Dh, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, Dh, generator=g).to(dev, dtype)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kc.reset_launches()
    out = attn_ops.attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    n = kc.launches()
    inst = attn_ops.WINDOW_COUNT if window else attn_ops.GLOBAL_COUNT
    assert n["flash_attention"] == n[inst] == 1
    assert "FlashAttention" in type(out.grad_fn).__name__
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = attention_ref(*ref_leaves, causal=True, window=window)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    for a, b, tol in [(out.detach(), ref_out.detach(), 2e-5)] + [
            (a, b, 1e-5) for a, b in zip(got, want)]:
        assert a.dtype == dtype and torch.isfinite(a).all()
        if dtype == torch.float32:
            assert float((a - b).abs().max() / b.abs().max()) <= tol
        else:
            assert _bf16_ulps(a, b.to(dtype)) <= 2


def test_reduced_lm_train_steps_card_match_cpu(dev):
    """Three `make_train_step` steps of reduced gemma3-1b (f32, remat off:
    one flash_attention launch a layer a step) on the card and on the CPU
    from the same weights and batches: losses within 1e-5 relative, the
    params within 2 lr a step everywhere and within 1e-6 for 99%."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models.registry import Arch
    from repro_torch.models.transformer import param_list
    from repro_torch.optim.adamw import AdamWCfg, adamw_init
    arch = Arch(get_arch("gemma3-1b", reduced=True))
    cfg = AdamWCfg(lr=3e-4, warmup_steps=5, total_steps=3)
    pipe = TokenPipeline(arch.cfg.vocab, 64, 4, seed=0)
    from repro_torch.ckpt.store import tree_flatten, tree_unflatten
    params = {"cpu": arch.init(seed=0, device="cpu")}
    leaves, structure = tree_flatten(params["cpu"])
    params["cuda"] = tree_unflatten(structure, [t.to(dev) for t in leaves])
    for p in params.values():
        for t in param_list(p):
            t.requires_grad_()
    states = {d: adamw_init(param_list(p), cfg) for d, p in params.items()}
    step_fn = steps.make_train_step(arch, cfg)
    kc.reset_launches()
    for i in range(3):
        tokens, labels = (torch.from_numpy(x) for x in pipe.batch_at(i))
        m = {d: step_fn(p, states[d], {"tokens": tokens.to(d),
                                       "labels": labels.to(d)})
             for d, p in params.items()}
        assert abs(float(m["cuda"]["loss"]) - float(m["cpu"]["loss"])) \
            <= 1e-5 * abs(float(m["cpu"]["loss"]))
    assert kc.launches()["flash_attention"] == 3 * arch.cfg.n_layers
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().ravel()
                       for a, b in zip(param_list(params["cuda"]),
                                       param_list(params["cpu"]))])
    assert float(diffs.max()) <= 2 * cfg.lr * 3
    assert float((diffs > 1e-6).float().mean()) <= 1e-2


def _reduced_cld(grid_substeps=1):
    import dataclasses
    from repro_torch.configs import get_diffusion
    return dataclasses.replace(get_diffusion("cifar10-cld", reduced=True),
                               sde=CLD(grid_substeps=grid_substeps))


def test_reduced_train_steps_card_match_cpu(dev):
    """Three `make_diffusion_train_step` steps of reduced cifar10-cld (f32,
    remat off) on the card and on the CPU from the same weights, batches
    and keys: losses within 1e-4 relative; the first step's gradients
    within 1e-3 of each leaf's scale; the params within 2 lr a step of each
    other everywhere (AdamW's early steps are near lr * sign(g), so a
    gradient near 0 of another sign moves a param by up to 2 lr) and
    within 1e-6 for 99% of them."""
    from repro_torch.launch import steps
    from repro_torch.launch.train import diffusion_opt_cfg, \
        diffusion_pipeline
    from repro_torch.optim.adamw import adamw_init
    spec = _reduced_cld()
    cfg = diffusion_opt_cfg(3e-4, 3)
    pipe = diffusion_pipeline(spec, 8, 0)
    nets = {d: spec.init(seed=0, device=d).requires_grad_()
            for d in ("cpu", "cuda")}
    states = {d: adamw_init(n.parameters(), cfg) for d, n in nets.items()}
    step_fn = steps.make_diffusion_train_step(spec, cfg)
    for i in range(3):
        x0 = torch.from_numpy(pipe.batch_at(i))
        key = prng.fold_in(prng.PRNGKey(0), i)
        if i == 0:
            grads = {}
            for d, n in nets.items():
                loss = spec.loss(n, x0.to(d), key.to(d))
                grads[d] = torch.autograd.grad(loss, list(n.parameters()))
            for a, b in zip(grads["cuda"], grads["cpu"]):
                assert float((a.cpu() - b).abs().max()
                             / b.abs().max().clamp_min(1e-30)) <= 1e-3
        m = {d: step_fn(n, states[d], {"x0": x0.to(d)}, key.to(d))
             for d, n in nets.items()}
        assert abs(float(m["cuda"]["loss"]) - float(m["cpu"]["loss"])) \
            <= 1e-4 * abs(float(m["cpu"]["loss"]))
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().ravel()
                       for a, b in zip(nets["cuda"].parameters(),
                                       nets["cpu"].parameters())])
    assert float(diffs.max()) <= 2 * cfg.lr * 3
    assert float((diffs > 1e-6).float().mean()) <= 1e-2


def test_checkpoint_from_the_card_restores_on_the_cpu(dev, tmp_path):
    """A train state written from card tensors (bf16 params, f32 moments
    and masters, an int32 step) restores on the CPU byte for byte."""
    from repro_torch import convert
    from repro_torch.ckpt.store import CheckpointStore, tree_flatten
    from repro_torch.optim.adamw import AdamWCfg, adamw_init
    spec = _reduced_cld()
    net = spec.init(seed=3, device=dev).to(torch.bfloat16)
    st = adamw_init(net.parameters(), AdamWCfg())
    st.step.fill_(7)
    for m in st.m:
        m.normal_()
    store = CheckpointStore(str(tmp_path))
    store.save(7, convert.train_state_tree(net, st))
    store.wait()
    cpu_net = spec.init(seed=0, device="cpu").to(torch.bfloat16)
    cpu_st = adamw_init(cpu_net.parameters(), AdamWCfg())
    step, tree = store.restore_latest(convert.train_state_tree(cpu_net,
                                                               cpu_st))
    convert.load_train_state(cpu_net, cpu_st, tree)
    assert step == 7 and int(cpu_st.step) == 7
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for a, b in zip(tree_flatten(convert.train_state_tree(net, st))[0],
                    tree_flatten(convert.train_state_tree(cpu_net,
                                                          cpu_st))[0]):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(bits(a.cpu()), bits(b))


# ---- a kf 1 family in a pool packed for CLD (K 2), mixed fam / prec ------
def _narrow_in_wide(dev, name, corr, D=3072, seed=3):
    """A VPSDE (in-kernel noise) or BDM (streamed noise) commit at kf 1 on a
    K 2 state and a K 2 bank, as in a multi-family engine: this variant is
    (fam 1, prec 0); slot 1 is another precision class of the family, slot
    2 another family, slot 0 retired — all three foreign rows, which must
    come back bitwise, padding rows included."""
    sde, shape, _ = _path(name, D)
    bank = _bank(dev, D, K=2, PB=5)
    x = _state(dev, [1, 2, 3, 1] if corr else [0, 3, 2, 4], bank, D, K=2,
               seed=seed)
    x["fam"] = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    x["prec"] = torch.tensor([0, 2, 0, 0], dtype=torch.int32, device=dev)
    x["active"] = torch.tensor([False, True, True, True], device=dev)
    x["eps_c"] = x["eps_c"][:, :1].contiguous()
    x["eps_n_c"] = x["eps_n_c"][:, :1].contiguous()
    args = (x["u"], x["hist"], x["k"], x["kc"], x["cfg"], x["fam"],
            x["prec"], x["keys"], x["active"], bank, x["eps_c"])
    kw = dict(sde=sde, state_shape=shape, kf=1, fam_index=1, prec_index=0,
              with_corrector=corr, eps_n_c=x["eps_n_c"])
    return bank, x, args, kw


@pytest.mark.parametrize("name", ["ddpm", "bdm"])
@pytest.mark.parametrize("corr", [False, True])
def test_commit_at_kf_1_in_a_K_2_pool(dev, name, corr):
    bank, x, args, kw = _narrow_in_wide(dev, name, corr)
    kc.reset_launches()
    got = rf.round_update(*args, **kw)
    pred = rf.round_predict(x["u"], x["hist"], x["kc"], x["cfg"], bank,
                            x["eps_c"], kf=1)
    want = rf_ref.round_update_ref(*args, **kw)
    pred_ref = rf_ref.round_predict_ref(x["u"], x["hist"], x["kc"],
                                        x["cfg"], bank, x["eps_c"], kf=1)
    torch.cuda.synchronize()
    n = kc.launches()
    assert n["round_fused"] == 1 and n["round_predict"] == 1
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    det = ~bank.stochastic[x["cfg"]]
    assert torch.equal(got[0][det], want[0][det])
    assert torch.equal(got[1], want[1])
    for i in (0, 1, 2):                                  # foreign rows
        assert torch.equal(got[0][i], x["u"][i])
        assert torch.equal(got[1][i], x["hist"][i])
        assert got[2][i] == x["k"][i]
    assert torch.equal(got[0][3, 1], x["u"][3, 1])       # the padding row
    assert torch.equal(pred, pred_ref)
    if name == "bdm":
        noise = rf_ref.draw_step_noise(x["keys"], x["kc"],
                                       bank.alg[x["cfg"]], kw["state_shape"])
        noise_c = kw["sde"].canonicalize(noise).contiguous()
        want_s = rf_ref.round_update_ref(*args, noise_c=noise_c, **kw)
        got_s = rf.round_fused(*args, x["eps_n_c"], noise_c, kf=1, n=3072,
                               fam_index=1, with_corrector=corr)
        torch.cuda.synchronize()
        for a, b in zip(got_s, want_s):
            assert torch.equal(a, b)


def test_dct2_on_the_kf_slice_of_a_K_2_pool(dev):
    """BDM's rows in a K 2 pool: the slice the round step takes is strided,
    which the kernel refuses; BDM's decanonicalize copies it first and is
    one dct2 launch, within 1e-6 of max |x| of the plain version."""
    g = torch.Generator().manual_seed(5)
    u = torch.randn(4, 2, 3072, generator=g).to(dev)
    sde = BDM(data_shape=(32, 32, 3))
    with pytest.raises(ValueError):
        dct_ops.dct2(u[:, :1].reshape(4, 32, 32, 3), inverse=True)
    kc.reset_launches()
    got = sde.decanonicalize(u[:, :1], (32, 32, 3))
    want = dct_ref.idct2_ref(u[:, :1].reshape(4, 32, 32, 3).cpu())
    torch.cuda.synchronize()
    assert kc.launches()["dct2"] == 1
    assert float((got.cpu() - want).abs().max()) <= \
        1e-6 * float(u.abs().max())


def test_f32_flash_attention_at_the_dit_shape(dev):
    """The DiT's attention under the int8 class at full width: f32 q, k, v
    at (4, 256, 12, 64), within 2e-5 of the plain version."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(4, 256, 12, 64, generator=g).to(dev)
               for _ in range(3))
    kc.reset_launches()
    got = attn_ops.attention(q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kc.launches()["flash_attention"] == 1
    assert float((got - want).abs().max()) <= 2e-5


def test_bf16_dh80_runs_the_mma_lm_kernel(dev):
    """d_head 80 (zamba2-2.7b's shared block) is never padded: a bf16
    causal call launches `flash_lm_mma_kernel<80, ...>`, an f32 one
    `flash_lm_kernel<80, ...>`, and a non-causal Sq == Sk call the general
    form's non-causal instance (the DiT form takes 32 / 64 / 128); one
    launch a call (counted), each within its tolerance of the plain
    version."""
    g = torch.Generator().manual_seed(80)
    q, k, v = (torch.randn(2, 200, 4, 80, generator=g).to(dev)
               for _ in range(3))
    for causal in (True, False):
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (q, k, v)]
            attn_ops.attention(*x, causal=causal)         # build, opt in
            torch.cuda.synchronize()
            kc.reset_launches()
            # three calls in the trace: CUPTI may drop a trace's first
            # device events on that machine
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    got = attn_ops.attention(*x, causal=causal)
                torch.cuda.synchronize()
            n = kc.launches()
            assert n["flash_attention"] == 3
            assert n.get(attn_ops.CROSS_COUNT, 0) == (0 if causal else 3)
            names = {e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "flash" in e.name}
            want = ("flash_lm_kernel<80" if dtype == torch.float32
                    else "flash_lm_mma_kernel<80")
            assert len(names) == 1 and want in names.pop()
            _close(got, attention_ref(*x, causal=causal), dtype, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dh80_attention_gradient_matches_plain_version(dev, dtype):
    """The causal form with a gradient at d_head 80 (zamba2-2.7b's
    training shape, cut to 2 x 256): the forward kernel once inside
    `FlashAttention`, the output and dq, dk, dv against torch autograd
    through the plain version in f32: f32 within 2e-5 / 1e-5 of scale,
    bf16 within 2 bf16 ulp."""
    g = torch.Generator().manual_seed(81)
    q, do, k, v = (torch.randn(2, 256, 8, 80, generator=g).to(dev, dtype)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kc.reset_launches()
    out = attn_ops.attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert kc.launches()["flash_attention"] == 1
    assert "FlashAttention" in type(out.grad_fn).__name__
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = attention_ref(*ref_leaves, causal=True)
    want = torch.autograd.grad(ref_out, ref_leaves, do.float())
    for a, b, tol in [(out.detach(), ref_out.detach(), 2e-5)] + [
            (a, b, 1e-5) for a, b in zip(got, want)]:
        assert a.dtype == dtype and torch.isfinite(a).all()
        if dtype == torch.float32:
            assert float((a - b).abs().max() / b.abs().max()) <= tol
        else:
            assert _bf16_ulps(a, b.to(dtype)) <= 2


@pytest.mark.parametrize("nb", [1, 2, 4, 8, 16])
def test_dh80_decode_attention_at_every_cluster_size(dev, nb):
    """decode_attention at d_head 80 (bf16 and f32, rep 1 and 4) at every
    cluster size, the entry point called directly: within 2 bf16 ulp /
    1e-5 of the plain version."""
    import ctypes
    import math
    fn = kc.function("decode_attention", "repro_decode_attention",
                     dec_ops._ARGS)
    g = torch.Generator().manual_seed(nb)
    for rep in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            B, Hkv, S, Dh = 3, 2, 200, 80
            q = torch.randn(B, Hkv * rep, Dh, generator=g).to(dev, dtype)
            k, v = (torch.randn(B, S, Hkv, Dh, generator=g).to(dev, dtype)
                    for _ in range(2))
            cl = torch.tensor([1, 150, 200], dtype=torch.int32, device=dev)
            out = torch.empty_like(q)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(),
                    out.data_ptr(), B, S, Hkv, rep, Dh, 0,
                    dec_ops._DTYPES[dtype], ctypes.c_float(1 / math.sqrt(Dh)),
                    nb, kc.stream_ptr(q))
            kc.check("decode_attention", rc, f"decode_attention nb {nb}")
            torch.cuda.synchronize()
            _close(out, decode_attention_ref(q, k, v, cl), dtype, 1e-5)


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b"])
def test_reduced_recurrent_card_matches_cpu(dev, name):
    """Reduced rwkv6-7b and zamba2-2.7b (f32) on the card and on the CPU
    with the same seeded weights: the logits of a prefill within 1e-4 of
    scale and a TokenEngine serve of 5 requests with equal token streams;
    rwkv launches no attention kernel, zamba one flash_attention a group a
    wave and one decode_attention a group a round."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import Arch
    from repro_torch.serve import ServeRequest, TokenEngine
    arch = Arch(get_arch(name, reduced=True))
    params = arch.init(seed=2, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, 256, (2, 40)))
    want = arch.prefill(params, {"tokens": toks}, 48)[0]
    from repro_torch.ckpt.store import tree_flatten, tree_unflatten
    leaves, structure = tree_flatten(params)
    on_card = tree_unflatten(structure, [t.to(dev) for t in leaves])
    got = arch.prefill(on_card, {"tokens": toks.to(dev)}, 48)[0]
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-4
    reqs = [ServeRequest(rid=i, workload="token", max_new=6,
                         tokens=rng.integers(2, 256, 5 + i % 2).astype(
                             np.int32)) for i in range(5)]
    out = {}
    for d in ("cuda", "cpu"):
        kc.reset_launches()
        eng = TokenEngine(arch, params, batch_size=2, max_len=24, device=d)
        out[d] = eng.serve(reqs)
        if d == "cuda":
            n = kc.launches()
            groups = getattr(arch.cfg, "n_groups", 0)
            assert n.get("flash_attention", 0) == groups * eng.n_prefill_calls
            assert n.get("decode_attention", 0) == \
                groups * eng.n_decode_steps
    for r in reqs:
        np.testing.assert_array_equal(out["cuda"][r.rid], out["cpu"][r.rid])
