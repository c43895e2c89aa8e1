"""JAX's threefry2x32 PRNG, bit for bit, on torch tensors.

The serving noise law of the JAX package (`jax.random.PRNGKey`, `fold_in`,
`split`, `normal`) is keyed through threefry2x32.  Samples are a pure
function of (request seed, sampler config), so the port has to draw the
same bits to serve the same samples.  This module transcribes the plain
array form of that law (the JAX package writes it out for its round kernel:
threefry rounds, fold_in, uniform -> erf_inv normal, the counter layout).

Conventions:

  * A key is an int64 tensor of shape (..., 2) holding two uint32 words.
    int64 keeps the uint32 arithmetic exact on every device: each add and
    shift is masked back to 32 bits.
  * The counter layout is JAX's *non-partitionable* one (the layout of
    `jax_threefry_partitionable=False`, the default of jax 0.4.x): an
    n-element draw encrypts counter pairs (i, i + ceil(n/2)) and lane 0
    covers the first half of the flat output, lane 1 the rest.
  * `normal` reproduces the uniform(-1, 1) -> sqrt(2) * erf_inv pipeline.
    `erf_inv` is XLA's two-branch f32 polynomial over XLA's own f32
    log1p/log, evaluated in fused multiply-add steps (emulated in float64,
    then rounded once).  Against `jax.random.normal` on the CPU the bits
    are exact and the normals are within 2 ulp (about 2e-5 of draws differ,
    from the emulated FMA's double rounding).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF
_TF_MAGIC = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
# key-schedule index pairs injected after each 4-round group i (i = 1..5)
_INJECT = ((1, 2), (2, 0), (0, 1), (1, 2), (2, 0))

# uniform(-1, 1) bounds of jax.random.normal, in f32
NORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
NORM_SCALE = float(np.float32(1.0) - np.float32(NORM_LO))     # rounds to 2.0
SQRT2 = float(np.float32(np.sqrt(2.0)))

# XLA's ErfInv32 coefficients (w < 5 and w >= 5 branches), highest first
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _u32(x: Union[int, Tensor]) -> Union[int, Tensor]:
    return x & _M32


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0: Tensor, x1: Tensor) -> Tuple[Tensor, Tensor]:
    """The 20-round threefry2x32 block cipher.  Keys and counters are int64
    tensors (or ints) of uint32 values; they broadcast against each other."""
    k2 = k0 ^ k1 ^ _TF_MAGIC
    ks = (k0, k1, k2)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, r) ^ x0
        a, b = _INJECT[i]
        x0 = _u32(x0 + ks[a])
        x1 = _u32(x1 + ks[b] + (i + 1))
    return x0, x1


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu") -> Tensor:
    """`jax.random.PRNGKey(seed)` with 32-bit seeds: the key (0, seed)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: Tensor, data: Union[int, Tensor]) -> Tensor:
    """`jax.random.fold_in`: encrypt the counter pair (0, data).  `key` is
    (..., 2); `data` an int or an integer tensor broadcasting against the
    key's leading axes."""
    if not isinstance(data, Tensor):
        data = torch.tensor(int(data) & _M32, dtype=torch.int64,
                            device=key.device)
    data = _u32(data.to(torch.int64))
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o0, o1], dim=-1)


def _counter_pairs(n: int, f: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Counter pair and lane of flat output index `f` in an n-element draw
    (the non-partitionable layout)."""
    half = (n + 1) // 2
    lo = f < half
    i0 = torch.where(lo, f, f - half)
    x1 = i0 + half
    return i0, torch.where(x1 < n, x1, torch.zeros_like(x1)), lo


def bits_at(key: Tensor, f: Tensor, n: int) -> Tensor:
    """uint32 random bits at flat indices `f` of an n-element draw;
    `key[..., 0/1]` broadcast against `f`."""
    i0, x1, lo = _counter_pairs(n, f)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], i0, x1)
    return torch.where(lo, o0, o1)


def random_bits(key: Tensor, shape: Sequence[int]) -> Tensor:
    """`jax.random.bits(key, shape)` (uint32 values in int64)."""
    n = int(math.prod(shape))
    f = torch.arange(n, dtype=torch.int64, device=key.device)
    return bits_at(key, f, n).reshape(tuple(shape))


def split(key: Tensor, num: int = 2) -> Tensor:
    """`jax.random.split(key, num)` -> (num, 2)."""
    return random_bits(key, (num * 2,)).reshape(num, 2)


def bits_to_uniform(bits: Tensor) -> Tensor:
    """uint32 bits -> the centred uniform of `jax.random.normal`, in
    [nextafter(-1, 0), 1).  Every step is one f32 rounding, as in XLA."""
    fb = (bits >> 9) | 0x3F800000
    fl = fb.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(fl * NORM_SCALE + NORM_LO, NORM_LO)


def _fma32(a: Tensor, b, c) -> Tensor:
    """f32 fused multiply-add: the product of two f32 is exact in f64, so
    one f64 add and a rounding to f32 give fmaf(a, b, c) (up to a double
    rounding of the sum, at most one f32 ulp)."""
    b = b.double() if isinstance(b, Tensor) else b
    c = c.double() if isinstance(c, Tensor) else c
    return (a.double() * b + c).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA CPU's f32 log (Cephes polynomial, Eigen's plog layout) and the
# rational log1p branch of XLA's elemental emitter (|x| < sqrt(2) - 1)
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_SMALL = _f32(0.41421356237309504880)


def log_f32(x: Tensor) -> Tensor:
    """XLA CPU's f32 natural log for positive normal inputs: frexp to
    [sqrt(1/2), sqrt(2)), a degree-8 Cephes polynomial in FMA steps, and
    the two-part ln 2 reconstruction."""
    x = torch.clamp_min(x.float(), float(np.finfo(np.float32).tiny))
    i = x.view(torch.int32)
    m = ((i & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = (i >> 23).float() - 126.0
    small = m < _SQRTHF
    tmp = torch.where(small, m, torch.zeros_like(m))
    z = m - 1.0
    e = e - small.float()
    z = z + tmp
    z2 = z * z
    z3 = z2 * z
    y0 = _fma32(z, _LOG_P[0], _LOG_P[1])
    y1 = _fma32(z, _LOG_P[3], _LOG_P[4])
    y2 = _fma32(z, _LOG_P[6], _LOG_P[7])
    y0 = _fma32(y0, z, _LOG_P[2])
    y1 = _fma32(y1, z, _LOG_P[5])
    y2 = _fma32(y2, z, _LOG_P[8])
    y0 = _fma32(y0, z3, y1)
    y0 = _fma32(y0, z3, y2)
    y = _fma32(y0, z3, _LOG_Q1 * e)
    z = z - z2 * 0.5
    z = z + y
    return z + _LOG_Q2 * e


def log1p_f32(x: Tensor) -> Tensor:
    """XLA's f32 log1p: a Cephes rational approximation for |x| < sqrt(2)-1,
    log(1 + x) elsewhere."""
    x = x.float()

    def poly(cs):
        r = torch.full_like(x, cs[0])
        for c in cs[1:]:
            r = _fma32(r, x, c)
        return r

    x2 = x * x
    r = poly(_LOG1P_NUM) / poly(_LOG1P_DEN)
    r = (x * x2) * r
    r = (-0.5 * x2) + r
    r = x + r
    return torch.where(x.abs() < _LOG1P_SMALL, r, log_f32(x + 1.0))


def erf_inv(x: Tensor) -> Tensor:
    """XLA's f32 `erf_inv`: w = -log1p(-x^2); a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3 (w >= 5), times x.  Defined on (-1, 1),
    the range `bits_to_uniform` produces."""
    x = x.float()
    w = -log1p_f32(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, ERFINV_LT5[0]),
                    torch.full_like(x, ERFINV_GE5[0]))
    for c_lt, c_ge in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, c_lt),
                        torch.full_like(x, c_ge))
        p = _fma32(p, w, c)
    return p * x


def bits_to_normal(bits: Tensor) -> Tensor:
    """uint32 bits -> N(0, 1) f32, as `jax.random.normal` draws them."""
    return SQRT2 * erf_inv(bits_to_uniform(bits))


def uniform(key: Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """`jax.random.uniform(key, shape, minval=, maxval=)` in f32: the bits'
    23 high mantissa bits under exponent 0, minus one, on [0, 1); then
    max(minval, u * (maxval - minval) + minval) with the bounds in f32 and
    the product and sum as one fused multiply-add, as XLA computes it.
    With the default bounds that is u itself."""
    fb = (random_bits(key, shape) >> 9) | 0x3F800000
    u = fb.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return u
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(_fma32(u, float(hi - lo), float(lo)), float(lo))


def rademacher(key: Tensor, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> Tensor:
    """`jax.random.rademacher(key, shape, dtype)`: 2 * bernoulli(0.5) - 1,
    the Bernoulli draw being uniform(key, shape) < 0.5."""
    return (2 * (uniform(key, shape) < 0.5).to(torch.int32) - 1).to(dtype)


def normal(key: Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> Tensor:
    """`jax.random.normal(key, shape, dtype)` for a single key (f32 draw,
    cast to `dtype`)."""
    return bits_to_normal(random_bits(key, shape)).to(dtype)


def to_int32_bits(key: Tensor) -> Tensor:
    """uint32 words (int64) -> int32 tensors with the same bit pattern: the
    form the CUDA kernels read as `uint32_t`."""
    return torch.where(key >= 2**31, key - 2**32, key).to(torch.int32)


def from_int32_bits(key: Tensor) -> Tensor:
    """Inverse of `to_int32_bits`."""
    return key.to(torch.int64) & _M32
