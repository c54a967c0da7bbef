"""Global random state.

Three streams, all under `seed()`:

  host     `np_rng()` is numpy's global RandomState. Initializers and
           iterators draw through it, so under the same `mx.random.seed`
           the port's initial weights are bit-identical to the JAX
           package's.
  device   one `torch.Generator` per device (`generator(device)`), for
           ops that need random bits (Dropout); compared with the JAX
           package's draws by their statistics.
  key      the JAX package's own key chain (`next_key`, a jax.random
           threefry2x32 key split at each draw) rebuilt on torch
           integers. `uniform`, `normal` and `exponential` draw
           jax.random's float32 values bit for bit: the inverse error
           function and log1p are XLA's own polynomials for the CPU, run
           op by op with its fused multiply-adds (`_fma`). SGLD's noise
           and the `uniform`, `normal` and `exponential` sampler ops are
           the JAX package's under the same seed.

A key is a pair of 32-bit halves. They may be Python integers or int64
tensors of one shape S; `fold_in`, `uniform` and `gumbel` then work on
S keys at once, one independent stream a key, all on the keys' device
with no read back to the host (the decode tier's per-row streams,
decoding/sampling.py).
"""
from __future__ import annotations

import math
import threading

import numpy as _np
import torch

_DEFAULT_SEED = 0
_lock = threading.Lock()
_seed = _DEFAULT_SEED
_generators: dict = {}

def np_rng():
    """numpy's global RandomState (steered by `seed()` and by plain
    `np.random.seed`)."""
    return _np.random.mtrand._rand


def seed(seed_state: int):
    """Seed numpy's global generator, every device generator and the
    key chain."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        _generators.clear()
    _np.random.seed(int(seed_state) & 0xFFFFFFFF)
    _keys.key = _seed_key(int(seed_state))


def generator(device):
    """The torch.Generator of `device`, created from the current seed
    at first use."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed)
            _generators[key] = gen
    return gen


# ------------------------------------------------- the JAX key chain
_keys = threading.local()
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _seed_key(seed_state):
    """jax.random.PRNGKey(seed) with 32-bit integers: (0, seed)."""
    return (0, int(seed_state) & _M32)


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2): uint32 arithmetic on int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(step + 1) % 3]) & _M32
        x2 = (x2 + ks[(step + 2) % 3] + step + 1) & _M32
    return x1, x2


def _bits(key, n, device="cpu"):
    """n random 32-bit words of `key` (jax's partitionable
    random_bits): the hash of the counters 0..n-1, halves XORed. Keys
    of shape S give (S..., n) words on the keys' device."""
    k1, k2 = (k.unsqueeze(-1) if torch.is_tensor(k) else k for k in key)
    if torch.is_tensor(k1):
        device = k1.device
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def fold_in(key, data):
    """jax.random.fold_in(key, data) for 32-bit `data`: the hash of the
    counter pair (0, data) under the key. `data` may be an int64 tensor
    broadcasting against the key's halves."""
    return _threefry2x32(key[0], key[1], 0, data & _M32)


def split(key):
    """(new state, subkey): jax.random.split(key) of the chain (Python
    integers: a split is host work)."""
    return (_threefry2x32(key[0], key[1], 0, 0),
            _threefry2x32(key[0], key[1], 0, 1))


def next_key():
    """A fresh key of the chain (jax.random.split of the state)."""
    key = getattr(_keys, "key", None)
    if key is None:
        key = _seed_key(_DEFAULT_SEED)
    _keys.key, out = split(key)
    return out


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 log1p on the CPU: a rational function for |x| < sqrt(2)
# - 1 (Cephes's), else Cephes's logf of 1 + x. XLA's CPU compiler lets
# LLVM contract a product feeding a sum into one fused multiply-add, so
# each `_fma` below is one rounding where XLA's machine code has one
_LOG1P_NUM = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
              57.112965, 20.039553)
_LOG1P_DEN = (1.0, 15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
              60.11866)
_LOGF_P = (0.070376836, -0.1151461, 0.116769984, -0.12420141, 0.14249323,
           -0.16668057, 0.20000714, -0.24999994, 0.3333333)


def _f32(*values):
    return [float(_np.float32(v)) for v in values]


def _fma(a, b, c):
    """a * b + c in float32 with one rounding: the product is exact in
    float64, and where the float64 sum lands on a float32 rounding tie
    its exact error (TwoSum) decides the direction."""
    a, b, c = (v.double() if torch.is_tensor(v) else float(v)
               for v in (a, b, c))
    p = a * b
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where(tie & (err != 0), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _logf32(u):
    """Cephes's float32 logf as XLA's CPU backend runs it."""
    p = _f32(*_LOGF_P)
    v = torch.where(u > 1.17549435e-38, u, torch.full_like(u, 1.17549435e-38))
    bits = v.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    below = m < _f32(0.70710677)[0]
    x = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    y0 = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(_fma(y0, x3, y1), x3, y2), x3, e * _f32(-2.12194440e-4)[0])
    r = _fma(e, 0.693359375, _fma(-x2, 0.5, x) + y)
    r = torch.where(u <= 0, torch.full_like(u, float("nan")), r)
    r = torch.where(torch.isnan(u), u, r)
    r = torch.where(u == 0, torch.full_like(u, -float("inf")), r)
    return torch.where(u == float("inf"), u, r)


def _log1p32(x, one_plus_x=None):
    """XLA's float32 log1p on the CPU; `one_plus_x`, when XLA fused the
    sum 1 + x with the product that made x, is that sum."""
    num, den = _f32(*_LOG1P_NUM), _f32(*_LOG1P_DEN)
    zero = x * 0.0
    p, q = zero + num[0], zero + den[0]
    for a in num[1:]:
        p = _fma(p, x, a)
    for b in den[1:]:
        q = _fma(q, x, b)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(torch.abs(x) < _f32(0.41421357)[0], small,
                       _logf32(x + 1.0 if one_plus_x is None
                               else one_plus_x))


def _erfinv32(x):
    """XLA's float32 inverse error function (Giles's polynomials of
    w = -log1p(-x²))."""
    w = -_log1p32(x * -x)
    lt = w < 5.0
    # the float32 square root correctly rounded (torch's float32 kernel
    # may miss by an ulp; a float64 root rounds once more, harmlessly)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0], dtype=x.dtype,
                                     device=x.device),
                    torch.tensor(_ERFINV_GE5[0], dtype=x.dtype,
                                 device=x.device))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(
            lt, torch.tensor(a, dtype=x.dtype, device=x.device),
            torch.tensor(b, dtype=x.dtype, device=x.device)))
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def uniform(key, shape, low=0.0, high=1.0, device="cpu",
            dtype=torch.float32):
    """jax.random.uniform(key, shape, float32, low, high) bit for bit:
    the bits' 23 high ones as a mantissa in [1, 2), less one, scaled
    with one rounding (XLA fuses the multiply and the add). Keys of
    shape S give (S + shape) values, one draw a key."""
    bits = _bits(key, math.prod(shape), device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    low32, high32 = float(_np.float32(low)), float(_np.float32(high))
    scale = float(_np.float32(high32 - low32))
    out = _fma(floats, scale, low32)
    out = torch.clamp_min(out, low32)
    return out.reshape(tuple(bits.shape[:-1]) + tuple(shape)).to(dtype)


_TINY32 = float(_np.finfo(_np.float32).tiny)


def gumbel(key, shape, device="cpu"):
    """jax.random.gumbel(key, shape) in float32 bit for bit (its default
    mode): -log(-log(u)) of uniforms u in [tiny, 1), both logs XLA's CPU
    logf. Keys of shape S give (S + shape) values."""
    u = uniform(key, shape, _TINY32, 1.0, device)
    return -_logf32(-_logf32(u))


def normal(key, shape, device="cpu", dtype=torch.float32):
    """jax.random.normal(key, shape) in float32: uniforms in
    (-1, 1) from the key's bits, through sqrt(2) * erfinv."""
    lo = float(_np.nextafter(_np.float32(-1.0), _np.float32(0.0)))
    u = uniform(key, (math.prod(shape),), lo, 1.0, device)
    out = _erfinv32(u) * float(_np.float32(math.sqrt(2)))
    return out.reshape(shape).to(dtype)


def exponential(key, shape, device="cpu", dtype=torch.float32):
    """jax.random.exponential(key, shape) in float32: -log1p(-u)."""
    return (-_log1p32(-uniform(key, shape, device=device))).to(dtype)


def generator_of(key, device):
    """A torch.Generator on `device` seeded from a key of the chain, for
    draws the chain's own functions do not reproduce (gamma, Poisson)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(key[0]) << 32) | int(key[1]))
    return gen
