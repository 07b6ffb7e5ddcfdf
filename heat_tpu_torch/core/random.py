"""Seeded random numbers, bitwise equal to the JAX package's
(counterpart of heat_tpu/core/random.py).

The JAX package draws every array from the key ``fold_in(PRNGKey(seed),
counter)`` and bumps the counter once per draw.  This module computes the
same Threefry-2x32 hash (20 rounds, the partitionable bit layout: element i
hashes the 64-bit counter i split into its high and low words) and builds
each draw from it as ``jax.random`` does (jax 0.9, partitionable threefry),
so a seeded draw gives the same bits here as there, on any device and at
any world size:

- uniform floats (:func:`rand`, :func:`uniform`, :func:`random_sample` and
  its aliases): random mantissa bits under the exponent of 1.0, minus 1;
- integers (:func:`randint`, :func:`random_integers`, :func:`bytes`): JAX's
  ``_randint``, two bit sets from the two halves of a split key, folded into
  the span by unsigned remainders (:func:`_randint`);
- permutations (:func:`permutation`, :func:`randperm`, :func:`shuffle`,
  :func:`choice` without replacement): JAX's ``_shuffle``, rounds of a
  stable sort on 32-bit keys read as unsigned (:func:`_shuffle_perm`);
- weighted choices: a cumulative sum searched (with replacement), or
  Gumbel keys on top of ``log(p)`` in a stable descending sort (without);
- normal draws: ``sqrt(2) erfinv(u)`` of a uniform ``u`` on
  ``[nextafter(-1, 0), 1)``, with ``erfinv`` evaluated by the polynomials
  XLA's host compiler uses (:func:`_erfinv`, :func:`_log1p`, :func:`_log`):
  float32 draws are within 2 ulp of the JAX package's, nearly all bitwise
  equal, float64 within 3.  The Gumbel keys go through the same ``_log``.

On a CUDA device the hash of a draw is one launch of the hand-written kernel
``csrc/threefry.cu`` (which also writes float32 uniforms directly); it
launches or raises, and ``THREEFRY_LAUNCHES`` counts its launches.  On the
CPU, and only there, the plain version runs: torch has little support for
uint32, so the hash runs on int32 tensors holding the words' bits (additions
wrap modulo 2^32 as unsigned ones do, and right shifts are masked to act as
logical ones).  The two are bitwise equal.  Key splits are hashed on the
host, as key derivation is.
"""

from __future__ import annotations

import builtins
import ctypes
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, arithmetics, types
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

#: launches of the CUDA threefry kernel in this process (the plain version adds nothing)
THREEFRY_LAUNCHES = 0

__all__ = [
    "bytes",
    "choice",
    "default_seed",
    "get_state",
    "normal",
    "permutation",
    "rand",
    "randint",
    "randn",
    "random",
    "random_integer",
    "random_integers",
    "random_sample",
    "randperm",
    "ranf",
    "sample",
    "seed",
    "set_state",
    "shuffle",
    "standard_normal",
    "uniform",
]

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_SIGN64 = 1 << 63
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

__seed: int = 0
__counter: int = 0


def default_seed() -> int:
    """A fresh 31-bit seed from OS entropy."""
    return int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF


def seed(new_seed: Optional[int] = None) -> None:
    """Seed the generator and reset its counter."""
    global __seed, __counter
    __seed = default_seed() if new_seed is None else int(new_seed)
    __counter = 0


def get_state() -> Tuple[str, int, int, int, float]:
    """``("Threefry", seed, counter, 0, 0.0)``, as the JAX package reports it."""
    return ("Threefry", __seed, __counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    """Restore a state from :func:`get_state`."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state needs to be a 3- or 5-tuple")
    if state[0] != "Threefry":
        raise ValueError("this generator is based on Threefry")
    __seed = int(state[1])
    __counter = int(state[2])


def _i32(v: int) -> int:
    """The int32 value that holds the bits of the 32-bit word ``v``."""
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _i64(v: int) -> int:
    """The int64 value that holds the bits of the 64-bit word ``v``."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1), int32 tensors, under the
    key (k0, k1) (python ints holding 32-bit words)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = x0 + _i32(ks[0])
    x1 = x1 + _i32(ks[1])
    for i in range(1, 6):
        for r in _ROTATIONS[(i - 1) % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + _i32(ks[i % 3])
        x1 = x1 + _i32(ks[(i + 1) % 3] + i)
    return x0, x1


def _key_from_seed(s: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(s)``: the 64-bit seed as two 32-bit words."""
    s &= (1 << 64) - 1
    return s >> 32, s & _M32


def _next_key() -> Tuple[int, int]:
    """``fold_in(PRNGKey(seed), counter)``, then bump the counter."""
    global __counter
    k0, k1 = _key_from_seed(__seed)
    data = torch.tensor([_i32(__counter)], dtype=torch.int32)
    a, b = _threefry2x32(k0, k1, torch.zeros_like(data), data)
    __counter += 1
    return int(a) & _M32, int(b) & _M32


def _random_bits_plain(key: Tuple[int, int], n: int, device: torch.device, start: int = 0):
    """The two hash words of counters start..start+n-1 (JAX's partitionable
    layout), as int32 tensors, in plain torch."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return _threefry2x32(key[0], key[1], (i >> 32).to(torch.int32), (i & _M32).to(torch.int32))


def _unit_f32_plain(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """float32 on [0, 1) from the hash words: 23 random mantissa bits under
    the exponent of 1.0, minus 1 (``jax.random.uniform``'s construction)."""
    bits = (((b0 ^ b1) >> 9) & 0x7FFFFF) | 0x3F800000
    return bits.view(torch.float32) - 1.0


_THREEFRY_LIB = None


def _threefry_cuda(key: Tuple[int, int], n: int, device: torch.device, start: int, uniform: bool):
    """Launch csrc/threefry.cu on PyTorch's current stream (no synchronise):
    the float32 uniforms of counters start..start+n-1, or their two hash
    words as int32 tensors."""
    global _THREEFRY_LIB, THREEFRY_LAUNCHES
    if start < 0 or start + n > 1 << 63:
        raise ValueError(f"the kernel hashes counters below 2^63, got {start}..{start + n - 1}")
    if n == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=device)
        return empty.view(torch.float32) if uniform else (empty, empty)
    if _THREEFRY_LIB is None:
        lib = _build.load("threefry")
        lib.heat_threefry2x32.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.heat_threefry2x32.restype = ctypes.c_int
        _THREEFRY_LIB = lib
    if uniform:
        out = torch.empty((n,), dtype=torch.float32, device=device)
        ptrs = (None, None, out.data_ptr())
    else:
        out = (torch.empty((n,), dtype=torch.int32, device=device), torch.empty((n,), dtype=torch.int32, device=device))
        ptrs = (out[0].data_ptr(), out[1].data_ptr(), None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _THREEFRY_LIB.heat_threefry2x32(key[0], key[1], start, n, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    THREEFRY_LAUNCHES += 1
    return out


def _hash_device(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no threefry hash for device {device}")
    return device.type


def _random_bits(key: Tuple[int, int], n: int, device: torch.device, start: int = 0):
    """The two hash words of counters start..start+n-1 (JAX's partitionable
    layout), as int32 tensors: the CUDA kernel on a CUDA device (or a
    raise), the plain version on the CPU."""
    if _hash_device(device) == "cuda":
        return _threefry_cuda(key, n, device, start, False)
    return _random_bits_plain(key, n, device, start)


def _unit_f32(key: Tuple[int, int], n: int, device: torch.device) -> torch.Tensor:
    """``jax.random.uniform``'s float32 on [0, 1) of counters 0..n-1:
    written by the CUDA kernel on a CUDA device (or a raise), the plain
    version on the CPU."""
    if _hash_device(device) == "cuda":
        return _threefry_cuda(key, n, device, 0, True)
    return _unit_f32_plain(*_random_bits_plain(key, n, device))


def _uniform(key: Tuple[int, int], shape, dtype, device: torch.device, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, lo, hi)``: random mantissa
    bits under the exponent of 1.0, minus 1, scaled to [lo, hi)."""
    n = 1
    for s in shape:
        n *= s
    if dtype is types.float32:
        floats = _unit_f32(key, n, device)
    elif dtype is types.float64:
        b0, b1 = _random_bits(key, n, device)
        w0, w1 = b0.to(torch.int64) & _M32, b1.to(torch.int64) & _M32
        bits = (w0 << 20) | (w1 >> 12) | 0x3FF0000000000000  # the 64-bit word >> 12
        floats = bits.view(torch.float64) - 1.0
    else:
        raise ValueError(f"rand draws float32 or float64, got {dtype.__name__}")
    if (lo, hi) != (0.0, 1.0):
        # scaled and shifted by one fused multiply-add, as XLA contracts it
        lo_t = torch.tensor(lo, dtype=floats.dtype, device=device)
        span = torch.tensor(hi, dtype=floats.dtype, device=device) - lo_t
        fma = _fma32 if dtype is types.float32 else _fma64
        floats = torch.maximum(fma(floats, span.expand_as(floats), lo_t), lo_t)
    return floats.reshape(shape)


def _split(key: Tuple[int, int], num: int = 2) -> Tuple[Tuple[int, int], ...]:
    """``jax.random.split(key, num)`` (``_threefry_split_foldlike``): new key
    i is the hash words of counter i under ``key``, hashed on the host."""
    b0, b1 = _random_bits_plain(key, num, torch.device("cpu"))
    return tuple((int(b0[i]) & _M32, int(b1[i]) & _M32) for i in range(num))


def _bits32(key: Tuple[int, int], n: int, device: torch.device) -> torch.Tensor:
    """JAX's 32 random bits of counters 0..n-1, ``w0 ^ w1``, as int32
    holding the bits."""
    b0, b1 = _random_bits(key, n, device)
    return b0 ^ b1


def _bits64(key: Tuple[int, int], n: int, device: torch.device) -> torch.Tensor:
    """JAX's 64 random bits of counters 0..n-1, ``(w0 << 32) | w1``, as
    int64 holding the bits."""
    b0, b1 = _random_bits(key, n, device)
    return (b0.to(torch.int64) << 32) | (b1.to(torch.int64) & _M32)


def _rem(a: int, s: int) -> int:
    """XLA's unsigned remainder of host words: ``a mod s``, and ``a`` where
    ``s`` is 0."""
    return a % s if s else a


def _urem64(a: torch.Tensor, s: int) -> torch.Tensor:
    """XLA's unsigned remainder of the 64-bit words held in the int64 tensor
    ``a`` by the host word ``s`` (``a`` itself where ``s`` is 0).  torch has
    no unsigned 64-bit remainder, so: a divisor of 2^63 or more is subtracted
    at most once (a < 2^64 <= 2 s), compared as unsigned by flipping both
    sign bits; a smaller one divides the low 63 bits, and a word with its top
    bit set adds 2^63 mod s, reduced once more (every step within int64)."""
    if s == 0:
        return a
    if s >= _SIGN64:
        return torch.where((a ^ _i64(_SIGN64)) >= _i64(s ^ _SIGN64), a - _i64(s), a)
    low = torch.remainder(a & (_SIGN64 - 1), s)
    top = low - (s - _SIGN64 % s)  # low + (2^63 mod s) - s, in (-s, s)
    return torch.where(a < 0, torch.where(top < 0, top + s, top), low)


def _randint(key: Tuple[int, int], shape, low: int, high: int, dtype, device: torch.device) -> torch.Tensor:
    """``jax.random.randint(key, shape, low, high, dtype)`` for int32 and
    int64 (``_randint``): the high bits from the first half of the split
    key, the low bits from the second, folded into the span modulo 2^nbits.
    The span and its multiplier are host words; the bits are tensors holding
    unsigned words (int64 for both widths)."""
    nbits = 64 if dtype is types.int64 else 32
    dmin, dmax = -(1 << (nbits - 1)), (1 << (nbits - 1)) - 1
    mask = (1 << nbits) - 1
    if not -(1 << 63) <= low < 1 << 63 or not -(1 << 63) <= high < 1 << 63:
        raise OverflowError(f"randint bounds must be int64 values, got {low} and {high}")
    out_of_range = high > dmax
    low, high = min(max(low, dmin), dmax), min(max(high, dmin), dmax)
    span = 1 if high <= low else (high - low) & mask
    if out_of_range and high > low:
        span = (span + 1) & mask  # may wrap to 0: the remainders then do nothing
    multiplier = _rem((_rem(1 << (nbits // 2), span) ** 2) & mask, span)
    k1, k2 = _split(key)
    n = math.prod(shape)
    if nbits == 64:
        hi_bits, lo_bits = _bits64(k1, n, device), _bits64(k2, n, device)
        offset = _urem64(_urem64(hi_bits, span) * multiplier + _urem64(lo_bits, span), span)  # int64 wraps
        return (offset + _i64(low)).reshape(shape)
    hi_bits = _bits32(k1, n, device).to(torch.int64) & _M32
    lo_bits = _bits32(k2, n, device).to(torch.int64) & _M32
    rem = (lambda t: torch.remainder(t, span)) if span else (lambda t: t)
    offset = rem((rem(hi_bits) * multiplier + rem(lo_bits)) & _M32)
    return (((offset + low) & _M32) ^ (1 << 31)).sub(1 << 31).to(torch.int32).reshape(shape)


def _shuffle_rounds(n: int) -> int:
    """JAX's round count for shuffling n items, in float64 as JAX computes
    it: 0 at n = 1, 1 up to 1625, 2 from 1626, 3 from 2642246."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def _shuffle_perm(key: Tuple[int, int], n: int, device: torch.device) -> torch.Tensor:
    """The permutation ``jax.random.permutation(key, n)`` applies
    (``_shuffle``): :func:`_shuffle_rounds` rounds, each a stable sort of
    the positions by 32-bit keys from a fresh split of the key, the keys
    compared as unsigned (their sign bit flipped, so that int32 order is
    uint32 order).  int64 indices."""
    perm = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(_shuffle_rounds(n)):
        key, subkey = _split(key)
        sort_keys = _bits32(subkey, n, device) ^ _i32(1 << 31)
        perm = perm[torch.sort(sort_keys, stable=True).indices]
    return perm


# XLA's erf_inv (M. Giles, "Approximating the erfinv function"): w =
# -log1p(-x^2), then a polynomial in w - c or sqrt(w) - c, each list from the
# highest power down.  float32: two branches split at w = 5.
_ERFINV32 = (
    (5.0, 2.5, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)),
    (None, 3.0, (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)),
)
# float64: three branches, split at w = 6.25 and w = 16
_ERFINV64 = (
    (6.25, 3.125, (
        -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
        1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
        6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
        2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
        1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
        4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
        0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
        0.24015818242558961693, 1.6536545626831027356)),
    (16.0, 3.25, (
        2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
        1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
        2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
        6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
        0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
        -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
        3.0838856104922207635)),
    (None, 5.0, (
        -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
        -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
        2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
        -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
        7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
        1.0103004648645343977, 4.8499064014085844221)),
)


# XLA's log1p (from the Cephes library): x - x^2/2 + x^3 P(x)/Q(x) where
# |x| < sqrt(2) - 1, else log(1 + x); P and Q from the highest power down
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
            2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
            3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """``(s, t)`` with ``s = a + b`` rounded and ``s + t`` exactly ``a + b``
    (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``s + t`` (a pair from :func:`_two_sum`) rounded to odd: ``s`` where
    the sum is exact or ``s``'s last bit is set, else the neighbour of ``s``
    toward ``t``, whose last bit is."""
    even = (s.view(torch.int64 if s.dtype == torch.float64 else torch.int32) & 1) == 0
    return torch.where((t != 0) & even, torch.nextafter(s, t * float("inf")), s)


def _fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` in float32 as one fused multiply-add, as XLA's compiler
    emits it: the product is exact in float64, the sum is rounded to odd
    there, and rounding that to float32 rounds the exact value once (53 bits
    hold 24 + 2)."""
    c = c.double() if torch.is_tensor(c) else torch.full_like(a, c, dtype=torch.float64)
    return _round_to_odd(*_two_sum(a.double() * b.double(), c)).float()


def _veltkamp(a: torch.Tensor):
    """``a`` split into two halves of 26 bits each, ``hi + lo == a``."""
    big = a * 134217729.0  # 2^27 + 1
    hi = big - (big - a)
    return hi, a - hi


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float64 as one fused multiply-add (Boldo and
    Melquiond's emulation): the exact product ``uh + ul`` (Dekker), ``c + uh
    = th + tl`` exactly, then ``th + RO(tl + ul)`` rounded once."""
    uh = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c.expand_as(uh), uh)
    return th + _round_to_odd(*_two_sum(tl, ul))


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    """The polynomial with ``coefs`` (highest power first) at ``x``, by fused
    multiply-adds in float32."""
    if x.dtype != torch.float32:
        p = torch.full_like(x, coefs[0])
        for c in coefs[1:]:
            p = p * x + c
        return p
    p = torch.full_like(x, float(np.float32(coefs[0])))
    for c in coefs[1:]:
        p = _fma32(p, x, float(np.float32(c)))
    return p


# XLA's float32 log on the host (Cephes' logf, as in Eigen): x = m 2^e with m
# in [sqrt(1/2), sqrt(2)), log(x) = (m - 1) - (m - 1)^2/2 + (m - 1)^3 P(m - 1) + e log(2)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` of positive ``x`` as XLA computes it on the host: in float32
    its own polynomial (``torch.log`` differs in 7% of the values), in
    float64 the library's."""
    if x.dtype != torch.float32:
        return torch.log(x)
    bits = torch.clamp(x, min=float(np.finfo(np.float32).tiny)).view(torch.int32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # x's mantissa in [0.5, 1)
    low = m < float(np.float32(0.707106781186547524))
    e = (((bits >> 23) & 0xFF) - 0x7E).float() - low.float()
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    c = [float(np.float32(v)) for v in _LOG_P]
    y = _fma32(_fma32(t, torch.full_like(t, c[0]), c[1]), t, c[2])
    y1 = _fma32(_fma32(t, torch.full_like(t, c[3]), c[4]), t, c[5])
    y2 = _fma32(_fma32(t, torch.full_like(t, c[6]), c[7]), t, c[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2) * x3
    y = y + float(np.float32(-2.12194440e-4)) * e
    out = ((t - 0.5 * x2) + y) + 0.693359375 * e
    return torch.where(x > 0, out, torch.where(x == 0, float("-inf"), float("nan")))


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` as XLA computes it on the host (``torch.log1p`` is up
    to 128 ulp away from it in float64, near |x| = sqrt(2) - 1)."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q)))
    return torch.where(x.abs() < 0.41421356237309504880, small, _log(x + 1.0))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function as XLA computes it, in ``x``'s dtype
    (``torch.erfinv`` is up to 64 ulp away from it in float32).  The first
    branch is evaluated in ``w - c``, the others in ``sqrt(w) - c``; each
    element takes the first branch whose bound exceeds its ``w``."""
    branches = _ERFINV32 if x.dtype == torch.float32 else _ERFINV64
    w = -_log1p(-x * x)
    root = torch.sqrt(w)
    out = None
    for i in reversed(range(len(branches))):
        bound, shift, coefs = branches[i]
        p = _horner((w if i == 0 else root) - shift, coefs)
        out = p if bound is None else torch.where(w < bound, p, out)
    out = out * x
    return torch.where(x.abs() == 1, x * float("inf"), out)


def _normal(key: Tuple[int, int], shape, dtype, device: torch.device) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) erfinv(u)``, u
    uniform on [nextafter(-1, 0), 1)."""
    np_dtype = np.float32 if dtype is types.float32 else np.float64
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    u = _uniform(key, shape, dtype, device, lo, 1.0)
    return _erfinv(u) * torch.tensor(float(np_dtype(np.sqrt(2))), dtype=u.dtype, device=device)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples on [0, 1) of the given shape."""
    shape = sanitize_shape(d if d else (1,))
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    data = _uniform(_next_key(), shape, dtype, device.torch_device)
    return DNDarray.from_dense(data, sanitize_axis(shape, split), device, comm)


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples of the given shape."""
    shape = sanitize_shape(d if d else (1,))
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    data = _normal(_next_key(), shape, dtype, device.torch_device)
    return DNDarray.from_dense(data, sanitize_axis(shape, split), device, comm)


def standard_normal(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples."""
    return randn(*sanitize_shape((1,) if shape is None else shape), dtype=dtype, split=split, device=device, comm=comm)


def normal(mean=0.0, std=1.0, shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Normal samples, ``randn * std + mean``; ``mean`` and ``std`` broadcast
    against ``shape`` (scalars, tensors or DNDarrays)."""
    shape = sanitize_shape((1,) if shape is None else shape)
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    dev = device.torch_device
    std_t = std._dense() if isinstance(std, DNDarray) else torch.as_tensor(std)
    if bool((std_t < 0).any()):
        raise ValueError("std needs to be positive")
    mean_t = mean._dense() if isinstance(mean, DNDarray) else torch.as_tensor(mean)
    data = _normal(_next_key(), shape, dtype, dev) * std_t.to(dev) + mean_t.to(dev)
    return DNDarray.from_dense(data, sanitize_axis(data.shape, split), device, comm)


def _gumbel(key: Tuple[int, int], n: int, dtype, device: torch.device) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), dtype)`` in its default mode ("low"):
    ``-log(-log(u))`` of a uniform ``u`` on [tiny, 1), through :func:`_log`."""
    tiny = float(np.finfo(np.float32 if dtype is types.float32 else np.float64).tiny)
    return -_log(-_log(_uniform(key, (n,), dtype, device, tiny, 1.0)))


def randint(low, high=None, size=None, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Random integers in [low, high); int64 unless ``dtype`` is int32."""
    if high is None:
        low, high = 0, low
    if low >= high:
        raise ValueError("low >= high")
    if size is None:
        size = (1,)
    shape = sanitize_shape(size)
    dtype = types.canonical_heat_type(types.int64 if dtype is None else dtype)
    if dtype not in (types.int64, types.int32):
        raise ValueError(f"Unsupported dtype for randint, got {dtype}")
    device = sanitize_device(device)
    data = _randint(_next_key(), shape, int(low), int(high), dtype, device.torch_device)
    return DNDarray.from_dense(data, sanitize_axis(shape, split), device, comm)


random_integer = randint


def random_integers(low, high=None, size=None, split=None, device=None, comm=None) -> DNDarray:
    """Random integers in the closed interval [low, high] (``low`` 1 when
    ``high`` is not given)."""
    if high is None:
        low, high = 1, low
    return randint(low, int(high) + 1, size=size, split=split, device=device, comm=comm)


def uniform(low=0.0, high=1.0, size=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples on [low, high)."""
    shape = sanitize_shape((1,) if size is None else size)
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    data = _uniform(_next_key(), shape, dtype, device.torch_device, float(low), float(high))
    return DNDarray.from_dense(data, sanitize_axis(shape, split), device, comm)


def random_sample(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples on [0, 1)."""
    return rand(*sanitize_shape((1,) if shape is None else shape), dtype=dtype, split=split, device=device, comm=comm)


random = random_sample
ranf = random_sample
sample = random_sample


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """A DNDarray's global data, a tensor, or array-like data, as a tensor
    on ``device``."""
    if isinstance(a, DNDarray):
        return a._dense().to(device)
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """A permutation of ``range(x)`` (int64), or a copy of ``x`` with its
    rows permuted.  A DNDarray's copy keeps its split, device and comm
    unless they are given."""
    key = _next_key()
    if isinstance(x, DNDarray):
        device = x.device if device is None else sanitize_device(device)
        comm = x.comm if comm is None else comm
        split = x.split if split is None else split
    else:
        device = sanitize_device(device)
    dev = device.torch_device
    if not isinstance(x, DNDarray) and np.ndim(x) == 0:
        if not np.issubdtype(np.asarray(x).dtype, np.integer):
            raise TypeError("x must be an integer or at least 1-dimensional")
        data = _shuffle_perm(key, int(x), dev)
    else:
        data = _as_tensor(x, dev)
        data = data[_shuffle_perm(key, data.shape[0], dev)]
    return DNDarray.from_dense(data, sanitize_axis(data.shape, split), device, comm)


def randperm(n: int, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``range(n)``, int64 unless ``dtype`` is given."""
    if not isinstance(n, int):
        raise TypeError(f"n must be an integer, got {type(n)}")
    dtype = types.canonical_heat_type(types.int64 if dtype is None else dtype)
    device = sanitize_device(device)
    data = _shuffle_perm(_next_key(), n, device.torch_device).to(dtype.torch_type())
    return DNDarray.from_dense(data, sanitize_axis(data.shape, split), device, comm)


def shuffle(x) -> None:
    """Shuffle a DNDarray in place along its first axis."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"x must be a DNDarray, got {type(x)}")
    dense = x._dense()
    x._replace_local(dense[_shuffle_perm(_next_key(), x.shape[0], dense.device)])


def choice(a, size=None, replace: bool = True, p=None, split=None, device=None, comm=None) -> DNDarray:
    """A random sample from the rows of ``a``, or from ``range(a)`` (int64),
    as ``jax.random.choice`` draws it; ``size=None`` gives a 0-d DNDarray."""
    device = sanitize_device(device)
    dev = device.torch_device
    pool = _as_tensor(a, dev)
    if pool.ndim == 0:  # an int: its range
        pool = torch.arange(int(pool), device=dev)
    shape = () if size is None else sanitize_shape(size)
    probs = None if p is None else _as_tensor(p, dev)
    key = _next_key()
    n_in, n_draws = pool.shape[0], math.prod(shape)
    if n_draws == 0:
        data = torch.zeros(shape, dtype=pool.dtype, device=dev)
        return DNDarray.from_dense(data, sanitize_axis(data.shape, split), device, comm)
    if n_in <= 0:
        raise ValueError("a must be greater than 0 unless no samples are taken")
    if not replace and n_draws > n_in:
        raise ValueError(f"Cannot take a larger sample (size {n_draws}) than population (size {n_in}) when "
                         "'replace=False'")
    if probs is None:
        if replace:
            ind = _randint(key, shape, 0, n_in, types.int64, dev)
        else:
            ind = _shuffle_perm(key, n_in, dev)[:n_draws]
    else:
        if probs.dtype not in (torch.float32, torch.float64):
            probs = probs.to(torch.float64)
        if tuple(probs.shape) != (n_in,):
            raise ValueError("p must be None or a 1D vector with the same size as a.shape[axis]. "
                             f"p has shape {tuple(probs.shape)} and a.shape[axis] is {n_in}.")
        dtype = types.canonical_heat_type(probs.dtype)
        if replace:
            cuml = arithmetics._CUMSUM(probs, 0)
            r = cuml[-1] * (1 - _uniform(key, shape, dtype, dev))
            ind = torch.searchsorted(cuml, r.reshape(-1))
        else:
            g = _gumbel(key, n_in, dtype, dev) + _log(probs)
            ind = torch.sort(g, descending=True, stable=True).indices[:n_draws]  # top_k: ties to the lower index
    data = pool[ind.reshape(-1)].reshape(shape + tuple(pool.shape[1:]))
    return DNDarray.from_dense(data, sanitize_axis(data.shape, split), device, comm)


def bytes(length: int) -> builtins.bytes:
    """``length`` random bytes: ``randint(0, 256)`` as int32, one byte each."""
    bits = _randint(_next_key(), (int(length),), 0, 256, types.int32, sanitize_device(None).torch_device)
    return builtins.bytes(bits.cpu().numpy().astype(np.uint8).tobytes())
