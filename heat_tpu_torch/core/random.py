"""Seeded random numbers, bitwise equal to the JAX package's
(counterpart of heat_tpu/core/random.py).

The JAX package draws every array from the key ``fold_in(PRNGKey(seed),
counter)`` and bumps the counter once per draw.  This module computes the
same Threefry-2x32 hash (20 rounds, the partitionable bit layout: element i
hashes the 64-bit counter i split into its high and low words) and JAX's
mantissa construction of uniform floats, so a seeded draw gives the same
bits here as there, on any device and at any world size.  Normal draws are
``jax.random.normal``'s: ``sqrt(2) erfinv(u)`` of a uniform ``u`` on
``[nextafter(-1, 0), 1)``, with ``erfinv`` evaluated by the polynomials
XLA's host compiler uses (:func:`_erfinv`, :func:`_log1p`, :func:`_log`):
float32 draws are within 2 ulp of the JAX package's, nearly all bitwise
equal, float64 within 3.

On a CUDA device the hash of a draw is one launch of the hand-written kernel
``csrc/threefry.cu`` (which also writes float32 uniforms directly); it
launches or raises, and ``THREEFRY_LAUNCHES`` counts its launches.  On the
CPU, and only there, the plain version runs: torch has little support for
uint32, so the hash runs on int32 tensors holding the words' bits (additions
wrap modulo 2^32 as unsigned ones do, and right shifts are masked to act as
logical ones).  The two are bitwise equal.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, types
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

#: launches of the CUDA threefry kernel in this process (the plain version adds nothing)
THREEFRY_LAUNCHES = 0

__all__ = ["default_seed", "get_state", "normal", "rand", "randn", "seed", "set_state", "standard_normal"]

_M32 = 0xFFFFFFFF
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
        lo_t = torch.tensor(lo, dtype=floats.dtype, device=device)
        floats = floats * (torch.tensor(hi, dtype=floats.dtype, device=device) - lo_t) + lo_t
    return torch.clamp(floats, min=lo).reshape(shape)


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


def _fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` in float32 as one fused multiply-add, as XLA's compiler
    emits it: taken in float64, where the product is exact, and rounded once
    to float32 (a double rounding that rarely differs from the fused one)."""
    return (a.double() * b.double() + (c.double() if torch.is_tensor(c) else c)).float()


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
