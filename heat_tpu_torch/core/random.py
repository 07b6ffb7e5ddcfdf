"""Seeded random numbers, bitwise equal to the JAX package's
(counterpart of heat_tpu/core/random.py).

The JAX package draws every array from the key ``fold_in(PRNGKey(seed),
counter)`` and bumps the counter once per draw.  This module computes the
same Threefry-2x32 hash (20 rounds, the partitionable bit layout: element i
hashes the 64-bit counter i split into its high and low words) and JAX's
mantissa construction of uniform floats, so a seeded draw gives the same
bits here as there, on any device and at any world size.  Torch has little
support for uint32, so the hash runs on int32 tensors holding the words'
bits: additions wrap modulo 2^32 as unsigned ones do, and right shifts are
masked to act as logical ones.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from . import types
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["default_seed", "get_state", "rand", "seed", "set_state"]

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


def _random_bits(key: Tuple[int, int], n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two hash words of counters 0..n-1 (JAX's partitionable layout)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return _threefry2x32(key[0], key[1], (i >> 32).to(torch.int32), (i & _M32).to(torch.int32))


def _uniform(key: Tuple[int, int], shape, dtype, device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1): random mantissa
    bits under the exponent of 1.0, minus 1."""
    n = 1
    for s in shape:
        n *= s
    b0, b1 = _random_bits(key, n, device)
    if dtype is types.float32:
        bits = (((b0 ^ b1) >> 9) & 0x7FFFFF) | 0x3F800000
        floats = bits.view(torch.float32) - 1.0
    elif dtype is types.float64:
        w0, w1 = b0.to(torch.int64) & _M32, b1.to(torch.int64) & _M32
        bits = (w0 << 20) | (w1 >> 12) | 0x3FF0000000000000  # the 64-bit word >> 12
        floats = bits.view(torch.float64) - 1.0
    else:
        raise ValueError(f"rand draws float32 or float64, got {dtype.__name__}")
    return torch.clamp(floats, min=0.0).reshape(shape)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples on [0, 1) of the given shape."""
    shape = sanitize_shape(d if d else (1,))
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    data = _uniform(_next_key(), shape, dtype, device.torch_device)
    return DNDarray.from_dense(data, sanitize_axis(shape, split), device, comm)
