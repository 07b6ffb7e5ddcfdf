"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py).

Element-wise operations run on each rank's padded chunk, reductions are a
local partial plus one all-reduce, scans along the split axis a local scan
plus an exclusive scan of the ranks' last slices (:mod:`._operations`).
Differences along the split axis take the neighbouring rows from the next
rank (a halo).  Integer division by zero gives the reference's (XLA's)
values on every device: the zeros are masked before torch divides.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
from .dndarray import DNDarray, _move_rows, _owned, _runs_to_canonical
from .stride_tricks import sanitize_axis

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "cumprod",
    "cumproduct",
    "cumsum",
    "diff",
    "div",
    "divide",
    "divmod",
    "floordiv",
    "floor_divide",
    "fmod",
    "gcd",
    "hypot",
    "invert",
    "lcm",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nan_to_num",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
    "ediff1d",
    "float_power",
    "gradient",
    "heaviside",
    "interp",
    "nancumprod",
    "nancumsum",
    "trapezoid",
    "trapz",
    "true_divide",
]

_SCAN_BLOCK = 4096


def _to_inexact(t: torch.Tensor) -> torch.Tensor:
    """Integer and bool data in the reference's inexact type: int64 in
    float64, the narrower ones in float32."""
    if t.is_floating_point() or t.is_complex():
        return t
    return t.to(torch.float64 if t.dtype == torch.int64 else torch.float32)


def _inexact(op):
    """``op`` on operands taken to the inexact type, as JAX promotes the
    arguments of its inexact functions."""
    return lambda a, b: op(_to_inexact(a), _to_inexact(b))


# ----------------------------------------------------------------------
# uint16, uint32 and uint64 on their holding tensors (types._WIDENED)
# ----------------------------------------------------------------------
def _ring(op):
    """``+``, ``-``, ``*`` or integer ``**`` on holding tensors: the
    holding dtype wraps, and the result is reduced to the type's width."""
    return lambda a, b, t: types._wrap(op(a, b), t)


def _unsigned_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a >= b`` of int64 tensors read as uint64."""
    return (a ^ types._SIGN64) >= (b ^ types._SIGN64)


def _udivmod(a: torch.Tensor, b: torch.Tensor, t):
    """``(a // b, a % b)`` of holding tensors of unsigned type ``t``, with
    XLA's unsigned answers by zero: the quotient all ones, the remainder 0.
    uint16 and uint32 are held as they are; uint64's bits divide by a long
    division step: a divisor at or past 2^63 goes once or not at all, a
    smaller one divides ``a >> 1`` (no longer negative) signed, the
    quotient doubled and corrected once."""
    a, b = torch.broadcast_tensors(*_paired(a, b))
    zero = b == 0
    if t is types.uint64:
        big = b < 0
        d = torch.where(zero | big, torch.ones_like(b), b)
        q = torch.bitwise_left_shift(torch.div((a >> 1) & 0x7FFFFFFFFFFFFFFF, d, rounding_mode="floor"), 1)
        q = q + _unsigned_ge(a - q * d, d).to(q.dtype)
        q = torch.where(big, _unsigned_ge(a, b).to(q.dtype), q)
    else:
        q = torch.div(a, torch.where(zero, torch.ones_like(b), b), rounding_mode="floor")
    r = torch.where(zero, torch.zeros_like(a), a - q * b)
    return types._wrap(torch.where(zero, torch.full_like(q, -1), q), t), r


def _ugcd(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """gcd of holding tensors of unsigned type ``t``: torch's on uint16 and
    uint32 (held non-negative), Euclid's steps with unsigned remainders on
    uint64 (at most 93 steps in 64 bits), as jnp's loop takes them."""
    a, b = torch.broadcast_tensors(*_paired(a, b))
    if t is not types.uint64:
        return torch.gcd(a, b)
    while bool((b != 0).any()):
        r = _udivmod(a, torch.where(b == 0, torch.ones_like(b), b), t)[1]
        a, b = torch.where(b == 0, a, b), torch.where(b == 0, b, r)
    return a


def _ulcm(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """jnp's lcm on holding tensors: ``a * (b // gcd)`` wrapped, 0 where
    the gcd is 0."""
    a, b = torch.broadcast_tensors(*_paired(a, b))
    g = _ugcd(a, b, t)
    out = types._wrap(a * _udivmod(b, g, t)[0], t)
    return torch.where(g == 0, torch.zeros_like(out), out)


def _upower(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    return types._wrap(_int_power(*torch.broadcast_tensors(*_paired(a, b))), t)


def add(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise ``t1 + t2``."""
    return _operations.__binary_op(torch.add, t1, t2, out, where, _ring(torch.add))


def _subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` in the reference's type: torch subtracts no bools, so a bool
    operand is cast to the result type first; two bools raise, as there."""
    rt = torch.result_type(a, b)
    if rt == torch.bool:
        raise TypeError("sub does not accept two bool operands")
    return torch.sub(a.to(rt) if a.dtype == torch.bool else a, b.to(rt) if b.dtype == torch.bool else b)


def sub(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise ``t1 - t2``."""
    return _operations.__binary_op(_subtract, t1, t2, out, where, _ring(_subtract))


subtract = sub


def mul(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise ``t1 * t2``."""
    return _operations.__binary_op(torch.mul, t1, t2, out, where, _ring(torch.mul))


multiply = mul


def _true_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` in the reference's type: int64 operands divide in float64
    (torch would give its default float32), int32 and bool in float32."""
    if torch.result_type(a, b) == torch.int64:
        return torch.true_divide(a.to(torch.float64), b.to(torch.float64))
    return torch.true_divide(a, b)


def div(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise true division ``t1 / t2``."""
    return _operations.__binary_op(_true_divide, t1, t2, out, where)


divide = div
true_divide = div


def _power(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ** b``; two bools meet in int32, the reference's type (torch has
    no bool power).  Integers take :func:`_int_power`."""
    rt = torch.result_type(a, b)
    if rt == torch.bool:
        rt = torch.int32
    if rt.is_floating_point or rt.is_complex:
        return torch.pow(a, b)
    a, b = _paired(a.to(rt), b.to(rt))
    return _int_power(a, b)


def _int_power(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer ``a ** b`` as JAX computes it: binary exponentiation over the
    exponent's six lowest bits, wrapping in the operands' width (so a
    negative exponent gives ``a ** (b mod 64)``: ``3 ** -1`` is ``3 ** 63``
    wrapped), and 0 where ``a`` is 0 and ``b`` is not."""
    acc = torch.where((a == 0) & (b != 0), torch.zeros_like(a), torch.ones_like(a))
    acc, a = torch.broadcast_tensors(acc, a)
    for _ in range(6):
        acc = torch.where((b & 1) != 0, acc * a, acc)
        a = a * a
        b = b >> 1  # only the low six bits are read: the shift's sign fill never reaches them
    return acc


def pow(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise ``t1 ** t2``."""
    return _operations.__binary_op(_power, t1, t2, out, where, _upower)


power = pow


def float_power(t1, t2, out=None, where=True) -> DNDarray:
    """``t1 ** t2`` in the inexact type of the operands (the reference's:
    integers in float32, int64 in float64)."""
    return _operations.__binary_op(_inexact(torch.pow), t1, t2, out, where)


# ----------------------------------------------------------------------
# division and remainders, with XLA's answers for integer division by zero
# ----------------------------------------------------------------------
def _paired(a: torch.Tensor, b: torch.Tensor):
    """Both operands on the data's device: a python scalar arrives as a 0-d
    host tensor and joins the other operand there (never the reverse)."""
    if a.device == b.device:
        return a, b
    if a.ndim == 0 and a.device.type == "cpu":
        return a.to(b.device), b
    return a, b.to(a.device)


def _int_operands(a: torch.Tensor, b: torch.Tensor):
    """Both operands on one device in their common integer type (bools in
    int32, as the reference promotes them), and whether it is signed."""
    rt = torch.result_type(a, b)
    if rt == torch.bool:
        rt = torch.int32
    a, b = _paired(a, b)
    return a.to(rt), b.to(rt), rt != torch.uint8


def _floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``floor_divide``.  Floats: its divmod (the quotient
    of ``a - fmod(a, b)``, adjusted, rounded half away from zero), so that
    ``x // 0`` is NaN; torch's own quotient rounds a tie of that division
    down and gives ``x // 0`` as an infinity.  Integers: by zero -1 for 0
    and -2 otherwise (the maximum for unsigned), by -1 the wrapped
    negation."""
    rt = torch.result_type(a, b)
    if rt.is_floating_point or rt.is_complex:
        # in place where it can be: a few full-size temporaries at a time
        a, b = _paired(a.to(rt), b.to(rt))
        mod = torch.fmod(a, b)
        div = torch.sub(a, mod).div_(b)
        fix = (mod != 0) & (torch.sign(b) != torch.sign(mod))
        del mod
        div.sub_(fix.to(div.dtype))
        del fix
        whole = torch.trunc(div)  # then half away from zero, XLA's rounding
        away = torch.sub(div, whole).abs_() >= 0.5
        return torch.where(away, torch.sign(div).add_(whole), whole)
    a, b, signed = _int_operands(a, b)
    zero = b == 0
    bad = zero | (b == -1) if signed else zero
    q = torch.div(a, torch.where(bad, torch.ones_like(b), b), rounding_mode="floor")
    if not signed:
        return torch.where(zero, torch.full_like(q, 255), q)
    q = torch.where(b == -1, -a, q)
    return torch.where(zero, torch.where(a == 0, torch.full_like(q, -1), torch.full_like(q, -2)), q)


def _remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``mod`` (the divisor's sign); an integer ``x % 0``
    is 0."""
    rt = torch.result_type(a, b)
    if rt.is_floating_point or rt.is_complex:
        return torch.remainder(*_paired(a, b))
    a, b, signed = _int_operands(a, b)
    bad = (b == 0) | (b == -1) if signed else b == 0
    return torch.where(bad, torch.zeros_like(a), torch.remainder(a, torch.where(bad, torch.ones_like(b), b)))


def _fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``fmod`` (the dividend's sign); an integer ``x % 0``
    is 0, but a bool one is x (JAX guards only integer divisors)."""
    rt = torch.result_type(a, b)
    if rt.is_floating_point or rt.is_complex:
        return torch.fmod(*_paired(a, b))
    was_bool = rt == torch.bool
    a, b, signed = _int_operands(a, b)
    bad = (b == 0) | (b == -1) if signed else b == 0
    r = torch.where(bad, torch.zeros_like(a), torch.fmod(a, torch.where(bad, torch.ones_like(b), b)))
    return torch.where(b == 0, a, r) if was_bool else r


def floordiv(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise floor division ``t1 // t2``."""
    _operations._refuse_complex("floordiv", TypeError, t1, t2)
    return _operations.__binary_op(_floor_divide, t1, t2, out, where, lambda a, b, t: _udivmod(a, b, t)[0])


floor_divide = floordiv


def mod(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise remainder with the divisor's sign, ``t1 % t2``."""
    _operations._refuse_complex("mod", TypeError, t1, t2)
    return _operations.__binary_op(_remainder, t1, t2, out, where, lambda a, b, t: _udivmod(a, b, t)[1])


remainder = mod


def fmod(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise remainder with the dividend's sign (C's ``fmod``)."""
    _operations._refuse_complex("fmod", TypeError, t1, t2)
    return _operations.__binary_op(_fmod, t1, t2, out, where, lambda a, b, t: _udivmod(a, b, t)[1])


def divmod(t1, t2, out1=None, out2=None, out=None, where=True):
    """``(floordiv(t1, t2), mod(t1, t2))``; ``out`` is a pair of outputs."""
    if out is None:
        out = (out1, out2)
    if not isinstance(out, tuple) or len(out) != 2:
        raise ValueError("out must be a 2-tuple")
    return floordiv(t1, t2, out[0], where), mod(t1, t2, out[1], where)


def copysign(t1, t2, out=None, where=True) -> DNDarray:
    """The magnitude of ``t1`` with the sign of ``t2``."""
    _operations._refuse_complex("copysign", TypeError, t1, t2)
    return _operations.__binary_op(_inexact(torch.copysign), t1, t2, out, where)


def hypot(t1, t2, out=None, where=True) -> DNDarray:
    """``sqrt(t1**2 + t2**2)``, for floating point operands only."""
    for t in (t1, t2):
        if isinstance(t, DNDarray) and types.heat_type_is_exact(t.dtype) or isinstance(t, int):
            raise TypeError("hypot is only supported for floating point types")
    _operations._refuse_complex("hypot", ValueError, t1, t2)
    return _operations.__binary_op(torch.hypot, t1, t2, out, where)


def _integer_only(t1, t2, name: str) -> None:
    """gcd and lcm take integers; operands that meet in bool raise
    ValueError, as JAX's do, and so do integers that meet in a float
    (uint64 and a python int)."""
    met = types.promote_types(types.heat_type_of(t1), types.heat_type_of(t2))
    exact = all(isinstance(t, int) or isinstance(t, DNDarray) and types.heat_type_is_exact(t.dtype) for t in (t1, t2))
    if met is types.bool or exact and not types.heat_type_is_exact(met):
        raise ValueError(f"Arguments to {name} must be integers.")
    _check_int_or_bool(t1, t2, name)


def gcd(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise greatest common divisor (non-negative)."""
    _integer_only(t1, t2, "gcd")
    return _operations.__binary_op(torch.gcd, t1, t2, out, where, _ugcd)


def lcm(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise least common multiple (non-negative; 0 where either is)."""
    _integer_only(t1, t2, "lcm")
    return _operations.__binary_op(torch.lcm, t1, t2, out, where, _ulcm)


def _heaviside(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0 below zero, 1 above, ``b`` at zero (and at NaN), in the inexact type."""
    a, b = _to_inexact(a), _to_inexact(b)
    rt = torch.result_type(a, b)
    a, b = _paired(a.to(rt), b.to(rt))
    a, b = torch.broadcast_tensors(a, b)
    return torch.where(a < 0, torch.zeros_like(a), torch.where(a > 0, torch.ones_like(a), b))


def heaviside(t1, t2, out=None, where=True) -> DNDarray:
    """The Heaviside step function of ``t1``, ``t2`` where ``t1`` is 0."""
    _operations._refuse_complex("heaviside", TypeError, t1, t2)
    return _operations.__binary_op(_heaviside, t1, t2, out, where)


def neg(a, out=None) -> DNDarray:
    """Element-wise ``-a``; bool input raises, as in the reference."""
    if isinstance(a, DNDarray) and a.dtype is types.bool:
        raise TypeError("neg does not accept dtype bool")
    return _operations.__local_op(torch.neg, a, out, no_cast=True)


negative = neg


def pos(a, out=None) -> DNDarray:
    """Element-wise ``+a``: a copy."""
    return _operations.__local_op(torch.clone, a, out, no_cast=True)


positive = pos


def nan_to_num(t, nan: float = 0.0, posinf=None, neginf=None, out=None) -> DNDarray:
    """NaN as ``nan``, infinities as ``posinf``/``neginf`` (by default the
    type's largest and smallest finite values)."""
    def op(a):
        if a.is_complex():
            return torch.complex(torch.nan_to_num(a.real, nan, posinf, neginf),
                                 torch.nan_to_num(a.imag, nan, posinf, neginf))
        return torch.nan_to_num(a, nan, posinf, neginf) if a.is_floating_point() else a.clone()

    return _operations.__local_op(op, t, out, no_cast=True)


# ----------------------------------------------------------------------
# reductions and scans
# ----------------------------------------------------------------------
def _accumulated(dtype):
    """The type of a sum or product: bools and signed integers in int64,
    unsigned integers in uint64 (JAX promotes integers to the 64-bit
    default)."""
    if issubclass(dtype, types.unsignedinteger):
        return types.uint64
    if types.heat_type_is_exact(dtype):
        return types.int64
    return dtype


def _prod(t: torch.Tensor, dims, keep: bool) -> torch.Tensor:
    """torch.prod over several dims (one at a time, the last first)."""
    if t.dtype == torch.bool:
        t = t.to(torch.int64)
    for d in sorted(dims, reverse=True):
        t = torch.prod(t, d, keepdim=keep)
    return t


def _nan_as(d: torch.Tensor, value: float) -> torch.Tensor:
    """``d`` with its NaN entries set to ``value``."""
    return torch.where(torch.isnan(d), torch.full((), value, dtype=d.dtype, device=d.device), d)


def _reduce(x, partial, reduction, neutral, axis, out, keepdims, nan=None) -> DNDarray:
    """A reduction whose result type is :func:`_accumulated`'s: NaN taken
    as ``nan`` first where it is given."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    if nan is not None and types.heat_type_is_inexact(x.dtype):
        x = x._like(_nan_as(x.larray_padded, nan), dtype=x.dtype)
    if x.dtype in (types.uint16, types.uint32):  # summed in uint64, whose bits int64 sums
        x = x.astype(types.uint64)
    res = _operations.__reduce_op(x, partial, reduction, neutral, axis, keepdims)
    res = res._like(res.larray_padded, dtype=_accumulated(x.dtype))
    return res if out is None else _operations.store_out(res, out)


def _sum(t, dims, keep):
    return torch.sum(t, dim=dims, keepdim=keep)


def sum(a, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Sum over ``axis`` (all axes when None); padding counts as 0."""
    return _reduce(a, _sum, a.comm.psum if isinstance(a, DNDarray) else None, 0, axis, out, keepdims)


def nansum(a, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Sum over ``axis``, NaN taken as 0."""
    return _reduce(a, _sum, a.comm.psum if isinstance(a, DNDarray) else None, 0, axis, out, keepdims, nan=0.0)


def prod(a, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Product over ``axis`` (all axes when None); padding counts as 1."""
    return _reduce(a, _prod, a.comm.pprod if isinstance(a, DNDarray) else None, 1, axis, out, keepdims)


def nanprod(a, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Product over ``axis``, NaN taken as 1."""
    return _reduce(a, _prod, a.comm.pprod if isinstance(a, DNDarray) else None, 1, axis, out, keepdims, nan=1.0)


def _blocked_scan(t: torch.Tensor, axis: int, torch_scan, combine, neutral) -> torch.Tensor:
    """The inclusive scan of ``t`` along ``axis`` in a fixed order and in
    parallel: blocks of 4096 along the axis, each scanned by torch (a row
    of its scan kernel), the blocks' totals scanned the same way, and each
    block combined with the totals before it.  At least two blocks, so that
    torch never takes its decoupled look-back scan of a whole vector."""
    n = t.shape[axis]
    nb = max(2, -(-n // _SCAN_BLOCK))
    pad = [0, 0] * (t.ndim - 1 - axis) + [0, nb * _SCAN_BLOCK - n]
    padded = torch.nn.functional.pad(t, pad, value=neutral)
    shape = list(t.shape)
    shape[axis:axis + 1] = [nb, _SCAN_BLOCK]
    inner = torch_scan(padded.reshape(shape), axis + 1)
    if n <= _SCAN_BLOCK:  # one block of data: its scan is the answer
        return inner.select(axis, 0).narrow(axis, 0, n)
    totals = inner.select(axis + 1, _SCAN_BLOCK - 1)
    if nb > _SCAN_BLOCK or totals.numel() == nb:  # never torch's scan of a whole vector
        before = _blocked_scan(totals, axis, torch_scan, combine, neutral)
    else:
        before = torch_scan(totals, axis)
    first = torch.full_like(before.narrow(axis, 0, 1), neutral)
    before = torch.cat([first, before.narrow(axis, 0, nb - 1)], dim=axis)
    out = combine(before.unsqueeze(axis + 1), inner)
    return out.reshape(padded.shape).narrow(axis, 0, n)


def _scan(kind: str):
    """The local scan of one kind ("sum" or "prod") along an axis.  On the
    card a long axis, or a whole vector, is scanned by
    :func:`_blocked_scan`: torch scans a vector by a decoupled look-back
    whose rounding changes from run to run, and an outer axis with a thread
    a column (46.7 s for 2^27 rows of 16 floats on an NVIDIA H100 80GB HBM3
    at 700 W).  A short last axis of many rows is moved to the front first:
    torch's scan of short contiguous rows took 740 ms at 2^27 x 16 on that
    card, its outer-axis scan plus the two transposes 70 ms.  Bools are
    counted as int64."""
    torch_scan, combine, neutral = (torch.cumsum, torch.add, 0) if kind == "sum" else (torch.cumprod, torch.mul, 1)

    def scan(t: torch.Tensor, axis: int) -> torch.Tensor:
        if t.dtype == torch.bool:
            t = t.to(torch.int64)
        if not t.is_cuda or t.shape[axis] <= 1:
            return torch_scan(t, axis)
        if t.shape[axis] > _SCAN_BLOCK or t.numel() == t.shape[axis]:
            if not (t.is_floating_point() or t.is_complex()):
                t = t.to(torch.int64)
            return _blocked_scan(t, axis, torch_scan, combine, neutral)
        if axis == t.ndim - 1 and t.numel() > _SCAN_BLOCK * t.shape[axis]:
            return torch_scan(t.movedim(axis, 0).contiguous(), 0).movedim(0, axis).contiguous()
        return torch_scan(t, axis)

    scan.__name__ = f"cum{kind}"
    return scan


_CUMSUM, _CUMPROD = _scan("sum"), _scan("prod")


def _cum(t, axis, kind: str, dtype, out, nan=None) -> DNDarray:
    if not isinstance(t, DNDarray):
        raise TypeError(f"expected t to be a DNDarray, but was {type(t)}")
    if nan is not None and types.heat_type_is_inexact(t.dtype):
        t = t._like(_nan_as(t.larray_padded, nan), dtype=t.dtype)._propagate_layout_from(t)
    scan, combine, neutral = (_CUMSUM, torch.add, 0) if kind == "sum" else (_CUMPROD, torch.mul, 1)
    natural = types.int64 if t.dtype is types.bool else t.dtype  # bools are counted
    return _operations.__cum_op(t, axis, scan, combine, neutral, out, dtype, natural)


def cumsum(t, axis, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis``; along the split axis each rank adds
    the sum of the rows before its own (one exclusive scan over ranks)."""
    return _cum(t, axis, "sum", dtype, out)


def cumprod(t, axis, dtype=None, out=None) -> DNDarray:
    """Cumulative product along ``axis``."""
    return _cum(t, axis, "prod", dtype, out)


cumproduct = cumprod


def nancumsum(t, axis, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis``, NaN taken as 0."""
    return _cum(t, axis, "sum", dtype, out, nan=0.0)


def nancumprod(t, axis, dtype=None, out=None) -> DNDarray:
    """Cumulative product along ``axis``, NaN taken as 1."""
    return _cum(t, axis, "prod", dtype, out, nan=1.0)


# ----------------------------------------------------------------------
# differences: the neighbouring rows along the split axis from a halo
# ----------------------------------------------------------------------
def _halos(x: DNDarray, n: int):
    """``(prev, next)``: the ``n`` rows before and after this rank's chunk
    along the split axis (fewer at the ends, None where there are none).
    One ``get_halo`` (two ppermutes) where every chunk holds ``n`` rows,
    else one exchange of the rows each rank needs."""
    s, comm, extent = x.split, x.comm, x.shape[x.split]
    if 0 < n <= int(comm.lshape_map(x.shape, s)[:, s].min()):
        h = x._like(x.larray_padded, dtype=x.dtype)
        h.get_halo(n)
        return h.halo_prev, h.halo_next
    owned = [_owned(comm, x.shape, s, r) for r in range(comm.size)]
    runs = [(lo, hi - lo) for lo, hi in owned]
    local = x.larray
    prev = _move_rows(comm, local, s, runs, [(max(lo - n, 0), lo) for lo, _ in owned])
    nxt = _move_rows(comm, local, s, runs, [(min(hi, extent), min(hi + n, extent)) for _, hi in owned])
    return (prev if prev.shape[s] else None), (nxt if nxt.shape[s] else None)


def _edge(p, a: DNDarray, axis: int) -> torch.Tensor:
    """A ``prepend`` or ``append`` value of ``diff`` as a tensor of ``a``'s
    shape along every axis but ``axis``, cut to this rank's rows where
    ``a`` is split along another axis."""
    from . import factories

    if not isinstance(p, DNDarray):
        p = factories.array(p, device=a.device, comm=a.comm)
    t = p._dense()
    if t.ndim == 0:
        shape = list(a.shape)
        shape[axis] = 1
        t = t.expand(shape)
    t = types._cast(t, p.dtype, types.promote_types(p.dtype, a.dtype))
    if a.split is not None and a.split != axis:
        return _operations._aligned(DNDarray.from_dense(t.contiguous(), None, a.device, a.comm), tuple(t.shape),
                                    a.split)
    return t


def diff(a, n: int = 1, axis: int = -1, prepend=None, append=None) -> DNDarray:
    """The n-th discrete difference along ``axis``.  Along the split axis
    each rank differences its own rows and the first ``n`` rows of the next
    rank's (a halo), and one exchange cuts the result to its canonical
    chunks."""
    if n < 0:
        raise ValueError(f"diff requires that n be a positive number, got {n}")
    if not isinstance(a, DNDarray):
        raise TypeError(f"'a' must be a DNDarray, got {type(a)}")
    if n == 0:
        return a
    axis = sanitize_axis(a.shape, axis)
    pieces = [None if p is None else _edge(p, a, axis) for p in (prepend, append)]
    if a.split != axis:
        local = a.larray_padded
        parts = [p for p in (pieces[0], local, pieces[1]) if p is not None]
        if len(parts) > 1:
            dt = parts[0].dtype if pieces[0] is not None else parts[-1].dtype
            rt = torch.promote_types(local.dtype, dt)
            local = torch.cat([q.to(rt).to(local.device) for q in parts], dim=axis)
        res = torch.diff(local, n, dim=axis)  # bools by inequality, as JAX's
        return a._like(res, tuple(res.shape[d] if d == axis else s for d, s in enumerate(a.shape)), a.split)
    if prepend is not None or append is not None:
        # values before and after the split axis: the one case of diff that
        # works on the gathered array
        from . import factories

        whole = torch.cat([q.to(a.larray.device) for q in (pieces[0], a._dense(), pieces[1]) if q is not None],
                          dim=axis)
        return diff(factories.array(whole, split=axis, device=a.device, comm=a.comm), n, axis)
    comm, extent = a.comm, a.shape[axis]
    out_extent = max(extent - n, 0)
    _, nxt = _halos(a, n)
    local = a.larray if nxt is None else torch.cat([a.larray, nxt], dim=axis)
    owned = [_owned(comm, a.shape, axis, r) for r in range(comm.size)]
    runs = [(lo, max(0, min(hi, out_extent) - lo)) for lo, hi in owned]
    count = runs[comm.rank][1]
    res = torch.diff(local, n, dim=axis).narrow(axis, 0, count) if count else local.narrow(axis, 0, 0)
    gshape = tuple(out_extent if d == axis else s for d, s in enumerate(a.shape))
    return a._like(_runs_to_canonical(comm, res, axis, runs, out_extent), gshape, axis)


def ediff1d(ary, to_end=None, to_begin=None) -> DNDarray:
    """Differences of the flattened array, with ``to_begin`` before and
    ``to_end`` after (cast to its type); 1-D, split along 0 where the input
    is split.  Each rank differences its own elements and the next one (a
    halo), and one exchange cuts the result to its canonical chunks."""
    if not isinstance(ary, DNDarray):
        raise TypeError(f"expected ary to be a DNDarray, but was {type(ary)}")

    def cap(v):
        if v is None:
            return None
        t = v._dense() if isinstance(v, DNDarray) else torch.as_tensor(np.asarray(v))
        return t.reshape(-1).to(ary.larray_padded.dtype).to(ary.larray_padded.device)

    tb, te = cap(to_begin), cap(to_end)
    x = ary if ary.split in (None, 0) else ary.resplit(0)
    comm, size = x.comm, x.size
    rest = size // x.shape[0] if x.ndim and x.shape[0] else 1
    flat = x.larray.reshape(-1)
    if x.split is None or comm.size == 1:
        d = _subtract(flat[1:], flat[:-1])
        res = torch.cat([p for p in (tb, d, te) if p is not None])
        return DNDarray.from_dense(res, 0 if ary.split is not None else None, ary.device, comm, None)
    owned = [_owned(comm, x.shape, 0, r) for r in range(comm.size)]
    spans = [(lo * rest, hi * rest) for lo, hi in owned]
    runs = [(lo, hi - lo) for lo, hi in spans]
    nxt = _move_rows(comm, flat, 0, runs, [(hi, min(hi + 1, size)) for _, hi in spans])
    ext = torch.cat([flat, nxt])
    d = _subtract(ext[1:], ext[:-1])
    nb = 0 if tb is None else tb.numel()
    out_extent = nb + max(size - 1, 0) + (0 if te is None else te.numel())
    last = max((r for r, (lo, hi) in enumerate(spans) if hi > lo), default=0)
    out_runs = []
    for r, (lo, hi) in enumerate(spans):
        first, cnt = nb + lo, max(0, min(hi, size - 1) - lo)
        if r == 0:
            first, cnt = 0, cnt + nb
        if r == last and te is not None:
            cnt += te.numel()
        out_runs.append((first, cnt))
    me = comm.rank
    mine = d[: max(0, min(spans[me][1], size - 1) - spans[me][0])]
    if me == 0 and tb is not None:
        mine = torch.cat([tb, mine])
    if me == last and te is not None:
        mine = torch.cat([mine, te])
    local = _runs_to_canonical(comm, mine, 0, out_runs, out_extent)
    return DNDarray(local, (out_extent,), types.canonical_heat_type(local.dtype), 0, ary.device, comm)


def _broadcast_along(v, axis: int, ndim: int, like: DNDarray) -> DNDarray:
    """``v`` (a coordinate vector along ``axis``, or sample points of
    ``like``'s rank) as a DNDarray of ``ndim`` axes; a vector gets extent 1
    on every other axis and keeps its split on ``axis``."""
    if not isinstance(v, DNDarray):
        v = DNDarray.from_dense(torch.as_tensor(np.asarray(v)), None, like.device, like.comm)
    if v.ndim != 1 or ndim == 1:
        return v
    shape = tuple(v.shape[0] if d == axis else 1 for d in range(ndim))
    view = [-1 if d == axis else 1 for d in range(ndim)]
    return v._like(v.larray_padded.reshape(view), shape, None if v.split is None else axis, v.dtype)


def _split_along(v: DNDarray, axis: int, like: DNDarray) -> DNDarray:
    """``v`` split along ``axis``, as ``like`` is: as it is where it is, its
    own rows where it is whole on every rank (no communication), resplit
    (one all-to-all) where it is split along another axis."""
    if v.split == axis:
        return v
    if v.split is None:
        return DNDarray.from_dense(v.larray, axis, like.device, like.comm, v.dtype)
    return v.resplit(axis)


def _neighbours(v: DNDarray, axis: int, dt: torch.dtype):
    """``(before, local, after)`` of ``v`` split along ``axis``: its true
    rows in ``dt`` and each one's neighbours along the axis (a halo from
    the ranks around; a row of its own at the array's ends)."""
    local = v.larray.to(dt)
    n = local.shape[axis]
    prev, nxt = _halos(v, 1)
    prev = local.narrow(axis, 0, 1) if prev is None else prev.to(dt)
    nxt = local.narrow(axis, n - 1, 1) if nxt is None else nxt.to(dt)
    after = torch.cat([local.narrow(axis, 1, n - 1), nxt], dim=axis)
    before = torch.cat([prev, local.narrow(axis, 0, n - 1)], dim=axis)
    return before, local, after


def _gradient_along(f: DNDarray, axis: int, h, dt: torch.dtype) -> torch.Tensor:
    """The central differences of ``f`` along ``axis`` (one-sided at the
    edges) as JAX's ``gradient`` computes them: over a scalar spacing
    ``h``, or over the coordinates ``h`` of the samples along the axis (a
    vector, the second-order formula of uneven steps); in ``dt``, this
    rank's padded chunk of the result.  Along the split axis the
    neighbouring rows of the values and of the coordinates come from one
    halo each."""
    a = f.larray_padded.to(dt)
    extent = f.shape[axis]
    if extent < 2:
        raise ValueError("Shape of array too small to calculate a numerical gradient, at least (edge_order + 1) "
                         "elements are required.")
    coords = not isinstance(h, (int, float, np.number))
    if coords:
        if int(np.prod(np.shape(h))) != extent or len(np.shape(h)) != 1:
            raise ValueError("Spacing arrays must have the same length as the dimension along which the gradient "
                             "is calculated.")
        hx = _broadcast_along(h, axis, f.ndim, f)
    if f.split != axis:
        if coords:
            x = _operations._aligned(hx, f.shape, f.split).to(dt).to(a.device)
            return _uneven(a.narrow(axis, 0, extent - 2), a.narrow(axis, 1, extent - 2), a.narrow(axis, 2, extent - 2),
                           x.narrow(axis, 0, extent - 2), x.narrow(axis, 1, extent - 2), x.narrow(axis, 2, extent - 2),
                           a, x, axis, extent)
        upper = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
        inner = (a.narrow(axis, 2, extent - 2) - a.narrow(axis, 0, extent - 2)) * 0.5
        lower = a.narrow(axis, extent - 1, 1) - a.narrow(axis, extent - 2, 1)
        return torch.cat([upper, inner, lower], dim=axis) / h
    n = f.larray.shape[axis]
    if n == 0:
        return a
    before, local, after = _neighbours(f, axis, dt)
    lo = f.comm.chunk(f.shape, axis)[0]
    pos = torch.arange(lo, lo + n, device=local.device).reshape([n if d == axis else 1 for d in range(f.ndim)])
    if coords:
        xb, xl, xa = _neighbours(_split_along(hx, axis, f), axis, dt)
        g = _central(before, local, after, xb, xl, xa)
        g = torch.where(pos == 0, (after - local) / (xa - xl), torch.where(pos == extent - 1, (local - before) / (xl - xb), g))
    else:
        g = (after - before) * 0.5
        g = torch.where(pos == 0, after - local, torch.where(pos == extent - 1, local - before, g)) / h
    return torch.cat([g, a.narrow(axis, n, a.shape[axis] - n)], dim=axis)


def _central(y0, y1, y2, x0, x1, x2) -> torch.Tensor:
    """JAX's second-order difference at uneven steps ``x1 - x0`` and
    ``x2 - x1``, in its order of operations."""
    dx1, dx2 = x1 - x0, x2 - x1
    wa = -dx2 / (dx1 * (dx1 + dx2))
    wb = (dx2 - dx1) / (dx1 * dx2)
    wc = dx1 / (dx2 * (dx1 + dx2))
    return wa * y0 + wb * y1 + wc * y2


def _uneven(y0, y1, y2, x0, x1, x2, a, x, axis: int, extent: int) -> torch.Tensor:
    """The whole axis's gradient over coordinates ``x``: the one-sided
    edges and :func:`_central` inside."""
    upper = (a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)) / (x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1))
    lower = (a.narrow(axis, extent - 1, 1) - a.narrow(axis, extent - 2, 1)) / \
        (x.narrow(axis, extent - 1, 1) - x.narrow(axis, extent - 2, 1))
    return torch.cat([upper, _central(y0, y1, y2, x0, x1, x2), lower], dim=axis)


def gradient(f, *varargs, axis=None, edge_order: int = 1):
    """The gradient by second-order central differences inside and
    first-order ones at the edges; per axis a scalar spacing or the
    samples' coordinates along it (a vector as long as the axis), as in
    ``varargs``; one DNDarray per axis (one alone for a single axis).
    Along the split axis the neighbouring rows come from a halo."""
    if not isinstance(f, DNDarray):
        raise TypeError(f"expected f to be a DNDarray, but was {type(f)}")
    if edge_order != 1:
        raise NotImplementedError("gradient: only edge_order=1 is supported")
    axes = tuple(range(f.ndim)) if axis is None else sanitize_axis(f.shape, axis)
    axes = (axes,) if isinstance(axes, int) else axes
    if len(varargs) == 0:
        spacing = [1.0] * len(axes)
    elif len(varargs) == 1:
        spacing = list(varargs) * len(axes)
    elif len(varargs) == len(axes):
        spacing = list(varargs)
    else:
        raise TypeError("Invalid number of spacing arguments")
    # the spacings take part in the type, as JAX promotes them with f
    t = types.result_type(f, *varargs) if varargs else f.dtype
    dt = _to_inexact(torch.zeros((), dtype=t.torch_type())).dtype
    outs = [f._like(_gradient_along(f, ax, h, dt))._propagate_layout_from(f) for ax, h in zip(axes, spacing)]
    return outs[0] if len(outs) == 1 else outs


def trapz(y, x=None, dx: float = 1.0, axis: int = -1) -> DNDarray:
    """The integral along ``axis`` by the trapezoidal rule, with the sample
    points ``x`` (a vector along the axis, or an array of ``y``'s rank that
    broadcasts against it) or the spacing ``dx``.  Along the split axis
    each rank sums its own intervals and the one to the next rank's first
    row (one halo of ``y`` and, for N-D sample points, one of ``x``); one
    all-reduce adds the ranks' sums."""
    if not isinstance(y, DNDarray):
        raise TypeError(f"expected y to be a DNDarray, but was {type(y)}")
    ax = sanitize_axis(y.shape, axis)
    data = _to_inexact(y.larray_padded)
    steps = xs = None
    if x is not None:
        xs = _broadcast_along(x, ax, y.ndim, y)
        if xs.ndim != y.ndim:
            raise ValueError(f"sample points of {xs.ndim} dimensions for {y.ndim}-dimensional y")
        # y and x meet in their promoted inexact type, as JAX's
        dt = _to_inexact(torch.zeros((), dtype=torch.promote_types(y.larray_padded.dtype,
                                                                     xs.larray_padded.dtype))).dtype
        data = y.larray_padded.to(dt)

    extent = y.shape[ax]
    if y.split != ax:
        if xs is not None:
            steps = torch.diff(_operations._aligned(xs, y.shape, y.split).to(data.device).to(data.dtype), dim=ax)
        pairs = data.narrow(ax, 1, max(extent - 1, 0)) + data.narrow(ax, 0, max(extent - 1, 0))
        res = 0.5 * (pairs * dx if steps is None else steps * pairs).sum(ax)
        split = None if y.split is None else y.split - (1 if ax < y.split else 0)
        gshape = tuple(s for d, s in enumerate(y.shape) if d != ax)
        return y._like(res, gshape, split)
    comm = y.comm
    lo, lshape, _ = comm.chunk(y.shape, ax)
    cnt = max(0, min(lo + lshape[ax], extent - 1) - lo)

    def extended(v: DNDarray) -> torch.Tensor:  # this rank's rows and the next rank's first
        local = v.larray.to(data.dtype)
        _, nxt = _halos(v, 1)
        return local if nxt is None else torch.cat([local, nxt.to(data.dtype)], dim=ax)

    ext = extended(y)
    pairs = ext.narrow(ax, 1, cnt) + ext.narrow(ax, 0, cnt)
    if xs is None:
        weighted = pairs * dx
    else:
        steps = torch.diff(extended(_split_along(xs, ax, y)), dim=ax).narrow(ax, 0, cnt)
        weighted = steps.to(pairs.device) * pairs
    total = comm.psum(weighted.sum(ax).contiguous())
    gshape = tuple(s for d, s in enumerate(y.shape) if d != ax)
    return y._like(0.5 * total, gshape, None)


trapezoid = trapz


def interp(x, xp, fp, left=None, right=None, period=None) -> DNDarray:
    """1-D linear interpolation of ``x`` in the samples ``(xp, fp)``, as
    JAX's ``interp`` computes it; the samples are whole on every rank, the
    query keeps its distribution."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    dev = x.larray_padded.device

    def whole(v):
        t = v._dense() if isinstance(v, DNDarray) else torch.as_tensor(np.asarray(v))
        return _to_inexact(t).to(dev)

    xpt, fpt, q = whole(xp), whole(fp), _to_inexact(x.larray_padded)
    rt = torch.promote_types(torch.promote_types(q.dtype, xpt.dtype), fpt.dtype)
    q, xpt, fpt = q.to(rt), xpt.to(rt), fpt.to(rt)
    if period is not None:
        if period == 0:
            raise ValueError("period must be a non-zero value; got 0")
        period = abs(period)
        q = torch.remainder(q, period)
        xpt = torch.remainder(xpt, period)
        order = torch.argsort(xpt, stable=True)
        xpt, fpt = xpt[order], fpt[order]
        xpt = torch.cat([xpt[-1:] - period, xpt, xpt[:1] + period])
        fpt = torch.cat([fpt[-1:], fpt, fpt[:1]])
    i = torch.clamp(torch.searchsorted(xpt, q.contiguous(), right=True), 1, xpt.numel() - 1)
    df = fpt[i] - fpt[i - 1]
    dx = xpt[i] - xpt[i - 1]
    delta = q - xpt[i - 1]
    eps = float(np.spacing(np.finfo(types.numpy_type(types.canonical_heat_type(rt))).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fpt[i - 1], fpt[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    if period is None:
        f = torch.where(q < xpt[0], fpt[0] if left is None else torch.tensor(left, dtype=rt), f)
        f = torch.where(q > xpt[-1], fpt[-1] if right is None else torch.tensor(right, dtype=rt), f)
    return x._like(f)._propagate_layout_from(x)


# ----------------------------------------------------------------------
# bitwise operations (heat_tpu/core/arithmetics.py:76-100, :187-290)
# ----------------------------------------------------------------------
# the bits of the widened types' values within their holding dtype
_WIDTH_MASK = {types.uint16: 0xFFFF, types.uint32: 0xFFFFFFFF}


def _check_int_or_bool(t1, t2, name: str) -> None:
    """Raise unless both operands, and the type they meet in, are integer
    or bool (uint64 and a python int meet in float64, as in the reference)."""
    for t in (t1, t2):
        if isinstance(t, DNDarray) and not types.heat_type_is_exact(t.dtype):
            raise TypeError(f"{name} is only supported for integer or boolean types, got {t.dtype.__name__}")
        if isinstance(t, float):
            raise TypeError(f"{name} is only supported for integer or boolean types, got float")
    met = types.promote_types(types.heat_type_of(t1), types.heat_type_of(t2))
    if not types.heat_type_is_exact(met):
        raise TypeError(f"{name} is only supported for integer or boolean types, the operands meet in "
                        f"{met.__name__}")


def _held(op):
    """A bitwise operation on holding tensors of a widened type: and, or
    and xor of values that fit give values that fit, on uint64's bits
    too."""
    return lambda a, b, t: op(a, b)


def bitwise_and(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise AND of the bits (of the truth values for bool)."""
    _check_int_or_bool(t1, t2, "bitwise_and")
    return _operations.__binary_op(torch.bitwise_and, t1, t2, out, where, _held(torch.bitwise_and))


def bitwise_or(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise OR of the bits."""
    _check_int_or_bool(t1, t2, "bitwise_or")
    return _operations.__binary_op(torch.bitwise_or, t1, t2, out, where, _held(torch.bitwise_or))


def bitwise_xor(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise XOR of the bits."""
    _check_int_or_bool(t1, t2, "bitwise_xor")
    return _operations.__binary_op(torch.bitwise_xor, t1, t2, out, where, _held(torch.bitwise_xor))


def invert(t, out=None) -> DNDarray:
    """Element-wise bit inversion (logical NOT for bool)."""
    if not isinstance(t, DNDarray):
        raise TypeError(f"expected a DNDarray, got {type(t)}")
    if not types.heat_type_is_exact(t.dtype):
        raise TypeError(f"invert is only supported for integer or boolean types, got {t.dtype.__name__}")
    res = torch.bitwise_not(t.larray_padded)
    if t.dtype in _WIDTH_MASK:
        res = res & _WIDTH_MASK[t.dtype]
    res = t._like(res, dtype=t.dtype)
    if out is not None:
        return _operations.store_out(res, out)
    return res._propagate_layout_from(t)


bitwise_not = invert


def _bool_as_int32(op):
    """``op`` with two bools met in int32, the reference's type (torch does
    not shift bools)."""
    def shifted(a, b):
        if torch.result_type(a, b) == torch.bool:
            a, b = a.to(torch.int32), b.to(torch.int32)
        return op(a, b)

    return shifted


def _shift_left(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    out = torch.bitwise_left_shift(a, b)
    return out & _WIDTH_MASK[t] if t in _WIDTH_MASK else out


def _shift_right(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Logical right shift of unsigned values: the held uint16 and uint32
    values are not negative; uint64's bits shift arithmetically in int64,
    so the sign copies are masked off."""
    out = torch.bitwise_right_shift(a, b)
    if t is not types.uint64:
        return out
    b = torch.as_tensor(b, device=out.device).to(torch.int64)
    keep = torch.where(b > 0, torch.bitwise_left_shift(torch.ones_like(b), 64 - b) - 1, torch.full_like(b, -1))
    return out & keep


def left_shift(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise ``t1 << t2``."""
    _check_int_or_bool(t1, t2, "left_shift")
    return _operations.__binary_op(_bool_as_int32(torch.bitwise_left_shift), t1, t2, out, where, _shift_left)


def right_shift(t1, t2, out=None, where=True) -> DNDarray:
    """Element-wise ``t1 >> t2`` (arithmetic for signed, logical for
    unsigned types)."""
    _check_int_or_bool(t1, t2, "right_shift")
    return _operations.__binary_op(_bool_as_int32(torch.bitwise_right_shift), t1, t2, out, where, _shift_right)


def _inplace(t1, result: DNDarray) -> DNDarray:
    """Store ``result`` into ``t1`` (same shape; cast back to t1's type where
    the reference's intuitive casting allows it)."""
    if not isinstance(t1, DNDarray):
        raise TypeError(f"in-place operations require a DNDarray target, got {type(t1)}")
    if result.shape != t1.shape:
        raise ValueError(f"non-broadcastable output operand with shape {t1.shape} doesn't match the broadcast shape "
                         f"{result.shape}")
    if result.dtype != t1.dtype and not types.can_cast(result.dtype, t1.dtype):
        raise TypeError(f"cannot cast {result.dtype.__name__} back to {t1.dtype.__name__} for in-place operation")
    if result.split != t1.split:
        result = result.resplit(t1.split)
    t1._replace(types._cast(result.larray_padded, result.dtype, t1.dtype))
    return t1


def add_(t1, t2) -> DNDarray:
    """In-place addition."""
    return _inplace(t1, add(t1, t2))


def bitwise_and_(t1, t2) -> DNDarray:
    """In-place bitwise AND."""
    return _inplace(t1, bitwise_and(t1, t2))


def bitwise_or_(t1, t2) -> DNDarray:
    """In-place bitwise OR."""
    return _inplace(t1, bitwise_or(t1, t2))


def bitwise_xor_(t1, t2) -> DNDarray:
    """In-place bitwise XOR."""
    return _inplace(t1, bitwise_xor(t1, t2))


def copysign_(t1, t2) -> DNDarray:
    """In-place copysign."""
    return _inplace(t1, copysign(t1, t2))


def cumprod_(t, axis) -> DNDarray:
    """In-place cumulative product."""
    return _inplace(t, cumprod(t, axis))


cumproduct_ = cumprod_


def cumsum_(t, axis) -> DNDarray:
    """In-place cumulative sum."""
    return _inplace(t, cumsum(t, axis))


def div_(t1, t2) -> DNDarray:
    """In-place true division."""
    return _inplace(t1, div(t1, t2))


divide_ = div_


def floordiv_(t1, t2) -> DNDarray:
    """In-place floor division."""
    return _inplace(t1, floordiv(t1, t2))


floor_divide_ = floordiv_


def fmod_(t1, t2) -> DNDarray:
    """In-place C-style remainder."""
    return _inplace(t1, fmod(t1, t2))


def gcd_(t1, t2) -> DNDarray:
    """In-place greatest common divisor."""
    return _inplace(t1, gcd(t1, t2))


def hypot_(t1, t2) -> DNDarray:
    """In-place hypot."""
    return _inplace(t1, hypot(t1, t2))


def invert_(t) -> DNDarray:
    """In-place bit inversion."""
    return _inplace(t, invert(t))


bitwise_not_ = invert_


def lcm_(t1, t2) -> DNDarray:
    """In-place least common multiple."""
    return _inplace(t1, lcm(t1, t2))


def left_shift_(t1, t2) -> DNDarray:
    """In-place left shift."""
    return _inplace(t1, left_shift(t1, t2))


def mod_(t1, t2) -> DNDarray:
    """In-place remainder."""
    return _inplace(t1, mod(t1, t2))


remainder_ = mod_


def mul_(t1, t2) -> DNDarray:
    """In-place multiplication."""
    return _inplace(t1, mul(t1, t2))


multiply_ = mul_


def nan_to_num_(t, nan: float = 0.0, posinf=None, neginf=None) -> DNDarray:
    """In-place NaN and infinity replacement."""
    return _inplace(t, nan_to_num(t, nan, posinf, neginf))


def neg_(t) -> DNDarray:
    """In-place negation."""
    return _inplace(t, neg(t))


negative_ = neg_


def pos_(t) -> DNDarray:
    """In-place ``+t``."""
    return _inplace(t, pos(t))


positive_ = pos_


def pow_(t1, t2) -> DNDarray:
    """In-place power."""
    return _inplace(t1, pow(t1, t2))


power_ = pow_


def right_shift_(t1, t2) -> DNDarray:
    """In-place right shift."""
    return _inplace(t1, right_shift(t1, t2))


def sub_(t1, t2) -> DNDarray:
    """In-place subtraction."""
    return _inplace(t1, sub(t1, t2))


subtract_ = sub_

_INPLACE = [
    "add_", "bitwise_and_", "bitwise_not_", "bitwise_or_", "bitwise_xor_", "copysign_", "cumprod_", "cumproduct_",
    "cumsum_", "div_", "divide_", "floordiv_", "floor_divide_", "fmod_", "gcd_", "hypot_", "invert_", "lcm_",
    "left_shift_", "mod_", "mul_", "multiply_", "nan_to_num_", "neg_", "negative_", "pos_", "positive_", "pow_",
    "power_", "remainder_", "right_shift_", "sub_", "subtract_",
]
for _name in _INPLACE:
    setattr(DNDarray, _name, globals()[_name])
__all__ += _INPLACE
