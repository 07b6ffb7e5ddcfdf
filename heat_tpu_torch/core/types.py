"""The heat type hierarchy on torch dtypes (counterpart of heat_tpu/core/types.py).

The port carries the reference's fifteen concrete types: bool, int8, int16,
int32, int64, uint8, uint16, uint32, uint64, float16, bfloat16, float32,
float64, complex64 and complex128.  Each class stands for one torch dtype,
the dtype its data is held in (:meth:`datatype.torch_type`).  Three types
are held in a wider signed dtype, because torch's uint16, uint32 and uint64
have no arithmetic or comparisons of their own:

* uint16 lives in int32 and uint32 in int64: every value fits exactly;
* uint64 lives in int64 as the same 64 bits (values past 2^63 - 1 read as
  negative int64); :func:`_cast` reads them back as unsigned.

A DNDarray keeps its heat type beside its tensor, so the holding dtype never
shows: ``numpy()`` gives uint16/uint32/uint64 arrays.  Every operation gives
these types' own answers: ``+``, ``-``, ``*`` and their reductions and scans
wrap modulo 2^16, 2^32 or 2^64 (:func:`_wrap`), orderings read uint64's bits
as unsigned (:func:`_order_key`), a conversion to float rounds once
(:func:`_u64_as_float`), and ``//`` and ``%`` of uint64 divide unsigned
(``arithmetics._udivmod``).

Promotion follows the reference, whose lattice is JAX's, not torch's
(``promote_types(int64, uint64)`` is float64, ``promote_types(int32,
uint32)`` int64, ``promote_types(bfloat16, float16)`` float32); the port
keeps its own copy of that lattice in :data:`_LATTICE`.  The 64-bit types
are always on: the reference's tests run with x64 enabled, and
:func:`enable_x64` only confirms that.
"""

from __future__ import annotations

import builtins
from typing import Any, Dict, FrozenSet, Type, Union

import numpy as np
import torch

__all__ = [
    "datatype",
    "generic",
    "number",
    "bool",
    "bool_",
    "integer",
    "signedinteger",
    "unsignedinteger",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int64",
    "long",
    "uint8",
    "ubyte",
    "uint16",
    "uint32",
    "uint64",
    "floating",
    "float16",
    "half",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "flexible",
    "complex",
    "complexfloating",
    "complex64",
    "cfloat",
    "csingle",
    "complex128",
    "cdouble",
    "canonical_dtype",
    "canonical_heat_type",
    "heat_type_of",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_is_realfloating",
    "heat_type_is_complexfloating",
    "issubdtype",
    "can_cast",
    "promote_types",
    "result_type",
    "iinfo",
    "finfo",
    "enable_x64",
    "iscomplex",
    "isreal",
]


class datatype:
    """Base of the scalar type hierarchy.  Calling a concrete type casts its
    argument into a DNDarray of that type, as in the reference:
    ``ht.float32(x)``."""

    _torch_dtype: Any = None

    def __new__(cls, *value, device=None, comm=None):
        from . import factories

        if cls._torch_dtype is None:
            raise TypeError(f"cannot instantiate abstract type {cls.__name__}")
        if len(value) == 0:
            value = (0,)
        elif len(value) == 1:
            value = value[0]
            if isinstance(value, builtins.complex) and not issubclass(cls, complexfloating):
                raise TypeError(f"cannot cast complex scalar to {cls.__name__}")
        return factories.array(value, dtype=cls, device=device, comm=comm)

    @classmethod
    def torch_type(cls):
        """The torch dtype the data is held in."""
        return cls._torch_dtype

    @classmethod
    def char(cls) -> str:
        """Short dtype name."""
        return cls.__name__


class bool(datatype):
    _torch_dtype = torch.bool


bool_ = bool


class number(datatype):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class unsignedinteger(integer):
    pass


class int8(signedinteger):
    _torch_dtype = torch.int8


byte = int8


class int16(signedinteger):
    _torch_dtype = torch.int16


short = int16


class int32(signedinteger):
    _torch_dtype = torch.int32


int = int32


class int64(signedinteger):
    _torch_dtype = torch.int64


long = int64


class uint8(unsignedinteger):
    _torch_dtype = torch.uint8


ubyte = uint8


class uint16(unsignedinteger):
    """Held in int32: every value fits."""

    _torch_dtype = torch.int32


class uint32(unsignedinteger):
    """Held in int64: every value fits."""

    _torch_dtype = torch.int64


class uint64(unsignedinteger):
    """Held in int64 as the same 64 bits."""

    _torch_dtype = torch.int64


class floating(number):
    pass


class float16(floating):
    _torch_dtype = torch.float16


half = float16


class bfloat16(floating):
    _torch_dtype = torch.bfloat16


class float32(floating):
    _torch_dtype = torch.float32


float = float32
float_ = float32


class float64(floating):
    _torch_dtype = torch.float64


double = float64


class flexible(datatype):
    """Abstract flexible type, kept for the hierarchy's parity."""


class complexfloating(number):
    pass


# the reference names its abstract complex class plain ``complex``
complex = complexfloating


class complex64(complexfloating):
    _torch_dtype = torch.complex64


cfloat = complex64
csingle = complex64


class complex128(complexfloating):
    _torch_dtype = torch.complex128


cdouble = complex128

generic = datatype

_CONCRETE = (
    bool, int8, int16, int32, int64, uint8, uint16, uint32, uint64,
    float16, bfloat16, float32, float64, complex64, complex128,
)
#: the types held in a wider signed torch dtype than their own
_WIDENED = (uint16, uint32, uint64)
_NUMPY = {
    bool: np.bool_, int8: np.int8, int16: np.int16, int32: np.int32, int64: np.int64, uint8: np.uint8,
    uint16: np.uint16, uint32: np.uint32, uint64: np.uint64, float16: np.float16, float32: np.float32,
    float64: np.float64, complex64: np.complex64, complex128: np.complex128,
}
# torch's own unsigned dtypes name the types held wider
_TORCH_NAMES = {torch.uint16: uint16, torch.uint32: uint32, torch.uint64: uint64}

_MAPPINGS: dict = {}
for _t in _CONCRETE:
    _MAPPINGS[_t] = _t
    _MAPPINGS[_t.__name__] = _t
    if _t not in _WIDENED:
        _MAPPINGS[_t.torch_type()] = _t
for _t, _n in _NUMPY.items():
    _MAPPINGS[_n] = _t
    _MAPPINGS[np.dtype(_n)] = _t
_MAPPINGS.update(_TORCH_NAMES)
_MAPPINGS.update(
    {
        builtins.bool: bool, builtins.int: int32, builtins.float: float32, builtins.complex: complex64,
        "int": int32, "float": float32, "complex": complex64,
    }
)


def canonical_heat_type(a_type: Union[str, Type[datatype], Any]) -> Type[datatype]:
    """Resolve a heat type, torch dtype, numpy dtype, name or python type.
    A torch int32 or int64 dtype names int32 or int64, never the unsigned
    types held in them."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        if a_type.torch_type() is None:
            raise TypeError(f"data type {a_type.__name__!r} is abstract")
        return a_type
    try:
        return _MAPPINGS[a_type]
    except (KeyError, TypeError):
        pass
    try:
        return _MAPPINGS[np.dtype(a_type)]
    except (KeyError, TypeError):
        raise TypeError(f"data type {a_type!r} is not understood") from None


def canonical_dtype(a_type):
    """The torch dtype ``a_type`` is held in.  The reference's returns the
    jnp dtype representable under its x64 setting; the port's 64-bit types
    are always on, so this is the holding dtype itself."""
    return canonical_heat_type(a_type).torch_type()


def heat_type_of(obj: Any) -> Type[datatype]:
    """The heat type of an arbitrary object: a DNDarray's, an array's or a
    tensor's dtype, python scalars as the reference types them (int ->
    int32, float -> float32, complex -> complex64), a list by numpy."""
    from .dndarray import DNDarray

    if isinstance(obj, DNDarray):
        return obj.dtype
    if hasattr(obj, "dtype"):
        return canonical_heat_type(obj.dtype)
    if isinstance(obj, builtins.bool):
        return bool
    if isinstance(obj, builtins.int):
        return int32
    if isinstance(obj, builtins.float):
        return float32
    if isinstance(obj, builtins.complex):
        return complex64
    if isinstance(obj, (list, tuple)):
        return canonical_heat_type(np.asarray(obj).dtype)
    raise TypeError(f"data type of {obj!r} is not understood")


def issubdtype(arg1, arg2) -> builtins.bool:
    """NumPy-style subtype check on the heat hierarchy."""
    if not (isinstance(arg1, type) and issubclass(arg1, datatype)):
        arg1 = canonical_heat_type(arg1)
    if not (isinstance(arg2, type) and issubclass(arg2, datatype)):
        arg2 = canonical_heat_type(arg2)
    return issubclass(arg1, arg2)


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for bool and integer types."""
    return issubclass(canonical_heat_type(ht_dtype), (integer, bool))


def heat_type_is_inexact(ht_dtype) -> builtins.bool:
    """True for floating and complex types."""
    return issubclass(canonical_heat_type(ht_dtype), (floating, complexfloating))


def heat_type_is_realfloating(ht_dtype) -> builtins.bool:
    """True for real floating types."""
    return issubclass(canonical_heat_type(ht_dtype), floating)


def heat_type_is_complexfloating(ht_dtype) -> builtins.bool:
    """True for complex types."""
    return issubclass(canonical_heat_type(ht_dtype), complexfloating)


# ----------------------------------------------------------------------
# casting rules
# ----------------------------------------------------------------------
_KIND = {
    bool: "b", int8: "i", int16: "i", int32: "i", int64: "i", uint8: "u", uint16: "u", uint32: "u", uint64: "u",
    float16: "f", bfloat16: "f", float32: "f", float64: "f", complex64: "c", complex128: "c",
}


def _np_proxy(t) -> np.dtype:
    """The numpy dtype that answers ``t``'s safe-cast queries: bfloat16 casts
    like float16 (it has no numpy dtype)."""
    return np.dtype(np.float16 if t is bfloat16 else _NUMPY[t])


def _is_scalar(x) -> builtins.bool:
    return isinstance(x, (builtins.bool, builtins.int, builtins.float, builtins.complex))


def can_cast(from_, to, casting: str = "intuitive") -> builtins.bool:
    """Whether ``from_`` (a type or a python scalar) casts to ``to`` under
    ``casting``: ``"no"``, ``"safe"``, ``"same_kind"``, ``"unsafe"`` or the
    reference's default ``"intuitive"`` (``same_kind``, and bool to bool)."""
    frm = canonical_heat_type(heat_type_of(from_) if _is_scalar(from_) else from_)
    to_t = canonical_heat_type(to)
    if casting == "no":
        return frm is to_t
    if casting == "unsafe":
        return True
    if casting == "safe":
        # bfloat16 and float16 hold values the other cannot
        if {frm, to_t} == {bfloat16, float16}:
            return False
        return builtins.bool(np.can_cast(_np_proxy(frm), _np_proxy(to_t), casting="safe"))
    if casting in ("same_kind", "intuitive"):
        if casting == "intuitive" and _KIND[frm] == "b" and _KIND[to_t] == "b":
            return True
        return builtins.bool(np.can_cast(_np_proxy(frm), _np_proxy(to_t), casting="same_kind"))
    raise ValueError(f"casting must be one of 'no', 'safe', 'same_kind', 'unsafe', 'intuitive', got {casting!r}")


# JAX's type promotion lattice, the reference's: each node and the nodes
# directly above it.  "i*", "f*" and "c*" are python ints, floats and complex
# numbers (weak types): they take the other operand's type within its kind.
_LATTICE: Dict[Any, tuple] = {
    bool: ("i*",),
    "i*": (uint8, int8),
    uint8: (int16, uint16),
    uint16: (int32, uint32),
    uint32: (int64, uint64),
    uint64: ("f*",),
    int8: (int16,),
    int16: (int32,),
    int32: (int64,),
    int64: ("f*",),
    "f*": ("c*", float16, bfloat16),
    float16: (float32,),
    bfloat16: (float32,),
    float32: (float64, complex64),
    float64: (complex128,),
    "c*": (complex64,),
    complex64: (complex128,),
    complex128: (),
}
# a weak result becomes the default type of its kind (64-bit: x64 is on)
_WEAK_DEFAULT = {"i*": int64, "f*": float64, "c*": complex128}


def _upper_bounds(node) -> FrozenSet:
    """The node and every node above it in :data:`_LATTICE`."""
    seen = {node}
    todo = [node]
    while todo:
        for up in _LATTICE[todo.pop()]:
            if up not in seen:
                seen.add(up)
                todo.append(up)
    return frozenset(seen)


_UPPER = {node: _upper_bounds(node) for node in _LATTICE}


def _join(*nodes):
    """The least upper bound of lattice nodes."""
    common = frozenset.intersection(*(_UPPER[n] for n in nodes))
    least = [n for n in common if _UPPER[n] <= common and builtins.all(c in _UPPER[n] for c in common)]
    if len(least) != 1:
        raise TypeError(f"no unique promotion of {nodes}")
    return least[0]


def promote_types(type1, type2) -> Type[datatype]:
    """The smallest type both can be cast to safely, by the reference's
    lattice (JAX's): ``promote_types(int64, uint64)`` is float64,
    ``promote_types(bfloat16, float16)`` float32."""
    joined = _join(canonical_heat_type(type1), canonical_heat_type(type2))
    return _WEAK_DEFAULT.get(joined, joined)


def _node(a):
    """The lattice node of one operand of :func:`result_type`."""
    from .dndarray import DNDarray

    if isinstance(a, DNDarray):
        return a.dtype
    if isinstance(a, builtins.bool):
        return bool
    if isinstance(a, builtins.int):
        return "i*"
    if isinstance(a, builtins.float):
        return "f*"
    if isinstance(a, builtins.complex):
        return "c*"
    if hasattr(a, "dtype"):
        return canonical_heat_type(a.dtype)
    return canonical_heat_type(a)


def result_type(*arrays_and_types) -> Type[datatype]:
    """The type of an operation's result over the given operands (arrays,
    types or python scalars), by the reference's lattice: a python scalar
    takes the other operands' type within its kind, and scalars alone give
    the 64-bit default of their kind."""
    if not arrays_and_types:
        raise ValueError("at least one array or dtype is required")
    joined = _join(*(_node(a) for a in arrays_and_types))
    return _WEAK_DEFAULT.get(joined, joined)


class iinfo:
    """Machine limits of an integer type."""

    def __init__(self, dtype):
        t = canonical_heat_type(dtype)
        if not issubclass(t, integer):
            raise ValueError(f"Invalid integer data type {t.__name__!r}.")
        info = np.iinfo(_NUMPY[t])
        self.bits = info.bits
        self.min = builtins.int(info.min)
        self.max = builtins.int(info.max)
        self.dtype = t

    def __repr__(self) -> str:
        return f"iinfo(min={self.min}, max={self.max}, dtype={self.dtype.__name__})"


_REAL_OF = {complex64: float32, complex128: float64}


class finfo:
    """Machine limits of a floating type (a complex type's are its real
    part's).  ``resolution`` is ``10 ** -precision`` in the type, as the
    reference's."""

    def __init__(self, dtype):
        t = canonical_heat_type(dtype)
        if not issubclass(t, (floating, complexfloating)):
            raise ValueError(f"data type {t.__name__!r} not inexact")
        real = _REAL_OF.get(t, t).torch_type()
        info = torch.finfo(real)
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        self.resolution = builtins.float(torch.tensor(info.resolution, dtype=real))
        self.dtype = t

    def __repr__(self) -> str:
        return f"finfo(resolution={self.resolution}, min={self.min}, max={self.max}, dtype={self.dtype.__name__})"


def iscomplex(x):
    """Element-wise: True where ``x`` has a non-zero imaginary part."""
    from . import factories
    from .sanitation import sanitize_in

    sanitize_in(x)
    if issubclass(x.dtype, complexfloating):
        return x._like(x.larray_padded.imag != 0, dtype=bool)
    return factories.zeros(x.shape, bool, split=x.split, device=x.device, comm=x.comm)


def isreal(x):
    """Element-wise: True where ``x`` has no imaginary part."""
    from . import factories
    from .sanitation import sanitize_in

    sanitize_in(x)
    if issubclass(x.dtype, complexfloating):
        return x._like(x.larray_padded.imag == 0, dtype=bool)
    return factories.ones(x.shape, bool, split=x.split, device=x.device, comm=x.comm)


def enable_x64(enable: builtins.bool = True) -> None:
    """The port holds 64-bit types always (the reference's tests run with
    x64 on); ``enable_x64(False)`` raises rather than pretend to narrow."""
    if not enable:
        raise NotImplementedError("heat_tpu_torch always holds 64-bit types; x64 cannot be switched off")


# ----------------------------------------------------------------------
# holding and casting the data
# ----------------------------------------------------------------------
_TWO64 = builtins.float(2**64)


def numpy_type(t) -> Any:
    """The numpy dtype of a type's values: bfloat16, which numpy lacks,
    is given as float32 (every value exact)."""
    return np.float32 if t is bfloat16 else _NUMPY[t]


def _itemsize(t) -> int:
    """Bytes of one element of type ``t`` (not of its holding dtype)."""
    return 2 if t is bfloat16 else np.dtype(_NUMPY[t]).itemsize


def _to_holding(data: np.ndarray, t) -> np.ndarray:
    """A numpy array of type ``t`` as its holding dtype's numpy array."""
    if t is uint64:
        return np.ascontiguousarray(data.astype(np.uint64, copy=False)).view(np.int64).reshape(np.shape(data))
    if t is uint32:
        return data.astype(np.int64)
    if t is uint16:
        return data.astype(np.int32)
    return data


def _from_holding(data: np.ndarray, t) -> np.ndarray:
    """A holding dtype's numpy array read back as type ``t``."""
    if t is uint64:  # np.ascontiguousarray makes a 0-d array 1-d
        return np.ascontiguousarray(data).view(np.uint64).reshape(np.shape(data))
    if t in (uint16, uint32):
        return data.astype(_NUMPY[t])
    return data


_CAST_CHUNK = 1 << 24  # elements a cast of several passes works on at a time


def _chunked(fn, data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``fn`` (element-wise, several passes) over ``data`` in chunks of
    ``_CAST_CHUNK`` elements into one tensor of ``dtype``: its temporaries
    stay a chunk's size, not the whole array's."""
    flat = data.contiguous().reshape(-1)
    out = torch.empty(flat.shape, dtype=dtype, device=data.device)
    for start in range(0, flat.numel(), _CAST_CHUNK):
        out[start:start + _CAST_CHUNK] = fn(flat[start:start + _CAST_CHUNK])
    return out.reshape(data.shape)


# the bits of uint16's and uint32's values within their holding dtype
_WIDTH_MASK = {uint16: 0xFFFF, uint32: 0xFFFFFFFF}
_SIGN64 = -(1 << 63)


def _wrap(data: torch.Tensor, t) -> torch.Tensor:
    """Holding integers of type ``t`` reduced modulo 2^bits, as ``t``'s own
    arithmetic wraps: after ``+``, ``-``, ``*`` and their reductions and
    scans on uint16 (held in int32) and uint32 (int64).  The holding
    dtype's own wrap-around keeps the low bits right; uint64's bits are
    int64's, which wrap modulo 2^64 already."""
    mask = _WIDTH_MASK.get(t)
    return data & mask if mask is not None else data


def _order_key(data: torch.Tensor, t) -> torch.Tensor:
    """Holding values of type ``t`` as signed integers of the same order:
    uint16 and uint32 as held, uint64's bits with the top bit flipped (its
    own inverse, so the same call maps the keys back)."""
    return data ^ _SIGN64 if t is uint64 else data


def _u64_as_float(bits: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """int64-held uint64 values in float dtype ``dt``, rounded once (as a
    uint64 converts): values below 2^63 convert as they are; the others
    are halved with the bit shifted out kept as a sticky bit, converted
    and doubled exactly."""
    half = (torch.bitwise_right_shift(bits, 1) & 0x7FFFFFFFFFFFFFFF) | (bits & 1)
    return torch.where(bits < 0, half.to(dt) * 2, bits.to(dt))


def _float_as_u64(data: torch.Tensor) -> torch.Tensor:
    """Float values in [0, 2^64) as uint64's int64 bits, truncated."""
    return torch.where(data >= 2.0**63, (data - _TWO64).to(torch.int64), data.to(torch.int64))


def _cast(data: torch.Tensor, frm, to) -> torch.Tensor:
    """``data`` held as type ``frm`` cast to type ``to``'s holding dtype with
    the reference's values: integers wrap modulo the target's width, floats
    truncate toward zero (exact where the value fits), uint64 reads its
    int64 bits as unsigned."""
    frm, to = canonical_heat_type(frm), canonical_heat_type(to)
    if frm is to:
        return data
    dt = to.torch_type()
    if frm is uint64 and not issubclass(to, integer) and to is not bool:
        return _chunked(lambda c: _u64_as_float(c, dt), data, dt)
    if to in _WIDENED:
        if data.dtype.is_complex:
            data = data.real
        if to is uint64:
            return _chunked(_float_as_u64, data, dt) if data.is_floating_point() else data.to(dt)
        mask = 0xFFFF if to is uint16 else 0xFFFFFFFF
        return _chunked(lambda c: (c.to(torch.int64) & mask).to(dt), data, dt)
    if data.dtype.is_complex and not dt.is_complex:
        if dt == torch.bool:
            return data != 0  # either part non-zero
        data = data.real  # the real part, as the reference's cast keeps
    return data.to(dt)
