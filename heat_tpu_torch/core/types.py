"""The heat type hierarchy on torch dtypes (counterpart of heat_tpu/core/types.py).

This port carries seven concrete types: bool, int32, int64, float32, float64,
complex64 and complex128.  Each class stands for one torch dtype.
"""

from __future__ import annotations

import builtins
from typing import Any, Type, Union

import numpy as np
import torch

__all__ = [
    "datatype",
    "bool",
    "number",
    "integer",
    "signedinteger",
    "floating",
    "int32",
    "int64",
    "float32",
    "float64",
    "complex",
    "complexfloating",
    "complex64",
    "complex128",
    "canonical_heat_type",
    "heat_type_is_complexfloating",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "promote_types",
    "iinfo",
]


class datatype:
    """Base of the scalar type hierarchy; its classes are never instantiated."""

    _torch_dtype: Any = None

    @classmethod
    def torch_type(cls):
        """The backing torch dtype."""
        return cls._torch_dtype


class bool(datatype):
    _torch_dtype = torch.bool


class number(datatype):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class int32(signedinteger):
    _torch_dtype = torch.int32


class int64(signedinteger):
    _torch_dtype = torch.int64


class floating(number):
    pass


class float32(floating):
    _torch_dtype = torch.float32


class float64(floating):
    _torch_dtype = torch.float64


class complexfloating(number):
    pass


# the reference names its abstract complex class plain ``complex``
complex = complexfloating


class complex64(complexfloating):
    _torch_dtype = torch.complex64


class complex128(complexfloating):
    _torch_dtype = torch.complex128


_CONCRETE = (bool, int32, int64, float32, float64, complex64, complex128)
_NUMPY = {
    bool: np.bool_, int32: np.int32, int64: np.int64, float32: np.float32, float64: np.float64,
    complex64: np.complex64, complex128: np.complex128,
}

_MAPPINGS: dict = {}
for _t in _CONCRETE:
    _MAPPINGS[_t] = _t
    _MAPPINGS[_t.torch_type()] = _t
    _MAPPINGS[np.dtype(_NUMPY[_t])] = _t
    _MAPPINGS[np.dtype(_NUMPY[_t]).name] = _t
    _MAPPINGS[_NUMPY[_t]] = _t
_MAPPINGS.update(
    {
        builtins.bool: bool, builtins.int: int32, builtins.float: float32, builtins.complex: complex64,
        "int": int32, "float": float32, "complex": complex64,
    }
)


def canonical_heat_type(a_type: Union[str, Type[datatype], Any]) -> Type[datatype]:
    """Resolve a heat type, torch dtype, numpy dtype, name or python type."""
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


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for bool and integer types."""
    return issubclass(canonical_heat_type(ht_dtype), (integer, bool))


def heat_type_is_inexact(ht_dtype) -> builtins.bool:
    """True for floating and complex types."""
    return issubclass(canonical_heat_type(ht_dtype), (floating, complexfloating))


def heat_type_is_complexfloating(ht_dtype) -> builtins.bool:
    """True for complex types."""
    return issubclass(canonical_heat_type(ht_dtype), complexfloating)


def promote_types(type1, type2) -> Type[datatype]:
    """Smallest type both can be cast to safely."""
    t1, t2 = canonical_heat_type(type1), canonical_heat_type(type2)
    return canonical_heat_type(torch.promote_types(t1.torch_type(), t2.torch_type()))


class iinfo:
    """Machine limits of an integer type."""

    def __init__(self, int_type):
        info = torch.iinfo(canonical_heat_type(int_type).torch_type())
        self.bits, self.min, self.max = info.bits, info.min, info.max
