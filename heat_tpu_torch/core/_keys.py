"""Order keys: signed integers whose order is a sort's order of the values.

torch sorts and compares signed integers on every device, and few of its
operations take uint32 or uint64, so the keys are signed, of the values'
width.  A float's key is its bits with the magnitude bits flipped where it
is negative; a descending sort takes the bitwise NOT of the ascending key.

Three orders of floats are in use, as in the reference:

* :func:`_ordered` (the sample sort's, the reference's ``_order_bits``):
  -0.0 below +0.0, and every NaN last, whatever its sign;
* :func:`sort_keys` with ``merge_zeros`` (a stable ``argsort``'s, the dense
  route of ``sort``): -0.0 equal to +0.0, every NaN last;
* :func:`total_keys` (``lax.top_k``'s total order): -0.0 below +0.0, a NaN
  above +inf and a NaN of negative sign below -inf.
"""

from __future__ import annotations

from typing import List

import torch

__all__ = []

_KEY_TYPES = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32,
              torch.float64: torch.int64}


def total_keys(x: torch.Tensor) -> torch.Tensor:
    """The values of a float tensor as signed integers of their width in
    the IEEE total order (the sign of a NaN counts)."""
    kind = _KEY_TYPES[x.dtype]
    bits = x.view(kind)
    return torch.bitwise_xor(bits, (bits >> (bits.element_size() * 8 - 1)) & torch.iinfo(kind).max)


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """The values of x as signed integers of their width in the values'
    order (a float's bits, the magnitude bits flipped where it is negative);
    NaN last of all."""
    return total_keys(x).masked_fill_(torch.isnan(x), torch.iinfo(_KEY_TYPES[x.dtype]).max)


def _from_ordered(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values whose :func:`_ordered` keys are ``key`` (int64 holding
    keys of ``dtype``'s width)."""
    kind = _KEY_TYPES[dtype]
    key = key.to(kind)
    return torch.bitwise_xor(key, (key >> (key.element_size() * 8 - 1)) & torch.iinfo(kind).max).view(dtype)


def sort_keys(x: torch.Tensor, descending: bool = False, merge_zeros: bool = False,
              unsigned64: bool = False) -> List[torch.Tensor]:
    """The int64 keys, most significant first, whose lexicographic order is
    the sort order of ``x`` (held in its holding dtype).

    Floats: :func:`_ordered` (with ``merge_zeros`` -0.0 counts as +0.0);
    complex: the real part's key, then the imaginary part's (NaN last in
    each); bool and integers: their values; uint64 held in int64
    (``unsigned64``), or in torch's own uint64: its bits with the sign bit
    flipped.  ``descending``
    takes the NOT of each key."""
    if x.is_complex():
        keys = sort_keys(x.real, merge_zeros=merge_zeros) + sort_keys(x.imag, merge_zeros=merge_zeros)
    elif x.is_floating_point():
        keys = [_ordered(x + 0.0 if merge_zeros else x).to(torch.int64)]
    elif unsigned64:
        keys = [unsigned_keys(x)]
    elif x.dtype == torch.uint64:  # torch's own uint64: its bits in unsigned order
        keys = [unsigned_keys(x.view(torch.int64))]
    else:
        keys = [x.to(torch.int64)]
    return [torch.bitwise_not(k) for k in keys] if descending else keys


def unsigned_keys(bits: torch.Tensor) -> torch.Tensor:
    """uint64 values held as int64 bits, as keys in their unsigned order."""
    return torch.bitwise_xor(bits, torch.iinfo(torch.int64).min)


def lex_sort(keys: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The permutation along ``dim`` that sorts by ``keys`` (one shape),
    most significant first, stably: one stable sort per key, the least
    significant first."""
    perm = None
    for k in reversed(keys):
        k = k if perm is None else k.gather(dim, perm)
        order = torch.sort(k, dim=dim, stable=True).indices
        perm = order if perm is None else perm.gather(dim, order)
    return perm
