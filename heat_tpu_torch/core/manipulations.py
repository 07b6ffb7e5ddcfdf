"""Layout manipulations (counterpart of heat_tpu/core/manipulations.py):
so far ``balance`` and ``redistribute``; the rest of the module is still to
be ported (ROADMAP Queue 1 item 11)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["balance", "redistribute"]


def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """``array`` itself, or a balanced copy with ``copy``: the compute
    layout is always the canonical one (``DNDarray.balance_`` drops a
    ragged target in place)."""
    if not isinstance(array, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(array)}")
    return array.copy() if copy else array


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """A copy of ``arr`` with the layout ``target_map``
    (:meth:`DNDarray.redistribute_`)."""
    if not isinstance(arr, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(arr)}")
    return arr.copy().redistribute_(lshape_map=lshape_map, target_map=target_map)
