"""Printing (counterpart of heat_tpu/core/printing.py).

A DNDarray prints as the reference prints it: ``np.array2string`` of its
values (precision 4, threshold 1000, edge items 3 by default, ``", "``
between elements), then its type, device and split.  Above the threshold
numpy shows only the edge items of each axis and formats them from those
alone, so only those blocks are fetched to the host (:func:`_edge_view`):
printing a split array of billions of elements copies a few hundred.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import types

__all__ = [
    "get_printoptions",
    "global_printing",
    "local_printing",
    "print0",
    "printoptions",
    "set_printoptions",
    "set_string_function",
]

_LOCAL_PRINTING = False

__PRINT_OPTIONS = dict(precision=4, threshold=1000, edgeitems=3, linewidth=120, sci_mode=None)

#: bytes copied to the host by the last global print (what _edge_view fetched)
LAST_FETCH_BYTES = 0


def get_printoptions() -> dict:
    """The current print options."""
    return dict(__PRINT_OPTIONS)


def global_printing() -> None:
    """Print global arrays (the default)."""
    global _LOCAL_PRINTING
    _LOCAL_PRINTING = False


def local_printing() -> None:
    """Print only each rank's own chunk."""
    global _LOCAL_PRINTING
    _LOCAL_PRINTING = True


def print0(*args, **kwargs) -> None:
    """Print on rank 0 only."""
    from ..parallel.comm import get_comm

    if get_comm().rank == 0:
        print(*args, **kwargs)


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None, sci_mode=None):
    """Configure formatting; the options are mirrored into numpy's, as the
    reference does."""
    if profile == "default":
        __PRINT_OPTIONS.update(precision=4, threshold=1000, edgeitems=3, linewidth=120)
    elif profile == "short":
        __PRINT_OPTIONS.update(precision=2, threshold=1000, edgeitems=2, linewidth=120)
    elif profile == "full":
        __PRINT_OPTIONS.update(precision=4, threshold=np.inf, edgeitems=3, linewidth=120)
    for k, v in dict(
        precision=precision, threshold=threshold, edgeitems=edgeitems, linewidth=linewidth, sci_mode=sci_mode
    ).items():
        if v is not None:
            __PRINT_OPTIONS[k] = v
    np.set_printoptions(
        precision=int(__PRINT_OPTIONS["precision"]),
        threshold=__PRINT_OPTIONS["threshold"],
        edgeitems=int(__PRINT_OPTIONS["edgeitems"]),
        linewidth=int(__PRINT_OPTIONS["linewidth"]),
    )


@contextlib.contextmanager
def printoptions(**kwargs):
    """Apply print options within a ``with`` block (numpy's too), then
    restore both."""
    saved = dict(__PRINT_OPTIONS)
    saved_np = np.get_printoptions()
    try:
        set_printoptions(**kwargs)
        yield get_printoptions()
    finally:
        __PRINT_OPTIONS.clear()
        __PRINT_OPTIONS.update(saved)
        np.set_printoptions(**saved_np)


def set_string_function(f, repr: bool = True) -> None:
    """Override the DNDarray's ``__repr__`` (or ``__str__``) with ``f``;
    None restores the default."""
    from .dndarray import DNDarray

    attr = "__repr_override__" if repr else "__str_override__"
    if f is None:
        if hasattr(DNDarray, attr):
            delattr(DNDarray, attr)
    else:
        setattr(DNDarray, attr, staticmethod(f))


def _edge_index(n: int, edge: int) -> list:
    """The indices of one axis that a summarised print reads: the first and
    last ``edge``, and one between them (never shown, but it keeps the axis
    longer than ``2 edge``, so numpy still elides it)."""
    if n <= 2 * edge:
        return list(range(n))
    return list(range(edge)) + [edge] + list(range(n - edge, n))


def _edge_view(x) -> np.ndarray:
    """The host values numpy needs to print ``x`` summarised: on each axis
    longer than ``2 edge`` the edge blocks (and one elided index).  Each
    rank takes its own rows of the edge blocks; they meet in one
    all-gather of those few rows."""
    from ..parallel.comm import _as_bytes, _from_bytes

    edge = int(__PRINT_OPTIONS["edgeitems"])
    picks = [_edge_index(n, edge) for n in x.shape]
    local = x.larray
    dev = local.device
    split = x.split
    for d, idx in enumerate(picks):
        if d == split:
            lo = x.comm.chunk(x.shape, split)[0]
            mine = [i - lo for i in idx if lo <= i < lo + local.shape[d]]
            local = local.index_select(d, torch.tensor(mine, dtype=torch.int64, device=dev))
        else:
            local = local.index_select(d, torch.tensor(idx, dtype=torch.int64, device=dev))
    if split is not None and x.comm.size > 1:
        counts = []
        for r in range(x.comm.size):
            lo, lsh, _ = x.comm.chunk(x.shape, split, rank=r)
            counts.append(sum(1 for i in picks[split] if lo <= i < lo + lsh[split]))
        parts = x.comm.all_gather_varying(_as_bytes(local), counts, split)
        local = _from_bytes(torch.cat(parts, dim=split), local.dtype)
    if local.dtype == torch.bfloat16:
        local = local.float()
    return types._from_holding(local.cpu().numpy(), x.dtype)


def __str__(dndarray) -> str:
    """The reference's string of a DNDarray."""
    global LAST_FETCH_BYTES
    if _LOCAL_PRINTING:
        data = dndarray.larray
        if data.dtype == torch.bfloat16:
            data = data.float()
        return f"DNDarray(local={data.cpu().numpy()}, device={dndarray.device}, split={dndarray.split})"
    threshold = __PRINT_OPTIONS["threshold"]
    if dndarray.size > threshold:
        data = _edge_view(dndarray)
        threshold = 0  # summarise the fetched view as numpy would the whole
    else:
        data = dndarray.numpy()
    LAST_FETCH_BYTES = int(data.nbytes)
    body = np.array2string(
        data,
        precision=int(__PRINT_OPTIONS["precision"]),
        threshold=threshold,
        edgeitems=int(__PRINT_OPTIONS["edgeitems"]),
        separator=", ",
        prefix="DNDarray(",
    )
    return f"DNDarray({body}, dtype=ht.{dndarray.dtype.__name__}, device={dndarray.device}, split={dndarray.split})"
