"""Non-finite guards for iterative fits (counterpart of
heat_tpu/resilience/guard.py).

An iterative solver that walks into NaN keeps "converging" — the shift
``sum((new - old)**2)`` of two NaN iterates is NaN, every comparison
with the tolerance is False, and the loop runs to ``max_iter`` before
handing the caller NaN centroids with a clean exit code.
:func:`guard_finite` turns that into a structured
:class:`DivergenceError` carrying the last finite iterate, so callers
can restart from it instead of discovering the NaNs three pipeline
stages later.

Each tensor leaf (a DNDarray's local chunk, a torch tensor on any
device) is reduced on its own device by one ``torch.isfinite(...).all()``;
the leaves' flags are combined there and read back with one host sync
per call.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from .errors import DivergenceError

__all__ = ["guard_finite", "all_finite"]


def _leaves(x, out: List, comms: List) -> None:
    """The inexact tensor leaves of ``x`` (DNDarray / tensor / array /
    dict / list / tuple pytree) appended to ``out``, and the
    communicators of its split DNDarrays to ``comms``; exact leaves are
    finite by construction and skipped."""
    if isinstance(x, dict):
        for v in x.values():
            _leaves(v, out, comms)
        return
    if isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out, comms)
        return
    local = getattr(x, "larray", None)  # a DNDarray: this rank's true elements
    if isinstance(local, torch.Tensor) and x.split is not None:
        comms.append(x.comm)
    t = local if isinstance(local, torch.Tensor) else x
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    if t.is_floating_point() or t.is_complex():
        out.append(t)


def _finite_flag(leaves: List[torch.Tensor], comm=None) -> bool:
    """True when every leaf is finite: one ``isfinite().all()`` per leaf
    on its device, the flags combined on the first leaf's device, one
    host read; where ``comm`` spans several ranks, the ranks' flags
    meet in one all-reduce first."""
    if not leaves:
        return True
    dev = leaves[0].device
    flags = torch.stack([torch.isfinite(t).all().to(dev) for t in leaves])
    bad = (~flags).sum().reshape(1).to(torch.int64)
    if comm is not None and comm.size > 1:
        bad = comm.psum(bad)
    return int(bad.item()) == 0


def all_finite(x) -> bool:
    """Host bool: every element of ``x`` (array / DNDarray / tensor /
    dict / list / tuple pytree) is finite.  Containers recurse leaf-wise:
    a NaN in any leaf must trip the divergence guard.  A split DNDarray
    reads every rank's chunk (one all-reduce of the flag).  Forces a
    device sync — call at checkpoint cadence, not per iteration."""
    leaves: List[torch.Tensor] = []
    comms: List = []
    _leaves(x, leaves, comms)
    return _finite_flag(leaves, comms[0] if comms else None)


def guard_finite(
    x,
    what: str = "iterate",
    iteration: Optional[int] = None,
    last_good: Any = None,
    last_good_iteration: Optional[int] = None,
):
    """Raise :class:`DivergenceError` if ``x`` contains NaN/Inf.

    ``x`` passes through unchanged when finite, so the guard drops into
    an update chain: ``centers = guard_finite(step(centers), ...)``.
    ``last_good``/``last_good_iteration`` ride the raised error — the
    most recent finite iterate a caller can degrade to."""
    if not all_finite(x):
        where = f" at iteration {iteration}" if iteration is not None else ""
        hint = (
            f"; last finite iterate was iteration {last_good_iteration}"
            if last_good_iteration is not None
            else ""
        )
        raise DivergenceError(
            f"non-finite values in {what}{where} — the fit has diverged{hint}",
            iteration=iteration,
            last_good=last_good,
            last_good_iteration=last_good_iteration,
        )
    return x
