"""``ht.jit`` (counterpart of heat_tpu/core/fusion.py).

The reference traces a DNDarray -> DNDarray function once per (structure,
DNDarray shapes/dtypes/splits, static values) and compiles it into one XLA
program.  PyTorch runs eagerly, and the port needs no counterpart of
``jax.jit``: ``ht.jit`` keeps the
reference's signature, its refusals and its per-wrapper cache of keys, and
runs the function **eagerly** on every call, on DNDarrays rebuilt around
the arguments' tensors.  There is no capture and no compile; each call
counts one ``dispatch.external_dispatches``, as the reference's launch of
its compiled program does.  Fusing a pipeline into fewer launches (a CUDA
graph, ``torch.compile``) is a speed-up, to be made where a benchmark can
measure it.

Semantics, and where they differ from the reference's:

* DNDarray arguments are the arrays; everything else (ints, strings,
  shapes, containers of them) is STATIC and part of the cache key, as in
  the reference.  An unhashable non-array argument raises ``TypeError``.
* In-place updates to an ARGUMENT or to a view of one (``a += 1``,
  ``a[0] = v``, ``b = ht.reshape(a, s); b[0] = v``) leave the caller's array
  unmodified, as under the reference's trace.  ``+=`` rebinds the rebuilt
  array to a new tensor anyway; a write (``__setitem__``,
  ``fill_diagonal``, ``lloc``) into a tensor that shares storage with an
  argument first copies the written chunk (copy-on-write), which costs
  one copy of that chunk per call that writes into it.  A write into
  ``larray``/``larray_padded`` directly is not covered.  Return what you
  change.
* Results never alias the arguments, as the reference's compiled outputs
  do not: a returned array or tensor that shares storage with an argument
  (``return a``, ``return a[1:]``) is returned as a copy, so a later write
  into the caller's array leaves the result as it was.
* A host read inside the function (``float(x)``, ``x.numpy()``,
  data-dependent Python control flow) works, since the function runs
  eagerly; the reference raises jax's tracer errors there
  (``ConcretizationTypeError``, ``TracerArrayConversionError``).
* Keyword options meant for ``jax.jit`` that do not index arguments
  (``backend``, ``inline``, ...) are accepted and have no effect.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable

import torch

from . import dndarray as _dndarray
from .dndarray import DNDarray

__all__ = ["jit"]


class _ASpec:
    """Hashable stand-in for a DNDarray argument in the cache key."""

    __slots__ = ("shape", "dtype", "split", "device", "comm", "pshape", "pdtype")

    def __init__(self, x: DNDarray):
        self.shape = x.shape
        self.dtype = x.dtype
        self.split = x.split
        self.device = x.device
        self.comm = x.comm
        self.pshape = tuple(x.larray_padded.shape)
        self.pdtype = str(x.larray_padded.dtype)

    def _key(self):
        return (
            self.shape, self.dtype, self.split, self.device, self.comm,
            self.pshape, self.pdtype,
        )

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, _ASpec) and self._key() == other._key()


def _flatten(obj, leaves: list):
    """The structure of ``obj`` (tuples, lists, dicts and named tuples are
    nodes, as in jax's trees; anything else a leaf appended to ``leaves``)."""
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        try:
            keys = tuple(sorted(obj))
        except TypeError:
            keys = tuple(obj)
        return (dict, keys, tuple(_flatten(obj[k], leaves) for k in keys))
    leaves.append(obj)
    return None


def _unflatten(tree, leaves):
    if tree is None:
        return next(leaves)
    if tree[0] is dict:
        return {k: _unflatten(t, leaves) for k, t in zip(tree[1], tree[2])}
    kind, items = tree
    items = [_unflatten(t, leaves) for t in items]
    if hasattr(kind, "_fields"):  # a named tuple
        return kind(*items)
    return kind(items)


def _unaliased(obj):
    """``obj`` (a result, or a tuple, list or dict of them) with every
    DNDarray or tensor that shares storage with the running call's
    arguments replaced by a copy."""
    if isinstance(obj, DNDarray):
        return obj._unaliased()
    if isinstance(obj, torch.Tensor):
        return obj.clone() if _dndarray._jit_argument_storage(obj) else obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a named tuple
        return type(obj)(*(_unaliased(o) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unaliased(o) for o in obj)
    if isinstance(obj, dict):
        out = copy.copy(obj)
        for k, v in obj.items():
            out[k] = _unaliased(v)
        return out
    return obj


def jit(fn: Callable = None, **jit_kwargs) -> Callable:
    """Run a function over DNDarrays as one counted dispatch.

    ::

        @ht.jit
        def step(x, w):
            return ht.tanh(x @ w) - ht.mean(x, axis=0)

        y = step(a, b)     # runs eagerly; one external dispatch counted

    Each call keys a per-wrapper cache (``cache`` in the wrapper's closure:
    argument structure, DNDarray specs, static values), which grows as the
    reference's trace cache does."""
    if fn is None:
        return lambda f: jit(f, **jit_kwargs)

    # argument-indexed jax.jit options would index the internal flattened
    # array-leaf signature, not the user's parameters: refused, as the
    # reference refuses them
    _positional = {
        "static_argnums", "static_argnames", "donate_argnums",
        "donate_argnames", "in_shardings", "out_shardings",
    }
    bad = _positional.intersection(jit_kwargs)
    if bad:
        raise TypeError(
            f"ht.jit does not accept argument-indexed jax.jit options "
            f"({sorted(bad)}): indices would refer to the internal flattened "
            f"signature, not your function's parameters"
        )

    cache = {}

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any):
        flat: list = []
        treedef = _flatten((args, kwargs), flat)
        key_leaves = tuple(_ASpec(x) if isinstance(x, DNDarray) else ("static", x) for x in flat)
        try:
            key = (treedef, key_leaves)
            hash(key)
        except TypeError:
            raise TypeError(
                "ht.jit arguments must be DNDarrays or hashable statics; "
                "got an unhashable non-array argument"
            ) from None

        from . import dispatch as _dispatch

        cache[key] = cache.get(key, 0) + 1  # calls per key
        _dispatch.record_external_dispatch()
        # second DNDarrays around the arguments' tensors: a write rebinds the
        # copy alone (DNDarray._writable), so the caller's array stays as it was
        rebuilt = [copy.copy(x) if isinstance(x, DNDarray) else x for x in flat]
        a2, k2 = _unflatten(treedef, iter(rebuilt))
        held = _dndarray._JIT_ARGS.storages
        mine = {x.larray_padded.untyped_storage().data_ptr() for x in flat if isinstance(x, DNDarray)}
        _dndarray._JIT_ARGS.storages = held | mine
        try:
            return _unaliased(fn(*a2, **k2))
        finally:
            _dndarray._JIT_ARGS.storages = held

    return wrapper
