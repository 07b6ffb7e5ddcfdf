"""Vectorizing map (counterpart of heat_tpu/core/vmap.py).

``torch.func.vmap`` maps over the global (dense) tensors, with each
DNDarray argument's split axis as its mapped axis; the outputs are wrapped
again with the declared ``out_dims`` as their splits.  ``func`` receives
torch tensors, where the reference's receives jax arrays.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from .dndarray import DNDarray

__all__ = ["vmap"]


def vmap(func: Callable, out_dims: Union[int, Tuple] = 0) -> Callable:
    """Vectorize ``func`` over the split dimensions of its DNDarray inputs."""
    if not callable(func):
        raise TypeError("func must be callable")

    def wrapped(*args, **kwargs):
        dnd_args = [a for a in args if isinstance(a, DNDarray)]
        if not dnd_args:
            raise TypeError("at least one input must be a DNDarray")
        ref = dnd_args[0]
        in_dims = tuple(a.split if isinstance(a, DNDarray) else None for a in args)
        dense_args = tuple(a._dense() if isinstance(a, DNDarray) else a for a in args)
        vfunc = torch.func.vmap(func, in_dims=in_dims, out_dims=out_dims)
        result = vfunc(*dense_args, **kwargs)
        single = not isinstance(result, tuple)
        results = (result,) if single else result
        out_d = (out_dims,) * len(results) if isinstance(out_dims, int) else tuple(out_dims)
        wrapped_out = tuple(
            DNDarray.from_dense(r, d if d is not None and r.ndim > 0 else None, ref.device, ref.comm)
            for r, d in zip(results, out_d)
        )
        return wrapped_out[0] if single else wrapped_out

    return wrapped
