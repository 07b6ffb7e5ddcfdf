"""Image transforms (counterpart of heat_tpu/utils/vision_transforms.py).

heat passes ``torchvision.transforms`` through; the JAX package implements
the common ones itself and falls back to torchvision for the rest, and so
does the port, on torch tensors.  A transform takes a tensor, a numpy array
or a DNDarray; on a DNDarray it works on each rank's rows where it reads no
other rank's (``Normalize`` with one channel, ``CenterCrop`` and
``RandomHorizontalFlip`` off the split axis) and returns a DNDarray split as
its input, otherwise on the dense array.  ``RandomHorizontalFlip`` draws
from an explicit numpy generator, as the reference's does, so the same
seed flips the same calls.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["CenterCrop", "Compose", "Lambda", "Normalize", "RandomHorizontalFlip", "ToTensor"]


def _dense(pic) -> torch.Tensor:
    from ..core.dndarray import DNDarray

    if isinstance(pic, DNDarray):
        return pic._dense()
    if isinstance(pic, torch.Tensor):
        return pic
    return torch.from_numpy(np.array(np.asarray(pic)))


def _local(pic, fn, axis):
    """``fn`` on a DNDarray's padded chunk where its split is not ``axis``
    (the axis ``fn`` reads across; None for an element-wise ``fn``),
    keeping its layout; None otherwise."""
    from ..core.dndarray import DNDarray

    if not isinstance(pic, DNDarray) or pic.split is None:
        return None
    if axis is not None and pic.split == axis % max(pic.ndim, 1):
        return None
    out = fn(pic.larray_padded)
    gshape = list(pic.gshape)
    for d in range(pic.ndim):
        if d != pic.split:
            gshape[d] = out.shape[d]
    return pic._like(out, tuple(gshape))


class Compose:
    """Apply the transforms in order (torchvision's ``Compose``)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, pic):
        for t in self.transforms:
            pic = t(pic)
        return pic

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"{type(self).__name__}([{inner}])"


class ToTensor:
    """HWC (or HW) values to a CHW float32 tensor, integers scaled from
    [0, 255] to [0, 1] (torchvision's semantics)."""

    def __call__(self, pic):
        arr = _dense(pic)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3:
            arr = arr.permute(2, 0, 1)
        if not (arr.is_floating_point() or arr.is_complex()) and arr.dtype != torch.bool:
            arr = arr.to(torch.float32) / 255.0
        return arr.to(torch.float32)

    def __repr__(self):
        return "ToTensor()"


class Normalize:
    """``(x - mean) / std`` per channel along the first axis, in float32."""

    def __init__(self, mean, std, inplace: bool = False):
        self.mean = torch.as_tensor(np.asarray(mean, np.float32))
        self.std = torch.as_tensor(np.asarray(std, np.float32))

    def _apply(self, arr: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (arr.ndim - 1)
        return (arr - self.mean.to(arr.device).reshape(shape)) / self.std.to(arr.device).reshape(shape)

    def __call__(self, pic):
        if self.mean.numel() == 1 and self.std.numel() == 1:
            out = _local(pic, self._apply, None)
            if out is not None:
                return out
        return self._apply(_dense(pic))

    def __repr__(self):
        return f"Normalize(mean={self.mean.tolist()}, std={self.std.tolist()})"


class CenterCrop:
    """The central (h, w) window of a (..., H, W) array."""

    def __init__(self, size):
        self.size = (int(size), int(size)) if np.isscalar(size) else tuple(size)

    def _apply(self, arr: torch.Tensor) -> torch.Tensor:
        h, w = self.size
        H, W = arr.shape[-2], arr.shape[-1]
        top, left = max((H - h) // 2, 0), max((W - w) // 2, 0)
        return arr[..., top:top + h, left:left + w]

    def __call__(self, pic):
        from ..core.dndarray import DNDarray

        if isinstance(pic, DNDarray) and pic.split is not None and pic.split < pic.ndim - 2:
            return _local(pic, self._apply, -1)
        return self._apply(_dense(pic))

    def __repr__(self):
        return f"CenterCrop(size={self.size})"


class RandomHorizontalFlip:
    """Flip the width axis with probability ``p``, drawn from ``rng`` (a
    numpy generator).  The width axis is torchvision's: -2 for an HWC array
    (3-D, channels last, not channels first), else -1."""

    def __init__(self, p: float = 0.5, rng: "np.random.Generator | None" = None):
        self.p = float(p)
        self.rng = rng or np.random.default_rng()

    @staticmethod
    def _width_axis(shape) -> int:
        if len(shape) >= 3 and shape[-1] in (1, 3, 4) and shape[-3] not in (1, 3, 4):
            return -2
        return -1

    def __call__(self, pic):
        flip = self.rng.random() < self.p
        shape = tuple(pic.shape)
        axis = self._width_axis(shape)
        if not flip:
            from ..core.dndarray import DNDarray

            return pic if isinstance(pic, DNDarray) else _dense(pic)
        out = _local(pic, lambda t: torch.flip(t, dims=(axis,)), axis)
        return out if out is not None else torch.flip(_dense(pic), dims=(axis,))

    def __repr__(self):
        return f"RandomHorizontalFlip(p={self.p})"


class Lambda:
    """A user's callable as a transform."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, pic):
        return self.fn(pic)

    def __repr__(self):
        return "Lambda()"


def __getattr__(name):
    """torchvision's transforms for any name not defined here, as the
    reference falls back (heat's vision_transforms.py:10-19)."""
    try:
        import torchvision.transforms as tvt
    except ImportError as exc:
        raise AttributeError(f"module {name} not implemented in heat_tpu_torch (and torchvision is absent)") from exc
    if hasattr(tvt, name):
        return getattr(tvt, name)
    raise AttributeError(f"module {name} not implemented in torchvision or heat_tpu_torch")
