"""MNIST-shaped data (counterpart of heat_tpu/utils/data/mnist.py).

:func:`synthetic_mnist` draws the JAX package's synthetic digits from the
same numpy generator, so the images and labels are bitwise the
reference's.  :class:`MNISTDataset` is a :class:`~.datatools.Dataset` of
those digits: the JAX package reads torchvision's MNIST where torchvision
is installed and falls back to them otherwise; the port has the fallback
alone (the download needs torchvision and the network) and raises where
torchvision is installed rather than answer with other data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...core import factories
from ...core.dndarray import DNDarray
from .datatools import Dataset

__all__ = ["MNISTDataset", "synthetic_mnist"]


def synthetic_mnist(n: int = 1024, seed: int = 0) -> Tuple[DNDarray, DNDarray]:
    """Deterministic MNIST-shaped synthetic digits: (n, 28, 28, 1) float32
    images (NHWC, as the JAX package's) and (n,) int32 labels of 10
    classes, both split=0."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    base = rng.standard_normal((10, 28, 28)).astype(np.float32)
    imgs = base[labels] + 0.3 * rng.standard_normal((n, 28, 28)).astype(np.float32)
    return factories.array(imgs[..., None], split=0), factories.array(labels, split=0)


class MNISTDataset(Dataset):
    """MNIST over the ranks (heat's mnist.py:15): images and labels split
    along the samples, ``transform`` applied to the images of a batch."""

    def __init__(self, root: str, train: bool = True, transform=None, ishuffle: bool = False,
                 test_set: bool = False, download: bool = True):
        try:
            import torchvision  # noqa: F401
        except ImportError:
            x, y = synthetic_mnist()
        else:
            raise NotImplementedError("MNISTDataset reads torchvision's MNIST in the reference; the port has only the "
                                      "synthetic fallback (ROADMAP)")
        super().__init__([x, y], transforms=[transform, None], ishuffle=ishuffle)
        self.train = train

    @property
    def images(self) -> DNDarray:
        return self.arrays[0]

    @property
    def labels(self) -> DNDarray:
        return self.arrays[1]
