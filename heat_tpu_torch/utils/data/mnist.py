"""MNIST-shaped data (counterpart of heat_tpu/utils/data/mnist.py).

:func:`synthetic_mnist` draws the JAX package's synthetic digits from the
same numpy generator, so the images and labels are bitwise the
reference's.  ``MNISTDataset`` (torchvision's MNIST split over the ranks)
waits with the rest of utils/data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...core import factories
from ...core.dndarray import DNDarray

__all__ = ["synthetic_mnist"]


def synthetic_mnist(n: int = 1024, seed: int = 0) -> Tuple[DNDarray, DNDarray]:
    """Deterministic MNIST-shaped synthetic digits: (n, 28, 28, 1) float32
    images (NHWC, as the JAX package's) and (n,) int32 labels of 10
    classes, both split=0."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    base = rng.standard_normal((10, 28, 28)).astype(np.float32)
    imgs = base[labels] + 0.3 * rng.standard_normal((n, 28, 28)).astype(np.float32)
    return factories.array(imgs[..., None], split=0), factories.array(labels, split=0)
