"""Data tooling (counterpart of heat_tpu/utils/data): datasets and loaders,
the card's prefetcher, windowed HDF5 streaming, test matrices, MNIST-shaped
digits and clustered data."""

from . import matrixgallery, spherical
from .datatools import DataLoader, Dataset, dataset_irecv, dataset_ishuffle, dataset_shuffle
from .mnist import MNISTDataset, synthetic_mnist
from .partial_dataset import PartialH5DataLoaderIter, PartialH5Dataset
from .prefetch import prefetch_to_device, sharding_for_batch
from .spherical import create_clusters, create_spherical_dataset

__all__ = [
    "DataLoader",
    "Dataset",
    "MNISTDataset",
    "PartialH5DataLoaderIter",
    "PartialH5Dataset",
    "create_clusters",
    "create_spherical_dataset",
    "dataset_irecv",
    "dataset_ishuffle",
    "dataset_shuffle",
    "matrixgallery",
    "prefetch_to_device",
    "sharding_for_batch",
    "spherical",
    "synthetic_mnist",
]
