"""Data-preparation helpers (counterpart of heat_tpu/utils/data/_utils.py):
a TFRecord index builder (the ``"<offset> <length>"`` lines NVIDIA DALI
reads) and a TFRecord-to-HDF5 merger whose files
:class:`~.partial_dataset.PartialH5Dataset` streams.  Plain Python on
files; the index files are written atomically with a CRC32 sidecar."""

from __future__ import annotations

import os
import struct
from typing import List

import numpy as np

__all__ = ["dali_tfrecord2idx", "merge_files_imagenet_tfrecord", "tfrecord_index"]


def tfrecord_index(path: str) -> List[tuple]:
    """``[(offset, length), ...]`` of every record of a TFRecord file: a
    record is a little-endian u64 payload length, a u32 CRC of it, the
    payload and a u32 CRC of the payload."""
    spans = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            start = f.tell()
            header = f.read(8)
            if len(header) < 8:
                break
            (payload_len,) = struct.unpack("<Q", header)
            f.seek(4 + payload_len + 4, os.SEEK_CUR)
            if f.tell() > size:
                raise ValueError(f"{path}: truncated TFRecord at offset {start}")
            spans.append((start, f.tell() - start))
    return spans


def dali_tfrecord2idx(train_dir, train_idx_dir, val_dir, val_idx_dir) -> None:
    """Write ``<name>`` index files into ``train_idx_dir`` and ``val_idx_dir``
    for every TFRecord file of ``train_dir`` and ``val_dir`` (heat's
    _utils.py:13), one ``"<offset> <length>"`` line a record."""
    from ...core.io import _atomic_out

    for src_dir, idx_dir in ((train_dir, train_idx_dir), (val_dir, val_idx_dir)):
        os.makedirs(idx_dir, exist_ok=True)
        for name in sorted(os.listdir(src_dir)):
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src):
                continue
            with _atomic_out(os.path.join(idx_dir, name)) as tmp:
                with open(tmp, "w") as idx:
                    for offset, length in tfrecord_index(src):
                        idx.write(f"{offset} {length}\n")


def merge_files_imagenet_tfrecord(folder_name, output_folder=None) -> None:
    """Merge the ``train*`` and ``val*`` TFRecord files of ``folder_name``
    into ``imagenet_merged.h5`` and ``imagenet_merged_validation.h5``
    (heat's _utils.py:47): the raw payloads as one uint8 ``records`` vector
    and an ``index`` table of (offset, length) rows."""
    import h5py

    output_folder = output_folder or "."
    names = sorted(os.listdir(folder_name))
    splits = {
        "imagenet_merged.h5": [n for n in names if n.startswith("train")],
        "imagenet_merged_validation.h5": [n for n in names if n.startswith("val")],
    }
    for out_name, files in splits.items():
        if not files:
            continue
        payloads = []
        for name in files:
            src = os.path.join(folder_name, name)
            with open(src, "rb") as f:
                data = f.read()
            for offset, length in tfrecord_index(src):
                payloads.append(np.frombuffer(data, np.uint8, count=length, offset=offset))
        table = np.zeros((len(payloads), 2), np.int64)
        pos = 0
        for i, p in enumerate(payloads):
            table[i] = (pos, len(p))
            pos += len(p)
        with h5py.File(os.path.join(output_folder, out_name), "w") as f:
            f.create_dataset("records", data=np.concatenate(payloads) if payloads else np.zeros(0, np.uint8))
            f.create_dataset("index", data=table)
