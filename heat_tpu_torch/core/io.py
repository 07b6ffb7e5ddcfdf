"""Parallel I/O (counterpart of heat_tpu/core/io.py).

Reads: each rank reads its own rows of an array split along an axis (an
HDF5 hyperslab, a memory-mapped .npy file, its share of a directory of .npy
shards, its own lines of a CSV file); an unsplit array is read whole on
every rank.  Writes: to HDF5 and .npy files the ranks' slabs go in rank
order, one rank at a time, each writing its own rows (no rank holds the
whole array); a directory of .npy shards gets one file per rank, written
in parallel.  The CSV, text, archive and netCDF writers write the gathered
array from rank 0, as the reference's do (``data.numpy()``).

Every file is written atomically: into a temporary file beside it, fsynced,
its CRC32 written to the sidecar ``<path>.crc32`` (8 hex digits and a
newline) and renamed into place.  Every loader verifies a sidecar where
there is one (rank 0 reads the file's bytes; all ranks raise
:class:`ChecksumError` on a mismatch).  ``HEAT_TPU_IO_CHECKSUM=0`` turns
both off.  The bytes written are the reference's, so a file written by
either package loads in the other.
"""

from __future__ import annotations

import contextlib
import csv as _csv
import os
import shutil
import uuid
import zlib
from typing import List, Optional

import numpy as np
import torch

from ..parallel.comm import sanitize_comm
from . import types
from .devices import sanitize_device
from .dndarray import DNDarray, _pad_along
from .stride_tricks import sanitize_axis

__all__ = [
    "DataSource",
    "fromfile",
    "fromregex",
    "genfromtxt",
    "load",
    "load_csv",
    "load_hdf5",
    "load_npy_from_path",
    "loadtxt",
    "memmap",
    "open_memmap",
    "save",
    "save_csv",
    "save_hdf5",
    "save_npy_from_path",
    "savetxt",
    "savez",
    "savez_compressed",
    "supports_hdf5",
    "tofile",
    "supports_netcdf",
    "supports_pandas",
]

try:
    import h5py

    __HDF5 = True
except ImportError:  # pragma: no cover
    __HDF5 = False

try:
    import netCDF4

    __NETCDF = True
    __NETCDF_BACKEND = "netcdf4"
except ImportError:
    netCDF4 = None
    try:
        # scipy's NetCDF3 reader and writer: the classic format's limits
        # (only the first dimension unlimited, no groups), as the reference
        from scipy.io import netcdf_file as _scipy_netcdf

        __NETCDF = True
        __NETCDF_BACKEND = "scipy"
    except ImportError:  # pragma: no cover
        __NETCDF = False
        __NETCDF_BACKEND = None

try:
    import pandas  # noqa: F401

    __PANDAS = True
except ImportError:  # pragma: no cover
    __PANDAS = False


# ----------------------------------------------------------------------
# atomic writes with a CRC32 sidecar (the reference's resilience/atomic.py)
# ----------------------------------------------------------------------
_CHUNK = 1 << 20
SIDECAR_SUFFIX = ".crc32"


class ChecksumError(OSError):
    """A file's bytes disagree with its CRC32 sidecar."""

    def __init__(self, path: str, expected: int, actual: int):
        super().__init__(f"checksum mismatch for {path!r}: sidecar records crc32 {expected:#010x} but the file "
                         f"hashes to {actual:#010x}; the file is torn or corrupted")
        self.path, self.expected, self.actual = path, expected, actual


def _checksums_enabled() -> bool:
    return os.environ.get("HEAT_TPU_IO_CHECKSUM", "1") != "0"


def checksum_path(path: str) -> str:
    """The sidecar path holding ``path``'s CRC32."""
    return path + SIDECAR_SUFFIX


def crc32_file(path: str) -> int:
    """The CRC32 of a file's bytes, read in blocks of 1 MiB."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # makes the rename durable; a filesystem that refuses to sync a
    # directory loses durability, not atomicity
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def write_checksum(path: str, crc: Optional[int] = None) -> int:
    """Write (atomically) the CRC32 sidecar of ``path``; returns the crc."""
    if crc is None:
        crc = crc32_file(path)
    side = checksum_path(path)
    tmp = f"{side}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        f.write(f"{crc:08x}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, side)
    return crc


def read_checksum(path: str) -> Optional[int]:
    """The CRC32 the sidecar of ``path`` records, or None without one."""
    side = checksum_path(path)
    if not os.path.exists(side):
        return None
    with open(side) as f:
        return int(f.read().strip(), 16)


def verify_checksum(path: str) -> Optional[bool]:
    """True where ``path`` matches its sidecar, None without a sidecar;
    raises :class:`ChecksumError` on a mismatch."""
    expected = read_checksum(path)
    if expected is None:
        return None
    actual = crc32_file(path)
    if actual != expected:
        raise ChecksumError(path, expected, actual)
    return True


def _temp_name(path: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(path)),
                        f".{os.path.basename(path)}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")


def _commit(tmp: str, path: str) -> None:
    """Fsync ``tmp``, write its sidecar and rename it over ``path``."""
    _fsync_path(tmp)
    crc = crc32_file(tmp) if _checksums_enabled() else None
    os.replace(tmp, path)
    if crc is not None:
        write_checksum(path, crc)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


@contextlib.contextmanager
def _atomic_out(path: str, preserve_existing: bool = False):
    """A temporary path beside ``path`` to write, committed on a clean exit
    and removed on any failure (the destination stays untouched).
    ``preserve_existing`` starts the temporary file as a copy of the
    current one (the append and update modes)."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = _temp_name(path)
    try:
        if preserve_existing and os.path.exists(path):
            shutil.copyfile(path, tmp)
        yield tmp
        if not os.path.exists(tmp):
            raise FileNotFoundError(f"the write of {path!r} did not create its temporary file")
        _commit(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


# ----------------------------------------------------------------------
# ranks working in turn
# ----------------------------------------------------------------------
def _agree(comm, device, flag: int) -> int:
    """The sum of every rank's ``flag`` (one all-reduce; the flag itself in
    a world of one)."""
    if comm.size == 1:
        return flag
    t = torch.tensor([flag], dtype=torch.int64, device=sanitize_device(device).torch_device)
    return int(comm.psum(t)[0])


def _checked_read(path: str, comm, device) -> None:
    """Verify ``path`` against its sidecar: rank 0 reads the bytes, and every
    rank raises :class:`ChecksumError` on a mismatch."""
    if not _checksums_enabled():
        return
    err = None
    if comm.rank == 0:
        try:
            verify_checksum(path)
        except ChecksumError as e:
            err = e
    if _agree(comm, device, int(err is not None)):
        raise err if err is not None else ChecksumError(path, read_checksum(path) or 0, 0)


def _shared_temp(path: str, comm, device) -> str:
    """One temporary name beside ``path`` for all ranks (rank 0's, sent by
    one broadcast)."""
    name = _temp_name(path).encode()
    if comm.size == 1:
        return name.decode()
    buf = torch.zeros(512, dtype=torch.uint8, device=sanitize_device(device).torch_device)
    if comm.rank == 0:
        buf[:len(name)] = torch.frombuffer(bytearray(name), dtype=torch.uint8)
    comm.bcast(buf, 0)
    return bytes(buf.cpu().numpy()).rstrip(b"\0").decode()


def _in_turns(comm, device, write) -> None:
    """``write()`` on each rank in rank order, one rank at a time."""
    for turn in range(comm.size):
        if comm.rank == turn:
            write()
        _agree(comm, device, 0)


def _own_slices(data: DNDarray):
    """``(global slices, this rank's true rows)`` of ``data``; None where
    the rank has nothing to write (an unsplit array is rank 0's)."""
    if data.split is None:
        if data.comm.rank:
            return None
        return tuple(slice(0, s) for s in data.shape), data.larray
    _, lshape, slices = data.comm.chunk(data.shape, data.split)
    if lshape[data.split] == 0:
        return None
    return slices, data.larray


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    """A local tensor of heat type ``dtype`` as numpy."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return types._from_holding(t.detach().cpu().numpy(), dtype)


def _from_rows(rows: np.ndarray, gshape, split, dtype, device, comm) -> DNDarray:
    """A DNDarray from this rank's rows ``rows`` (the whole array when
    ``split`` is None) of an array of ``gshape``."""
    device = sanitize_device(device)
    host = np.ascontiguousarray(types._to_holding(np.asarray(rows), dtype)).reshape(rows.shape)
    t = torch.from_numpy(host.copy() if not host.flags.writeable else host).to(device.torch_device)
    if split is not None:
        t = _pad_along(t, split, comm.padded_extent(gshape[split]) // comm.size).contiguous()
    return DNDarray(t, tuple(int(s) for s in gshape), dtype, split, device, comm)


def _np_type(dtype) -> np.dtype:
    return np.dtype(types.numpy_type(types.canonical_heat_type(dtype)))


def supports_hdf5() -> bool:
    """Whether HDF5 io is available (h5py)."""
    return __HDF5


def supports_netcdf() -> bool:
    """Whether netCDF io is available (netCDF4, or scipy's NetCDF3)."""
    return __NETCDF


def supports_pandas() -> bool:
    """Whether pandas is available."""
    return __PANDAS


if __NETCDF:
    __all__.extend(["load_netcdf", "save_netcdf"])


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by file extension (.h5/.hdf5, .nc/.nc4/.netcdf, .csv, .npy (a
    file, or a directory of shards), .npz, .txt/.dat)."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".h5", ".hdf5"):
        return load_hdf5(path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        if not __NETCDF:
            raise RuntimeError("netCDF4 is not available; install netCDF4 to load netCDF files")
        return load_netcdf(path, *args, **kwargs)
    if ext == ".csv":
        return load_csv(path, *args, **kwargs)
    if ext == ".npy":
        return load_npy_from_path(path, *args, **kwargs) if os.path.isdir(path) else \
            _load_npy_file(path, *args, **kwargs)
    if ext == ".npz":
        return _load_npz_file(path, *args, **kwargs)
    if ext in (".txt", ".dat"):
        return loadtxt(path, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by file extension (as :func:`load` reads them)."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".h5", ".hdf5"):
        return save_hdf5(data, path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        if not __NETCDF:
            raise RuntimeError("netCDF4 is not available; install netCDF4 to save netCDF files")
        return save_netcdf(data, path, *args, **kwargs)
    if ext == ".csv":
        return save_csv(data, path, *args, **kwargs)
    if ext == ".npy":
        return _save_npy_file(data, path)
    if ext == ".npz":
        return savez(path, data, *args, **kwargs)
    if ext in (".txt", ".dat"):
        return savetxt(path, data, *args, **kwargs)
    raise ValueError(f"Unsupported file extension {ext}")


# ----------------------------------------------------------------------
# HDF5
# ----------------------------------------------------------------------
def load_hdf5(path: str, dataset: str, dtype=types.float32, load_fraction: float = 1.0, split: Optional[int] = None,
              device=None, comm=None) -> DNDarray:
    """An HDF5 dataset, each rank reading the hyperslab of its own rows
    (the whole dataset where ``split`` is None); ``load_fraction`` keeps the
    first part of the split axis."""
    if not __HDF5:
        raise RuntimeError("h5py is not available")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be str, not {type(dataset)}")
    if not isinstance(load_fraction, float) or not (0.0 < load_fraction <= 1.0):
        raise ValueError("load_fraction must be a float in (0., 1.]")
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    dtype = types.canonical_heat_type(dtype)
    with h5py.File(path, "r") as handle:
        data = handle[dataset]
        gshape = tuple(data.shape)
        if load_fraction < 1.0 and split is not None:
            gshape = tuple(int(s * load_fraction) if d == split else s for d, s in enumerate(gshape))
        split = sanitize_axis(gshape, split)
        rows = np.asarray(data[comm.chunk(gshape, split)[2]], dtype=_np_type(dtype))
    return _from_rows(rows, gshape, split, dtype, device, comm)


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
    """Write a DNDarray to an HDF5 dataset of its global shape: rank 0
    creates it in a temporary file, then each rank in turn writes its own
    rows as a hyperslab, and rank 0 commits the file (``mode='a'`` starts
    from a copy of the existing file)."""
    if not __HDF5:
        raise RuntimeError("h5py is not available")
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    comm = data.comm
    np_dtype = _np_type(data.dtype)
    tmp = _shared_temp(path, comm, data.device)
    if comm.rank == 0:
        try:
            if mode not in ("w", "w-", "x") and os.path.exists(path):
                shutil.copyfile(path, tmp)
            with h5py.File(tmp, mode) as handle:
                handle.create_dataset(dataset, shape=data.shape, dtype=np_dtype, **kwargs)
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
    _agree(comm, data.device, 0)

    def write():
        own = _own_slices(data)
        if own is not None:
            with h5py.File(tmp, "a") as handle:
                handle[dataset][own[0]] = _host(own[1], data.dtype)

    _in_turns(comm, data.device, write)
    if comm.rank == 0:
        _commit(tmp, path)
    _agree(comm, data.device, 0)


# ----------------------------------------------------------------------
# netCDF
# ----------------------------------------------------------------------
if __NETCDF:

    def load_netcdf(path, variable, dtype=types.float32, split=None, device=None, comm=None, **kwargs):
        """A netCDF variable (netCDF4, or scipy's NetCDF3 reader), each rank
        keeping its own rows."""
        if not isinstance(path, str):
            raise TypeError(f"path must be str, not {type(path)}")
        if not isinstance(variable, str):
            raise TypeError(f"variable must be str, not {type(variable)}")
        comm = sanitize_comm(comm)
        _checked_read(path, comm, device)
        dtype = types.canonical_heat_type(dtype)
        if __NETCDF_BACKEND == "netcdf4":
            with netCDF4.Dataset(path, "r") as handle:
                var = handle[variable]
                gshape = tuple(var.shape)
                split = sanitize_axis(gshape, split)
                rows = np.asarray(var[comm.chunk(gshape, split)[2]], dtype=_np_type(dtype))
        else:
            with _scipy_netcdf(path, "r", mmap=False) as handle:
                if variable not in handle.variables:
                    raise ValueError(f"variable {variable!r} not found in {path}")
                var = handle.variables[variable]
                gshape = tuple(var.shape)
                split = sanitize_axis(gshape, split)
                rows = np.array(var[comm.chunk(gshape, split)[2]], dtype=_np_type(dtype))
        return _from_rows(rows, gshape, split, dtype, device, comm)

    def _nc_dim_names(data, dimension_names, variable):
        if dimension_names is None:
            # per-variable default names: a second variable appended to the
            # file must not bind to the first one's dimension sizes
            return [f"{variable}_dim_{i}" for i in range(max(data.ndim, 1))]
        if isinstance(dimension_names, str):
            dimension_names = [dimension_names]
        if not isinstance(dimension_names, (list, tuple)):
            raise TypeError(f"dimension_names must be list, tuple or str, not {type(dimension_names)}")
        if len(dimension_names) != data.ndim:
            raise ValueError(f"{len(dimension_names)} dimension names for a {data.ndim}-d array")
        return list(dimension_names)

    def save_netcdf(data, path, variable, mode: str = "w", dimension_names=None, is_unlimited: bool = False,
                    file_slices=slice(None), **kwargs):
        """A netCDF write from rank 0 of the gathered array (netCDF4, or
        scipy's classic-format writer, which rewrites the whole file), with
        the reference's ``mode`` ('w', 'a', 'r+'), ``dimension_names``,
        ``is_unlimited`` and ``file_slices``."""
        if not isinstance(data, DNDarray):
            raise TypeError(f"data must be a DNDarray, not {type(data)}")
        if not isinstance(path, str):
            raise TypeError(f"path must be str, not {type(path)}")
        if not isinstance(variable, str):
            raise TypeError(f"variable must be str, not {type(variable)}")
        if mode not in ("w", "a", "r+"):
            raise ValueError(f"mode must be 'w', 'a' or 'r+', got {mode!r}")
        dims = _nc_dim_names(data, dimension_names, variable)
        values = data.numpy()
        if values.ndim == 0:
            values = values.reshape(1)  # the classic model has no scalars
        if data.comm.rank != 0:
            return
        preserve = mode in ("a", "r+")
        if __NETCDF_BACKEND == "netcdf4":
            with _atomic_out(path, preserve_existing=preserve) as tmp:
                with netCDF4.Dataset(tmp, mode) as handle:
                    if variable in handle.variables:
                        handle.variables[variable][file_slices] = values
                    else:
                        for name, s in zip(dims, values.shape):
                            if name not in handle.dimensions:
                                handle.createDimension(name, None if is_unlimited else s)
                        var = handle.createVariable(variable, values.dtype, tuple(dims))
                        var[file_slices] = values
            return
        with _atomic_out(path, preserve_existing=preserve) as tmp:
            with _scipy_netcdf(tmp, "a" if mode == "r+" else mode) as handle:
                if variable in handle.variables:
                    handle.variables[variable][file_slices] = values
                else:
                    for i, (name, s) in enumerate(zip(dims, values.shape)):
                        if name not in handle.dimensions:
                            handle.createDimension(name, None if (is_unlimited and i == 0) else s)
                    var = handle.createVariable(variable, values.dtype, tuple(dims))
                    var[file_slices] = values


# ----------------------------------------------------------------------
# CSV
# ----------------------------------------------------------------------
def load_csv(path: str, header_lines: int = 0, sep: str = ",", dtype=types.float32, encoding: str = "utf-8",
             split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A CSV file of numbers, each field parsed by the numpy type's
    constructor; split along axis 0 each rank parses only its own lines."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(sep, str):
        raise TypeError(f"separator must be str, not {type(sep)}")
    if not isinstance(header_lines, int):
        raise TypeError(f"header_lines must be int, not {type(header_lines)}")
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    dtype = types.canonical_heat_type(dtype)
    np_dtype = _np_type(dtype)
    with open(path, "r", encoding=encoding, newline="") as f:
        lines = [row for i, row in enumerate(_csv.reader(f, delimiter=sep)) if i >= header_lines and row]
    ncols = len(lines[0]) if lines else 0
    gshape = (len(lines), ncols) if lines else (0,)
    split = sanitize_axis(gshape, split)
    if split == 0:
        lo, lshape, _ = comm.chunk(gshape, 0)
        lines = lines[lo:lo + lshape[0]]
    rows = np.asarray([[np_dtype.type(x) for x in row] for row in lines], dtype=np_dtype)
    if not lines:
        rows = rows.reshape((0, ncols) if gshape != (0,) else (0,))
    if split == 1:
        rows = rows[comm.chunk(gshape, 1)[2]]
    return _from_rows(rows, gshape, split, dtype, device, comm)


def save_csv(data: DNDarray, path: str, header_lines: Optional[List[str]] = None, sep: str = ",",
             decimals: int = -1, encoding: str = "utf-8", **kwargs) -> None:
    """Write a 1-D or 2-D DNDarray as CSV from rank 0 (the gathered array),
    each row's values as python numbers (``row.tolist()``), or rounded to
    ``decimals``."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if data.ndim > 2:
        raise ValueError("CSV can only store 1-D or 2-D arrays")
    arr = data.numpy()
    if arr.ndim == 1:
        arr = arr[:, None]
    if data.comm.rank == 0:
        with _atomic_out(path) as tmp:
            with open(tmp, "w", encoding=encoding, newline="") as f:
                if header_lines:
                    for line in header_lines:
                        f.write(line if line.endswith("\n") else line + "\n")
                writer = _csv.writer(f, delimiter=sep)
                for row in arr:
                    if decimals >= 0:
                        writer.writerow([round(float(x), decimals) for x in row])
                    else:
                        writer.writerow(row.tolist())


# ----------------------------------------------------------------------
# .npy files and directories of shards
# ----------------------------------------------------------------------
def _load_npy_file(path: str, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """A .npy file, memory-mapped: each rank reads its own rows."""
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    mm = np.load(path, mmap_mode="r")
    gshape = tuple(mm.shape)
    split = sanitize_axis(gshape, split)
    heat = types.canonical_heat_type(mm.dtype if dtype is None else dtype)
    rows = np.array(mm[comm.chunk(gshape, split)[2]])
    del mm
    return _from_rows(rows.astype(_np_type(heat)), gshape, split, heat, device, comm)


def load_npy_from_path(path: str, dtype=types.int32, split: int = 0, device=None, comm=None) -> DNDarray:
    """A directory of .npy shards (in file-name order) as one array joined
    along ``split``: each rank reads, memory-mapped, only the parts of the
    shards that hold its rows; every shard read is verified.  Unsplit: the
    first shard."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(split, int) and split is not None:
        raise TypeError(f"split must be an integer or None, not {type(split)}")
    comm = sanitize_comm(comm)
    files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not files:
        raise ValueError(f"no .npy files found in {path}")
    shards = [os.path.join(path, f) for f in files]
    dtype = types.canonical_heat_type(dtype)
    if split is None:
        _checked_read(shards[0], comm, device)
        data = np.load(shards[0]).astype(_np_type(dtype))
        return _from_rows(data, data.shape, None, dtype, device, comm)
    maps = [np.load(s, mmap_mode="r") for s in shards]
    extents = [m.shape[split] for m in maps]
    gshape = list(maps[0].shape)
    gshape[split] = int(np.sum(extents))
    split = sanitize_axis(gshape, split)
    lo, lshape, _ = comm.chunk(gshape, split)
    hi = lo + lshape[split]
    starts = np.concatenate([[0], np.cumsum(extents)])
    parts, bad = [], None
    for s, m, a, b in zip(shards, maps, starts[:-1], starts[1:]):
        if b <= lo or a >= hi or (a == b and lshape[split] == 0):
            continue
        if _checksums_enabled():
            try:
                verify_checksum(s)
            except ChecksumError as e:
                bad = e
        key = [slice(None)] * len(gshape)
        key[split] = slice(max(lo, a) - a, min(hi, b) - a)
        parts.append(np.array(m[tuple(key)]))
    del maps
    if _agree(comm, device, int(bad is not None)):
        raise bad if bad is not None else ChecksumError(path, 0, 0)
    rows = np.concatenate(parts, axis=split) if parts else np.zeros(tuple(lshape), dtype=_np_type(dtype))
    return _from_rows(rows.astype(_np_type(dtype)), tuple(gshape), split, dtype, device, comm)


def save_npy_from_path(data: DNDarray, path: str) -> None:
    """Write a DNDarray as a directory of .npy shards, one per rank's rows,
    ``part_<offset>.npy`` (offsets zero-padded to 12 digits, so that the
    file names sort in offset order), each written atomically with its
    sidecar, all ranks at once."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    os.makedirs(path, exist_ok=True)
    own = _own_slices(data)
    if own is None:
        return
    start = own[0][data.split].start if data.split is not None else 0
    with _atomic_out(os.path.join(path, f"part_{start:012d}.npy")) as tmp:
        with open(tmp, "wb") as f:
            np.save(f, _host(own[1], data.dtype))


def _save_npy_file(data: DNDarray, path: str) -> None:
    """``np.save``'s file of the array: rank 0 writes the header, then each
    rank in turn writes its own rows into the memory-mapped file, and rank 0
    commits it."""
    if not isinstance(data, DNDarray):
        arr = np.asarray(data)
        with _atomic_out(path) as tmp:
            with open(tmp, "wb") as f:
                np.save(f, arr)
        return
    comm = data.comm
    tmp = _shared_temp(path, comm, data.device)
    np_dtype = _np_type(data.dtype)
    if comm.rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.lib.format.open_memmap(tmp, mode="w+", dtype=np_dtype, shape=data.shape).flush()
    _agree(comm, data.device, 0)

    def write():
        own = _own_slices(data)
        if own is not None and data.size:
            mm = np.lib.format.open_memmap(tmp, mode="r+")
            mm[own[0]] = _host(own[1], data.dtype)
            mm.flush()
            del mm

    _in_turns(comm, data.device, write)
    if comm.rank == 0:
        _commit(tmp, path)
    _agree(comm, data.device, 0)


# ----------------------------------------------------------------------
# numpy's text, binary and archive formats (parsed whole on each rank,
# written from rank 0)
# ----------------------------------------------------------------------
def _array(arr, dtype, split, device, comm) -> DNDarray:
    from . import factories

    return factories.array(arr, dtype=dtype, split=split, device=device, comm=comm)


def loadtxt(path: str, dtype=types.float32, comments: str = "#", delimiter=None, skiprows: int = 0, usecols=None,
            split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """``np.loadtxt``; each rank keeps its own rows."""
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    arr = np.loadtxt(path, dtype=_np_type(dtype), comments=comments, delimiter=delimiter, skiprows=skiprows,
                     usecols=usecols)
    return _array(arr, dtype, split, device, comm)


def savetxt(path: str, x: DNDarray, fmt: str = "%.18e", delimiter: str = " ", newline: str = "\n", header: str = "",
            footer: str = "", comments: str = "# ") -> None:
    """``np.savetxt`` of the gathered array, from rank 0."""
    arr = x.numpy()
    if x.comm.rank == 0:
        with _atomic_out(path) as tmp:
            np.savetxt(tmp, arr, fmt=fmt, delimiter=delimiter, newline=newline, header=header, footer=footer,
                       comments=comments)


def genfromtxt(path: str, dtype=types.float32, comments: str = "#", delimiter=None, skip_header: int = 0,
               filling_values=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """``np.genfromtxt`` (missing values filled, NaN by default)."""
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    arr = np.genfromtxt(path, dtype=_np_type(dtype), comments=comments, delimiter=delimiter,
                        skip_header=skip_header, filling_values=filling_values)
    return _array(arr, dtype, split, device, comm)


def _npz_path(path: str) -> str:
    # np.savez appends .npz to a bare path, not to a file object
    return path if path.endswith(".npz") else path + ".npz"


def _archive(writer, path: str, args, kwargs) -> None:
    arrays = [a.numpy() if isinstance(a, DNDarray) else a for a in args]
    named = {k: (v.numpy() if isinstance(v, DNDarray) else v) for k, v in kwargs.items()}
    ref = next((a for a in list(args) + list(kwargs.values()) if isinstance(a, DNDarray)), None)
    if ref is None or ref.comm.rank == 0:
        with _atomic_out(_npz_path(path)) as tmp:
            with open(tmp, "wb") as f:
                writer(f, *arrays, **named)


def savez(path: str, *args, **kwargs) -> None:
    """``np.savez`` of the gathered arrays, from rank 0."""
    _archive(np.savez, path, args, kwargs)


def savez_compressed(path: str, *args, **kwargs) -> None:
    """``np.savez_compressed`` of the gathered arrays, from rank 0."""
    _archive(np.savez_compressed, path, args, kwargs)


def fromfile(path: str, dtype=types.float32, count: int = -1, sep: str = "", offset: int = 0,
             split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """``np.fromfile`` (binary or text)."""
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    arr = np.fromfile(path, dtype=_np_type(dtype), count=count, sep=sep, offset=offset)
    return _array(arr, dtype, split, device, comm)


def tofile(x: DNDarray, path: str, sep: str = "", format: str = "%s") -> None:
    """``ndarray.tofile`` of the gathered array (raw or text), from rank 0."""
    arr = x.numpy()
    if x.comm.rank == 0:
        with _atomic_out(path) as tmp:
            arr.tofile(tmp, sep=sep, format=format)


def fromregex(path: str, regexp, dtype, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """``np.fromregex``; a structured result becomes a plain array (its one
    field, or its fields as columns)."""
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    arr = np.fromregex(path, regexp, dtype)
    if arr.dtype.names is not None:
        if len(arr.dtype.names) == 1:
            arr = arr[arr.dtype.names[0]]
        else:
            from numpy.lib import recfunctions

            arr = recfunctions.structured_to_unstructured(arr)
    return _array(np.asarray(arr), None, split, device, comm)


def memmap(path: str, dtype=types.float32, mode: str = "r", offset: int = 0, shape=None,
           split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A raw file, memory-mapped: each rank copies its own rows."""
    comm = sanitize_comm(comm)
    if mode in ("r", "r+", "c"):
        _checked_read(path, comm, device)
    mm = np.memmap(path, dtype=_np_type(dtype), mode=mode, offset=offset, shape=shape)
    return _array(mm, dtype, split, device, comm)


# numpy's .npy/.npz format helpers: host-side file layout, numpy's own
format = np.lib.format


def open_memmap(path: str, mode: str = "r", dtype=None, shape=None, split: Optional[int] = None, device=None,
                comm=None) -> DNDarray:
    """A .npy file through ``np.lib.format.open_memmap``: each rank copies
    its own rows."""
    comm = sanitize_comm(comm)
    if mode in ("r", "r+", "c"):
        _checked_read(path, comm, device)
    mm = np.lib.format.open_memmap(path, mode=mode, dtype=None if dtype is None else _np_type(dtype), shape=shape)
    return _array(mm, None, split, device, comm)


class DataSource:
    """``np.lib.npyio.DataSource``: host-side path resolution."""

    def __init__(self, destpath="."):
        self._ds = np.lib.npyio.DataSource(destpath)

    def exists(self, path) -> bool:
        return self._ds.exists(path)

    def abspath(self, path) -> str:
        return self._ds.abspath(path)

    def open(self, path, mode="r", encoding=None, newline=None):
        return self._ds.open(path, mode=mode, encoding=encoding, newline=newline)


def _load_npz_file(path: str, name: Optional[str] = None, split: Optional[int] = None, device=None,
                   comm=None) -> DNDarray:
    """One array of a .npz archive (its first unless ``name``)."""
    comm = sanitize_comm(comm)
    _checked_read(path, comm, device)
    with np.load(path) as z:
        arr = z[name if name is not None else z.files[0]]
    return _array(arr, None, split, device, comm)
