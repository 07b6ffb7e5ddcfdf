"""Atomic file writes with CRC32 sidecar checksums (counterpart of
heat_tpu/resilience/atomic.py).

Every writer in the port's io funnels through
:func:`atomic_write`: the payload is written to a temp file in the
destination directory, fsynced, checksummed, and renamed over the final
path — so a reader can observe the old complete file or the new
complete file, never a torn intermediate.  A ``<path>.crc32`` sidecar
records the payload checksum; :func:`verify_checksum` (called by every
loader) streams the file and raises :class:`ChecksumError` on mismatch,
so silent corruption fails loudly instead of returning garbage.

Files without a sidecar (written by other tools) verify as "unknown"
and load normally — checksums harden our own writes without locking the
loaders onto them.  The sidecar format (8 hex digits and a newline) is
the reference's: a file written by either package verifies in the other.
"""

from __future__ import annotations

import contextlib
import os
import uuid
import zlib
from typing import Optional

from .errors import ChecksumError
from .faults import inject

__all__ = [
    "atomic_write",
    "checksum_path",
    "crc32_file",
    "read_checksum",
    "verify_checksum",
    "write_checksum",
]

_CHUNK = 1 << 20  # 1 MiB read blocks: bounded memory on multi-GB files

SIDECAR_SUFFIX = ".crc32"


def checksum_path(path: str) -> str:
    """Sidecar path holding ``path``'s CRC32 (``<path>.crc32``)."""
    return path + SIDECAR_SUFFIX


def crc32_file(path: str) -> int:
    """Streaming CRC32 of a file's bytes."""
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
    # directory fsync makes the rename itself durable; some filesystems
    # refuse O_RDONLY fsync on directories — a failed dir sync degrades
    # durability, not atomicity, so it is best-effort
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
    """Write (atomically) the CRC32 sidecar for ``path``; returns the crc."""
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
    """The sidecar-recorded CRC32 of ``path``, or None if no sidecar."""
    side = checksum_path(path)
    if not os.path.exists(side):
        return None
    with open(side) as f:
        return int(f.read().strip(), 16)


def verify_checksum(path: str, required: bool = False) -> Optional[bool]:
    """Verify ``path`` against its sidecar.

    Returns True (verified), None (no sidecar; ``required=False``), or
    raises :class:`ChecksumError` on mismatch / :class:`FileNotFoundError`
    when ``required`` and no sidecar exists."""
    expected = read_checksum(path)
    if expected is None:
        if required:
            raise FileNotFoundError(f"no checksum sidecar for {path!r}")
        return None
    actual = crc32_file(path)
    if actual != expected:
        raise ChecksumError(path, expected, actual)
    return True


@contextlib.contextmanager
def atomic_write(path: str, checksum: bool = True, fault_site: str = "io.write"):
    """Context manager yielding a temp path to write; commits on exit.

    The body writes the full payload to the yielded temp path (same
    directory, so the final ``os.replace`` is a same-filesystem atomic
    rename).  On clean exit the temp file is fsynced, its CRC32 sidecar
    written, and the rename performed; on ANY failure the temp file is
    removed and the destination is untouched — a torn write is never
    visible.  ``fault_site`` is evaluated before the commit so injected
    transient faults exercise the retry path with no partial state."""
    path = os.fspath(path)
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    tmp = os.path.join(
        dirname,
        f".{os.path.basename(path)}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}",
    )
    try:
        yield tmp
        inject(fault_site, path=path)
        if not os.path.exists(tmp):
            raise FileNotFoundError(
                f"atomic_write body did not create the temp file for {path!r}"
            )
        _fsync_path(tmp)
        crc = crc32_file(tmp) if checksum else None
        os.replace(tmp, path)
        if checksum:
            write_checksum(path, crc)
        _fsync_dir(dirname)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
