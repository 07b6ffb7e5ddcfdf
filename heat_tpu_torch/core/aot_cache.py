"""Persistent on-disk artifact cache: a replica starts without ``nvcc``
(counterpart of heat_tpu/core/aot_cache.py).

The reference's cold start is one XLA compile per dispatch key, and its
cache serializes the compiled executables.  The port's cold start is
``core/_build.py``'s ``nvcc`` build of every ``csrc/*.cu`` (seconds per
source, all sources at once); so this cache holds the built shared
libraries, and a fresh process (or a replica that has no CUDA toolkit at
all) loads them instead of building them.  ``_build`` consults it before
it starts ``nvcc`` and, where the cache may be written, saves each library
it built.

Design points, the reference's:

* **Keys** -- :func:`stable_key` renders a key (nested tuples of names,
  numbers and named callables) into a deterministic string; the artifact
  file name is its SHA-256.  ``_build``'s key is the source's name and the
  digest ``_build`` already computes from the source, the sources it
  includes, every header and the flags.  Keys holding callables without a
  stable qualified name (lambdas, locals) are refused (``aot.unkeyed``).
* **Atomic + checksummed** -- artifacts are written through
  :func:`~heat_tpu_torch.resilience.atomic.atomic_write` (temp file, fsync,
  CRC32 sidecar, rename), and every load verifies the sidecar and the
  payload's SHA-256 first: a torn or corrupt artifact is *dropped*
  (``aot.errors``) and the library is built again; it is never loaded.
* **Fingerprint** -- every artifact records :func:`fingerprint` (torch's
  and CUDA's versions, the card's name and compute capability, the nvcc
  flags, the framework version).  An artifact of another fingerprint is
  ignored (``aot.stale``) and the library is built.  Neither the
  fingerprint nor a load needs ``nvcc``.
* **Fail-open** -- a failed load falls back to the build, as the
  reference's falls back to a compile; a library that can neither be
  loaded nor built still raises (``_build``), with no CPU fallback.

Off by default.  Arm with ``HEAT_TPU_AOT_CACHE=<dir>`` (or
:func:`configure`); ``HEAT_TPU_AOT_SAVE=0`` makes an armed cache read-only.
The artifact format is the port's own: one JSON header line (format,
fingerprint, key, size, SHA-256, time), then the library's bytes; nothing
is unpickled.  The cache directory must still be trusted: a loaded
library runs native code.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Optional, Tuple

from ..analysis import tsan as _tsan
from ..resilience.atomic import atomic_write, verify_checksum
from ..resilience.faults import inject as _inject
from ..telemetry import metrics as _tm
from . import _env

__all__ = [
    "configure",
    "enabled",
    "fingerprint",
    "load",
    "save",
    "stable_key",
    "stats",
]

#: artifact format version -- bumped on any layout change so old caches
#: read as stale
FORMAT_VERSION = 1

ARTIFACT_SUFFIX = ".aotx"

_HITS_C = _tm.counter("aot.hits", "libraries loaded from the on-disk artifact cache")
_MISSES_C = _tm.counter("aot.misses", "armed artifact lookups that found no artifact")
_SAVES_C = _tm.counter("aot.saves", "built libraries written to the artifact cache")
_STALE_C = _tm.counter(
    "aot.stale", "artifacts ignored for a torch/CUDA/device/flags fingerprint mismatch"
)
_ERRORS_C = _tm.counter(
    "aot.errors", "artifacts dropped (torn, corrupt, foreign) or failed writes"
)
_UNKEYED_C = _tm.counter(
    "aot.unkeyed", "keys refused a stable persistent form (lambda/local callables)"
)

#: guards the module configuration (directory, save flag, fingerprint
#: memo): configure() runs on the main thread, loads from any thread that
#: builds a kernel's library
_LOCK = _tsan.register_lock("dispatch.aot")
_DIR: Optional[str] = None
_SAVE = True
_ENV_READ = False
_FP: Optional[str] = None


def fingerprint() -> str:
    """Compatibility fingerprint of this process's build substrate: torch's
    and CUDA's versions, the card's name and compute capability, the nvcc
    flags and the framework version.  An artifact written under another
    fingerprint is never loaded.  Needs no ``nvcc``; without a card the
    device reads ``?``, which matches no artifact written on one."""
    global _FP
    with _LOCK:
        _tsan.note_access("dispatch.aot.state")
        if _FP is not None:
            return _FP
    import torch

    from ..version import __version__
    from ._build import NVCC_FLAGS

    name, cc = "?", "?"
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        cc = "%d.%d" % torch.cuda.get_device_capability(0)
    fp = (
        f"torch={torch.__version__};cuda={torch.version.cuda};device={name};cc={cc};"
        f"nvcc_flags={' '.join(NVCC_FLAGS)};heat={__version__};fmt={FORMAT_VERSION}"
    )
    with _LOCK:
        _tsan.note_access("dispatch.aot.state")
        _FP = fp
        return _FP


def configure(directory: Optional[str], save: Optional[bool] = None) -> Optional[str]:
    """Arm (or, with ``None``, disarm) the cache at ``directory``; returns
    the previously configured directory.  ``save=False`` makes the cache
    read-only for this process."""
    global _DIR, _SAVE, _ENV_READ
    if directory is not None:
        directory = os.fspath(directory)
        os.makedirs(directory, exist_ok=True)
    with _LOCK:
        _tsan.note_access("dispatch.aot.state")
        prev, _DIR = _DIR, directory
        if save is not None:
            _SAVE = bool(save)
        _ENV_READ = True
    return prev


def _config() -> Tuple[Optional[str], bool]:
    """(directory, save) -- reading ``HEAT_TPU_AOT_CACHE`` /
    ``HEAT_TPU_AOT_SAVE`` on first use, so a replica arms the cache from
    its environment without any code change."""
    global _DIR, _SAVE, _ENV_READ
    with _LOCK:
        _tsan.note_access("dispatch.aot.state")
        if not _ENV_READ:
            _ENV_READ = True
            d = _env.env_str("HEAT_TPU_AOT_CACHE")
            if d:
                _DIR = d
                try:
                    os.makedirs(d, exist_ok=True)
                except OSError:
                    _DIR = None  # unwritable dir: stay disarmed
            _SAVE = _env.env_flag("HEAT_TPU_AOT_SAVE")
        return _DIR, _SAVE


def enabled() -> bool:
    """Whether the on-disk cache is armed for this process."""
    return _config()[0] is not None


def save_enabled() -> bool:
    """Whether this process may write artifacts (armed and not read-only)."""
    d, s = _config()
    return d is not None and s


# ----------------------------------------------------------------------
# stable key rendering
# ----------------------------------------------------------------------
def _stable_part(obj: Any, depth: int = 0) -> str:
    """Deterministic cross-process string form of one key element, or
    raise ``ValueError`` when none exists (anonymous callables)."""
    if depth > 8:
        raise ValueError("key nesting too deep for a stable form")
    if callable(obj) and not isinstance(obj, type):
        mod = getattr(obj, "__module__", None)
        qual = getattr(obj, "__qualname__", None) or getattr(obj, "__name__", None)
        if not mod or not qual or "<lambda>" in qual or "<locals>" in qual:
            raise ValueError(f"no stable name for callable {obj!r}")
        return f"fn:{mod}.{qual}"
    if isinstance(obj, (tuple, list, frozenset)):
        items = sorted(obj) if isinstance(obj, frozenset) else obj
        inner = ",".join(_stable_part(o, depth + 1) for o in items)
        return f"{type(obj).__name__}({inner})"
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return repr(obj)
    # dtypes, devices: their str is stable for a fixed torch version, which
    # the fingerprint pins
    return f"{type(obj).__name__}:{obj}"


def stable_key(key: Any) -> Optional[str]:
    """Deterministic string form of a key, or ``None`` when the key has no
    stable cross-process identity (anonymous callables)."""
    try:
        return _stable_part(key)
    except ValueError:
        _UNKEYED_C.inc()
        return None


def _artifact_path(directory: str, key_str: str) -> str:
    digest = hashlib.sha256(key_str.encode("utf-8")).hexdigest()
    return os.path.join(directory, digest + ARTIFACT_SUFFIX)


# ----------------------------------------------------------------------
# load / save
# ----------------------------------------------------------------------
def load(key: Any) -> Optional[bytes]:
    """The verified payload (a built library's bytes) stored under ``key``,
    or ``None`` on any miss (disarmed, unstable key, absent, corrupt, stale
    fingerprint).  A corrupt or foreign artifact is removed so the next
    save can heal it.  The ``aot.load`` fault site is evaluated before the
    read; its fault reaches the caller."""
    directory, _ = _config()
    if directory is None:
        return None
    key_str = stable_key(key)
    if key_str is None:
        return None
    path = _artifact_path(directory, key_str)
    if not os.path.exists(path):
        _MISSES_C.inc()
        return None
    _inject("aot.load", path=path)
    try:
        verify_checksum(path, required=True)
        with open(path, "rb") as f:
            blob = f.read()
        head, sep, payload = blob.partition(b"\n")
        if not sep:
            raise ValueError("no header line")
        doc = json.loads(head.decode("utf-8"))
        if not isinstance(doc, dict) or doc.get("format") != FORMAT_VERSION:
            _STALE_C.inc()
            return None
        if doc.get("fingerprint") != fingerprint():
            _STALE_C.inc()
            return None
        if doc.get("key") != key_str:
            raise ValueError("artifact of another key")  # a SHA collision or a foreign file
        if len(payload) != doc.get("size") or hashlib.sha256(payload).hexdigest() != doc.get("sha256"):
            raise ValueError("payload does not match its header")
    except Exception:  # torn, corrupt, foreign: it costs a build, never a wrong library
        _ERRORS_C.inc()
        _drop(path)
        return None
    _HITS_C.inc()
    return payload


def save(key: Any, payload: bytes) -> bool:
    """Write ``payload`` (a built library's bytes) under ``key``; True when
    an artifact was written.  Never raises: a failed save is counted and
    the library in the build directory keeps serving."""
    directory, do_save = _config()
    if directory is None or not do_save:
        return False
    key_str = stable_key(key)
    if key_str is None:
        return False
    try:
        payload = bytes(payload)
        doc = {
            "format": FORMAT_VERSION,
            "fingerprint": fingerprint(),
            "key": key_str,
            "saved_at": time.time(),
            "size": len(payload),
            "sha256": hashlib.sha256(payload).hexdigest(),
        }
        path = _artifact_path(directory, key_str)
        _inject("aot.save", path=path)
        with atomic_write(path, fault_site="io.write") as tmp:
            with open(tmp, "wb") as f:
                f.write(json.dumps(doc, sort_keys=True).encode("utf-8") + b"\n" + payload)
    except Exception:  # a failed artifact write must never fail the build that made the library
        _ERRORS_C.inc()
        return False
    _SAVES_C.inc()
    return True


def _drop(path: str) -> None:
    for p in (path, path + ".crc32"):
        try:
            os.remove(p)
        except OSError:
            pass


def stats() -> dict:
    """Snapshot of the cache's counters plus the armed directory -- a thin
    view over the shared telemetry registry (``aot.*``)."""
    directory, do_save = _config()
    return {
        "directory": directory,
        "save": do_save,
        "hits": _HITS_C.value,
        "misses": _MISSES_C.value,
        "saves": _SAVES_C.value,
        "stale": _STALE_C.value,
        "errors": _ERRORS_C.value,
        "unkeyed": _UNKEYED_C.value,
    }
