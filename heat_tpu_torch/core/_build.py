"""Build and load the port's hand-written CUDA kernels.

Each ``heat_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
:data:`BUILD_DIR`: ``build/heat_tpu_torch/`` at the root of the checkout
when the package sits in one, a per-user cache when it is installed
(``$XDG_CACHE_HOME/heat_tpu_torch``, by default ``~/.cache/heat_tpu_torch``),
and the directory ``$HEAT_TPU_TORCH_BUILD_DIR`` names in either case.  The
library's file
name carries a hash of the source, of every ``csrc/*.cu`` it includes (as
``csrc/lloyd_phases.cu`` includes ``lloyd.cu``), of every header
``csrc/*.cuh`` and of the flags, so an edited source or header builds anew
and an unchanged one is loaded as it is.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir(environ=os.environ, root: Path = Path(__file__).resolve().parents[2]) -> Path:
    """Where the libraries are built: the override variable's directory; in
    a checkout (``root`` holds ``pyproject.toml`` beside the package) its
    ``build/heat_tpu_torch``; else the per-user cache."""
    override = environ.get("HEAT_TPU_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    if (root / "pyproject.toml").is_file() and (root / "heat_tpu_torch").is_dir():
        return root / "build" / "heat_tpu_torch"
    cache = environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "heat_tpu_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: nvcc's report (registers, shared memory, spills) of each build, by source name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source and need the CUDA toolkit")


_INCLUDED_CU = re.compile(rb'^\s*#\s*include\s+"([\w.]+\.cu)"', re.MULTILINE)


def _target(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(source)
    for included in _INCLUDED_CU.findall(source):
        h.update(included + (CSRC / included.decode()).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Raises with nvcc's output on failure."""
    names = list(names)
    targets = {n: _target(n) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build_all([name])[name]))
