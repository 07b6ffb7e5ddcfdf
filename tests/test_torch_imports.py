"""The port imports torch and numpy, never JAX and nothing of heat_tpu: in a
fresh interpreter, importing heat_tpu_torch and every subpackage leaves no
``jax*`` or ``heat_tpu`` module loaded, and no source file of the package,
nor chip_smoke.py, has an import of either."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "heat_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import heat_tpu_torch
names = ["heat_tpu_torch"]
for info in pkgutil.walk_packages(heat_tpu_torch.__path__, "heat_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
assert "heat_tpu_torch.fft" in names and "heat_tpu_torch.fft._leading" in names, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "jax_")) or m == "heat_tpu" or m.startswith("heat_tpu."))
print("BAD", bad)
"""

_IMPORT = re.compile(r"^\s*(?:import\s+(?:jax\w*|heat_tpu)(?:[\s.,]|$)|from\s+(?:jax\w*|heat_tpu)(?:[\s.]|$))", re.M)


def test_importing_the_port_loads_no_jax_and_no_heat_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_source_of_the_port_imports_jax_or_heat_tpu():
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = [str(p.relative_to(REPO)) for p in sources if _IMPORT.search(p.read_text())]
    assert offenders == []


def test_the_import_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax", "import heat_tpu as ht",
                 "from heat_tpu.fft import _leading", "from heat_tpu import fft", "  import jaxlib"):
        assert _IMPORT.search(line), line
    for line in ("import heat_tpu_torch as ht", "from heat_tpu_torch.fft import _leading", "from . import fft",
                 "# heat_tpu/fft/_leading.py", "import numpy"):
        assert not _IMPORT.search(line), line


_WITHOUT = r"""
import importlib, importlib.abc, pkgutil, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("h5py", "torchvision"):
            raise ImportError(f"{name} is refused")
        return None


sys.meta_path.insert(0, Refuse())
import heat_tpu_torch
heat_tpu_torch.use_device("cpu")
for info in pkgutil.walk_packages(heat_tpu_torch.__path__, "heat_tpu_torch."):
    importlib.import_module(info.name)
x, y = heat_tpu_torch.utils.data.synthetic_mnist(8)
heat_tpu_torch.utils.data.MNISTDataset("unused")
print("IMPORTED", sorted(m for m in sys.modules if m.split(".")[0] in ("h5py", "torchvision")))
"""


def test_importing_the_port_needs_no_h5py_and_no_torchvision():
    """The card's machine has neither: every module imports, and the
    MNIST fallback runs, with both refused."""
    out = subprocess.run(
        [sys.executable, "-c", _WITHOUT], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout, out.stdout


_NEW_SUBPACKAGES = r"""
import importlib, sys
for name in ("heat_tpu_torch.resilience", "heat_tpu_torch.resilience.faults", "heat_tpu_torch.resilience.retry",
             "heat_tpu_torch.resilience.atomic", "heat_tpu_torch.resilience.guard", "heat_tpu_torch.telemetry",
             "heat_tpu_torch.telemetry.metrics", "heat_tpu_torch.telemetry.spans", "heat_tpu_torch.telemetry.tracing",
             "heat_tpu_torch.telemetry.journal", "heat_tpu_torch.analysis.concurrency", "heat_tpu_torch.analysis.tsan",
             "heat_tpu_torch.analysis.diagnostics", "heat_tpu_torch.analysis.protocols",
             "heat_tpu_torch.analysis.conformance", "heat_tpu_torch.datasets"):
    importlib.import_module(name)
import heat_tpu_torch as ht
assert ht.communication is ht.parallel
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "jax_")) or m == "heat_tpu" or m.startswith("heat_tpu."))
print("BAD", bad)
"""


def test_the_resilience_telemetry_and_analysis_subpackages_load_no_jax():
    """Each module of the resilience, telemetry and analysis slice, and
    the datasets, imported on its own in a fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", _NEW_SUBPACKAGES], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
