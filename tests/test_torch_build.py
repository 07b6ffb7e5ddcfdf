"""heat_tpu_torch/core/_build.py without nvcc: a library's file name
follows its source, every header beside it and the flags, so an edited
header builds anew; a built library is loaded again without nvcc; the
build directory is the checkout's, a per-user cache when installed, or the
one ``HEAT_TPU_TORCH_BUILD_DIR`` names."""

from pathlib import Path

import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.core import _build


def test_target_name_follows_the_source_and_every_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// first\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first  # unchanged sources: the same library
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-") and first.suffix == ".so"
    (tmp_path / "h.cuh").write_text("// second\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = _build._target("k")
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second, third)


def test_target_name_follows_an_included_source(tmp_path, monkeypatch):
    # csrc/lloyd_phases.cu defines its switch and includes lloyd.cu: an edit
    # to lloyd.cu must rebuild it too
    (tmp_path / "body.cu").write_text("// the body\n")
    (tmp_path / "stamped.cu").write_text('#define STAMPS\n#include "body.cu"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("stamped")
    assert _build._target("stamped") == first
    (tmp_path / "body.cu").write_text("// the body, edited\n")
    assert _build._target("stamped") != first
    (tmp_path / "other.cu").write_text("// not included\n")
    second = _build._target("stamped")
    (tmp_path / "other.cu").write_text("// not included, edited\n")
    assert _build._target("stamped") == second


def test_the_stamped_lloyd_build_includes_lloyd_cu():
    text = (_build.CSRC / "lloyd_phases.cu").read_text()
    assert _build._INCLUDED_CU.findall(text.encode()) == [b"lloyd.cu"]


def test_build_dir_checkout_cache_and_override(tmp_path, monkeypatch):
    monkeypatch.delenv("HEAT_TPU_TORCH_BUILD_DIR", raising=False)
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    checkout = tmp_path / "repo"
    (checkout / "heat_tpu_torch").mkdir(parents=True)
    (checkout / "pyproject.toml").write_text("")
    assert _build._build_dir(checkout) == checkout / "build" / "heat_tpu_torch"
    site = tmp_path / "site-packages"
    (site / "heat_tpu_torch").mkdir(parents=True)
    assert _build._build_dir(site) == Path("~/.cache/heat_tpu_torch").expanduser()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir(site) == tmp_path / "cache" / "heat_tpu_torch"
    mine = str(tmp_path / "mine")
    monkeypatch.setenv("HEAT_TPU_TORCH_BUILD_DIR", mine)
    for root in (checkout, site):
        assert _build._build_dir(root) == Path(mine)
    monkeypatch.delenv("HEAT_TPU_TORCH_BUILD_DIR")
    # this checkout builds into its own build/ (listed in .gitignore)
    repo = Path(__file__).resolve().parents[1]
    assert _build._build_dir(repo) == repo / "build" / "heat_tpu_torch"


def test_a_built_library_is_reused_without_nvcc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// a kernel\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    target = _build._target("k")
    target.parent.mkdir()
    target.write_bytes(b"built")

    def no_nvcc():
        raise AssertionError("nvcc must not run for a library that is built")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build_all(["k"]) == {"k": target}
    (tmp_path / "k.cu").write_text("// a kernel, edited\n")
    with pytest.raises(AssertionError, match="must not run"):
        _build.build_all(["k"])  # an edited source builds anew


def test_version_is_the_reference_version():
    assert ht.__version__ == hj.__version__
