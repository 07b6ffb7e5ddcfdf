"""heat_tpu_torch/core/_build.py without nvcc: a library's file name
follows its source, every header beside it and the flags, so an edited
header builds anew."""

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
