"""heat_tpu_torch/core/aot_cache.py, the persistent artifact cache, on the
CPU with fake artifacts: a round trip, a flipped byte dropped and counted,
a fingerprint mismatch counted as stale, read-only mode, a lambda key
refused, arming from the environment, and ``_build``'s use of it: a
library restored from the cache with no ``nvcc``, a corrupt one built
again, a fresh build saved."""

import os
import stat
import sys

import pytest

from heat_tpu.core import aot_cache as ref_aot
from heat_tpu_torch.core import _build, aot_cache
from heat_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _fresh_cache_state(monkeypatch):
    """Each test starts disarmed, with the environment not yet read."""
    for name in ("_DIR", "_SAVE", "_ENV_READ", "_FP"):
        monkeypatch.setattr(aot_cache, name, getattr(aot_cache, name))
    monkeypatch.setattr(aot_cache, "_DIR", None)
    monkeypatch.setattr(aot_cache, "_SAVE", True)
    monkeypatch.setattr(aot_cache, "_ENV_READ", True)
    monkeypatch.delenv("HEAT_TPU_AOT_CACHE", raising=False)
    monkeypatch.delenv("HEAT_TPU_AOT_SAVE", raising=False)


def _delta(before):
    now = aot_cache.stats()
    return {k: now[k] - before[k] for k in ("hits", "misses", "saves", "stale", "errors", "unkeyed")}


KEY = ("heat_tpu_torch.csrc", "k.cu", "0" * 64)


def _only_artifact(d):
    (path,) = [p for p in d.iterdir() if p.suffix == aot_cache.ARTIFACT_SUFFIX]
    return path


def test_round_trip(tmp_path):
    aot_cache.configure(str(tmp_path))
    before = aot_cache.stats()
    assert aot_cache.load(KEY) is None  # absent: a miss
    assert aot_cache.save(KEY, b"\x7fELF library bytes")
    assert aot_cache.load(KEY) == b"\x7fELF library bytes"
    assert _delta(before) == {"hits": 1, "misses": 1, "saves": 1, "stale": 0, "errors": 0, "unkeyed": 0}
    path = _only_artifact(tmp_path)
    assert os.path.exists(str(path) + ".crc32")
    assert path.name == __import__("hashlib").sha256(aot_cache.stable_key(KEY).encode()).hexdigest() + ".aotx"


@pytest.mark.parametrize("where", ["payload", "header"])
def test_a_flipped_byte_is_dropped_and_counted(tmp_path, where):
    aot_cache.configure(str(tmp_path))
    aot_cache.save(KEY, b"0123456789" * 10)
    path = _only_artifact(tmp_path)
    blob = bytearray(path.read_bytes())
    at = len(blob) - 5 if where == "payload" else 3
    blob[at] ^= 0x40
    path.write_bytes(bytes(blob))
    before = aot_cache.stats()
    assert aot_cache.load(KEY) is None
    assert _delta(before)["errors"] == 1 and _delta(before)["hits"] == 0
    assert not path.exists() and not os.path.exists(str(path) + ".crc32")  # dropped: the next save heals it


def test_an_artifact_without_its_sidecar_is_never_loaded(tmp_path):
    aot_cache.configure(str(tmp_path))
    aot_cache.save(KEY, b"payload")
    os.remove(str(_only_artifact(tmp_path)) + ".crc32")
    before = aot_cache.stats()
    assert aot_cache.load(KEY) is None and _delta(before)["errors"] == 1


def test_a_fingerprint_mismatch_counts_stale(tmp_path, monkeypatch):
    aot_cache.configure(str(tmp_path))
    monkeypatch.setattr(aot_cache, "_FP", "torch=0;cuda=0;device=another card")
    aot_cache.save(KEY, b"payload")
    monkeypatch.setattr(aot_cache, "_FP", None)  # this process's own fingerprint again
    before = aot_cache.stats()
    assert aot_cache.load(KEY) is None
    assert _delta(before)["stale"] == 1 and _delta(before)["errors"] == 0
    assert _only_artifact(tmp_path).exists()  # stale, not corrupt: kept


def test_read_only_mode(tmp_path):
    aot_cache.configure(str(tmp_path))
    aot_cache.save(KEY, b"written by the fleet's writer")
    aot_cache.configure(str(tmp_path), save=False)
    assert aot_cache.enabled() and not aot_cache.save_enabled()
    other = KEY[:2] + ("1" * 64,)
    assert not aot_cache.save(other, b"not written")
    assert len([p for p in tmp_path.iterdir() if p.suffix == ".aotx"]) == 1
    assert aot_cache.load(KEY) == b"written by the fleet's writer"


def test_a_lambda_key_is_refused_as_in_the_reference(tmp_path):
    aot_cache.configure(str(tmp_path))
    before = aot_cache.stats()
    for key in (("op", lambda a: a), ("op", (1, lambda: 0))):
        assert aot_cache.stable_key(key) is None
        assert ref_aot.stable_key(key) is None
        assert not aot_cache.save(key, b"x")
    assert _delta(before)["unkeyed"] == 4
    named = ("op", len, (1, 2.5, "s"), None)
    assert aot_cache.stable_key(named) == ref_aot.stable_key(named)


def test_arming_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setattr(aot_cache, "_ENV_READ", False)
    monkeypatch.setenv("HEAT_TPU_AOT_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HEAT_TPU_AOT_SAVE", "0")
    assert aot_cache.enabled() and not aot_cache.save_enabled()
    assert aot_cache.stats()["directory"] == str(tmp_path / "cache") and (tmp_path / "cache").is_dir()
    monkeypatch.setattr(aot_cache, "_ENV_READ", False)
    monkeypatch.delenv("HEAT_TPU_AOT_CACHE")
    monkeypatch.delenv("HEAT_TPU_AOT_SAVE")
    monkeypatch.setattr(aot_cache, "_DIR", None)
    assert not aot_cache.enabled()  # off by default


def test_the_fingerprint_needs_no_nvcc(monkeypatch):
    def no_nvcc():
        raise AssertionError("the fingerprint must not ask for nvcc")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(aot_cache, "_FP", None)
    fp = aot_cache.fingerprint()
    assert "torch=" in fp and "nvcc_flags=" + " ".join(_build.NVCC_FLAGS) in fp and fp.endswith("fmt=1")


# ----------------------------------------------------------------------
# _build consults the cache before nvcc
# ----------------------------------------------------------------------
@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _forbid_nvcc(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source and need the CUDA toolkit")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)


def test_build_restores_a_library_from_the_cache_without_nvcc(fake_csrc, monkeypatch):
    aot_cache.configure(str(fake_csrc / "cache"))
    assert aot_cache.save(_build.artifact_key("k"), b"built elsewhere")
    _forbid_nvcc(monkeypatch)
    before = aot_cache.stats()
    target = _build.build_all(["k"])["k"]
    assert target == _build._target("k") and target.read_bytes() == b"built elsewhere"
    assert _delta(before)["hits"] == 1


def test_a_corrupt_artifact_is_built_again_never_loaded(fake_csrc, monkeypatch):
    aot_cache.configure(str(fake_csrc / "cache"))
    aot_cache.save(_build.artifact_key("k"), b"built elsewhere")
    path = _only_artifact(fake_csrc / "cache")
    path.write_bytes(path.read_bytes()[:-1] + b"X")
    _forbid_nvcc(monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc not found"):  # no CPU fallback: a build, which fails here
        _build.build_all(["k"])
    assert not _build._target("k").exists()


def test_a_transient_load_fault_falls_back_to_the_build(fake_csrc, monkeypatch):
    aot_cache.configure(str(fake_csrc / "cache"))
    aot_cache.save(_build.artifact_key("k"), b"built elsewhere")
    _forbid_nvcc(monkeypatch)
    with faults.fault_plan({"aot.load": [0]}):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_all(["k"])


def test_an_edited_source_misses_the_cache(fake_csrc):
    aot_cache.configure(str(fake_csrc / "cache"))
    aot_cache.save(_build.artifact_key("k"), b"old build")
    (fake_csrc / "csrc" / "k.cu").write_text("// a kernel, edited\n")
    before = aot_cache.stats()
    assert aot_cache.load(_build.artifact_key("k")) is None and _delta(before)["misses"] == 1


def test_a_fresh_build_is_saved_where_the_cache_may_be_written(fake_csrc, monkeypatch):
    fake = fake_csrc / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\nout = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'fresh build')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    aot_cache.configure(str(fake_csrc / "cache"))
    before = aot_cache.stats()
    _build.build_all(["k"])
    assert _delta(before)["saves"] == 1
    assert aot_cache.load(_build.artifact_key("k")) == b"fresh build"
    aot_cache.configure(str(fake_csrc / "cache2"), save=False)
    assert _build.save_artifacts(["k"]) == 0
    aot_cache.configure(str(fake_csrc / "cache2"), save=True)
    assert _build.save_artifacts(["k"]) == 1
