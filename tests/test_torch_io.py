"""The port's io.py against heat_tpu's on a world of one: every export
round-trips, the two packages write the same bytes for the same array (the
CSV text, the .npy file, the HDF5 dataset's values, type and shape, the
netCDF variable, and the CRC32 sidecar), a file written by either loads in
the other, a corrupted file fails its checksum in both, and
``HEAT_TPU_IO_CHECKSUM=0`` turns the sidecars off in both.  netCDF runs
through scipy's NetCDF3 writer where netCDF4 is missing."""

import os

import h5py
import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.resilience.errors import ChecksumError as RefChecksumError
from heat_tpu_torch.core.io import ChecksumError
from torch_parity import DTYPES, SPLITS, data, same


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_files(a, b):
    assert _bytes(a) == _bytes(b)
    assert _bytes(a + ".crc32") == _bytes(b + ".crc32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_hdf5_round_trips_and_crosses_packages(tmp_path, dtype):
    a = data(dtype, shape=(7, 3), seed=20)
    for split in SPLITS:
        mine, theirs = str(tmp_path / f"p{split}.h5"), str(tmp_path / f"r{split}.h5")
        ht.save_hdf5(ht.array(a, split=split), mine, "x")
        hj.save_hdf5(hj.array(a, split=split), theirs, "x")
        with h5py.File(mine, "r") as f, h5py.File(theirs, "r") as g:
            assert f["x"].dtype == g["x"].dtype and f["x"].shape == g["x"].shape
            np.testing.assert_array_equal(f["x"][...], g["x"][...])
        for load_split in SPLITS:
            same(ht.load_hdf5(theirs, "x", dtype=dtype, split=load_split),
                 hj.load_hdf5(theirs, "x", dtype=dtype, split=load_split))
            same(ht.load(mine, "x", dtype=dtype, split=load_split), hj.load(mine, "x", dtype=dtype, split=load_split))
    same(ht.load_hdf5(mine, "x", dtype=dtype, load_fraction=0.5, split=0),
         hj.load_hdf5(mine, "x", dtype=dtype, load_fraction=0.5, split=0))


def test_hdf5_append_mode_keeps_the_first_dataset(tmp_path):
    path = str(tmp_path / "two.h5")
    ht.save_hdf5(ht.array(np.arange(6.0), split=0), path, "a")
    ht.save_hdf5(ht.array(np.ones((2, 2), np.int32)), path, "b", mode="a")
    np.testing.assert_array_equal(hj.load_hdf5(path, "a", dtype=hj.float64).numpy(), np.arange(6.0))
    np.testing.assert_array_equal(ht.load_hdf5(path, "b", dtype=ht.int32).numpy(), np.ones((2, 2)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_npy_writes_the_references_bytes(tmp_path, dtype):
    a = data(dtype, shape=(6, 5), seed=21)
    for split in SPLITS:
        mine, theirs = str(tmp_path / f"p{split}.npy"), str(tmp_path / f"r{split}.npy")
        ht.save(ht.array(a, split=split), mine)
        hj.save(hj.array(a, split=split), theirs)
        _same_files(mine, theirs)
        for load_split in SPLITS:
            same(ht.load(theirs, split=load_split), hj.load(mine, split=load_split))
        same(ht.load(mine, dtype=ht.float64, split=split), hj.load(mine, dtype=hj.float64, split=split))


@pytest.mark.parametrize("split", SPLITS)
def test_npy_shards_round_trip_and_cross(tmp_path, split):
    a = data("int32", shape=(9, 4), seed=22)
    mine, theirs = str(tmp_path / "p"), str(tmp_path / "r")
    ht.save_npy_from_path(ht.array(a, split=split), mine)
    hj.save_npy_from_path(hj.array(a, split=split), theirs)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for name in os.listdir(mine):
        assert _bytes(os.path.join(mine, name)) == _bytes(os.path.join(theirs, name))
    for load_split in (None, 0, 1):
        same(ht.load_npy_from_path(theirs, split=load_split), hj.load_npy_from_path(mine, split=load_split))
        same(ht.load_npy_from_path(mine, dtype=ht.float32, split=load_split),
             hj.load_npy_from_path(theirs, dtype=hj.float32, split=load_split))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_csv_writes_the_references_text(tmp_path, dtype):
    a = data(dtype, shape=(9, 4), seed=23)
    for split in SPLITS:
        for kw in ({}, {"header_lines": ["a,b,c,d", "# two lines"], "sep": ";"}, {"decimals": 3}):
            mine, theirs = str(tmp_path / f"p{split}.csv"), str(tmp_path / f"r{split}.csv")
            ht.save_csv(ht.array(a, split=split), mine, **kw)
            hj.save_csv(hj.array(a, split=split), theirs, **kw)
            _same_files(mine, theirs)
            lines = 2 if "header_lines" in kw else 0
            sep = kw.get("sep", ",")
            read_as = "float64" if "decimals" in kw else dtype  # rounded values print as floats
            for load_split in SPLITS:
                same(ht.load_csv(theirs, header_lines=lines, sep=sep, dtype=read_as, split=load_split),
                     hj.load_csv(mine, header_lines=lines, sep=sep, dtype=read_as, split=load_split))
    v = data("float32", shape=(7,), seed=24)
    ht.save(ht.array(v, split=0), str(tmp_path / "v.csv"))
    hj.save(hj.array(v, split=0), str(tmp_path / "w.csv"))
    _same_files(str(tmp_path / "v.csv"), str(tmp_path / "w.csv"))
    same(ht.load(str(tmp_path / "v.csv"), split=0), hj.load(str(tmp_path / "w.csv"), split=0))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_netcdf_round_trips_and_crosses_packages(tmp_path, dtype):
    assert ht.supports_netcdf() == hj.supports_netcdf()
    a = data(dtype, shape=(6, 3), seed=25)
    for split in SPLITS:
        mine, theirs = str(tmp_path / f"p{split}.nc"), str(tmp_path / f"r{split}.nc")
        ht.save_netcdf(ht.array(a, split=split), mine, "v")
        hj.save_netcdf(hj.array(a, split=split), theirs, "v")
        _same_files(mine, theirs)
        for load_split in SPLITS:
            same(ht.load_netcdf(theirs, "v", dtype=dtype, split=load_split),
                 hj.load_netcdf(mine, "v", dtype=dtype, split=load_split))
        same(ht.load(mine, "v", dtype=dtype), hj.load(theirs, "v", dtype=dtype))
    b = data(dtype, shape=(2, 3), seed=26)
    for m, path in ((ht, str(tmp_path / "pa.nc")), (hj, str(tmp_path / "ra.nc"))):
        m.save_netcdf(m.array(a), path, "v", dimension_names=["t", "f"], is_unlimited=True)
        m.save_netcdf(m.array(b), path, "w", mode="a")
        m.save_netcdf(m.array(b), path, "v", mode="r+", file_slices=slice(6, 8))
    _same_files(str(tmp_path / "pa.nc"), str(tmp_path / "ra.nc"))


def test_text_archive_and_binary_formats_match_reference(tmp_path):
    a = data("float64", shape=(5, 3), seed=27)
    for split in SPLITS:
        p, r = ht.array(a, split=split), hj.array(a, split=split)
        pairs = {}
        for m, x, tag in ((ht, p, "p"), (hj, r, "r")):
            m.savetxt(str(tmp_path / f"{tag}.txt"), x, fmt="%.6e", header="h")
            m.savez(str(tmp_path / f"{tag}"), x, b=x)
            m.savez_compressed(str(tmp_path / f"{tag}c.npz"), x)
            m.tofile(x, str(tmp_path / f"{tag}.bin"))
            m.tofile(x, str(tmp_path / f"{tag}.tsv"), sep=",", format="%.4f")
            pairs[tag] = m
        for name in ("{}.txt", "{}.npz", "{}.bin", "{}.tsv"):
            _same_files(str(tmp_path / name.format("p")), str(tmp_path / name.format("r")))
        for load_split in SPLITS:
            same(ht.loadtxt(str(tmp_path / "r.txt"), dtype=ht.float64, split=load_split),
                 hj.loadtxt(str(tmp_path / "p.txt"), dtype=hj.float64, split=load_split))
            same(ht.load(str(tmp_path / "r.txt"), dtype=ht.float64, split=load_split),
                 hj.load(str(tmp_path / "p.txt"), dtype=hj.float64, split=load_split))
            same(ht.load(str(tmp_path / "r.npz"), split=load_split), hj.load(str(tmp_path / "p.npz"), split=load_split))
            same(ht.load(str(tmp_path / "rc.npz"), "arr_0", split=load_split),
                 hj.load(str(tmp_path / "pc.npz"), "arr_0", split=load_split))
            same(ht.fromfile(str(tmp_path / "r.bin"), dtype=ht.float64, split=load_split if load_split != 1 else 0),
                 hj.fromfile(str(tmp_path / "p.bin"), dtype=hj.float64, split=load_split if load_split != 1 else 0))
            same(ht.memmap(str(tmp_path / "r.bin"), dtype=ht.float64, shape=(5, 3), split=load_split),
                 hj.memmap(str(tmp_path / "p.bin"), dtype=hj.float64, shape=(5, 3), split=load_split))
    (tmp_path / "gaps.txt").write_text("1,2,3\n4,,6\n7,8,\n")
    same(ht.genfromtxt(str(tmp_path / "gaps.txt"), delimiter=",", split=0),
         hj.genfromtxt(str(tmp_path / "gaps.txt"), delimiter=",", split=0))
    (tmp_path / "re.txt").write_text("x=1 y=2.5\nx=3 y=4.5\nx=5 y=6.5\n")
    for dt in ([("x", np.int32)], [("x", np.float64), ("y", np.float64)]):
        same(ht.fromregex(str(tmp_path / "re.txt"), r"x=(\d+) y=([\d.]+)" if len(dt) == 2 else r"x=(\d+)", dt),
             hj.fromregex(str(tmp_path / "re.txt"), r"x=(\d+) y=([\d.]+)" if len(dt) == 2 else r"x=(\d+)", dt))
    np.save(str(tmp_path / "m.npy"), a)
    for split in SPLITS:
        same(ht.open_memmap(str(tmp_path / "m.npy"), split=split), hj.open_memmap(str(tmp_path / "m.npy"), split=split))
    ds = ht.DataSource(str(tmp_path))
    assert ds.exists(str(tmp_path / "m.npy")) and ds.abspath("m.npy") == hj.DataSource(str(tmp_path)).abspath("m.npy")
    with ds.open(str(tmp_path / "gaps.txt")) as f:
        assert f.read().startswith("1,2,3")
    assert (ht.supports_hdf5(), ht.supports_pandas()) == (hj.supports_hdf5(), hj.supports_pandas())
    assert ht.io.format is np.lib.format


@pytest.mark.parametrize("ext", [".h5", ".npy", ".csv", ".nc", ".txt", ".npz"])
def test_a_corrupted_file_fails_its_checksum_in_both(tmp_path, ext):
    path = str(tmp_path / f"x{ext}")
    x = ht.array(data("float32", shape=(6, 2), seed=28), split=0)
    args = ("x",) if ext in (".h5", ".nc") else ()
    ht.save(x, path, *args)
    with open(path + ".crc32") as f:
        assert len(f.read()) == 9  # 8 hex digits and a newline
    same(ht.load(path, *args), hj.load(path, *args))
    with open(path, "r+b") as f:  # one byte flipped near the end
        f.seek(-3, os.SEEK_END)
        byte = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))
    with pytest.raises(ChecksumError):
        ht.load(path, *args)
    with pytest.raises(RefChecksumError):
        hj.load(path, *args)


def test_checksums_off_writes_no_sidecar_and_verifies_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_IO_CHECKSUM", "0")
    path = str(tmp_path / "x.npy")
    ht.save(ht.array(np.arange(4.0), split=0), path)
    assert not os.path.exists(path + ".crc32")
    with open(path + ".crc32", "w") as f:
        f.write("00000000\n")  # a wrong sidecar is not read
    np.testing.assert_array_equal(ht.load(path).numpy(), np.arange(4.0))
    np.testing.assert_array_equal(hj.load(path).numpy(), np.arange(4.0))


def test_bad_arguments_raise_as_in_the_reference(tmp_path):
    x = ht.array(np.zeros((2, 2, 2)))
    r = hj.array(np.zeros((2, 2, 2)))
    for call in (lambda m, v: m.load(3), lambda m, v: m.save(v, 3), lambda m, v: m.load("x.bad"),
                 lambda m, v: m.save(v, "x.bad"), lambda m, v: m.save_csv(v, str(tmp_path / "a.csv")),
                 lambda m, v: m.load_hdf5(str(tmp_path / "no.h5"), 3),
                 lambda m, v: m.load_hdf5(str(tmp_path / "no.h5"), "x", load_fraction=2.0),
                 lambda m, v: m.load_csv(str(tmp_path / "no.csv"), sep=3),
                 lambda m, v: m.load_npy_from_path(str(tmp_path), split="0")):
        try:
            call(hj, r)
        except Exception as e:
            with pytest.raises(type(e)):
                call(ht, x)
        else:
            raise AssertionError("the reference accepted a bad call")
