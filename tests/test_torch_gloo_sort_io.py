"""The port's sample sort, the calls on it and its io in a world of 3 CPU
ranks (torch.distributed, gloo) against heat_tpu on a 3-device
Communication, the sample sort's threshold lowered in both packages (as
tests/test_sort_collective.py lowers the reference's): sorts bitwise at
ragged extents (float32, float64, int32, int64, ascending and descending,
NaNs and zeros of both signs, an all-equal input, axis 0 and 1 of 2-D
arrays), a sort along the split axis below the threshold (a stable
argsort's order), the sorted route of 1-D percentile and median, the
column quantiles of median(x, axis=0), the top-k merge, unique, and
reshape, flatten, concatenate, pad, roll, flip, unfold, repeat, tile and
split along the split axis; every rank loading its own rows of an HDF5,
.npy and CSV file and a directory of .npy shards, and the saves writing
the reference's bytes.  Every all-gather is recorded: none hands a rank a
tensor as large as its share of the array, but for the gathers of the
reference's own algorithms (the sample sort's p^2 samples, top-k's p k
candidates, unique's distinct values) and the CSV writer's.

Each of the 28 sorts is a test of its own
(``test_sample_sort_case_is_the_references_bitwise``).  The rank script is
the one slice of a world of 3 rank processes (tests/torch_world.py), which
must finish it within 60 s."""

import os
from pathlib import Path

import jax
import numpy as np
import pytest

import heat_tpu as hj
from heat_tpu.core import sample_sort as ref_sort
from torch_world import WORLD, spawned

pytestmark = pytest.mark.multiprocess

THRESHOLD = 16

_MAIN = r"""
from heat_tpu_torch.core import sample_sort

arrays = dict(arrays)
files = str(arrays.pop("files"))
sample_sort.SAMPLE_SORT_THRESHOLD = LOWERED
saved, gathered, sources, phase = {}, {}, {}, [None]
for fname in ("all_gather", "all_gather_varying"):
    _fn = getattr(ht.Communication, fname)

    def recording(self, x, *args, _fn=_fn, **kw):
        if phase[0] is not None:  # the bytes this rank hands over
            gathered[phase[0]] = max(gathered.get(phase[0], 0), int(x.numel()) * x.element_size())
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, fname, recording)


def run(name, fn, source="mat"):
    phase[0] = name
    gathered.setdefault(name, 0)
    sources[name] = source
    try:
        return fn()
    finally:
        phase[0] = None


def keep(name, res):
    if isinstance(res, (tuple, list)):
        for i, r in enumerate(res):
            keep(f"{name}/{i}", r)
        return
    saved[name] = res.numpy()
    saved[name + "/split"] = np.asarray(-1 if res.split is None else res.split)
    saved[name + "/local"] = res.larray.numpy()


for key in [k for k in arrays if k.startswith("sort_")]:
    _, _, desc, axis = key.rsplit("_", 3)
    x = ht.array(arrays[key], split=int(axis))
    keep(key, run(key, lambda: ht.sort(x, axis=int(axis), descending=desc == "d"), key))
sample_sort.SAMPLE_SORT_THRESHOLD = 1 << 17
for key in ("dense_f", "dense_i"):
    x = ht.array(arrays[key], split=0)
    keep(key, run(key, lambda: ht.sort(x, axis=0, descending=key == "dense_i"), key))
sample_sort.SAMPLE_SORT_THRESHOLD = LOWERED

v = ht.array(arrays["vec"], split=0)
vi = ht.array(arrays["ivec"], split=0)
for method in ("linear", "lower", "higher", "midpoint", "nearest"):
    keep("pct_" + method, run("pct_" + method, lambda: ht.percentile(v, [0, 25, 50, 99.9], interpolation=method),
                              "vec"))
keep("pct_int", run("pct_int", lambda: ht.percentile(vi, [10, 90]), "ivec"))
keep("median", run("median", lambda: ht.median(v), "vec"))
nanvec = ht.array(arrays["nanvec"], split=0)
keep("median_nan", run("median_nan", lambda: ht.median(nanvec), "nanvec"))
m = ht.array(arrays["mat"], split=0)
keep("median_axis0", run("median_axis0", lambda: ht.median(m, axis=0)))
keep("pct_axis0", run("pct_axis0", lambda: ht.percentile(m, [5, 60], axis=0, interpolation="nearest")))
keep("pct_all", run("pct_all", lambda: ht.percentile(m, 40)))
keep("topk", run("topk", lambda: ht.topk(v, 5), "vec"))
keep("topk_small", run("topk_small", lambda: ht.topk(v, 4, largest=False), "vec"))
keep("topk_int", run("topk_int", lambda: ht.topk(vi, 6), "ivec"))
keep("topk_int_small", run("topk_int_small", lambda: ht.topk(vi, 3, largest=False), "ivec"))
keep("topk_cols", run("topk_cols", lambda: ht.topk(m, 3, dim=0)))
keep("unique", run("unique", lambda: ht.unique(vi), "ivec"))
keep("unique_nan", run("unique_nan", lambda: ht.unique(nanvec), "nanvec"))
imat = ht.array(arrays["imat"], split=0)
keep("unique_2d", run("unique_2d", lambda: ht.unique(imat), "imat"))
keep("reshape", run("reshape", lambda: ht.reshape(m, (4, 301))))
keep("reshape_flat", run("reshape_flat", lambda: ht.reshape(m, (1204,))))
keep("reshape_split1", run("reshape_split1", lambda: ht.reshape(m, (2, 602), new_split=1)))
m1 = ht.array(arrays["mat"], split=1)
keep("flatten_split1", run("flatten_split1", lambda: ht.flatten(m1)))
head = ht.array(arrays["mat"][:7])
keep("concatenate", run("concatenate", lambda: ht.concatenate([m, head, m], axis=0)))
keep("vstack", run("vstack", lambda: ht.vstack([v, v]), "vec"))
keep("pad_constant", run("pad_constant", lambda: ht.pad(m, ((3, 250), (1, 0)), constant_values=-1)))
keep("pad_reflect", run("pad_reflect", lambda: ht.pad(m, ((5, 2), (0, 0)), mode="reflect")))
keep("pad_wrap", run("pad_wrap", lambda: ht.pad(m, ((120, 4), (0, 0)), mode="wrap")))
keep("pad_mean", run("pad_mean", lambda: ht.pad(m, ((2, 1), (0, 0)), mode="mean", stat_length=3)))
keep("roll", run("roll", lambda: ht.roll(m, 5, 0)))
keep("roll_far", run("roll_far", lambda: ht.roll(m, -400, 0)))
keep("roll_flat", run("roll_flat", lambda: ht.roll(m, 7)))
keep("flip", run("flip", lambda: ht.flip(m, 0)))
keep("unfold", run("unfold", lambda: ht.unfold(m, 0, 4, 3)))
keep("repeat", run("repeat", lambda: ht.repeat(m, 2, axis=0)))
keep("tile", run("tile", lambda: ht.tile(m, (3, 1))))
keep("split", run("split", lambda: ht.split(m, [100, 250], axis=0)))
short, square = ht.array(arrays["vec"][:50], split=0), ht.array(arrays["square"], split=1)
keep("diag", run("diag", lambda: ht.diag(short, 2), "short"))
keep("diagonal", run("diagonal", lambda: ht.diagonal(square, -3), "square"))

# io: every rank its own rows; the saves in rank order
keep("load_h5", run("load_h5", lambda: ht.load_hdf5(files + "/ref.h5", "x", split=0)))
keep("load_h5_1", run("load_h5_1", lambda: ht.load_hdf5(files + "/ref.h5", "x", split=1)))
keep("load_npy", run("load_npy", lambda: ht.load(files + "/ref.npy", split=0)))
keep("load_csv", run("load_csv", lambda: ht.load_csv(files + "/ref.csv", split=0)))
keep("load_shards", run("load_shards", lambda: ht.load_npy_from_path(files + "/shards", dtype=ht.float32, split=0)))
base = files + "/port"
run("save_h5", lambda: ht.save_hdf5(m, base + ".h5", "x"))
run("save_npy", lambda: ht.save(m, base + ".npy"))
run("save_npy1", lambda: ht.save(m1, base + "_1.npy"))
run("save_shards", lambda: ht.save_npy_from_path(m, base + "_shards"))
ht.save_csv(m, base + ".csv")  # gathers, as the reference's writer

saved["gather_names"] = np.asarray(list(gathered))
saved["gather_bytes"] = np.asarray([gathered[k] for k in gathered])
saved["gather_sources"] = np.asarray([sources[k] for k in gathered])
np.savez(out, **saved)
""".replace("LOWERED", str(THRESHOLD))


def _sort_inputs(rng):
    """Ragged extents over 3 ranks (1000: 334, 334, 332; 301: 101, 101, 99)."""
    out = {}
    for dt in ("float32", "float64", "int32", "int64"):
        if dt.startswith("float"):
            x = (rng.integers(-20, 20, 1000) * 0.25).astype(dt)
            x[::17], x[3::23], x[5::29] = np.nan, -0.0, 0.0
            x[7::31] = -np.nan
        else:
            x = rng.integers(-50, 50, 1000).astype(dt)
        for desc in ("a", "d"):
            out[f"sort_{dt}_{desc}_0"] = x
            out[f"sort_{dt}x2_{desc}_0"] = np.stack([x[:301], x[301:602], x[602:903]], axis=1)
            out[f"sort_{dt}t_{desc}_1"] = np.stack([x[:301], x[301:602], x[602:903]], axis=0)
        out[f"sort_{dt}eq_a_0"] = np.full(1000, x[0] if dt.startswith("int") else 1.5, dt)
    return out


def _inputs(files):
    """The arrays, and the reference's files written under ``files`` for the
    ranks to read."""
    rng = np.random.default_rng(50)
    arrays = _sort_inputs(rng)
    arrays["dense_f"] = arrays["sort_float32_a_0"]
    arrays["dense_i"] = arrays["sort_int64_a_0"]
    arrays["vec"] = rng.standard_normal(1000)
    arrays["ivec"] = rng.integers(0, 9, 1000).astype(np.int32)
    nanvec = (rng.integers(0, 5, 61) * 1.0).astype(np.float64)
    nanvec[[3, 40]] = np.nan
    arrays["nanvec"] = nanvec
    arrays["mat"] = rng.standard_normal((301, 4)).astype(np.float32)
    arrays["imat"] = rng.integers(0, 4, (301, 2)).astype(np.int64)
    arrays["square"] = rng.standard_normal((31, 31))
    arrays["short"] = arrays["vec"][:50]
    comm = hj.Communication(jax.devices()[:WORLD])
    m = hj.array(arrays["mat"], split=0, comm=comm)
    hj.save_hdf5(m, str(files / "ref.h5"), "x")
    hj.save(m, str(files / "ref.npy"))
    hj.save_csv(m, str(files / "ref.csv"))
    hj.save_npy_from_path(m, str(files / "shards"))
    hj.save(hj.array(arrays["mat"], split=1, comm=comm), str(files / "ref_1.npy"))
    return {**arrays, "files": np.asarray(str(files))}, comm


# io under faults on some ranks only: every rank must leave each save or
# load at the same point and retry, or give up, together (no rank left
# waiting in a collective the others have passed).  Each case records, on
# each rank, the retry counters' change and the class of what it raised
_RETRY = r"""
import contextlib
import os

from heat_tpu_torch.resilience import faults, retry

os.environ["HEAT_TPU_RETRY_NO_SLEEP"] = "1"
files = str(arrays["files"])
m = ht.array(arrays["mat"], split=0)
saved = {}


def on(ranks, plan):
    return faults.fault_plan(plan) if rank in ranks else contextlib.nullcontext()


@contextlib.contextmanager
def fails_once(owner, name, ranks):
    # a real OSError (EIO) from owner.name on the given ranks, once
    real = getattr(owner, name)
    left = [int(rank in ranks)]

    def flaky(*args, **kwargs):
        if left[0]:
            left[0] = 0
            raise OSError(5, "Input/output error")
        return real(*args, **kwargs)

    setattr(owner, name, flaky)
    try:
        yield
    finally:
        setattr(owner, name, real)


def case(name, fn, ctx):
    before = retry.retry_stats()
    raised = ""
    try:
        with ctx:
            res = fn()
        if res is not None:
            saved[name + "/local"] = res.larray.numpy()
    except Exception as e:
        raised = type(e).__name__
    after = retry.retry_stats()
    saved[name + "/retries"] = np.asarray(after["retries"] - before["retries"])
    saved[name + "/gave_up"] = np.asarray(after["gave_up"] - before["gave_up"])
    saved[name + "/raised"] = np.asarray(raised)


out_ = files + "/retry"
case("csv_fault_rank0", lambda: ht.save_csv(m, out_ + "_a.csv"), on([0], {"io.write": [0]}))
case("csv_eio_rank0", lambda: ht.save_csv(m, out_ + "_b.csv"), fails_once(os, "replace", [0]))
case("npy_fault_rank0", lambda: ht.save(m, out_ + "_a.npy"), on([0], {"io.write": [0]}))
case("npy_eio_rank1", lambda: ht.save(m, out_ + "_b.npy"), fails_once(np.lib.format, "open_memmap", [1]))
case("h5_fault_rank1", lambda: ht.save_hdf5(m, out_ + ".h5", "x"), on([1], {"io.write": [0]}))
case("load_fault_rank2", lambda: ht.load(files + "/ref.npy", split=0), on([2], {"io.open": [0]}))
case("load_eio_rank1", lambda: ht.load(files + "/ref.npy", split=0), fails_once(np, "load", [1]))
case("csv_load_fault_rank1", lambda: ht.load_csv(files + "/ref.csv", split=0), on([1], {"io.open": [0]}))
case("load_gives_up_rank1", lambda: ht.load(files + "/ref.npy", split=0), on([1], {"io.open": [0, 1, 2]}))
case("shards_permanent_rank2", lambda: ht.save_npy_from_path(m, out_ + "_shards"),
     on([2], {"io.write": [{"at": [0], "kind": "permanent"}]}))
np.savez(out, **saved)
"""


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """The world's slices: the sorts and io, then io under faults."""
    files = tmp_path_factory.mktemp("files")
    slices = {"sort_io": (_MAIN, lambda: _inputs(files)),
              "io_retry": (_RETRY, lambda: ({"mat": np.load(files / "ref.npy"), "files": np.asarray(str(files))},
                                            None))}
    with spawned(tmp_path_factory.mktemp("sort_io"), slices) as w:
        got = {name: w.ranks(name) for name in slices}
    return w, got, files


@pytest.fixture(scope="module")
def sort_io_world(gloo_world):
    w, got, files = gloo_world
    arrays, comm = w["sort_io"]
    return arrays, comm, got["sort_io"], files


def _gathered(ranks, name):
    axis = int(ranks[0][name + "/split"])
    if axis < 0:
        for got in ranks:
            np.testing.assert_array_equal(got[name + "/local"], got[name])
        return ranks[0][name]
    return np.concatenate([got[name + "/local"] for got in ranks], axis=axis)


def _same(ranks, name, want, bitwise=True, rtol=3e-5, atol=1e-6):
    """Every rank's result is the reference's: its split, its own chunk of
    the reference's layout, the whole array on every rank."""
    wsplit = -1 if want.split is None else want.split
    w = np.asarray(want.numpy())
    for r, got in enumerate(ranks):
        assert int(got[name + "/split"]) == wsplit, (name, int(got[name + "/split"]), wsplit)
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, (name, got[name].dtype, w.dtype)
        if wsplit >= 0:
            assert got[name + "/local"].shape[wsplit] == want.lshape_map[r][wsplit], name
    whole = _gathered(ranks, name)
    if bitwise:
        np.testing.assert_array_equal(whole.view(np.uint8), w.view(np.uint8), err_msg=name)
    else:
        np.testing.assert_allclose(whole, w, rtol=rtol, atol=atol, err_msg=name)


SORT_KEYS = sorted(_sort_inputs(np.random.default_rng(0)))


@pytest.mark.parametrize("key", SORT_KEYS)
def test_sample_sort_case_is_the_references_bitwise(sort_io_world, monkeypatch, key):
    arrays, comm, ranks, _ = sort_io_world
    monkeypatch.setattr(ref_sort, "SAMPLE_SORT_THRESHOLD", THRESHOLD)
    _, _, desc, axis = key.rsplit("_", 3)
    want = hj.sort(hj.array(arrays[key], split=int(axis), comm=comm), axis=int(axis), descending=desc == "d")
    assert ref_sort.supports_sample_sort(hj.array(arrays[key], split=int(axis), comm=comm), int(axis), False)
    _same(ranks, key + "/0", want[0])
    _same(ranks, key + "/1", want[1])


def test_sample_sort_is_the_references_bitwise_on_three_ranks(sort_io_world, monkeypatch):
    """The 28 sample sorts (each held by
    test_sample_sort_case_is_the_references_bitwise) and the sorts below
    the threshold."""
    arrays, comm, ranks, _ = sort_io_world
    keys = sorted(k for k in arrays if k.startswith("sort_"))
    assert len(keys) == 28 and keys == SORT_KEYS
    for key, desc in (("dense_f", False), ("dense_i", True)):
        monkeypatch.setattr(ref_sort, "SAMPLE_SORT_THRESHOLD", 1 << 17)
        want = hj.sort(hj.array(arrays[key], split=0, comm=comm), axis=0, descending=desc)
        _same(ranks, key + "/0", want[0])
        _same(ranks, key + "/1", want[1])


def test_percentile_topk_and_unique_on_three_ranks(sort_io_world, monkeypatch):
    arrays, comm, ranks, _ = sort_io_world
    monkeypatch.setattr(ref_sort, "SAMPLE_SORT_THRESHOLD", THRESHOLD)
    v = hj.array(arrays["vec"], split=0, comm=comm)
    vi = hj.array(arrays["ivec"], split=0, comm=comm)
    m = hj.array(arrays["mat"], split=0, comm=comm)
    for method in ("linear", "lower", "higher", "midpoint", "nearest"):
        _same(ranks, "pct_" + method, hj.percentile(v, [0, 25, 50, 99.9], interpolation=method), bitwise=False,
              rtol=1e-12, atol=1e-12)
    _same(ranks, "pct_int", hj.percentile(vi, [10, 90]), bitwise=False, rtol=1e-12, atol=1e-12)
    _same(ranks, "median", hj.median(v), bitwise=False, rtol=1e-12, atol=1e-12)
    _same(ranks, "median_nan", hj.median(hj.array(arrays["nanvec"], split=0, comm=comm)), bitwise=False)
    _same(ranks, "median_axis0", hj.median(m, axis=0), bitwise=False)
    _same(ranks, "pct_axis0", hj.percentile(m, [5, 60], axis=0, interpolation="nearest"), bitwise=False)
    _same(ranks, "pct_all", hj.percentile(m, 40), bitwise=False)
    for name, want in (("topk", hj.topk(v, 5)), ("topk_small", hj.topk(v, 4, largest=False)),
                       ("topk_int", hj.topk(vi, 6)), ("topk_int_small", hj.topk(vi, 3, largest=False)),
                       ("topk_cols", hj.topk(m, 3, dim=0))):
        _same(ranks, name + "/0", want[0])
        _same(ranks, name + "/1", want[1])
    _same(ranks, "unique", hj.unique(vi))
    _same(ranks, "unique_nan", hj.unique(hj.array(arrays["nanvec"], split=0, comm=comm)))
    _same(ranks, "unique_2d", hj.unique(hj.array(arrays["imat"], split=0, comm=comm)))


def test_rows_move_along_the_split_axis_as_in_the_reference(sort_io_world):
    arrays, comm, ranks, _ = sort_io_world
    m = hj.array(arrays["mat"], split=0, comm=comm)
    v = hj.array(arrays["vec"], split=0, comm=comm)
    for name, want in (("reshape", hj.reshape(m, (4, 301))), ("reshape_flat", hj.reshape(m, (1204,))),
                       ("reshape_split1", hj.reshape(m, (2, 602), new_split=1)),
                       ("flatten_split1", hj.flatten(hj.array(arrays["mat"], split=1, comm=comm))),
                       ("concatenate", hj.concatenate([m, hj.array(arrays["mat"][:7], comm=comm), m], axis=0)),
                       ("vstack", hj.vstack([v, v])),
                       ("pad_constant", hj.pad(m, ((3, 250), (1, 0)), constant_values=-1)),
                       ("pad_reflect", hj.pad(m, ((5, 2), (0, 0)), mode="reflect")),
                       ("pad_wrap", hj.pad(m, ((120, 4), (0, 0)), mode="wrap")),
                       ("roll", hj.roll(m, 5, 0)), ("roll_far", hj.roll(m, -400, 0)), ("roll_flat", hj.roll(m, 7)),
                       ("flip", hj.flip(m, 0)), ("unfold", hj.unfold(m, 0, 4, 3)),
                       ("repeat", hj.repeat(m, 2, axis=0)), ("tile", hj.tile(m, (3, 1))),
                       ("diag", hj.diag(hj.array(arrays["vec"][:50], split=0, comm=comm), 2)),
                       ("diagonal", hj.diagonal(hj.array(arrays["square"], split=1, comm=comm), -3))):
        _same(ranks, name, want)
    _same(ranks, "pad_mean", hj.pad(m, ((2, 1), (0, 0)), mode="mean", stat_length=3), bitwise=False)
    for i, want in enumerate(hj.split(m, [100, 250], axis=0)):
        _same(ranks, f"split/{i}", want)


def test_io_reads_own_rows_and_writes_the_references_bytes(sort_io_world, tmp_path):
    arrays, comm, ranks, files = sort_io_world
    m = hj.array(arrays["mat"], split=0, comm=comm)
    _same(ranks, "load_h5", hj.load_hdf5(str(files / "ref.h5"), "x", split=0, comm=comm))
    _same(ranks, "load_h5_1", hj.load_hdf5(str(files / "ref.h5"), "x", split=1, comm=comm))
    _same(ranks, "load_npy", hj.load(str(files / "ref.npy"), split=0, comm=comm))
    _same(ranks, "load_csv", hj.load_csv(str(files / "ref.csv"), split=0, comm=comm))
    _same(ranks, "load_shards", hj.load_npy_from_path(str(files / "shards"), dtype=hj.float32, split=0, comm=comm))
    out = str(files / "port")
    for mine, theirs in ((out + ".npy", files / "ref.npy"), (out + "_1.npy", files / "ref_1.npy"),
                         (out + ".csv", files / "ref.csv")):
        assert Path(mine).read_bytes() == Path(theirs).read_bytes(), mine
        assert Path(mine + ".crc32").read_bytes() == Path(str(theirs) + ".crc32").read_bytes(), mine
    import h5py

    with h5py.File(out + ".h5", "r") as f, h5py.File(files / "ref.h5", "r") as g:
        assert f["x"].dtype == g["x"].dtype and f["x"].shape == g["x"].shape
        np.testing.assert_array_equal(f["x"][...], g["x"][...])
    assert sorted(os.listdir(out + "_shards")) == sorted(os.listdir(files / "shards"))
    for name in os.listdir(files / "shards"):
        assert Path(out + "_shards", name).read_bytes() == (files / "shards" / name).read_bytes()
    np.testing.assert_array_equal(hj.load_hdf5(out + ".h5", "x", comm=comm).numpy(), arrays["mat"])


def test_nothing_the_size_of_the_array_is_gathered(sort_io_world):
    """Each rank hands an all-gather at most its share of the samples,
    candidates or distinct values the reference's algorithm gathers, never
    its share of the array (the CSV writer's gather is not recorded)."""
    arrays, _, ranks, _ = sort_io_world
    for got in ranks:
        names = got["gather_names"].tolist()
        assert len(names) > 70
        for name, size, source in zip(names, got["gather_bytes"].tolist(), got["gather_sources"].tolist()):
            share = arrays[source].nbytes / WORLD
            assert size < share, f"{name} handed an all-gather {size} bytes of a {share}-byte share of {source}"


# case: (what each rank retried, what each rank raised, the file it wrote
# and the reference's, or the rows it read)
RETRY_CASES = {
    "csv_fault_rank0": ([1, 0, 0], "", ("retry_a.csv", "ref.csv")),
    "csv_eio_rank0": ([1, 0, 0], "", ("retry_b.csv", "ref.csv")),
    "npy_fault_rank0": ([1, 1, 1], "", ("retry_a.npy", "ref.npy")),
    "npy_eio_rank1": ([1, 1, 1], "", ("retry_b.npy", "ref.npy")),
    "h5_fault_rank1": ([1, 1, 1], "", None),
    "load_fault_rank2": ([1, 1, 1], "", "rows"),
    "load_eio_rank1": ([1, 1, 1], "", "rows"),
    "csv_load_fault_rank1": ([1, 1, 1], "", "rows"),
    "load_gives_up_rank1": ([2, 2, 2], "TransientFault", None),
    "shards_permanent_rank2": ([0, 0, 0], "PermanentFault", None),
}


@pytest.mark.parametrize("name", sorted(RETRY_CASES))
def test_io_ranks_retry_or_give_up_together(gloo_world, name):
    """A fault, injected or a real EIO, on one rank of three: a save or load
    that holds collectives is retried by every rank together (none is left
    in a collective: the slice would miss its deadline), the gathering
    writers retry rank 0's write alone, and a failure that is not retried
    raises on every rank.  What was written is the reference's bytes; what
    was read, each rank's own rows."""
    _, got, files = gloo_world
    retries, raised, check = RETRY_CASES[name]
    ranks = got["io_retry"]
    assert [int(r[name + "/retries"]) for r in ranks] == retries
    assert [str(r[name + "/raised"]) for r in ranks] == [raised] * WORLD
    gave_up = [int(r[name + "/gave_up"]) for r in ranks]
    assert gave_up == ([1] * WORLD if raised == "TransientFault" else [0] * WORLD)
    if check == "rows":
        mat = np.load(files / "ref.npy")
        bounds = np.cumsum([0] + [r[name + "/local"].shape[0] for r in ranks])
        assert bounds.tolist() == [0, 101, 202, 301]
        for r, lo, hi in zip(ranks, bounds[:-1], bounds[1:]):
            np.testing.assert_array_equal(r[name + "/local"][:hi - lo], mat[lo:hi])
    elif check is not None:
        mine, theirs = (files / f for f in check)
        assert mine.read_bytes() == theirs.read_bytes()
        assert Path(str(mine) + ".crc32").read_bytes() == Path(str(theirs) + ".crc32").read_bytes()
    if name == "h5_fault_rank1":
        import h5py

        with h5py.File(files / "retry.h5", "r") as f:
            np.testing.assert_array_equal(f["x"][...], np.load(files / "ref.npy"))
    leftovers = [f for f in os.listdir(files) if ".tmp-" in f]
    assert not leftovers, leftovers
