"""The CSR SpMM kernel's route gate and its plain version on the CPU.

``_planes.csr_spmm_route`` is held on every width class, type and
alignment class: width 1 takes the spmv route, a row of x of at most
``CSR_SPMM_ROWS_MAX_BYTES`` the rows route, a wider one the wide route, and
the rows and wide routes read 16-byte pieces only where x and out start on
16-byte boundaries with rows a multiple of 16 bytes apart.  The plain
version ``_csr_spmm_plain`` (what a CPU tensor runs, and what the card's
kernel is held against in tests/test_torch_gpu.py) is held against the JAX
package's SpMM program (``heat_tpu/sparse/_planes.py::_spmm_comp_rows_prog``,
not distributed) at the routes' edge shapes, on inputs made with numpy
from a seed: float32 within 1e-6 of the result's largest magnitude, int32
exactly."""

import numpy as np
import pytest
import torch

from heat_tpu.sparse import _planes as ref_planes
from heat_tpu_torch.sparse import _planes

TYPES = list(_planes.CSR_SPMM_TYPES)
EDGES = [1, 2, 31, 32, 33, "bound-1", "bound", "bound+1", 4096]


def _width(label, dtype: torch.dtype) -> int:
    """A width at an edge of the routes: a number, or the rows route's
    bound in columns of ``dtype`` plus an offset."""
    if isinstance(label, int):
        return label
    return _planes.CSR_SPMM_ROWS_MAX_BYTES // dtype.itemsize + int(label[len("bound"):] or 0)


def _x_views(rows: int, width: int, dtype: torch.dtype) -> dict:
    """x of ``width`` columns by alignment class: a 16-byte aligned start
    with rows a multiple of 16 bytes apart, the same one element off, and
    contiguous rows."""
    item = dtype.itemsize
    pad = -(-width * item // 16) * 16 // item + 16 // item
    buf = torch.zeros(rows, pad, dtype=dtype)
    return {"aligned": buf[:, :width], "one element off": buf[:, 1:width + 1],
            "contiguous": torch.zeros(rows, width, dtype=dtype)}


@pytest.mark.parametrize("dtype", TYPES, ids=str)
def test_route_gate(dtype):
    item = dtype.itemsize
    for label in EDGES:
        width = _width(label, dtype)
        want = "spmv" if width == 1 else "rows" if width * item <= 512 else "wide"
        for where, x in _x_views(3, width, dtype).items():
            # a new out (None) is aligned where its rows are whole 16-byte pieces
            vector = where != "one element off" and width * item % 16 == 0
            route, lane_bytes = _planes.csr_spmm_route(width, dtype, x)
            assert route == want, (label, where)
            assert lane_bytes == (item if route == "spmv" else 16 if vector else item), (label, where)
            # an out whose rows are not 16-byte multiples apart takes one element at a time
            odd = torch.zeros(3, width + 1, dtype=dtype)[:, :width]
            if route != "spmv" and (width + 1) * item % 16:
                assert _planes.csr_spmm_route(width, dtype, x, odd) == (route, item)
            if where == "aligned" and route != "spmv":
                assert _planes.csr_spmm_route(width, dtype, x, x) == (route, 16)


def test_route_bound_is_a_warps_16_byte_lanes():
    assert _planes.CSR_SPMM_ROWS_MAX_BYTES == 32 * 16
    assert _planes.csr_spmm_route(128, torch.float32, torch.zeros(2, 128))[0] == "rows"
    assert _planes.csr_spmm_route(129, torch.float32, torch.zeros(2, 129))[0] == "wide"
    assert _planes.csr_spmm_route(32, torch.complex128, torch.zeros(2, 32, dtype=torch.complex128))[0] == "rows"
    assert _planes.csr_spmm_route(33, torch.complex128, torch.zeros(2, 33, dtype=torch.complex128))[0] == "wide"


def _csr(rng, rows: int, k: int):
    """Row lengths with the routes' edges: 0, 1, 31, 32, 33, several
    hundred, and one longer than a spmv chunk (4096 float32 products) and a
    wide stage (1024 entries)."""
    lengths = rng.integers(0, 40, rows)
    lengths[::5] = 0
    lengths[1:8] = [1, 31, 32, 33, 300, 0, 5000]
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    col = rng.integers(0, k, int(ptr[-1])).astype(np.int32)
    return lengths, ptr, col


@pytest.mark.parametrize("label", EDGES)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_plain_matches_reference_spmm(label, dtype):
    """``_csr_spmm_plain`` against the JAX package's ``segment_sum`` SpMM at
    the routes' edge shapes (width 4096 on 9 rows), into zeros and
    accumulating into an out."""
    width = _width(label, getattr(torch, dtype))
    rows, k = (9 if width == 4096 else 61), 53
    rng = np.random.default_rng(1000 + width)
    lengths, ptr, col = _csr(rng, rows, k)
    if dtype == "float32":
        w = rng.standard_normal(col.size).astype(np.float32)
        x = rng.standard_normal((k, width)).astype(np.float32)
        base = rng.standard_normal((rows, width)).astype(np.float32)
    else:
        w = rng.integers(-9, 10, col.size).astype(np.int32)
        x = rng.integers(-9, 10, (k, width)).astype(np.int32)
        base = rng.integers(-9, 10, (rows, width)).astype(np.int32)
    comp = np.repeat(np.arange(rows, dtype=np.int32), lengths)
    want = np.asarray(ref_planes._spmm_comp_rows_prog(None, 1, col.size, rows, k, width, False)(comp, col, w, x))
    tx = torch.from_numpy(x)
    for out, expect in ((None, want), (torch.from_numpy(base.copy()), base + want)):
        got = _planes._csr_spmm_plain(torch.from_numpy(ptr), torch.from_numpy(col), torch.from_numpy(w), tx,
                                      torch.zeros(rows, width, dtype=tx.dtype) if out is None else out).numpy()
        assert got.dtype == expect.dtype and got.shape == expect.shape
        if dtype == "int32":
            np.testing.assert_array_equal(got, expect)
        else:
            assert np.abs(got - expect).max() <= 1e-6 * np.abs(expect).max()
        # the wrapper on a CPU tensor is the plain version
        again = _planes.csr_spmm(torch.from_numpy(ptr), torch.from_numpy(col), torch.from_numpy(w), tx,
                                 None if out is None else torch.from_numpy(base.copy()))
        assert again.numpy().tobytes() == got.tobytes()
