#!/usr/bin/env python3
"""Times of heat_tpu_torch's CSR SpMM kernel (csrc/csr_spmm.cu) on one CUDA
card, at the sparse path's operands: a random graph of 2^24 nodes of
degree 16 (2^28 entries) and X of 2^24 x 32 float32, as chip_smoke.py's
phase sparse draws them.  Run from the root of a checkout:

    python3 scripts/torch_csr_spmm_probe.py shapes [--pkg DIR]
    python3 scripts/torch_csr_spmm_probe.py footprint
    python3 scripts/torch_csr_spmm_probe.py check

``shapes``: ``chip_smoke.csr_spmm_shapes`` (the four shapes and the column
planes that split gather from latency), with the package of DIR, another
checkout (a ``git archive`` of another commit, unpacked into a
git-ignored directory), so that two versions of the kernel are timed by
one script; a kernel without a route gate is reported as one route.
``footprint``: the spmv route at one column and the rows route at 32 with
the columns cut to [0, n / k) for k = 1, 2, 4, 8, 16, 128 (x from 67 MB
down at one column), then variants of the source built beside the
library -- x's gathers without the L2 evict-last policy, the outputs
stored streamed (``st.global.cs``), both -- timed in turns against the
source as it is.  ``check``: phase csr_spmm_check alone.  ``--cpu``
rehearses a mode at a tiny size with the plain version.  Each record is
one JSON line with the card's name and power limit."""

import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(sys.argv[sys.argv.index("--pkg") + 1]).resolve() if "--pkg" in sys.argv else ROOT
sys.path.insert(0, str(PKG))

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import _build  # noqa: E402
from heat_tpu_torch.sparse import _planes  # noqa: E402

# x's gathers without the policy, and the output stores streamed, as text edits of the source
PLAIN_X = ("xv[u] = i < n ? ld_keep(x + (int64_t)c[u] * ldx, keep) : zero<T>();",
           "xv[u] = i < n ? x[(int64_t)c[u] * ldx] : zero<T>();")
STORE = '''template <typename T>
__device__ __forceinline__ void st_stream(T* p, T v) {
  static_assert(sizeof(T) <= 16 && (sizeof(T) & (sizeof(T) - 1)) == 0, "1 to 16 bytes");
  if constexpr (sizeof(T) == 1) {
    asm volatile("st.global.cs.u8 [%0], %1;" ::"l"(p), "r"((uint32_t) * (const uint8_t*)&v) : "memory");
  } else if constexpr (sizeof(T) == 2) {
    asm volatile("st.global.cs.u16 [%0], %1;" ::"l"(p), "h"(*(const uint16_t*)&v) : "memory");
  } else if constexpr (sizeof(T) == 4) {
    asm volatile("st.global.cs.b32 [%0], %1;" ::"l"(p), "r"(*(const uint32_t*)&v) : "memory");
  } else if constexpr (sizeof(T) == 8) {
    asm volatile("st.global.cs.b64 [%0], %1;" ::"l"(p), "l"(*(const uint64_t*)&v) : "memory");
  } else {
    const uint64_t* r = (const uint64_t*)&v;
    asm volatile("st.global.cs.v2.b64 [%0], {%1, %2};" ::"l"(p), "l"(r[0]), "l"(r[1]) : "memory");
  }
}

'''
STREAMED = [("template <typename T>\n__device__ __forceinline__ void put(", STORE + "template <typename T>\n"
             "__device__ __forceinline__ void put("),
            ("*o = Tr::store(accumulate ? add(Tr::load(*o), acc) : acc);",
             "st_stream(o, Tr::store(accumulate ? add(Tr::load(*o), acc) : acc));"),
            ("*reinterpret_cast<Vec<T, V>*>(o) = r;", "st_stream(reinterpret_cast<Vec<T, V>*>(o), r);")]


def edited(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"csr_spmm.cu no longer holds {old!r}: update this script's variants")
        text = text.replace(old, new, 1)
    return text


def bind(lib):
    for suffix in _planes.CSR_SPMM_TYPES.values():
        fn = getattr(lib, "heat_csr_spmm_" + suffix)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p] + [ctypes.c_int64] * 3 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def variants() -> dict:
    """The source as it is and its variants, each built into the build
    directory (one nvcc each, all at once) and bound as the wrapper binds
    its library."""
    src = (_build.CSRC / "csr_spmm.cu").read_text()
    texts = {"as_is": src, "plain_x": edited(src, [PLAIN_X]), "streamed_out": edited(src, STREAMED),
             "plain_x_streamed_out": edited(src, [PLAIN_X] + STREAMED)}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        path = _build.BUILD_DIR / f"csr_spmm_variant_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")),
                                        str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} variant:\n{out}")
        libs[name] = bind(ctypes.CDLL(str(_build.BUILD_DIR / f"csr_spmm_variant_{name}.so")))
    return libs


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith("--") else "shapes"
    cpu = "--cpu" in sys.argv
    if Path(ht.__file__).resolve().parent.parent != PKG:
        raise SystemExit(f"heat_tpu_torch comes from {ht.__file__}, not from {PKG}")
    if cpu:
        ht.use_device("cpu")
        dev = torch.device("cpu")
        cs.time_ms = lambda fn, reps, warmup=2: (fn(), 1.0)[1]
        cs.SPARSE_ROWS, cs.SPGEMM_DENSE_N, cs.CSR_RAGGED_ROWS = 1 << 12, 160, 60
        torch.cuda.synchronize = lambda *a: None
        plain = _planes.csr_spmm

        def counted(ptr, col, w, x, out=None):  # the launch count the card's wrapper keeps
            if x.stride(1) != 1 or col.dtype != torch.int32 or w.dtype != x.dtype:
                raise ValueError("refused")
            r = plain(ptr, col, w, x, out)
            _planes.CSR_SPMM_LAUNCHES += 1
            if hasattr(_planes, "CSR_SPMM_ROUTE_LAUNCHES"):
                _planes.CSR_SPMM_ROUTE_LAUNCHES[_planes.csr_spmm_route(x.shape[1], x.dtype, x, out)[0]] += 1
            return r

        _planes.csr_spmm = counted
        smi = "cpu"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card; --cpu rehearses on the host")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        t0 = time.perf_counter()
        _build.build_all(["csr_spmm"])
        cs.emit({"phase": "build", "package": str(PKG), "seconds": time.perf_counter() - t0,
                 "ptxas": cs.csr_spmm_ptxas(), "card": smi})
    if not hasattr(_planes, "csr_spmm_route"):  # a kernel of one design, before the route gate
        _planes.csr_spmm_route = lambda width, dtype, x, out: ("one", dtype.itemsize)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 19)
    coo = cs.random_graph(cs.SPARSE_ROWS, cs.SPARSE_DEGREE, dev, g)
    A = ht.sparse.sparse_csr_matrix(coo, split=0)
    del coo
    x = torch.rand(cs.SPARSE_ROWS, cs.SPARSE_X_COLS, device=dev, generator=g)
    t0 = time.perf_counter()
    if mode == "shapes":
        cs.csr_spmm_shapes(A, x, dev, smi)
    elif mode == "check":
        cs.emit(cs.csr_spmm_check(A, x, dev, g, smi))
    elif mode == "footprint":
        n, x1 = A.shape[0], x[:, :1].contiguous()
        ptr, col, w = A.lindptr, A._other[: A._n], A._val[: A._n]
        for k in (1, 2, 4, 8, 16, 128):
            cols = col % (n // k)
            cs.emit({"phase": "footprint", "x_rows": n // k, "x_mb_one_column": 4 * n / k / 1e6,
                     "spmv_ms": cs.time_ms(lambda: _planes.csr_spmm(ptr, cols, w, x1), reps=10),
                     "rows_ms": cs.time_ms(lambda: _planes.csr_spmm(ptr, cols, w, x), reps=5), "card": smi})
        if not cpu:
            libs = variants()
            quarter = col % (n // 4)
            for name in list(libs) + list(libs)[::-1]:  # in turns: a, b, c, d, d, c, b, a
                _planes._CSR_LIB = libs[name]
                cs.emit({"phase": "variant", "variant": name,
                         "spmv_67mb_ms": cs.time_ms(lambda: _planes.csr_spmm(ptr, col, w, x1), reps=10),
                         "spmv_17mb_ms": cs.time_ms(lambda: _planes.csr_spmm(ptr, quarter, w, x1), reps=10),
                         "rows_ms": cs.time_ms(lambda: _planes.csr_spmm(ptr, col, w, x), reps=5), "card": smi})
    else:
        raise SystemExit(f"unknown mode {mode!r}: shapes, footprint or check")
    cs.emit({"phase": "probe_done", "mode": mode, "package": str(PKG), "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
