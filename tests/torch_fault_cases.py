"""The calls of faults F17-F23 (ROADMAP queue 3), shared by
tests/test_torch_faults_f17_f23.py (each against heat_tpu on the CPU) and
tests/test_torch_gpu.py (the card against the CPU).  No JAX import.

``CASES[name] = (fn, inputs)``: ``fn(m, *arrays)`` calls module ``m``
(heat_tpu or heat_tpu_torch) on ``inputs()``, a list of numpy arrays of
which the first is split as the test asks and the others are whole."""

import numpy as np


def udata(dtype: str, seed: int = 0, shape=(6, 5)) -> np.ndarray:
    """Seeded values of an unsigned type: the even rows small (zeros among
    them), the odd ones over the whole range, and the first entries 0, 1,
    the maximum and both sides of the top bit."""
    rng = np.random.default_rng(seed)
    bits = np.iinfo(dtype).bits
    wide = rng.integers(0, 2**63, shape, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, shape, dtype=np.uint64)
    v = (wide >> np.uint64(64 - bits)).astype(dtype)
    v[::2] = rng.integers(0, 10, shape).astype(dtype)[::2]
    top = np.iinfo(dtype).max
    v.reshape(-1)[:5] = [0, 1, top, top // 2 + 1, top // 2]
    return v


def values(dtype: str, seed: int = 0, shape=(6, 5)) -> np.ndarray:
    """Seeded values of ``dtype``: the unsigned types by :func:`udata`,
    bool at random, small integers, normal floats (float16 rounded from
    float32), complex of normal parts."""
    if dtype in ("uint16", "uint32", "uint64"):
        return udata(dtype, seed, shape)
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype.startswith("int") or dtype == "uint8":
        return rng.integers(0 if dtype == "uint8" else -9, 10, shape).astype(dtype)
    if dtype.startswith("complex"):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    return (rng.standard_normal(shape) * 2).astype(np.float32).astype(dtype)


def _conditioned() -> np.ndarray:
    """A uint64 matrix drawn over the whole range (entries on both sides of
    2^63), well-conditioned in float32."""
    return np.random.default_rng(7).integers(0, 2**64 - 1, (5, 5), dtype=np.uint64, endpoint=True)


CASES = {}


def _case(name, fn, *inputs):
    CASES[name] = (fn, lambda: [f() for f in inputs])


for _t in ("float16",):
    _case(f"f17_histogram_{_t}", lambda m, x: m.histogram(x, bins=7), lambda t=_t: values(t))
    _case(f"f17_histc_{_t}", lambda m, x: m.histc(x, bins=7), lambda t=_t: values(t))
for _t in ("float16", "int8", "uint8", "int16"):
    _case(f"f17_histogram2d_{_t}", lambda m, x: m.histogram2d(x[:, 0], x[:, 1], bins=4), lambda t=_t: values(t))
    _case(f"f17_histogramdd_{_t}", lambda m, x: m.histogramdd(x[:, :3], bins=3), lambda t=_t: values(t))
    _case(f"f17_histogram_bin_edges_{_t}", lambda m, x: m.histogram_bin_edges(x, bins=5), lambda t=_t: values(t))
for _t in ("uint16", "uint32", "uint64"):
    _case(f"f18_diff_{_t}", lambda m, x: m.diff(x, axis=0), lambda t=_t: values(t))
    _case(f"f18_diff_last_{_t}", lambda m, x: m.diff(x, n=2), lambda t=_t: values(t))
    _case(f"f18_ediff1d_{_t}", lambda m, x: m.ediff1d(x), lambda t=_t: values(t))
    _case(f"f18_outer_{_t}", lambda m, x, y: m.outer(x[0], y[1]), lambda t=_t: values(t), lambda t=_t: values(t, 1))
    _case(f"f18_dot_{_t}", lambda m, x, y: m.dot(x[0], y[1]), lambda t=_t: values(t), lambda t=_t: values(t, 1))
    _case(f"f18_matmul_{_t}", lambda m, x, y: m.matmul(x, y.T), lambda t=_t: values(t), lambda t=_t: values(t, 1))
_case("f18_vdot_uint32", lambda m, x, y: m.vdot(x, y), lambda: values("uint32"), lambda: values("uint32", 1))
_case("f19_topk_uint64", lambda m, x: m.topk(x, 2), lambda: values("uint64"))
_case("f19_topk_uint64_axis0", lambda m, x: m.topk(x, 3, dim=0), lambda: values("uint64"))
_case("f19_topk_uint64_smallest", lambda m, x: m.topk(x, 2, largest=False), lambda: values("uint64"))
_case("f19_trace_uint64", lambda m, x: m.trace(x), lambda: values("uint64"))
_case("f19_gradient_uint64", lambda m, x: m.gradient(x, axis=0), lambda: values("uint64"))
_case("f19_trapz_uint64", lambda m, x: m.trapz(x, axis=0), lambda: values("uint64"))
_case("f19_trapz_uint32", lambda m, x: m.trapz(x, axis=0), lambda: values("uint32"))
for _p in (1, -1, np.inf, -np.inf):
    _case(f"f19_cond_uint64_p{_p}", lambda m, x, p=_p: m.linalg.cond(x, p), _conditioned)
for _s in (65, 70, 200):
    _case(f"f19_right_shift_uint64_by_{_s}", lambda m, x, y: x >> y, lambda: values("uint64"),
          lambda s=_s: np.full((6, 5), s, np.uint64))
_case("f19_right_shift_uint64_by_mixed", lambda m, x, y: m.right_shift(x, y), lambda: values("uint64"),
      lambda: (np.arange(30).reshape(6, 5) * 3).astype(np.uint64))
for _t in ("bool", "int8", "int32"):
    _case(f"f20_vdot_{_t}", lambda m, x, y: m.vdot(x, y), lambda t=_t: values(t), lambda t=_t: values(t, 1))
_case("f20_var_float16", lambda m, x: m.var(x, axis=0), lambda: values("float16"))
_case("f20_std_float16", lambda m, x: m.std(x), lambda: values("float16"))
_case("f20_histogram_bin_edges_bool", lambda m, x: m.histogram_bin_edges(x, bins=3), lambda: values("bool"))
_case("f20_histogramdd_bool", lambda m, x: m.histogramdd(x[:, :2], bins=3), lambda: values("bool"))
_case("f20_diff_prepend_int8", lambda m, x: m.diff(x, axis=0, prepend=0), lambda: values("int8"))
_case("f20_diff_prepend_bool", lambda m, x: m.diff(x, axis=0, prepend=0), lambda: values("bool"))
for _t in ("uint32", "uint64", "bool"):
    _case(f"f21_nanargmax_{_t}", lambda m, x: m.nanargmax(x, axis=0), lambda t=_t: values(t))
    _case(f"f21_nanargmin_{_t}", lambda m, x: m.nanargmin(x), lambda t=_t: values(t))
_case("f21_argwhere_uint64", lambda m, x: m.argwhere(x), lambda: values("uint64"))
_case("f21_flatnonzero_uint64", lambda m, x: m.flatnonzero(x), lambda: values("uint64"))
for _t in ("uint64", "complex64"):
    _case(f"f21_fmax_{_t}", lambda m, x, y: m.fmax(x, y), lambda t=_t: values(t), lambda t=_t: values(t, 1))
    _case(f"f21_fmin_{_t}", lambda m, x, y: m.fmin(x, y), lambda t=_t: values(t), lambda t=_t: values(t, 1))
for _t in ("uint32", "uint64"):
    _case(f"f21_inner_{_t}", lambda m, x, y: m.inner(x, y), lambda t=_t: values(t), lambda t=_t: values(t, 1))
    _case(f"f21_tensordot_{_t}", lambda m, x, y: m.tensordot(x, y, axes=([1], [1])), lambda t=_t: values(t),
          lambda t=_t: values(t, 1))
_case("f21_histogram_bin_edges_uint64", lambda m, x: m.histogram_bin_edges(x, bins=4), lambda: values("uint64"))
_case("f21_nanmax_complex64", lambda m, x: m.nanmax(x, axis=0), lambda: values("complex64"))
_case("f21_nanmin_complex64", lambda m, x: m.nanmin(x), lambda: values("complex64"))
_case("f21_histogram_complex64", lambda m, x: m.histogram(x, bins=4), lambda: values("complex64"))
_case("f21_logaddexp2_complex64", lambda m, x, y: m.logaddexp2(x, y), lambda: values("complex64"),
      lambda: values("complex64", 1))
_case("f23_bucketize_2d_boundaries", lambda m, x, y: m.bucketize(x, y), lambda: values("float32"),
      lambda: np.sort(values("float32", 1), axis=1))
_case("f23_digitize_2d_bins", lambda m, x, y: m.digitize(x, y), lambda: values("float32"),
      lambda: np.sort(values("float32", 1), axis=1))
_case("f23_delete_float_index", lambda m, x, y: m.delete(x, y, axis=0), lambda: values("float32"),
      lambda: np.array([0.0, 2.0]))
_case("f23_kron_bool", lambda m, x, y: m.kron(x, y), lambda: values("bool"), lambda: values("bool", 1))
_case("f23_percentile_2d_q", lambda m, x, y: m.percentile(x, y), lambda: values("float32"),
      lambda: np.array([[10.0, 50.0]]))
for _f in ("isnan", "isinf", "isfinite"):
    _case(f"f23_{_f}_second_positional", lambda m, x, f=_f: getattr(m, f)(x, 1), lambda: values("float32"))

# found by a sweep of napi over ten types while F17-F23 were repaired
_case("f24_nanvar_float16", lambda m, x: m.nanvar(x, axis=0), lambda: values("float16"))
_case("f24_nanstd_float16", lambda m, x: m.nanstd(x, axis=0), lambda: values("float16", 3, (40, 6)))
_case("f25_nanargmax_complex64", lambda m, x: m.nanargmax(x, axis=0), lambda: values("complex64"))
_case("f25_nanargmin_complex64", lambda m, x: m.nanargmin(x), lambda: values("complex64"))
_case("f26_histogram2d_complex64", lambda m, x: m.histogram2d(x[:, 0], x[:, 1], bins=3), lambda: values("complex64"))
_case("f26_histogramdd_complex64", lambda m, x: m.histogramdd(x[:, :2], bins=(2, 3)), lambda: values("complex64"))

#: the cases whose answer the card must give bitwise as the CPU does (F21,
#: F19's top-k and shifts): torch's CUDA kernels cover other types than its
#: CPU kernels, so each route is held on both
CARD_CASES = [n for n in CASES if n.startswith("f21_") or n.startswith("f19_topk") or n.startswith("f19_right_shift")]
