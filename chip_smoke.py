#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; without a CUDA card, or without the package beside this
file, it exits non-zero before printing any result):

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: every CUDA source under heat_tpu_torch/csrc, one nvcc each, at once;
3. rng and kernels: seeded draws on the card bitwise equal to the host's;
   each kernel against its plain PyTorch version on the card, at
   the main path's shape (2^27 x 16 float32 points, k = 8) and at ragged
   shapes, plus a bitwise repeat;
4. main path: KMeans(n_clusters=8, init="random", max_iter=30).fit on 2^27
   x 16 Gaussian blobs made on the card from a seeded torch.Generator, the
   kernel launch count of that fit, a check of its labels and inertia
   against the plain version, and three predict requests (1, 64, 4096 rows);
5. profile: the same fit again under torch.profiler: the device's busy and
   idle share of the fit's wall time and the kernels that took the most;
6. times: each kernel's time per launch (CUDA events, after warm-up), its
   plain version's, and the least time the card could take (the bound).

The line before the last is the kernel summary, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROWS = 1 << 27  # BASELINE config 2's 10^9 rows cut to fit one card and the run's time
FEATURES = 16
CLUSTERS = 8
MAX_ITER = 30
SEED = 0
# published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def near_tie_mismatches(x, c, got, want) -> int:
    """Rows where two label vectors differ; fails unless every one is a
    near-tie, its two half-distances within 1e-4 (1 + |d|)."""
    import torch

    bad = torch.nonzero(got != want)[:, 0]
    if bad.numel():
        xb, cc = x[bad].double(), c.double()
        half = (cc * cc).sum(1)[None, :] - 2.0 * xb @ cc.T
        dg = half.gather(1, got[bad, None])[:, 0]
        dw = half.gather(1, want[bad, None])[:, 0]
        if not bool(((dg - dw).abs() <= 1e-4 * (1 + dw.abs())).all()):
            raise AssertionError(f"{bad.numel()} label mismatches, not all near-ties")
    return int(bad.numel())


def profile_fit(fit) -> dict:
    """Run ``fit`` under torch.profiler: its wall time, the device time of
    every kernel it launched (one stream, so the sum is the busy time), and
    the kernels that took the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"fit_wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels": [{"name": n[:80], "ms": ms, "calls": c} for n, (ms, c) in top]}


def compare_lloyd(x, c, n_true: int) -> dict:
    """The Lloyd kernel against its plain version on the same inputs:
    centres atol 1e-4, counts exact (up to near-tie relabels), inertia rtol
    1e-4, labels equal but at near-ties (at most 1e-6 of the rows), and a
    second launch bitwise equal to the first."""
    import torch
    from heat_tpu_torch.core import kernels

    got = kernels.lloyd_partials(x, c, n_true, labels=True)
    again = kernels.lloyd_partials(x, c, n_true, labels=True)
    want = kernels._lloyd_plain(x, c, n_true, True)
    torch.cuda.synchronize()
    sums, counts, inertia, lab = got
    ps, pc, pi, pl = want
    mism = near_tie_mismatches(x, c, lab, pl)
    if mism > 1e-6 * x.shape[0]:
        raise AssertionError(f"{mism} near-tie label mismatches in {x.shape[0]} rows")
    count_dev = float((counts - pc).abs().max())
    if count_dev > mism:
        raise AssertionError(f"counts differ by {count_dev} with {mism} relabelled rows")
    centres = sums / counts.clamp(min=1)[:, None]
    err = float((centres - ps / pc.clamp(min=1)[:, None]).abs().max())
    if err > 1e-4:
        raise AssertionError(f"centres differ by {err}")
    rel = abs(float(inertia) - float(pi)) / abs(float(pi))
    if rel > 1e-4:
        raise AssertionError(f"inertia differs by {rel} relative")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two launches on the same inputs differ")
    return {"rows": x.shape[0], "f": x.shape[1], "k": c.shape[0], "n_true": n_true, "max_abs_err": err,
            "inertia_rel_err": rel, "label_mismatches": mism, "bitwise_repeat": True}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on one", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import heat_tpu_torch as ht
    except ImportError:
        print("chip_smoke: run it from the root of a checkout (heat_tpu_torch not found)", file=sys.stderr)
        return 2
    if Path(ht.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: heat_tpu_torch comes from {ht.__file__}, not from this checkout", file=sys.stderr)
        return 2
    from heat_tpu_torch.core import _build, kernels

    # 1. device
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    print(smi, flush=True)

    # 2. build
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build_all(sources)
    regs = [ln.strip() for log in _build.BUILD_LOGS.values() for ln in log.splitlines() if "registers" in ln]
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0, "ptxas": regs})

    # the seeded generator on the card draws the host's bits (the host's are
    # the JAX package's, tests/test_torch_random.py)
    for n in (1003, 1 << 20):
        ht.random.seed(n)
        on_card = ht.random.rand(n, device="gpu").larray_padded.cpu()
        ht.random.seed(n)
        if not torch.equal(on_card.view(torch.int32), ht.random.rand(n, device="cpu").larray_padded.view(torch.int32)):
            raise AssertionError(f"rand({n}) on the card differs from the host's")
    emit({"phase": "rng", "rand_card_equals_host_bitwise": True})

    # data of the main path: Gaussian blobs, well apart, made on the card
    g = torch.Generator(device=dev).manual_seed(SEED)
    truth = torch.randn(CLUSTERS, FEATURES, device=dev, generator=g) * 10.0
    member = torch.randint(0, CLUSTERS, (ROWS,), device=dev, generator=g)
    x = torch.randn(ROWS, FEATURES, device=dev, generator=g)
    x += truth[member]
    del member

    # 3. kernels against their plain versions
    checks = [compare_lloyd(x, truth, ROWS)]
    for rows, f, k, n_true in ((1003, 17, 30, 1003), (1003, 16, 8, 901)):
        xs = torch.randn(rows, f, device=dev, generator=g)
        cs = torch.randn(k, f, device=dev, generator=g)
        checks.append(compare_lloyd(xs, cs, n_true))
    for c in checks:
        emit({"phase": "kernel_check", "kernel": "lloyd_step", **c})
    max_abs_err = max(c["max_abs_err"] for c in checks)

    # 4. the main path, through the entry points a user calls
    ht.use_device("gpu")
    kernels.LLOYD_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = ht.array(x, split=0)
    km = ht.cluster.KMeans(n_clusters=CLUSTERS, init="random", random_state=SEED, max_iter=MAX_ITER).fit(pts)
    n_iter, inertia = km.n_iter_, km.inertia_
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.LLOYD_LAUNCHES
    if launches < n_iter + 1:
        raise AssertionError(f"the fit launched the Lloyd kernel {launches} times for {n_iter} iterations")
    centres = km.cluster_centers_.larray
    labels = km.labels_.larray
    if centres.shape != (CLUSTERS, FEATURES) or labels.shape != (ROWS,) or not bool(torch.isfinite(centres).all()):
        raise AssertionError("the fit's centres or labels have the wrong shape or are not finite")
    _, _, plain_inertia, plain_labels = kernels._lloyd_plain(x, centres, ROWS, True)
    relabelled = near_tie_mismatches(x, centres, labels, plain_labels)
    if abs(inertia - float(plain_inertia)) > 1e-4 * abs(float(plain_inertia)):
        raise AssertionError(f"inertia {inertia} against {float(plain_inertia)} from the plain version")
    emit({"phase": "main_path", "rows": ROWS, "features": FEATURES, "clusters": CLUSTERS, "n_iter": n_iter,
          "inertia": inertia, "fit_wall_s": fit_s, "lloyd_launches": launches,
          "labels_vs_plain_near_ties": relabelled})

    rng = torch.Generator(device="cpu").manual_seed(SEED + 1)
    requests = []
    for size in (1, 64, 4096):
        rows = torch.randint(0, ROWS, (size,), generator=rng).to(dev)
        t0 = time.perf_counter()
        pred = km.predict(ht.array(x[rows], split=0)).larray
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(pred, labels[rows]):
            raise AssertionError(f"predict on {size} rows disagrees with labels_")
        requests.append({"rows": size, "wall_ms": ms})
    emit({"phase": "predict", "requests": requests})

    # 5. where the fit's time goes (the launches here are not counted)
    emit({"phase": "profile", **profile_fit(lambda: ht.cluster.KMeans(
        n_clusters=CLUSTERS, init="random", random_state=SEED, max_iter=MAX_ITER).fit(pts).n_iter_)})

    # 6. times, beside the bound
    kernel_ms = time_ms(lambda: kernels.lloyd_partials(x, centres, ROWS), reps=20)
    plain_ms = time_ms(lambda: kernels._lloyd_plain(x, centres, ROWS, False), reps=3, warmup=1)
    n, f, k = ROWS, FEATURES, CLUSTERS
    nbytes = 4 * n * f + 4 * k * f + 8 * (k * f + k + 1)  # x and c read once, the sums written once
    ops = n * (2 * k * f + 2 * f + 3 * k + f)  # dots, |x|^2, half-distance and argmin, the sums
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / F32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    emit({"phase": "times", "kernel": "lloyd_step", "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound[bound_by], "bound_by": bound_by, "share_of_bound": bound[bound_by] / kernel_ms,
          "library_ms": None, "library_note": "no single PyTorch call computes the fused Lloyd step",
          "card": smi})

    emit({"kernels": [{
        "name": "lloyd_step", "route": "cuda", "source": "heat_tpu_torch/csrc/lloyd.cu",
        "replaces": "heat_tpu/core/kernels.py:121", "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound[bound_by], "bound_by": bound_by,
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
