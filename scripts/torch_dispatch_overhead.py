"""Host cost of the port's dispatch-key counting and of the roofline
observatory (heat_tpu_torch/core/dispatch.py, telemetry/observatory.py).

Times loops of small wrapper ops on a few-row array, and optionally a
chain of eager ops on a 2^20 x 16 array (device time above host time, so
a host stall shows), Lasso fits and KMeans fits at chip_smoke.py's sizes
and a KMeans prediction of four rows, in three modes taken in turns
within one process: key counting off; counting on with the observatory
disarmed; counting on with the observatory armed at the default fenced
period (``HEAT_TPU_PERF_SYNC_EVERY``).  ``HEAT_TPU_DISPATCH_CACHE`` is
read at import, so the script flips the module's switch between rounds.
An op on a 4 x 16 array moves almost no data: its time is the host's,
which is what counting and noting add to.

    python3 scripts/torch_dispatch_overhead.py                 # on the card
    python3 scripts/torch_dispatch_overhead.py --fit --chain --lasso
    python3 scripts/torch_dispatch_overhead.py --device cpu --ops 2000

Prints the card's name and power limit, one JSON line per round, and a
summary JSON line (also written to ``--out`` when given).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


#: mode -> (key counting, observatory armed)
MODES = {"off": (False, False), "counting": (True, False), "armed": (True, True)}


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _set_mode(mode: str) -> None:
    from heat_tpu_torch.core import dispatch
    from heat_tpu_torch.telemetry import observatory

    dispatch._CACHE_ENABLED, armed = MODES[mode]
    observatory.set_enabled(armed)


def _medians(samples: dict) -> dict:
    """Each mode's median, and what counting and the observatory add."""
    med = {m: statistics.median(v) for m, v in samples.items() if v}
    out = {f"{m}_median": v for m, v in med.items()}
    if len(med) == len(MODES):
        out["counting_added"] = med["counting"] - med["off"]
        out["observatory_added"] = med["armed"] - med["counting"]
    return dict(out, **samples)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ops", type=int, default=10000, help="applications per op and round")
    ap.add_argument("--rounds", type=int, default=9, help="rounds, the three modes in turns")
    ap.add_argument("--fit", action="store_true",
                    help="also time KMeans fits at chip_smoke.py's size and predictions of four rows")
    ap.add_argument("--chain", action="store_true",
                    help="also time a chain of eager ops on a 2^20 x 16 array (y = y * 0.5 + b)")
    ap.add_argument("--lasso", action="store_true", help="also time Lasso fits at chip_smoke.py's size")
    ap.add_argument("--out", default="", help="write the summary JSON here too")
    args = ap.parse_args()

    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.telemetry import observatory

    card = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_dispatch_overhead: no CUDA device", file=sys.stderr)
            return 2
        torch.cuda.set_device(0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        ht.use_device("gpu")
    else:
        ht.use_device("cpu")
    print(card, flush=True)

    rng = np.random.default_rng(0)
    a = ht.array(rng.random((4, 16), dtype=np.float32), split=0)
    b = ht.array(rng.random((4, 16), dtype=np.float32), split=0)
    ops = {
        "add": lambda: ht.add(a, b),
        "mul_scalar": lambda: a * 2.0,
        "sum_axis0": lambda: ht.sum(a, axis=0),
        "argmax_axis1": lambda: ht.argmax(a, axis=1),
        "exp": lambda: ht.exp(a),
    }
    # the process's first application of each op (lazy loads on the card)
    first_ms = {}
    for name, fn in ops.items():
        _sync(torch, args.device)
        t0 = time.perf_counter()
        fn()
        _sync(torch, args.device)
        first_ms[name] = (time.perf_counter() - t0) * 1e3

    modes = list(MODES)
    per_op = {name: {m: [] for m in modes} for name in ops}
    for r in range(args.rounds):
        mode = modes[r % len(modes)]
        _set_mode(mode)
        for name, fn in ops.items():
            for _ in range(50):
                fn()
            _sync(torch, args.device)
            t0 = time.perf_counter()
            for _ in range(args.ops):
                fn()
            _sync(torch, args.device)
            per_op[name][mode].append((time.perf_counter() - t0) / args.ops * 1e6)
        print(json.dumps({"round": r, "mode": mode, "us_per_op": {n: v[mode][-1] for n, v in per_op.items()},
                          "card": card}), flush=True)
    _set_mode("armed")

    summary = {"device": args.device, "card": card, "ops_per_round": args.ops, "rounds": args.rounds,
               "modes": {m: {"key_counting": c, "observatory": o} for m, (c, o) in MODES.items()},
               "sync_every": observatory.sync_every(), "first_application_ms": first_ms,
               "us_per_op": {name: _medians(v) for name, v in per_op.items()}}

    if args.chain:
        big_rng = np.random.default_rng(1)
        y0 = ht.array(big_rng.random((1 << 20, 16), dtype=np.float32), split=0)
        c = ht.array(big_rng.random((1 << 20, 16), dtype=np.float32), split=0)
        steps = 500
        chain = {m: [] for m in modes}
        for r in range(args.rounds + 1):  # the first round warms the ops: not kept
            mode = modes[r % len(modes)]
            _set_mode(mode)
            y = y0
            _sync(torch, args.device)
            t0 = time.perf_counter()
            for _ in range(steps):
                y = y * 0.5 + c
            _sync(torch, args.device)
            if r:
                chain[mode].append((time.perf_counter() - t0) / (2 * steps) * 1e6)
        _set_mode("armed")
        summary["chain_us_per_op"] = dict(_medians(chain), shape=[1 << 20, 16], ops_a_round=2 * steps)

    if args.lasso:
        import chip_smoke as cs

        gen = torch.Generator(device=args.device).manual_seed(cs.SEED + 5)
        w = torch.randn(cs.FEATURES, device=args.device, generator=gen)
        w[::4] = 0.0
        xl = torch.randn(cs.LASSO_ROWS, cs.FEATURES, device=args.device, generator=gen)
        yl = xl @ w + 0.5 + 0.01 * torch.randn(cs.LASSO_ROWS, device=args.device, generator=gen)
        XL, YL = ht.array(xl, split=0), ht.array(yl, split=0)
        lasso = {m: [] for m in modes}
        for r in range(2 * len(modes) + 1):  # the first fit loads the ops: not kept
            mode = modes[r % len(modes)]
            _set_mode(mode)
            _sync(torch, args.device)
            t0 = time.perf_counter()
            ht.regression.Lasso(lam=0.01).fit(XL, YL)
            _sync(torch, args.device)
            if r:
                lasso[mode].append((time.perf_counter() - t0) * 1e3)
        _set_mode("armed")
        summary["lasso_fit_ms"] = dict(_medians(lasso), rows=cs.LASSO_ROWS, features=cs.FEATURES)
        del XL, YL, xl, yl

    if args.fit:
        import chip_smoke as cs

        dev = torch.device(args.device)
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        truth = torch.randn(cs.CLUSTERS, cs.FEATURES, device=dev, generator=g) * 10.0
        member = torch.randint(0, cs.CLUSTERS, (cs.ROWS,), device=dev, generator=g)
        x = torch.randn(cs.ROWS, cs.FEATURES, device=dev, generator=g)
        x += truth[member]
        del member
        pts = ht.array(x, split=0)
        fits = {m: [] for m in modes}
        for r in range(2 * len(modes) + 1):  # the first fit builds and loads K1: not kept
            mode = modes[r % len(modes)]
            _set_mode(mode)
            _sync(torch, args.device)
            t0 = time.perf_counter()
            km = ht.cluster.KMeans(n_clusters=cs.CLUSTERS, init="random", random_state=cs.SEED,
                                   max_iter=cs.MAX_ITER).fit(pts)
            _sync(torch, args.device)
            if r:
                fits[mode].append((time.perf_counter() - t0) * 1e3)
        # predicting a few rows (PERF.md's end-to-end metric that host time
        # per op rules), the modes in turns
        few = ht.array(x[:4].clone(), split=0)
        predict = {m: [] for m in modes}
        for r in range(args.rounds):
            mode = modes[r % len(modes)]
            _set_mode(mode)
            for _ in range(20):
                km.predict(few)
            _sync(torch, args.device)
            t0 = time.perf_counter()
            for _ in range(1000):
                km.predict(few)
            _sync(torch, args.device)
            predict[mode].append((time.perf_counter() - t0) / 1000 * 1e6)
        _set_mode("armed")
        summary["fit_ms"] = dict(_medians(fits), n_iter=km.n_iter_)
        summary["predict_4_rows_us"] = _medians(predict)

    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
