"""Host cost of the port's dispatch-key counting (heat_tpu_torch/core/dispatch.py).

Times loops of small wrapper ops on a few-row array, and optionally a
KMeans fit at chip_smoke.py's size and its prediction of four rows, with
key counting on and off in turns within one process
(``HEAT_TPU_DISPATCH_CACHE`` is read at import, so the script flips the
module's switch between rounds).  An op on a 4 x 16
array moves almost no data: its time is the host's, which is what the
counting adds to.

    python3 scripts/torch_dispatch_overhead.py                 # on the card
    python3 scripts/torch_dispatch_overhead.py --fit           # and the fit
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


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ops", type=int, default=10000, help="applications per op and round")
    ap.add_argument("--rounds", type=int, default=6, help="rounds, counting on and off in turns")
    ap.add_argument("--fit", action="store_true",
                    help="also time KMeans fits at chip_smoke.py's size and predictions of four rows")
    ap.add_argument("--out", default="", help="write the summary JSON here too")
    args = ap.parse_args()

    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import dispatch

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

    per_op = {name: {"on": [], "off": []} for name in ops}
    for r in range(args.rounds):
        on = r % 2 == 0
        dispatch._CACHE_ENABLED = on
        for name, fn in ops.items():
            for _ in range(50):
                fn()
            _sync(torch, args.device)
            t0 = time.perf_counter()
            for _ in range(args.ops):
                fn()
            _sync(torch, args.device)
            per_op[name]["on" if on else "off"].append((time.perf_counter() - t0) / args.ops * 1e6)
        print(json.dumps({"round": r, "key_counting": on,
                          "us_per_op": {n: v["on" if on else "off"][-1] for n, v in per_op.items()},
                          "card": card}), flush=True)
    dispatch._CACHE_ENABLED = True

    summary = {"device": args.device, "card": card, "ops_per_round": args.ops, "rounds": args.rounds,
               "first_application_ms": first_ms, "us_per_op": {}}
    for name, v in per_op.items():
        on, off = statistics.median(v["on"]), statistics.median(v["off"])
        summary["us_per_op"][name] = {"on_median": on, "off_median": off, "added": on - off,
                                      "on": v["on"], "off": v["off"]}

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
        fits = []
        for r in range(5):  # the first fit builds and loads K1: not kept
            on = r % 2 == 1
            dispatch._CACHE_ENABLED = on
            _sync(torch, args.device)
            t0 = time.perf_counter()
            km = ht.cluster.KMeans(n_clusters=cs.CLUSTERS, init="random", random_state=cs.SEED,
                                   max_iter=cs.MAX_ITER).fit(pts)
            _sync(torch, args.device)
            fits.append({"key_counting": on, "fit_ms": (time.perf_counter() - t0) * 1e3, "n_iter": km.n_iter_})
        # predicting a few rows (PERF.md's end-to-end metric that host time
        # per op rules), counting on and off in turns
        few = ht.array(x[:4].clone(), split=0)
        predict = {"on": [], "off": []}
        for r in range(args.rounds):
            on = r % 2 == 0
            dispatch._CACHE_ENABLED = on
            for _ in range(20):
                km.predict(few)
            _sync(torch, args.device)
            t0 = time.perf_counter()
            for _ in range(1000):
                km.predict(few)
            _sync(torch, args.device)
            predict["on" if on else "off"].append((time.perf_counter() - t0) / 1000 * 1e6)
        dispatch._CACHE_ENABLED = True
        summary["fits"] = fits[1:]
        summary["fit_first_ms"] = fits[0]["fit_ms"]
        summary["predict_4_rows_us"] = {"on_median": statistics.median(predict["on"]),
                                        "off_median": statistics.median(predict["off"]), **predict}

    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
