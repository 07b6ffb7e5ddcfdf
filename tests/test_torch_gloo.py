"""The port in a world of 3 CPU ranks (torch.distributed, gloo) against
heat_tpu on a 3-device Communication: the canonical layout of an uneven
split and the distributed KMeans fit and predict.

The ranks are separate processes that meet through a file store under the
test's temporary directory (no TCP port).  The test waits at most 60 s for
them, then kills them and fails."""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import heat_tpu as hj

pytestmark = pytest.mark.multiprocess

WORLD = 3
DEADLINE_S = 60.0
REPO = Path(__file__).resolve().parents[1]

_RANK_MAIN = r"""
import sys
import numpy as np
import torch.distributed as dist

rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, world_size=3, rank=rank)
import heat_tpu_torch as ht

ht.use_device("cpu")
arrays = np.load(data)
x = ht.array(arrays["x"], split=0)
km = ht.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(x)
np.savez(
    out,
    lshape_map=x.lshape_map,
    lshape=np.asarray(x.lshape),
    centers=km.cluster_centers_.numpy(),
    labels=km.labels_.numpy(),
    inertia=np.asarray(km.inertia_),
    n_iter=np.asarray(km.n_iter_),
    predict=km.predict(ht.array(arrays["fresh"], split=0)).numpy(),
)
dist.destroy_process_group()
"""


def _blobs(n, f, k, seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, f)) * 6.0
    return (centres[rng.integers(0, k, n)] + rng.standard_normal((n, f))).astype(np.float32)


def _run_world(tmp_path, x, fresh):
    data = tmp_path / "data.npz"
    np.savez(data, x=x, fresh=fresh)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = []
    for r in range(WORLD):
        cmd = [sys.executable, "-c", _RANK_MAIN, str(r), str(tmp_path / "store"), str(data), str(tmp_path / f"rank{r}.npz")]
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        pytest.fail(f"the gloo world of {WORLD} did not finish within {DEADLINE_S} s")
    finally:
        for p, log in procs:
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]


def test_kmeans_in_a_gloo_world_of_three(tmp_path):
    x = _blobs(1003, 16, 8, 0)  # 1003 = 3 * 335 - 2: rank 2 holds padding
    fresh = _blobs(301, 16, 8, 9)
    ranks = _run_world(tmp_path, x, fresh)

    ref_comm = hj.Communication(jax.devices()[:WORLD])
    ref_x = hj.array(x, split=0, comm=ref_comm)
    ref = hj.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(ref_x)
    want_predict = ref.predict(hj.array(fresh, split=0, comm=ref_comm)).numpy()
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["lshape_map"], ref_x.lshape_map)
        assert tuple(got["lshape"]) == tuple(ref_comm.chunk(x.shape, 0, rank=r)[1])
        assert int(got["n_iter"]) == ref.n_iter_
        np.testing.assert_allclose(got["centers"], ref.cluster_centers_.numpy(), atol=5e-5)
        np.testing.assert_array_equal(got["labels"], ref.labels_.numpy())
        np.testing.assert_allclose(float(got["inertia"]), ref.inertia_, rtol=1e-4)
        np.testing.assert_array_equal(got["predict"], want_predict)
