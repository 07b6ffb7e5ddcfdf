#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --kmeans-only`` stops after phase 6b, before the
summary and the last line: a quicker probe of the KMeans path alone.)

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; without a CUDA card, or without the package beside this
file, it exits non-zero before printing any result):

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: every CUDA source under heat_tpu_torch/csrc, one nvcc each, at once
   (lloyd_phases.cu is K1 with its clock64() stamps compiled in);
   ptxas's registers and spills of the six tensor-core kernels (lloyd,
   syrk, fft_stage, fft_axis, flash_attn, flash_attn_bwd) and their count
   of HMMA (mma.sync) and HGMMA (wgmma) instructions in the built SASS
   (where the toolkit has cuobjdump; none fails the run);
3a. kernel_check (float64): K1's float64 walk route against its plain
   version at 2^27 x 16 float64 points (17.2 GB), k = 8, and at ragged
   shapes: labels bitwise, counts exact, sums and inertia within 1e-12
   relative, a bitwise repeat, the mixes and shapes it must refuse, and its
   time beside its bound (one read of x, 5.13 ms) and the float32 walk
   route's in the same run;
4a. main_path_f64: KMeans(n_clusters=8, init="random", max_iter=30).fit on
   those float64 blobs through the entry point: K1 n_iter + 1 launches,
   labels equal to the plain version's, three predicts (1, 64, 4096 rows),
   the peak memory; the float64 data is then freed;
3. rng, threefry_check, kernel_check and lloyd_phases: seeded draws on the
   card bitwise equal to the host's; the threefry kernel bitwise equal to
   the plain hash (both words and the float32 uniform) at n = 1, 65539 and
   2^27 and at counters past 2^32, timed beside its bound; the Lloyd
   kernel (K1) against its plain PyTorch version on the card, by both its
   routes (tc, walk) at the KMeans path's shape (2^27 x 16 float32 points,
   k = 8) and at ragged shapes, plus a bitwise repeat, and the shapes its
   tc route refuses; K1's stamped build by each route at the path's shape,
   each phase's share of the cycles;
4. main_path: KMeans(n_clusters=8, init="random", max_iter=30).fit on 2^27
   x 16 Gaussian blobs made on the card from a seeded torch.Generator, the
   launch counts of that fit (K1 and the random init's threefry), a check
   of its labels and inertia against the plain version and of its labels
   against the walk route's, and three predict requests (1, 64, 4096 rows);
5. profile: the same fit again under torch.profiler: the device's busy and
   idle share of the fit's wall time and the kernels that took the most;
6. times: the Lloyd kernel's time per launch (CUDA events, after warm-up),
   the walk route's, its plain version's, and the least time the card
   could take (the bound);
6a. rng_draws: every seeded draw beyond rand and randn (randint and its
   aliases at int64 and int32 edge ranges, uniform, random_sample,
   permutation, randperm, shuffle, choice's four branches, bytes) on the
   card bitwise equal to the host's draw at 2^20, with the threefry
   launches each made; randint, uniform and permutation at 2^27, the host
   redrawing the first 2^20 values and the permutation checked to be one,
   each with its wall time and launches beside its bound;
6b. kmeanspp: kmeans++ on 2^20 x 16 blobs on the card against the CPU path,
   round by round (a differing pick passes only where u lies within 1e-6
   of the cumulative boundary between the two rows; every such case is
   printed), then KMeans(init="kmeans++").fit at the main path's size
   through the entry point: K1 n_iter + 1 and threefry 9 launches, labels
   against the plain version and the walk route, three predicts, the peak
   memory, and the init alone: its centres the rows its draws pick,
   distinct, in every run, its wall time beside its bound and its profile.

6c. array_runtime: the tutorials' calls on the float32 points (x[5],
   x[:, 3], x[::2], a mask, 2^20 random rows and a write through them,
   resplit(1), resplit(None), resplit(0), astype to each of the 15 types and
   back, eye(2^15), linspace(0, 1, 2^27), full, meshgrid, print, allclose,
   all), each with its wall time and checked against the CPU's result on
   the first 2^20 rows; the print equal to numpy's string of the edge rows
   with only those bytes copied to the host.
6d. ops: the NumPy surface on the same points.  A user's
   standardize-then-cluster path: (x - mean(x, 0)) / std(x, 0) within
   1e-5 of float64, KMeans(n_clusters=8).fit on it (K1 n_iter + 1 launches,
   counted into lloyd_step's; labels against the plain version by the
   near-tie rule, inertia within 1e-4), predict and bincount of the labels
   (equal to torch.bincount); then exp, log, sqrt, sin, tanh (rtol 3e-5,
   atol 1e-6 of float64), abs, floor, round(x, 2), clip, % and // 0.5, diff
   (bitwise the CPU's on the first 2^20 rows), cumsum along both axes,
   prod, var and std (within stated bounds of float64, bitwise in a second
   run), argmax/argmin (equal to the plain argument), histogram of a column
   (counts equal to the plain binning), cov, dot, outer, tril/triu of
   2^15 x 2^15, the norms, redistribute_ and balance_; each call's first
   and warm wall time beside its byte bound, and the peak memory.

6e. manipulations: on the same points, ``sort`` of 2^26 x 16 along axis 0
   and of a 2^27 column with NaNs and zeros of both signs (bitwise
   ``torch.sort(stable=True)``), ``percentile`` and ``median(x, axis=0)`` of
   2^31 elements (bitwise ``torch.kthvalue``'s order statistics),
   ``topk``, ``unique`` of the fit's labels, ``reshape``, ``concatenate``,
   ``pad``, ``roll``, ``flip`` (each bitwise its torch counterpart) and
   three scalers (against float64), each call's first and warm wall time
   beside its byte bound;
6f. io: 2^24 x 16 (1 GiB) through .npy (and HDF5 where h5py is installed)
   and 2^20 x 4 through CSV, round trips bitwise, sidecars verified.
6g. ml_rest: GaussianNB (fit, partial_fit in two halves, predict,
   predict_proba) and BatchParallelKMeans(8) on the points and their true
   labels, BatchParallelKMedians on the first 2^24 rows, Lasso(lam=0.01) on
   the first 2^25 rows (y = x w + 0.5 + noise; its sweeps and host syncs),
   Spectral(8, gamma=0.5, n_lanczos=300) on 2^15 of the points scaled by
   1/8 (K1 n_iter + 1 and threefry launches, device time by step), each
   call's first and warm wall time beside its byte bound, each estimator
   also fitted on a head on the card and on the host, the phase's peak
   memory under 60 GB;
6h. napi_signal: a sweep of napi's exports on the points or one of their
   columns (first and warm wall time beside the byte bound; the card's
   result at 2^16 rows against the host's), then convolve of a 2^27
   float32 signal with a 1025-tap kernel in the three modes within 1e-5 of
   float64 (and, beside it, with cuDNN's TF32 allowed).
6i. faults_f17_f23: the calls of the repaired faults F17-F23 on the card
   at 2^27 values an operand (float16 bin edges, unsigned results and
   orderings, unsigned products, complex nanmax/fmin/histogram/logaddexp2,
   ml_dtypes bfloat16 arrays), each bitwise the port's answer on the host
   (complex logaddexp2 within 1e-5), each call's first and warm wall time
   beside its byte bound; the refusals raising the host's exception types;
6j. resilience: KMeans(8, init="random").fit on the points inside
   telemetry spans under torch.profiler (the spans in the ring, their
   record_function labels in the profile, K1 n_iter + 1 and threefry 1
   launches, counted into the kernel summary); a 1 GiB .npy save and load
   each failing once by an injected transient fault and retried, read back
   bitwise; the ring SpGEMM of 2^20 x 2^20 (16 a row) aborted by an
   injected comm.collective fault, then retried by a RetryPolicy to the
   unfaulted product bitwise; guard_finite on the points and on a copy
   with one NaN (DivergenceError).

The KMeans data is then freed, and the hierarchical SVD path follows on a
2^25 x 128 float32 matrix with a decaying spectrum, made on the card:

7. gram_check: the Gram kernel against its plain version at that shape, at
   ragged ones (padding poisoned) and at 2^22 x 128 of mean 10 (uncentred,
   the stress case of its tensor-core chains), exact symmetry, a bitwise
   repeat, and the inputs it must refuse;
8. hsvd: hsvd_rank (rank 10) and hsvd_rtol (1e-2) through the entry points
   a user calls, one Gram launch per call, singular values, orthonormal U
   and the error estimate against the plain version's;
9. pca: PCA(n_components=10, svd_solver="hierarchical").fit and transforms
   of 1, 64 and 4096 rows, checked against the float64 projection;
9a. rsvd: linalg.rsvd(A, 10) with power_iter 0 and 1 through the entry
   point: one threefry launch a call (the Gaussian test matrix) and no
   other kernel, S within rtol 1e-4 of the plain spectrum, U orthonormal
   within 1e-4, the first and a warm call's wall time beside the byte bound (A read 2 (1 +
   power_iter) times, U written once), and a profile split between the
   range products (A Omega), the Gram orthonormalizations, Q^T A and the
   small SVD;
9b. pca_randomized: PCA(n_components=10, svd_solver="randomized",
   random_state=0).fit (one threefry launch), transforms of 1, 64 and 4096
   rows against the float64 projection, and the largest principal angle
   between its components and the hierarchical fit's, within 4 sigma_21 /
   sigma_10 (the randomized range's error without power iterations) plus
   the Gram kernel's tolerated error over the spectral gap;
10. hsvd_profile: the hsvd_rank call under torch.profiler;
11. times: the Gram kernel beside its plain version, the library's
    ``x.T @ x`` (cuBLAS, full float32), its bound, its 3xTF32 floor and its
    CUDA-core floor.

The hSVD data is then freed, and the FFT path follows at the JAX package's
config-5 size (a real 512^3 float32 cube, split=0), on data made on the card:

12. fft_check: each FFT kernel -- K3 (the two-plane stage, blocked form),
    K4 (the cat-layout pair stage, as entry and as stage), K5 (the combine
    plus Hermitian extension) and K6 (the fused last-axis pass) -- against
    its plain version at the main path's shapes and at ragged ones (K and
    n not multiples of 8, n = 1, M one past a tile, operands only 4-byte
    aligned, complex64 views, cat operands whose row tiles straddle blocks,
    element stride 2 through the C entry; K6 at n1 = 6, 127, 125, 128)
    (relative error at most 1e-5), a bitwise repeat, the inputs each must
    refuse, and each kernel's time beside its plain version's, its bound
    (bf16x3 at 989 TFLOP/s, as the TPU kernels count), its 3xTF32 floor
    (three TF32 products at 495 TFLOP/s), its CUDA-core floor and
    ``torch.fft``'s time on the same data;
13. fftn: ht.fft.fftn of the cube, fftn and ifftn of its spectrum, through
    the entry points a user calls: K3 and K5 once, K4 three times a complex
    transform, against torch.fft in complex128, Parseval and the round trip;
14. fft2_fft: ht.fft.fft2 of a real 8192^2 image (one K4 launch) and
    ht.fft.fft of (2^19, 1024) complex64 signals (one K6 launch);
15. fft_profile: the real and the complex fftn under torch.profiler;
16. fft_times: the whole path against torch.fft.fftn on the same inputs.

The FFT data is then freed, and the attention path follows at the JAX
package's long-context configuration (benchmarks/cb/attention.py at scale 1:
seq 16384, 8 heads of 64, float32, causal):

17. attn_check: the flash-attention kernel K7 against its plain version at
    that shape, at ragged ones and at (4096, 4, 64) with q scaled by 8 (a
    peaked softmax, the stress case of its tensor-core chains) (relative
    error at most 1e-5), a bitwise repeat, the inputs it must refuse, and
    its time beside its plain version's, its bound, its 3xTF32 floor, the
    CUDA cores' floor and
    ``torch.nn.functional.scaled_dot_product_attention``'s;
18. attention: q, k and v from ht.random.randn on the card (the first
    2^20 values of each against the same draws on the host, at most 4 ulp
    apart), then
    ht.nn.scaled_dot_product_attention through the entry point a user calls:
    "flash" on split=0 and on split=None (K7 once each), "ring" and
    "ulysses" (no K7), each against float64 attention computed head by head
    (max abs error at most 1e-4), with its wall time;
19. attn_profile: the split=0 flash call under torch.profiler.

Then the training path, first at the same attention configuration:

20. flash_bwd_check: the backward kernels of flash attention (K7-bwd,
    csrc/flash_attn_bwd.cu: di, then dK/dV and dQ by each route -- tc, the
    tensor cores in 3xTF32 after a pre-pass that splits q, k, v and do into
    TF32 planes, for d <= 64; cuda_core, exact f32 FMAs, for any d) against
    their plain versions on the same inputs (the forward kernel's output
    and log-sum-exp) at that shape and at ragged ones (s = 1, 63, 65, 129,
    1000; d = 16, 33, 64, 100, 128, 256; n_true < s; causal and not;
    strided q, k, v; a stride-0 do), every route at every shape it takes
    (max abs error over max abs, over the three gradients, at most 5e-5),
    bitwise repeats, the pre-pass bitwise equal to its plain version, the
    gradient at (4096, 4, 64), q as drawn and scaled by 8, through the
    autograd Function and through each route within 1e-4 of float64, the
    inputs it must refuse, and each kernel's time beside its plain
    version's, its bound (bf16 at 989 TFLOP/s, as the TPU kernels count),
    its 3xTF32 and CUDA-core floors, the other route's time in the same run
    (timed in turns; the tc route's pre-pass, dkv and dq must beat the
    cuda_core route's dkv and dq), and the time of the backward of
    ``torch.nn.functional.scaled_dot_product_attention``;
21. train_attention: a user module (x of (16384, 512) -> q, k, v
    projections -> ulysses_attention(use_flash=True, causal=True) -> output
    projection, MSE loss) in ht.nn.DataParallel with ht.optim.Adam: the
    first step's parameter gradients against the same step through the
    plain forward and backward on the card (max abs error over max abs,
    over all parameters together, at most 1e-4), then 3 steps, K7 once
    and di, the pre-pass and the tc route's dkv and dq once a step (the
    cuda_core route never), the loss falling, the wall time per step;
22. train_cnn: BASELINE config 4 (benchmarks/cb/nn.py): the MNIST CNN on
    synthetic_mnist(2048), batch 128, Adam(1e-3), softmax cross-entropy:
    the first step's loss against the same step on the CPU from the same
    parameters (within 1e-5), then an epoch of 16 steps, steps/s, the loss
    falling.

The training data is then freed, and the distances path follows (no
kernel of the port: plain torch, cuBLAS for the cross terms):

23. distances: cdist (direct and expanded), manhattan and rbf of 2^16 x 16
    against 2^14 x 16 float32 points (4.3 GB results, the broadcast forms
    in blocks), cdist of 2^15 points with themselves, cdist_topk and
    KNeighborsClassifier(5) of 2^15 queries against 2^20 x 16 training
    rows from create_clusters (and one block of its merge: the int64-key
    selection beside a float32 topk and a stable sort), each with its
    first and warm wall time, its
    error against float64 truth on the card, the memory it took beyond
    its inputs and its bound (the result written once or its float32
    operations); KNN's accuracy and its votes against a float64 vote
    (every difference a near-tie of the k-th distance); KMedians and
    KMedoids (4 clusters, ++ inits) on benchmarks/cb/cluster.py's
    spherical data at 2^27 x 3 rows: fit wall time, n_iter_, host syncs
    per iteration and one update's wall time, one more KMedians update against each cluster's median
    by torch.sort, each medoid a member row least in city-block sum to its
    members' mean in float64; the norm_sym Laplacian of 2^15 spherical
    points (diagonal 1, symmetric within 1e-5); the phase's peak memory
    under 60 GB.

The distances data is then freed, and the linalg path follows (no kernel
of the port: the JAX package runs its linalg in plain XLA, the port in
cuSOLVER and cuBLAS through torch.linalg, IEEE float32 throughout):

24. linalg: qr, svd and PCA(n_components=10, svd_solver="full").fit of a
    2^22 x 128 float32 matrix (2 GiB); cholesky, det, slogdet, solve, inv
    and lanczos (m = 64) of an SPD 16384^2 float32 matrix (1 GiB,
    eigenvalues within 1 +- 0.1); cg on a backward-Euler step of the 1-D
    heat equation, (I + 3e4 L) x = b over 4096 points (condition number
    1.2e5: the reference's stop test holds for most of len(b) float32
    steps); each through the entry point a user calls, with its first and warm wall time beside its bound (bytes at the
    HBM rate or float32 operations on the CUDA cores), held within the
    reference tests' float32 bound of 1e-4 (tests/test_linalg.py:46, :113)
    on the card by a float64 residual (||QR - A|| / ||A||, the SVD's,
    ||L L^T - S|| / ||S||, ||S inv - I|| / ||I|| and lanczos' three-term
    recurrence in the Frobenius norm; Q^T Q, U^T U and V^T V against I;
    S against float64; solve's relative residual; cg's within float32
    CG's attainable sqrt(steps) u |A| |x| / |b|) and at a head size (4096
    rows, the leading 512^2 block) against the port on the CPU; log|det|
    (det and slogdet) within about three times what cuSOLVER's float32
    getrf reads on an H100 (4e-3 at 16384, 1.2e-3 at the head; the CPU's
    LAPACK within 1e-4), at the head also with its rows rolled by one
    (every pivot a row swap, the sign -1); MAGMA's getrf on the same
    matrices is timed and read beside it (a library reading only).

The linalg data is then freed, and the sparse layer follows (the JAX
package's runs in plain XLA and reaches no Pallas kernel; the port's
products run its CSR SpMM kernel, csrc/csr_spmm.cu, added because
cuSPARSE's SpMM is not bitwise repeatable on the card):

25. sparse_check: at 2^18 x 2^18, 16 entries a row drawn on the card,
    every op's indptr and indices bitwise scipy's on the host (stored
    zeros as the reference keeps them: a + (-a) keeps a's pattern), the
    element-wise values bitwise, the products and sums within 1e-5 of
    float64;
26. csr_spmm_check: the kernel against its plain version at the main
    path's shapes (2^24 rows, 2^28 entries, 32 columns and one) and at
    ragged ones (empty rows, rows past a warp, widths 3, 33, 65, float64,
    int32 and int64, a row stride past the width, accumulating), within
    1e-6 of the plain
    sum's largest magnitude (1e-14 in float64), bitwise repeats, the
    inputs it refuses, its time beside its plain version's, its bound and
    cuSPARSE's SpMM (``torch.sparse.mm``);
27. sparse: a graph of 2^24 nodes of degree 16 (A and B, 2^28 nnz, built
    by ``sparse_csr_matrix`` from torch sparse COO tensors on the card,
    split 0) and X of 2^24 x 32: construction, ``A @ X``, ``A @ x``,
    ``A + B``, ``A * B``, ``A * 2.0``, ``A + 1.0``, the three sums, ``A.T
    @ X``, ``X.T @ A``, ``to_sparse_csc``, ``todense`` of 2^15 x 2^15, the
    ring SpGEMM of a 2^20 x 2^20 matrix with itself and the dense-route
    SpGEMM of 4096 x 4096 at density 0.05; each call's first and warm
    wall time, its extra memory and its byte bound, both runs bitwise
    equal; 4096 sampled rows and columns of each result against the host
    (element-wise ops bitwise scipy's, products and sums within 1e-5 of
    float64), the kernel's launches on the path, the phase's peak under
    60 GB.

The line before the last is the kernel summary, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROWS = 1 << 27  # BASELINE config 2's 10^9 rows cut to fit one card and the run's time
FEATURES = 16
CLUSTERS = 8
MAX_ITER = 30
SEED = 0
# BASELINE config 3's ~3.9e8 rows of 128 columns (200 GB) cut to fit one card
# with PCA's centred copy; width and rank are the JAX package's own benchmark's
HSVD_ROWS = 1 << 25
HSVD_COLS = 128
HSVD_RANK = 10
# published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside the
# tensor cores, bf16 FLOP/s on the tensor cores (dense)
# the FFT path: BASELINE config 5 and the JAX package's own config-5 benchmark
FFT_N = 512
FFT2_N = 8192
FFT1_ROWS = 1 << 19
FFT1_N = 1024
# the attention path: benchmarks/cb/attention.py:13-17 at scale 1
ATTN_SEQ = 16384
ATTN_HEADS = 8
ATTN_HEAD_DIM = 64
ATTN_SEED = 7
ATTN_HOST_DRAWS = 1 << 20  # values of each draw redrawn on the host to check the card's
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# no 32-bit lane operation runs faster than the f32 lanes' 128 a clock an SM
# (the table's f32 rate counts an FMA as two): the integer hash's ceiling
INT32_OPS = F32_FLOPS / 2
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores: the floor of a 3xTF32 product is 3 flops / this


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


def wall_ms(fn) -> tuple:
    """``(fn's result, its wall time in ms up to a synchronise)``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_fit(fit, top_n: int = 6, labels=()) -> dict:
    """Run ``fit`` under torch.profiler: its wall time, the device time of
    every kernel it launched (one stream, so the sum is the busy time), and
    the kernels that took the most; with profiler ``labels``, also the
    device time of the kernels launched under each label."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms_ = wall_ms(fit)
    by_name: dict = {}
    by_label = {label: 0.0 for label in labels}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name in by_label:
                by_label[e.name] += e.device_time_total / 1e3
            continue
        if e.name in by_label:  # a label's own range on the device is no kernel
            continue
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    out = {"fit_wall_ms": wall_ms_, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms_,
           "top_kernels": [{"name": n[:80], "ms": ms, "calls": c} for n, (ms, c) in top]}
    if labels:
        out["device_ms_by_step"] = by_label
    return out


def compare_lloyd(x, c, n_true: int, route=None) -> dict:
    """The Lloyd kernel, by the route its wrapper picks or by ``route``,
    against its plain version on the same inputs: centres atol 1e-4, counts
    exact (up to near-tie relabels), inertia rtol 1e-4, labels equal but at
    near-ties (at most 1e-6 of the rows), and a second launch bitwise equal
    to the first."""
    import torch
    from heat_tpu_torch.core import kernels

    if route is None:
        route = kernels.lloyd_route(x.shape[1], c.shape[0], x.data_ptr() % 16 == 0)
        launch = lambda: kernels.lloyd_partials(x, c, n_true, labels=True)  # noqa: E731
    else:
        launch = lambda: kernels._lloyd_cuda(x, c, n_true, True, route)  # noqa: E731
    got = launch()
    again = launch()
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
    return {"route": route, "rows": x.shape[0], "f": x.shape[1], "k": c.shape[0], "n_true": n_true, "max_abs_err": err,
            "inertia_rel_err": rel, "label_mismatches": mism, "bitwise_repeat": True}


def lloyd_phases(x, c, n_true: int, route: str, smi: str) -> dict:
    """Phase lloyd_phases: K1's stamped build (csrc/lloyd_phases.cu) by
    ``route`` on the main path's inputs, each phase's share of the grid's
    thread-cycles over three launches (after one to warm up), and the
    stamped step's time beside the unstamped one's."""
    from heat_tpu_torch.core import kernels

    kernels.lloyd_phase_cycles(x, c, n_true, route)
    total = dict.fromkeys(kernels.LLOYD_PHASES[route], 0)
    for _ in range(3):
        for name, cyc in kernels.lloyd_phase_cycles(x, c, n_true, route).items():
            total[name] += cyc
    whole = sum(total.values())
    import torch

    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    line = {"phase": "lloyd_phases", "route": route, "rows": x.shape[0], "f": x.shape[1], "k": c.shape[0],
            "blocks_per_sm": kernels._resident_blocks(x.device, x.shape[1], c.shape[0], route) // sms,
            "shares": {name: cyc / whole for name, cyc in total.items()},
            "thread_cycles_per_launch": whole / 3,
            "stamped_ms": time_ms(lambda: kernels.lloyd_phase_cycles(x, c, n_true, route), reps=5),
            "ms": time_ms(lambda: kernels._lloyd_cuda(x, c, n_true, False, route), reps=5), "card": smi}
    emit(line)
    return line


# per counter: an add, a rotation and an xor in each of 20 rounds, the key
# additions (2 first, 2 after every fourth round), the mantissa (xor, shift, or)
THREEFRY_OPS = 20 * 3 + 2 + 5 * 2 + 3


def threefry_check(dev, smi: str) -> dict:
    """Phase threefry_check: the threefry kernel bitwise against the plain
    hash on the card -- both words and the float32 uniform -- at n = 1,
    65539 and 2^27 and at counters past 2^32 (where the high word is not
    zero), its time beside the plain version's and its bound.  Returns its
    entry of the summary line, launches still to fill in."""
    import torch
    from heat_tpu_torch.core import random as rnd

    key = (0x9E3779B9, 0x7F4A7C15)
    cases = []
    for n, start in ((1, 0), (65539, 0), (ROWS, 0), (70001, (1 << 32) - 35000), (4099, 3 * (1 << 32) + 7)):
        w0, w1 = rnd._threefry_cuda(key, n, dev, start, False)
        u = rnd._threefry_cuda(key, n, dev, start, True)
        p0, p1 = rnd._random_bits_plain(key, n, dev, start)
        pu = rnd._unit_f32_plain(p0, p1)
        torch.cuda.synchronize()
        if not (torch.equal(w0, p0) and torch.equal(w1, p1) and torch.equal(u.view(torch.int32), pu.view(torch.int32))):
            raise AssertionError(f"threefry at n={n}, start={start} differs from the plain hash")
        cases.append({"n": n, "start": start, "bitwise": True})
        del w0, w1, u, p0, p1, pu
    for c in cases:
        emit({"phase": "threefry_check", "kernel": "threefry", **c})
    refused = []
    for what, call in (("start < 0", lambda: rnd._threefry_cuda(key, 4, dev, -1, True)),
                       ("device meta", lambda: rnd._random_bits(key, 4, torch.device("meta")))):
        try:
            call()
        except ValueError:
            refused.append(what)
        else:
            raise AssertionError(f"the threefry kernel took {what}")
    kernel_ms = time_ms(lambda: rnd._threefry_cuda(key, ROWS, dev, 0, True), reps=10)
    plain_ms = time_ms(lambda: rnd._unit_f32_plain(*rnd._random_bits_plain(key, ROWS, dev)), reps=3, warmup=1)
    bound_ms = {"bytes": 4 * ROWS / HBM_BYTES_PER_S * 1e3, "operations": THREEFRY_OPS * ROWS / INT32_OPS * 1e3}
    bound_by = max(bound_ms, key=bound_ms.get)
    emit({"phase": "threefry_check", "kernel": "threefry", "n": ROWS, "output": "float32 uniform", "ms": kernel_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms[bound_by], "bound_by": bound_by,
          "share_of_bound": bound_ms[bound_by] / kernel_ms, "library_ms": None,
          "library_note": "no PyTorch call computes threefry (torch.rand is Philox)", "refused": refused,
          "card": smi})
    return {"name": "threefry", "route": "cuda", "source": "heat_tpu_torch/csrc/threefry.cu",
            "replaces": "heat_tpu/core/random.py:150", "note": "not a TPU kernel: XLA's threefry in the JAX package",
            "launches": None, "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms[bound_by], "bound_by": bound_by, "library_ms": None}


RNG_SMALL = 1 << 20  # draws compared whole between the card and the host
RNG_SEED = 11


def rng_draws(dev, smi: str) -> None:
    """Phase rng_draws: every seeded draw beyond rand and randn (randint, its
    aliases, uniform, random_sample, permutation, randperm, shuffle, choice's
    four branches, bytes) through the entry points on the card, bitwise
    equal to the host's draw of the same seed at 2^20, with the threefry
    launches each made; then randint, uniform and permutation at 2^27, the
    host redrawing the first 2^20 values (element i hashes counter i alone),
    the permutation checked to be one, each with its wall time and launches
    beside its bound."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import random as rnd

    t0 = time.perf_counter()
    n = RNG_SMALL
    pool = torch.randn(n, 3, generator=torch.Generator().manual_seed(RNG_SEED))
    p64 = torch.rand(n, generator=torch.Generator().manual_seed(RNG_SEED + 1), dtype=torch.float64)
    p64[::7] = 0.0
    p64 /= p64.sum()
    p32 = p64.float()

    def on(device):
        return dev if device == "gpu" else torch.device("cpu")

    def shuffled(device):
        x = ht.array(pool.to(on(device)), split=0, device=device)
        ht.random.shuffle(x)
        return x

    def random_bytes(device):
        ht.use_device(device)
        try:
            return torch.frombuffer(bytearray(ht.random.bytes(4099)), dtype=torch.uint8)
        finally:
            ht.use_device("gpu")

    rounds = rnd._shuffle_rounds(n)
    draws = [  # (name, draw on a device, threefry launches on the card)
        ("randint int64 [0, 3n)", lambda d: ht.random.randint(0, 3 * n, size=(n,), device=d), 2),
        ("randint int64 span 2^63 + 5", lambda d: ht.random.randint(-(2**62) - 3, 2**62 + 2, size=(n,), device=d), 2),
        ("randint int32 [-7, 2^31 - 1)", lambda d: ht.random.randint(-7, 2**31 - 1, size=(n,), dtype=ht.int32,
                                                                      device=d), 2),
        ("randint int32 [-2^31, 2^40)", lambda d: ht.random.randint(-(2**31), 2**40, size=(n,), dtype=ht.int32,
                                                                     device=d), 2),
        ("random_integers [-3, 3]", lambda d: ht.random.random_integers(-3, 3, size=(n,), device=d), 2),
        ("uniform float32 [-3.7, 11.2)", lambda d: ht.random.uniform(-3.7, 11.2, (n,), device=d), 1),
        ("uniform float64 [-3.7, 11.2)", lambda d: ht.random.uniform(-3.7, 11.2, (n,), dtype=ht.float64, device=d), 1),
        ("random_sample float64", lambda d: ht.random.random_sample((n,), dtype=ht.float64, device=d), 1),
        ("permutation(n)", lambda d: ht.random.permutation(n, device=d), rounds),
        ("randperm(n) int32", lambda d: ht.random.randperm(n, dtype=ht.int32, device=d), rounds),
        ("permutation of (n, 3) split=0", lambda d: ht.random.permutation(ht.array(pool.to(on(d)), split=0, device=d)),
         rounds),
        ("shuffle of (n, 3) split=0", shuffled, rounds),
        ("choice, replace", lambda d: ht.random.choice(n, size=(4096,), device=d), 2),
        ("choice, no replace", lambda d: ht.random.choice(ht.array(pool.to(on(d)), device=d), size=(4096,), replace=False,
                                                          device=d), rounds),
        ("choice, p float64, replace", lambda d: ht.random.choice(n, size=(4096,), p=p64.to(on(d)), device=d), 1),
        ("choice, p float32, no replace (Gumbel)", lambda d: ht.random.choice(n, size=(4096,), replace=False,
                                                                               p=p32.to(on(d)), device=d), 1),
        ("bytes(4099)", random_bytes, 2),
    ]
    small = []
    for name, draw, want_launches in draws:
        ht.random.seed(RNG_SEED)
        rnd.THREEFRY_LAUNCHES = 0
        card = draw("gpu")
        launches = rnd.THREEFRY_LAUNCHES
        state = ht.random.get_state()
        ht.random.seed(RNG_SEED)
        host = draw("cpu")
        if isinstance(card, ht.DNDarray):
            if card.larray.device.type != "cuda":
                raise AssertionError(f"{name}: drawn on {card.larray.device}, not on the card")
            card, host = card.larray.cpu(), host.larray
        if launches != want_launches or rnd.THREEFRY_LAUNCHES != launches or ht.random.get_state() != state:
            raise AssertionError(f"{name}: {launches} threefry launches on the card ({want_launches} wanted), "
                                 f"{rnd.THREEFRY_LAUNCHES - launches} on the host")
        if card.dtype != host.dtype or card.shape != host.shape or not torch.equal(
                card.view(torch.uint8) if card.is_floating_point() else card,
                host.view(torch.uint8) if host.is_floating_point() else host):
            raise AssertionError(f"{name}: the card's draw differs from the host's")
        small.append({"draw": name, "n": card.numel(), "threefry_launches": launches, "bitwise": True})
    emit({"phase": "rng_draws", "size": n, "checks": small})

    big = []
    for name, draw, out_bytes, hashes, prefix in (
            ("randint int64 [0, 2^27)", lambda d, m: ht.random.randint(0, ROWS, size=(m,), device=d), 8, 2, True),
            ("randint int32 [-7, 2^31 - 1)", lambda d, m: ht.random.randint(-7, 2**31 - 1, size=(m,),
                                                                            dtype=ht.int32, device=d), 4, 2, True),
            ("uniform float32 [-3.7, 11.2)", lambda d, m: ht.random.uniform(-3.7, 11.2, (m,), device=d), 4, 1, True),
            ("permutation(2^27)", lambda d, m: ht.random.permutation(m, device=d), 8, rnd._shuffle_rounds(ROWS),
             False)):
        ht.random.seed(RNG_SEED)
        draw("gpu", ROWS)  # warm-up: the allocator's first growth
        ht.random.seed(RNG_SEED)
        rnd.THREEFRY_LAUNCHES = 0
        out, ms = wall_ms(lambda: draw("gpu", ROWS).larray)
        launches = rnd.THREEFRY_LAUNCHES
        if launches != hashes:
            raise AssertionError(f"{name} at 2^27: {launches} threefry launches, {hashes} wanted")
        if prefix:
            ht.random.seed(RNG_SEED)
            host = draw("cpu", n).larray
            head = out[:n].cpu()
            if not torch.equal(head.view(torch.uint8) if head.is_floating_point() else head,
                               host.view(torch.uint8) if host.is_floating_point() else host):
                raise AssertionError(f"{name} at 2^27: the first 2^20 values differ from the host's draw")
        else:
            if not torch.equal(torch.sort(out).values, torch.arange(ROWS, device=dev)):
                raise AssertionError("permutation(2^27) is not a permutation of range(2^27)")
        # each output written once; each hashed counter's 75 integer operations
        # (a sort's work depends on its algorithm: not counted)
        bound = {"bytes": out_bytes * ROWS / HBM_BYTES_PER_S * 1e3,
                 "operations": hashes * THREEFRY_OPS * ROWS / INT32_OPS * 1e3}
        bound_by = max(bound, key=bound.get)
        big.append({"draw": name, "n": ROWS, "wall_ms": ms, "threefry_launches": launches,
                    "bound_ms": bound[bound_by], "bound_by": bound_by, "share_of_bound": bound[bound_by] / ms,
                    "checked": "first 2^20 bitwise the host's" if prefix else "a permutation"})
        del out
    torch.cuda.empty_cache()
    emit({"phase": "rng_draws", "size": ROWS, "draws": big, "card": smi, "phase_seconds": time.perf_counter() - t0})


def kmeanspp_pick_check(dev, g, smi: str) -> dict:
    """Phase kmeanspp (first part): kmeans++ on 2^20 x 16 blobs on the card
    against the CPU path on a host copy, round by round: the host replays
    each round from the card's centres so far and must pick the card's row,
    unless u lies within 1e-6 (relative, in float64) of the cumulative
    boundary between the two picks (float32 cumulative sums resolve about
    6e-8 near 1, summed in other orders on the two devices)."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _kcluster

    t0 = time.perf_counter()
    n = RNG_SMALL
    truth = torch.randn(CLUSTERS, FEATURES, device=dev, generator=g) * 10.0
    xs = torch.randn(n, FEATURES, device=dev, generator=g)
    xs += truth[torch.randint(0, CLUSTERS, (n,), device=dev, generator=g)]
    card = ht.array(xs, split=0)
    host = ht.array(xs.cpu(), split=0, device="cpu")
    cases = []
    for seed in range(3):
        ht.random.seed(seed)
        first = int(ht.random.randint(0, n, size=(1,)).larray[0])
        us = [float(ht.random.rand(1).larray[0]) for _ in range(CLUSTERS - 1)]
        picks = _kcluster._kmeanspp_indices(card, first, us).cpu()
        local = host.larray
        x2 = (local * local).sum(1)
        d2 = torch.full_like(x2, float("inf"))
        for i, u in enumerate(us, 1):
            d2, mine = _kcluster._kmeanspp_round(host, x2, d2, picks[i - 1:i], u)
            a, b = sorted((int(mine), int(picks[i])))
            if a == b:
                continue
            xd = local.double()
            d64 = torch.stack([((xd - local[j].double()) ** 2).sum(1) for j in picks[:i].tolist()]).min(0).values
            cum = torch.cumsum(d64, 0) / d64.sum()
            gap = max(abs(float(cum[a]) - u), abs(float(cum[b - 1]) - u)) / u
            case = {"seed": seed, "round": i, "u": u, "host_pick": int(mine), "card_pick": int(picks[i]),
                    "cum_f64_at_lower": float(cum[a]), "cum_f64_before_upper": float(cum[b - 1]), "rel_gap": gap}
            print(json.dumps({"phase": "kmeanspp", "near_boundary_case": case}), flush=True)
            if gap > 1e-6:
                raise AssertionError(f"kmeans++ round {i} (seed {seed}): the card picked row {picks[i]}, the host "
                                     f"{int(mine)}, and u is {gap} (relative) from their boundary")
            cases.append(case)
    return {"rows": n, "seeds": 3, "rounds": 3 * (CLUSTERS - 1), "near_boundary_cases": len(cases),
            "seconds": time.perf_counter() - t0}


def kmeanspp_path(x, pts, check: dict, smi: str) -> dict:
    """Phase kmeanspp (second part): KMeans(init="kmeans++") through the
    entry point at full width, its launches (K1 n_iter + 1, threefry 9),
    labels against the plain version, three predicts; then the init alone,
    its centres distinct rows of x, its wall time beside its bound (x read
    once for |x|^2 and once a round) and its profile.  Returns the launches
    of the fit."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _kcluster
    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.core import random as rnd

    def model():
        return ht.cluster.KMeans(n_clusters=CLUSTERS, init="kmeans++", random_state=SEED, max_iter=MAX_ITER)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    km, fit_ms = wall_ms(lambda: model().fit(pts))
    launches = {"lloyd_step": kernels.LLOYD_LAUNCHES, "threefry": rnd.THREEFRY_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_iter, inertia = km.n_iter_, km.inertia_
    if launches != {"lloyd_step": n_iter + 1, "threefry": CLUSTERS + 1} or other_launches() != sum(launches.values()):
        raise AssertionError(f"the kmeans++ fit launched {launches} and {other_launches()} kernels in all; K1 "
                             f"{n_iter + 1} times, threefry {CLUSTERS + 1}")
    centres, labels = km.cluster_centers_.larray, km.labels_.larray
    if centres.shape != (CLUSTERS, FEATURES) or labels.shape != (ROWS,) or not bool(torch.isfinite(centres).all()):
        raise AssertionError("the kmeans++ fit's centres or labels have the wrong shape or are not finite")
    _, _, plain_inertia, plain_labels = kernels._lloyd_plain(x, centres, ROWS, True)
    relabelled = near_tie_mismatches(x, centres, labels, plain_labels)
    if not torch.equal(labels, kernels._lloyd_cuda(x, centres, ROWS, True, "walk")[3]):
        raise AssertionError("the kmeans++ fit's labels differ from the walk route's on the same centres")
    if abs(inertia - float(plain_inertia)) > 1e-4 * abs(float(plain_inertia)):
        raise AssertionError(f"kmeans++ fit inertia {inertia} against {float(plain_inertia)} from the plain version")
    del plain_labels
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    requests = []
    for size in (1, 64, 4096):
        rows = torch.randint(0, ROWS, (size,), generator=gen).to(x.device)
        pred, ms = wall_ms(lambda: km.predict(ht.array(x[rows], split=0)).larray)
        if not torch.equal(pred, labels[rows]):
            raise AssertionError(f"kmeans++ model: predict on {size} rows disagrees with labels_")
        requests.append({"rows": size, "wall_ms": ms})

    # the init alone: its centres are the rows the draws pick, distinct
    init = model()
    _, init_first_ms = wall_ms(lambda: init._initialize_cluster_centers(pts))
    _, init_ms = wall_ms(lambda: init._initialize_cluster_centers(pts))
    ht.random.seed(SEED)
    first = int(ht.random.randint(0, ROWS, size=(1,)).larray[0])
    idx = _kcluster._kmeanspp_indices(pts, first, [float(ht.random.rand(1).larray[0]) for _ in range(CLUSTERS - 1)])
    if len(set(idx.tolist())) != CLUSTERS or not torch.equal(init._cluster_centers.larray, x[idx]):
        raise AssertionError(f"the kmeans++ centres are not {CLUSTERS} distinct rows of x: rows {idx.tolist()}")
    nbytes = CLUSTERS * 4 * ROWS * FEATURES  # x read for |x|^2 and once a round
    ops = ROWS * (2 * FEATURES + (CLUSTERS - 1) * (2 * FEATURES + 8))  # |x|^2; a round's dot, D^2, min, sum, cumsum
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / F32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    profile = profile_fit(lambda: init._initialize_cluster_centers(pts))
    # a round's two largest steps beside the library calls they replace:
    # x @ c as one block-diagonal GEMM against cuBLAS's gemv, the cumulative
    # sum in a fixed order against torch.cumsum (whose rounding varies by run)
    from heat_tpu_torch.core import arithmetics

    c = x[idx[1]]
    w = torch.rand(ROWS, device=x.device, generator=torch.Generator(device=x.device).manual_seed(SEED)) / ROWS
    steps = {"row_dots_ms": time_ms(lambda: _kcluster._row_dots(x, c), reps=10),
             "gemv_ms": time_ms(lambda: x @ c, reps=10),
             "blocked_cumsum_ms": time_ms(lambda: arithmetics._CUMSUM(w, 0), reps=10),
             "torch_cumsum_ms": time_ms(lambda: torch.cumsum(w, 0), reps=10)}
    del w
    emit({"phase": "kmeanspp", "rows": ROWS, "features": FEATURES, "clusters": CLUSTERS, "picks_2^20": check,
          "fit_wall_ms": fit_ms, "n_iter": n_iter, "inertia": inertia, "launches": launches,
          "labels_vs_plain_near_ties": relabelled, "labels_equal_walk_route": True, "peak_memory_gb": peak_gb,
          "predict": requests, "init_rows": idx.tolist(), "init_first_wall_ms": init_first_ms,
          "init_wall_ms": init_ms, "init_bound_ms": bound[bound_by], "init_bound_by": bound_by,
          "init_share_of_bound": bound[bound_by] / init_ms, "init_profile": profile, "round_steps": steps, "card": smi,
          "phase_seconds": time.perf_counter() - t0 + check["seconds"]})
    return launches


F64_FLOPS = 34e12  # float64 outside the tensor cores (NVIDIA's data sheet, H100 SXM)


def walk64_registers() -> list:
    """ptxas's registers and spills of K1's float64 walk kernels, from the
    build's log."""
    from heat_tpu_torch.core import _build

    out, entry = [], ""
    for ln in _build.BUILD_LOGS.get("lloyd", "").splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            entry = ln
        elif ("registers" in ln or "spill" in ln) and "lloyd_walk_kernelIdLi" in entry:
            out.append(ln.strip())
    return out


def compare_lloyd64(x, c, n_true: int) -> dict:
    """K1's float64 walk route against its plain version on the same inputs:
    labels bitwise, counts exact, sums and inertia within 1e-12 relative
    (max |difference| over max |plain|), and a second launch bitwise equal
    to the first."""
    import torch
    from heat_tpu_torch.core import kernels

    got = kernels.lloyd_partials(x, c, n_true, labels=True)
    again = kernels.lloyd_partials(x, c, n_true, labels=True)
    want = kernels._lloyd_plain(x, c, n_true, True)
    torch.cuda.synchronize()
    sums, counts, inertia, lab = got
    ps, pc, pi, pl = want
    if not torch.equal(lab, pl):
        raise AssertionError(f"float64 labels differ from the plain version's in {int((lab != pl).sum())} rows")
    if not torch.equal(counts, pc):
        raise AssertionError("float64 counts differ from the plain version's")
    sums_rel = float((sums - ps).abs().max() / ps.abs().max().clamp(min=1e-300))
    inertia_rel = abs(float(inertia) - float(pi)) / abs(float(pi))
    if sums_rel > 1e-12 or inertia_rel > 1e-12:
        raise AssertionError(f"float64 sums {sums_rel}, inertia {inertia_rel} relative from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two float64 launches on the same inputs differ")
    centres = sums / counts.clamp(min=1)[:, None]
    err = float((centres - ps / pc.clamp(min=1)[:, None]).abs().max())
    return {"route": "walk", "dtype": "float64", "rows": x.shape[0], "f": x.shape[1], "k": c.shape[0],
            "n_true": n_true, "max_abs_err": err, "sums_rel_err": sums_rel, "inertia_rel_err": inertia_rel,
            "labels_bitwise": True, "bitwise_repeat": True}


def lloyd64_path(dev, smi: str) -> dict:
    """Phases kernel_check (float64) and main_path_f64: K1's float64 walk
    route against its plain version at the KMeans path's shape in float64
    (2^27 x 16, 17.2 GB) and at ragged shapes, its time beside the bound
    and the float32 walk route's in the same run; then KMeans.fit of those
    float64 points through the entry point, three predicts, the peak
    memory.  The data is freed at the end.  Returns K1 float64's entry of
    the kernel summary."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import kernels

    g = torch.Generator(device=dev).manual_seed(SEED + 64)
    truth = torch.randn(CLUSTERS, FEATURES, device=dev, generator=g, dtype=torch.float64) * 10.0
    member = torch.randint(0, CLUSTERS, (ROWS,), device=dev, generator=g)
    x = torch.randn(ROWS, FEATURES, device=dev, generator=g, dtype=torch.float64)
    x += truth[member]
    del member
    checks = [compare_lloyd64(x, truth, ROWS), compare_lloyd64(x, truth, ROWS - 77)]
    for rows, f, k, n_true in ((1003, 17, 30, 1000), (1003, 16, 8, 901), (4096, 64, 8, 4000), (777, 4, 3, 777),
                               (1000, 32, 24, 999), (33, 8, 64, 31), (5, 16, 8, 5)):
        xs = torch.randn(rows, f, device=dev, generator=g, dtype=torch.float64)
        checks.append(compare_lloyd64(xs, torch.randn(k, f, device=dev, generator=g, dtype=torch.float64), n_true))
    flat = torch.randn(1003 * 16 + 1, device=dev, generator=g, dtype=torch.float64)
    checks.append(compare_lloyd64(flat[1:].view(1003, 16), truth, 1003))  # 8-byte aligned only
    refused = []
    for what, call in (("float64 points, float32 centres", lambda: kernels.lloyd_partials(x[:64], truth.float(), 64)),
                       ("float32 points, float64 centres", lambda: kernels.lloyd_partials(x[:64].float(), truth, 64)),
                       ("float64 by the tc route", lambda: kernels._lloyd_cuda(x[:64], truth, 64, False, "tc")),
                       ("float64 at 128 features", lambda: kernels.lloyd_partials(
                           torch.zeros(64, 128, dtype=torch.float64, device=dev),
                           torch.zeros(8, 128, dtype=torch.float64, device=dev), 64))):
        try:
            call()
        except (TypeError, ValueError):
            refused.append(what)
        else:
            raise AssertionError(f"K1 took {what}")
    for c in checks:
        emit({"phase": "kernel_check", "kernel": "lloyd_step_f64", **c})
    emit({"phase": "kernel_check", "kernel": "lloyd_step_f64", "refused": refused})
    del flat

    f64_ms = time_ms(lambda: kernels.lloyd_partials(x, truth, ROWS), reps=20)
    plain_ms = time_ms(lambda: kernels._lloyd_plain(x, truth, ROWS, False), reps=3, warmup=1)
    x32, t32 = x.float(), truth.float()
    walk32_ms = time_ms(lambda: kernels._lloyd_cuda(x32, t32, ROWS, False, "walk"), reps=20)
    del x32, t32
    n, f, k = ROWS, FEATURES, CLUSTERS
    nbytes = 8 * n * f + 8 * k * f + 8 * (k * f + k + 1)  # x and c read once, the sums written once
    ops = n * (2 * k * f + 2 * f + 3 * k + f)
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / F64_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    emit({"phase": "times", "kernel": "lloyd_step_f64", "route": "walk", "dtype": "float64", "ms": f64_ms,
          "plain_ms": plain_ms, "float32_walk_route_ms": walk32_ms, "bound_ms": bound[bound_by],
          "bound_by": bound_by, "share_of_bound": bound[bound_by] / f64_ms, "library_ms": None,
          "ptxas_float64_walk": walk64_registers(), "card": smi})

    # the float64 main path through the entry points a user calls
    ht.use_device("gpu")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    pts = ht.array(x, split=0)
    (km, fit_ms) = wall_ms(lambda: ht.cluster.KMeans(n_clusters=CLUSTERS, init="random", random_state=SEED,
                                                        max_iter=MAX_ITER).fit(pts))
    n_iter = km.n_iter_
    launches = kernels.LLOYD_LAUNCHES
    if launches != n_iter + 1:
        raise AssertionError(f"the float64 fit launched K1 {launches} times for {n_iter} iterations; n_iter + 1")
    centres, labels = km.cluster_centers_.larray, km.labels_.larray
    if (centres.dtype != torch.float64 or km.cluster_centers_.dtype is not ht.float64 or labels.shape != (ROWS,)
            or not bool(torch.isfinite(centres).all())):
        raise AssertionError("the float64 fit's centres are not float64, or its labels are misshapen")
    _, _, plain_inertia, plain_labels = kernels._lloyd_plain(x, centres, ROWS, True)
    if not torch.equal(labels, plain_labels):
        raise AssertionError(f"the float64 fit's labels differ from the plain version's in "
                             f"{int((labels != plain_labels).sum())} rows")
    inertia_rel = abs(km.inertia_ - float(plain_inertia)) / abs(float(plain_inertia))
    if inertia_rel > 1e-12:
        raise AssertionError(f"the float64 fit's inertia is {inertia_rel} from the plain version's")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rng = torch.Generator(device="cpu").manual_seed(SEED + 65)
    requests = []
    for size in (1, 64, 4096):
        rows = torch.randint(0, ROWS, (size,), generator=rng).to(dev)
        pred, ms = wall_ms(lambda: km.predict(ht.array(x[rows], split=0)).larray)
        if not torch.equal(pred, labels[rows]):
            raise AssertionError(f"float64 predict on {size} rows disagrees with labels_")
        requests.append({"rows": size, "wall_ms": ms})
    emit({"phase": "main_path_f64", "rows": ROWS, "features": FEATURES, "clusters": CLUSTERS, "dtype": "float64",
          "n_iter": n_iter, "inertia": km.inertia_, "fit_wall_ms": fit_ms, "lloyd_launches": launches,
          "labels_equal_plain": True, "inertia_rel_err": inertia_rel, "peak_memory_gb": peak_gb,
          "predict": requests, "card": smi})
    del x, pts, km, centres, labels, plain_labels, truth, pred
    torch.cuda.empty_cache()
    return {"name": "lloyd_step_f64", "route": "cuda", "source": "heat_tpu_torch/csrc/lloyd.cu",
            "replaces": "heat_tpu/core/kernels.py:121", "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checks), "ms": f64_ms, "plain_ms": plain_ms,
            "bound_ms": bound[bound_by], "bound_by": bound_by, "library_ms": None}


ARRAY_HEAD = 1 << 20  # rows of the points the CPU recomputes for each call of array_runtime


def array_runtime(x, smi: str) -> None:
    """Phase array_runtime: the tutorials' calls on the float32 KMeans points
    (2^27 x 16) on the card through the entry points a user calls, each
    with its wall time and each checked against the port's CPU result on
    the same rows: the first 2^20 rows of the points go through the same
    call on the CPU and must give the same bits (a random index key and
    its write: the indices among those rows)."""
    import numpy as np
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import printing

    ht.use_device("gpu")
    dev = x.device
    a = ht.array(x, split=0)
    head = x[:ARRAY_HEAD].cpu()
    h = ht.array(head, split=0, device="cpu")
    calls = []

    def check(name, got, want, head_rows=None):
        """got (the card's DNDarray) against want (the CPU port's on the
        head rows): its first rows, or the rows ``head_rows`` of it."""
        g = got.larray
        w = want.larray
        g = g.reshape(-1)[: w.numel()].reshape(w.shape) if head_rows is None else g[head_rows]
        if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            raise AssertionError(f"array_runtime {name}: the card's result differs from the CPU's on the same rows")

    def timed(name, fn, **extra):
        out, ms = wall_ms(fn)
        calls.append({"call": name, "wall_ms": ms, **extra})
        return out

    r = timed("x[5]", lambda: a[5])
    check("x[5]", r, h[5])
    r = timed("x[:, 3]", lambda: a[:, 3])
    check("x[:, 3]", r, h[:, 3])
    r = timed("x[::2]", lambda: a[::2])
    calls[-1]["shape"] = list(r.shape)
    check("x[::2]", r, h[::2])
    r = timed("x[x[:, 0] > 0]", lambda: a[a[:, 0] > 0])
    calls[-1]["shape"] = list(r.shape)
    check("x[x[:, 0] > 0]", r, h[h[:, 0] > 0])
    # 2^20 draws, duplicates removed (a write through repeated indices has
    # no defined winner on the card), in a random order
    cpu_gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    idx = torch.unique(torch.randint(0, ROWS, (1 << 20,), generator=cpu_gen))
    idx = idx[torch.randperm(idx.numel(), generator=cpu_gen)]
    r = timed("x[idx] (2^20 random rows)", lambda: a[ht.array(idx.to(dev))])
    mine = torch.nonzero(idx < ARRAY_HEAD)[:, 0]
    check("x[idx]", r, h[ht.array(idx[mine], device="cpu")], mine.to(dev))
    if not torch.equal(r.larray, x[idx.to(dev)]):
        raise AssertionError("array_runtime x[idx]: not the rows x[idx] of the plain tensor")
    y = ht.array(x, copy=True, split=0)
    v = torch.arange(idx.numel() * FEATURES, dtype=torch.float32).reshape(-1, FEATURES)
    timed("x[idx] = v", lambda: y.__setitem__(ht.array(idx.to(dev)), ht.array(v.to(dev))))
    hy = h.copy()
    hy[ht.array(idx[mine], device="cpu")] = ht.array(v[mine], device="cpu")
    check("x[idx] = v", y, hy)
    if not torch.equal(y.larray[idx.to(dev)], v.to(dev)):
        raise AssertionError("array_runtime x[idx] = v: the rows idx do not hold v")
    del y
    torch.cuda.empty_cache()
    for axis in (1, None, 0):
        r = timed(f"resplit({axis})", lambda: a.resplit(axis))
        if r.split != axis or r.shape != a.shape:
            raise AssertionError(f"resplit({axis}) gave split {r.split}, shape {r.shape}")
        check(f"resplit({axis})", r, h.resplit(axis))
    del r
    types = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16",
             "bfloat16", "float32", "float64", "complex64", "complex128"]
    for name in types:
        t = getattr(ht, name)
        there = timed(f"astype({name})", lambda: a.astype(t))
        back = timed(f"astype({name}).astype(float32)", lambda: there.astype(ht.float32))
        del there
        want = h.astype(t).astype(ht.float32)
        g = back.larray[:ARRAY_HEAD].cpu()
        exact = torch.ones_like(head, dtype=torch.bool)
        if name.startswith(("int", "uint")):
            info = ht.iinfo(t)
            exact = (head >= info.min) & (head <= info.max)
        if not torch.equal(g[exact], want.larray[exact]):
            raise AssertionError(f"astype({name}) and back differs from the CPU's on the same rows")
        del back
        torch.cuda.empty_cache()
    n_eye = 1 << 15
    e = timed("eye(2^15)", lambda: ht.eye(n_eye, split=0))
    if float(e.larray.double().sum()) != n_eye or not torch.equal(e.larray[:1024, :1024].cpu(),
                                                                  ht.eye(1024, device="cpu").larray):
        raise AssertionError("eye(2^15): not the identity")
    del e
    lin = timed("linspace(0, 1, 2^27)", lambda: ht.linspace(0.0, 1.0, ROWS, split=0))
    if not torch.equal(lin.larray.cpu(), ht.linspace(0.0, 1.0, ROWS, split=0, device="cpu").larray):
        raise AssertionError("linspace(0, 1, 2^27) differs from the CPU's")
    del lin
    full = timed("full((2^27, 16), 2.5)", lambda: ht.full((ROWS, FEATURES), 2.5, split=0))
    if not bool((full.larray == 2.5).all()):
        raise AssertionError("full((2^27, 16), 2.5) holds other values")
    del full
    gx, gy = timed("meshgrid(arange(2^13), arange(2^14))",
                   lambda: ht.meshgrid(ht.arange(1 << 13, split=0), ht.arange(1 << 14)))
    cx, cy = ht.meshgrid(ht.arange(1 << 13, split=0, device="cpu"), ht.arange(1 << 14, device="cpu"))
    if not (torch.equal(gx.larray.cpu(), cx.larray) and torch.equal(gy.larray.cpu(), cy.larray)):
        raise AssertionError("meshgrid differs from the CPU's")
    del gx, gy
    torch.cuda.empty_cache()
    text = timed("str(x)", lambda: str(a))
    fetched = printing.LAST_FETCH_BYTES
    edge = ht.get_printoptions()["edgeitems"]
    rows = list(range(edge + 1)) + list(range(ROWS - edge, ROWS))
    cols = list(range(edge + 1)) + list(range(FEATURES - edge, FEATURES))
    view = x[rows][:, cols].cpu().numpy()
    body = np.array2string(view, precision=ht.get_printoptions()["precision"], threshold=0, edgeitems=edge,
                           separator=", ", prefix="DNDarray(")
    if text != f"DNDarray({body}, dtype=ht.float32, device=gpu:0, split=0)":
        raise AssertionError(f"str(x) is not numpy's string of the edge rows:\n{text}")
    if fetched != view.nbytes:
        raise AssertionError(f"str(x) copied {fetched} bytes to the host; the edge blocks are {view.nbytes}")
    print(text, flush=True)
    same = timed("allclose(x, x)", lambda: ht.allclose(a, a))
    off = timed("allclose(x, x + 1)", lambda: ht.allclose(a, a + 1.0))
    every = timed("all(x > -inf)", lambda: bool(ht.all(a > -float("inf"))))
    if not (same and not off and every):
        raise AssertionError(f"allclose(x, x) {same}, allclose(x, x + 1) {off}, all(x > -inf) {every}")
    emit({"phase": "array_runtime", "rows": ROWS, "features": FEATURES, "head_rows_checked_on_cpu": ARRAY_HEAD,
          "print_bytes_to_host": fetched, "print_bytes_of_x": x.numel() * 4, "calls": calls, "card": smi})


OPS_CHUNK = 1 << 24  # rows of a float64 check at a time


def _worst(fn, rows: int) -> float:
    """The largest of ``fn(lo, hi)`` over row chunks of OPS_CHUNK."""
    return max(fn(lo, min(lo + OPS_CHUNK, rows)) for lo in range(0, max(rows, 1), OPS_CHUNK))


def ops_phase(x, smi: str) -> int:
    """Phase ops: the NumPy surface on the float32 KMeans points (2^27 x 16)
    through the entry points a user calls.  First a user's
    standardize-then-cluster path: ``(x - mean(x, 0)) / std(x, 0)``, then
    ``KMeans(n_clusters=8).fit`` on it (K1), ``predict`` and ``bincount`` of
    the labels.  Then the calls of the element-wise, scan, reduction,
    statistics and linalg modules, each timed by wall time beside its byte
    bound (each input read once, each output written once at 3.35 TB/s) and
    checked: exact ops bitwise the CPU port's on the first 2^20 rows,
    transcendentals within rtol 3e-5, atol 1e-6 of float64 on the card,
    reductions and scans within their stated bounds of float64 and bitwise
    in a second run, integer results equal to the plain computation in
    float64/int64.  Returns the K1 launches of its fit."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import kernels

    ht.use_device("gpu")
    rows, feats = x.shape
    a = ht.array(x, split=0)
    head = x[:ARRAY_HEAD].cpu()
    h = ht.array(head, split=0, device="cpu")
    calls = []
    torch.cuda.reset_peak_memory_stats()
    f32 = 4

    def timed(name, fn, nbytes, repeat=False, **extra):
        """The call's wall time, first (with torch's lazy loading and
        compiling of the kernels it runs) and warm (a second call), beside
        its byte bound; with ``repeat`` the second result must be the
        first's, bitwise."""
        out, ms = wall_ms(fn)
        again, warm = wall_ms(fn)
        calls.append({"call": name, "wall_ms": ms, "warm_ms": warm, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      **extra})
        if repeat:
            if not torch.equal(out.larray, again.larray):
                raise AssertionError(f"ops {name}: a second run differs")
            note(bitwise_repeat=True)
        del again
        return out

    def note(**kw):
        calls[-1].update(kw)

    def exact(got, want):
        """got (the card's DNDarray) bitwise want (the CPU port's on the head
        rows) on its first elements."""
        g, w = got.larray, want.larray
        g = g.reshape(-1)[: w.numel()].reshape(w.shape)
        if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            raise AssertionError(f"ops {calls[-1]['call']}: the card's result differs from the CPU's on the same rows")
        note(check="bitwise the CPU's")

    def transcendental(got, fn64):
        """got within rtol 3e-5, atol 1e-6 of fn64 of x in float64."""
        g = got.larray

        def excess(lo, hi):
            w = fn64(x[lo:hi].double())
            return float(((g[lo:hi].double() - w).abs() - (1e-6 + 3e-5 * w.abs())).max())

        worst = _worst(excess, rows)
        if worst > 0:
            raise AssertionError(f"ops {calls[-1]['call']}: beyond rtol 3e-5, atol 1e-6 of float64 by {worst}")
        note(check="rtol 3e-5, atol 1e-6 of float64")

    def within(err, bound, what):
        note(err=err, err_bound=bound, err_of=what)
        if not err <= bound:
            raise AssertionError(f"ops {calls[-1]['call']}: {what} {err} beyond {bound}")

    # the path: standardize, then cluster, predict and count
    zero_launches()
    xs = timed("standardize (x - mean(x, 0)) / std(x, 0)", lambda: (a - ht.mean(a, axis=0)) / ht.std(a, axis=0),
               3 * rows * feats * f32)
    x64m = x.double().mean(0)
    var64_0 = sum(((x[lo:lo + OPS_CHUNK].double() - x64m) ** 2).sum(0) for lo in range(0, rows, OPS_CHUNK)) / rows
    x64s = var64_0.sqrt()

    def std_excess(lo, hi):
        w = (x[lo:hi].double() - x64m) / x64s
        return float(((xs.larray[lo:hi].double() - w).abs() - (1e-5 + 1e-5 * w.abs())).max())

    if _worst(std_excess, rows) > 0:
        raise AssertionError("ops standardize: beyond rtol 1e-5, atol 1e-5 of float64")
    note(check="rtol 1e-5, atol 1e-5 of float64")
    km, fit_ms = wall_ms(lambda: ht.cluster.KMeans(n_clusters=CLUSTERS, init="random", random_state=SEED,
                                                   max_iter=MAX_ITER).fit(xs))
    launches = kernels.LLOYD_LAUNCHES
    if launches < km.n_iter_ + 1:
        raise AssertionError(f"the standardized fit launched K1 {launches} times for {km.n_iter_} iterations")
    centres, labels = km.cluster_centers_.larray, km.labels_.larray
    if centres.shape != (CLUSTERS, FEATURES) or labels.shape != (rows,) or not bool(torch.isfinite(centres).all()):
        raise AssertionError("the standardized fit's centres or labels have the wrong shape or are not finite")
    _, _, plain_inertia, plain_labels = kernels._lloyd_plain(xs.larray, centres, rows, True)
    relabelled = near_tie_mismatches(xs.larray, centres, labels, plain_labels)
    if abs(km.inertia_ - float(plain_inertia)) > 1e-4 * abs(float(plain_inertia)):
        raise AssertionError(f"standardized fit inertia {km.inertia_} against {float(plain_inertia)}")
    del plain_labels
    calls.append({"call": "KMeans(n_clusters=8).fit(standardized)", "wall_ms": fit_ms, "n_iter": km.n_iter_,
                  "lloyd_launches": launches, "labels_vs_plain_near_ties": relabelled})
    pred = timed("predict(standardized)", lambda: km.predict(xs), rows * feats * f32 + rows * 8)
    # predict's distances and K1's differ in rounding: labels agree but at near-ties
    note(labels_vs_fit_near_ties=near_tie_mismatches(xs.larray, centres, pred.larray, labels))
    counts = timed("bincount(labels)", lambda: ht.bincount(pred), rows * 8)
    if not torch.equal(counts.larray, torch.bincount(pred.larray)):
        raise AssertionError("bincount of the labels differs from torch.bincount")
    note(counts=counts.larray.tolist())
    del xs, km, pred, counts, labels, centres
    torch.cuda.empty_cache()
    n_el = rows * feats

    # transcendentals
    for name, fn, fn64 in (("exp", ht.exp, torch.exp),
                           ("log(abs(x) + 1)", lambda t: ht.log(ht.abs(t) + 1), lambda t: torch.log(t.abs() + 1)),
                           ("sqrt(abs(x))", lambda t: ht.sqrt(ht.abs(t)), lambda t: torch.sqrt(t.abs())),
                           ("sin", ht.sin, torch.sin), ("tanh", ht.tanh, torch.tanh)):
        r = timed(name, lambda: fn(a), 2 * n_el * f32)
        transcendental(r, fn64)
        del r
    # exact element-wise ops
    for name, fn in (("abs", ht.abs), ("floor", ht.floor), ("round(x, 2)", lambda t: ht.round(t, 2)),
                     ("clip(x, -1, 1)", lambda t: ht.clip(t, -1, 1)), ("x % 0.5", lambda t: t % 0.5),
                     ("x // 0.5", lambda t: t // 0.5)):
        r = timed(name, lambda: fn(a), 2 * n_el * f32)
        exact(r, fn(h))
        del r
    r = timed("diff(x, axis=0)", lambda: ht.diff(a, axis=0), 2 * n_el * f32)
    exact(r, ht.diff(h, axis=0))
    del r
    torch.cuda.empty_cache()

    # scans and reductions against float64, and repeated
    cs0 = timed("cumsum(x, 0) (the split axis)", lambda: ht.cumsum(a, 0), 2 * n_el * f32, repeat=True)
    err = 0.0
    for c in range(feats):
        col = x[:, c].double()
        err = max(err, float(((cs0.larray[:, c].double() - torch.cumsum(col, 0)).abs()
                              / torch.cumsum(col.abs(), 0).clamp(min=1e-30)).max()))
        del col
    within(err, 1e-4, "max |error| over the running sum of |x|")
    del cs0
    cs1 = timed("cumsum(x, 1)", lambda: ht.cumsum(a, 1), 2 * n_el * f32, repeat=True)
    within(_worst(lambda lo, hi: float(((cs1.larray[lo:hi].double() - torch.cumsum(x[lo:hi].double(), 1)).abs()
                                        / torch.cumsum(x[lo:hi].double().abs(), 1).clamp(min=1e-30)).max()), rows),
           1e-6, "max |error| over the running sum of |x|")
    del cs1
    pr = timed("prod(x, 1)", lambda: ht.prod(a, 1), n_el * f32 + rows * f32, repeat=True)
    within(_worst(lambda lo, hi: float(((pr.larray[lo:hi].double() - x[lo:hi].double().prod(1)).abs()
                                        / x[lo:hi].double().prod(1).abs().clamp(min=1e-300)).max()), rows),
           4e-6, "max relative error")
    del pr
    torch.cuda.empty_cache()
    mean_all = x64m.mean()
    var64_all = sum(float(((x[lo:lo + OPS_CHUNK].double() - mean_all) ** 2).sum())
                    for lo in range(0, rows, OPS_CHUNK)) / (rows * feats)
    for name, fn, want in (("var(x, 0)", lambda: ht.var(a, 0), var64_0),
                           ("std(x, 0)", lambda: ht.std(a, 0), var64_0.sqrt()),
                           ("var(x)", lambda: ht.var(a), torch.tensor(var64_all, dtype=torch.float64)),
                           ("std(x)", lambda: ht.std(a), torch.tensor(var64_all, dtype=torch.float64).sqrt())):
        r = timed(name, fn, 2 * n_el * f32, repeat=True)
        within(float(((r.larray.double() - want.to(r.larray.device)).abs() / want.abs()).max()), 1e-5,
               "max relative error")
        del r
    for name, fn, axis in (("argmax(x, 0)", ht.argmax, 0), ("argmin(x, 0)", ht.argmin, 0),
                           ("argmax(x)", ht.argmax, None), ("argmin(x)", ht.argmin, None)):
        r = timed(name, lambda: fn(a, axis), n_el * f32)
        plain = (torch.argmax if fn is ht.argmax else torch.argmin)(x if axis is not None else x.reshape(-1),
                                                                      *((axis,) if axis is not None else ()))
        if not torch.equal(r.larray.reshape(plain.shape), plain):
            raise AssertionError(f"ops {name}: not the plain argument")
        note(check="equal to the plain computation")
        del r, plain
    col0 = timed("x[:, 0]", lambda: a[:, 0], rows * f32 * 2)
    hist, edges = timed("histogram(x[:, 0], bins=64)", lambda: ht.histogram(col0, bins=64), rows * f32)
    e64 = edges.larray.double()
    idx = torch.searchsorted(e64, x[:, 0].double().contiguous(), right=True)
    idx = torch.where(x[:, 0].double() == e64[-1], torch.full_like(idx, 64), idx)
    plain = torch.bincount(idx, minlength=66)[1:65]
    if not torch.equal(hist.larray.to(torch.int64), plain) or not torch.equal(
            edges.larray.cpu(), ht.histogram(ht.array(x[:, 0].cpu(), device="cpu"), bins=64)[1].larray):
        raise AssertionError("ops histogram: counts or edges differ from the plain computation")
    note(check="counts equal to the plain computation, edges bitwise the CPU's")
    cv = timed("cov(x, rowvar=False)", lambda: ht.cov(a, rowvar=False), n_el * f32, repeat=True)
    centred_gram = sum((x[lo:lo + OPS_CHUNK].double() - x64m).T @ (x[lo:lo + OPS_CHUNK].double() - x64m)
                       for lo in range(0, rows, OPS_CHUNK)) / (rows - 1)
    within(float((cv.larray.double() - centred_gram).abs().max() / centred_gram.abs().max()), 3e-5,
           "max |error| over max |cov|")
    del cv
    col1 = a[:, 1]
    d = timed("dot(x[:, 0], x[:, 1])", lambda: ht.dot(col0, col1), 2 * rows * f32, repeat=True)
    prods = x[:, 0].double() * x[:, 1].double()
    within(abs(float(d.larray) - float(prods.sum())) / float(prods.abs().sum()), 1e-6,
           "|error| over the sum of |products|")
    del d, prods
    u, v = a[: 1 << 14, 0], a[: 1 << 14, 1]
    o = timed("outer(2^14, 2^14)", lambda: ht.outer(u, v), (1 << 28) * f32 + (1 << 15) * f32)
    hu, hv = ht.array(head[:64, 0], device="cpu"), ht.array(x[: 1 << 14, 1].cpu(), device="cpu")
    exact(o, ht.outer(hu, hv))
    del o, col0, col1, u, v
    torch.cuda.empty_cache()
    side = 1 << 15
    m = ht.array(x.reshape(-1)[: side * side].reshape(side, side), split=0)
    hm = ht.array(x.reshape(-1)[: 32 * side].reshape(32, side).cpu(), split=0, device="cpu")
    for name, fn in (("tril(2^15 x 2^15)", lambda t: ht.tril(t)), ("triu(2^15 x 2^15, 1)", lambda t: ht.triu(t, 1))):
        r = timed(name, lambda: fn(m), 2 * side * side * f32)
        exact(r, fn(hm))
        del r
    del m
    torch.cuda.empty_cache()
    total = float(sum(float((x[lo:lo + OPS_CHUNK].double() ** 2).sum()) for lo in range(0, rows, OPS_CHUNK)))
    for name, fn in (("vector_norm(x)", lambda: ht.vector_norm(a)), ("matrix_norm(x)", lambda: ht.matrix_norm(a))):
        r = timed(name, fn, n_el * f32, repeat=True)
        within(abs(float(r.larray) - total ** 0.5) / total ** 0.5, 1e-6, "relative error")
        del r
    rd = ht.array(x, split=0)
    target = rd.lshape_map
    timed("redistribute_ (the canonical target on one card)", lambda: rd.redistribute_(target_map=target), 0)
    timed("balance_", lambda: rd.balance_(), 0)
    if not (rd.is_balanced() and rd.larray.data_ptr() == x.data_ptr() and (rd.lshape_map == target).all()):
        raise AssertionError("ops redistribute_/balance_: not a no-op on one card")
    note(check="no data moved, balanced")
    emit({"phase": "ops", "rows": rows, "features": feats, "head_rows_checked_on_cpu": ARRAY_HEAD, "calls": calls,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    unsigned_ops(smi)
    return launches


UNSIGNED_N = 1 << 27  # values of each unsigned operand


def unsigned_ops(smi: str) -> None:
    """Phase ops, its unsigned part: uint16, uint32 and uint64 (held in
    int32, int64 and int64's bits) through the entry points, on 2^27 values
    drawn over each type's whole range (the top bit set in half of them),
    each call's result bitwise numpy's on the host, its warm wall time
    beside its byte bound (each operand read once and the result written
    once in the type's own width at 3.35 TB/s).  Divisors are not zero and
    shift counts below the width: numpy's answers there are not the
    reference's (the CPU tests hold those)."""
    import numpy as np
    import torch
    import heat_tpu_torch as ht

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    calls = []
    for name in ("uint16", "uint32", "uint64"):
        t = getattr(np, name)
        bits = np.iinfo(t).bits
        a = (rng.integers(0, 2**63, UNSIGNED_N, dtype=np.uint64) << np.uint64(1) | np.uint64(1)) >> np.uint64(64 - bits)
        b = rng.integers(0, 2**63, UNSIGNED_N, dtype=np.uint64) >> np.uint64(64 - bits) | np.uint64(1)
        a, b = a.astype(t), b.astype(t)
        s = (b % t(bits)).astype(t)
        pa, pb, ps = (ht.array(v, split=0, device="gpu") for v in (a, b, s))
        w = np.dtype(t).itemsize
        n = UNSIGNED_N
        cases = [
            ("+", lambda: pa + pb, lambda: a + b, 3 * n * w), ("-", lambda: pa - pb, lambda: a - b, 3 * n * w),
            ("*", lambda: pa * pb, lambda: a * b, 3 * n * w), ("//", lambda: pa // pb, lambda: a // b, 3 * n * w),
            ("%", lambda: pa % pb, lambda: a % b, 3 * n * w), (">>", lambda: pa >> ps, lambda: a >> s, 3 * n * w),
            ("<", lambda: pa < pb, lambda: a < b, n * (2 * w + 1)), ("==", lambda: pa == pb, lambda: a == b, n * (2 * w + 1)),
            ("sum", lambda: ht.sum(pa), lambda: np.sum(a, dtype=np.uint64), n * w),
            ("cumsum", lambda: ht.cumsum(pa, 0), lambda: np.cumsum(a, dtype=t), 2 * n * w),
            ("max", lambda: ht.max(pa), lambda: np.max(a), n * w),
            ("argmax", lambda: ht.argmax(pa), lambda: np.argmax(a), n * w),
            ("sort", lambda: ht.sort(pa)[0], lambda: np.sort(a), 2 * n * w),
            ("astype(float32)", lambda: pa.astype(ht.float32), lambda: a.astype(np.float32), n * (w + 4)),
            ("astype(float64)", lambda: pa.astype(ht.float64), lambda: a.astype(np.float64), n * (w + 8)),
        ]
        for op, port, host, nbytes in cases:
            out, first = wall_ms(port)
            out, warm = wall_ms(port)
            want = np.asarray(host())
            got = out.numpy()
            if got.dtype != want.dtype and op not in ("argmax",):
                raise AssertionError(f"ops {name} {op}: type {got.dtype}, numpy's {want.dtype}")
            if got.shape != want.shape or got.tobytes() != want.astype(got.dtype).tobytes():
                raise AssertionError(f"ops {name} {op}: the card's result differs from numpy's")
            calls.append({"type": name, "call": op, "wall_ms": first, "warm_ms": warm,
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bitwise_numpy": True})
            del out
        del pa, pb, ps
        torch.cuda.empty_cache()
    emit({"phase": "ops", "unsigned_values": UNSIGNED_N, "unsigned_calls": calls, "card": smi,
          "phase_seconds": time.perf_counter() - t0})


SORT_PEAK_BYTES = 60e9  # the points, the sorted values, the indices and torch.sort's workspace must fit
SORT_WORKSPACE = 6  # torch.sort along axis 0: a transposed copy and its sorted keys and int64 indices, in bytes of x
IO_ROWS = 1 << 24  # 2^24 x 16 float32: 1 GiB through HDF5 and .npy
CSV_ROWS = 1 << 20  # tutorial 4's width (4 columns), its rows scaled to 2^20
TOPK_K = 1024


def manipulations_phase(x, labels, smi: str) -> None:
    """Phase manipulations: the sort and its statistics, the row moves and
    the scalers on the float32 KMeans points (2^27 x 16) through the entry
    points a user calls, on one card (the world of one: every sort and
    quantile runs on the card's own rows).  Each call's first and warm wall
    time, the memory it took beyond what was allocated before it, and its
    bound (each input read once, each output written once at 3.35 TB/s).
    Checks: sort's values and int64 indices bitwise ``torch.sort(stable=
    True)`` column by column; a 1-D sort of a 2^27 column with NaNs and
    zeros of both signs planted, bitwise; percentile(col, [25, 50, 75])
    "lower" and "higher" bitwise ``torch.kthvalue``, "linear" within the
    float32 rounding of its two order statistics; median(x, axis=0) of 2^31
    elements (past ``torch.quantile``'s 2^24) bitwise the float64 midpoint of
    the two kthvalues; topk(col, 1024) of a column with ties in the
    lowest-index-first order; unique of the fit's labels; reshape,
    concatenate, pad, roll and flip along axis 0 bitwise their torch
    counterparts; StandardScaler, MinMaxScaler and RobustScaler against
    float64 statistics on the card."""
    import torch
    import heat_tpu_torch as ht

    ht.use_device("gpu")
    rows, feats = x.shape
    pts = ht.array(x, split=0)
    peaks, calls = [], []
    n4 = 4 * rows * feats

    def bound(nbytes):
        return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes}

    def timed(fn, name, nbytes):
        out, rec = timed_call(fn, name, bound(nbytes), smi, peaks)
        calls.append(rec)
        return out

    # sort along axis 0: every column sorted on the card
    sort_rows = rows if x.nbytes * (4 + SORT_WORKSPACE) <= SORT_PEAK_BYTES else rows // 2
    part = ht.array(x[:sort_rows], split=0)
    v, i = timed(lambda: ht.sort(part, axis=0), f"sort(x[:{sort_rows}], axis=0)", 16 * sort_rows * feats)
    for j in range(feats):
        want = torch.sort(x[:sort_rows, j], stable=True)
        if not (torch.equal(v.larray[:, j].view(torch.int32), want.values.view(torch.int32))
                and torch.equal(i.larray[:, j], want.indices)):
            raise AssertionError(f"sort: column {j} differs from torch.sort(stable=True)")
        del want
    calls[-1].update(rows=sort_rows, check="values and indices bitwise torch.sort(stable=True), column by column")
    del v, i, part
    torch.cuda.empty_cache()

    # a 1-D sort with NaNs and both zeros planted
    col = x[:, 0].clone()
    col[::1000] = float("nan")
    col[1::997] = -0.0
    col[2::991] = 0.0
    c = ht.array(col, split=0)
    v, i = timed(lambda: ht.sort(c), "sort(col) with NaNs and both zeros", 16 * rows)
    want = torch.sort(col, stable=True)
    if not (torch.equal(v.larray.view(torch.int32), want.values.view(torch.int32))
            and torch.equal(i.larray, want.indices)):
        raise AssertionError("sort of the planted column differs from torch.sort(stable=True)")
    calls[-1]["check"] = "values and indices bitwise torch.sort(stable=True)"
    del v, i, want, c, col

    # percentiles of a clean column, each order statistic against kthvalue
    col = x[:, 1].contiguous()
    c = ht.array(col, split=0)
    q = torch.tensor([25.0, 50.0, 75.0], dtype=torch.float64)
    pos = q / 100.0 * (rows - 1)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    kth_lo = torch.stack([torch.kthvalue(col, int(k) + 1).values for k in lo])
    kth_hi = torch.stack([torch.kthvalue(col, int(k) + 1).values for k in hi])
    for method in ("linear", "lower", "higher"):
        got = timed(lambda: ht.percentile(c, [25, 50, 75], interpolation=method),
                    f"percentile(col, [25, 50, 75], {method})", 4 * rows).larray
        if method == "lower" and not torch.equal(got.view(torch.int32), kth_lo.view(torch.int32)):
            raise AssertionError("percentile lower differs from torch.kthvalue")
        if method == "higher" and not torch.equal(got.view(torch.int32), kth_hi.view(torch.int32)):
            raise AssertionError("percentile higher differs from torch.kthvalue")
        if method == "linear":  # interpolated in float64, rounded once to float32
            w = (pos - lo.double()).to(col.device)
            ref = (kth_lo.double() * (1 - w) + kth_hi.double() * w).float()
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError("percentile linear differs from the float32 rounding of kthvalue's interpolation")
        calls[-1]["check"] = {"lower": "bitwise torch.kthvalue", "higher": "bitwise torch.kthvalue",
                              "linear": "bitwise the float32 rounding of the float64 interpolation of two "
                                        "torch.kthvalue"}[method]
    del c, col, kth_lo, kth_hi

    # the median of every column: 2^31 elements
    med = timed(lambda: ht.median(pts, axis=0), f"median(x, axis=0) of {rows * feats} elements", n4).larray
    half = (rows - 1) / 2.0
    for j in range(feats):
        a = torch.kthvalue(x[:, j], int(half) + 1).values.double()
        b = torch.kthvalue(x[:, j], int(half) + 2).values.double()
        if med[j].view(torch.int32) != (a * 0.5 + b * 0.5).float().view(torch.int32):
            raise AssertionError(f"median of column {j} is not the midpoint of its two middle kthvalues")
    calls[-1]["check"] = "bitwise the float64 midpoint of the two middle torch.kthvalue, cast to float32"

    # top-k of a column with ties: the larger values first, the lower index first among equals
    col = torch.round(x[:, 2] * 4) / 4
    c = ht.array(col, split=0)
    tv, ti = timed(lambda: ht.topk(c, TOPK_K), f"topk(col, {TOPK_K}) with ties", 4 * rows)
    key = col.view(torch.int32)
    key = torch.bitwise_xor(key, (key >> 31) & 0x7FFFFFFF)
    want = torch.sort(key, descending=True, stable=True).indices[:TOPK_K]
    if not (torch.equal(ti.larray, want) and torch.equal(tv.larray, col[want])):
        raise AssertionError("topk: not the lowest-index-first order of the largest values")
    calls[-1].update(check="indices bitwise a stable descending sort of the total-order keys",
                     ties_in_result=int(TOPK_K - torch.unique(tv.larray).numel()))
    del c, col, key, want, tv, ti

    # unique of the fit's labels
    u = timed(lambda: ht.unique(labels), "unique(labels_)", 8 * rows)
    if not torch.equal(u.larray, torch.unique(labels.larray)):
        raise AssertionError("unique of the labels differs from torch.unique")
    calls[-1]["check"] = "equal to torch.unique"

    # rows moved along axis 0, each against its torch counterpart in chunks
    chunk = 1 << 24

    def same_rows(got, fn_want, extent):
        for s in range(0, extent, chunk):
            if not torch.equal(got[s:s + chunk], fn_want(s, min(s + chunk, extent))):
                raise AssertionError(f"{calls[-1]['call']}: rows {s}.. differ from the torch counterpart")
        calls[-1]["check"] = "bitwise its torch counterpart"

    r = timed(lambda: ht.reshape(pts, (rows * feats // 64, 64)), "reshape to (2^25, 64)", 2 * n4)
    if not torch.equal(r.larray, x.reshape(-1, 64)):
        raise AssertionError("reshape differs from torch.reshape")
    calls[-1]["check"] = "bitwise torch.reshape"
    del r
    def catted(a, b):  # rows a..b of torch.cat([x, x])
        return torch.cat([x[a:min(b, rows)], x[max(a, rows) - rows:max(b - rows, 0)]])

    r = timed(lambda: ht.concatenate([pts, pts], axis=0), "concatenate([x, x], 0)", 4 * n4)
    same_rows(r.larray, catted, 2 * rows)
    del r
    torch.cuda.empty_cache()
    r = timed(lambda: ht.pad(pts, ((3, 5), (0, 0))), "pad(x, ((3, 5), (0, 0)))", 2 * n4)
    padded = lambda a, b: torch.nn.functional.pad(x[max(a - 3, 0):min(b - 3, rows)],  # noqa: E731
                                                  (0, 0, max(3 - a, 0), max(b - 3 - rows, 0)))
    same_rows(r.larray, padded, rows + 8)
    del r
    torch.cuda.empty_cache()
    shift = 12345
    r = timed(lambda: ht.roll(pts, shift, 0), f"roll(x, {shift}, 0)", 2 * n4)
    same_rows(r.larray, lambda a, b: x[(torch.arange(a, b, device=x.device) - shift) % rows], rows)  # torch.roll's rows
    del r
    torch.cuda.empty_cache()
    r = timed(lambda: ht.flip(pts, 0), "flip(x, 0)", 2 * n4)
    same_rows(r.larray, lambda a, b: torch.flip(x[rows - b:rows - a], [0]), rows)
    del r
    torch.cuda.empty_cache()

    # the scalers, against float64 statistics of the points on the card
    stats = {"mean": [], "var": [], "min": [], "max": [], "median": [], "q25": [], "q75": []}
    for j in range(feats):
        c64 = x[:, j].double()
        stats["mean"].append(c64.mean())
        stats["var"].append(c64.var(unbiased=False))
        stats["min"].append(c64.min())
        stats["max"].append(c64.max())
        del c64
    stats = {k: torch.stack(v) for k, v in stats.items() if v}
    head = x[:ARRAY_HEAD].double()
    scalers = (("StandardScaler", lambda s: (s.mean_.larray.double(), s.var_.larray.double()),
                lambda: ((head - stats["mean"]) / stats["var"].sqrt(), [stats["mean"], stats["var"]]), (1e-5, 1e-4)),
               ("MinMaxScaler", lambda s: (s.data_min_.larray.double(), s.data_max_.larray.double()),
                lambda: ((head - stats["min"]) / (stats["max"] - stats["min"]), [stats["min"], stats["max"]]),
                (0.0, 1e-6)),
               ("RobustScaler", None, None, None))
    for name, fitted, truth, tol in scalers:
        est = getattr(ht.preprocessing, name)()
        out = timed(lambda: est.fit_transform(pts), f"{name}().fit_transform(x)", 3 * n4)
        if truth is not None:
            want, want_stats = truth()
            err = float((out.larray[:ARRAY_HEAD].double() - want).abs().max())
            stat_err = max(float(((g - w).abs() / (1 + w.abs())).max()) for g, w in zip(fitted(est), want_stats))
            if not (stat_err <= tol[0] and err <= tol[1]):
                raise AssertionError(f"{name}: statistics {stat_err}, transform {err} from float64 (bounds {tol})")
            calls[-1].update(stat_rel_err_vs_float64=stat_err, max_abs_err_vs_float64=err, err_bounds=list(tol))
        else:
            if not torch.equal(est.center_.larray, med):
                raise AssertionError("RobustScaler's centre differs from median(x, axis=0)")
            q = torch.stack([torch.kthvalue(x[:, j], k + 1).values for j in range(feats)
                             for k in (int(0.25 * (rows - 1)), int(0.25 * (rows - 1)) + 1,
                                       int(0.75 * (rows - 1)), int(0.75 * (rows - 1)) + 1)]).double().view(feats, 4)
            w25, w75 = 0.25 * (rows - 1) % 1, 0.75 * (rows - 1) % 1
            iqr = ((q[:, 2] * (1 - w75) + q[:, 3] * w75).float() - (q[:, 0] * (1 - w25) + q[:, 1] * w25).float())
            if not torch.equal(est.iqr_.larray, iqr):
                raise AssertionError("RobustScaler's IQR differs from the kthvalue quantiles")
            want = (head - med.double()) / iqr.double()
            err = float((out.larray[:ARRAY_HEAD].double() - want).abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"RobustScaler: transform {err} from float64")
            calls[-1].update(check="centre and IQR bitwise the kthvalue quantiles", max_abs_err_vs_float64=err)
        del out, est
        torch.cuda.empty_cache()
    for rec in calls:
        emit({"phase": "manipulations", **rec})


def io_phase(x, smi: str) -> None:
    """Phase io: 2^24 x 16 float32 points from the card (1 GiB) through
    save_hdf5/load_hdf5 and save/load of .npy, and 2^20 x 4 through
    save_csv/load_csv (tutorial 4's width), each round trip bitwise and its
    CRC32 sidecar verified, with the wall time and rate of each; in a
    temporary directory, deleted afterwards."""
    import shutil
    import tempfile

    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import io as htio

    ht.use_device("gpu")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        big = ht.array(x[:IO_ROWS].contiguous(), split=0)
        small = ht.array(x[:CSV_ROWS, :4].contiguous(), split=0)
        formats = [("npy", big, lambda d, p: ht.save(d, p), lambda p: ht.load(p, split=0)),
                   ("csv", small, lambda d, p: ht.save_csv(d, p), lambda p: ht.load_csv(p, split=0))]
        if ht.supports_hdf5():
            formats.insert(0, ("hdf5", big, lambda d, p: ht.save_hdf5(d, p, "x"),
                               lambda p: ht.load_hdf5(p, "x", split=0)))
        else:  # save_hdf5 raises without h5py, as the reference's does
            emit({"phase": "io", "format": "hdf5", "measured": False,
                  "reason": "h5py is not installed on this machine (ht.supports_hdf5() is False)", "card": smi})
        for name, data, save, load in formats:
            path = os.path.join(tmp, "x." + {"hdf5": "h5"}.get(name, name))
            _, save_ms = wall_ms(lambda: save(data, path))
            back, load_ms = wall_ms(lambda: load(path))
            if htio.verify_checksum(path) is not True:
                raise AssertionError(f"io {name}: the sidecar is missing or does not verify")
            if back.shape != data.shape or not back.larray.is_cuda or not torch.equal(back.larray, data.larray):
                raise AssertionError(f"io {name}: the round trip is not bitwise")
            gb = data.larray.numel() * 4 / 1e9
            emit({"phase": "io", "format": name, "shape": list(data.shape), "array_gb": gb,
                  "file_gb": os.path.getsize(path) / 1e9, "save_s": save_ms / 1e3, "load_s": load_ms / 1e3,
                  "save_gb_per_s": gb / (save_ms / 1e3), "load_gb_per_s": gb / (load_ms / 1e3),
                  "check": "round trip bitwise, CRC32 sidecar verified", "card": smi})
            os.remove(path)
            os.remove(path + ".crc32")
            del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


ML_HEAD = 1 << 16  # rows each estimator also fits on the card and on the host
KMEDIANS_ROWS = 1 << 24  # each update sorts every cluster's members feature by feature
LASSO_ROWS = 1 << 25  # a sweep reads the 17 columns' data 17 times
SPECTRAL_ROWS = 1 << 15  # the Laplacian cell's size: a 4.3 GB L
SPECTRAL_SCALE = 0.125  # at their own scale every similarity between clusters underflows to 0
SPECTRAL_HEAD = 1 << 12  # points the host's Spectral fits beside the card's
ML_PEAK_BYTES = 60e9


def _agreement(a, b, k: int) -> float:
    """The share of labels a and b (int tensors) agree on, under the best
    matching of a's clusters to b's (each of a's to the b label it meets most)."""
    import torch

    a, b = a.long().cpu(), b.long().cpu()
    table = torch.zeros((k, k), dtype=torch.int64).index_put_((a, b), torch.ones_like(a), accumulate=True)
    return float(table.max(1).values.sum()) / a.numel()


def lloyd_fixed_point(points, centres, labels, medians: bool, block: int = 1 << 22) -> float:
    """How far a converged fit is from a fixed point of its own step, in
    float64 on the card: the labels must be each row's nearest centre but
    for near-ties (``near_tie_mismatches``), and the largest distance of a
    centre from its members' mean (median: the mean of the two middle
    values, feature by feature) is returned.  The fits stop once the
    squared movement of a step is at most 1e-4, so 1e-2 bounds it."""
    import torch

    c64 = centres.double()
    want = torch.cat([torch.addmm((c64 * c64).sum(1)[None, :], points[i:i + block].double(), c64.T, alpha=-2.0)
                      .argmin(1) for i in range(0, points.shape[0], block)])
    near_tie_mismatches(points, centres, labels.long(), want)
    worst = 0.0
    for j in range(centres.shape[0]):
        members = points[labels == j].double()
        if members.shape[0] == 0:
            continue
        if medians:
            s = torch.sort(members, dim=0).values
            m = members.shape[0]
            centre = 0.5 * (s[(m - 1) // 2] + s[m // 2])
        else:
            centre = members.mean(0)
        worst = max(worst, float((centre - c64[j]).abs().max()))
    return worst


def ml_rest_phase(x, member, smi: str) -> dict:
    """Phase ml_rest: GaussianNB (fit, partial_fit in two halves, predict,
    predict_proba) and BatchParallelKMeans(8, random_state=1) on the 2^27 x
    16 points with their 8 true labels, BatchParallelKMedians on the first
    2^24 rows, Lasso(lam=0.01) on the first 2^25 rows with y = x w + 0.5 +
    noise, Spectral(8, gamma=0.5, n_lanczos=300) on 2^15 of the points
    scaled by 1/8.  Each call's first and warm wall time beside its byte
    bound (x read once per pass at 3.35 TB/s); Lasso's sweeps and host
    syncs; K1's and threefry's launches during Spectral and its device time
    by step (the profiler labels spectral.laplacian, .lanczos, .eigh,
    .kmeans); the phase's peak memory under 60 GB.  Each estimator also fits
    the first 2^16 rows (Spectral: 2^12 points) on the card and on the host:
    the results agree within the CPU tests' bounds, labels bitwise but for
    near-ties.  Returns ``{"lloyd_step": K1 launches, "threefry": ...}`` of
    the Spectral fit."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.core import random as rnd
    from heat_tpu_torch.regression import lasso as lasso_mod

    ht.use_device("gpu")
    rows, feats = x.shape
    xb = 4 * rows * feats
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    calls = []

    def timed(name, fn, passes, rows_read: int = rows, **extra):
        """``fn``'s result and its first and warm wall time beside the
        bound of ``passes`` reads of ``rows_read`` rows of x (a callable
        ``passes`` is asked after the warm call)."""
        out, first = wall_ms(fn)
        del out
        out, warm = wall_ms(fn)
        if callable(passes):
            passes = passes()
            extra["passes"] = passes
        bound = passes * 4 * rows_read * feats / HBM_BYTES_PER_S * 1e3
        calls.append({"call": name, "first_ms": first, "warm_ms": warm, "bound_ms": bound, "bound_by": "bytes",
                      "share_of_bound": bound / warm, **extra})
        return out

    def head_pair(a):
        return ht.array(a[:ML_HEAD], split=0), ht.array(a[:ML_HEAD].cpu(), split=0, device="cpu")

    labels = member.to(torch.int32)
    X, Y = ht.array(x, split=0), ht.array(labels, split=0)

    # GaussianNB: the mean pass, then the centred moments (2 passes); predict 1 pass
    nb = timed("GaussianNB.fit", lambda: ht.naive_bayes.GaussianNB().fit(X, Y), 2)
    half = rows // 2

    def two_halves():
        est = ht.naive_bayes.GaussianNB()
        est.partial_fit(ht.array(x[:half], split=0), ht.array(labels[:half], split=0))
        return est.partial_fit(ht.array(x[half:], split=0), ht.array(labels[half:], split=0))

    nb2 = timed("GaussianNB.partial_fit (two halves)", two_halves, 2)
    pred = timed("GaussianNB.predict", lambda: nb.predict(X), 1)
    proba = timed("GaussianNB.predict_proba", lambda: nb.predict_proba(X), 1)
    theta_err = float((nb.theta_.larray - nb2.theta_.larray).abs().max())
    accuracy = float((pred.larray == labels).double().mean())
    proba_sum_err = float((proba.larray.double().sum(1) - 1.0).abs().max())
    if theta_err > 1e-4 or accuracy < 0.99 or proba_sum_err > 1e-5 or proba.shape != (rows, CLUSTERS):
        raise AssertionError(f"GaussianNB: two halves' theta {theta_err} from the fit's, accuracy {accuracy}, "
                             f"probability sums {proba_sum_err} from 1")
    del pred, proba, nb2
    hx, cx = head_pair(x)
    hy, cy = head_pair(labels)
    g, c = ht.naive_bayes.GaussianNB().fit(hx, hy), ht.naive_bayes.GaussianNB().fit(cx, cy)
    # the reference's moments subtract E[xc]^2 from E[xc^2] (xc: x less its
    # global mean): each is a float32 sum of terms up to the scale below, and
    # the card and the host add them in other orders (1e-3 apart relative to
    # a variance of 1 at this head, measured): theta is held to 1e-5 of |x|, var to 1e-4 of E[xc^2]
    xc = hx.larray.double() - hx.larray.double().mean(0)
    scale = {"theta_": float(hx.larray.abs().max()), "var_": float((xc * xc).mean(0).max())}
    nb_head = {a: float((getattr(g, a).larray.cpu() - getattr(c, a).larray).abs().max()) / scale[a]
               for a in ("theta_", "var_")}
    nb_head["predict_mismatches"] = int((g.predict(hx).larray.cpu() != c.predict(cx).larray).sum())
    nb_head["proba_max_abs_err"] = float((g.predict_proba(hx).larray.cpu() - c.predict_proba(cx).larray).abs().max())
    if nb_head["theta_"] > 1e-5 or nb_head["var_"] > 1e-4 or nb_head["proba_max_abs_err"] > 1e-5 or \
            nb_head["predict_mismatches"] > 0 or not torch.equal(g.class_count_.larray.cpu(), c.class_count_.larray):
        raise AssertionError(f"GaussianNB at the head (theta and var relative to their scales): {nb_head}")
    del xc
    del nb, g, c

    # BatchParallelKMeans: one batch on one card (k-means++ then Lloyd); a
    # pass of x per k-means++ round and per assignment (each Lloyd iteration
    # and the labels), counted at the assignment
    from heat_tpu_torch.cluster import batchparallelclustering as bpc

    assignments, real_nearest = [0], bpc._nearest

    def counting(points, centres):
        assignments[0] += 1
        return real_nearest(points, centres)

    def passes_per_fit():
        n_fit, assignments[0] = assignments[0] // 2, 0  # timed ran the fit twice
        return CLUSTERS - 1 + n_fit

    bpc._nearest = counting
    try:
        bp = timed("BatchParallelKMeans.fit", lambda: ht.cluster.BatchParallelKMeans(
            n_clusters=CLUSTERS, random_state=1).fit(X), passes_per_fit)
    finally:
        bpc._nearest = real_nearest
    bp_agree = _agreement(bp.labels_.larray, labels, CLUSTERS)
    g = ht.cluster.BatchParallelKMeans(n_clusters=CLUSTERS, random_state=1).fit(hx)
    c = ht.cluster.BatchParallelKMeans(n_clusters=CLUSTERS, random_state=1).fit(cx)
    bp_head = {"centre_max_abs_err": float((g.cluster_centers_.larray.cpu() - c.cluster_centers_.larray).abs().max()),
               "near_ties": near_tie_mismatches(hx.larray, g.cluster_centers_.larray, g.labels_.larray.long(),
                                                c.labels_.larray.to(hx.larray.device).long())}
    bp_fixed = lloyd_fixed_point(x, bp.cluster_centers_.larray, bp.labels_.larray, medians=False)
    if bp_fixed > 1e-2 or bp_head["centre_max_abs_err"] > 5e-5:
        raise AssertionError(f"BatchParallelKMeans: centres {bp_fixed} from their members' mean, head {bp_head}")
    del bp, g, c

    km_rows = KMEDIANS_ROWS
    XM = ht.array(x[:km_rows], split=0)
    bpc._nearest = counting
    try:
        bpm = timed("BatchParallelKMedians.fit", lambda: ht.cluster.BatchParallelKMedians(
            n_clusters=CLUSTERS, random_state=1).fit(XM), passes_per_fit, km_rows,
            rows_note=f"first {km_rows} rows")
    finally:
        bpc._nearest = real_nearest
    bpm_agree = _agreement(bpm.labels_.larray, labels[:km_rows], CLUSTERS)
    g = ht.cluster.BatchParallelKMedians(n_clusters=CLUSTERS, random_state=1).fit(hx)
    c = ht.cluster.BatchParallelKMedians(n_clusters=CLUSTERS, random_state=1).fit(cx)
    bpm_err = float((g.cluster_centers_.larray.cpu() - c.cluster_centers_.larray).abs().max())
    near_tie_mismatches(hx.larray, g.cluster_centers_.larray, g.labels_.larray.long(),
                        c.labels_.larray.to(hx.larray.device).long())
    bpm_fixed = lloyd_fixed_point(x[:km_rows], bpm.cluster_centers_.larray, bpm.labels_.larray, medians=True)
    if bpm_fixed > 1e-2 or bpm_err > 5e-5:
        raise AssertionError(f"BatchParallelKMedians: centres {bpm_fixed} from their members' median, head centres "
                             f"{bpm_err}")
    del bpm, XM, g, c

    # Lasso on 2^25 standard normal rows of the cell's width: y = x w + 0.5 +
    # noise, w with zeros.  On the cell's own rows (8 blobs) the features
    # share the blobs' structure and coordinate descent takes about 900
    # sweeps (measured on the host at 2^16 rows); max_iter=100 stops it
    # mid-course, where a 1e-7 change of x moves theta by 2e-5
    gen = torch.Generator(device=x.device).manual_seed(SEED + 5)
    w = torch.randn(feats, device=x.device, generator=gen)
    w[::4] = 0.0
    xl = torch.randn(LASSO_ROWS, feats, device=x.device, generator=gen)
    yl = xl @ w + 0.5 + 0.01 * torch.randn(LASSO_ROWS, device=x.device, generator=gen)
    XL, YL = ht.array(xl, split=0), ht.array(yl, split=0)
    las, lasso_syncs = count_syncs(lambda: ht.regression.Lasso(lam=0.01).fit(XL, YL))
    sweeps, reads = las.n_iter, lasso_mod.STOP_TEST_READS
    las = timed("Lasso.fit", lambda: ht.regression.Lasso(lam=0.01).fit(XL, YL), sweeps * (feats + 1), LASSO_ROWS,
                sweeps=sweeps, stop_test_reads=reads, host_syncs=lasso_syncs,
                one_read_a_sweep_ms=sweeps * 4 * LASSO_ROWS * feats / HBM_BYTES_PER_S * 1e3)
    yhat = timed("Lasso.predict", lambda: las.predict(XL), 1, LASSO_ROWS)
    coef_err = float((las.coef_.larray.reshape(-1) - w).abs().max())
    fit_err = float((yhat.larray.reshape(-1) - yl).pow(2).mean().sqrt())
    hl, cl = head_pair(yl)
    g = ht.regression.Lasso(lam=0.01).fit(head_pair(xl)[0], hl)
    c = ht.regression.Lasso(lam=0.01).fit(head_pair(xl)[1], cl)
    lasso_head = float((g.theta.larray.cpu() - c.theta.larray).abs().max())
    if coef_err > 1e-3 or fit_err > 0.02 or lasso_head > 1e-5 or g.n_iter != c.n_iter:
        raise AssertionError(f"Lasso: coefficients {coef_err} from w, RMS residual {fit_err} (noise 0.01), head theta "
                             f"{lasso_head}, n_iter {g.n_iter} against {c.n_iter}")
    del XL, YL, yl, yhat, las, g, c, xl
    torch.cuda.empty_cache()

    # Spectral on 2^15 scaled points: K1 and threefry launches, device time by step
    pts = x[:SPECTRAL_ROWS] * SPECTRAL_SCALE
    S = ht.array(pts, split=0)

    def spectral():
        ht.random.seed(SEED + 6)
        return ht.cluster.Spectral(n_clusters=CLUSTERS, gamma=0.5, n_lanczos=300).fit(S)

    zero_launches()
    sp, first_ms = wall_ms(spectral)
    k1, tf = kernels.LLOYD_LAUNCHES, rnd.THREEFRY_LAUNCHES
    if k1 != sp._cluster.n_iter_ + 1 or tf < 1 or other_launches() != k1 + tf:
        raise AssertionError(f"Spectral launched K1 {k1} times for {sp._cluster.n_iter_} iterations, threefry {tf}, "
                             f"{other_launches()} kernels in all")
    sp_agree = _agreement(sp.labels_.larray, labels[:SPECTRAL_ROWS], CLUSTERS)
    _, warm_ms = wall_ms(lambda: spectral().labels_)
    split = profile_fit(lambda: spectral().labels_,
                        labels=("spectral.laplacian", "spectral.lanczos", "spectral.eigh", "spectral.kmeans"))
    hs, cs = (ht.array(pts[:SPECTRAL_HEAD], split=0), ht.array(pts[:SPECTRAL_HEAD].cpu(), split=0, device="cpu"))
    ht.random.seed(SEED + 7)
    g = ht.cluster.Spectral(n_clusters=CLUSTERS, gamma=0.5, n_lanczos=300).fit_predict(hs)
    ht.random.seed(SEED + 7)
    c = ht.cluster.Spectral(n_clusters=CLUSTERS, gamma=0.5, n_lanczos=300).fit_predict(cs)
    sp_head = _agreement(g.larray, c.larray, CLUSTERS)
    if sp_head < 0.99 or not 0 <= int(sp.labels_.larray.min()) <= int(sp.labels_.larray.max()) < CLUSTERS:
        raise AssertionError(f"Spectral: the head's labels {sp_head} the host's (up to their numbering)")
    lap_bytes = 4 * SPECTRAL_ROWS * SPECTRAL_ROWS
    calls.append({"call": "Spectral.fit", "first_ms": first_ms, "warm_ms": warm_ms,
                  "bound_ms": 301 * lap_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                  "bound_note": "L written once and read once a Lanczos step", "k1_launches": k1,
                  "threefry_launches": tf, "labels_agree_truth": sp_agree, "head_agree_host": sp_head,
                  "profile": split})
    del sp, S, pts
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    if peak > ML_PEAK_BYTES:
        raise AssertionError(f"ml_rest took {peak / 1e9} GB at its peak")
    emit({"phase": "ml_rest", "calls": calls, "gaussian_nb": {"accuracy": accuracy, "two_halves_theta_err": theta_err,
          "head": nb_head},
          "batch_parallel_kmeans": {"labels_agree_truth": bp_agree, "centres_from_members_mean": bp_fixed,
                                    "head": bp_head},
          "batch_parallel_kmedians": {"labels_agree_truth": bpm_agree, "centres_from_members_median": bpm_fixed,
                                      "head_centre_err": bpm_err},
          "lasso": {"sweeps": sweeps, "stop_test_reads": reads, "host_syncs": lasso_syncs, "coef_err": coef_err,
                    "head_theta_err": lasso_head},
          "phase_peak_gb": peak / 1e9, "phase_seconds": time.perf_counter() - t_phase, "card": smi})
    return {"lloyd_step": k1, "threefry": tf}


CONV_N = 1 << 27
CONV_TAPS = 1025
NAPI_HEAD = 1 << 16  # rows each napi call also runs on the host


def napi_signal_phase(x, smi: str) -> None:
    """Phase napi_signal: a sweep of napi's exports on the KMeans points (or
    one of their columns), each call's first and warm wall time beside its
    byte bound (its inputs read once, its outputs written once), each also
    run on the first 2^16 rows on the card and on the host (integers,
    indices and bools bitwise, floats within rtol 1e-4, atol 1e-5); then
    ``convolve`` of a 2^27 float32 signal with a 1025-tap kernel in the
    three modes, within 1e-5 (relative to the largest value) of the float64
    convolution on the card, beside the same convolution with cuDNN's TF32
    allowed (the port turns it off) and its bound."""
    import torch
    import heat_tpu_torch as ht

    ht.use_device("gpu")
    rows, feats = x.shape
    f4 = 4
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    col0, col1 = x[:, 0].contiguous(), x[:, 1].contiguous()
    srt = torch.sort(col1[: 1 << 20]).values
    wv = torch.linspace(-1.0, 1.0, feats, device=x.device)
    n, nb = rows, rows * f4
    # (name, call on (m, points, column, other column, sorted, weights), bytes read and written)
    sweep = [
        ("argsort", lambda m, a, c, d, s, w: m.argsort(c), nb + 8 * n),
        ("argsort_desc", lambda m, a, c, d, s, w: m.argsort(c, descending=True), nb + 8 * n),
        ("partition", lambda m, a, c, d, s, w: m.partition(c, 1000), 2 * nb),
        ("lexsort", lambda m, a, c, d, s, w: m.lexsort((c, d)), 2 * nb + 8 * n),
        ("searchsorted", lambda m, a, c, d, s, w: m.searchsorted(s, c), nb + f4 * n),
        ("sort_complex", lambda m, a, c, d, s, w: m.sort_complex(c), nb + 8 * n),
        ("nanmax", lambda m, a, c, d, s, w: m.nanmax(a, axis=0), feats * nb),
        ("nanmean", lambda m, a, c, d, s, w: m.nanmean(a, axis=0), feats * nb),
        ("nanvar", lambda m, a, c, d, s, w: m.nanvar(a, axis=0), feats * nb),
        ("nanstd", lambda m, a, c, d, s, w: m.nanstd(a, axis=0, ddof=1), feats * nb),
        ("nanargmax", lambda m, a, c, d, s, w: m.nanargmax(a, axis=0), feats * nb),
        ("nanmedian", lambda m, a, c, d, s, w: m.nanmedian(c), nb),
        ("quantile", lambda m, a, c, d, s, w: m.quantile(c, [0.1, 0.5, 0.9]), nb),
        ("nanpercentile", lambda m, a, c, d, s, w: m.nanpercentile(a, 75.0, axis=0), feats * nb),
        ("ptp", lambda m, a, c, d, s, w: m.ptp(a, axis=0), feats * nb),
        ("amax", lambda m, a, c, d, s, w: m.amax(a, axis=0), feats * nb),
        ("count_nonzero", lambda m, a, c, d, s, w: m.count_nonzero(a > 0, axis=0), feats * nb),
        ("corrcoef", lambda m, a, c, d, s, w: m.corrcoef(a, rowvar=False), feats * nb),
        ("histogram2d", lambda m, a, c, d, s, w: m.histogram2d(c, d, bins=32), 2 * nb),
        ("histogram_bin_edges", lambda m, a, c, d, s, w: m.histogram_bin_edges(c, bins=64), nb),
        ("append", lambda m, a, c, d, s, w: m.append(c, d), 4 * nb),
        ("delete", lambda m, a, c, d, s, w: m.delete(c, slice(0, None, 3)), nb + nb * 2 // 3),
        ("resize", lambda m, a, c, d, s, w: m.resize(c, (2, n)), 3 * nb),
        ("array_split", lambda m, a, c, d, s, w: m.array_split(a, 4), 0),  # views: no bytes move
        ("dstack", lambda m, a, c, d, s, w: m.dstack([c, d]), 4 * nb),
        ("flatnonzero", lambda m, a, c, d, s, w: m.flatnonzero(c > 0), nb + 4 * n),
        ("extract", lambda m, a, c, d, s, w: m.extract(c > 0, c), nb + nb // 2),
        ("fmax", lambda m, a, c, d, s, w: m.fmax(a, 0.0), 2 * feats * nb),
        ("inner", lambda m, a, c, d, s, w: m.inner(c, d), 2 * nb),
        ("tensordot", lambda m, a, c, d, s, w: m.tensordot(a, w, axes=1), feats * nb + nb),
        ("einsum", lambda m, a, c, d, s, w: m.einsum("ij,j->i", a, w), feats * nb + nb),
        ("vander", lambda m, a, c, d, s, w: m.vander(c, 4), nb + 4 * nb),
        ("correlate", lambda m, a, c, d, s, w: m.correlate(c, d[:64]), 2 * nb),
        ("packbits", lambda m, a, c, d, s, w: m.packbits(c > 0), nb + n // 8),
        ("array_equal", lambda m, a, c, d, s, w: m.array_equal(a, a), 2 * feats * nb),
    ]
    a = ht.array(x, split=0)
    c, d = ht.array(col0, split=0), ht.array(col1, split=0)
    s, w = ht.array(srt), ht.array(wv)
    hd = (ht.array(x[:NAPI_HEAD], split=0), ht.array(col0[:NAPI_HEAD], split=0), ht.array(col1[:NAPI_HEAD], split=0),
          s, w)
    hc = tuple(ht.array(t.larray.cpu(), split=t.split, device="cpu") for t in hd)
    records = []
    for name, call, nbytes in sweep:
        out, first = wall_ms(lambda: call(ht, a, c, d, s, w))
        del out
        out, warm = wall_ms(lambda: call(ht, a, c, d, s, w))
        del out
        got, want = call(ht, *hd), call(ht, *hc)
        err = _napi_mismatch(got, want)
        if err is not None:
            raise AssertionError(f"napi {name} on the card differs from the host at the head: {err}")
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        records.append({"call": name, "first_ms": first, "warm_ms": warm, "bound_ms": bound, "bound_by": "bytes",
                        "share_of_bound": bound / warm})
    emit({"phase": "napi_signal", "calls": records, "head_rows": NAPI_HEAD, "card": smi})
    del a, c, d, s, w, hd, hc, col0, col1
    torch.cuda.empty_cache()

    gen = torch.Generator(device=x.device).manual_seed(SEED + 8)
    sig = torch.randn(CONV_N, device=x.device, generator=gen)
    ker = torch.randn(CONV_TAPS, device=x.device, generator=gen)
    S, K = ht.array(sig, split=0), ht.array(ker)
    conv = []
    for mode in ("full", "same", "valid"):
        out, first = wall_ms(lambda: ht.convolve(S, K, mode=mode))
        del out
        out, warm = wall_ms(lambda: ht.convolve(S, K, mode=mode))
        got = out.larray
        pad = {"full": CONV_TAPS - 1, "same": CONV_TAPS // 2, "valid": 0}[mode]
        sp = torch.nn.functional.pad(sig.double(), (pad, pad))
        want = torch.nn.functional.conv1d(sp[None, None], ker.double().flip(0)[None, None])[0, 0]
        scale = float(want.abs().max())
        err = float((got.double() - want).abs().max()) / scale
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = torch.nn.functional.conv1d(torch.nn.functional.pad(sig, (pad, pad))[None, None],
                                              ker.flip(0)[None, None])[0, 0]
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        tf32_err = float((tf32.double() - want).abs().max()) / scale
        if out.shape != (want.shape[0],) or out.split != 0 or err > 1e-5:
            raise AssertionError(f"convolve {mode}: {err} from float64 (1e-5), shape {out.shape}, split {out.split}")
        n_out = want.shape[0]
        b = {"bytes": 4 * (CONV_N + CONV_TAPS + n_out) / HBM_BYTES_PER_S * 1e3,
             "operations": 2.0 * n_out * CONV_TAPS / F32_FLOPS * 1e3}
        by = max(b, key=b.get)
        conv.append({"mode": mode, "first_ms": first, "warm_ms": warm, "rel_err_vs_float64": err,
                     "tf32_rel_err_vs_float64": tf32_err, "bound_ms": b[by], "bound_by": by,
                     "share_of_bound": b[by] / warm})
        del out, got, want, sp, tf32
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "napi_signal", "convolve": conv, "signal": CONV_N, "taps": CONV_TAPS, "phase_peak_gb": peak / 1e9,
          "phase_seconds": time.perf_counter() - t_phase, "card": smi})
    del sig, ker, S, K
    torch.cuda.empty_cache()


FAULT_N = 1 << 27  # values of each operand of phase faults_f17_f23
FAULT_ROWS = 1 << 20  # rows of its matrices (FAULT_ROWS x 128 = 2^27 values)


def _result_leaves(r) -> list:
    """The DNDarrays of a result (tuples and lists flattened)."""
    return [x for part in r for x in _result_leaves(part)] if isinstance(r, (tuple, list)) else [r]


def faults_f17_f23_phase(smi: str) -> None:
    """Phase faults_f17_f23: the calls of faults F17-F23 (ROADMAP queue 3,
    tests/torch_fault_cases.py) on the card at 2^27 values an operand (a
    2^20 x 128 matrix where the call takes one), each result bitwise the
    port's answer on the host for the same numpy inputs (the bin edges too:
    float16 edges follow XLA's rule exactly), but where the card computes
    in another order or with other roundings: float sums (``trapz`` of
    uint64 in float64 within 1e-12 of the largest value; float16 ``var``
    and ``std``, summed in float32, within one float16 rounding) and
    complex ``logaddexp2`` (exp and log1p, within the reference's float32
    bound: 3e-5 relative, 1e-6 absolute); each call's first and warm wall time beside its byte bound
    (its inputs read once, its outputs written once).  The refusals (F23)
    raise the host's exception type on the card."""
    import ml_dtypes
    import numpy as np
    import torch
    import heat_tpu_torch as ht

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    n, rows = FAULT_N, FAULT_ROWS
    # two draws of 64 random bits a value; the narrower types and the
    # small integers are their bits, so the host draws little
    base = rng.integers(0, 2**63, n, dtype=np.uint64) << np.uint64(1) | np.uint64(1)
    b64 = rng.integers(0, 2**63, n, dtype=np.uint64) << np.uint64(1)
    u16, u32 = (base >> np.uint64(48)).astype(np.uint16), (base >> np.uint64(32)).astype(np.uint32)
    u64 = np.where((b64 >> np.uint64(1)) & np.uint64(1) == 1, base, np.uint64(0))  # zeros for nonzero's sake
    bools = (base >> np.uint64(7)) & np.uint64(1) == 1
    i8 = ((base >> np.uint64(8)) % np.uint64(19)).astype(np.int8) - np.int8(9)
    i16 = ((base >> np.uint64(16)) % np.uint64(600)).astype(np.int16).reshape(-1, 2) - np.int16(300)
    shifts = (base >> np.uint64(24)) % np.uint64(200)
    f16 = (rng.standard_normal(n, dtype=np.float32) * 2).astype(np.float16)
    c64 = (rng.standard_normal(n, dtype=np.float32) + 1j * rng.standard_normal(n, dtype=np.float32)).astype(np.complex64)
    c64b = np.roll(c64, 12345)
    m32, m64 = u32.reshape(rows, -1), u64.reshape(rows, -1)
    small32, small64 = u32[:512].reshape(4, 128), base[:512].reshape(4, 128)
    bf16 = f16.astype(np.float32).astype(ml_dtypes.bfloat16)
    cases = [
        ("F17 histogram float16", lambda m, a: m.histogram(a, bins=64), [f16], 2 * n),
        ("F17 histc float16", lambda m, a: m.histc(a, bins=64), [f16], 2 * n),
        ("F17 histogram2d float16", lambda m, a: m.histogram2d(a[:, 0], a[:, 1], bins=16), [f16.reshape(-1, 2)], 2 * n),
        ("F17 histogramdd int16", lambda m, a: m.histogramdd(a, bins=8), [i16], 2 * n),
        ("F18 diff uint32", lambda m, a: m.diff(a), [u32], 8 * n),
        ("F18 diff uint64", lambda m, a: m.diff(a), [u64], 16 * n),
        ("F18 ediff1d uint16", lambda m, a: m.ediff1d(a), [u16], 4 * n),
        ("F18 outer uint32", lambda m, a, b: m.outer(a, b), [u32[:rows], small32[0]], 4 * n),
        ("F18 matmul uint64", lambda m, a, b: m.matmul(a, b.T), [m64, small64], 8 * n + 8 * rows * 4),
        ("F18 vdot uint32", lambda m, a, b: m.vdot(a, b), [u32, u32[::-1].copy()], 8 * n),
        ("F19 topk uint64", lambda m, a: m.topk(a.reshape((rows, -1)), 8, dim=1), [b64], 8 * n + 16 * rows * 8),
        ("F19 right_shift uint64", lambda m, a, b: a >> b, [b64, shifts], 24 * n),
        ("F19 trapz uint64", lambda m, a: m.trapz(a, axis=0), [m64], 8 * n, (1e-12, "max")),
        ("F19 gradient uint64", lambda m, a: m.gradient(a, axis=0), [m64], 16 * n),
        ("F20 vdot int8", lambda m, a, b: m.vdot(a, b), [i8, i8[::-1].copy()], 2 * n),
        ("F20 vdot bool", lambda m, a, b: m.vdot(a, b), [bools, bools[::-1].copy()], 2 * n),
        ("F20 var float16", lambda m, a: m.var(a, axis=0), [f16.reshape(rows, -1)], 2 * n, (1e-3, 0.0)),
        ("F20 std float16", lambda m, a: m.std(a), [f16], 2 * n, (1e-3, 0.0)),
        ("F20 diff prepend int8", lambda m, a: m.diff(a, prepend=0), [i8], 2 * n),
        ("F21 nanargmax uint32", lambda m, a: m.nanargmax(a), [u32], 4 * n),
        ("F21 nanargmin uint64", lambda m, a: m.nanargmin(a.reshape((rows, -1)), axis=1), [b64], 8 * n),
        ("F21 nanargmax bool", lambda m, a: m.nanargmax(a), [bools], n),
        ("F21 argwhere uint64", lambda m, a: m.argwhere(a), [u64], 8 * n + 8 * int(np.count_nonzero(u64))),
        ("F21 flatnonzero uint64", lambda m, a: m.flatnonzero(a), [u64], 8 * n + 8 * int(np.count_nonzero(u64))),
        ("F21 fmax uint64", lambda m, a, b: m.fmax(a, b), [u64, b64], 24 * n),
        ("F21 fmin complex64", lambda m, a, b: m.fmin(a, b), [c64, c64b], 24 * n),
        ("F21 inner uint64", lambda m, a, b: m.inner(a, b), [m64, small64], 8 * n + 8 * rows * 4),
        ("F21 tensordot uint32", lambda m, a, b: m.tensordot(a, b, axes=([1], [1])), [m32, small32],
         4 * n + 4 * rows * 4),
        ("F21 histogram_bin_edges uint64", lambda m, a: m.histogram_bin_edges(a, bins=32), [b64], 8 * n),
        ("F21 nanmax complex64", lambda m, a: m.nanmax(a), [c64], 8 * n),
        ("F21 nanmin complex64", lambda m, a: m.nanmin(a.reshape((rows, -1)), axis=0), [c64], 8 * n),
        ("F21 histogram complex64", lambda m, a: m.histogram(a, bins=8), [c64], 8 * n),
        ("F21 logaddexp2 complex64", lambda m, a, b: m.logaddexp2(a, b), [c64, c64b], 24 * n, (3e-5, 1e-6)),
        ("F22 array of ml_dtypes bfloat16", lambda m, a: m.array(a, split=0), [bf16], 4 * n),
    ]
    calls = []
    for name, fn, inputs, nbytes, *tol in cases:
        # the first operand split along 0, the others whole; F22 takes the numpy array itself
        def operands(device):
            if name.startswith("F22"):
                return inputs
            return [ht.array(a, split=0 if i == 0 else None, device=device) for i, a in enumerate(inputs)]

        card = operands("gpu")
        ht.use_device("gpu")
        out, first = wall_ms(lambda: fn(ht, *card))
        out, warm = wall_ms(lambda: fn(ht, *card))
        t_host = time.perf_counter()
        host = operands("cpu")
        ht.use_device("cpu")
        want = fn(ht, *host)
        ht.use_device("gpu")
        host_s = time.perf_counter() - t_host
        got_l, want_l = _result_leaves(out), _result_leaves(want)
        if len(got_l) != len(want_l):
            raise AssertionError(f"faults {name}: {len(got_l)} results on the card, {len(want_l)} on the host")
        err = None
        for g_, w_ in zip(got_l, want_l):
            if g_.dtype is not w_.dtype or tuple(g_.shape) != tuple(w_.shape) or not g_.larray.is_cuda:
                raise AssertionError(f"faults {name}: {g_.dtype} {g_.shape} on the card, {w_.dtype} {w_.shape} host")
            gn, wn = g_.numpy(), w_.numpy()
            if not tol:
                if gn.tobytes() != wn.tobytes():
                    raise AssertionError(f"faults {name}: the card's result differs from the host's")
                continue
            rtol, atol = tol[0]
            if atol == "max":  # within rtol of the largest value
                rtol, atol = 0.0, rtol * float(np.abs(wn).max())
            diff = np.abs(gn.astype(np.complex128) - wn.astype(np.complex128))
            err = max(err or 0.0, float(np.max(diff / (atol + rtol * np.abs(wn) + 1e-300))))
            if err > 1.0:
                raise AssertionError(f"faults {name}: the card's result is {err} tolerances from the host's")
        calls.append({"call": name, "wall_ms": first, "warm_ms": warm, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "host_s": host_s, **({"bitwise_host": True} if not tol else {"tolerance": list(tol[0]),
                                                                  "err_in_tolerances": err})})
        emit({"phase": "faults_f17_f23", **calls[-1], "card": smi})
        del out, want, card, host
    refusals = []
    x2 = ht.array(rng.standard_normal((64, 4)).astype(np.float32), device="gpu")
    b2 = ht.array(np.sort(rng.standard_normal((2, 3)).astype(np.float32), axis=1), device="gpu")
    for name, call in (("F23 bucketize 2-d boundaries", lambda: ht.bucketize(x2, b2)),
                       ("F23 digitize 2-d bins", lambda: ht.digitize(x2, b2)),
                       ("F23 delete float index", lambda: ht.delete(x2, np.array([0.0, 2.0]), axis=0)),
                       ("F23 kron bool", lambda: ht.kron(x2 > 0, x2 < 0)),
                       ("F23 percentile 2-d q", lambda: ht.percentile(x2, np.array([[10.0, 50.0]]))),
                       ("F23 isnan second positional", lambda: ht.isnan(x2, 1))):
        try:
            call()
        except (TypeError, ValueError) as e:
            refusals.append({"call": name, "raises": type(e).__name__})
        else:
            raise AssertionError(f"faults {name}: the card answered where the reference refuses")
    emit({"phase": "faults_f17_f23", "values": n, "calls": len(calls), "refusals": refusals,
          "phase_seconds": time.perf_counter() - t_phase, "card": smi})


RES_IO_ROWS = 1 << 24  # 2^24 x 16 float32: 1 GiB through .npy
RES_SPGEMM_ROWS = 1 << 20  # the ring SpGEMM of phase sparse, S @ S of 2^20 x 2^20, 16 a row


def resilience_phase(x, smi: str) -> dict:
    """Phase resilience: the fault, retry, span and guard layer on the card.

    * KMeans(n_clusters=8, init="random").fit on the KMeans points inside
      ``telemetry.span`` blocks, under torch.profiler: the spans land in
      the ring (``spans.recorded``), their ``record_function`` labels in
      the profile with the device time of the kernels launched under them,
      and the fit's K1 and threefry launches are counted;
    * a 1 GiB .npy save and load under a plan that fails the first
      ``io.write`` and the first ``io.open``: each retried once by the io
      policy (``retry.*``), the file read back bitwise, its sidecar
      verified;
    * the ring SpGEMM S @ S (2^20 x 2^20, 16 entries a row) under a plan
      that fails its first ``comm.collective`` site: the product aborts
      with TransientFault, and under the same plan ``RetryPolicy().call``
      gives the unfaulted product bitwise;
    * ``guard_finite`` on the points (finite: one host sync) and on a
      copy of 2^20 rows with one NaN planted (DivergenceError).

    Returns the launches of K1, threefry and csr_spmm the phase made."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    import heat_tpu_torch as ht
    from heat_tpu_torch import resilience, telemetry
    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.core import random as rnd
    from heat_tpu_torch.sparse import _planes

    t_phase = time.perf_counter()
    ht.use_device("gpu")
    pts = ht.array(x, split=0)
    telemetry.reset_all("telemetry")
    zero_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with telemetry.span("resilience.kmeans", rows=int(x.shape[0])):
            with telemetry.span("kmeans.fit"):
                km = ht.cluster.KMeans(n_clusters=CLUSTERS, init="random", random_state=SEED,
                                       max_iter=MAX_ITER).fit(pts)
            with telemetry.span("kmeans.predict"):
                km.predict(pts[:4096])
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) * 1e3
    launches = {"lloyd_step": kernels.LLOYD_LAUNCHES, "threefry": rnd.THREEFRY_LAUNCHES}
    if launches["lloyd_step"] < km.n_iter_ + 1 or launches["threefry"] != 1:
        raise AssertionError(f"resilience: the fit under spans launched K1 {launches['lloyd_step']} times for "
                             f"{km.n_iter_} iterations and threefry {launches['threefry']} times")
    recorded = [(s.name, s.depth) for s in telemetry.get_spans()]
    if recorded != [("kmeans.fit", 1), ("kmeans.predict", 1), ("resilience.kmeans", 0)] or \
            telemetry.snapshot()["spans.recorded"] != 3:
        raise AssertionError(f"resilience: the spans recorded are {recorded}")
    # each span's label: its host range, and the device time of the kernels
    # launched inside it.  A kernel is joined to the runtime call that
    # launched it (cudaLaunchKernel and the like, whoever called it: K1's
    # ctypes launches too) by CUPTI's correlation id, and counts for the span
    # whose range holds that call, however late the card runs it
    names = ("resilience.kmeans", "kmeans.fit", "kmeans.predict")
    on_card = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    host = [e for e in raw if e.device_type() != on_card]
    ranges = {e.name(): (e.start_ns(), e.end_ns()) for e in host if e.name() in names}
    if set(ranges) != set(names):
        raise AssertionError(f"resilience: the profile holds the span labels {sorted(ranges)}")
    calls = {e.correlation_id(): e.start_ns() for e in host if re.match(r"cu(da)?[A-Z]", e.name())}
    kernels_ = [e for e in raw if e.device_type() == on_card and e.name() not in names
                and not e.name().startswith(("Memcpy", "Memset"))]
    launched = [(calls[e.correlation_id()], e) for e in kernels_ if e.correlation_id() in calls]
    labels = {}
    for name, (lo, hi) in ranges.items():
        inside = [e for t, e in launched if lo <= t <= hi]
        labels[name] = {"host_ms": (hi - lo) / 1e6, "kernel_ms": sum(e.duration_ns() for e in inside) / 1e6,
                        "kernels": len(inside), "k1_kernels": sum("lloyd" in e.name() for e in inside)}
    k1 = [e for e in kernels_ if "lloyd" in e.name()]
    covered = labels["kmeans.fit"]["k1_kernels"] + labels["kmeans.predict"]["k1_kernels"]
    if len(k1) < launches["lloyd_step"] or covered != len(k1) or \
            labels["resilience.kmeans"]["kernels"] != len(launched) or len(launched) != len(kernels_):
        raise AssertionError(f"resilience: {len(k1)} K1 kernels in the profile for {launches['lloyd_step']} "
                             f"launches, {covered} of them launched under the fit's and predict's spans; "
                             f"{len(launched)} of {len(kernels_)} kernels joined to a launch, "
                             f"{labels['resilience.kmeans']['kernels']} under the outer span")
    seen = set(ranges)
    emit({"phase": "resilience", "step": "kmeans_under_spans", "fit_and_predict_wall_ms": fit_ms,
          "n_iter": km.n_iter_, "lloyd_launches": launches["lloyd_step"], "threefry_launches": launches["threefry"],
          "spans": recorded, "profile_labels": sorted(seen), "by_span": labels, "card": smi})
    del km

    # 1 GiB through .npy with the first write and the first open failing
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        path = os.path.join(tmp, "x.npy")
        data = ht.array(x[:RES_IO_ROWS].contiguous(), split=0)
        before = resilience.retry_stats()
        with resilience.fault_plan({"io.write": [0], "io.open": [0]}) as inj:
            _, save_ms = wall_ms(lambda: ht.save(data, path))
            back, load_ms = wall_ms(lambda: ht.load(path, split=0))
        after = resilience.retry_stats()
        retried = {k: after[k] - before[k] for k in after}
        if inj.injected != {"io.write": [(0, "transient")], "io.open": [(0, "transient")]} or retried["retries"] != 2:
            raise AssertionError(f"resilience io: injected {inj.injected}, retries {retried}")
        if not torch.equal(back.larray, data.larray) or resilience.verify_checksum(path) is not True:
            raise AssertionError("resilience io: the retried round trip is not bitwise, or its sidecar fails")
        if sorted(os.listdir(tmp)) != ["x.npy", "x.npy.crc32"]:
            raise AssertionError(f"resilience io: the failed attempt left {sorted(os.listdir(tmp))}")
        gb = data.larray.numel() * 4 / 1e9
        emit({"phase": "resilience", "step": "npy_retried", "array_gb": gb, "save_s": save_ms / 1e3,
              "load_s": load_ms / 1e3, "injected": {k: len(v) for k, v in inj.injected.items()}, "retry": retried,
              "check": "round trip bitwise after one retried fault each way, CRC32 sidecar verified",
              "card": smi})
        del back, data
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the ring SpGEMM failing at its first re-sync, then retried
    g = torch.Generator(device=x.device).manual_seed(SEED + 23)
    coo = random_graph(RES_SPGEMM_ROWS, SPARSE_DEGREE, x.device, g)
    S = ht.sparse.sparse_csr_matrix(coo, split=0)
    del coo
    os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"] = "1.0"  # the ring route, whatever the estimate
    try:
        spmm0 = _planes.CSR_SPMM_LAUNCHES
        clean, clean_ms = wall_ms(lambda: S @ S)
        want = fingerprint(clean)
        del clean
        plan = {"comm.collective": [0]}
        with resilience.fault_plan(plan) as inj:
            try:
                S @ S
            except resilience.TransientFault as e:
                aborted = {"site": e.site, "index": e.index}
            else:
                raise AssertionError("resilience spgemm: the injected fault did not abort the product")
        with resilience.fault_plan(plan) as inj2:
            again, retry_ms = wall_ms(lambda: resilience.RetryPolicy().call(lambda: S @ S))
        if fingerprint(again) != want:
            raise AssertionError("resilience spgemm: the retried product differs from the unfaulted one")
        spmm = _planes.CSR_SPMM_LAUNCHES - spmm0
    finally:
        del os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"]
    emit({"phase": "resilience", "step": "spgemm_ring_retried", "rows": RES_SPGEMM_ROWS, "nnz_in": S.gnnz,
          "nnz_out": again.gnnz, "clean_ms": clean_ms, "aborted_at": aborted, "retried_ms": retry_ms,
          "sites_evaluated": inj2.hits, "retried_bitwise_unfaulted": True, "csr_spmm_launches": spmm, "card": smi})
    del S, again
    torch.cuda.empty_cache()

    # guard_finite: the points pass, a planted NaN raises
    _, ok_ms = wall_ms(lambda: resilience.guard_finite(pts))
    bad = ht.array(x[: 1 << 20].clone(), split=0)
    bad.larray[12345, 3] = float("nan")
    try:
        resilience.guard_finite({"centers": bad}, what="centers", iteration=7)
    except resilience.DivergenceError as e:
        caught = {"iteration": e.iteration, "message": str(e)}
    else:
        raise AssertionError("resilience: guard_finite passed a tensor with a NaN")
    emit({"phase": "resilience", "step": "guard_finite", "finite_points_ms": ok_ms,
          "bound_ms": x.numel() * 4 / HBM_BYTES_PER_S * 1e3, "divergence": caught,
          "phase_seconds": time.perf_counter() - t_phase, "card": smi})
    return {**launches, "csr_spmm": spmm}


def _napi_mismatch(got, want):
    """None where a napi result on the card is the host's (integers, indices
    and bools bitwise, floats within rtol 1e-4, atol 1e-5: float32 sums of
    2^16 terms in the card's order and the host's), else what differs."""
    import numpy as np
    import heat_tpu_torch as ht

    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            err = _napi_mismatch(g, w)
            if err is not None:
                return err
        return None
    if not isinstance(want, ht.DNDarray):
        return None if np.allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5) else (got, want)
    if got.split != want.split or got.dtype != want.dtype or got.shape != want.shape:
        return (got.split, want.split, got.dtype, want.dtype, got.shape, want.shape)
    g, w = got.numpy(), want.numpy()
    if g.dtype.kind in "biu":
        return None if np.array_equal(g, w) else "values"
    ok = np.allclose(g, w, rtol=1e-4, atol=1e-5, equal_nan=True)
    return None if ok else float(np.nanmax(np.abs(g.astype(np.float64) - w)))


def compare_gram(x, n_true: int) -> dict:
    """The Gram kernel against its plain version on the same inputs:
    relative Frobenius error at most 5e-6, G exactly symmetric, and a second
    launch bitwise equal to the first."""
    import torch
    from heat_tpu_torch.core import kernels

    got = kernels.gram_partials(x, n_true)
    again = kernels.gram_partials(x, n_true)
    want = kernels._gram_plain(x, n_true)
    torch.cuda.synchronize()
    diff = got.double() - want.double()
    rel = float(diff.norm() / want.double().norm())
    if rel > 5e-6:
        raise AssertionError(f"Gram of {tuple(x.shape)} differs from the plain version by {rel} (Frobenius, relative)")
    if not torch.equal(got, got.T):
        raise AssertionError(f"Gram of {tuple(x.shape)} is not exactly symmetric")
    if not torch.equal(got, again):
        raise AssertionError(f"two Gram launches on {tuple(x.shape)} differ")
    return {"rows": x.shape[0], "n": x.shape[1], "n_true": n_true, "rel_frobenius_err": rel,
            "max_abs_err": float(diff.abs().max()), "max_abs_g": float(want.abs().max()),
            "symmetric": True, "bitwise_repeat": True}


def spectrum_matrix(dev):
    """The hSVD path's matrix, built in place on the card from a seeded
    generator: 0.01 N(0, 1) noise plus z w, z (rows, 16) and w (16, 128)
    normal with w's rows scaled 10, 9, ..., 1, 0.5, 0.1, ..., 0.005, so that
    the spectrum decays (hsvd_rtol at 1e-2 keeps 11 directions)."""
    import torch
    from heat_tpu_torch.core.linalg.basics import full_f32_matmul

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    a = torch.randn(HSVD_ROWS, HSVD_COLS, device=dev, generator=g)
    a.mul_(0.01)
    z = torch.randn(HSVD_ROWS, 16, device=dev, generator=g)
    scale = torch.tensor([10.0 - i for i in range(10)] + [0.5, 0.1, 0.05, 0.02, 0.01, 0.005], device=dev)
    w = torch.randn(16, HSVD_COLS, device=dev, generator=g) * scale[:, None]
    with full_f32_matmul():
        a.addmm_(z, w)
    return a


def plain_spectrum(a):
    """Eigenvalues of the plain version's Gram matrix, descending, float64."""
    import torch
    from heat_tpu_torch.core import kernels

    return torch.linalg.eigvalsh(kernels._gram_plain(a, a.shape[0]).double()).flip(0).clamp(min=0.0)


def check_factors(U, S, err, lam, k: int) -> dict:
    """hsvd's factors against the plain spectrum: S within rtol 1e-4 of its
    square roots, U^T U within 1e-4 of I (in float64), rel_err within 1e-4
    of sqrt(1 - sum S^2 / |a|^2)."""
    import torch

    s = S.larray.double()
    want_s = lam[:k].sqrt()
    if S.shape != (k,) or not bool(torch.isfinite(s).all()):
        raise AssertionError(f"S has shape {S.shape}, not ({k},), or is not finite")
    s_err = float(((s - want_s).abs() / want_s).max())
    if s_err > 1e-4:
        raise AssertionError(f"singular values differ from the plain spectrum's by {s_err} relative")
    u = U.larray.double()
    orth = float((u.T @ u - torch.eye(k, dtype=torch.float64, device=u.device)).abs().max())
    if orth > 1e-4:
        raise AssertionError(f"U^T U differs from I by {orth}")
    want_err = float(torch.sqrt(torch.clamp(1.0 - (want_s**2).sum() / lam.sum(), min=0.0)))
    if abs(float(err) - want_err) > 1e-4:
        raise AssertionError(f"rel_err {float(err)} against {want_err} from the plain spectrum")
    return {"k": k, "s_max_rel_err": s_err, "u_orthonormality_err": orth, "rel_err": float(err),
            "plain_rel_err": want_err}


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64 or complex128."""
    import torch

    wide = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    w = want.to(wide)
    return float((got.to(wide) - w).abs().max() / w.abs().max())


def fft_launches() -> dict:
    from heat_tpu_torch.fft import _axis_pass, _leading

    return {"fft_stage": _leading.FFT_STAGE_LAUNCHES, "fft_pair": _leading.FFT_PAIR_LAUNCHES,
            "fft_ext": _leading.FFT_EXT_LAUNCHES, "fft_axis": _axis_pass.FFT_AXIS_LAUNCHES}


def zero_launches() -> None:
    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.core import random as rnd
    from heat_tpu_torch.fft import _axis_pass, _leading
    from heat_tpu_torch.nn import _flash

    from heat_tpu_torch.sparse import _planes

    kernels.LLOYD_LAUNCHES = kernels.GRAM_LAUNCHES = 0
    rnd.THREEFRY_LAUNCHES = 0
    _planes.CSR_SPMM_LAUNCHES = 0
    _leading.FFT_STAGE_LAUNCHES = _leading.FFT_PAIR_LAUNCHES = _leading.FFT_EXT_LAUNCHES = 0
    _axis_pass.FFT_AXIS_LAUNCHES = 0
    _flash.FLASH_LAUNCHES = 0
    for key in _flash.FLASH_BWD_LAUNCHES:
        _flash.FLASH_BWD_LAUNCHES[key] = 0


def other_launches() -> int:
    """Launches of every kernel but K7 and K7-bwd since the counts were last
    zeroed."""
    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.core import random as rnd
    from heat_tpu_torch.sparse import _planes

    return (kernels.LLOYD_LAUNCHES + kernels.GRAM_LAUNCHES + rnd.THREEFRY_LAUNCHES + sum(fft_launches().values())
            + _planes.CSR_SPMM_LAUNCHES)


def compare_fft(kernel, plain, label: str) -> dict:
    """A kernel wrapper against its plain version on the same card tensors:
    relative error at most 1e-5 on every output, and a second launch
    bitwise equal to the first."""
    import torch

    def outs(r):
        return tuple(r) if isinstance(r, tuple) else (r,)

    got, again, want = outs(kernel()), outs(kernel()), outs(plain())
    torch.cuda.synchronize()
    rel = max(rel_err(g, w) for g, w in zip(got, want))
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    if any(g.shape != w.shape for g, w in zip(got, want)) or rel > 1e-5:
        raise AssertionError(f"{label}: {[tuple(g.shape) for g in got]} against {[tuple(w.shape) for w in want]}, "
                             f"relative error {rel}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    return {"case": label, "rel_err": rel, "max_abs_err": err, "bitwise_repeat": True}


def bound(nbytes: float, flops: float) -> tuple:
    """The least time the card could take, in ms, and what bounds it: the
    bytes at the HBM rate or the operations at the bf16 tensor-core rate."""
    b = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": flops / BF16_FLOPS * 1e3}
    by = max(b, key=b.get)
    return b[by], by


def fft_kernels(dev, g, smi: str) -> list:
    """Phase fft_check: K3-K6 against their plain versions at the main
    path's shapes (timed there, beside their bounds and torch.fft) and at
    ragged ones, and the inputs they refuse.  Returns the kernel entries of
    the summary line, launches still to fill in."""
    import torch
    from heat_tpu_torch.fft import _axis_pass, _leading

    n = FFT_N
    m = n // 2

    def wcat(k, inverse=False, scale=1.0, like=None):
        return _leading._w(_leading._w_cat, k, "float32", inverse, scale, like=like)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    def offset(*shape):
        """A contiguous tensor whose data starts one float past an aligned
        address (4-byte aligned only, as a view z[..., 1:] is)."""
        flat = torch.randn(int(torch.Size(shape).numel()) + 1, device=dev, generator=g)
        return flat[1:].view(shape)

    entries = []

    def finish(name, source, replaces, checks, kernel, plain, library, nbytes, flops, stage_flops=None, note=None,
               tensor_flops=None):
        kernel_ms = time_ms(kernel, reps=10)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        library_ms = time_ms(library, reps=10) if library is not None else None
        bound_ms, bound_by = bound(nbytes, flops)
        for c in checks:
            emit({"phase": "fft_check", "kernel": name, **c})
        line = {"phase": "fft_check", "kernel": name, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms, "library_ms": library_ms, "card": smi}
        if stage_flops is not None:
            line["cuda_core_floor_ms"] = stage_flops / F32_FLOPS * 1e3
        if tensor_flops is not None:
            line["tf32x3_floor_ms"] = 3 * tensor_flops / TF32_FLOPS * 1e3
        if note:
            line["library_note"] = note
        emit(line)
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": None,
                        "max_abs_err": max(c["max_abs_err"] for c in checks), "ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})

    # K3: the mid stage of the real 512^3 fftn, blocked form: z (K = 512, B = 512, 2m = 512)
    z = randn(n, n, 2 * m)
    w = wcat(n, like=z)
    k3 = lambda: _leading._stage_fused_blocked(z, n, m, False, 1.0)  # noqa: E731
    k3_plain = lambda: _leading._stage(z[..., :m], z[..., m:], w, n)  # noqa: E731
    checks = [compare_fft(k3, k3_plain, f"blocked ({n}, {n}, {2 * m})")]
    zs = randn(100, 7, 2 * 37)
    checks.append(compare_fft(lambda: _leading._stage_fused_blocked(zs, 100, 37, True, 0.01),
                              lambda: _leading._stage(zs[..., :37], zs[..., 37:], wcat(100, True, 0.01, zs), 100),
                              "blocked (100, 7, 74), inverse, scaled"))
    re, im = randn(96, 5, 33), randn(96, 5, 33)
    checks.append(compare_fft(lambda: _leading._stage_fused(re, im, 96, False, 1.0),
                              lambda: _leading._stage(re, im, wcat(96, like=re), 96), "planes (96, 5, 33)"))
    # the tensor-core tiles' edges: K = n not a multiple of 8 (or 1), M one
    # past a 128-row tile, planes only 4-byte aligned, complex64 views read in
    # place as (re, im) pairs, cat operands whose row tiles straddle blocks
    for k, rest, off in ((1, (5,), False), (33, (129,), False), (100, (2, 65), True), (37, (257,), True)):
        pr, pi = (offset if off else randn)(k, *rest), (offset if off else randn)(k, *rest)
        wk = wcat(k, False, 0.5, pr)
        checks.append(compare_fft(lambda: _leading._stage_fused(pr, pi, k, False, 0.5),
                                  lambda: _leading._stage(pr, pi, wk, k),
                                  f"planes ({k}, {', '.join(map(str, rest))}){' offset by one float' if off else ''}"))
        cp = torch.complex(pr, pi)
        checks.append(compare_fft(lambda: _leading._stage_fused(cp.real, cp.imag, k, False, 0.5),
                                  lambda: _leading._stage(pr, pi, wk, k),
                                  f"complex64 views ({k}, {', '.join(map(str, rest))})"))
    for k, b, mm, off in ((96, 5, 36, False), (40, 7, 37, False), (64, 3, 44, True)):
        zb = (offset if off else randn)(k, b, 2 * mm)
        wk = wcat(k, True, like=zb)
        checks.append(compare_fft(lambda: _leading._stage_fused_blocked(zb, k, mm, True, 1.0),
                                  lambda: _leading._stage(zb[..., :mm], zb[..., mm:], wk, k),
                                  f"blocked ({k}, {b}, {2 * mm}), row tiles straddle blocks"
                                  f"{', offset by one float' if off else ''}"))
    cz = torch.complex(z[..., :m], z[..., m:])  # K3's operand as complex data, for torch.fft over its axis
    K, M = n, n * m
    finish("fft_stage", "heat_tpu_torch/csrc/fft_stage.cu", "heat_tpu/fft/_leading.py:220", checks, k3, k3_plain,
           lambda: torch.fft.fft(cz, dim=0), 4 * (2 * K * M + 2 * M * n + K * 2 * n), 3 * 8 * K * M * n,
           stage_flops=8 * K * M * n, tensor_flops=8 * K * M * n)
    del z, cz, w

    # K4: one pair stage of the complex 512^3 transform: z (K = 512, 512, 2, 512), and the entry
    zp = randn(n, n, 2, n)
    w = wcat(n, like=zp)
    k4 = lambda: _leading._stage_pair_fused(zp, n, False, 1.0)  # noqa: E731

    def k4_plain():
        z3 = zp.reshape(n, n, 2 * n)
        return _leading._pair_plain(z3[..., :n].reshape(n, -1), z3[..., n:].reshape(n, -1), w, n).reshape(n, n, 2, n)

    checks = [compare_fft(k4, k4_plain, f"pair stage ({n}, {n}, 2, {n})")]
    checks.append(compare_fft(lambda: _leading._entry_pair_fused(zp[:, :, 0], zp[:, :, 1], n, True),
                              lambda: _leading._pair_plain(zp[:, :, 0].reshape(n, -1), zp[:, :, 1].reshape(n, -1),
                                                           wcat(n, True, like=zp), n).reshape(n, n, 2, n),
                              f"entry ({n}, {n}, {n}), inverse"))
    zr_ = randn(64, 5, 2, 50)
    checks.append(compare_fft(lambda: _leading._stage_pair_fused(zr_, 64, False, 0.5, planes=True),
                              lambda: (lambda o: (o[..., 0, :], o[..., 1, :]))(_leading._stage_pair(zr_, 64, False, 0.5)),
                              "pair stage (64, 5, 2, 50) into complex64, against the pair-block product"))
    zo = offset(9, 2, 3, 2, 13)
    checks.append(compare_fft(lambda: _leading._stage_pair_fused(zo, 9, False, 0.5),
                              lambda: _leading._stage_pair(zo, 9, False, 0.5),
                              "pair stage (9, 2, 3, 2, 13) offset by one float, against the pair-block product"))
    # the C entry on element stride 2 that is not one complex64 tensor: an
    # interleaved operand only 4-byte aligned, and planes of two tensors,
    # written with element stride 2 into two tensors
    xi_, yi_ = offset(40, 300, 2), randn(40, 300, 2)
    w40 = wcat(40, like=xi_)
    for label, (pr, pi) in (("interleaved, offset by one float", (xi_[..., 0], xi_[..., 1])),
                            ("planes of two tensors", (xi_[..., 0], yi_[..., 1]))):
        def strided(pr=pr, pi=pi):
            o_re, o_im = torch.empty(300, 40, 2, device=dev), torch.empty(300, 40, 2, device=dev)
            _leading._launch_stage(pr.data_ptr(), pi.data_ptr(), 600, 2, 300, 0, 40, 300, 40, w40, o_re.data_ptr(),
                                   o_im.data_ptr(), 80, 2, dev)
            return o_re[..., 0], o_im[..., 0]

        checks.append(compare_fft(strided, lambda pr=pr, pi=pi: _leading._stage(pr.contiguous(), pi.contiguous(),
                                                                                  w40, 40),
                                  f"element stride 2 (40, 300), {label}, outputs with element stride 2"))
    cz = torch.complex(zp[:, :, 0], zp[:, :, 1])
    K, M = n, n * n
    finish("fft_pair", "heat_tpu_torch/csrc/fft_stage.cu", "heat_tpu/fft/_leading.py:369", checks, k4, k4_plain,
           lambda: torch.fft.fft(cz, dim=0), 4 * (2 * K * M + 2 * M * n + K * 2 * n), 3 * 8 * K * M * n,
           stage_flops=8 * K * M * n, tensor_flops=8 * K * M * n)
    del zp, cz, w

    # K5: the raw exit products (m, n1, 2 n2) of the real 512^3 fftn and its Nyquist planes
    zr, zi = randn(m, n, 2 * n), randn(m, n, 2 * n)
    nyr, nyi = randn(n, n), randn(n, n)
    k5 = lambda: _leading._ext_fused(zr, zi, nyr, nyi)  # noqa: E731

    def ext_plain(a, b, c, d):
        h = a.shape[2] // 2
        return _leading._ext_xla(a[..., :h] - b[..., h:], a[..., h:] + b[..., :h], c, d)

    k5_plain = lambda: ext_plain(zr, zi, nyr, nyi)  # noqa: E731
    checks = [compare_fft(k5, k5_plain, f"extension ({m}, {n}, {2 * n})")]
    small = [randn(5, 7, 18), randn(5, 7, 18), randn(7, 9), randn(7, 9)]
    checks.append(compare_fft(lambda: _leading._ext_fused(*small), lambda: ext_plain(*small), "extension (5, 7, 18)"))
    if any(c["max_abs_err"] != 0.0 for c in checks):
        raise AssertionError("the extension is an exact copy after one subtraction, yet differs from its plain version")
    finish("fft_ext", "heat_tpu_torch/csrc/fft_ext.cu", "heat_tpu/fft/_leading.py:491", checks, k5, k5_plain, None,
           4 * (2 * m * n * 2 * n + 2 * n * n) + 8 * 2 * m * n * n, 2 * m * n * n * 2,
           note="no single PyTorch call computes the combine plus the Hermitian extension")
    del zr, zi, nyr, nyi

    # K6: the last-axis pass of fft on (2^19, 1024) complex64, read in place from the complex tensor
    sig = torch.complex(randn(FFT1_ROWS, FFT1_N), randn(FFT1_ROWS, FFT1_N))
    n1, n2 = _axis_pass._split_factors(FFT1_N)
    consts = _axis_pass.on_device(_axis_pass._kernel_consts, FFT1_N, False, device=dev)
    k6 = lambda: _axis_pass.fused_axis_pass(sig.real, sig.imag, False)  # noqa: E731
    k6_plain = lambda: _axis_pass._axis_pass_plain(sig.real, sig.imag, n1, n2, consts)  # noqa: E731
    checks = [compare_fft(k6, k6_plain, f"axis pass ({FFT1_ROWS}, {FFT1_N}) complex64")]
    for rows, length, real, inverse in ((37, 1000, True, False), (300, 96, False, True), (5, 6, False, False),
                                        (1003, 384, False, False), (64, 127, True, True)):
        xr = randn(rows, length)
        xi = None if real else randn(rows, length)
        f1, f2 = _axis_pass._split_factors(length)
        cst = _axis_pass.on_device(_axis_pass._kernel_consts, length, inverse, device=dev)
        checks.append(compare_fft(lambda: _axis_pass.fused_axis_pass(xr, xi, inverse),
                                  lambda: _axis_pass._axis_pass_plain(xr, xi, f1, f2, cst),
                                  f"axis pass ({rows}, {length}){' real' if real else ''}{' inverse' if inverse else ''}"))
    # the tensor-core tiles' edges: n1 = 6, 127, 125 and 128 (padded to a
    # multiple of 8), several blocks' rows, planes only 4-byte aligned, and
    # complex64 views read in place
    for length in (6, 127, 1000, 1024):
        f1, f2 = _axis_pass._split_factors(length)
        cst = _axis_pass.on_device(_axis_pass._kernel_consts, length, True, device=dev)
        xr, xi = offset(300, length), offset(300, length)
        for label, args in (("real", (xr, None)), ("complex", (xr, xi))):
            checks.append(compare_fft(lambda args=args: _axis_pass.fused_axis_pass(*args, True),
                                      lambda args=args: _axis_pass._axis_pass_plain(*args, f1, f2, cst),
                                      f"axis pass (300, {length}) {label}, offset by one float, inverse"))
        xc = torch.complex(xr, xi)
        checks.append(compare_fft(lambda: _axis_pass.fused_axis_pass(xc.real, xc.imag, True),
                                  lambda: _axis_pass._axis_pass_plain(xr, xi, f1, f2, cst),
                                  f"axis pass (300, {length}) complex64 views, inverse"))
    B = FFT1_ROWS
    finish("fft_axis", "heat_tpu_torch/csrc/fft_axis.cu", "heat_tpu/fft/_pallas_fft.py:141", checks, k6, k6_plain,
           lambda: torch.fft.fft(sig, dim=-1), 8 * B * FFT1_N * 2 + 4 * 2 * (n1 * n1 + FFT1_N + n2 * n2),
           B * FFT1_N * (3 * 8 * n1 + 8 * n2 + 6), stage_flops=B * FFT1_N * (8 * n1 + 8 * n2 + 6),
           tensor_flops=B * FFT1_N * 8 * n1)
    del sig

    refused = []
    d = torch.zeros(8, 4, device=dev, dtype=torch.float64)
    for what, call, err in (
        ("K3 float64", lambda: _leading._stage_fused(d, d, 8, False, 1.0), TypeError),
        ("K3 no rows", lambda: _leading._stage_fused(torch.zeros(8, 0, device=dev), torch.zeros(8, 0, device=dev),
                                                    8, False, 1.0), ValueError),
        ("K4 float64", lambda: _leading._entry_pair_fused(d, d, 8, False), TypeError),
        ("K5 float64", lambda: _leading._ext_fused(d[None], d[None], d[:, :2], d[:, :2]), TypeError),
        ("K6 float64", lambda: _axis_pass.fused_axis_pass(d.reshape(2, 16), None, False), TypeError),
        ("K6 n = 262 (2 x 131, no factor pair)", lambda: _axis_pass.fused_axis_pass(
            torch.zeros(2, 262, device=dev), None, False), ValueError),
    ):
        try:
            call()
        except err:
            refused.append(what)
        else:
            raise AssertionError(f"{what} was taken")
    emit({"phase": "fft_check", "refused": refused})
    return entries


def fft_path(dev, g, smi: str) -> dict:
    """Phases fftn, fft2_fft, fft_profile and fft_times; returns the FFT
    kernels' launches on the main path (fftn, fftn and ifftn of the cube's
    spectrum, fft2 and fft)."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import kernels

    # 13. the FFT path, through the entry points a user calls: a real 512^3 cube, split=0
    x = torch.randn(FFT_N, FFT_N, FFT_N, device=dev, generator=g)
    X = ht.array(x, split=0)
    zero_launches()
    spec, real_ms = wall_ms(lambda: ht.fft.fftn(X))
    real_launches = fft_launches()
    spec2, complex_ms = wall_ms(lambda: ht.fft.fftn(spec))
    back, inverse_ms = wall_ms(lambda: ht.fft.ifftn(spec))
    fftn_launches = fft_launches()
    if real_launches != {"fft_stage": 1, "fft_pair": 0, "fft_ext": 1, "fft_axis": 0}:
        raise AssertionError(f"the real fftn launched {real_launches}; K3 and K5 once each, nothing else")
    if fftn_launches != {"fft_stage": 1, "fft_pair": 6, "fft_ext": 1, "fft_axis": 0}:
        raise AssertionError(f"fftn, fftn and ifftn launched {fftn_launches}; K4 three times a complex transform")
    if kernels.LLOYD_LAUNCHES or kernels.GRAM_LAUNCHES:
        raise AssertionError("the FFT path launched the Lloyd or the Gram kernel")
    s_, s2, b_ = spec.larray, spec2.larray, back.larray
    if (s_.dtype, s2.dtype, b_.dtype) != (torch.complex64,) * 3 or s_.shape != x.shape or spec.split != 0:
        raise AssertionError(f"fftn gave {s_.dtype} {tuple(s_.shape)} split {spec.split}")
    if not all(bool(torch.isfinite(torch.view_as_real(t)).all()) for t in (s_, s2, b_)):
        raise AssertionError("an FFT result is not finite")
    oracle = torch.fft.fftn(x.double())
    spec_err = rel_err(s_, oracle)
    energy = float((s_.abs().double() ** 2).sum())
    parseval = abs(energy - x.numel() * float((x.double() ** 2).sum())) / energy
    oracle = torch.fft.fftn(oracle)
    spec2_err = rel_err(s2, oracle)
    del oracle
    back_err = rel_err(b_, x)
    if max(spec_err, spec2_err, back_err, parseval) > 1e-4:
        raise AssertionError(f"fftn {spec_err}, fftn of the spectrum {spec2_err}, round trip {back_err}, "
                             f"Parseval {parseval}: each must be at most 1e-4")
    emit({"phase": "fftn", "shape": list(x.shape), "split": 0, "launches": fftn_launches,
          "real_fftn_wall_ms": real_ms, "complex_fftn_wall_ms": complex_ms, "ifftn_wall_ms": inverse_ms,
          "rel_err_vs_torch_fft_complex128": spec_err, "complex_rel_err": spec2_err, "round_trip_rel_err": back_err,
          "parseval_rel_err": parseval})
    del spec2, back, s2, b_

    # 14. fft2 of a real image (one K4 launch), fft of complex signals along the last axis (one K6 launch)
    img = torch.randn(FFT2_N, FFT2_N, device=dev, generator=g)
    sig = torch.complex(torch.randn(FFT1_ROWS, FFT1_N, device=dev, generator=g),
                        torch.randn(FFT1_ROWS, FFT1_N, device=dev, generator=g))
    IMG, SIG = ht.array(img), ht.array(sig, split=0)
    zero_launches()
    f2, fft2_ms = wall_ms(lambda: ht.fft.fft2(IMG))
    f1, fft_ms = wall_ms(lambda: ht.fft.fft(SIG))
    more = fft_launches()
    if more != {"fft_stage": 0, "fft_pair": 1, "fft_ext": 0, "fft_axis": 1} or kernels.LLOYD_LAUNCHES or kernels.GRAM_LAUNCHES:
        raise AssertionError(f"fft2 and fft launched {more}; K4 once and K6 once")
    fft2_err = rel_err(f2.larray, torch.fft.fft2(img.double()))
    fft_err = rel_err(f1.larray, torch.fft.fft(sig.to(torch.complex128)))
    if f2.larray.shape != img.shape or f1.larray.shape != sig.shape or max(fft2_err, fft_err) > 1e-4:
        raise AssertionError(f"fft2 {tuple(f2.larray.shape)} rel {fft2_err}; fft {tuple(f1.larray.shape)} rel {fft_err}")
    emit({"phase": "fft2_fft", "fft2_shape": list(img.shape), "fft2_wall_ms": fft2_ms, "fft2_rel_err": fft2_err,
          "fft_shape": list(sig.shape), "fft_wall_ms": fft_ms, "fft_rel_err": fft_err, "launches": more})
    fft2_warm_ms = time_ms(lambda: ht.fft.fft2(IMG), reps=3, warmup=0)  # its matrices now built and cached
    fft_warm_ms = time_ms(lambda: ht.fft.fft(SIG), reps=3, warmup=0)
    emit({"phase": "fft2_fft", "fft2_warm_ms": fft2_warm_ms, "fft_warm_ms": fft_warm_ms,
          "torch_fft2_ms": time_ms(lambda: torch.fft.fft2(img), reps=3),
          "torch_fft_ms": time_ms(lambda: torch.fft.fft(sig), reps=3), "card": smi})
    del f2, f1, IMG, SIG, img, sig
    torch.cuda.empty_cache()

    # 15. where the fftn's time goes: the real and then the complex transform
    # in one profiled window (the launches here are not counted)
    emit({"phase": "fft_profile", "transforms": "fftn of the real 512^3 cube, then fftn of its spectrum",
          **profile_fit(lambda: (ht.fft.fftn(X).larray.shape, ht.fft.fftn(spec).larray.shape), top_n=10)})

    # 16. the whole path against torch.fft on the same inputs
    emit({"phase": "fft_times", "card": smi,
          "real_fftn_ms": time_ms(lambda: ht.fft.fftn(X), reps=5),
          "torch_fft_real_fftn_ms": time_ms(lambda: torch.fft.fftn(x), reps=5),
          "complex_fftn_ms": time_ms(lambda: ht.fft.fftn(spec), reps=5),
          "torch_fft_complex_fftn_ms": time_ms(lambda: torch.fft.fftn(s_), reps=5)})
    return {k: fftn_launches[k] + more[k] for k in more}


def compare_flash(q, k, v, scale: float, causal: bool, n_true: int) -> dict:
    """K7 against its plain version on the same card tensors: relative
    error (max abs over max abs) at most 1e-5, and a second launch bitwise
    equal to the first."""
    import torch
    from heat_tpu_torch.nn import _flash

    got = _flash.flash_attention(q, k, v, scale, causal, n_true)
    again = _flash.flash_attention(q, k, v, scale, causal, n_true)
    want = _flash._flash_plain(q, k, v, scale, causal, n_true)
    torch.cuda.synchronize()
    label = f"s={q.shape[0]} h={q.shape[1]} d={q.shape[2]} n_true={n_true}{' causal' if causal else ''}"
    rel = rel_err(got, want)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or rel > 1e-5:
        raise AssertionError(f"flash {label}: {tuple(got.shape)} against {tuple(want.shape)}, relative error {rel}")
    if not torch.equal(got, again):
        raise AssertionError(f"flash {label}: two launches on the same inputs differ")
    return {"case": label, "rel_err": rel, "max_abs_err": float((got.double() - want.double()).abs().max()),
            "bitwise_repeat": True}


def attention_kernel(dev, g, smi: str) -> dict:
    """Phase attn_check: K7 against its plain version at the main path's
    shape (timed there) and at ragged ones, and the inputs it refuses.
    Returns K7's entry of the summary line, launches still to fill in."""
    import torch
    import torch.nn.functional as F
    from heat_tpu_torch.nn import _flash

    t0 = time.perf_counter()
    s, h, d = ATTN_SEQ, ATTN_HEADS, ATTN_HEAD_DIM
    scale = 1.0 / d**0.5
    q, k, v = (torch.randn(s, h, d, device=dev, generator=g) for _ in range(3))
    checks = [compare_flash(q, k, v, scale, True, s), compare_flash(q, k, v, scale, False, s - 5)]
    for (rows, heads, dim, n_true) in ((1, 1, 16, 0), (127, 3, 64, 100), (1000, 1, 128, 999), (1000, 3, 256, 937),
                                       (127, 1, 16, 120)):
        qs, ks, vs = (torch.randn(rows, heads, dim, device=dev, generator=g) for _ in range(3))
        for causal in (False, True):
            checks.append(compare_flash(qs, ks, vs, 1.0 / dim**0.5, causal, n_true))
    # a peaked softmax (q scaled by 8), where long tensor-core chains would drift
    qs, ks, vs = (torch.randn(4096, 4, 64, device=dev, generator=g) for _ in range(3))
    for causal in (False, True):
        checks.append({**compare_flash(qs * 8, ks, vs, 0.125, causal, 4096 - 37), "q_scaled_by": 8})
    del qs, ks, vs
    for c in checks:
        emit({"phase": "attn_check", "kernel": "flash_attention", **c})
    refused = []
    x = torch.zeros(16, 2, 8, device=dev)
    for what, args, err in (("float64", (x.double(),) * 3, TypeError),
                            ("d = 257", (torch.zeros(4, 1, 257, device=dev),) * 3, ValueError),
                            ("s = 0", (torch.zeros(0, 2, 8, device=dev),) * 3, ValueError)):
        try:
            _flash.flash_attention(*args, 1.0, False, 4)
        except err:
            refused.append(what)
        else:
            raise AssertionError(f"the flash kernel took a {what} input")
    emit({"phase": "attn_check", "kernel": "flash_attention", "refused": refused})

    kernel_ms = time_ms(lambda: _flash.flash_attention(q, k, v, scale, True, s), reps=10)
    plain_ms = time_ms(lambda: _flash._flash_plain(q, k, v, scale, True, s), reps=3, warmup=1)
    # the library's fused attention on the same data in its (1, h, s, d) layout
    qt, kt, vt = (t.permute(1, 0, 2).contiguous()[None] for t in (q, k, v))
    backend = "efficient_attention"
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps=10)
    except RuntimeError as e:
        backend = f"default (efficient attention refused: {str(e)[:80]})"
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps=10)
    del qt, kt, vt
    flops = 2 * s * s * h * d  # two products over the causal half
    bound_ms, bound_by = bound(4 * 4 * s * h * d, flops)
    emit({"phase": "attn_check", "kernel": "flash_attention", "shape": [s, h, d], "causal": True, "ms": kernel_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms,
          "tf32x3_floor_ms": 3 * flops / TF32_FLOPS * 1e3, "cuda_core_floor_ms": flops / F32_FLOPS * 1e3,
          "library_ms": library_ms,
          "library_call": f"torch.nn.functional.scaled_dot_product_attention, is_causal, float32, {backend}",
          "card": smi, "phase_seconds": time.perf_counter() - t0})
    return {"name": "flash_attention", "route": "cuda", "source": "heat_tpu_torch/csrc/flash_attn.cu",
            "replaces": "heat_tpu/nn/attention.py:66", "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in checks), "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def attention_truth(q, k, v):
    """Causal attention of (s, h, d) tensors in float64, one head at a time."""
    import torch

    s, h, d = q.shape
    out = torch.empty((s, h, d), dtype=torch.float64, device=q.device)
    above = torch.ones(s, s, dtype=torch.bool, device=q.device).triu_(1)
    for j in range(h):
        scores = (q[:, j].double() @ k[:, j].double().T) / d**0.5
        scores.masked_fill_(above, float("-inf"))
        out[:, j] = torch.softmax(scores, dim=-1) @ v[:, j].double()
    return out


def attention_path(smi: str) -> int:
    """Phases attention and attn_profile; returns K7's launches on the main
    path (the two flash calls)."""
    import torch
    import heat_tpu_torch as ht
    from heat_tpu_torch.nn import _flash

    t0 = time.perf_counter()
    shape = (ATTN_SEQ, ATTN_HEADS, ATTN_HEAD_DIM)
    torch.cuda.reset_peak_memory_stats()
    ht.random.seed(ATTN_SEED)
    Q, K, V = (ht.random.randn(*shape, split=0) for _ in range(3))
    # element i of a draw hashes counter i alone, so a shorter draw under the
    # same key repeats the first values of the long one
    ht.random.seed(ATTN_SEED)
    worst = 0
    for X in (Q, K, V):
        host = ht.random.randn(ATTN_HOST_DRAWS, device="cpu").larray
        card = X.larray.reshape(-1)[:ATTN_HOST_DRAWS].cpu()
        worst = max(worst, int((card.view(torch.int32).long() - host.view(torch.int32).long()).abs().max()))
    if worst > 4 or X.larray.device.type != "cuda":
        raise AssertionError(f"randn on the card is {worst} ulp from the host's draws (or not on the card)")
    draws_s = time.perf_counter() - t0
    truth = attention_truth(Q.larray, K.larray, V.larray)
    unsplit = [ht.array(X.larray) for X in (Q, K, V)]
    calls = []
    for method, args in (("flash", (Q, K, V)), ("flash", unsplit), ("ring", (Q, K, V)), ("ulysses", (Q, K, V))):
        zero_launches()
        out, ms = wall_ms(lambda: ht.nn.scaled_dot_product_attention(*args, causal=True, method=method))
        launches = _flash.FLASH_LAUNCHES
        if launches != (1 if method == "flash" else 0) or other_launches() or any(_flash.FLASH_BWD_LAUNCHES.values()):
            raise AssertionError(f"{method} on split={args[0].split} launched K7 {launches} times and "
                                 f"{other_launches()} other kernels; K7 once per flash call, nothing else")
        o = out.larray
        err = float((o.double() - truth).abs().max())
        if o.shape != shape or out.split != args[0].split or not bool(torch.isfinite(o).all()) or err > 1e-4:
            raise AssertionError(f"{method} on split={args[0].split}: {tuple(o.shape)} split {out.split}, "
                                 f"max abs error {err} against float64")
        calls.append({"method": method, "split": args[0].split, "wall_ms": ms, "flash_launches": launches,
                      "max_abs_err_vs_float64": err})
        del out, o
        torch.cuda.empty_cache()
    emit({"phase": "attention", "shape": list(shape), "causal": True, "randn_card_vs_host_max_ulp": worst,
          "calls": calls, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi,
          "draws_seconds": draws_s, "phase_seconds": time.perf_counter() - t0})
    main_launches = sum(c["flash_launches"] for c in calls)
    del truth
    torch.cuda.empty_cache()

    # 19. where the split=0 flash call's time goes (the launches here are not counted)
    emit({"phase": "attn_profile", "call": "scaled_dot_product_attention, method flash, split=0, causal",
          **profile_fit(lambda: ht.nn.scaled_dot_product_attention(Q, K, V, causal=True, method="flash").shape)})
    return main_launches


def attended_pairs(s: int, n_true: int, causal: bool) -> int:
    """The (query, key) pairs flash attention computes: within the real
    rows and within the padded tail, under causal only keys not after the
    query."""
    pad = s - n_true
    if causal:
        return n_true * (n_true + 1) // 2 + pad * (pad + 1) // 2
    return n_true * n_true + pad * pad


def flash_bwd_kernels(q, k, v, do, scale: float, causal: bool, n_true: int, route: str):
    """The backward kernels by ``route`` on the forward kernel's output and
    log-sum-exp, and their plain versions on the same inputs: (kernel,
    plain), each (di, dq, dk, dv)."""
    from heat_tpu_torch.nn import _flash

    out, lse = _flash._flash_cuda(q, k, v, scale, causal, n_true, with_lse=True)
    di = _flash._bwd_di_cuda(out, do)
    dq, dk, dv = _flash._bwd_cuda(q, k, v, do, lse, di, scale, causal, n_true, route)
    pdi = _flash._bwd_di_plain(out, do)
    pdk, pdv = _flash._bwd_dkv_plain(q, k, v, do, lse, di, scale, causal, n_true)
    pdq = _flash._bwd_dq_plain(q, k, v, do, lse, di, scale, causal, n_true)
    return (di, dq, dk, dv), (pdi, pdq, pdk, pdv)


def grad_err(got, want) -> float:
    """max abs error over max abs, over a group of gradients together."""
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    return err / max(float(b.double().abs().max()) for b in want)


def compare_flash_bwd(q, k, v, do, scale: float, causal: bool, n_true: int, route: str) -> dict:
    """K7-bwd by ``route`` against its plain versions on the same inputs: di,
    and dQ, dK, dV together, within 5e-5 (max abs error over max abs),
    finite, and a second launch of each kernel bitwise equal to the first."""
    import torch

    got, want = flash_bwd_kernels(q, k, v, do, scale, causal, n_true, route)
    again, _ = flash_bwd_kernels(q, k, v, do, scale, causal, n_true, route)
    torch.cuda.synchronize()
    strided = "" if q.is_contiguous() else " strided"
    if 0 in do.stride():
        strided += f" do strides {tuple(do.stride())}"
    label = f"s={q.shape[0]} h={q.shape[1]} d={q.shape[2]} n_true={n_true}{' causal' if causal else ''}{strided}"
    di_rel, grads_rel = grad_err(got[:1], want[:1]), grad_err(got[1:], want[1:])
    finite = all(bool(torch.isfinite(t).all()) for t in got + want)
    if not finite or any(a.shape != b.shape for a, b in zip(got, want)) or max(di_rel, grads_rel) > 5e-5:
        raise AssertionError(f"flash backward {label}, {route} route: finite {finite}, di relative error {di_rel}, "
                             f"dQ/dK/dV {grads_rel}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash backward {label}, {route} route: two launches on the same inputs differ")
    return {"case": label, "route": route, "di_rel_err": di_rel, "grads_rel_err": grads_rel,
            "max_abs_err": {name: float((a.double() - b.double()).abs().max())
                            for name, a, b in zip(("di", "dq", "dk", "dv"), got, want)},
            "bitwise_repeat": True}


def compare_bwd_prep(q, k, v, do) -> dict:
    """The tc route's pre-pass against its plain version, on an lse and di
    drawn for the purpose: bitwise equal (the TF32 split is exact integer
    work on the bits, the rest copies), and a repeat too."""
    import torch
    from heat_tpu_torch.nn import _flash

    lse, di = torch.randn(2, q.shape[1], q.shape[0], device=q.device)
    got = _flash._bwd_prep_cuda(q, k, v, do, lse, di)
    again = _flash._bwd_prep_cuda(q, k, v, do, lse, di)
    want = _flash._bwd_prep_plain(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    label = f"s={q.shape[0]} h={q.shape[1]} d={q.shape[2]}{'' if q.is_contiguous() else ' strided'}"
    if 0 in do.stride():
        label += f" do strides {tuple(do.stride())}"
    if not (torch.equal(got.view(torch.int32), want.view(torch.int32)) and torch.equal(got, again)):
        raise AssertionError(f"flash backward pre-pass {label}: {float((got - want).abs().max())} from its plain "
                             f"version, or a repeat differs")
    return {"case": label, "bitwise_equal_plain": True, "bitwise_repeat": True}


def flash_bwd_check(dev, g, smi: str) -> list:
    """Phase flash_bwd_check: K7-bwd against its plain versions at the main
    path's shape (timed there) and at ragged ones, end to end against
    float64, and the inputs it refuses.  Returns the kernels' entries of the
    summary line, launches still to fill in."""
    import torch
    import torch.nn.functional as F
    from heat_tpu_torch.nn import _flash

    t0 = time.perf_counter()
    s, h, d = ATTN_SEQ, ATTN_HEADS, ATTN_HEAD_DIM
    scale = 1.0 / d**0.5
    q, k, v, do = (torch.randn(s, h, d, device=dev, generator=g) for _ in range(4))
    if _flash.bwd_route(s, h, d) != "tc":
        raise AssertionError(f"the backward's gate picks the {_flash.bwd_route(s, h, d)} route at the main shape")
    # every route at every shape it takes: tc at d <= 64, cuda_core at any d
    checks = [compare_flash_bwd(q, k, v, do, scale, True, s, route) for route in ("tc", "cuda_core")]
    prep = [compare_bwd_prep(q, k, v, do)]
    for rows, heads, dim, n_true in ((1, 1, 16, 1), (63, 2, 16, 60), (65, 3, 100, 65), (65, 3, 100, 30),
                                     (1000, 2, 128, 937), (1000, 2, 256, 999), (1000, 1, 256, 500),
                                     (1000, 2, 64, 937), (129, 3, 33, 100)):
        ts = [torch.randn(rows, heads, dim, device=dev, generator=g) for _ in range(4)]
        routes = ("tc", "cuda_core") if _flash.bwd_route(rows, heads, dim) == "tc" else ("cuda_core",)
        for causal in (False, True):
            for route in routes:
                checks.append(compare_flash_bwd(*ts, 1.0 / dim**0.5, causal, n_true, route))
    base = torch.randn(4, 2, 300, 64, device=dev, generator=g)  # (q, k, v, do) x (h, s, d): strided (s, h, d)
    strided = [base[i].transpose(0, 1) for i in range(4)]
    flat = torch.randn((), device=dev, generator=g).expand(300, 2, 64)  # autograd's gradient of a sum: stride 0
    prep += [compare_bwd_prep(*strided), compare_bwd_prep(*strided[:3], flat)]
    for causal in (False, True):
        for route in ("tc", "cuda_core"):
            checks.append(compare_flash_bwd(*strided, 0.125, causal, 290, route))
            checks.append(compare_flash_bwd(*strided[:3], flat, 0.125, causal, 290, route))
    # end to end against float64, q as drawn and scaled by 8 (a peaked
    # softmax): through the autograd Function (the route its gate picks,
    # tc) and through each route's kernels
    qs, ks, vs, dos = (torch.randn(4096, 4, 64, device=dev, generator=g) for _ in range(4))
    for qm in (1.0, 8.0):
        w64 = [t.double() for t in (qs * qm, ks, vs, dos)]
        out64, lse64 = _flash._flash_plain(*w64[:3], 0.125, True, 4096 - 37, with_lse=True)
        di64 = _flash._bwd_di_plain(out64, w64[3])
        dk64, dv64 = _flash._bwd_dkv_plain(*w64, lse64, di64, 0.125, True, 4096 - 37)
        dq64 = _flash._bwd_dq_plain(*w64, lse64, di64, 0.125, True, 4096 - 37)
        leaves = [t.clone().requires_grad_() for t in (qs * qm, ks, vs)]
        _flash.flash_attention(*leaves, 0.125, True, 4096 - 37).backward(dos)
        ways = {"autograd Function": [t.grad for t in leaves]}
        for route in ("tc", "cuda_core"):
            (_, *grads), _ = flash_bwd_kernels(qs * qm, ks, vs, dos, 0.125, True, 4096 - 37, route)
            ways[f"{route} route"] = grads
        for way, grads in ways.items():
            rel = grad_err(grads, (dq64, dk64, dv64))
            if rel > 1e-4:
                raise AssertionError(f"flash gradient at (4096, 4, 64), q x {qm}, {way}: {rel} from float64")
            checks.append({"case": f"s=4096 h=4 d=64 n_true=4059 causal, {way}", "q_scaled_by": qm,
                           "grads_rel_err_vs_float64": rel})
    del qs, ks, vs, dos, leaves, w64, out64, lse64, di64, dk64, dv64, dq64, ways, base, strided, flat
    if {c.get("route") for c in checks if "route" in c} != {"tc", "cuda_core"}:
        raise AssertionError("the K7-bwd checks did not cover both routes")
    for c in checks:
        emit({"phase": "flash_bwd_check", "kernel": "flash_attn_bwd", **c})
    for c in prep:
        emit({"phase": "flash_bwd_check", "kernel": "flash_attn_bwd_prep", **c})
    refused = []
    x = torch.zeros(16, 2, 8, device=dev)
    for what, call, err in (
            ("float64", lambda: _flash.flash_attention(*(x.double().requires_grad_() for _ in range(3)), 1.0, False,
                                                       4).sum().backward(), TypeError),
            ("d = 257", lambda: _flash.flash_attention(*(torch.zeros(4, 1, 257, device=dev).requires_grad_()
                                                         for _ in range(3)), 1.0, False, 4).sum().backward(),
             ValueError),
            ("tc route, d = 65", lambda: _flash._bwd_prep_cuda(*[torch.zeros(4, 1, 65, device=dev)] * 4,
                                                               *torch.zeros(2, 1, 4, device=dev)), ValueError)):
        try:
            call()
        except err:
            refused.append(what)
        else:
            raise AssertionError(f"the flash kernels took {what} for a gradient")
    emit({"phase": "flash_bwd_check", "kernel": "flash_attn_bwd", "refused": refused})

    # times at the main path's shape, beside the bounds and the library's backward
    out, lse = _flash._flash_cuda(q, k, v, scale, True, s, with_lse=True)
    di = _flash._bwd_di_cuda(out, do)
    planes = _flash._bwd_prep_cuda(q, k, v, do, lse, di)
    pairs = attended_pairs(s, s, True)
    product = 2 * pairs * d * h
    io = 4 * s * h * d  # bytes of one (s, h, d) float32 tensor
    jax_op = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    runs = {  # name: kernel, plain, library, bytes, flops, library call, replaces
        "di": (lambda: _flash._bwd_di_cuda(out, do), lambda: _flash._bwd_di_plain(out, do),
               lambda: torch.einsum("qhd,qhd->hq", out, do), 2 * io + 4 * h * s, 2 * s * h * d,
               "torch.einsum('qhd,qhd->hq', o, do)", f"{jax_op}:271 (di in _flash_attention_bwd, outside the kernels)"),
        "prep": (lambda: _flash._bwd_prep_cuda(q, k, v, do, lse, di),
                 lambda: _flash._bwd_prep_plain(q, k, v, do, lse, di), None, 4 * io + 8 * h * s + 4 * planes.numel(), 0,
                 None,
                 f"{jax_op}:941 and :1287 (the tc route's operand planes of _flash_attention_bwd_dkv and _dq)"),
        "dkv": (lambda: _flash._bwd_dkv_cuda(q, k, v, do, lse, di, scale, True, s, "tc", planes),
                lambda: _flash._bwd_dkv_plain(q, k, v, do, lse, di, scale, True, s), None,
                6 * io + 8 * h * s, 4 * product, None, f"{jax_op}:941 (_flash_attention_bwd_dkv)"),
        "dq": (lambda: _flash._bwd_dq_cuda(q, k, v, do, lse, di, scale, True, s, "tc", planes),
               lambda: _flash._bwd_dq_plain(q, k, v, do, lse, di, scale, True, s), None,
               5 * io + 8 * h * s, 3 * product, None, f"{jax_op}:1287 (_flash_attention_bwd_dq)"),
    }
    cuda_core = {"dkv": lambda: _flash._bwd_dkv_cuda(q, k, v, do, lse, di, scale, True, s, "cuda_core"),
                 "dq": lambda: _flash._bwd_dq_cuda(q, k, v, do, lse, di, scale, True, s, "cuda_core")}
    qt, kt, vt = (t.permute(1, 0, 2).contiguous()[None].requires_grad_() for t in (q, k, v))
    dot = do.permute(1, 0, 2).contiguous()[None]
    backend = "efficient_attention"
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), dot, retain_graph=True), reps=10)
    except RuntimeError as e:
        backend = f"default (efficient attention refused: {str(e)[:80]})"
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), dot, retain_graph=True), reps=10)
    del qt, kt, vt, dot, o_sdpa
    routed = [c for c in checks if "max_abs_err" in c]
    max_abs = {"di": max(c["max_abs_err"]["di"] for c in routed), "prep": 0.0}
    for route in ("tc", "cuda_core"):
        cs = [c for c in routed if c["route"] == route]
        max_abs[f"dkv_{route}"] = max(max(c["max_abs_err"]["dk"], c["max_abs_err"]["dv"]) for c in cs)
        max_abs[f"dq_{route}"] = max(c["max_abs_err"]["dq"] for c in cs)
    entries = []
    for name, (kernel, plain, library, nbytes, flops, library_call, replaces) in runs.items():
        key = f"{name}_tc" if name in cuda_core else name
        # the tc route and the cuda_core route in turns (tc, cuda_core, cuda_core, tc)
        kernel_ms = time_ms(kernel, reps=10 if name in ("di", "prep") else 5)
        other = None
        if name in cuda_core:
            other_ms = time_ms(cuda_core[name], reps=5)
            other_ms = (other_ms + time_ms(cuda_core[name], reps=5)) / 2
            kernel_ms = (kernel_ms + time_ms(kernel, reps=5)) / 2
            other = {"route": "cuda_core", "ms": other_ms, "max_abs_err": max_abs[f"{name}_cuda_core"],
                     "launches": None}
        plain_ms = time_ms(plain, reps=3, warmup=1)
        library_ms = time_ms(library, reps=10) if library is not None else None
        bound_ms, bound_by = bound(nbytes, flops)
        line = {"phase": "flash_bwd_check", "kernel": f"flash_attn_bwd_{name}", "shape": [s, h, d], "causal": True,
                "route": "tc" if name in cuda_core else None, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms,
                "tf32x3_floor_ms": 3 * flops / TF32_FLOPS * 1e3, "cuda_core_floor_ms": flops / F32_FLOPS * 1e3,
                "library_ms": library_ms,
                "library_call": library_call or "none: no single PyTorch call computes this part of the backward",
                "sdpa_backward_ms": sdpa_bwd_ms,
                "sdpa_backward_call": f"torch.autograd.grad of scaled_dot_product_attention, is_causal, float32, "
                                      f"{backend}: the whole backward", "card": smi}
        if other is not None:
            line["cuda_core_route_ms"] = other["ms"]
        emit(line)
        entry = {"name": f"flash_attn_bwd_{name}", "route": "cuda", "source": "heat_tpu_torch/csrc/flash_attn_bwd.cu",
                 "replaces": replaces, "launches": None, "launch_key": key, "max_abs_err": max_abs[key],
                 "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms}
        if other is not None:
            entry["kernel_route"] = "tc"
            entry["cuda_core_route"] = other
        entries.append(entry)
    del planes
    tc_ms = sum(e["ms"] for e in entries if e["name"] != "flash_attn_bwd_di")
    cc_ms = sum(e["cuda_core_route"]["ms"] for e in entries if "cuda_core_route" in e)
    if not tc_ms < cc_ms:
        raise AssertionError(f"the tc route's pre-pass, dkv and dq take {tc_ms} ms, the cuda_core route's {cc_ms}")
    emit({"phase": "flash_bwd_check", "kernel": "flash_attn_bwd", "shape": [s, h, d], "causal": True,
          "tc_route_ms": tc_ms, "cuda_core_route_ms": cc_ms, "di_ms": entries[0]["ms"],
          "sdpa_backward_ms": sdpa_bwd_ms, "card": smi, "phase_seconds": time.perf_counter() - t0})
    return entries


def _bwd_plain(q, k, v, do, lse, di, scale, causal, n_true, route=None):
    from heat_tpu_torch.nn import _flash

    dk, dv = _flash._bwd_dkv_plain(q, k, v, do, lse, di, scale, causal, n_true)
    return _flash._bwd_dq_plain(q, k, v, do, lse, di, scale, causal, n_true), dk, dv


class _PlainFlash:
    """Inside the block, the flash-attention Function runs its plain forward
    and backward on the card (the reference for the training step's
    gradients); the kernels' wrappers are put back on the way out."""

    names = ("_flash_cuda", "_bwd_di_cuda", "_bwd_cuda")

    def __enter__(self):
        from heat_tpu_torch.nn import _flash

        self.saved = {n: getattr(_flash, n) for n in self.names}
        for n, plain in zip(self.names, (_flash._flash_plain, _flash._bwd_di_plain, _bwd_plain)):
            setattr(_flash, n, plain)

    def __exit__(self, *exc):
        from heat_tpu_torch.nn import _flash

        for n, fn in self.saved.items():
            setattr(_flash, n, fn)


def train_attention(dev, smi: str) -> dict:
    """Phase train_attention: a user's attention module in DataParallel with
    Adam, three steps on the card.  Returns the steps' launches of each
    backward kernel by route (one a step of di, the pre-pass and the tc
    route's dkv and dq: the gate's route at this shape)."""
    import torch
    import torch.nn.functional as F
    import heat_tpu_torch as ht
    from heat_tpu_torch.nn import _flash

    width, heads = ATTN_HEADS * ATTN_HEAD_DIM, ATTN_HEADS
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(ATTN_SEED + 1)
    x = torch.randn(ATTN_SEQ, width, device=dev, generator=g)
    target = torch.randn(ATTN_SEQ, width, device=dev, generator=g)
    model = attention_module(width, heads).to(dev)
    dp = ht.nn.DataParallel(model, optimizer=ht.optim.Adam(model.parameters(), lr=1e-3))
    dp.init(g, x[:64])
    grad_rel, grad_abs, loss_k = first_step_check(dp, x, target, "train_attention")

    zero_launches()
    torch.cuda.synchronize()
    losses, step_ms = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        losses.append(dp.step(F.mse_loss, x, target))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    fwd, bwd = _flash.FLASH_LAUNCHES, dict(_flash.FLASH_BWD_LAUNCHES)
    want = {"di": 3, "prep": 3, "dkv_tc": 3, "dq_tc": 3, "dkv_cuda_core": 0, "dq_cuda_core": 0}
    if fwd != 3 or bwd != want or other_launches():
        raise AssertionError(f"train_attention: 3 steps launched K7 {fwd} times, the backward kernels {bwd} and "
                             f"{other_launches()} others; K7 and each backward kernel of the tc route once a step")
    if not all(l == l and l < float("inf") for l in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_attention: the loss did not fall: {losses}")
    emit({"phase": "train_attention", "x": [ATTN_SEQ, width], "heads": heads, "causal": True,
          "optimizer": "Adam(1e-3)", "loss": "MSE", "losses": losses, "step_wall_ms": step_ms,
          "first_step_grads_rel_err_vs_plain": grad_rel, "first_step_grads_max_abs_err_vs_plain": grad_abs,
          "first_step_loss": float(loss_k),
          "flash_launches": fwd, "flash_bwd_launches": bwd, "card": smi, "phase_seconds": time.perf_counter() - t0})
    del dp, model, x, target
    torch.cuda.empty_cache()
    return bwd, step_ms


def attention_module(width: int, heads: int):
    """A user's attention module: projections around
    ``ht.nn.ulysses_attention`` with flash, causal."""
    import torch
    import heat_tpu_torch as ht

    class Attention(torch.nn.Module):  # user code
        def __init__(self):
            super().__init__()
            self.wq, self.wk, self.wv, self.wo = (torch.nn.Linear(width, width) for _ in range(4))

        def forward(self, x):
            q, k, v = (f(x).view(x.shape[0], heads, width // heads) for f in (self.wq, self.wk, self.wv))
            return self.wo(ht.nn.ulysses_attention(q, k, v, causal=True, use_flash=True).reshape(x.shape[0], width))

    return Attention()


def first_step_check(dp, x, target, phase: str):
    """The first step's loss and gradients by the kernels against the plain
    flash path's on the card: ``(gradient error, per-parameter max abs
    error, loss)``; fails beyond 1e-4 (max abs error over max abs, over all
    parameters together: the key bias's gradient is zero in exact
    arithmetic -- a softmax does not see a constant added to a query's
    scores -- so on its own it compares rounding with rounding)."""
    import torch.nn.functional as F

    loss_k, grads_k = dp.value_and_grad(F.mse_loss, x, target)
    with _PlainFlash():
        loss_p, grads_p = dp.value_and_grad(F.mse_loss, x, target)
    names = list(grads_k)
    grad_rel = grad_err([grads_k[n] for n in names], [grads_p[n] for n in names])
    grad_abs = {n: float((grads_k[n].double() - grads_p[n].double()).abs().max()) for n in names}
    if not grad_rel <= 1e-4 or abs(float(loss_k) - float(loss_p)) > 1e-5 * abs(float(loss_p)):
        raise AssertionError(f"{phase}: the kernels' first step against the plain one: loss {float(loss_k)} "
                             f"and {float(loss_p)}, gradients {grad_rel} (max abs error over max abs), {grad_abs}")
    return grad_rel, grad_abs, float(loss_k)


DASO_STEPS = 7  # global_skip 2, batches_to_wait 1: averages at steps 0, 2, 4, 6, landing at 1, 3, 5; the last one
# waits for last_batch


def train_daso(dev, smi: str, attn_step_ms) -> dict:
    """Phase train_daso: train_attention's user module at x of (16384, 512)
    in ``DataParallelMultiGPU`` with ``DASO(Adam)`` on a
    ``HierarchicalCommunication`` of one node of one card.  The first
    step's gradients against the plain flash path; then DASO_STEPS steps
    with global_skip 2 and batches_to_wait 1, where every average that
    lands is bitwise the bfloat16 round trip of the parameters of the step
    that scheduled it, and last_batch applies the last.  Returns the steps'
    launches of K7 and of each backward kernel (one a step each, the tc
    route)."""
    import torch
    import torch.nn.functional as F
    import heat_tpu_torch as ht
    from heat_tpu_torch.nn import _flash

    width, heads = ATTN_HEADS * ATTN_HEAD_DIM, ATTN_HEADS
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(ATTN_SEED + 1)
    x = torch.randn(ATTN_SEQ, width, device=dev, generator=g)
    target = torch.randn(ATTN_SEQ, width, device=dev, generator=g)
    model = attention_module(width, heads).to(dev)
    hc = ht.parallel.HierarchicalCommunication()
    daso = ht.optim.DASO(ht.optim.Adam(model.parameters(), lr=1e-3), total_epochs=1, comm=hc, warmup_epochs=0,
                         cooldown_epochs=0)
    dp = ht.nn.DataParallelMultiGPU(model, daso=daso)
    dp.init(g, x[:64])
    grad_rel, grad_abs, first_loss = first_step_check(dp, x, target, "train_daso")

    daso.global_skip, daso.batches_to_wait = 2, 1
    params = [p for p in model.parameters()]
    zero_launches()
    torch.cuda.synchronize()
    losses, step_ms, landed, scheduled = [], [], [], {}
    for t in range(DASO_STEPS):
        t1 = time.perf_counter()
        losses.append(dp.step(F.mse_loss, x, target))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if t in scheduled:  # the average of step t - 1 landed
            if not all(torch.equal(p.detach().view(torch.int32), w.view(torch.int32)) for p, w in zip(params, scheduled.pop(t))):
                raise AssertionError(f"train_daso: the average landed at step {t} is not the bf16 round trip of step "
                                     f"{t - 1}'s parameters")
            landed.append(t)
        if daso._pending is not None and daso._pending[0] == daso.batch:  # scheduled at this step
            want = [p.detach().to(torch.bfloat16).to(p.dtype) for p in params]
            if not all(torch.equal(a.view(torch.int32), w.view(torch.int32)) for a, w in zip(daso._pending[1], want)):
                raise AssertionError(f"train_daso: the average scheduled at step {t} is not the bf16 round trip")
            scheduled[t + 1] = want
    fwd, bwd = _flash.FLASH_LAUNCHES, dict(_flash.FLASH_BWD_LAUNCHES)
    last = scheduled.pop(DASO_STEPS, None)
    daso.last_batch()
    if last is None or not all(torch.equal(p.detach().view(torch.int32), w.view(torch.int32)) for p, w in zip(params, last)):
        raise AssertionError("train_daso: last_batch did not apply the last pending average")
    n = DASO_STEPS
    want = {"di": n, "prep": n, "dkv_tc": n, "dq_tc": n, "dkv_cuda_core": 0, "dq_cuda_core": 0}
    if fwd != n or bwd != want or other_launches():
        raise AssertionError(f"train_daso: {n} steps launched K7 {fwd} times, the backward kernels {bwd} and "
                             f"{other_launches()} others; K7 and each backward kernel of the tc route once a step")
    if landed != [1, 3, 5] or not all(l == l and l < float("inf") for l in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_daso: averages landed at {landed}, losses {losses}")
    emit({"phase": "train_daso", "x": [ATTN_SEQ, width], "heads": heads, "causal": True, "grid": [1, 1],
          "optimizer": "DASO(Adam(1e-3)), global_skip 2, batches_to_wait 1", "loss": "MSE", "losses": losses,
          "step_wall_ms": step_ms, "train_attention_step_wall_ms": attn_step_ms, "averages_landed_at": landed,
          "landed_bitwise_bf16_round_trip": True, "last_batch_applied": True,
          "first_step_grads_rel_err_vs_plain": grad_rel, "first_step_grads_max_abs_err_vs_plain": grad_abs,
          "first_step_loss": first_loss, "flash_launches": fwd, "flash_bwd_launches": bwd, "card": smi,
          "phase_seconds": time.perf_counter() - t0})
    del dp, model, x, target, daso
    torch.cuda.empty_cache()
    return {"flash": fwd, **bwd}


LOADER_IMAGES = 2048
LOADER_BATCH = 128
SHUFFLE_ROWS = 1 << 27  # the KMeans cell's points, 2^27 x 16 float32
PARTIAL_ROWS = 1 << 24
PARTIAL_WINDOW = 1 << 20


def data_loader(dev, smi: str) -> None:
    """Phase data_loader: config 4's CNN trained for one epoch on
    synthetic_mnist(2048) held on the host, through ``Dataset`` with
    ``vision_transforms.Normalize`` and ``DataLoader(batch_size=128,
    shuffle=True, prefetch=2)`` (pinned copies on a side stream), in
    ``DataParallelMultiGPU`` with DASO: every batch on the card bitwise the
    host's rows of the same permutation, normalized alike.  Then
    ``dataset_ishuffle``/``dataset_irecv`` of 2^27 x 16 points on the card
    (a bitwise permutation of the rows, the times to start and to complete)
    and a ``PartialH5Dataset`` reading 2^24 rows from memory in windows."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import heat_tpu_torch as ht
    from heat_tpu_torch.utils.data import prefetch

    t0 = time.perf_counter()
    x, y = ht.utils.data.synthetic_mnist(LOADER_IMAGES)
    xh, yh = x.larray.cpu(), y.larray.cpu()
    hx, hy = ht.array(xh, split=0, device="cpu"), ht.array(yh, split=0, device="cpu")
    mean, std = float(xh.mean()), float(xh.std())
    norm = ht.utils.vision_transforms.Normalize((mean,), (std,))
    ds = ht.utils.data.Dataset([hx, hy], transforms=[norm, None])
    loader = ht.utils.data.DataLoader(ds, batch_size=LOADER_BATCH, shuffle=True, prefetch=2)

    model = cnn_module().to(dev)
    daso = ht.optim.DASO(ht.optim.Adam(model.parameters(), lr=1e-3), total_epochs=1,
                         comm=ht.parallel.HierarchicalCommunication(), warmup_epochs=0, cooldown_epochs=0)
    dp = ht.nn.DataParallelMultiGPU(model, daso=daso)
    dp.init(torch.Generator(device=dev).manual_seed(0), x.larray[:LOADER_BATCH])
    ht.random.seed(SEED + 5)
    perm = ht.random.randperm(LOADER_IMAGES, device="cpu").larray
    ht.random.seed(SEED + 5)
    prefetch.prefetch_stats(reset=True)
    torch.cuda.synchronize()
    losses, t1 = [], time.perf_counter()
    for i, (xb, yb) in enumerate(loader):
        idx = perm[i * LOADER_BATCH:(i + 1) * LOADER_BATCH]
        if xb.larray.device.type != "cuda" or yb.larray.device.type != "cuda":
            raise AssertionError("data_loader: a batch was not staged on the card")
        losses.append(dp.step(lambda p, t: F.cross_entropy(p, t.long()), xb, yb))
        want_x = norm._apply(xh[idx])
        if not (torch.equal(xb.larray.cpu().view(torch.int32), want_x.view(torch.int32))
                and torch.equal(yb.larray.cpu(), yh[idx])):
            raise AssertionError(f"data_loader: batch {i} is not the host's rows of the permutation")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t1
    stats = prefetch.prefetch_stats()
    if len(losses) != LOADER_IMAGES // LOADER_BATCH or not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"data_loader: {len(losses)} steps, losses {losses}")
    loader.close()
    del dp, model, daso, x, y
    torch.cuda.empty_cache()

    # the asynchronous shuffle of the KMeans cell's points on the card
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    pts = torch.randn(SHUFFLE_ROWS, FEATURES, device=dev, generator=g)
    big = ht.utils.data.Dataset(ht.array(pts, split=0))
    ht.random.seed(SEED + 7)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ht.utils.data.dataset_ishuffle(big)
    start_ms = (time.perf_counter() - t2) * 1e3
    ht.utils.data.dataset_irecv(big)
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t2) * 1e3
    ht.random.seed(SEED + 7)
    order = ht.random.randperm(SHUFFLE_ROWS, device="gpu").larray
    if not torch.equal(big.arrays[0].larray.view(torch.int32), pts[order].view(torch.int32)):
        raise AssertionError("data_loader: the shuffled rows are not the permutation's")
    del big, pts, order
    torch.cuda.empty_cache()

    # PartialH5Dataset streaming from memory (no h5py needed)
    src = np.random.default_rng(SEED + 8).standard_normal((PARTIAL_ROWS, FEATURES)).astype(np.float32)

    class InMemory(ht.utils.data.PartialH5Dataset):  # user code: a window reader of its own
        def __init__(self):
            self.length, self.load_length = PARTIAL_ROWS, PARTIAL_WINDOW
            self.transforms, self.dataset_names, self.comm = None, ["data"], None

        def read_window(self, start, stop):
            return [src[start:stop]]

    prefetch.prefetch_stats(reset=True)
    t3, pos = time.perf_counter(), 0
    for w in InMemory():
        if w.larray.device.type != "cuda" or w.shape[0] != PARTIAL_WINDOW:
            raise AssertionError("data_loader: a window was not staged on the card whole")
        if w.larray.cpu().numpy().tobytes() != src[pos:pos + PARTIAL_WINDOW].tobytes():
            raise AssertionError(f"data_loader: the window at row {pos} differs from its source")
        pos += PARTIAL_WINDOW
    stream_s = time.perf_counter() - t3
    if pos != PARTIAL_ROWS:
        raise AssertionError(f"data_loader: streamed {pos} rows of {PARTIAL_ROWS}")
    emit({"phase": "data_loader", "images": LOADER_IMAGES, "batch": LOADER_BATCH, "prefetch": 2,
          "steps": len(losses), "losses": losses, "epoch_wall_s": epoch_s, "steps_per_s": len(losses) / epoch_s,
          "prefetch_hits": stats["prefetch_hits"], "prefetch_misses": stats["prefetch_misses"],
          "batches_bitwise_host_permutation": True, "shuffle_rows": SHUFFLE_ROWS, "shuffle_features": FEATURES,
          "ishuffle_start_ms": start_ms, "ishuffle_complete_ms": done_ms, "shuffle_bitwise_permutation": True,
          "partial_rows": PARTIAL_ROWS, "partial_window": PARTIAL_WINDOW, "partial_stream_s": stream_s,
          "partial_hits": prefetch.prefetch_stats()["prefetch_hits"],
          "partial_misses": prefetch.prefetch_stats()["prefetch_misses"], "partial_rows_bitwise_in_order": True,
          "card": smi, "phase_seconds": time.perf_counter() - t0})


def cnn_module():
    """benchmarks/cb/nn.py's CNN (BASELINE config 4) as a user writes it:
    NHWC in, flattened as flax does."""
    import torch
    import torch.nn.functional as F

    class CNN(torch.nn.Module):  # user code
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(1, 16, 3, padding=1)
            self.dense0 = torch.nn.Linear(14 * 14 * 16, 64)
            self.dense1 = torch.nn.Linear(64, 10)

        def forward(self, x):
            t = F.avg_pool2d(F.relu(self.conv(x.permute(0, 3, 1, 2))), 2)
            return self.dense1(F.relu(self.dense0(t.permute(0, 2, 3, 1).reshape(t.shape[0], -1))))

    return CNN()


def train_cnn(dev, smi: str) -> None:
    """Phase train_cnn: BASELINE config 4, the data-parallel MNIST CNN of
    benchmarks/cb/nn.py at its published size."""
    import copy

    import torch
    import torch.nn.functional as F
    import heat_tpu_torch as ht
    from heat_tpu_torch.nn import _flash

    def loss_fn(pred, target):
        return F.cross_entropy(pred, target.long())

    t0 = time.perf_counter()
    n, batch = 2048, 128
    x, y = ht.utils.data.synthetic_mnist(n)
    xd, yd = x.larray, y.larray
    if xd.device.type != "cuda":
        raise AssertionError(f"synthetic_mnist made its images on {xd.device}, not the card")
    model = cnn_module().to(dev)
    dp = ht.nn.DataParallel(model, optimizer=ht.optim.Adam(model.parameters(), lr=1e-3))
    dp.init(torch.Generator(device=dev).manual_seed(0), xd[:batch])
    host = copy.deepcopy(model).cpu()
    host_dp = ht.nn.DataParallel(host, optimizer=ht.optim.Adam(host.parameters(), lr=1e-3))
    zero_launches()
    first = dp.step(loss_fn, xd[:batch], yd[:batch])  # the warm-up step, as benchmarks/cb/nn.py takes one
    host_first = host_dp.step(loss_fn, xd[:batch].cpu(), yd[:batch].cpu())
    if abs(first - host_first) > 1e-5 * abs(host_first):
        raise AssertionError(f"train_cnn: the first step's loss {first} on the card, {host_first} on the CPU")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [dp.step(loss_fn, xd[i:i + batch], yd[i:i + batch]) for i in range(0, n - batch + 1, batch)]
    epoch_s = time.perf_counter() - t1
    if other_launches() or _flash.FLASH_LAUNCHES or any(_flash.FLASH_BWD_LAUNCHES.values()):
        raise AssertionError("train_cnn launched a kernel of the port; the CNN runs on cuDNN and cuBLAS")
    if not losses[-1] < first:
        raise AssertionError(f"train_cnn: the loss did not fall: {first} then {losses}")
    emit({"phase": "train_cnn", "config": "BASELINE config 4, benchmarks/cb/nn.py", "images": n, "batch": batch,
          "steps": len(losses), "optimizer": "Adam(1e-3)", "first_step_loss": first,
          "first_step_loss_cpu": host_first, "losses": losses, "epoch_wall_s": epoch_s,
          "steps_per_s": len(losses) / epoch_s, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32, "card": smi,
          "phase_seconds": time.perf_counter() - t0})


# the distances path (phase distances): the spatial module's calls at the
# cells' sizes, then the estimators on them
DIST_ROWS = 1 << 16  # X: 2^16 x 16 against Y: 2^14 x 16, each result 4.3 GB
DIST_COLS = 1 << 14
DIST_FEATURES = 16
DIST_SELF_ROWS = 1 << 15  # cdist(X') of 2^15 rows: 4.3 GB
KNN_TRAIN = 1 << 20
KNN_QUERIES = 1 << 15
KNN_K = 5
KNN_CLUSTERS = 8
# benchmarks/cb/cluster.py:15-40: 4 spherical clusters of 5000 points in 3-D,
# their rows scaled to the KMeans cell's 2^27 to fill the card
SPHERE_PER_CLUSTER = 1 << 25
LAPLACIAN_ROWS = 1 << 15
DIST_PEAK_BYTES = 60e9


def distance_bound(n: int, m: int, f: int, ops_per_feature: int, ops_per_pair: int, out_bytes: int = 4) -> dict:
    """The least time of a call on n x m pairs of f features: its result
    written once and its inputs read once at the HBM rate, or its float32
    operations on the CUDA cores, whichever is larger."""
    b = {"bytes": (out_bytes * n * m + 4 * (n + m) * f) / HBM_BYTES_PER_S * 1e3,
         "operations": n * m * (f * ops_per_feature + ops_per_pair) / F32_FLOPS * 1e3}
    by = max(b, key=b.get)
    return {"bound_ms": b[by], "bound_by": by}


def restart_peak(peaks: list) -> None:
    """Keep the peak memory since the last restart in ``peaks``, then
    restart the count."""
    import torch

    peaks.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def timed_call(fn, name: str, bound: dict, smi: str, peaks: list):
    """``fn``'s result and a record of its first and warm wall time, the
    memory it took beyond what was allocated before it, and its bound."""
    import torch

    first, first_ms = wall_ms(fn)
    del first
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    restart_peak(peaks)
    out, warm_ms = wall_ms(fn)
    extra = torch.cuda.max_memory_allocated() - before
    return out, {"call": name, "first_ms": first_ms, "warm_ms": warm_ms, "extra_peak_gb": extra / 1e9, **bound,
                 "share_of_bound": bound["bound_ms"] / warm_ms, "card": smi}


def count_syncs(fn):
    """``(fn's result, the host synchronisations it made)``, counted by
    torch's sync debug mode."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def nearest64(q, t, kk: int, block: int = 1 << 14):
    """The kk nearest rows of t to each row of q in float64 on the card, by
    blocks of t: ``(distances ascending, indices)``."""
    import torch

    q64 = q.double()
    qq = (q64 * q64).sum(1, keepdim=True)
    vals = torch.full((q.shape[0], kk), float("inf"), dtype=torch.float64, device=q.device)
    idx = torch.zeros((q.shape[0], kk), dtype=torch.int64, device=q.device)
    for j in range(0, t.shape[0], block):
        tb = t[j:j + block].double()
        d2 = torch.addmm(qq + (tb * tb).sum(1)[None, :], q64, tb.T, alpha=-2.0)
        v, p = torch.topk(torch.cat([vals, d2], 1), kk, dim=1, largest=False)
        idx = torch.where(p < kk, idx.gather(1, p.clamp(max=kk - 1)), p - kk + j)
        vals = v
        del d2
    return vals.clamp(min=0).sqrt(), idx


def distances_phase(dev, smi: str) -> int:
    """Phase distances: cdist (direct and expanded), manhattan and rbf of
    2^16 x 16 against 2^14 x 16 points, cdist of 2^15 points with
    themselves, cdist_topk and KNN of 2^15 queries against 2^20 training
    rows, KMedians and KMedoids on benchmarks/cb/cluster.py's spherical
    data at 2^27 rows, and the Laplacian of 2^15 spherical points; each
    call's first and warm wall time, its error against float64 truth on the
    card, the memory it took and its bound.  Returns the threefry launches
    (the data's draws and the ++ inits)."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _kcluster, kmedians, kmedoids
    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.core import random as rnd

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    peaks: list = []
    restart_peak(peaks)
    zero_launches()
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    f = DIST_FEATURES

    # cdist, manhattan and rbf: each result 4.3 GB, held to float64 truth by blocks of X's rows
    x = torch.randn(DIST_ROWS, f, device=dev, generator=g)
    y = torch.randn(DIST_COLS, f, device=dev, generator=g)
    X, Y = ht.array(x, split=0), ht.array(y, split=0)
    sigma = 4.0
    n, m = DIST_ROWS, DIST_COLS
    calls = {
        "cdist": (lambda: ht.spatial.cdist(X, Y), distance_bound(n, m, f, 3, 1)),
        "cdist_expanded": (lambda: ht.spatial.cdist(X, Y, quadratic_expansion=True), distance_bound(n, m, f, 2, 4)),
        "manhattan": (lambda: ht.spatial.manhattan(X, Y), distance_bound(n, m, f, 3, 0)),
        "rbf": (lambda: ht.spatial.rbf(X, Y, sigma=sigma), distance_bound(n, m, f, 2, 5)),
    }
    results, records = {}, []
    for name, (fn, b) in calls.items():
        out, rec = timed_call(fn, name, b, smi, peaks)
        if out.shape != (n, m) or out.split != 0 or out.larray.device != x.device:
            raise AssertionError(f"{name}: shape {out.shape}, split {out.split}, on {out.larray.device}")
        results[name], rec["rows"], rec["cols"] = out.larray, n, m
        records.append(rec)
    err = {name: [0.0, 0.0] for name in results}  # max |got - truth| and max |got - truth| / (1 + |truth|)
    y64 = y.double()
    for i in range(0, n, 256):
        diff = x[i:i + 256].double()[:, None, :] - y64[None, :, :]
        d2 = (diff * diff).sum(-1)
        truth = {"cdist": d2.sqrt(), "manhattan": diff.abs_().sum(-1), "rbf": torch.exp(-d2 / (2 * sigma * sigma))}
        truth["cdist_expanded"] = truth["cdist"]
        del diff
        for name, t in truth.items():
            e = (results[name][i:i + 256].double() - t).abs_()
            err[name][0] = max(err[name][0], float(e.max()))
            err[name][1] = max(err[name][1], float((e / (1.0 + t.abs())).max()))
    for rec in records:
        rec["max_abs_err"], rec["max_rel_err"] = err[rec["call"]]
        limit = 1e-5 if rec["call"] == "cdist" else 1e-4  # the CPU tests' bounds against the reference
        if rec["max_rel_err"] > limit:
            raise AssertionError(f"{rec['call']}: {rec['max_rel_err']} from float64 (bound {limit})")
    del results, X, Y, y64
    torch.cuda.empty_cache()
    xs = torch.randn(DIST_SELF_ROWS, f, device=dev, generator=g)
    XS = ht.array(xs, split=0)
    out, rec = timed_call(lambda: ht.spatial.cdist(XS), "cdist_self",
                          distance_bound(DIST_SELF_ROWS, DIST_SELF_ROWS, f, 3, 1), smi, peaks)
    worst = 0.0
    for i in range(0, DIST_SELF_ROWS, 256):
        diff = xs[i:i + 256].double()[:, None, :] - xs.double()[None, :, :]
        t = (diff * diff).sum(-1).sqrt()
        worst = max(worst, float(((out.larray[i:i + 256].double() - t).abs() / (1.0 + t)).max()))
    if worst > 1e-5 or out.shape != (DIST_SELF_ROWS, DIST_SELF_ROWS) or bool((out.larray.diagonal() != 0).any()):
        raise AssertionError(f"cdist(X'): {worst} from float64, or a non-zero diagonal")
    rec.update(rows=DIST_SELF_ROWS, cols=DIST_SELF_ROWS, max_rel_err=worst)
    records.append(rec)
    del out, XS, xs, x, y
    torch.cuda.empty_cache()

    # cdist_topk and KNN: create_clusters' blobs, their labels by the clusters' counts
    rng = np.random.default_rng(SEED + 15)
    means = rng.standard_normal((KNN_CLUSTERS, f)).astype(np.float32)
    stds = np.ones(KNN_CLUSTERS, np.float32)
    train = ht.utils.data.create_clusters(KNN_TRAIN, f, KNN_CLUSTERS, means, stds, device="gpu", random_state=3)
    queries = ht.utils.data.create_clusters(KNN_QUERIES, f, KNN_CLUSTERS, means, stds, device="gpu", random_state=4)
    train_labels = torch.arange(KNN_CLUSTERS, device=dev).repeat_interleave(KNN_TRAIN // KNN_CLUSTERS)
    query_labels = torch.arange(KNN_CLUSTERS, device=dev).repeat_interleave(KNN_QUERIES // KNN_CLUSTERS)
    q, t = queries.larray, train.larray
    want_d, want_i = nearest64(q, t, KNN_K + 1)
    topk_bound = distance_bound(KNN_QUERIES, KNN_TRAIN, f, 2, 4, out_bytes=0)
    (vals, idx), rec = timed_call(lambda: ht.spatial.cdist_topk(queries, train, KNN_K), "cdist_topk", topk_bound, smi, peaks)
    chosen = (q.double()[:, None, :] - t.double()[idx.larray.long()]).pow(2).sum(-1).sqrt()  # the port's picks in float64
    gap = (chosen - want_d[:, :KNN_K]).abs() / (1.0 + want_d[:, :KNN_K])
    val_err = float(((vals.larray.double() - want_d[:, :KNN_K]).abs() / (1.0 + want_d[:, :KNN_K])).max())
    if float(gap.max()) > 1e-5 or val_err > 1e-4 or vals.shape != (KNN_QUERIES, KNN_K) or idx.dtype is not ht.int32:
        raise AssertionError(f"cdist_topk: picks {float(gap.max())} from the float64 k nearest, values {val_err}")
    rec.update(rows=KNN_QUERIES, cols=KNN_TRAIN, k=KNN_K, max_rel_err=val_err,
               indices_not_float64s=int((idx.larray.long() != want_i[:, :KNN_K]).sum()),
               picks_max_rel_gap=float(gap.max()))
    records.append(rec)
    # one block of the merge's candidates: the int64-key selection beside a
    # float32 topk (no tie order) and a stable sort, the two it stands between
    from heat_tpu_torch.spatial import distance

    cols = distance._BLOCK_ELEMENTS // KNN_QUERIES
    cand = torch.rand(KNN_QUERIES, cols, device=dev, generator=g)
    records.append({"call": "topk_block", "rows": KNN_QUERIES, "cols": cols, "k": KNN_K,
                    "key64_topk_ms": time_ms(lambda: distance._smallest(cand, KNN_K), reps=5, warmup=1),
                    "f32_topk_ms": time_ms(lambda: torch.topk(cand, KNN_K, dim=1, largest=False), reps=5, warmup=1),
                    "stable_sort_ms": time_ms(lambda: torch.sort(cand, dim=1, stable=True), reps=5, warmup=1),
                    "card": smi})
    del cand
    knn = ht.classification.KNeighborsClassifier(n_neighbors=KNN_K).fit(train, ht.array(train_labels, split=0))
    pred, rec = timed_call(lambda: knn.predict(queries), "knn_predict", topk_bound, smi, peaks)
    votes64 = torch.nn.functional.one_hot(train_labels[want_i[:, :KNN_K]], KNN_CLUSTERS).sum(1).argmax(1)
    differ = torch.nonzero(pred.larray != votes64)[:, 0]
    kth, next_ = want_d[differ, KNN_K - 1], want_d[differ, KNN_K]
    if not bool(((next_ - kth) <= 1e-5 * (1.0 + next_)).all()):
        raise AssertionError(f"KNN: {differ.numel()} votes differ from float64's, not all at a near-tie of the k-th")
    accuracy = float((pred.larray == query_labels).double().mean())
    if pred.dtype is not ht.int64 or pred.split != 0 or accuracy < 0.9:
        raise AssertionError(f"KNN: {pred.dtype}, split {pred.split}, accuracy {accuracy}")
    rec.update(rows=KNN_QUERIES, train_rows=KNN_TRAIN, k=KNN_K, accuracy=accuracy,
               votes_not_float64s=int(differ.numel()))
    records.append(rec)
    del train, queries, knn, pred, vals, idx, want_d, want_i, chosen, gap, q, t
    torch.cuda.empty_cache()
    for r in records:
        emit({"phase": "distances", **r})

    # KMedians and KMedoids on benchmarks/cb/cluster.py's data at 2^27 rows
    t0 = time.perf_counter()
    data = ht.utils.data.spherical.create_spherical_dataset(
        num_samples_cluster=SPHERE_PER_CLUSTER, radius=1.0, offset=4.0, dtype=ht.float32, random_state=1, device="gpu")
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    pts = data.larray
    for name, init in (("KMedians", "kmedians++"), ("KMedoids", "kmedoids++")):
        torch.cuda.synchronize()
        restart_peak(peaks)
        t0 = time.perf_counter()
        est, syncs = count_syncs(lambda: getattr(ht.cluster, name)(n_clusters=4, init=init).fit(data))
        n_iter = est.n_iter_
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        c = est.cluster_centers_.larray
        # an iteration is one update and one host read of the shift
        update = ((lambda: kmedians._medians(data, kmedians._ordered(pts), c)) if name == "KMedians"
                  else (lambda: kmedoids._medoids(data, c)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, update_syncs = count_syncs(update)
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t0) * 1e3
        members, counts, _ = _kcluster._members(data, c)
        labels = est.labels_.larray
        if not torch.equal(labels, members.to(torch.int64).argmax(0)):
            raise AssertionError(f"{name}: labels_ are not the nearest centres of the fit's centres")
        check = {}
        if name == "KMedians":
            # one more update from the fit's centres is each centre's members' exact median
            again = kmedians._medians(data, kmedians._ordered(pts), c)
            for j in range(4):
                s = torch.sort(pts[members[j]], dim=0).values
                med = (s[(s.shape[0] - 1) // 2] + s[s.shape[0] // 2]) * 0.5
                if not torch.equal(med, again[j]):
                    raise AssertionError(f"KMedians: centre {j}'s update {again[j].tolist()}, the sorted median "
                                         f"{med.tolist()}")
            check = {"update_is_sorted_median": True, "centres_fixed_point": bool(torch.equal(again, c))}
        else:
            # each centre a member row whose city-block sum to its members' mean is least, in float64
            worst = 0.0
            for j in range(4):
                rows = pts[members[j]].double()
                mean = rows.mean(0)
                dm = (rows - mean).abs().sum(1)
                mine = float((c[j].double() - mean).abs().sum())
                worst = max(worst, (mine - float(dm.min())) / (1.0 + float(dm.min())))
                if not bool((pts[members[j]] == c[j]).all(1).any()):
                    raise AssertionError(f"KMedoids: centre {j} is not a row of its members")
            if worst > 1e-5:
                raise AssertionError(f"KMedoids: a centre's city-block sum to the mean is {worst} above the least")
            check = {"centres_are_member_rows": True, "medoid_excess_rel": worst}
        emit({"phase": "distances", "call": f"{name}.fit", "config": "benchmarks/cb/cluster.py:15-40", "rows": pts.shape[0],
              "features": 3, "clusters": 4, "init": init, "n_iter": n_iter, "fit_wall_ms": fit_ms,
              "update_wall_ms": update_ms, "host_syncs": syncs,
              "host_syncs_per_iteration": update_syncs + 1,
              "counts": counts.tolist(), "inertia": est.inertia_, "peak_gb": peak / 1e9, **check,
              "data_make_s": make_s, "card": smi})
        del est, members, labels
        torch.cuda.empty_cache()
    del data, pts
    torch.cuda.empty_cache()

    # the Laplacian of 2^15 spherical points: diagonal 1, symmetric within 1e-5 (tests/test_ml.py:164-173)
    lap_pts = ht.utils.data.spherical.create_spherical_dataset(LAPLACIAN_ROWS // 4, random_state=2, device="gpu")
    lap = ht.graph.Laplacian(lambda z: ht.spatial.rbf(z, sigma=1.0), definition="norm_sym")
    L, rec = timed_call(lambda: lap.construct(lap_pts), "laplacian",
                        distance_bound(LAPLACIAN_ROWS, LAPLACIAN_ROWS, 3, 2, 9), smi, peaks)
    Ll = L.larray
    diag_err = float((Ll.diagonal() - 1.0).abs().max())
    asym, b = 0.0, 4096
    for i in range(0, LAPLACIAN_ROWS, b):
        for j in range(i, LAPLACIAN_ROWS, b):
            asym = max(asym, float((Ll[i:i + b, j:j + b] - Ll[j:j + b, i:i + b].T).abs().max()))
    if diag_err > 1e-5 or asym > 1e-5 or L.shape != (LAPLACIAN_ROWS, LAPLACIAN_ROWS) or not bool(torch.isfinite(Ll).all()):
        raise AssertionError(f"Laplacian: diagonal {diag_err} from 1, asymmetry {asym}")
    emit({"phase": "distances", **rec, "rows": LAPLACIAN_ROWS, "diag_err": diag_err, "asymmetry": asym})
    del L, Ll, lap_pts
    torch.cuda.empty_cache()

    threefry = rnd.THREEFRY_LAUNCHES
    others = kernels.LLOYD_LAUNCHES + kernels.GRAM_LAUNCHES + sum(fft_launches().values())
    restart_peak(peaks)
    peak = max(peaks)
    if others or threefry < 1 or peak > DIST_PEAK_BYTES:
        raise AssertionError(f"distances: {others} launches of K1-K6, threefry {threefry}, peak {peak / 1e9} GB")
    emit({"phase": "distances", "threefry_launches": threefry, "phase_peak_gb": peak / 1e9,
          "phase_seconds": time.perf_counter() - t_phase, "card": smi})
    return threefry


# the linalg path (tutorial 5 at the sizes a user factors on one card): a
# tall 2^22 x 128 float32 matrix (2 GiB, the hSVD width), an SPD 16384^2
# float32 matrix (1 GiB), CG on a backward-Euler step of the 1-D heat
# equation, (I + tau L) x = b with L = tridiag(-1, 2, -1), 4096 points
LINALG_ROWS = 1 << 22
LINALG_COLS = 128
SPD_N = 16384
LANCZOS_M = 64
CG_N = 4096
CG_TAU = 3e4  # condition number 1 + 4 tau: the float32 stop test holds after most of len(b) steps
# log|det| of the near-identity SPD matrix by float32 LU, held within about
# three times what cuSOLVER's getrf reads on an H100 (1.37e-3 at 16384,
# 3.9e-4 at the head's 512; PERF.md, linalg); the CPU's LAPACK reads
# 7.0e-6 at the head
LU_LOG_BOUND = 4e-3
LU_HEAD_LOG_BOUND = 1.2e-3
LU_HEAD_LOG_BOUND_CPU = 1e-4
LINALG_HEAD_ROWS = 4096  # rows of the tall matrix held against the CPU
LINALG_HEAD_N = 512  # leading block of the SPD matrix held against the CPU


def linalg_bound(nbytes: float, flops: float) -> dict:
    """The least time of a float32 factorization: its inputs read and its
    outputs written once at the HBM rate, or its float32 operations on the
    CUDA cores (no TF32 enters these paths), whichever is larger."""
    b = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": flops / F32_FLOPS * 1e3}
    by = max(b, key=b.get)
    return {"bound_ms": b[by], "bound_by": by}


def _rel_max(x, y) -> float:
    """max |x - y| over max |y|."""
    return float((x - y).abs().max() / y.abs().max())


def _rel_fro(x, y) -> float:
    """||x - y|| over ||y||, Frobenius."""
    import torch

    return float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))


def linalg_phase(dev, smi: str) -> int:
    """Phase linalg: qr, svd and PCA(svd_solver="full").fit of a 2^22 x 128
    float32 matrix; cholesky, det, slogdet, solve, inv and lanczos (m = 64)
    of an SPD 16384^2 float32 matrix; cg on a 4096-point heat-equation
    step; each through the entry point a user calls, its first and warm
    wall time beside its bound, each result held on the card by a float64
    residual and, at a head size, against the port on the CPU.  det and
    slogdet are also held at the head with its rows rolled by one (an odd
    permutation: every pivot needs a row swap and the sign is -1), and
    beside MAGMA's getrf on the same matrix.  No kernel of the port runs
    here (the JAX package's linalg has none); returns the threefry
    launches of the timed lanczos calls (their start vectors)."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import kernels
    from heat_tpu_torch.core import random as rnd

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    peaks: list = []
    restart_peak(peaks)
    zero_launches()
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    m, n, hm = LINALG_ROWS, LINALG_COLS, LINALG_HEAD_ROWS
    a = torch.randn(m, n, device=dev, generator=g) * torch.linspace(10.0, 1.0, n, device=dev) + 0.5
    A = ht.array(a, split=0)
    a64 = a.double()
    head, head_cpu = ht.array(a[:hm], split=0), ht.array(a[:hm].cpu(), split=0, device="cpu")
    records = []

    def record(rec, **checks):
        records.append({**rec, **checks})
        emit({"phase": "linalg", **rec, **checks})

    # qr: Householder QR and Q formed, 4 m n^2 - 4 n^3 / 3 flops
    (q, r), rec = timed_call(lambda: ht.linalg.qr(A), "qr", linalg_bound(8 * m * n + 4 * n * n,
                                                                            4 * m * n * n - 4 * n ** 3 / 3),
                             smi, peaks)
    q64, r64 = q.larray.double(), r.larray.double()
    qr_res, qr_max = _rel_fro(q64 @ r64, a64), _rel_max(q64 @ r64, a64)
    orth = float((q64.T @ q64 - torch.eye(n, dtype=torch.float64, device=dev)).abs().max())
    below = float(r.larray.tril(-1).abs().max())
    hq, hr = ht.linalg.qr(head)
    cq, cr = ht.linalg.qr(head_cpu)
    sign = torch.sign(torch.diagonal(hr.larray).cpu()) * torch.sign(torch.diagonal(cr.larray))
    head_err = max(_rel_max(hr.larray.cpu() * sign[:, None], cr.larray), _rel_max(hq.larray.cpu() * sign, cq.larray))
    if qr_res > 1e-4 or orth > 1e-4 or below != 0.0 or head_err > 1e-4 or (q.split, r.split) != (0, None):
        raise AssertionError(f"qr: |QR - A| {qr_res}, |Q^T Q - I| {orth}, below R's diagonal {below}, "
                             f"head against the CPU {head_err}")
    record(rec, qr_residual=qr_res, qr_max_abs_over_max=qr_max, q_orthonormality_err=orth, head_vs_cpu=head_err)
    del q, r, q64, r64
    torch.cuda.empty_cache()

    # svd through the QR, then U = Q u_r (2 m n^2 more flops)
    (u, s, v), rec = timed_call(lambda: ht.linalg.svd(A), "svd", linalg_bound(8 * m * n + 4 * n * (n + 1),
                                                                                6 * m * n * n), smi, peaks)
    u64, s64, v64 = u.larray.double(), s.larray.double(), v.larray.double()
    svd_res = _rel_fro((u64 * s64) @ v64.T, a64)
    orth = float((u64.T @ u64 - torch.eye(n, dtype=torch.float64, device=dev)).abs().max())
    gram = a64.T @ a64
    truth = torch.sqrt(torch.linalg.eigvalsh(gram).flip(0))
    s_err = float(((s64 - truth) / truth).abs().max())
    s_head = float(((ht.linalg.svd(head, compute_uv=False).larray.cpu() - ht.linalg.svd(head_cpu, compute_uv=False)
                     .larray) / ht.linalg.svd(head_cpu, compute_uv=False).larray).abs().max())
    if svd_res > 1e-4 or orth > 1e-4 or s_err > 1e-4 or s_head > 1e-4:
        raise AssertionError(f"svd: |U S V^T - A| {svd_res}, |U^T U - I| {orth}, S against float64 {s_err}, "
                             f"head against the CPU {s_head}")
    record(rec, svd_residual=svd_res, u_orthonormality_err=orth, s_rel_err=s_err, head_vs_cpu=s_head)
    del u, s, v, u64, s64, v64, gram
    torch.cuda.empty_cache()

    # PCA(svd_solver="full"): the mean, the centred copy, then the svd
    (pca), rec = timed_call(lambda: ht.decomposition.PCA(n_components=10, svd_solver="full").fit(A), "pca_full",
                            linalg_bound(16 * m * n, 6 * m * n * n), smi, peaks)
    centred = a64 - a64.mean(0)
    w, vecs = torch.linalg.eigh(centred.T @ centred / (m - 1))
    w, vecs = w.flip(0)[:10], vecs.flip(1)[:, :10]
    del centred
    comps = pca.components_.larray.double()
    ev_err = float(((pca.explained_variance_.larray.double() - w) / w).abs().max())
    align = float((comps @ vecs).diagonal().abs().min())
    c_orth = float((comps @ comps.T - torch.eye(10, dtype=torch.float64, device=dev)).abs().max())
    # at the head the sample's eigenvalue gaps are as small as its rounding
    # moves the components, so the head holds the spectrum
    hp = ht.decomposition.PCA(n_components=10, svd_solver="full").fit(head).explained_variance_.larray.cpu()
    cp = ht.decomposition.PCA(n_components=10, svd_solver="full").fit(head_cpu).explained_variance_.larray
    pca_head = float(((hp - cp) / cp).abs().max())
    if ev_err > 1e-4 or align < 1 - 1e-4 or c_orth > 1e-4 or pca_head > 1e-4:
        raise AssertionError(f"pca_full: variance {ev_err}, alignment {align}, orthonormality {c_orth}, "
                             f"head against the CPU {pca_head}")
    record(rec, explained_variance_rel_err=ev_err, min_alignment=align, components_orthonormality_err=c_orth,
           head_vs_cpu=pca_head)
    del pca, comps, A, a, a64, head, head_cpu
    torch.cuda.empty_cache()

    # the SPD matrix: I + c (B + B^T) / 2, B uniform in (-1, 1), c = sqrt(240) / N:
    # its eigenvalues within 1 +- 0.1, log det about -20 (finite in float32)
    N, hn = SPD_N, LINALG_HEAD_N
    spd = torch.rand(N, N, device=dev, generator=g) * 2 - 1
    spd = (spd + spd.T) * (float(np.sqrt(240.0)) / N / 2)
    spd.diagonal().add_(1.0)
    S = ht.array(spd, split=0)
    s64 = spd.double()
    eye64 = torch.eye(N, dtype=torch.float64, device=dev)
    sh, sh_cpu = ht.array(spd[:hn, :hn].contiguous(), split=0), ht.array(spd[:hn, :hn].cpu(), split=0, device="cpu")
    sign64, logdet64 = torch.linalg.slogdet(s64)

    L, rec = timed_call(lambda: ht.linalg.cholesky(S), "cholesky", linalg_bound(8 * N * N, N ** 3 / 3), smi, peaks)
    l64 = L.larray.double()
    chol_res = _rel_fro(l64 @ l64.T, s64)
    chol_head = _rel_max(ht.linalg.cholesky(sh).larray.cpu(), ht.linalg.cholesky(sh_cpu).larray)
    if chol_res > 1e-4 or chol_head > 1e-4 or float(L.larray.triu(1).abs().max()) != 0.0:
        raise AssertionError(f"cholesky: |L L^T - S| {chol_res}, head against the CPU {chol_head}")
    record(rec, cholesky_residual=chol_res, head_vs_cpu=chol_head)
    del L, l64
    torch.cuda.empty_cache()

    lu_flops = 2 * N ** 3 / 3
    # the head, and the head with its rows rolled by one: partial pivoting
    # swaps a row at every column, and the n - 1 swaps make the sign -1
    rolled = torch.roll(spd[:hn, :hn], 1, 0)
    heads = {"head": (sh, sh_cpu), "rolled": (ht.array(rolled, split=0), ht.array(rolled.cpu(), split=0, device="cpu"))}
    truth = {key: tuple(float(v) for v in torch.linalg.slogdet(pair[0].larray.double())) for key, pair in heads.items()}

    def head_errs(sign_log):
        """|log|det| - float64's| of the port on the card and on the CPU at
        both heads (inf where the sign is not float64's)."""
        errs = {}
        for key, pair in heads.items():
            sign64_h, log64_h = truth[key]
            for where, mat in zip(("card", "cpu"), pair):
                sgn, log = sign_log(mat)
                errs[f"{key}_{where}"] = abs(log - log64_h) if sgn == sign64_h else float("inf")
        return errs

    def heads_hold(errs) -> bool:
        return max(errs["head_card"], errs["rolled_card"]) <= LU_HEAD_LOG_BOUND and \
            max(errs["head_cpu"], errs["rolled_cpu"]) <= LU_HEAD_LOG_BOUND_CPU

    def det_sign_log(mat):
        v = float(ht.linalg.det(mat))
        return float(np.sign(v)), float(np.log(abs(v))) if v != 0 else -float("inf")

    def slogdet_sign_log(mat):
        sgn, log = ht.linalg.slogdet(mat)
        return float(sgn), float(log)

    d, rec = timed_call(lambda: ht.linalg.det(S), "det", linalg_bound(4 * N * N, lu_flops), smi, peaks)
    det = float(d)
    det_err = abs(np.log(abs(det)) - float(logdet64)) if det != 0 else float("inf")
    det_heads = head_errs(det_sign_log)
    if not np.isfinite(det) or np.sign(det) != float(sign64) or det_err > LU_LOG_BOUND or not heads_hold(det_heads):
        raise AssertionError(f"det {det} against float64 log|det| {float(logdet64)} (sign {float(sign64)}), "
                             f"heads: {det_heads} from float64")
    record(rec, det=det, logdet_float64=float(logdet64), log_abs_err=det_err, log_bound=LU_LOG_BOUND,
           **{f"{k}_log_abs_err": v for k, v in det_heads.items()}, head_log_bound=LU_HEAD_LOG_BOUND,
           head_log_bound_cpu=LU_HEAD_LOG_BOUND_CPU, rolled_sign_float64=truth["rolled"][0])

    (sl_sign, sl_log), rec = timed_call(lambda: ht.linalg.slogdet(S), "slogdet", linalg_bound(4 * N * N, lu_flops),
                                        smi, peaks)
    sl_err = abs(float(sl_log) - float(logdet64))
    sl_heads = head_errs(slogdet_sign_log)
    if float(sl_sign) != float(sign64) or sl_err > LU_LOG_BOUND or not heads_hold(sl_heads):
        raise AssertionError(f"slogdet: {float(sl_log)} against {float(logdet64)}, heads: {sl_heads} from float64")
    record(rec, logabsdet=float(sl_log), abs_err=sl_err, **{f"{k}_abs_err": v for k, v in sl_heads.items()})

    # MAGMA's getrf on the same matrices, beside cuSOLVER's (the port's
    # route through torch.linalg): a library reading, used nowhere in the port
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        (mg_sign, mg_log), rec = timed_call(lambda: torch.linalg.slogdet(spd), "slogdet_magma",
                                            linalg_bound(4 * N * N, lu_flops), smi, peaks)
        mg_heads = {key: abs(float(torch.linalg.slogdet(pair[0].larray)[1]) - truth[key][1])
                    for key, pair in heads.items()}
        mg_signs = {key: float(torch.linalg.slogdet(pair[0].larray)[0]) == truth[key][0] for key, pair in heads.items()}
    finally:
        torch.backends.cuda.preferred_linalg_library(before)
    emit({"phase": "linalg", **rec, "library": "torch.linalg.slogdet under preferred_linalg_library('magma')",
          "abs_err": abs(float(mg_log) - float(logdet64)), "sign_right": float(mg_sign) == float(sign64),
          **{f"{k}_abs_err": v for k, v in mg_heads.items()}, "head_signs_right": mg_signs})

    b = torch.randn(N, device=dev, generator=g)
    B = ht.array(b, split=0)
    x, rec = timed_call(lambda: ht.linalg.solve(S, B), "solve", linalg_bound(4 * N * N + 8 * N, lu_flops + 2 * N * N),
                        smi, peaks)
    b64 = b.double()
    solve_res = float(torch.linalg.vector_norm(s64 @ x.larray.double() - b64) / torch.linalg.vector_norm(b64))
    bh = ht.array(b[:hn], split=0)
    solve_head = _rel_max(ht.linalg.solve(sh, bh).larray.cpu(), ht.linalg.solve(sh_cpu, ht.array(b[:hn].cpu(),
                                                                                               device="cpu")).larray)
    if solve_res > 1e-4 or solve_head > 1e-4:
        raise AssertionError(f"solve: |S x - b| / |b| {solve_res}, head against the CPU {solve_head}")
    record(rec, solve_residual=solve_res, head_vs_cpu=solve_head)
    del x

    inv, rec = timed_call(lambda: ht.linalg.inv(S), "inv", linalg_bound(8 * N * N, 2 * N ** 3), smi, peaks)
    inv_res = _rel_fro(s64 @ inv.larray.double(), eye64)
    inv_head = _rel_max(ht.linalg.inv(sh).larray.cpu(), ht.linalg.inv(sh_cpu).larray)
    if inv_res > 1e-4 or inv_head > 1e-4:
        raise AssertionError(f"inv: |S inv - I| {inv_res}, head against the CPU {inv_head}")
    record(rec, inv_residual=inv_res, head_vs_cpu=inv_head)
    del inv
    torch.cuda.empty_cache()

    # lanczos: m matrix-vector products and the reorthogonalisations
    def lanczos():
        ht.random.seed(SEED)
        return ht.linalg.lanczos(S, LANCZOS_M)

    threefry_before = rnd.THREEFRY_LAUNCHES
    (V, T), rec = timed_call(lanczos, "lanczos", linalg_bound(LANCZOS_M * 4 * N * N, LANCZOS_M * 2 * N * N), smi,
                             peaks)
    lanczos_draws = rnd.THREEFRY_LAUNCHES - threefry_before
    v64, t64 = V.larray.double(), T.larray.double()
    k = LANCZOS_M - 1
    rel_res = _rel_fro(s64 @ v64[:, :k], v64 @ t64[:, :k])  # A V_k = V T[:, :k], the three-term recurrence
    v_orth = float((v64.T @ v64 - torch.eye(LANCZOS_M, dtype=torch.float64, device=dev)).abs().max())
    ht.random.seed(SEED)
    t_card = ht.linalg.lanczos(sh, 32)[1].larray.cpu()
    ht.random.seed(SEED)
    t_head = float((t_card - ht.linalg.lanczos(sh_cpu, 32)[1].larray).abs().max())
    if rel_res > 1e-4 or v_orth > 1e-4 or t_head > 1e-4 or lanczos_draws != 2:
        raise AssertionError(f"lanczos: |S V - V T| {rel_res}, |V^T V - I| {v_orth}, head T against the CPU "
                             f"{t_head}, threefry launches {lanczos_draws} (one a call)")
    record(rec, recurrence_residual=rel_res, v_orthonormality_err=v_orth, head_t_vs_cpu=t_head,
           threefry_launches=lanczos_draws)
    del V, T, v64, t64

    # cg on (I + tau L) x = b: the reference's stop test (sqrt(rs) >= 1e-10)
    # holds for most of len(b) float32 steps, so the timed call runs the
    # loop that reads the test only every 16 steps; the up to 15 steps after
    # the test fails run frozen and are not in the bound
    from heat_tpu_torch.core.linalg import solver

    nc, tau = CG_N, CG_TAU
    lap = torch.eye(nc, device=dev) * (1 + 2 * tau)
    lap.diagonal(1).fill_(-tau)
    lap.diagonal(-1).fill_(-tau)
    c4, b4 = ht.array(lap, split=0), ht.array(b[:nc], split=0)
    ht.linalg.cg(c4, b4, ht.zeros(nc, split=0))
    steps = solver.CG_STEPS  # the steps this data needs: one read of the matrix each
    x4, rec = timed_call(lambda: ht.linalg.cg(c4, b4, ht.zeros(nc, split=0)), "cg",
                         linalg_bound(steps * 4 * nc * nc, steps * 2 * nc * nc), smi, peaks)
    x64, b64c = x4.larray.double(), b64[:nc]
    cg_res = float(torch.linalg.vector_norm(lap.double() @ x64 - b64c) / torch.linalg.vector_norm(b64c))
    # float32 CG's attainable residual: sqrt(steps) u |A| |x| / |b| (the
    # roundings of each step add up as a random walk; an H100 reads about
    # a sixth of it, PERF.md), |A| = 1 + 2 tau (1 + cos(pi / (n + 1)))
    a_norm = 1 + 2 * tau * (1 + np.cos(np.pi / (nc + 1)))
    cg_bound = steps ** 0.5 * 2.0 ** -24 * a_norm * float(torch.linalg.vector_norm(x64) / torch.linalg.vector_norm(b64c))
    cg_head = _rel_max(ht.linalg.cg(sh, bh, ht.zeros(hn, split=0)).larray.cpu(),
                       ht.linalg.cg(sh_cpu, ht.array(b[:hn].cpu(), split=0, device="cpu"),
                                    ht.zeros(hn, split=0, device="cpu")).larray)
    if cg_res > cg_bound or steps < nc // 2 or cg_head > 1e-4:
        raise AssertionError(f"cg: |A x - b| / |b| {cg_res} (bound {cg_bound}) in {steps} steps of at most {nc}, "
                             f"head against the CPU {cg_head}")
    record(rec, cg_residual=cg_res, cg_residual_bound=cg_bound, head_vs_cpu=cg_head, steps=steps, max_steps=nc,
           condition_number=1 + 4 * tau)
    del S, spd, s64, eye64, lap, c4, b4, x4, x64
    torch.cuda.empty_cache()

    others = kernels.LLOYD_LAUNCHES + kernels.GRAM_LAUNCHES + sum(fft_launches().values())
    restart_peak(peaks)
    if others:
        raise AssertionError(f"linalg: {others} launches of K1-K6, where the path runs no kernel")
    emit({"phase": "linalg", "calls": len(records), "threefry_launches": lanczos_draws,
          "threefry_launches_of_checks": rnd.THREEFRY_LAUNCHES - lanczos_draws, "phase_peak_gb": max(peaks) / 1e9,
          "phase_seconds": time.perf_counter() - t_phase, "card": smi})
    return lanczos_draws


# a graph of 16.7 M nodes of degree 16 (a PageRank-size adjacency), 2^28 nnz,
# 3.2 GB of planes a matrix
SPARSE_ROWS = 1 << 24
SPARSE_DEGREE = 16
SPARSE_X_COLS = 32  # X of 2^24 x 32 float32, split 0: 2.1 GB
SPARSE_CHECK_ROWS = 1 << 18  # every op's pattern held bitwise against scipy's at this size
SPARSE_SAMPLE = 4096  # rows (and columns) of each full-size result recomputed in float64 on the host
SPARSE_DENSE_N = 1 << 15  # todense of 2^15 x 2^15: 4.3 GB
SPGEMM_ROWS = 1 << 20  # S @ S of 2^20 x 2^20, 16 a row: the ring route, about 2^28 nnz out
SPGEMM_DENSE_N = 4096  # the dense route: 4096 x 4096 at density 0.05
SPGEMM_DENSE_DENSITY = 0.05
SPARSE_PEAK_BYTES = 60e9


def random_graph(n: int, degree: int, dev, g, density: float = 0.0):
    """A seeded n x n float32 torch sparse COO tensor on the card: ``degree``
    columns a row drawn uniformly (duplicates left in, for the factory to
    merge), or each entry present with probability ``density``; values
    uniform in [0.5, 1.5), so that no sum cancels."""
    import torch

    if density:
        mask = torch.rand(n, n, device=dev, generator=g) < density
        rows, cols = torch.nonzero(mask, as_tuple=True)
        del mask
    else:
        rows = torch.arange(n, device=dev).repeat_interleave(degree)
        cols = torch.randint(0, n, (n * degree,), device=dev, generator=g)
    vals = torch.rand(rows.numel(), device=dev, generator=g) + 0.5
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n))


def host_csr(coo, rows=None):
    """The scipy CSR matrix (duplicates summed, indices sorted) of a torch
    COO tensor, or of its rows ``rows`` (a sorted tensor on the card: only
    their entries come to the host)."""
    import scipy.sparse as sp
    import torch

    idx, vals = coo._indices(), coo._values()
    shape = tuple(coo.shape)
    if rows is not None:
        keep = torch.isin(idx[0], rows)
        idx, vals = torch.stack([torch.searchsorted(rows, idx[0][keep]), idx[1][keep]]), vals[keep]
        shape = (rows.numel(), shape[1])
    idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
    out = sp.coo_matrix((vals, (idx[0], idx[1])), shape=shape).tocsr()
    out.sort_indices()
    return out


def digest(*tensors) -> list:
    """Bitwise fingerprints of tensors: the sum of each one's bits as
    integers, weighted by position (equal bits give equal sums)."""
    import torch

    out = []
    for t in tensors:
        t = t.contiguous().reshape(-1)
        bits = t.view(torch.int64 if t.element_size() == 8 else torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=t.device) % 1000003 + 1
        out.append((int(bits.numel()), int((bits * w).sum()), int(bits.sum())))
    return out


def fingerprint(res) -> list:
    """A result's fingerprints: a sparse matrix's planes and counts, a dense
    array's chunk."""
    if hasattr(res, "_comp"):
        return [res._lnnz_host] + digest(res._comp, res._other, res._val)
    return digest(res.larray_padded)


def sparse_twice(fn, name: str, nbytes, smi: str, peaks: list, **extra):
    """``fn``'s warm result and a record of its first and warm wall time,
    the memory it took beyond what was allocated before it and its byte
    bound (``nbytes``, or a function of the result giving them); fails
    unless both runs give the same bits and the result lies on the card."""
    import torch

    first, first_ms = wall_ms(fn)
    first_bits = fingerprint(first)
    del first
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    restart_peak(peaks)
    out, warm_ms = wall_ms(fn)
    extra_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    if fingerprint(out) != first_bits:
        raise AssertionError(f"sparse {name}: a second run gave other bits")
    planes = (out._comp, out._other, out._val) if hasattr(out, "_comp") else (out.larray_padded,)
    if not all(p.is_cuda for p in planes):
        raise AssertionError(f"sparse {name}: the result is not on the card")
    bound_ms = (nbytes(out) if callable(nbytes) else nbytes) / HBM_BYTES_PER_S * 1e3
    return out, {"phase": "sparse", "call": name, "first_ms": first_ms, "warm_ms": warm_ms, "extra_peak_gb": extra_gb,
                 "bound_ms": bound_ms, "bound_by": "bytes", "share_of_bound": bound_ms / warm_ms,
                 "repeat_bitwise": True, **extra, "card": smi}


def planes_csr(m):
    """A CSR matrix's planes on one card as scipy CSR on the host (stored
    zeros kept; the planes of a CSC matrix read as its transpose)."""
    import numpy as np
    import scipy.sparse as sp

    n = m._n
    shape = m.shape if m._compressed_axis == 0 else m.shape[::-1]
    return sp.csr_matrix((m._val[:n].cpu().numpy(), m._other[:n].cpu().numpy(),
                          m.lindptr[: shape[0] + 1].cpu().numpy().astype(np.int64)), shape=shape)


def sampled_rows(m, rows):
    """The rows ``rows`` (a sorted int64 tensor on the card) of a CSR
    matrix on one card: (row position, column, value) of their stored
    entries, on the host."""
    import torch

    ptr = m.lindptr
    starts, counts = ptr[rows], ptr[rows + 1] - ptr[rows]
    which = torch.repeat_interleave(torch.arange(rows.numel(), device=rows.device), counts)
    pos = starts[which] + torch.arange(which.numel(), device=rows.device) - (torch.cumsum(counts, 0) - counts)[which]
    return which.cpu().numpy(), m._other[pos].cpu().numpy(), m._val[pos].cpu().numpy()


def same_rows(got, want, name: str, exact: bool = True, rtol: float = 0.0) -> None:
    """Two (position, column, value) samples: the same pattern in the same
    order, values bitwise or within ``rtol``."""
    import numpy as np

    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError(f"sparse {name}: the sampled rows' pattern differs")
    if exact and got[2].tobytes() != want[2].tobytes():
        raise AssertionError(f"sparse {name}: the sampled rows' values differ in their bits")
    if not exact:
        err = float(np.max(np.abs(got[2] - want[2]) / np.abs(want[2]))) if len(want[2]) else 0.0
        if err > rtol:
            raise AssertionError(f"sparse {name}: sampled values {err} from float64 (bound {rtol})")


def scipy_rows(s, rows):
    """The same sample of a scipy CSR matrix's rows."""
    import numpy as np

    sub = s[rows]
    return (np.repeat(np.arange(len(rows)), np.diff(sub.indptr)), sub.indices.astype(np.int32), sub.data)


def sparse_pattern_check(dev, g, smi: str) -> dict:
    """Every op at 2^18 x 2^18 (16 a row, the full size's construction):
    its indptr and indices bitwise scipy's on the host, stored zeros as the
    reference keeps them (scipy drops them: a + (-a) keeps a's pattern),
    the values of the exact ops bitwise, the products' within 1e-5 of
    float64."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import heat_tpu_torch as ht

    n = SPARSE_CHECK_ROWS
    coo_a, coo_b = (random_graph(n, SPARSE_DEGREE, dev, g) for _ in range(2))
    a, b = host_csr(coo_a), host_csr(coo_b)
    A, B = (ht.sparse.sparse_csr_matrix(c, split=0) for c in (coo_a, coo_b))
    x = torch.rand(n, SPARSE_X_COLS, device=dev, generator=g)
    x64 = x.cpu().double().numpy()
    checked = []

    def pattern(got, want, name, values=True):
        want.sort_indices()
        g_ = planes_csr(got)
        if not (np.array_equal(g_.indptr, want.indptr) and np.array_equal(g_.indices, want.indices)):
            raise AssertionError(f"sparse check {name}: indptr/indices differ from scipy's")
        if values and g_.data.tobytes() != want.data.astype(np.float32).tobytes():
            raise AssertionError(f"sparse check {name}: values differ from scipy's in their bits")
        if not (np.array_equal(got.indptr.cpu().numpy(), want.indptr) and
                np.array_equal(got.indices.cpu().numpy(), want.indices)):
            raise AssertionError(f"sparse check {name}: the global accessors differ from scipy's")
        checked.append(name)

    pattern(A, a, "construct")
    pattern(A + B, a + b, "add")
    pattern(A * B, a.multiply(b).tocsr(), "mul")
    pattern(A * 2.0, a * np.float32(2.0), "mul_scalar")
    plus = a.copy()
    plus.data = plus.data + np.float32(1.0)
    pattern(A + 1.0, plus, "add_scalar")
    zero = A + A * (-1.0)
    pattern(zero, a, "a + (-a)", values=False)
    if zero._val[: zero._n].abs().max() != 0:
        raise AssertionError("sparse check a + (-a): a stored value is not 0")
    pattern(A.T, a, "T")  # the CSC A.T, compressed along A's rows, holds A's CSR planes
    csc = ht.sparse.to_sparse_csc(A)
    want_csc = a.tocsc()  # a CSC's pointers and indices, read as its transpose's CSR
    pattern(csc, sp.csr_matrix((want_csc.data, want_csc.indices, want_csc.indptr), shape=a.shape[::-1]),
            "to_sparse_csc")
    pattern(ht.sparse.to_sparse_csr(csc), a, "to_sparse_csr")
    s = (a.astype(np.float64) @ a.astype(np.float64)).tocsr()
    s.sort_indices()
    prod = A @ A
    pattern(prod, s, "spgemm", values=False)
    got = planes_csr(prod)
    spgemm_err = float(np.max(np.abs(got.data - s.data) / np.abs(s.data)))
    a64 = a.astype(np.float64)
    spmm_err = float(np.max(np.abs((A @ ht.array(x, split=0)).larray.cpu().numpy() - a64 @ x64) /
                            np.maximum(np.abs(a64 @ x64), 1e-30)))
    csc_err = float(np.max(np.abs((A.T @ ht.array(x, split=0)).larray.cpu().numpy() - a64.T @ x64) /
                           np.maximum(np.abs(a64.T @ x64), 1e-30)))
    sums = [float(np.max(np.abs(A.sum(axis=ax).larray.cpu().numpy() - np.asarray(a64.sum(axis=ax)).ravel()) /
                         np.maximum(np.abs(np.asarray(a64.sum(axis=ax)).ravel()), 1e-30))) for ax in (0, 1)]
    worst = max(spgemm_err, spmm_err, csc_err, *sums)
    if worst > 1e-5:
        raise AssertionError(f"sparse check: products and sums {worst} from float64 (spgemm {spgemm_err}, "
                             f"spmm {spmm_err}, csc {csc_err}, sums {sums})")
    rec = {"phase": "sparse_check", "rows": n, "nnz": A.gnnz, "patterns_bitwise_scipy": checked,
           "spgemm_max_rel_err": spgemm_err, "spmm_max_rel_err": spmm_err, "csc_spmm_max_rel_err": csc_err,
           "sum_max_rel_err": sums, "card": smi}
    emit(rec)
    return rec


def csr_spmm_check(A, x, dev, g, smi: str) -> dict:
    """Phase csr_spmm_check: the CSR SpMM kernel against its plain version
    on the card at the main path's shapes (A's 2^24 rows and 2^28 entries
    times X's 32 columns, and times one column; the CSR of A^T, rows of
    Poisson(16) lengths, times X, as A.T @ X runs it; the dense-route
    SpGEMM's 4096 x 4096 matrix of density 0.05 times its dense self, width
    4096) and at ragged ones (empty rows, rows longer than a warp, widths
    3, 33 and 65, float64, x with a row stride past its width, accumulating
    into out, int32 and int64, and every other value type the port stores:
    float16, bfloat16, complex64, complex128, int8, uint8, int16, bool):
    max |kernel - plain| over max |plain| at most 1e-6 (float32; 1e-14
    float64: the two add each row's products in other orders, the kernel
    in fused multiply-adds; integers and bool exactly); for float16,
    bfloat16 and the complex types each element within (2 len + 8) u S of
    the plain one, S the row's sum of |w||x| (and |out|) and u the type's
    unit roundoff: each is within (len + 4) u S of the exact sum, the bound
    of a recursive sum of len products (the plain version adds in the type
    itself); a
    second launch bitwise equal to the first; the types and strides it
    refuses; its time beside its plain version's, its bound and cuSPARSE's
    SpMM on the same CSR, and how many distinct results cuSPARSE gives in
    8 runs on A and on the CSR of A^T (the reason the kernel exists).
    Returns its kernel entry (launches filled in by the main path)."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.sparse import _planes

    def compare(ptr, col, w, xx, label, out=None, tol=1e-6):
        base = None if out is None else out.clone()
        got = _planes.csr_spmm(ptr, col, w, xx, None if out is None else out.clone())
        again = _planes.csr_spmm(ptr, col, w, xx, None if out is None else out.clone())
        want = _planes._csr_spmm_plain(ptr, col, w, xx, torch.zeros_like(got) if base is None else base.clone())
        torch.cuda.synchronize()
        wide = torch.complex128 if got.is_complex() else torch.float64
        diff = (got.to(wide) - want.to(wide)).abs()
        err = float(diff.max())
        if tol == "rows":  # (2 len + 8) u S a row, S = sum |w||x| (plus |out|)
            u = (torch.finfo(got.real.dtype).eps if got.is_complex() else torch.finfo(got.dtype).eps) / 2
            s_row = _planes._csr_spmm_plain(ptr, col, w.abs().double(), xx.abs().double(),
                                            torch.zeros(got.shape, dtype=torch.float64, device=dev))
            if base is not None:
                s_row += base.abs().double()
            bound = (2 * torch.diff(ptr).double()[:, None] + 8) * u * s_row
            rel = float((diff / bound.clamp_min(1e-300)).max())
            ok = rel <= 1.0
        else:
            rel = err / max(float(want.to(wide).abs().max()), 1e-300)
            ok = rel <= tol
        if not ok or not torch.equal(got, again):
            raise AssertionError(f"csr_spmm {label}: {rel} from its plain version (bound {tol}), "
                                 f"repeat bitwise {torch.equal(got, again)}")
        return {"case": label, "rel_err": rel, "max_abs_err": err, "bitwise_repeat": True}

    n, k = A.shape[0], x.shape[1]
    ptr, col, w = A.lindptr, A._other[: A._n], A._val[: A._n]
    checks = [compare(ptr, col, w, x, f"{n} rows, {A._n} entries, width {k}"),
              compare(ptr, col, w, x[:, :1].contiguous(), f"{n} rows, width 1")]
    # the CSR of A^T (A.T @ X's operand) and the dense-route SpGEMM's E times dense E
    perm = A._by_other()
    other_sorted = A._other[: A._n][perm]
    ptr_t = torch.searchsorted(other_sorted, torch.arange(x.shape[0] + 1, dtype=other_sorted.dtype, device=dev))
    col_t, w_t = A._comp[: A._n][perm].contiguous(), w[perm].contiguous()
    del other_sorted
    checks.append(compare(ptr_t, col_t, w_t, x, f"CSR of A^T, {x.shape[0]} rows, width {k}"))
    del ptr_t, col_t, w_t
    g_e = torch.Generator(device=dev).manual_seed(SEED + 20)
    coo_e = random_graph(SPGEMM_DENSE_N, 0, dev, g_e, density=SPGEMM_DENSE_DENSITY)
    E = ht.sparse.sparse_csr_matrix(coo_e, split=0)
    checks.append(compare(E.lindptr, E._other[: E._n], E._val[: E._n], coo_e.to_dense(),
                          f"dense route, {SPGEMM_DENSE_N} rows, {E._n} entries, width {SPGEMM_DENSE_N}"))
    del E, coo_e
    torch.cuda.empty_cache()
    # ragged: rows of 0 to 200 entries, some past a warp
    lengths = torch.randint(0, 200, (3001,), device=dev, generator=g)
    lengths[::7] = 0
    rp = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(lengths, 0)])
    nnz = int(rp[-1])
    rc = torch.randint(0, 517, (nnz,), device=dev, generator=g, dtype=torch.int32)
    for width, dt in ((1, torch.float32), (3, torch.float32), (33, torch.float32), (65, torch.float64),
                      (32, torch.float64), (1, torch.int64), (32, torch.int32)):
        if dt.is_floating_point:
            rw = torch.randn(nnz, device=dev, generator=g, dtype=dt)
            rx = torch.randn(517, width, device=dev, generator=g, dtype=dt)
        else:  # integer sums are exact
            rw = torch.randint(-9, 10, (nnz,), device=dev, generator=g, dtype=dt)
            rx = torch.randint(-9, 10, (517, width), device=dev, generator=g, dtype=dt)
        tol = {torch.float32: 1e-6, torch.float64: 1e-14}.get(dt, 0.0)
        checks.append(compare(rp, rc, rw, rx, f"ragged rows, width {width}, {dt}", tol=tol))
    for width, dt in ((32, torch.float16), (1, torch.float16), (33, torch.bfloat16), (32, torch.complex64),
                      (1, torch.complex128), (32, torch.int8), (1, torch.uint8), (33, torch.int16),
                      (32, torch.bool), (1, torch.bool)):
        if dt.is_floating_point or dt.is_complex:
            rw = torch.randn(nnz, device=dev, generator=g, dtype=dt)
            rx = torch.randn(517, width, device=dev, generator=g, dtype=dt)
            base = torch.randn(3001, width, device=dev, generator=g, dtype=dt)
            tol = "rows"
        else:  # wrapped integer sums, bool's OR of ANDs: exact
            hi = 2 if dt == torch.bool else 200
            rw = torch.randint(0, hi, (nnz,), device=dev, generator=g).to(dt)
            rx = torch.randint(0, hi, (517, width), device=dev, generator=g).to(dt)
            base = torch.randint(0, hi, (3001, width), device=dev, generator=g).to(dt)
            tol = 0.0
        checks.append(compare(rp, rc, rw, rx, f"ragged rows, width {width}, {dt}", tol=tol))
        checks.append(compare(rp, rc, rw, rx, f"ragged rows, width {width}, {dt}, accumulating", out=base, tol=tol))
    wide = torch.randn(517, 48, device=dev, generator=g)
    rw = torch.randn(nnz, device=dev, generator=g)
    checks.append(compare(rp, rc, rw, wide[:, :40], "x with row stride 48, width 40"))
    checks.append(compare(rp, rc, rw, wide[:, :40], "accumulating into out",
                          out=torch.randn(3001, 40, device=dev, generator=g)))
    for c in checks:
        emit({"phase": "kernel_check", "kernel": "csr_spmm", **c})
    refused = []
    for what, call in (("float16 values for float32 x", lambda: _planes.csr_spmm(rp, rc, rw.half(), wide)),
                       ("x of column stride 2", lambda: _planes.csr_spmm(rp, rc, rw, wide[:, ::2])),
                       ("int64 columns", lambda: _planes.csr_spmm(rp, rc.long(), rw, wide))):
        try:
            call()
        except (TypeError, ValueError):
            refused.append(what)
        else:
            raise AssertionError(f"csr_spmm took {what}")

    ms = time_ms(lambda: _planes.csr_spmm(ptr, col, w, x), reps=10)
    ms1 = time_ms(lambda: _planes.csr_spmm(ptr, col, w, x[:, :1].contiguous()), reps=10)
    plain_ms = time_ms(lambda: _planes._csr_spmm_plain(ptr, col, w, x, torch.zeros(n, k, device=dev)), reps=2,
                       warmup=1)
    csr = torch.sparse_csr_tensor(ptr.to(torch.int32), col, w, size=(n, x.shape[0]))
    library_ms = time_ms(lambda: torch.sparse.mm(csr, x), reps=10)
    # is cuSPARSE's SpMM bitwise repeatable, on A (16 entries a row) and on
    # the CSR of A^T (the CSC route's: rows of Poisson(16) lengths)?
    distinct = {"A": len({str(digest(torch.sparse.mm(csr, x))) for _ in range(8)})}
    other_sorted = A._other[: A._n][perm]
    csr_t = torch.sparse_csr_tensor(torch.searchsorted(other_sorted, torch.arange(
        x.shape[0] + 1, dtype=other_sorted.dtype, device=dev)).to(torch.int32), A._comp[: A._n][perm], w[perm],
        size=(x.shape[0], n))
    distinct["A^T"] = len({str(digest(torch.sparse.mm(csr_t, x))) for _ in range(8)})
    del csr, csr_t, other_sorted
    nbytes = 8 * (n + 1) + 8 * A._n + 4 * x.numel() + 4 * n * k
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "kernel_check", "kernel": "csr_spmm", "rows": n, "entries": A._n, "width": k, "ms": ms,
          "ms_width_1": ms1, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
          "share_of_bound": bound_ms / ms, "gather_bound_ms": 4 * k * A._n / HBM_BYTES_PER_S * 1e3,
          "library_ms": library_ms, "library_call": "torch.sparse.mm (cuSPARSE), float32",
          "library_distinct_results_in_8_runs": distinct, "refused": refused, "card": smi})
    return {"name": "csr_spmm", "route": "cuda", "source": "heat_tpu_torch/csrc/csr_spmm.cu",
            "replaces": "heat_tpu/sparse/_planes.py:493",
            "note": "not a TPU kernel: the JAX package's SpMM is XLA's gather and segment_sum",
            "launches": None, "max_abs_err": max(c["max_abs_err"] for c in checks[:2]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}


def sparse_phase(dev, smi: str) -> dict:
    """Phase sparse: the sparse layer at a graph of 2^24 nodes of degree 16
    (A and B, 2^28 nnz each, built by sparse_csr_matrix from torch sparse
    COO tensors on the card, split 0) and X of 2^24 x 32 float32 split 0:
    construction, A @ X and A @ x, A + B, A * B, A * 2.0, A + 1.0, the
    three sums, A.T @ X (the CSC route), X.T @ A, to_sparse_csc(A), todense
    of a 2^15 x 2^15 matrix, the ring SpGEMM of a 2^20 x 2^20 matrix with
    itself and the dense-route SpGEMM of a 4096 x 4096 matrix of density
    0.05.  Each call's first and warm wall time, the memory it took beyond
    what was allocated before it and its byte bound (planes, X and the
    result each read or written once at the HBM rate; the SpMMs also with
    the rows of X their entries gather); both runs bitwise equal.  Patterns
    are held bitwise against scipy's at 2^18 x 2^18
    (sparse_pattern_check); at full size, 4096 sampled rows (and columns)
    of each result against the host: the element-wise ops bitwise scipy's,
    the products and sums within 1e-5 of float64, the conversion's round
    trip bitwise.  No kernel of the port runs here (the JAX package's
    sparse layer reaches no Pallas kernel)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.sparse import _planes

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    peaks: list = []
    restart_peak(peaks)
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    sparse_pattern_check(dev, g, smi)
    torch.cuda.empty_cache()
    restart_peak(peaks)
    records = []

    def record(r, **checks):
        r.update(checks)
        records.append(r)
        emit(r)

    n, k, ns = SPARSE_ROWS, SPARSE_X_COLS, SPARSE_SAMPLE
    coo_a = random_graph(n, SPARSE_DEGREE, dev, g)
    coo_b = random_graph(n, SPARSE_DEGREE, dev, g)
    drawn = coo_a._nnz()
    A, rec = sparse_twice(lambda: ht.sparse.sparse_csr_matrix(coo_a, split=0), "construct",
                          lambda out: 20 * drawn + 12 * out.gnnz, smi, peaks, drawn=drawn)
    B = ht.sparse.sparse_csr_matrix(coo_b, split=0)
    nnz, nnz_b = A.gnnz, B.gnnz
    # 4096 sampled rows and columns; the draws' entries in them come to the host
    rows = torch.sort(torch.randperm(n, device=dev, generator=g)[:ns]).values
    cols = torch.sort(torch.randperm(n, device=dev, generator=g)[:ns]).values
    host_a, host_b = host_csr(coo_a, rows), host_csr(coo_b, rows)
    host_at = host_csr(torch.sparse_coo_tensor(coo_a._indices().flip(0), coo_a._values(), (n, n)), cols)
    del coo_a, coo_b
    torch.cuda.empty_cache()
    same_rows(sampled_rows(A, rows), scipy_rows(host_a, np.arange(ns)), "construct")
    record(rec, nnz=nnz, sampled_rows_bitwise_scipy=True)

    x = torch.rand(n, k, device=dev, generator=g)
    X = ht.array(x, split=0)
    csr_entry = csr_spmm_check(A, x, dev, g, smi)
    torch.cuda.empty_cache()
    restart_peak(peaks)
    _planes.CSR_SPMM_LAUNCHES = 0  # the path's launches from here on
    spmm_bytes = 12 * nnz + 8 * n * k  # the planes and X read, the result written
    gather = {"gather_bound_ms": 4 * k * nnz / HBM_BYTES_PER_S * 1e3}  # one row of X for each entry
    host_rows = sp.csr_matrix(host_a, dtype=np.float64)
    host_cols = sp.csr_matrix(host_at, dtype=np.float64)
    x_rows = x[torch.from_numpy(host_rows.indices.astype(np.int64)).to(dev)].cpu().double().numpy()
    x_cols = x[torch.from_numpy(host_cols.indices.astype(np.int64)).to(dev)].cpu().double().numpy()

    def row_products(h, xr):
        """Each sampled row's products with X in float64 (xr: X's rows of
        the row's entries, in entry order)."""
        out = np.zeros((h.shape[0], xr.shape[1]))
        np.add.at(out, np.repeat(np.arange(h.shape[0]), np.diff(h.indptr)), h.data[:, None] * xr)
        return out

    want_rows, want_cols = row_products(host_rows, x_rows), row_products(host_cols, x_cols)

    def rel(got, want):
        return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))

    # A @ X through the entry point, beside cuSPARSE's SpMM on the same CSR (a library reading only)
    Y, rec = sparse_twice(lambda: A @ X, "A @ X", spmm_bytes, smi, peaks, **gather)
    csr = A.larray
    library_ms = time_ms(lambda: torch.sparse.mm(csr, x), reps=3, warmup=1)
    del csr
    err = rel(Y.larray[rows].cpu().double().numpy(), want_rows)
    if err > 1e-5 or Y.split != 0:
        raise AssertionError(f"sparse A @ X: sampled rows {err} from float64 (bound 1e-5), split {Y.split}")
    record(rec, max_rel_err=err, library_ms=library_ms, library_call="torch.sparse.mm (cuSPARSE)")
    del Y
    torch.cuda.empty_cache()

    v = ht.array(x[:, 0].contiguous(), split=0)
    y, rec = sparse_twice(lambda: A @ v, "A @ x", 12 * nnz + 8 * n, smi, peaks,
                          gather_bound_ms=4 * nnz / HBM_BYTES_PER_S * 1e3)
    err = rel(y.larray[rows].cpu().double().numpy(), want_rows[:, 0])
    if err > 1e-5 or y.shape != (n,):
        raise AssertionError(f"sparse A @ x: sampled rows {err} from float64, shape {y.shape}")
    record(rec, max_rel_err=err)
    del y, v

    # element-wise and scalar ops: the sampled rows bitwise scipy's
    plus = host_a.copy()
    plus.data = plus.data + np.float32(1.0)
    for name, fn, host, nbytes in (
            ("A + B", lambda: A + B, host_a + host_b, lambda out: 12 * (nnz + nnz_b + out.gnnz)),
            ("A * B", lambda: A * B, host_a.multiply(host_b), lambda out: 12 * (nnz + nnz_b + out.gnnz)),
            ("A * 2.0", lambda: A * 2.0, host_a * np.float32(2.0), 8 * nnz),  # the values read and written
            ("A + 1.0", lambda: A + 1.0, plus, 12 * nnz)):  # the row plane read too
        host = sp.csr_matrix(host)
        host.sort_indices()
        out, rec = sparse_twice(fn, name, nbytes, smi, peaks)
        same_rows(sampled_rows(out, rows), scipy_rows(host, np.arange(ns)), name)
        record(rec, nnz_out=out.gnnz, sampled_rows_bitwise_scipy=True)
        del out
        torch.cuda.empty_cache()
    del B

    # the sums: the sampled rows' and columns' against float64
    total64 = float(A._val[: A._n].double().sum())
    for axis, nbytes in ((None, 4 * nnz), (1, 8 * nnz + 4 * n), (0, 8 * nnz + 4 * n)):
        s, rec = sparse_twice(lambda: A.sum(axis=axis), f"A.sum(axis={axis})", nbytes, smi, peaks)
        if axis is None:
            err = abs(float(s.larray) - total64) / total64
        elif axis == 1:
            err = rel(s.larray[rows].cpu().double().numpy(), np.asarray(host_rows.sum(axis=1)).ravel())
        else:
            err = rel(s.larray[cols].cpu().double().numpy(), np.asarray(host_cols.sum(axis=1)).ravel())
        if err > 1e-5:
            raise AssertionError(f"sparse A.sum(axis={axis}): {err} from float64")
        record(rec, max_rel_err=err)
        del s

    # A.T @ X (the CSC route: no gather of X, one reduce-scatter) and X.T @ A
    At = A.T
    if not (At._comp is A._comp and At._other is A._other and At._val is A._val and At.T.shape == A.shape):
        raise AssertionError("sparse A.T moved data")
    Z, rec = sparse_twice(lambda: At @ X, "A.T @ X", spmm_bytes, smi, peaks, **gather)
    err = rel(Z.larray[cols].cpu().double().numpy(), want_cols)
    if err > 1e-5:
        raise AssertionError(f"sparse A.T @ X: sampled rows {err} from float64")
    record(rec, max_rel_err=err)
    del Z
    torch.cuda.empty_cache()
    XT = X.T
    W, rec = sparse_twice(lambda: XT @ A, "X.T @ A", spmm_bytes, smi, peaks, **gather)
    err = rel(W.larray[:, cols].cpu().double().numpy().T, want_cols)
    if err > 1e-5 or W.shape != (k, n):
        raise AssertionError(f"sparse X.T @ A: sampled columns {err} from float64, shape {W.shape}")
    record(rec, max_rel_err=err)
    del W, XT, X, x
    torch.cuda.empty_cache()

    # the triplet-keeping conversion, and back: A's planes bitwise
    C, rec = sparse_twice(lambda: ht.sparse.to_sparse_csc(A), "to_sparse_csc(A)", 24 * nnz, smi, peaks)
    if fingerprint(ht.sparse.to_sparse_csr(C)) != fingerprint(A):
        raise AssertionError("sparse to_sparse_csr(to_sparse_csc(A)) is not A bitwise")
    record(rec, round_trip_bitwise=True)
    del C, A, At
    torch.cuda.empty_cache()

    # todense of 2^15 x 2^15: the sampled rows bitwise the host's
    nd = SPARSE_DENSE_N
    coo_d = random_graph(nd, SPARSE_DEGREE, dev, g)
    D = ht.sparse.sparse_csr_matrix(coo_d, split=0)
    dense_rows = torch.sort(torch.randperm(nd, device=dev, generator=g)[:ns]).values
    host_d = host_csr(coo_d, dense_rows).toarray()
    dd, rec = sparse_twice(lambda: D.todense(), "todense 2^15", 12 * D.gnnz + 4 * nd * nd, smi, peaks)
    if dd.larray[dense_rows].cpu().numpy().tobytes() != host_d.tobytes():
        raise AssertionError("sparse todense: sampled rows differ from the host's")
    record(rec, sampled_rows_bitwise=True)
    del dd, D, coo_d
    torch.cuda.empty_cache()

    # the ring SpGEMM S @ S, 2^20 x 2^20 of 16 a row: sampled rows against float64
    m = SPGEMM_ROWS
    coo_s = random_graph(m, SPARSE_DEGREE, dev, g)
    S = ht.sparse.sparse_csr_matrix(coo_s, split=0)
    host_s = host_csr(coo_s).astype(np.float64)
    del coo_s
    P, rec = sparse_twice(lambda: S @ S, "S @ S (ring)", lambda out: 24 * S.gnnz + 12 * out.gnnz, smi, peaks)
    srows = torch.sort(torch.randperm(m, device=dev, generator=g)[:ns]).values
    want_p = sp.csr_matrix(host_s[srows.cpu().numpy()] @ host_s)
    want_p.sort_indices()
    same_rows(sampled_rows(P, srows), scipy_rows(want_p, np.arange(ns)), "S @ S", exact=False, rtol=1e-5)
    record(rec, nnz_in=S.gnnz, nnz_out=P.gnnz)
    del P, S, host_s
    torch.cuda.empty_cache()

    # the dense route: 4096 x 4096 at density 0.05, every row against float64
    ne = SPGEMM_DENSE_N
    coo_e = random_graph(ne, 0, dev, g, density=SPGEMM_DENSE_DENSITY)
    E = ht.sparse.sparse_csr_matrix(coo_e, split=0)
    host_e = host_csr(coo_e).astype(np.float64)
    PE, rec = sparse_twice(lambda: E @ E, "E @ E (dense route)", lambda out: 24 * E.gnnz + 12 * out.gnnz, smi, peaks)
    want_e = sp.csr_matrix(host_e @ host_e)
    want_e.sort_indices()
    same_rows(sampled_rows(PE, torch.arange(ne, device=dev)), scipy_rows(want_e, np.arange(ne)), "E @ E",
              exact=False, rtol=1e-5)
    record(rec, nnz_in=E.gnnz, nnz_out=PE.gnnz)
    del PE, E, coo_e
    torch.cuda.empty_cache()

    launches = _planes.CSR_SPMM_LAUNCHES
    restart_peak(peaks)
    if max(peaks) > SPARSE_PEAK_BYTES:
        raise AssertionError(f"sparse: the phase peaked at {max(peaks) / 1e9} GB (bound {SPARSE_PEAK_BYTES / 1e9})")
    if launches == 0:
        raise AssertionError("sparse: the path never launched the CSR SpMM kernel")
    emit({"phase": "sparse", "calls": len(records), "nnz": nnz, "csr_spmm_launches": launches,
          "phase_peak_gb": max(peaks) / 1e9, "phase_seconds": time.perf_counter() - t_phase, "card": smi})
    csr_entry["launches"] = launches
    return csr_entry


def tensor_core_report(build) -> dict:
    """ptxas's report (registers, spills) of the six tensor-core kernels,
    and their count of tensor-core instructions in the built SASS -- HMMA
    (mma.sync: lloyd's tc route, fft_axis) and HGMMA (wgmma: syrk,
    fft_stage, flash_attn, flash_attn_bwd's tc route) --
    which shows that the tensor cores are used (null where the toolkit has
    no cuobjdump; a kernel without any fails the run)."""
    import os
    import shutil

    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                          "cuobjdump")
    report = {"ptxas_tensor_core_kernels": {}, "tensor_core_sass_instructions": {}}
    for name in ("lloyd", "syrk", "fft_stage", "fft_axis", "flash_attn", "flash_attn_bwd"):
        log = build.BUILD_LOGS.get(name, "")
        report["ptxas_tensor_core_kernels"][name] = [ln.strip() for ln in log.splitlines()
                                                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        counts = None
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", str(build._target(name))], capture_output=True, text=True)
            if sass.returncode == 0:
                ops = [ln.split(";")[0].split() for ln in sass.stdout.splitlines() if "MMA" in ln]
                words = [w for op in ops for w in op]
                counts = {"HMMA": sum(w.startswith("HMMA.") for w in words),
                          "HGMMA": sum(w.startswith("HGMMA.") for w in words)}
                if counts["HMMA"] + counts["HGMMA"] == 0:
                    raise AssertionError(f"{name} has no tensor-core instruction in its SASS")
        report["tensor_core_sass_instructions"][name] = counts
    return report


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
    emit({"phase": "build", **tensor_core_report(_build)})

    # the seeded generator on the card draws the host's bits (the host's are
    # the JAX package's, tests/test_torch_random.py)
    for n in (1003, 1 << 20):
        ht.random.seed(n)
        on_card = ht.random.rand(n, device="gpu").larray_padded.cpu()
        ht.random.seed(n)
        if not torch.equal(on_card.view(torch.int32), ht.random.rand(n, device="cpu").larray_padded.view(torch.int32)):
            raise AssertionError(f"rand({n}) on the card differs from the host's")
    emit({"phase": "rng", "rand_card_equals_host_bitwise": True})

    # 3a.-4a. K1's float64 route against its plain version, then the float64
    # KMeans path through the entry points (its data freed before the
    # float32 path's is made)
    lloyd64 = lloyd64_path(dev, smi)

    # data of the main path: Gaussian blobs, well apart, made on the card
    g = torch.Generator(device=dev).manual_seed(SEED)
    truth = torch.randn(CLUSTERS, FEATURES, device=dev, generator=g) * 10.0
    member = torch.randint(0, CLUSTERS, (ROWS,), device=dev, generator=g)
    x = torch.randn(ROWS, FEATURES, device=dev, generator=g)
    x += truth[member]
    del member

    # 3. kernels against their plain versions: K1 by both routes at the main
    # path's shape (tc is its route), then ragged shapes by the route the
    # wrapper picks (tc: f a multiple of 4 within 8 output tiles; walk: the
    # rest, and points not 16-byte aligned)
    threefry = threefry_check(dev, smi)
    checks = [compare_lloyd(x, truth, ROWS), compare_lloyd(x, truth, ROWS - 77, "walk")]
    for rows, f, k, n_true in ((1003, 17, 30, 1003), (1003, 16, 8, 901), (1003, 16, 30, 1000), (4096, 128, 8, 4000),
                               (777, 4, 3, 777), (1000, 32, 24, 999), (1003, 20, 12, 1003), (300, 64, 40, 299),
                               (33, 8, 64, 31), (5, 16, 8, 5)):
        xs = torch.randn(rows, f, device=dev, generator=g)
        cs = torch.randn(k, f, device=dev, generator=g)
        checks.append(compare_lloyd(xs, cs, n_true))
        if kernels.lloyd_route(f, k) == "tc":
            checks.append(compare_lloyd(xs, cs, n_true, "walk"))
    flat = torch.randn(1003 * 16 + 1, device=dev, generator=g)
    checks.append(compare_lloyd(flat[1:].view(1003, 16), truth, 1003))  # 4-byte aligned: the walk route
    if {c["route"] for c in checks} != {"tc", "walk"}:
        raise AssertionError("the K1 checks did not cover both routes")
    for c in checks:
        emit({"phase": "kernel_check", "kernel": "lloyd_step", **c})
    refused = []
    for what, call in (("tc, f = 17", lambda: kernels._lloyd_cuda(torch.zeros(64, 17, device=dev),
                                                                  torch.zeros(4, 17, device=dev), 64, False, "tc")),
                       ("tc, 4-byte aligned", lambda: kernels._lloyd_cuda(flat[1:].view(1003, 16), truth, 1003, False,
                                                                          "tc")),
                       ("tc, 16 features x 72 centres", lambda: kernels._lloyd_cuda(
                           torch.zeros(64, 16, device=dev), torch.zeros(72, 16, device=dev), 64, False, "tc"))):
        try:
            call()
        except ValueError:
            refused.append(what)
        else:
            raise AssertionError(f"K1's tc route took {what}")
    emit({"phase": "kernel_check", "kernel": "lloyd_step", "refused": refused})
    max_abs_err = max(c["max_abs_err"] for c in checks)
    del flat
    for route in ("tc", "walk"):
        lloyd_phases(x, truth, ROWS, route, smi)

    # 4. the main path, through the entry points a user calls
    ht.use_device("gpu")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = ht.array(x, split=0)
    km = ht.cluster.KMeans(n_clusters=CLUSTERS, init="random", random_state=SEED, max_iter=MAX_ITER).fit(pts)
    n_iter, inertia = km.n_iter_, km.inertia_
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.LLOYD_LAUNCHES
    from heat_tpu_torch.core import random as rnd

    threefry["launches"] = rnd.THREEFRY_LAUNCHES
    if threefry["launches"] != 1:
        raise AssertionError(f"the fit's random init launched the threefry kernel {threefry['launches']} times; once")
    if kernels.GRAM_LAUNCHES:
        raise AssertionError(f"the KMeans fit launched the Gram kernel {kernels.GRAM_LAUNCHES} times")
    if launches < n_iter + 1:
        raise AssertionError(f"the fit launched the Lloyd kernel {launches} times for {n_iter} iterations")
    centres = km.cluster_centers_.larray
    labels = km.labels_.larray
    if centres.shape != (CLUSTERS, FEATURES) or labels.shape != (ROWS,) or not bool(torch.isfinite(centres).all()):
        raise AssertionError("the fit's centres or labels have the wrong shape or are not finite")
    _, _, plain_inertia, plain_labels = kernels._lloyd_plain(x, centres, ROWS, True)
    relabelled = near_tie_mismatches(x, centres, labels, plain_labels)
    if not torch.equal(labels, kernels._lloyd_cuda(x, centres, ROWS, True, "walk")[3]):
        raise AssertionError("the fit's labels (tc route) differ from the walk route's on the same centres")
    if abs(inertia - float(plain_inertia)) > 1e-4 * abs(float(plain_inertia)):
        raise AssertionError(f"inertia {inertia} against {float(plain_inertia)} from the plain version")
    emit({"phase": "main_path", "rows": ROWS, "features": FEATURES, "clusters": CLUSTERS, "n_iter": n_iter,
          "inertia": inertia, "fit_wall_s": fit_s, "lloyd_launches": launches, "lloyd_route": kernels.lloyd_route(FEATURES, CLUSTERS, x.data_ptr() % 16 == 0),
          "threefry_launches": threefry["launches"],
          "labels_vs_plain_near_ties": relabelled, "labels_equal_walk_route": True})

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
    walk_ms = time_ms(lambda: kernels._lloyd_cuda(x, centres, ROWS, False, "walk"), reps=20)
    plain_ms = time_ms(lambda: kernels._lloyd_plain(x, centres, ROWS, False), reps=3, warmup=1)
    n, f, k = ROWS, FEATURES, CLUSTERS
    nbytes = 4 * n * f + 4 * k * f + 8 * (k * f + k + 1)  # x and c read once, the sums written once
    ops = n * (2 * k * f + 2 * f + 3 * k + f)  # dots, |x|^2, half-distance and argmin, the sums
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / F32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    emit({"phase": "times", "kernel": "lloyd_step", "route": "tc", "ms": kernel_ms, "walk_route_ms": walk_ms,
          "plain_ms": plain_ms,
          "bound_ms": bound[bound_by], "bound_by": bound_by, "share_of_bound": bound[bound_by] / kernel_ms,
          "library_ms": None, "library_note": "no single PyTorch call computes the fused Lloyd step",
          "card": smi})

    # 6a. the rest of the seeded draws on the card, against the host's
    rng_draws(dev, smi)

    # 6b. the kmeans++ path: the card's picks against the host's, then the
    # fit at full width through the entry point
    kpp_launches = kmeanspp_path(x, pts, kmeanspp_pick_check(dev, g, smi), smi)
    threefry["launches"] += kpp_launches["threefry"]

    lloyd = {"name": "lloyd_step", "route": "cuda", "source": "heat_tpu_torch/csrc/lloyd.cu",
             "replaces": "heat_tpu/core/kernels.py:121", "launches": launches + kpp_launches["lloyd_step"],
             "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound[bound_by],
             "bound_by": bound_by, "library_ms": None}
    if "--kmeans-only" in sys.argv[1:]:
        emit({"partial_run": "--kmeans-only: the phases after the KMeans path were not run"})
        return 0

    # 6c. the array runtime's calls on the same points
    array_runtime(x, smi)

    # 6d. the NumPy surface on the same points: standardize, then cluster
    # (K1 launched on the ops' output), then the ops' calls
    lloyd["launches"] += ops_phase(x, smi)

    # 6e.-6f. the sort, its statistics, the row moves and the scalers on the
    # same points; then io of their first rows
    manipulations_phase(x, km.labels_, smi)
    io_phase(x, smi)

    # 6g.-6h. the rest of the ML layer on the same points and their true
    # labels (drawn again from the seeded generator), then napi and convolve
    g_truth = torch.Generator(device=dev).manual_seed(SEED)
    torch.randn(CLUSTERS, FEATURES, device=dev, generator=g_truth)
    member = torch.randint(0, CLUSTERS, (ROWS,), device=dev, generator=g_truth)
    ml_launches = ml_rest_phase(x, member, smi)
    lloyd["launches"] += ml_launches["lloyd_step"]
    threefry["launches"] += ml_launches["threefry"]
    del member
    torch.cuda.empty_cache()
    napi_signal_phase(x, smi)

    # 6i.-6j. the repaired faults F17-F23 at 2^27 values, then the fault,
    # retry, span and guard layer on the same points (K1 and threefry in its
    # fit, its ring SpGEMM's csr_spmm launches joined to phase sparse's)
    faults_f17_f23_phase(smi)
    res_launches = resilience_phase(x, smi)
    lloyd["launches"] += res_launches["lloyd_step"]
    threefry["launches"] += res_launches["threefry"]

    # the KMeans data is freed before the hSVD path's matrix is made
    del x, pts, km, centres, labels, plain_labels, truth, pred
    torch.cuda.empty_cache()
    a = spectrum_matrix(dev)
    m, n = a.shape

    # 7. the Gram kernel against its plain version
    checks = [compare_gram(a, m)]
    for rows, cols, n_true in ((4233, 128, 4100), (3 * 2048 + 11, 64, 3 * 2048 + 11), (5000, 200, 5000),
                               (2049, 512, 2049), (100, 128, 100)):
        xs = torch.randn(rows, cols, device=dev, generator=g)
        xs[n_true:] = 1e6  # padding, poisoned: it must add nothing
        checks.append(compare_gram(xs, n_true))
    # uncentred data of mean 10, as hsvd_rank receives it, where long
    # tensor-core chains would drift
    xs = torch.randn(1 << 22, HSVD_COLS, device=dev, generator=g) + 10.0
    checks.append({**compare_gram(xs, xs.shape[0]), "mean": 10.0})
    del xs
    refused = []
    for bad, what in ((torch.zeros(64, 16, dtype=torch.float64, device=dev), "float64"),
                      (torch.zeros(64, 513, device=dev), "n=513"),
                      (torch.zeros(16, 64, device=dev).T, "non-contiguous")):
        try:
            kernels.gram_partials(bad, 64)
        except (TypeError, ValueError):
            refused.append(what)
        else:
            raise AssertionError(f"the Gram kernel took a {what} input")
    for c in checks:
        emit({"phase": "gram_check", "kernel": "gram_syrk", **c})
    emit({"phase": "gram_check", "kernel": "gram_syrk", "refused": refused})
    gram_abs_err = max(c["max_abs_err"] for c in checks)
    lam = plain_spectrum(a)

    # 8. the hSVD path, through the entry points a user calls
    kernels.LLOYD_LAUNCHES = kernels.GRAM_LAUNCHES = 0
    A = ht.array(a, split=0)
    (U, S, V, err), rank_ms = wall_ms(
        lambda: ht.linalg.hsvd_rank(A, HSVD_RANK, compute_sv=True, safetyshift=5))
    gram_launches = kernels.GRAM_LAUNCHES
    if gram_launches != 1 or kernels.LLOYD_LAUNCHES:
        raise AssertionError(f"hsvd_rank launched the Gram kernel {gram_launches} times (and Lloyd's "
                             f"{kernels.LLOYD_LAUNCHES}); it should once")
    rank_check = check_factors(U, S, err, lam, HSVD_RANK)
    if V.shape != (n, HSVD_RANK) or U.shape != (m, HSVD_RANK) or U.split != 0:
        raise AssertionError(f"U {U.shape} split {U.split}, V {V.shape}")
    del U, V
    rtol = 1e-2
    (U, S, V, err), rtol_ms = wall_ms(lambda: ht.linalg.hsvd_rtol(A, rtol, compute_sv=True))
    sq = lam.sum() - torch.cumsum(lam, 0)
    plain_k = int(torch.nonzero(sq <= rtol**2 * lam.sum())[0, 0]) + 1
    if S.shape[0] != plain_k:
        raise AssertionError(f"hsvd_rtol chose rank {S.shape[0]}, the plain spectrum {plain_k}")
    rtol_check = check_factors(U, S, err, lam, plain_k)
    del U, V
    emit({"phase": "hsvd", "rows": m, "cols": n, "gram_launches": gram_launches,
          "hsvd_rank": {"wall_ms": rank_ms, **rank_check},
          "hsvd_rtol": {"rtol": rtol, "wall_ms": rtol_ms, **rtol_check}})

    # 9. PCA through the hierarchical solver
    kernels.LLOYD_LAUNCHES = kernels.GRAM_LAUNCHES = 0
    pca, fit_ms = wall_ms(lambda: ht.decomposition.PCA(n_components=HSVD_RANK, svd_solver="hierarchical").fit(A))
    pca_launches = kernels.GRAM_LAUNCHES
    if pca_launches != 1 or kernels.LLOYD_LAUNCHES:
        raise AssertionError(f"PCA.fit launched the Gram kernel {pca_launches} times; it should once")
    comps = pca.components_.larray.double()
    orth = float((comps @ comps.T - torch.eye(HSVD_RANK, dtype=torch.float64, device=dev)).abs().max())
    ratio_sum = float(pca.explained_variance_ratio_.larray.double().sum())
    tevr = pca.total_explained_variance_ratio_
    if comps.shape != (HSVD_RANK, n) or orth > 1e-4 or abs(ratio_sum - tevr) > 1e-4:
        raise AssertionError(f"components {tuple(comps.shape)}, orthonormality {orth}, "
                             f"ratio sum {ratio_sum} against tevr {tevr}")
    mean = pca.mean_.larray.double()
    transforms = []
    for size in (1, 64, 4096):
        rows = a[torch.randint(0, m, (size,), generator=rng).to(dev)]
        out, ms = wall_ms(lambda: pca.transform(ht.array(rows, split=0)).larray)
        want = (rows.double() - mean) @ comps.T
        dev_ = float(((out.double() - want).abs() / (1.0 + want.abs())).max())
        if out.shape != (size, HSVD_RANK) or dev_ > 1e-4:
            raise AssertionError(f"transform of {size} rows: shape {tuple(out.shape)}, error {dev_}")
        transforms.append({"rows": size, "wall_ms": ms, "max_err": dev_})
    emit({"phase": "pca", "fit_wall_ms": fit_ms, "gram_launches": pca_launches, "components_orthonormality_err": orth,
          "explained_variance_ratio_sum": ratio_sum, "total_explained_variance_ratio": tevr,
          "transforms": transforms})
    del pca

    # 9a. rsvd through the entry point
    from heat_tpu_torch.core import random as rnd

    want_s = lam[:HSVD_RANK].sqrt()
    ell = min(HSVD_RANK + 10, m, n)  # rsvd's default n_oversamples
    rsvd_calls = []
    for p_iter in (0, 1):
        zero_launches()
        ht.random.seed(SEED + 3)
        (Ur, Sr, Vr), ms = wall_ms(lambda: ht.linalg.rsvd(A, HSVD_RANK, power_iter=p_iter))
        launches = rnd.THREEFRY_LAUNCHES
        if launches != 1 or other_launches() != launches:
            raise AssertionError(f"rsvd launched the threefry kernel {launches} times and {other_launches()} kernels "
                                 "in all; the threefry kernel once, nothing else")
        _, warm_ms = wall_ms(lambda: ht.linalg.rsvd(A, HSVD_RANK, power_iter=p_iter)[1].shape)
        s = Sr.larray.double()
        u = Ur.larray.double()
        s_err = float(((s - want_s).abs() / want_s).max())
        orth = float((u.T @ u - torch.eye(HSVD_RANK, dtype=torch.float64, device=dev)).abs().max())
        if (Ur.shape != (m, HSVD_RANK) or Ur.split != 0 or Sr.shape != (HSVD_RANK,) or Vr.shape != (n, HSVD_RANK)
                or not bool(torch.isfinite(u).all() and torch.isfinite(s).all())):
            raise AssertionError(f"rsvd: U {Ur.shape} split {Ur.split}, S {Sr.shape}, V {Vr.shape}, or not finite")
        # two float32 Gram passes over a sample this ill-conditioned leave U
        # orthonormal to about 2e-5 at this size (1.96e-5 and 1.90e-5 on an
        # H100, the same in repeated runs of this seed): held to 5e-5
        if s_err > 1e-4 or orth > 5e-5:
            raise AssertionError(f"rsvd power_iter={p_iter}: S {s_err} from the plain spectrum (rtol 1e-4), "
                                 f"U^T U {orth} from I (5e-5)")
        reads = 2 * (1 + p_iter)  # A Omega, A^T Q and A Q per power iteration, Q^T A
        nbytes = reads * 4 * m * n + 4 * m * HSVD_RANK
        ops = reads * 2 * m * n * ell + (1 + 2 * p_iter) * 2 * 4 * m * ell * ell + 2 * m * ell * ell
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / F32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        rsvd_calls.append({"power_iter": p_iter, "wall_ms": ms, "warm_wall_ms": warm_ms, "threefry_launches": launches,
                           "s_max_rel_err": s_err, "u_orthonormality_err": orth, "bound_ms": bound[bound_by],
                           "bound_by": bound_by, "share_of_bound": bound[bound_by] / warm_ms})
        del Ur, Sr, Vr, u, s
    ht.random.seed(SEED + 3)
    split = profile_fit(lambda: ht.linalg.rsvd(A, HSVD_RANK)[1].shape,
                        labels=("rsvd.range", "rsvd.gram", "rsvd.project", "rsvd.small_svd"))
    emit({"phase": "rsvd", "rows": m, "cols": n, "rank": HSVD_RANK, "ell": ell, "calls": rsvd_calls,
          "profile_power_iter_0": split, "card": smi})
    rsvd_threefry = sum(c["threefry_launches"] for c in rsvd_calls)
    torch.cuda.empty_cache()

    # 9b. PCA through the randomized solver, held against the hierarchical fit's subspace
    def randomized_fit():
        return ht.decomposition.PCA(n_components=HSVD_RANK, svd_solver="randomized", random_state=SEED).fit(A)

    zero_launches()
    rpca, rfit_ms = wall_ms(randomized_fit)
    rpca_threefry = rnd.THREEFRY_LAUNCHES
    if rpca_threefry != 1 or other_launches() != rpca_threefry:
        raise AssertionError(f"the randomized PCA launched the threefry kernel {rpca_threefry} times and "
                             f"{other_launches()} kernels in all; the threefry kernel once, nothing else")
    _, rfit_warm_ms = wall_ms(lambda: randomized_fit().n_components_)
    rcomps = rpca.components_.larray.double()
    rorth = float((rcomps @ rcomps.T - torch.eye(HSVD_RANK, dtype=torch.float64, device=dev)).abs().max())
    rratio_sum = float(rpca.explained_variance_ratio_.larray.double().sum())
    rtevr = rpca.total_explained_variance_ratio_
    if rcomps.shape != (HSVD_RANK, n) or rorth > 1e-4 or abs(rratio_sum - rtevr) > 1e-4:
        raise AssertionError(f"randomized components {tuple(rcomps.shape)}, orthonormality {rorth}, "
                             f"ratio sum {rratio_sum} against tevr {rtevr}")
    # largest principal angle between the two fits' subspaces: the randomized
    # range without power iterations is off by about sigma_ell+1 / sigma_k (4
    # times that allowed for the Gaussian draw), the Gram route by the Gram
    # kernel's tolerated error (5e-6 of |G|) over the gap lam_k - lam_k+1
    # (the sine, from orthonormal bases in float64: arccos of the cosines
    # cannot resolve angles below about 1e-3 from float32 components)
    basis_h, basis_r = torch.linalg.qr(comps.T).Q, torch.linalg.qr(rcomps.T).Q
    residual = basis_r - basis_h @ (basis_h.T @ basis_r)
    angle = float(torch.arcsin(torch.clamp(torch.linalg.svdvals(residual).max(), max=1.0)))
    angle_bound = float(4 * torch.sqrt(lam[ell] / lam[HSVD_RANK - 1])
                        + 5e-6 * lam[0] / (lam[HSVD_RANK - 1] - lam[HSVD_RANK]))
    if not angle <= angle_bound:
        raise AssertionError(f"the randomized and hierarchical subspaces are {angle} rad apart (bound {angle_bound})")
    rmean = rpca.mean_.larray.double()
    rtransforms = []
    for size in (1, 64, 4096):
        rows = a[torch.randint(0, m, (size,), generator=rng).to(dev)]
        out, ms = wall_ms(lambda: rpca.transform(ht.array(rows, split=0)).larray)
        want = (rows.double() - rmean) @ rcomps.T
        dev_ = float(((out.double() - want).abs() / (1.0 + want.abs())).max())
        if out.shape != (size, HSVD_RANK) or dev_ > 1e-4:
            raise AssertionError(f"randomized transform of {size} rows: shape {tuple(out.shape)}, error {dev_}")
        rtransforms.append({"rows": size, "wall_ms": ms, "max_err": dev_})
    emit({"phase": "pca_randomized", "fit_wall_ms": rfit_ms, "warm_fit_wall_ms": rfit_warm_ms,
          "threefry_launches": rpca_threefry,
          "components_orthonormality_err": rorth, "explained_variance_ratio_sum": rratio_sum,
          "total_explained_variance_ratio": rtevr, "largest_principal_angle_vs_hierarchical_rad": angle,
          "angle_bound_rad": angle_bound, "transforms": rtransforms, "card": smi})
    del rpca, rcomps, rmean, comps, mean
    torch.cuda.empty_cache()

    # 10. where the hsvd_rank call's time goes (the launches here are not counted)
    emit({"phase": "hsvd_profile", **profile_fit(lambda: ht.linalg.hsvd_rank(A, HSVD_RANK, compute_sv=True)[3])})

    # 11. times, beside the bound: one read of x, or three bf16 products of
    # the upper triangle on the tensor cores, as the TPU kernel counts them
    from heat_tpu_torch.core.linalg.basics import full_f32_matmul

    gram_ms = time_ms(lambda: kernels.gram_partials(a, m), reps=20)
    gram_plain_ms = time_ms(lambda: kernels._gram_plain(a, m), reps=3, warmup=1)
    with full_f32_matmul():
        library_ms = time_ms(lambda: a.T @ a, reps=20)
    nbytes = 4 * m * n + 4 * n * n
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": 3 * m * n * (n + 1) / BF16_FLOPS * 1e3}
    gram_bound_by = max(bound, key=bound.get)
    emit({"phase": "times", "kernel": "gram_syrk", "ms": gram_ms, "plain_ms": gram_plain_ms,
          "bound_ms": bound[gram_bound_by], "bound_by": gram_bound_by,
          "share_of_bound": bound[gram_bound_by] / gram_ms,
          "tf32x3_floor_ms": 3 * m * n * (n + 1) / TF32_FLOPS * 1e3,
          "cuda_core_floor_ms": m * n * (n + 1) / F32_FLOPS * 1e3,
          "library_ms": library_ms, "library_call": "x.T @ x, full float32 (cuBLAS)", "card": smi})

    gram = {"name": "gram_syrk", "route": "cuda", "source": "heat_tpu_torch/csrc/syrk.cu",
            "replaces": "heat_tpu/core/kernels.py:378", "launches": gram_launches, "max_abs_err": gram_abs_err,
            "ms": gram_ms, "plain_ms": gram_plain_ms, "bound_ms": bound[gram_bound_by], "bound_by": gram_bound_by,
            "library_ms": library_ms}

    # the hSVD data is freed before the FFT path's
    del a, A, S, lam, sq
    torch.cuda.empty_cache()

    # 12. the FFT kernels against their plain versions, and their times
    fft_entries = fft_kernels(dev, g, smi)

    # 13.-16. the FFT path through the entry points a user calls
    main_launches = fft_path(dev, g, smi)
    for e in fft_entries:
        e["launches"] = main_launches[e["name"]]

    # the FFT data is freed before the attention path's
    torch.cuda.empty_cache()

    # 17. K7 against its plain version, and its times
    flash = attention_kernel(dev, g, smi)
    torch.cuda.empty_cache()

    # 18.-19. the attention path through the entry point a user calls
    flash["launches"] = attention_path(smi)
    torch.cuda.empty_cache()

    # 20. K7-bwd against its plain versions, and its times
    flash_bwd = flash_bwd_check(dev, g, smi)
    torch.cuda.empty_cache()

    # 21.-22. the training path through the entry points a user calls
    bwd_launches, attn_step_ms = train_attention(dev, smi)
    train_cnn(dev, smi)

    # 22a.-22b. hierarchical training (DASO) through the same kernels, then the data tooling
    daso_launches = train_daso(dev, smi, attn_step_ms)
    flash["launches"] += daso_launches["flash"]
    for e in flash_bwd:
        key = e.pop("launch_key")
        e["launches"] = bwd_launches[key] + daso_launches[key]
        if "cuda_core_route" in e:
            key = f"{e['name'].rsplit('_', 1)[1]}_cuda_core"
            e["cuda_core_route"]["launches"] = bwd_launches[key] + daso_launches[key]
    data_loader(dev, smi)

    # 23. the distances path and the estimators on it (threefry draws the data and the ++ inits)
    threefry["launches"] += distances_phase(dev, smi)

    # 24. the linalg path (no kernel; threefry draws lanczos' start vectors)
    threefry["launches"] += linalg_phase(dev, smi)

    # 25. the sparse layer: no TPU kernel (the JAX package's runs in plain
    # XLA); its products through the CSR SpMM kernel
    csr_spmm = sparse_phase(dev, smi)
    csr_spmm["launches"] += res_launches["csr_spmm"]

    threefry["launches"] += rsvd_threefry + rpca_threefry  # the KMeans inits', rsvd's and the randomized PCA's
    emit({"kernels": [lloyd, lloyd64, threefry, gram, *fft_entries, flash, *flash_bwd, csr_spmm]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
