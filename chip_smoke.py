#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written kernel from ``flink_ml_tpu_torch/csrc``, holds each
against its plain PyTorch version, and drives the port's main paths on the
card — dense, sparse, MLP and KMeans serving, wide-sparse, MLP and KMeans
training. Phases, one JSON line each:

1. device    — the card, its power limit;
2. build     — nvcc for every kernel source, all started together, with the
               ``-Xptxas -v`` resource lines;
3. kernels   — the serving megakernel against its plain version over a grid
               of shapes, then CUDA-event times of kernel, plain version and
               the bound at the serving shape (4096 × 100);
4. serve     — a StandardScaler → LogisticRegression pipeline (d=100) served
               by ``InferenceServer`` with ``fusion.mode=fast``: 64 requests
               from 4 client threads, every response checked against float64
               numpy; megakernel launches, fallbacks, post-warmup builds;
5. crossings — the four one-hot row crossings of sparse SGD against their
               plain versions over a grid of (n_sub, row_hi, n): mult
               bit-equal, dot within 1e-5 · Σ_row |q|, build-form dot
               bit-equal to premat dot;
6. train     — LogisticRegression.fit on the headline wide-sparse workload
               (250,000 rows of 39 hashed features, d = 2^22, batch 65,536,
               20 iterations; data from seed 1): premat crossings launched 20
               times each and no plain crossing called; then SGD.optimize
               with onehot_premat "off" (build-form crossings, 20 launches
               each) and "on" on one DeviceDataCache — all three
               coefficients bit-identical, and held against a float64 numpy
               SGD of the same schedule, whose copy with bf16-hi-only
               crossings must fall outside the tolerance; steady-state
               ms/step of both forms by differencing two iteration counts;
7. crossings — the four crossings at the headline unit shape taken from the
               real layout: checks as in 5, and CUDA-event times of kernel,
               plain version and one PyTorch library call, with the bound;
8. kernels_sparse — the sparse IDF → logistic megakernel against its plain
               version over rows × nnz caps × d × chain (IDF kept, IDF
               dropped, no IDF), rows shorter than the cap included: tfidf
               and margin bit-equal, prediction equal; then CUDA-event times
               at 4096 rows × cap 64 × d = 2^22 on the headline rows' ids, of
               kernel, plain version and ``F.embedding_bag`` (the head's
               margin), with the bytes bound;
9. serve_sparse — the wide-sparse model served: IDF fitted on the headline
               rows, IDFModel.transform on the card, LogisticRegression.fit on
               the tf-idf column (the train phase's schedule), both models
               saved and loaded back through ``load_servable`` into one
               pipeline, served by ``InferenceServer`` (fusion.mode=fast,
               warmed on a sparse template over the nnz-cap ladder 1…64): 64
               requests of 1–4096 new rows from 4 clients, every response
               checked against float64 numpy; megakernel launches equal the
               batches whose (bucket, cap) key is hot, 0 fallbacks, 0 chains
               built after warmup, the plain version never called;
10. kernels_mlp — the scale → mlp megakernel against its plain version over
               rows × networks (256→512→512→8, 100→64→2, 8→16→3 and one at
               the kernel's layer, width and class limits) × chain (the four
               scaler flag combinations, the MLP alone): scaled bit-equal,
               probabilities within the fast tier's envelope, prediction
               equal where the plain top-two logits differ by more than a
               margin; then CUDA-event times at 4096 × 256→512→512→8 of
               kernel, plain version and the chain's three products as
               ``torch.addmm`` (float32, TF32 off), with the operations bound;
11. serve_mlp — the MLP classifier trained and served: 100,000 rows × 256 of
               8 classes from a random teacher, StandardScaler fitted and
               applied on the card, MLPClassifier fitted at the published
               paramMap (hiddenLayers [512, 512], maxIter 10,
               globalBatchSize 4096), held against a float64 fit of the same
               schedule on the card (the bfloat16 fit must land outside the
               tolerance), ms per epoch; both models saved, loaded through
               ``load_servable`` into one pipeline and served by
               ``InferenceServer`` (fusion.mode=fast): 64 requests of 1–4096
               rows from 4 clients checked against float64 numpy; megakernel
               launches equal the batches of bucket ≥ 2, 0 fallbacks, 0
               chains built after warmup, the plain version never called;
12. kernels_kmeans — the scale → kmeans megakernel against its plain
               version over rows (1 … 4096, ragged) × d (1, 7, 100, 256) × k
               (2, 10, 64) × measure (euclidean, manhattan, cosine) × chain
               (the four scaler flag combinations, KMeans alone), with a NaN
               feature, a zero row and a duplicate centroid in the grid:
               scaled bit-equal, prediction equal where the float64 top-two
               distance gap exceeds a margin; then CUDA-event times at 4096
               × d 100 × k 10 of kernel, plain version, the head alone and
               ``torch.cdist`` + ``argmin`` (the head's library yardstick),
               with the bytes bound;
13. fit_kmeans — KMeans.fit at the published config (kmeans-benchmark.json:
               100,000 × 100 uniform rows from seed 2, k 10, maxIter 10),
               nothing cut: two fits bit-identical; every epoch replayed and
               held against float64 from its own starting centroids
               (assignments equal outside the margin, counts equal, new
               centroids within a tolerance of the float64 means), with
               bfloat16-rounded features as a control that must fail; ms per
               epoch from 10 against 60 epochs on one cache; a
               ``torch.profiler`` trace of a 10-epoch fit for the device's
               idle share;
14. serve_kmeans — StandardScaler → KMeans fitted on the published rows,
               saved, loaded back through ``load_servable`` and served by
               ``InferenceServer`` (fusion.mode=fast, max batch 4096): 64
               requests of 1–4096 new rows from 4 clients checked against
               float64 numpy; megakernel launches equal the batches of bucket
               ≥ 512, 0 fallbacks, 0 chains built after warmup, the plain
               version never called; a 4096-row batch's host breakdown.

Then a ``{"kernels": [...]}`` line for every kernel (eight), the ``nvidia-smi``
name/power-limit line, and as the last line ``{"ok": true, "device": {...}}``.
Any failure exits nonzero without that last line; so does a machine without
a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

SEED = 0
D = 100  # vectorDim of the reference's published LogisticRegression / StandardScaler benchmark configs
MAX_BATCH = 4096
CHECK_ROWS = (1, 7, 203, 1024, 4096)
CHECK_WIDTHS = (8, 100, 256, 1000)
# (chain label, with_mean, with_std, write_scaled): the four scaler flag
# combinations of the scale→logistic chain, and LR alone.
CHAINS = (
    ("scale_logistic", True, True, True),
    ("scale_logistic", True, False, True),
    ("scale_logistic", False, True, True),
    ("scale_logistic", False, False, True),
    ("logistic", False, False, False),
)
TIMED_SHAPE = (4096, 100)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
N_CLIENTS = 4
REQUESTS_PER_CLIENT = 16
PREDICTION_MARGIN = 1e-4
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
# The headline wide-sparse workload (bench.py bench_logreg_sparse): Criteo's
# 39 feature fields hashed into 2^22 features, 250,000 rows, values 1.0.
TRAIN_ROWS, TRAIN_DIM, TRAIN_NNZ = 250_000, 1 << 22, 39
TRAIN_BATCH, TRAIN_LR, TRAIN_ITERS, TRAIN_SEED = 65_536, 0.5, 20, 1
STEP_ITERS = (20, 120)  # the two iteration counts differenced for ms/step
PROFILE_ITERS = 10  # iterations of each form traced with torch.profiler
CROSS_GRID = [(s, h, n) for s in (1, 4) for h in (1, 4, 128) for n in (1, 1000, 8192 + 7)]
DOT_RTOL = 1e-5  # |kernel - plain| <= DOT_RTOL * sum_row |q| + 1e-6: another summation order
# max |f32 fit - float64 SGD| / max |coef|: between the split-bf16 fit and
# the float64 SGD whose crossings keep only the bf16 hi half (asserted apart)
COEF_TOL = 1e-5
# the sparse megakernel's check grid (rows shorter than the cap included)
SPARSE_ROWS = (1, 7, 203, 1024, 2048, 4096)
SPARSE_CAPS = (1, 2, 8, 16, 32, 64)
SPARSE_DIMS = (8, 1000, TRAIN_DIM)
SPARSE_CHAINS = (("idf_kept", True, True), ("idf_dropped", True, False), ("no_idf", False, False))
SPARSE_SERVE_SEED = TRAIN_SEED + 1  # new rows from the headline generator
# The MLP classifier: bench.py's mlp / mlp_serving_throughput network and
# flink_ml_tpu/benchmark/configs/mlpclassifier-benchmark.json (vectorDim 256,
# hiddenLayers [512, 512], labelArity 8, 100,000 rows, maxIter 10,
# globalBatchSize 4096).
MLP_WIDTHS = (256, 512, 512, 8)
MLP_CHECK_ROWS = (1, 2, 7, 64, 203, 1024, 4096)
MLP_CHECK_NETWORKS = {"256-512-512-8": MLP_WIDTHS, "100-64-2": (100, 64, 2), "8-16-3": (8, 16, 3)}
# (chain label, with_mean, with_std, write_scaled), as CHAINS
MLP_CHAINS = (
    ("scale_mlp", True, True, True),
    ("scale_mlp", True, False, True),
    ("scale_mlp", False, True, True),
    ("scale_mlp", False, False, True),
    ("mlp", False, False, False),
)
MLP_ROWS, MLP_ITERS, MLP_BATCH, MLP_SEED = 100_000, 10, 4096, 3
MLP_SERVE_SEED = MLP_SEED + 1  # new rows of the same population
MLP_EPOCH_ITERS = (10, 60)  # the two iteration counts differenced for ms/epoch
MLP_HOLDOUT_ROWS = 4096
MLP_SMALL_ROWS = (2, 32, 256, 1024)  # warm times below the serving shape: one block per 32 rows
# The fit against its float64 twin. The first epoch's loss is the forward
# pass at the shared initial weights: float32 rounding of 512-term sums
# (~1e-7 relative) against bfloat16's 2^-9 per operand (the CPU read 9e-10
# and 2.6e-5). From the second epoch on, the default learning rate 0.1
# explodes the loss (2.7 -> ~900) before it settles, which amplifies
# last-bit differences of float32 gradients: the largest relative
# difference of the later losses and the mean |difference| of the held-out
# probabilities get a wider bound. An independent float32 fit of the same
# schedule (the float32 floor) is reported beside the fit: on the CPU both
# read ~1e-4, on the card the fit read 1.16e-3; bfloat16 5.3e-2 and 6.1e-4
# on the CPU.
FIT_FIRST_LOSS_RTOL = 1e-6
FIT_LOSS_RTOL = 1e-2
FIT_PROB_MEAN_ATOL = 1e-4
# KMeans: flink_ml_tpu/benchmark/configs/kmeans-benchmark.json — k 10,
# maxIter 10 on DenseVectorGenerator rows (seed 2, 100,000 x vectorDim 100,
# uniform [0, 1)); nothing cut.
KMEANS_ROWS, KMEANS_D, KMEANS_K, KMEANS_ITERS, KMEANS_DATA_SEED = 100_000, 100, 10, 10, 2
KMEANS_SERVE_SEED = KMEANS_DATA_SEED + 1  # new rows from the same generator
KMEANS_CHECK_ROWS = (1, 7, 203, 1024, 4096)
KMEANS_CHECK_DIMS = (1, 7, 100, 256)
KMEANS_CHECK_KS = (2, 10, 64)
KMEANS_MEASURES = ("euclidean", "manhattan", "cosine")
# (chain label, with_mean, with_std, write_scaled), as CHAINS
KMEANS_CHAINS = (
    ("scale_kmeans", True, True, True),
    ("scale_kmeans", True, False, True),
    ("scale_kmeans", False, True, True),
    ("scale_kmeans", False, False, True),
    ("kmeans", False, False, False),
)
KMEANS_EPOCH_ITERS = (10, 60)  # the two epoch counts differenced for ms/epoch
# StandardScaler → KMeans at d 100, k 10 scores 3016 per row against the
# default bar of 10^6: buckets from 512 rows run the megakernel
KMEANS_HOT_FROM = 512
# Assignments are compared where the float64 top-two distance gap exceeds
# this margin (the MLP slice's): below it two summation orders may round the
# two nearest distances either way. At the published rows the distances are
# ~4.1 and their float32 rounding ~1e-6.
KMEANS_MARGIN = 1e-4
# |a fitted epoch's centroids - the float64 means over its own assignment|:
# float32 sums of ~10,000 values in [0, 1) through the GEMM, ~1e-6.
KMEANS_CENTROID_ATOL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build(kernels):
    from flink_ml_tpu_torch.native import build

    t0 = time.perf_counter()
    sources = sorted({k.source for k in kernels})
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        results = dict(zip(sources, pool.map(build, sources)))
    for source, res in results.items():
        emit(
            "build",
            kernels=[k.name for k in kernels if k.source == source],
            source=source,
            seconds=res.seconds,
            cached=res.cached,
            # registers, shared memory, stack and spills of each kernel
            ptxas=[ln.strip() for ln in res.log.splitlines()
                   if ("ptxas info" in ln and "Used" in ln) or "spill" in ln],
        )
    emit("build", total_seconds=time.perf_counter() - t0)


def _cold_times(fn, iters: int, flush) -> list:
    """Per-call device milliseconds of ``fn`` with L2 cold: each call runs
    after zeroing ``flush`` (larger than L2), between its own CUDA events.
    The flush keeps the device busy while the host enqueues the call, so
    host launch overhead does not enter the time."""
    import torch

    pairs = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def _warm_time(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` back to back (inputs in
    L2): a sleep kernel holds the device while the host enqueues all calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(rng, card: str):
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        SCALE_LOGISTIC,
        scale_logistic,
        scale_logistic_plain,
    )

    dev = torch.device("cuda", 0)
    envelope = ULP_ENVELOPE["scale_logistic"]

    def inputs(rows, d):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        x = rng.normal(size=(rows, d))
        mean = rng.normal(size=d)
        std = np.abs(rng.normal(size=d)) + 0.5
        std[0] = 0.0  # the zero-std guard: that feature scales to 0
        std32 = std.astype(np.float32)
        inv_std = np.where(std32 == 0.0, 0.0, 1.0 / np.where(std32 == 0.0, 1.0, std32))
        coef = rng.normal(size=d) * (3.0 / np.sqrt(d))
        return t(x), t(mean), t(inv_std), t(coef)

    max_abs_err = 0.0
    max_ulps = 0
    checked = 0
    for rows in CHECK_ROWS:
        for d in CHECK_WIDTHS:
            x, mean, inv_std, coef = inputs(rows, d)
            for label, with_mean, with_std, write_scaled in CHAINS:
                scaled, pred, raw = scale_logistic(
                    x, mean, inv_std, coef,
                    with_mean=with_mean, with_std=with_std, write_scaled=write_scaled,
                )
                p_scaled, p_pred, p_raw = scale_logistic_plain(
                    x, mean, inv_std, coef, with_mean=with_mean, with_std=with_std
                )
                torch.cuda.synchronize()
                where = f"{label} rows={rows} d={d} with_mean={with_mean} with_std={with_std}"
                if write_scaled:
                    if not torch.equal(scaled, p_scaled):
                        raise AssertionError(f"scaled not bit-equal to the plain version: {where}")
                else:
                    assert scaled is None, where
                ulps = ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy())
                if ulps > envelope:
                    raise AssertionError(f"rawPrediction {ulps} ulps > {envelope}: {where}")
                margin = (p_scaled @ coef).cpu().numpy()
                decided = np.abs(margin) > PREDICTION_MARGIN
                if not np.array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided]):
                    raise AssertionError(f"prediction differs where |margin| > {PREDICTION_MARGIN}: {where}")
                errs = [(raw - p_raw).abs().max(), (pred - p_pred).abs().max()]
                if write_scaled:
                    errs.append((scaled - p_scaled).abs().max())
                max_abs_err = max(max_abs_err, max(float(e) for e in errs))
                max_ulps = max(max_ulps, ulps)
                checked += 1
    emit("kernels", kernel=SCALE_LOGISTIC.name, configurations=checked,
         max_abs_err=max_abs_err, max_raw_ulps=max_ulps, raw_ulp_envelope=envelope,
         scaled="bit-equal", prediction=f"equal where |margin| > {PREDICTION_MARGIN}")

    rows, d = TIMED_SHAPE
    x, mean, inv_std, coef = inputs(rows, d)

    def kernel():
        scale_logistic(x, mean, inv_std, coef, with_mean=True, with_std=True, write_scaled=True)

    def plain():
        scale_logistic_plain(x, mean, inv_std, coef, with_mean=True, with_std=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for fn in (kernel, plain):  # warm-up
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    times = {"kernel": {"cold": [], "warm": []}, "plain": {"cold": [], "warm": []}}
    for name, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
        times[name]["cold"] += _cold_times(fn, 100, flush)
        times[name]["warm"].append(_warm_time(fn, 200))

    def median(v):
        v = sorted(v)
        return v[len(v) // 2]

    bytes_moved = 4 * (rows * d + rows * d + rows + 2 * rows + 3 * d)
    ops = 4 * rows * d + 8 * rows  # sub, mul, fma (2) per element; compare + sigmoid per row
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timing = {
        "shape": [rows, d],
        "ms": median(times["kernel"]["cold"]),
        "ms_l2_warm": median(times["kernel"]["warm"]),
        "plain_ms": median(times["plain"]["cold"]),
        "plain_ms_l2_warm": median(times["plain"]["warm"]),
        "bytes": bytes_moved,
        "ops": ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes the fused chain
    }
    emit("kernels", kernel=SCALE_LOGISTIC.name, card=card, **timing)
    return {"max_abs_err": max_abs_err, **timing}


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def _count_calls(module, names):
    """Wrap ``module``'s functions ``names`` so a run can show none was
    called; returns the call list and a function that restores them."""
    saved = {n: getattr(module, n) for n in names}
    calls = []

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return counted

    for n in names:
        setattr(module, n, wrap(n, saved[n]))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)

    return calls, restore


def _count_plain_calls():
    """The crossings' plain versions, counted (``_count_calls``)."""
    import flink_ml_tpu_torch.linalg.onehot_sparse as oh

    return _count_calls(oh, ("dot_crossing_plain", "mult_crossing_plain",
                             "dot_crossing_premat_plain", "mult_crossing_premat_plain"))


def _check_crossings(q, rowid, m3, row_hi, order, oh, where):
    """Each crossing kernel against its plain version on one input set;
    returns {kernel name: max |kernel - plain|}."""
    import torch

    from flink_ml_tpu_torch.linalg import onehot_sparse as O

    n_sub, n = q.shape
    dot_b = O.dot_crossing(q, rowid, row_hi, order)
    dot_p = O.dot_crossing_premat(q, *oh)
    dot_plain = O.dot_crossing_plain(q, rowid, row_hi)
    mult_b = O.mult_crossing(m3, rowid)
    mult_p = O.mult_crossing_premat(m3, *oh)
    mult_plain = O.mult_crossing_plain(m3, rowid)
    mult_p_plain = O.mult_crossing_premat_plain(m3, *oh)
    torch.cuda.synchronize()
    rows = row_hi * 128
    flat = (torch.arange(n_sub, device=q.device)[:, None] * rows + rowid.long()).reshape(-1)
    live = (rowid >= 0) & (rowid < rows)
    absum = torch.zeros(n_sub * rows, dtype=torch.float64, device=q.device).index_add_(
        0, flat[live.reshape(-1)], q.abs().double().reshape(-1)[live.reshape(-1)])
    tol = DOT_RTOL * absum.reshape(n_sub, row_hi, 128) + 1e-6
    err = (dot_b.double() - dot_plain.double()).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"dot crossing off its plain version by {float(err.max())}: {where}")
    if not torch.equal(dot_b, dot_p):
        raise AssertionError(f"build-form dot not bit-equal to premat dot: {where}")
    if not torch.equal(mult_b, mult_plain):
        raise AssertionError(f"mult crossing not bit-equal to its plain version: {where}")
    if not torch.equal(mult_p, mult_p_plain) or not torch.equal(mult_p[:, :n], mult_b):
        raise AssertionError(f"premat mult crossing not bit-equal: {where}")
    return {
        O.DOT_CROSSING.name: float(err.max()),
        O.MULT_CROSSING.name: float((mult_b - mult_plain).abs().max()),
        O.DOT_CROSSING_PREMAT.name: float(err.max()),  # dot_p == dot_b, bit for bit
        O.MULT_CROSSING_PREMAT.name: float((mult_p - mult_p_plain).abs().max()),
    }


def phase_crossings_grid(rng, card: str):
    """The four crossings against their plain versions over CROSS_GRID."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.linalg import onehot_sparse as O

    dev = torch.device("cuda", 0)
    errs = {}
    for n_sub, row_hi, n in CROSS_GRID:
        rowid = torch.from_numpy(rng.integers(0, row_hi * 128, (n_sub, n)).astype(np.int16)).to(dev)
        q = torch.from_numpy(rng.normal(size=(n_sub, n)).astype(np.float32)).to(dev)
        m3 = torch.from_numpy(rng.normal(size=(n_sub, row_hi, 128)).astype(np.float32)).to(dev)
        got = _check_crossings(q, rowid, m3, row_hi, O.row_order(rowid, row_hi),
                               O.premat_row_onehots(rowid, row_hi), f"n_sub={n_sub} row_hi={row_hi} n={n}")
        for k, v in got.items():
            errs[k] = max(errs.get(k, 0.0), v)
    emit("crossings", card=card, configurations=len(CROSS_GRID), max_abs_err=errs,
         mult="bit-equal", dot=f"within {DOT_RTOL} * sum_row |q| + 1e-6",
         build_vs_premat_dot="bit-equal")
    return errs


def _hashed_rows(rng, rows, nnz):
    """``rows`` rows of ``nnz`` distinct hashed features in [0, TRAIN_DIM),
    sorted: the headline generator."""
    import numpy as np

    idx = np.sort(rng.integers(0, TRAIN_DIM, size=(rows, nnz)), axis=1)
    while True:  # redraw the rows where two hashes collide
        dup = np.flatnonzero((np.diff(idx, axis=1) == 0).any(axis=1))
        if not dup.size:
            return idx
        idx[dup] = np.sort(rng.integers(0, TRAIN_DIM, size=(dup.size, nnz)), axis=1)


def _headline_data():
    """The headline dataset from TRAIN_SEED: 39 distinct hashed features per
    row, value 1.0, labels from a sparse random separator (bench.py)."""
    import numpy as np

    rng = np.random.default_rng(TRAIN_SEED)
    idx = _hashed_rows(rng, TRAIN_ROWS, TRAIN_NNZ)
    w_true = (rng.random(TRAIN_DIM) < 0.001) * rng.standard_normal(TRAIN_DIM)
    y = (w_true[idx].sum(axis=1) > 0).astype(np.float64)
    return idx, y


def _sparse_frame(idx_rows, **columns):
    """A DataFrame of SparseVector rows (value 1.0) from rows of ids, with
    any further ``columns``."""
    import numpy as np

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.linalg.vectors import SparseVector

    ones = np.ones(idx_rows.shape[1])
    return DataFrame.from_dict({
        "features": [SparseVector(TRAIN_DIM, row, ones) for row in idx_rows], **columns,
    })


def _bf16(x):
    """``x`` rounded to bfloat16 (to nearest even), as float64."""
    import numpy as np

    b = np.asarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32).astype(np.float64)


def _reference_sgd(indices, values, y, dim, hi_only=False):
    """Float64 numpy SGD of SGD's schedule and update (BinaryLogisticLoss,
    no regularization): the coefficient and the loss history. With
    ``hi_only`` the crossings keep only their bf16 hi half (each entry's
    term of the margin and each row's multiplier rounded to bf16): the
    control that shows the coefficient check can tell a crossing that drops
    its lo half from the split-bf16 one."""
    import numpy as np

    from flink_ml_tpu_torch.ops.schedule import offset_schedule

    def cross(x):
        return _bf16(x) if hi_only else x

    n = y.shape[0]
    batch = min(TRAIN_BATCH, n)
    coef = np.zeros(dim)
    losses = []
    idx = indices.astype(np.int64)
    val = values.astype(np.float64)
    for start, offset in zip(*offset_schedule(n, batch, TRAIN_ITERS)):
        rows = slice(start, start + batch)
        ib, vb, yb = idx[rows], val[rows], y[rows].astype(np.float64)
        wb = (start + np.arange(batch) >= offset).astype(np.float64)
        ys = 2.0 * yb - 1.0
        z = cross(vb * coef[ib]).sum(axis=1) * ys
        loss = (wb * np.logaddexp(0.0, -z)).sum()
        mult = cross(wb * (-ys / (1.0 + np.exp(z))))
        grad = np.bincount(ib.ravel(), weights=(vb * mult[:, None]).ravel(), minlength=dim)
        coef -= TRAIN_LR / wb.sum() * grad
        losses.append(loss / wb.sum())
    return coef, losses


def _profile_steps(run):
    """Device time by kernel name over one ``run()`` under torch.profiler:
    the top entries, the device-busy total and the wall time (whose
    difference is the device's idle share while the host drives it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm: layout, one-hots and kernels built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # device-side events only (kernels, copies): an operator's own entry
    # carries its kernels' time again
    events = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in events)
    return {
        "iterations": PROFILE_ITERS, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
        "top": [{"name": k[:80], "ms": ms, "calls": n} for k, ms, n in events[:12]],
    }


def phase_train(card: str, headline):
    """LogisticRegression.fit on the headline workload, then SGD.optimize
    with the build-form and premat crossings on one cache."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
    from flink_ml_tpu_torch.models.common import extract_labeled_data
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD

    premat_k = (O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)
    build_k = (O.DOT_CROSSING, O.MULT_CROSSING)
    t0 = time.perf_counter()
    idx, y = headline
    df = _sparse_frame(idx, label=y)
    data_s = time.perf_counter() - t0

    # Main path 1: LogisticRegression.fit — the premat crossings.
    est = (LogisticRegression().set_max_iter(TRAIN_ITERS).set_global_batch_size(TRAIN_BATCH)
           .set_learning_rate(TRAIN_LR).set_tol(0.0))
    calls, restore = _count_plain_calls()
    try:
        for k in premat_k + build_k:
            k.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = est.fit(df)
        fit_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in premat_k + build_k}
    finally:
        restore()
    fit_peak = torch.cuda.max_memory_allocated()
    if not est.onehot_premat_active:
        raise AssertionError("the fit did not take the premat one-hot path")
    for k in premat_k:
        if launches[k.name] != TRAIN_ITERS:
            raise AssertionError(f"{k.name} launched {launches[k.name]} times in the fit, not {TRAIN_ITERS}")
    for k in build_k:
        if launches[k.name] != 0:
            raise AssertionError(f"{k.name} launched {launches[k.name]} times in the premat fit")
    if calls:
        raise AssertionError(f"plain crossings were called on the card: {sorted(set(calls))}")
    coef_fit = model.coefficient
    losses = est.loss_history
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss_history does not fall: {losses[0]} -> {losses[-1]}")

    # Main path 2: SGD.optimize, build form ("off") then premat ("on"), one cache.
    cols = extract_labeled_data(df, "features", "label", None, allow_sparse=True)
    dim = cols.pop("dim")
    cache = DeviceDataCache(cols)
    del df

    def sgd(premat, iters=TRAIN_ITERS):
        opt = SGD(max_iter=iters, global_batch_size=TRAIN_BATCH, tol=0.0,
                  learning_rate=TRAIN_LR, onehot_premat=premat)
        return opt, opt.optimize(np.zeros(dim, np.float32), cache, BinaryLogisticLoss.INSTANCE)

    runs = {}
    for premat, ks in (("off", build_k), ("on", premat_k)):
        calls, restore = _count_plain_calls()
        try:
            for k in premat_k + build_k:
                k.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            opt, coef = sgd(premat)
            seconds = time.perf_counter() - t0
            got = {k.name: k.launches for k in premat_k + build_k}
        finally:
            restore()
        if calls:
            raise AssertionError(f"plain crossings were called on the card: {sorted(set(calls))}")
        if opt.onehot_premat_active != (premat == "on"):
            raise AssertionError(f"onehot_premat={premat} ran premat={opt.onehot_premat_active}")
        for k in premat_k + build_k:
            want = TRAIN_ITERS if k in ks else 0
            if got[k.name] != want:
                raise AssertionError(f"{k.name} launched {got[k.name]} times with premat {premat}, not {want}")
        runs[premat] = {"coef": coef, "launches": got, "seconds": seconds,
                        "layout_s": opt.layout_seconds, "peak_bytes": torch.cuda.max_memory_allocated()}
    for name, coef in (("off", runs["off"]["coef"]), ("on", runs["on"]["coef"])):
        if not np.array_equal(coef.view(np.int32), coef_fit.view(np.int32)):
            raise AssertionError(f"SGD premat={name} coefficient is not bit-identical to the fit's")

    ref, ref_losses = _reference_sgd(cols["indices"], cols["values"], cols["labels"], dim)
    control, _ = _reference_sgd(cols["indices"], cols["values"], cols["labels"], dim, hi_only=True)
    scale = float(np.abs(ref).max())
    coef_err = float(np.abs(coef_fit.astype(np.float64) - ref).max())
    control_err = float(np.abs(control - ref).max())
    loss_err = float(np.max(np.abs(np.asarray(losses) - ref_losses) / np.abs(ref_losses)))
    if not coef_err <= COEF_TOL * scale:
        raise AssertionError(f"coefficient off the float64 SGD by {coef_err} (scale {scale})")
    if not control_err > COEF_TOL * scale:
        raise AssertionError(f"the hi-half-only control is within the tolerance ({control_err}, "
                             f"scale {scale}): the coefficient check cannot tell the two apart")
    if not loss_err <= 1e-5:
        raise AssertionError(f"loss history off the float64 SGD by {loss_err} (relative)")

    # Steady-state ms/step of both forms: difference two iteration counts.
    step_ms = {}
    for premat in ("on", "off", "off", "on"):  # ends on "on": the premat memo stays for phase 7
        t = []
        for iters in STEP_ITERS:
            t0 = time.perf_counter()
            sgd(premat, iters)
            t.append(time.perf_counter() - t0)
        step_ms.setdefault(premat, []).append((t[1] - t[0]) / (STEP_ITERS[1] - STEP_ITERS[0]) * 1e3)
    profile = {premat: _profile_steps(lambda: sgd(premat, PROFILE_ITERS)) for premat in ("off", "on")}
    lay = cache._onehot_memo[1]
    result = {
        "rows": TRAIN_ROWS, "dim": TRAIN_DIM, "nnz_per_row": TRAIN_NNZ, "batch": TRAIN_BATCH,
        "iterations": TRAIN_ITERS, "data_s": data_s, "fit_s": fit_s, "fit_peak_bytes": fit_peak,
        "fit_launches": launches, "premat_active": True,
        "layout": {"n_windows": lay.n_windows, "n_sub": lay.n_sub, "sub_batch": lay.sub_batch,
                   "row_hi": lay.row_hi, "n_flat": lay.n_flat,
                   "live_slots_per_unit": float(np.count_nonzero(lay.lvals)) / (lay.n_windows * lay.n_sub),
                   "classes": [[f, w] for f, w, _, _ in lay.class_meta]},
        "layout_build_s": runs["off"]["layout_s"],
        "sgd": {k: {kk: v[kk] for kk in ("launches", "seconds", "peak_bytes")} for k, v in runs.items()},
        "coefficients": "fit == SGD premat on == SGD premat off, bit for bit",
        "coef_max_abs_err_vs_f64": coef_err, "coef_scale": scale,
        "coef_tol": COEF_TOL, "hi_only_control_max_abs_err_vs_f64": control_err,
        "loss_max_rel_err_vs_f64": loss_err, "loss_first": losses[0], "loss_last": losses[-1],
        "ms_per_step": {k: _median(v) for k, v in step_ms.items()},
        "ms_per_step_runs": step_ms,
        "rows_per_s": {k: TRAIN_BATCH / (_median(v) / 1e3) for k, v in step_ms.items()},
        "profile": profile,
    }
    emit("train", card=card, **result)
    return cache, {
        O.DOT_CROSSING.name: runs["off"]["launches"][O.DOT_CROSSING.name],
        O.MULT_CROSSING.name: runs["off"]["launches"][O.MULT_CROSSING.name],
        O.DOT_CROSSING_PREMAT.name: launches[O.DOT_CROSSING_PREMAT.name],
        O.MULT_CROSSING_PREMAT.name: launches[O.MULT_CROSSING_PREMAT.name],
    }


def phase_crossings_headline(cache, card: str):
    """The crossings at the headline unit shape (window 0 of the real
    layout): checks, then L2-cold and warm times of kernel, plain version
    and one library call, and the bound."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.linalg import onehot_sparse as O

    dev = torch.device("cuda", 0)
    lay, (lidx, rowid, lvals, row_ptr, entry_of) = cache._onehot_memo[1:]
    oh_hi, oh_lo = cache._onehot_premat_memo[1]
    wi = 0
    rng = np.random.default_rng(SEED + 1)
    coef_perm = torch.from_numpy(rng.normal(size=lay.nblk * O.BLOCK).astype(np.float32)).to(dev)
    q = lvals[wi] * O.gather_round(coef_perm, lidx[wi], lay.class_meta)
    m3 = torch.from_numpy(rng.normal(size=(lay.n_sub, lay.row_hi, 128)).astype(np.float32)).to(dev)
    rid, order, prem = rowid[wi], (row_ptr[wi], entry_of[wi]), (oh_hi, oh_lo, wi)
    errs = _check_crossings(q, rid, m3, lay.row_hi, order, prem, "headline unit shape")

    n_sub, n = (int(v) for v in q.shape)
    n_pad, row_hi, rows = int(oh_hi.shape[2]), lay.row_hi, lay.row_hi * 128
    live = int(order[0][:, -1].sum())
    # library calls: one PyTorch call each on the same inputs, operands prepared outside
    flat = (torch.arange(n_sub, device=dev)[:, None] * rows + rid.long()).reshape(-1)
    acc = torch.zeros(n_sub * rows, device=dev)
    q_flat = q.reshape(-1)
    rid_long = rid.long()
    m3_flat = m3.reshape(n_sub, rows)
    hi_t = oh_hi[wi].transpose(1, 2)
    q_hi = q.to(torch.bfloat16).float()
    q_pad = torch.nn.functional.pad(torch.cat([q_hi, (q - q_hi)], 0), (0, n_pad - n))
    lo_q = torch.cat([oh_lo[wi] * q_pad[:n_sub, :, None].to(torch.bfloat16),
                      oh_lo[wi] * q_pad[n_sub:, :, None].to(torch.bfloat16)], dim=2)
    m_hi = m3.to(torch.bfloat16)
    m_cat = torch.cat([m_hi, (m3 - m_hi.float()).to(torch.bfloat16)], dim=2)
    del q_pad
    cases = {
        O.DOT_CROSSING.name: (
            lambda: O.dot_crossing(q, rid, row_hi, order),
            lambda: O.dot_crossing_plain(q, rid, row_hi),
            lambda: acc.index_add_(0, flat, q_flat),
            4 * live * 2 + 4 * n_sub * (rows + 1) + 4 * n_sub * rows,  # q + entry_of (live), row_ptr, out
            5 * 2 * live,  # split and add per live entry and half (f32)
            F32_OPS_PER_S,
        ),
        O.MULT_CROSSING.name: (
            lambda: O.mult_crossing(m3, rid),
            lambda: O.mult_crossing_plain(m3, rid),
            lambda: torch.gather(m3_flat, 1, rid_long),
            2 * n_sub * n + 4 * n_sub * n + 4 * n_sub * rows,  # rowid in, u out, mult3
            4 * n_sub * n,
            F32_OPS_PER_S,
        ),
        O.DOT_CROSSING_PREMAT.name: (
            lambda: O.dot_crossing_premat(q, *prem),
            lambda: O.dot_crossing_premat_plain(q, *prem),
            lambda: torch.bmm(hi_t, lo_q),
            # q at every slot, the one-hot rows of live entries (padding slots
            # carry q = 0 and add nothing), out; as the build-form dot
            4 * n_sub * n + 2 * live * (row_hi + 128) + 4 * n_sub * rows,
            2 * 2 * live * row_hi * 128,  # two halves of the dense contraction, live entries
            BF16_OPS_PER_S,
        ),
        O.MULT_CROSSING_PREMAT.name: (
            lambda: O.mult_crossing_premat(m3, *prem),
            lambda: O.mult_crossing_premat_plain(m3, *prem),
            lambda: torch.bmm(oh_hi[wi], m_cat),
            # every slot's output is read off its own one-hot rows, padding too
            2 * n_sub * n_pad * (row_hi + 128) + 4 * n_sub * rows + 4 * n_sub * n_pad,
            2 * 2 * n_sub * n_pad * row_hi * 128,
            BF16_OPS_PER_S,
        ),
    }
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for name, (kernel, plain, library, nbytes, ops, peak) in cases.items():
        reps = 10 if "premat" in name else 50
        for fn in (kernel, plain, library):
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        t = {"kernel": {"cold": [], "warm": []}, "plain": {"cold": [], "warm": []},
             "library": {"cold": [], "warm": []}}
        for which, fn in (("plain", plain), ("kernel", kernel), ("library", library),
                          ("library", library), ("kernel", kernel), ("plain", plain)):
            t[which]["cold"] += _cold_times(fn, reps, flush)
            t[which]["warm"].append(_warm_time(fn, reps))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        out[name] = {
            "max_abs_err": errs[name],
            "ms": _median(t["kernel"]["cold"]),
            "ms_l2_warm": _median(t["kernel"]["warm"]),
            "plain_ms": _median(t["plain"]["cold"]),
            "library_ms": _median(t["library"]["cold"]),
            "library_ms_l2_warm": _median(t["library"]["warm"]),
            "bytes": nbytes,
            "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    emit("crossings", card=card, shape={"n_sub": n_sub, "n": n, "n_pad": n_pad, "row_hi": row_hi,
                                        "live_entries": live}, timing=out)
    return out


def phase_serve(rng, card: str):
    import numpy as np

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.servable import (
        LogisticRegressionModelServable,
        PipelineModelServable,
        StandardScalerModelServable,
    )
    from flink_ml_tpu_torch.servable.megakernels import SCALE_LOGISTIC
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    scaler = (
        StandardScalerModelServable()
        .set_input_col("features").set_output_col("scaled").set_with_mean(True)
    )
    scaler.mean = rng.normal(size=D)
    scaler.std = np.abs(rng.normal(size=D)) + 0.5
    lr = LogisticRegressionModelServable().set_features_col("scaled")
    lr.coefficient = rng.normal(size=D) * (3.0 / np.sqrt(D))
    pipeline = PipelineModelServable([scaler, lr])

    mean32 = np.asarray(scaler.mean, np.float32).astype(np.float64)
    inv_std = scaler._inv_std().astype(np.float64)
    coef32 = np.asarray(lr.coefficient, np.float32).astype(np.float64)

    def reference(x):
        x64 = np.asarray(x, np.float32).astype(np.float64)
        scaled = (x64 - mean32) * inv_std
        margin = scaled @ coef32
        p = 1.0 / (1.0 + np.exp(-margin))
        return scaled, margin, np.stack([1.0 - p, p], axis=1)

    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12)))))
             for _ in range(N_CLIENTS * REQUESTS_PER_CLIENT)]
    sizes[::16] = [4096, 1500, 2048, 1024][: len(sizes[::16])]  # hot buckets on every run
    payloads = [rng.normal(size=(n, D)) for n in sizes]

    config = ServingConfig(
        max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast",
    )
    server = InferenceServer(
        pipeline,
        name="chip-smoke",
        serving_config=config,
        warmup_template=DataFrame.from_dict({"features": payloads[0][:1]}),
        device="cuda",
    )
    scope = server.scope
    with server:
        kinds = chain_kinds(pipeline._fastpath_plan)
        hot = sorted(b for b, k in kinds.items() if "megakernel" in k)
        # The main path's run starts here: counts to 0, then traffic.
        SCALE_LOGISTIC.reset_launches()
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * len(sizes)
        failures = []

        def client(c):
            for i in range(c, len(sizes), N_CLIENTS):
                t0 = time.perf_counter()
                try:
                    resp = server.predict(DataFrame.from_dict({"features": payloads[i]}))
                    latencies[i] = (time.perf_counter() - t0) * 1000.0
                    out = resp.dataframe
                    scaled, margin, raw = reference(payloads[i])
                    np.testing.assert_allclose(out["scaled"], scaled, rtol=1e-6, atol=1e-6)
                    np.testing.assert_allclose(out["rawPrediction"], raw, rtol=0, atol=1e-5)
                    decided = np.abs(margin) > PREDICTION_MARGIN
                    np.testing.assert_array_equal(
                        np.asarray(out["prediction"])[decided], (margin >= 0).astype(np.float64)[decided]
                    )
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve clients did not finish within 600 s")
        launches = SCALE_LOGISTIC.launches
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    hot_batches = sum(1 for _, bucket in batches if bucket in hot)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(f"megakernel launches {launches} != batches in hot buckets {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    lat = sorted(latencies)
    result = {
        "requests": len(sizes),
        "rows": sum(sizes),
        "batches": len(batches),
        "hot_buckets": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
    }
    emit("serve", card=card, **result)
    return launches


def _packed_headline(idx_rows, cap):
    """The headline rows' ids packed at ``cap`` (value 1.0, padding id 0 /
    value 0): ``(values f32, ids i32, live slots)``."""
    import numpy as np

    rows = len(idx_rows)
    ids = np.zeros((rows, cap), np.int32)
    vals = np.zeros((rows, cap), np.float32)
    k = min(cap, idx_rows.shape[1])
    ids[:, :k] = idx_rows[:, :k]
    vals[:, :k] = 1.0
    return vals, ids, rows * k


def phase_kernels_sparse(rng, card: str, headline_idx):
    """The sparse IDF → logistic megakernel against its plain version over
    the check grid, then its times at the serving shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        SPARSE_IDF_LOGISTIC,
        sparse_idf_logistic,
        sparse_idf_logistic_plain,
    )

    dev = torch.device("cuda", 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same_bits(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    checked, max_ulps, max_abs_err = 0, 0, 0.0
    for d in SPARSE_DIMS:
        idf = t(np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.1))
        coef = t((rng.normal(size=d) * 0.3).astype(np.float32))
        for rows in SPARSE_ROWS:
            for cap in SPARSE_CAPS:
                nnz = rng.integers(0, cap + 1, rows)  # rows shorter than the cap
                ids = np.sort(rng.integers(0, d, (rows, cap)), axis=1).astype(np.int32)
                vals = rng.normal(size=(rows, cap)).astype(np.float32)
                dead = np.arange(cap)[None, :] >= nnz[:, None]
                ids[dead], vals[dead] = 0, 0.0
                v_t, i_t = t(vals), t(ids)
                for label, with_idf, keep in SPARSE_CHAINS:
                    m_idf = idf if with_idf else None
                    tfidf, margin, pred, raw = sparse_idf_logistic(v_t, i_t, m_idf, coef, write_tfidf=keep)
                    p_tfidf, p_margin, p_pred, p_raw = sparse_idf_logistic_plain(v_t, i_t, m_idf, coef)
                    torch.cuda.synchronize()
                    where = f"{label} rows={rows} cap={cap} d={d}"
                    if keep and not same_bits(tfidf, p_tfidf):
                        raise AssertionError(f"tfidf not bit-equal to the plain version: {where}")
                    if (tfidf is None) == keep:
                        raise AssertionError(f"tfidf kept={tfidf is not None}, asked {keep}: {where}")
                    if not same_bits(margin, p_margin):
                        raise AssertionError(f"margin not bit-equal to the plain version: {where}")
                    if not torch.equal(pred, p_pred):
                        raise AssertionError(f"prediction differs from the plain version: {where}")
                    ulps = ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy())
                    if ulps > ULP_ENVELOPE["sparse_idf_logistic"]:
                        raise AssertionError(f"rawPrediction {ulps} ulps from the plain version: {where}")
                    max_ulps = max(max_ulps, ulps)
                    max_abs_err = max(max_abs_err, float((raw - p_raw).abs().max()))
                    checked += 1
    emit("kernels_sparse", kernel=SPARSE_IDF_LOGISTIC.name, configurations=checked,
         tfidf="bit-equal", margin="bit-equal", prediction="equal",
         max_raw_ulps=max_ulps, max_abs_err=max_abs_err)

    # Times at the serving shape: 4096 headline rows at cap 64, d = 2^22.
    rows, cap, d = MAX_BATCH, 64, TRAIN_DIM
    vals_np, ids_np, live = _packed_headline(headline_idx[:rows], cap)
    values, ids = t(vals_np), t(ids_np)
    idf = t(np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.1))
    coef = t((rng.normal(size=d) * 0.3).astype(np.float32))
    coef_col, ids_long = coef[:, None], ids.long()  # the library call's operands, prepared outside

    def kernel():
        sparse_idf_logistic(values, ids, idf, coef, write_tfidf=True)

    def kernel_head():
        sparse_idf_logistic(values, ids, None, coef, write_tfidf=False)

    def plain():
        sparse_idf_logistic_plain(values, ids, idf, coef)

    def library():  # the sparse_logistic chain's margin, one PyTorch call
        F.embedding_bag(ids_long, coef_col, per_sample_weights=values, mode="sum")

    lib_margin = F.embedding_bag(ids_long, coef_col, per_sample_weights=values, mode="sum")[:, 0]
    _, head_margin, _, _ = sparse_idf_logistic(values, ids, None, coef, write_tfidf=False)
    lib_err = float((lib_margin - head_margin).abs().max())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fns = {"kernel": kernel, "kernel_head": kernel_head, "plain": plain, "library": library}
    for fn in fns.values():
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    times = {k: {"cold": [], "warm": []} for k in fns}
    for name in ("plain", "kernel", "kernel_head", "library", "library", "kernel_head", "kernel", "plain"):
        reps = 20 if name == "plain" else 100
        times[name]["cold"] += _cold_times(fns[name], reps, flush)
        times[name]["warm"].append(_warm_time(fns[name], reps))
    # Bytes the chain must move: values and ids read once, tfidf and the
    # three heads written once, and for each gathered model vector (idf,
    # coef) each distinct 32-byte sector that this run's ids touch, once (a
    # repeat hits L2). nnz is not read: the kernel folds all K slots.
    sectors = np.unique(ids_np // 8).size
    nbytes = 4 * rows * cap * 2 + 4 * rows * cap + 4 * rows * 4 + 2 * 32 * sectors
    ops = 3 * rows * cap + 8 * rows  # two multiplies and an add per slot; the head per row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timing = {
        "shape": {"rows": rows, "cap": cap, "d": d, "live_slots": live, "distinct_sectors": sectors},
        "ms": _median(times["kernel"]["cold"]),
        "ms_l2_warm": _median(times["kernel"]["warm"]),
        "ms_head_only": _median(times["kernel_head"]["cold"]),
        "ms_head_only_l2_warm": _median(times["kernel_head"]["warm"]),
        "plain_ms": _median(times["plain"]["cold"]),
        "plain_ms_l2_warm": _median(times["plain"]["warm"]),
        "library_ms": _median(times["library"]["cold"]),
        "library_ms_l2_warm": _median(times["library"]["warm"]),
        "library": "F.embedding_bag(ids, coef[:, None], per_sample_weights=values, mode='sum'): "
                   "the head's margin, to hold against ms_head_only",
        "library_margin_max_abs_err": lib_err,
        "bytes": nbytes,
        "ops": ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit("kernels_sparse", kernel=SPARSE_IDF_LOGISTIC.name, card=card, **timing)
    del flush
    return {"max_abs_err": max_abs_err, **timing}


def _sparse_batch_breakdown(plan, df, ingest, reps=5):
    """Where one full-bucket batch's time goes on the plan's path (host
    clock, the device synchronised after each step; median of ``reps``):
    packing the SparseVectors, the upload, the chain on the card, and the
    readback with the tf-idf SparseVectors rebuilt."""
    import torch

    from flink_ml_tpu_torch.servable.planner import PlanExecution, run_segment
    from flink_ml_tpu_torch.servable.sparse import resolve_nnz_cap_max

    (segment,) = plan.segments
    steps = {"pack": [], "pack_and_upload": [], "chain": [], "readback": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        segment.gather_sparse(df, "features", cap_max=resolve_nnz_cap_max())
        t1 = time.perf_counter()
        inputs, key = ingest(segment, df, len(df))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outputs = run_segment(segment, key, inputs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        PlanExecution(df, segment.pending(outputs)).finalize()
        t4 = time.perf_counter()
        for name, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[name].append(dt * 1e3)
    return {"rows": len(df), "key": list(key), "kinds": list(segment.plan_kinds[key]),
            **{name: _median(v) for name, v in steps.items()}}


def phase_serve_sparse(card: str, headline):
    """The wide-sparse model served on the card: IDF → LogisticRegression
    fitted on the headline rows, saved, loaded, and served."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.linalg.sparse_batch import ladder_cap
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
    from flink_ml_tpu_torch.models.common import extract_labeled_data
    from flink_ml_tpu_torch.models.feature.idf import IDF
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    idx, y = headline
    t0 = time.perf_counter()
    df = _sparse_frame(idx, label=y)
    data_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    idf_model = IDF().set_input_col("features").set_output_col("tfidf").fit(df)
    idf_fit_s = time.perf_counter() - t0
    doc_freq = np.bincount(idx.ravel(), minlength=TRAIN_DIM)
    if not np.array_equal(idf_model.doc_freq, doc_freq):
        raise AssertionError("IDF doc_freq differs from the rows' document counts")
    t0 = time.perf_counter()
    tfidf_df = idf_model.transform(df)  # on the card
    idf_transform_s = time.perf_counter() - t0
    idf32 = np.asarray(idf_model.idf, np.float32)
    for i in (0, len(idx) // 2, len(idx) - 1):
        v = tfidf_df.column("tfidf")[i]
        if not (np.array_equal(v.indices, idx[i]) and np.array_equal(v.values, idf32[idx[i]].astype(np.float64))):
            raise AssertionError(f"IDFModel.transform row {i} is not the f32 product")

    premat_k = (O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)

    est = (LogisticRegression().set_features_col("tfidf").set_max_iter(TRAIN_ITERS)
           .set_global_batch_size(TRAIN_BATCH).set_learning_rate(TRAIN_LR).set_tol(0.0))
    for k in premat_k:
        k.reset_launches()
    t0 = time.perf_counter()
    lr_model = est.fit(tfidf_df)
    fit_s = time.perf_counter() - t0
    fit_launches = {k.name: k.launches for k in premat_k}
    if any(n != TRAIN_ITERS for n in fit_launches.values()) or not est.onehot_premat_active:
        raise AssertionError(f"the tf-idf fit did not run the premat crossings each step: {fit_launches}")
    if not est.loss_history[-1] < est.loss_history[0]:
        raise AssertionError(f"tf-idf fit loss does not fall: {est.loss_history[0]} -> {est.loss_history[-1]}")
    # Steady ms/step as in the train phase: SGD on one cache of the tf-idf
    # column (its layout and one-hots built once), two iteration counts
    # differenced; at the fit's schedule its coefficient is the fit's.
    cols = extract_labeled_data(tfidf_df, "tfidf", "label", None, allow_sparse=True)
    dim = cols.pop("dim")
    cache = DeviceDataCache(cols)
    del df, tfidf_df, cols

    def sgd(iters):
        opt = SGD(max_iter=iters, global_batch_size=TRAIN_BATCH, tol=0.0, learning_rate=TRAIN_LR)
        t0 = time.perf_counter()
        coef = opt.optimize(np.zeros(dim, np.float32), cache, BinaryLogisticLoss.INSTANCE)
        return coef, time.perf_counter() - t0

    coef, _ = sgd(TRAIN_ITERS)
    if not np.array_equal(coef.view(np.int32), np.asarray(lr_model.coefficient, np.float32).view(np.int32)):
        raise AssertionError("SGD on the tf-idf cache is not bit-identical to the fit")
    t_runs = [sgd(iters)[1] for iters in STEP_ITERS]
    fit_ms_per_step = (t_runs[1] - t_runs[0]) / (STEP_ITERS[1] - STEP_ITERS[0]) * 1e3
    del cache

    with tempfile.TemporaryDirectory() as tmp:
        idf_model.save(f"{tmp}/idf")
        lr_model.save(f"{tmp}/lr")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/idf"), load_servable(f"{tmp}/lr")])
    if not np.array_equal(pipeline.servables[1].coefficient, lr_model.coefficient):
        raise AssertionError("the loaded coefficient differs from the fitted one")
    coef32 = np.asarray(lr_model.coefficient, np.float32).astype(np.float64)

    # Traffic: new rows of the headline generator under another seed.
    rng = np.random.default_rng(SPARSE_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    hot_sizes = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2, MAX_BATCH // 4]
    sizes[::16] = hot_sizes[: len(sizes[::16])]  # hot keys on every run (4096, 1500, 2048, 1024)
    nnz = [TRAIN_NNZ] * n_req
    short = rng.choice([i for i in range(n_req) if i % 16], n_req // 4, replace=False)
    for j, i in enumerate(short):  # a quarter with 1-38 features: caps 1-32 as well
        nnz[i] = (1, 2, 3, 5, 9, 17, 24, 38)[j % 8]
    payload_ids = [_hashed_rows(rng, n, k) for n, k in zip(sizes, nnz)]
    payloads = [_sparse_frame(ids) for ids in payload_ids]

    def check(i, out):
        ids = payload_ids[i]
        want = idf32[ids]  # value 1.0 × idf: the f32 product
        got = out["tfidf"]
        if len(got) != len(ids):
            raise AssertionError(f"{len(got)} rows back for {len(ids)}")
        for r in range(len(ids)):
            if not (np.array_equal(got[r].indices, ids[r]) and np.array_equal(got[r].values, want[r])):
                raise AssertionError(f"row {r}: tfidf is not the f32 product")
        margin = (want.astype(np.float64) * coef32[ids]).sum(axis=1)
        p = 1.0 / (1.0 + np.exp(-margin))
        np.testing.assert_allclose(out["rawPrediction"], np.stack([1.0 - p, p], axis=1), rtol=0, atol=1e-5)
        decided = np.abs(margin) > PREDICTION_MARGIN
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      (margin >= 0).astype(np.float64)[decided])

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name="chip-smoke-sparse", serving_config=config,
                             warmup_template=payloads[0].take([0]), device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        keys = []  # the key of every batch the plan ingests from here on
        ingest = plan._ingest

        def recording_ingest(segment, df, bucket, cap=None, warm=False):
            got = ingest(segment, df, bucket, cap=cap, warm=warm)
            keys.append(got[1])
            return got

        plan._ingest = recording_ingest
        # The main path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, ("sparse_idf_logistic_plain", "scale_logistic_plain"))
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * n_req
        failures = []

        def client(c):
            for i in range(c, n_req, N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    resp = server.predict(payloads[i])
                    latencies[i] = (time.perf_counter() - t_req) * 1000.0
                    check(i, resp.dataframe)
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            restore()
        if any(th.is_alive() for th in threads):
            raise AssertionError("serve_sparse clients did not finish within 600 s")
        launches = mk.SPARSE_IDF_LOGISTIC.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.SPARSE_IDF_LOGISTIC}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    breakdown = _sparse_batch_breakdown(plan, payloads[sizes.index(MAX_BATCH)], ingest)
    hot = sorted(k for k, kind in kinds.items() if "megakernel" in kind)
    hot_batches = sum(1 for k in keys if k in hot)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the sparse megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(f"sparse megakernel launches {launches} != batches with hot keys {hot_batches}")
    if len(keys) != len(batches):
        raise AssertionError(f"{len(keys)} batches ingested, {len(batches)} executed")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during sparse serving: {other}")
    lat = sorted(latencies)
    result = {
        "dim": TRAIN_DIM, "train_rows": len(idx), "data_s": data_s,
        "idf_fit_s": idf_fit_s, "idf_transform_s": idf_transform_s,
        "lr_fit_s": fit_s, "lr_fit_ms_per_step": fit_ms_per_step, "lr_fit_launches": fit_launches,
        "lr_loss_first": est.loss_history[0], "lr_loss_last": est.loss_history[-1],
        "warmup_s": warmup_s, "warmed_keys": len(kinds),
        "requests": n_req, "rows": sum(sizes),
        "caps_requested": sorted({ladder_cap(k) for k in nnz}),
        "caps_served": sorted({k[1] for k in keys}),
        "batches": len(batches),
        "hot_keys": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "hot_batch_breakdown_ms": breakdown,
    }
    emit("serve_sparse", card=card, **result)
    return launches


def _mlp_inputs(rng, rows, widths, dev):
    """A scaler (zero-std guard included), a He-initialised network with
    small biases, class values and ``rows`` input rows, on ``dev``."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    d = widths[0]
    std = (np.abs(rng.normal(size=d)) + 0.5).astype(np.float32)
    std[0] = 0.0  # the zero-std guard: that feature scales to 0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))
    layers = [(t(rng.normal(size=(a, b)) * np.sqrt(2.0 / a)), t(rng.normal(size=b) * 0.1))
              for a, b in zip(widths[:-1], widths[1:])]
    labels = t(rng.permutation(widths[-1]) + 1.0)
    return t(rng.normal(size=(rows, d))), t(rng.normal(size=d)), t(inv_std), layers, labels


def _top_two_gap(layers, h):
    """The gap between the two largest float32 logits of each row (the
    plain version's products); infinite with one class."""
    import torch

    for W, b in layers[:-1]:
        h = torch.relu(h @ W + b)
    logits = h @ layers[-1][0] + layers[-1][1]
    if logits.shape[1] < 2:
        return torch.full((logits.shape[0],), float("inf"), device=logits.device)
    top = torch.topk(logits, 2, dim=1).values
    return top[:, 0] - top[:, 1]


def phase_kernels_mlp(rng, card: str):
    """The scale → mlp megakernel against its plain version over rows ×
    networks × chains, then its times at the serving shape."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
    from flink_ml_tpu_torch.servable.megakernels import (
        MLP_MAX_CLASSES,
        MLP_MAX_LAYERS,
        MLP_MAX_WIDTH,
        SCALE_MLP,
        scale_mlp,
        scale_mlp_plain,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain and library products in full float32
    envelope = ULP_ENVELOPE["scale_mlp"]
    networks = dict(MLP_CHECK_NETWORKS, limits=(MLP_MAX_WIDTH,) * MLP_MAX_LAYERS + (MLP_MAX_CLASSES,))
    max_abs_err, max_ulps, checked = 0.0, 0, 0
    for rows in MLP_CHECK_ROWS:
        for net, widths in networks.items():
            x, mean, inv_std, layers, labels = _mlp_inputs(rng, rows, widths, dev)
            for label, with_mean, with_std, write_scaled in MLP_CHAINS:
                kw = dict(with_mean=with_mean, with_std=with_std)
                scaled, pred, probs = scale_mlp(x, mean, inv_std, layers, labels,
                                                write_scaled=write_scaled, **kw)
                p_scaled, p_pred, p_probs = scale_mlp_plain(x, mean, inv_std, layers, labels, **kw)
                torch.cuda.synchronize()
                where = f"{label} rows={rows} net={net} with_mean={with_mean} with_std={with_std}"
                if write_scaled:
                    if not torch.equal(scaled, p_scaled):
                        raise AssertionError(f"scaled not bit-equal to the plain version: {where}")
                else:
                    assert scaled is None, where
                ulps = ulp_diff(probs.cpu().numpy(), p_probs.cpu().numpy())
                if ulps > envelope:
                    raise AssertionError(f"probabilities {ulps} ulps > {envelope}: {where}")
                decided = (_top_two_gap(layers, p_scaled) > PREDICTION_MARGIN).cpu().numpy()
                if not np.array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided]):
                    raise AssertionError(
                        f"prediction differs where the top-two logit gap > {PREDICTION_MARGIN}: {where}")
                errs = [(probs - p_probs).abs().max()]
                if write_scaled:
                    errs.append((scaled - p_scaled).abs().max())
                max_abs_err = max(max_abs_err, max(float(e) for e in errs))
                max_ulps = max(max_ulps, ulps)
                checked += 1
    emit("kernels_mlp", kernel=SCALE_MLP.name, configurations=checked, networks=
         {k: list(v) for k, v in networks.items()}, max_abs_err=max_abs_err,
         max_probability_ulps=max_ulps, probability_ulp_envelope=envelope, scaled="bit-equal",
         prediction=f"equal where the plain top-two logit gap > {PREDICTION_MARGIN}")

    rows, widths = MAX_BATCH, MLP_WIDTHS
    x, mean, inv_std, layers, labels = _mlp_inputs(rng, rows, widths, dev)
    kw = dict(with_mean=True, with_std=True)
    scaled = scale_mlp_plain(x, mean, inv_std, layers, labels, **kw)[0]

    def kernel():
        scale_mlp(x, mean, inv_std, layers, labels, write_scaled=True, **kw)

    def plain():
        scale_mlp_plain(x, mean, inv_std, layers, labels, **kw)

    def library():  # the chain's three products only: no single call computes the chain
        h = scaled
        for W, b in layers:
            h = torch.addmm(b, h, W)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for fn in (kernel, plain, library):  # warm-up
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    times = {n: {"cold": [], "warm": []} for n in ("kernel", "plain", "library")}
    for name, fn in (("plain", plain), ("library", library), ("kernel", kernel),
                     ("kernel", kernel), ("library", library), ("plain", plain)):
        times[name]["cold"] += _cold_times(fn, 50, flush)
        times[name]["warm"].append(_warm_time(fn, 100))
    by_rows = {}
    for r in MLP_SMALL_ROWS:
        xr, sr = x[:r].contiguous(), scaled[:r].contiguous()

        def kernel_r():
            scale_mlp(xr, mean, inv_std, layers, labels, write_scaled=True, **kw)

        def library_r():
            h = sr
            for W, b in layers:
                h = torch.addmm(b, h, W)

        by_rows[r] = {"ms_l2_warm": _warm_time(kernel_r, 100),
                      "library_ms_l2_warm": _warm_time(library_r, 100)}
    weights = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    # the three products; the scale, bias, relu and softmax add under 0.3%
    ops = 2 * rows * weights
    bytes_moved = 4 * (2 * rows * widths[0] + weights + sum(widths[1:]) + 2 * widths[0]
                       + widths[-1] + rows * widths[-1] + rows)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timing = {
        "shape": [rows, *widths],
        "ms": _median(times["kernel"]["cold"]),
        "ms_l2_warm": _median(times["kernel"]["warm"]),
        "plain_ms": _median(times["plain"]["cold"]),
        "plain_ms_l2_warm": _median(times["plain"]["warm"]),
        "library_ms": _median(times["library"]["cold"]),
        "library_ms_l2_warm": _median(times["library"]["warm"]),
        "library": "three torch.addmm, float32, TF32 off: the chain's products only",
        "small_batches": by_rows,
        "bytes": bytes_moved,
        "ops": ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit("kernels_mlp", kernel=SCALE_MLP.name, card=card, **timing)
    return {"max_abs_err": max_abs_err, **timing}


def _mlp_population():
    """The population of the MLP rows: per-feature location and spread, and
    a random linear teacher whose argmax over the standardised features is
    the class, so the classes are learnable."""
    import numpy as np

    rng = np.random.default_rng(MLP_SEED)
    d, classes = MLP_WIDTHS[0], MLP_WIDTHS[-1]
    return rng.normal(size=d) * 3.0, np.abs(rng.normal(size=d)) + 0.5, rng.normal(size=(d, classes))


def _mlp_rows(rng, population, rows):
    """``rows`` rows of the population: features [rows, 256] and class values."""
    import numpy as np

    loc, spread, teacher = population
    X = rng.normal(size=(rows, loc.shape[0])) * spread + loc
    return X, np.argmax(((X - loc) / spread) @ teacher, axis=1).astype(np.float64)


def _reference_mlp_fit(X, y_idx, dims, seed, lr, batch, iters, dtype, device):
    """The MLP fit written out plainly in ``dtype``: the same initial draws,
    windows (the tail clamped and its re-read rows weighted 0) and adam
    formula, the gradient of the window's mean loss by autograd. Returns
    the per-epoch mean losses and the ``(W, b)`` layers."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        W = (rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
        params += [torch.tensor(W, dtype=dtype, device=device, requires_grad=True),
                   torch.zeros(b, dtype=dtype, device=device, requires_grad=True)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    X = torch.as_tensor(X, device=device).to(dtype)
    y = torch.as_tensor(y_idx, device=device).long()
    n, offset, losses = X.shape[0], 0, []
    for t in range(1, iters + 1):
        start = min(offset, n - batch)
        w = ((start + torch.arange(batch, device=device)) >= offset).to(dtype)
        h = X[start:start + batch]
        for i in range(0, len(params) - 2, 2):
            h = torch.relu(h @ params[i] + params[i + 1])
        logits = h @ params[-2] + params[-1]
        rows = torch.logsumexp(logits, dim=1) - logits.gather(1, y[start:start + batch, None])[:, 0]
        loss = (rows * w).sum() / w.sum()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                mu[i] = 0.1 * g + 0.9 * mu[i]
                nu[i] = 0.001 * g * g + 0.999 * nu[i]
                p -= lr * (mu[i] / (1 - 0.9 ** t)) / (torch.sqrt(nu[i] / (1 - 0.999 ** t)) + 1e-8)
        losses.append(float(loss.detach()))
        offset = 0 if offset + batch >= n else offset + batch
    return losses, [(params[i].detach(), params[i + 1].detach()) for i in range(0, len(params), 2)]


def _dense_batch_breakdown(plan, df, ingest, reps=5):
    """Where one full-bucket batch's time goes on the plan's path (host
    clock, the device synchronised after each step; median of ``reps``):
    the host gather, the gather and upload, the chain on the card, and the
    readback."""
    import torch

    from flink_ml_tpu_torch.servable.planner import PlanExecution, run_segment

    (segment,) = plan.segments
    steps = {"gather": [], "gather_and_upload": [], "chain": [], "readback": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        segment.gather(df, "features")
        t1 = time.perf_counter()
        inputs, key = ingest(segment, df, len(df))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outputs = run_segment(segment, key, inputs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        PlanExecution(df, segment.pending(outputs)).finalize()
        t4 = time.perf_counter()
        for name, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[name].append(dt * 1e3)
    medians = {name: _median(v) for name, v in steps.items()}
    total = medians["gather_and_upload"] + medians["chain"] + medians["readback"]
    return {"rows": len(df), "key": key, "kinds": list(segment.plan_kinds[key]), **medians,
            "chain_share": medians["chain"] / total}


def phase_serve_mlp(card: str):
    """The MLP classifier trained and served on the card (see the module
    docstring, phase 11)."""
    import tempfile

    import numpy as np
    import torch

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.device import resolve_device
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    dev = resolve_device()
    population = _mlp_population()
    t0 = time.perf_counter()
    X, y = _mlp_rows(np.random.default_rng(MLP_SEED + 10), population, MLP_ROWS)
    df = DataFrame.from_dict({"features": X, "label": y})
    data_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    scaler = (StandardScaler().set_input_col("features").set_output_col("scaled")
              .set_with_mean(True).set_with_std(True).fit(df))
    scaler_fit_s = time.perf_counter() - t0
    X32 = X.astype(np.float32).astype(np.float64)
    # float32 column sums of 100,000 values, then float64: a few float32 ulps
    np.testing.assert_allclose(scaler.mean, X32.mean(axis=0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scaler.std, X32.std(axis=0, ddof=1), rtol=1e-5)
    t0 = time.perf_counter()
    scaled_df = scaler.transform(df)
    scaler_transform_s = time.perf_counter() - t0
    mean32 = np.asarray(scaler.mean, np.float32).astype(np.float64)
    inv_std = np.where(np.asarray(scaler.std, np.float32) == 0, 0.0,
                       1.0 / np.asarray(scaler.std, np.float32)).astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(scaled_df.column("scaled"), (X32 - mean32) * inv_std, rtol=1e-6, atol=1e-6)

    def estimator(compute_type="float32", iters=MLP_ITERS):
        return (MLPClassifier().set_features_col("scaled").set_hidden_layers(*MLP_WIDTHS[1:-1])
                .set_max_iter(iters).set_global_batch_size(MLP_BATCH).set_compute_type(compute_type))

    est = estimator()
    t0 = time.perf_counter()
    model = est.fit(scaled_df)
    fit_s = time.perf_counter() - t0
    est_bf16 = estimator("bfloat16")
    model_bf16 = est_bf16.fit(scaled_df)

    # the float64 twin of the fit, on the card, on the same float32 features
    Xs = scaled_df.vectors("scaled").astype(np.float32)
    classes = np.unique(y)
    y_idx = np.searchsorted(classes, y)
    ref_losses, ref_layers = _reference_mlp_fit(
        Xs, y_idx, list(MLP_WIDTHS), est.get_seed(), est.get_learning_rate(), MLP_BATCH,
        MLP_ITERS, torch.float64, dev)
    holdout_X, _ = _mlp_rows(np.random.default_rng(MLP_SEED + 20), population, MLP_HOLDOUT_ROWS)
    holdout = scaler.transform(DataFrame.from_dict({"features": holdout_X}))
    h = torch.from_numpy(holdout.vectors("scaled").astype(np.float32)).to(dev).double()
    for W, b in ref_layers[:-1]:
        h = torch.relu(h @ W + b)
    ref_probs = torch.softmax(h @ ref_layers[-1][0] + ref_layers[-1][1], dim=1).cpu().numpy()

    def against_reference(losses, probs):
        rel = np.abs(np.asarray(losses) - ref_losses) / np.abs(ref_losses)
        diff = np.abs(probs - ref_probs)
        return {"first_loss_rel": float(rel[0]), "loss_max_rel": float(rel.max()),
                "loss_rel_by_epoch": rel.tolist(), "prob_mean_abs": float(diff.mean()),
                "prob_max_abs": float(diff.max())}

    def within(dev):
        return (dev["first_loss_rel"] <= FIT_FIRST_LOSS_RTOL and dev["loss_max_rel"] <= FIT_LOSS_RTOL
                and dev["prob_mean_abs"] <= FIT_PROB_MEAN_ATOL)

    f32_dev = against_reference(est.loss_history, model.transform(holdout).column("rawPrediction"))
    bf16_dev = against_reference(est_bf16.loss_history, model_bf16.transform(holdout).column("rawPrediction"))
    # the float32 floor: the plain fit of the same schedule in float32
    floor_losses, floor_layers = _reference_mlp_fit(
        Xs, y_idx, list(MLP_WIDTHS), est.get_seed(), est.get_learning_rate(), MLP_BATCH,
        MLP_ITERS, torch.float32, dev)
    h = torch.from_numpy(holdout.vectors("scaled").astype(np.float32)).to(dev)
    for W, b in floor_layers[:-1]:
        h = torch.relu(h @ W + b)
    floor_dev = against_reference(
        floor_losses, torch.softmax(h @ floor_layers[-1][0] + floor_layers[-1][1], dim=1).cpu().numpy())
    fit_check = {
        "loss_history": est.loss_history, "loss_history_float64": ref_losses,
        "loss_history_bf16": est_bf16.loss_history, "loss_history_plain_float32": floor_losses,
        "float32_vs_float64": f32_dev, "bf16_vs_float64": bf16_dev,
        "plain_float32_vs_float64": floor_dev,
        "tolerance": {"first_loss_rel": FIT_FIRST_LOSS_RTOL, "loss_max_rel": FIT_LOSS_RTOL,
                      "prob_mean_abs": FIT_PROB_MEAN_ATOL},
    }
    emit("serve_mlp", card=card, fit_check=fit_check)  # before the gates, so a failure shows its numbers
    if len(est.loss_history) != MLP_ITERS:
        raise AssertionError(f"the fit ran {len(est.loss_history)} epochs, expected {MLP_ITERS}")
    if not within(f32_dev):
        raise AssertionError(f"the float32 fit is off its float64 twin: {f32_dev}")
    if within(bf16_dev):
        raise AssertionError(f"the bfloat16 control lies inside the float64 tolerance: {bf16_dev}")

    # steady ms/epoch: two iteration counts on one cache, differenced
    cache = DeviceDataCache({"x": Xs, "y": y_idx.astype(np.float32),
                             "w": np.ones(len(Xs), np.float32)})
    deltas = []
    for _ in range(3):
        spans = []
        for iters in MLP_EPOCH_ITERS:
            t0 = time.perf_counter()
            estimator(iters=iters).fit_cache(cache, classes)  # ends in a readback
            spans.append(time.perf_counter() - t0)
        deltas.append((spans[1] - spans[0]) / (MLP_EPOCH_ITERS[1] - MLP_EPOCH_ITERS[0]) * 1e3)
    fit_ms_per_epoch = _median(deltas)
    fit_profile = _profile_steps(lambda: estimator(iters=PROFILE_ITERS).fit_cache(cache, classes))
    del cache, Xs, scaled_df

    with tempfile.TemporaryDirectory() as tmp:
        scaler.save(f"{tmp}/scaler")
        model.save(f"{tmp}/mlp")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/scaler"), load_servable(f"{tmp}/mlp")])
    layers64 = [(np.asarray(W, np.float32).astype(np.float64), np.asarray(b, np.float32).astype(np.float64))
                for W, b in model.params]
    for (W, b), (lW, lb) in zip(model.params, pipeline.servables[1].layers):
        if not (np.array_equal(W, lW) and np.array_equal(b, lb)):
            raise AssertionError("the loaded network differs from the fitted one")
    labels = np.asarray(model.labels)

    rng = np.random.default_rng(MLP_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    sizes[::16] = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2, 1][: len(sizes[::16])]
    payloads = [_mlp_rows(rng, population, n)[0] for n in sizes]

    def check(i, out):
        scaled = (payloads[i].astype(np.float32).astype(np.float64) - mean32) * inv_std
        np.testing.assert_allclose(out["scaled"], scaled, rtol=1e-6, atol=1e-6)
        h = scaled
        for W, b in layers64[:-1]:
            h = np.maximum(h @ W + b, 0.0)
        logits = h @ layers64[-1][0] + layers64[-1][1]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        np.testing.assert_allclose(out["rawPrediction"], e / e.sum(axis=1, keepdims=True), rtol=0, atol=1e-5)
        top = np.sort(logits, axis=1)
        decided = top[:, -1] - top[:, -2] > PREDICTION_MARGIN
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      labels[np.argmax(logits, axis=1)][decided])

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name="chip-smoke-mlp", serving_config=config,
                             warmup_template=DataFrame.from_dict({"features": payloads[0][:1]}),
                             device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        ingest = plan._ingest
        # The main path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, ("scale_mlp_plain", "scale_logistic_plain",
                                                 "sparse_idf_logistic_plain"))
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * n_req
        failures = []

        def client(c):
            for i in range(c, n_req, N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    resp = server.predict(DataFrame.from_dict({"features": payloads[i]}))
                    latencies[i] = (time.perf_counter() - t_req) * 1000.0
                    check(i, resp.dataframe)
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            restore()
        if any(th.is_alive() for th in threads):
            raise AssertionError("serve_mlp clients did not finish within 600 s")
        launches = mk.SCALE_MLP.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.SCALE_MLP}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    breakdown = _dense_batch_breakdown(
        plan, DataFrame.from_dict({"features": payloads[sizes.index(MAX_BATCH)]}), ingest)
    hot = sorted(b for b, kind in kinds.items() if "megakernel" in kind)
    if hot != [b for b in kinds if b >= 2]:
        raise AssertionError(f"hot buckets {hot}: the cost model should mark every bucket from 2 rows")
    hot_batches = sum(1 for _, bucket in batches if bucket >= 2)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the MLP megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(f"MLP megakernel launches {launches} != batches of bucket >= 2 {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during MLP serving: {other}")
    lat = sorted(latencies)
    result = {
        "train_rows": MLP_ROWS, "widths": list(MLP_WIDTHS), "data_s": data_s,
        "scaler_fit_s": scaler_fit_s, "scaler_transform_s": scaler_transform_s,
        "fit_s": fit_s, "fit_ms_per_epoch": fit_ms_per_epoch, "fit_profile": fit_profile,
        "loss_first": est.loss_history[0], "loss_last": est.loss_history[-1],
        "warmup_s": warmup_s, "warmed_buckets": len(kinds),
        "requests": n_req, "rows": sum(sizes),
        "batches": len(batches),
        "hot_buckets": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "hot_batch_breakdown_ms": breakdown,
    }
    emit("serve_mlp", card=card, **result)
    return launches


def _kmeans_distances64(measure, X, C):
    """Float64 distances [rows, k] of ``X`` to ``C`` on their device, in the
    measure's direct form (``torch.cdist`` for euclidean and manhattan)."""
    import torch

    X, C = X.double(), C.double()
    if measure == "euclidean":
        return torch.cdist(X, C)
    if measure == "manhattan":
        return torch.cdist(X, C, p=1)
    return 1.0 - (X @ C.T) / X.norm(dim=1, keepdim=True) / C.norm(dim=1)[None, :]


def _kmeans_decided(dist):
    """Rows of float64 distances whose top-two gap exceeds KMEANS_MARGIN; a
    row with a NaN distance is decided (the first NaN wins)."""
    import torch

    nan = torch.isnan(dist).any(dim=1)
    if dist.shape[1] < 2:
        return torch.ones_like(nan)
    top = torch.topk(torch.nan_to_num(dist, nan=0.0), 2, dim=1, largest=False).values
    return nan | (top[:, 1] - top[:, 0] > KMEANS_MARGIN)


def _same_bits(a, b):
    """Bit-equal, a NaN matching any NaN (its payload aside)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.masked_fill(na, 0.0).view(torch.int32), b.masked_fill(nb, 0.0).view(torch.int32)))


def _kmeans_inputs(rng, rows, d, k, dev):
    """Uniform [0, 1) rows (the published generator's kind), a scaler with
    the zero-std guard, and centroids drawn as scaled rows of the same
    population — so the distances concentrate as a fitted model's do."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    mean = (rng.random(d) * 0.5).astype(np.float32)
    std = (rng.random(d) * 0.3 + 0.2).astype(np.float32)
    std[0] = 0.0  # the zero-std guard: that feature scales to 0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std)).astype(np.float32)
    C = (rng.random((k, d)).astype(np.float32) - mean) * inv_std
    return t(rng.random((rows, d))), t(mean), t(inv_std), t(C)


def _kmeans_grid(rng, dev):
    """The kmeans megakernel (``scale_kmeans`` on ``dev``) against its plain
    version over rows × d × k × measure × chain: scaled bit-equal, the
    prediction equal on every row whose float64 top-two gap exceeds the
    margin. A NaN feature (row 1), a row equal to the mean (row 2: zero
    after centring, NaN under cosine) and a duplicate centroid (the last
    equals centroid 1, so ties take the first index) are in every grid
    cell that has room for them. Returns the totals."""
    import torch

    from flink_ml_tpu_torch.servable.megakernels import scale_kmeans, scale_kmeans_plain

    checked, inside, compared, max_abs_err = 0, 0, 0, 0.0
    for rows in KMEANS_CHECK_ROWS:
        for d in KMEANS_CHECK_DIMS:
            for k in KMEANS_CHECK_KS:
                x, mean, inv_std, C = _kmeans_inputs(rng, rows, d, k, dev)
                if rows >= 7:
                    x[1, d // 2] = float("nan")
                    x[2] = mean
                distinct = k
                if k >= 3:
                    C[k - 1] = C[1]
                    distinct = k - 1
                for measure in KMEANS_MEASURES:
                    for label, with_mean, with_std, write_scaled in KMEANS_CHAINS:
                        kw = dict(measure=measure, with_mean=with_mean, with_std=with_std)
                        scaled, pred = scale_kmeans(x, mean, inv_std, C, write_scaled=write_scaled, **kw)
                        p_scaled, p_pred = scale_kmeans_plain(x, mean, inv_std, C, **kw)
                        where = f"{label} {measure} rows={rows} d={d} k={k} " \
                                f"with_mean={with_mean} with_std={with_std}"
                        if write_scaled:
                            if not _same_bits(scaled, p_scaled):
                                raise AssertionError(f"scaled not bit-equal to the plain version: {where}")
                            max_abs_err = max(max_abs_err, float(torch.nan_to_num(scaled - p_scaled).abs().max()))
                        elif scaled is not None:
                            raise AssertionError(f"scaled written though not asked for: {where}")
                        if pred.dtype != torch.int32 or tuple(pred.shape) != (rows,):
                            raise AssertionError(f"prediction {pred.dtype} {tuple(pred.shape)}: {where}")
                        decided = _kmeans_decided(_kmeans_distances64(measure, p_scaled, C[:distinct]))
                        bad = int(((pred != p_pred) & decided).sum())
                        if bad:
                            raise AssertionError(f"{bad} predictions differ outside the margin: {where}")
                        if rows >= 7 and not (pred[1] == 0 and p_pred[1] == 0):
                            raise AssertionError(f"a NaN row is not assigned index 0: {where}")
                        diff = (pred.long() - p_pred.long()).abs()[decided]
                        if diff.numel():
                            max_abs_err = max(max_abs_err, float(diff.max()))
                        inside += int((~decided).sum())
                        compared += int(decided.sum())
                        checked += 1
    return {"configurations": checked, "rows_compared": compared, "rows_inside_margin": inside,
            "max_abs_err": max_abs_err}


def phase_kernels_kmeans(rng, card: str):
    """The scale → kmeans megakernel against its plain version over the grid
    (``_kmeans_grid``), then its times at the serving shape."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.servable.megakernels import SCALE_KMEANS, scale_kmeans, scale_kmeans_plain

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain and library products in full float32
    grid = _kmeans_grid(rng, dev)
    emit("kernels_kmeans", kernel=SCALE_KMEANS.name, **grid,
         grid={"rows": list(KMEANS_CHECK_ROWS), "d": list(KMEANS_CHECK_DIMS), "k": list(KMEANS_CHECK_KS),
               "measures": list(KMEANS_MEASURES), "chains": [c[:3] for c in KMEANS_CHAINS]},
         scaled="bit-equal", prediction=f"equal where the float64 top-two distance gap > {KMEANS_MARGIN}")

    rows, d, k = MAX_BATCH, KMEANS_D, KMEANS_K
    x, mean, inv_std, C = _kmeans_inputs(rng, rows, d, k, dev)
    kw = dict(measure="euclidean", with_mean=True, with_std=True)
    scaled = scale_kmeans_plain(x, mean, inv_std, C, **kw)[0]

    def kernel():
        scale_kmeans(x, mean, inv_std, C, write_scaled=True, **kw)

    def plain():
        scale_kmeans_plain(x, mean, inv_std, C, **kw)

    def head():  # the assignment alone, on the scaled rows: the library call's work
        scale_kmeans(scaled, None, None, C, measure="euclidean", with_mean=False, with_std=False,
                     write_scaled=False)

    def library():  # the head alone: no single call computes the chain
        torch.argmin(torch.cdist(scaled, C), dim=1)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for fn in (kernel, plain, head, library):  # warm-up
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    names = ("kernel", "plain", "head", "library")
    times = {n: {"cold": [], "warm": []} for n in names}
    for name, fn in (("plain", plain), ("library", library), ("head", head), ("kernel", kernel),
                     ("kernel", kernel), ("head", head), ("library", library), ("plain", plain)):
        times[name]["cold"] += _cold_times(fn, 100, flush)
        times[name]["warm"].append(_warm_time(fn, 200))
    by_measure = {}
    for measure in KMEANS_MEASURES:
        def kernel_m():
            scale_kmeans(x, mean, inv_std, C, measure=measure, with_mean=True, with_std=True,
                         write_scaled=True)
        by_measure[measure] = _warm_time(kernel_m, 200)
    bytes_moved = 4 * (rows * d + rows * d + rows + k * d + 2 * d)  # x, scaled, index, centroids, mean/inv_std
    # sub, mul and the row's |h|^2 FMA per element; a dot FMA per element and
    # centroid plus add, sub, mul, compare, sqrt per distance; |c|^2 once
    ops = 4 * rows * d + rows * k * (2 * d + 5) + 2 * k * d
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timing = {
        "shape": {"rows": rows, "d": d, "k": k, "measure": "euclidean", "with_mean": True, "with_std": True},
        "ms": _median(times["kernel"]["cold"]),
        "ms_l2_warm": _median(times["kernel"]["warm"]),
        "plain_ms": _median(times["plain"]["cold"]),
        "plain_ms_l2_warm": _median(times["plain"]["warm"]),
        "head_alone_ms": _median(times["head"]["cold"]),
        "head_alone_ms_l2_warm": _median(times["head"]["warm"]),
        "library_ms": _median(times["library"]["cold"]),
        "library_ms_l2_warm": _median(times["library"]["warm"]),
        "library": "torch.cdist + torch.argmin on the scaled rows: the head only (hold it against head_alone)",
        "ms_l2_warm_by_measure": by_measure,
        "bytes": bytes_moved,
        "ops": ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit("kernels_kmeans", kernel=SCALE_KMEANS.name, card=card, **timing)
    return {"max_abs_err": grid["max_abs_err"], **timing}


def _kmeans_published_rows():
    """The published rows: DenseVectorGenerator(seed 2) — uniform [0, 1),
    100,000 × 100, float64 as the generator makes them."""
    import numpy as np

    return np.random.default_rng(KMEANS_DATA_SEED).random((KMEANS_ROWS, KMEANS_D))


def _kmeans_epoch_check(X, init, measure, epochs, control=None):
    """Replay ``epochs`` epochs of the port's fit (``_epoch_update``) from
    ``init`` on ``X`` (float32, on the card) — with ``control`` applied to the
    features first, if given — and hold each epoch against float64 from its
    own starting centroids: assignments equal to the float64 argmin wherever
    the gap exceeds the margin, counts equal to its assignment's, and the new
    centroids within KMEANS_CENTROID_ATOL of the float64 means of the exact
    features over its assignment. Returns ``(final centroids, per-epoch
    readings, whether every epoch passed)``."""
    import torch

    from flink_ml_tpu_torch.models.clustering.kmeans import _epoch_update
    from flink_ml_tpu_torch.ops.distance import DistanceMeasure

    m = DistanceMeasure.get_instance(measure)
    k = int(init.shape[0])
    X64 = X.double()
    feats = X if control is None else control(X)
    mask = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    c, readings, ok = init, [], True
    for _ in range(epochs):
        new, counts = _epoch_update(m, k, c, feats, mask)
        assign = m.find_closest(feats, c)
        dist = _kmeans_distances64(measure, X64, c)
        decided = _kmeans_decided(dist)
        mismatched = int(((assign != torch.argmin(dist, dim=1)) & decided).sum())
        hot = (assign[:, None] == torch.arange(k, device=X.device)).double()
        n_assigned = hot.sum(dim=0)
        means = torch.where(n_assigned[:, None] > 0, (hot.T @ X64) / n_assigned.clamp_min(1.0)[:, None],
                            c.double())
        err = float((new.double() - means).abs().max())
        counts_equal = bool(torch.equal(counts.double(), n_assigned))
        readings.append({"mismatched": mismatched, "inside_margin": int((~decided).sum()),
                         "centroid_err": err, "counts_equal": counts_equal})
        ok = ok and mismatched == 0 and err <= KMEANS_CENTROID_ATOL and counts_equal
        c = new
    return c, readings, ok


def phase_fit_kmeans(card: str):
    """KMeans.fit on the published config (module docstring, phase 13)."""
    import numpy as np
    import torch

    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.device import resolve_device
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

    dev = resolve_device()
    t0 = time.perf_counter()
    X = _kmeans_published_rows()
    df = DataFrame.from_dict({"features": X})
    data_s = time.perf_counter() - t0

    def estimator(iters=KMEANS_ITERS):
        return KMeans().set_k(KMEANS_K).set_max_iter(iters)

    est = estimator()
    t0 = time.perf_counter()
    model = est.fit(df)
    fit_s = time.perf_counter() - t0
    again = estimator().fit(df)
    if not (np.array_equal(again.centroids, model.centroids) and np.array_equal(again.weights, model.weights)):
        raise AssertionError("two fits of the same rows differ")
    if model.weights.sum() != KMEANS_ROWS or model.centroids.shape != (KMEANS_K, KMEANS_D):
        raise AssertionError(f"fit shapes {model.centroids.shape}, weights sum {model.weights.sum()}")

    # each epoch against float64 from the port's own centroids of that epoch
    X32 = torch.from_numpy(X.astype(np.float32)).to(dev)
    pick = np.random.default_rng(est.get_seed()).choice(KMEANS_ROWS, size=KMEANS_K, replace=False)
    init = X32[torch.from_numpy(pick).to(dev)]
    final, readings, ok = _kmeans_epoch_check(X32, init, est.get_distance_measure(), KMEANS_ITERS)
    if not np.array_equal(final.cpu().numpy().astype(np.float64), model.centroids):
        raise AssertionError("the replayed epochs do not land on the fitted centroids")
    _, control, control_ok = _kmeans_epoch_check(
        X32, init, est.get_distance_measure(), KMEANS_ITERS,
        control=lambda a: a.to(torch.bfloat16).to(torch.float32))
    fit_check = {
        "epochs": readings, "control_bf16_features": control,
        "margin": KMEANS_MARGIN, "centroid_atol": KMEANS_CENTROID_ATOL,
    }
    emit("fit_kmeans", card=card, fit_check=fit_check)  # before the gates, so a failure shows its numbers
    if not ok:
        raise AssertionError(f"the fit's epochs are off float64: {readings}")
    if control_ok:
        raise AssertionError(f"the bfloat16-feature control passes the float64 check: {control}")

    # steady ms/epoch: two epoch counts on one cache, differenced
    cache = DeviceDataCache({"x": X.astype(np.float32)})
    deltas = []
    for _ in range(3):
        spans = []
        for iters in KMEANS_EPOCH_ITERS:
            t0 = time.perf_counter()
            estimator(iters).fit_cache(cache)  # ends in a readback
            spans.append(time.perf_counter() - t0)
        deltas.append((spans[1] - spans[0]) / (KMEANS_EPOCH_ITERS[1] - KMEANS_EPOCH_ITERS[0]) * 1e3)
    profile = _profile_steps(lambda: estimator(PROFILE_ITERS).fit_cache(cache))
    del cache, X32
    result = {
        "rows": KMEANS_ROWS, "d": KMEANS_D, "k": KMEANS_K, "max_iter": KMEANS_ITERS,
        "measure": est.get_distance_measure(), "seed": est.get_seed(),
        "data_s": data_s, "fit_s": fit_s,
        "ms_per_epoch": _median(deltas), "ms_per_epoch_runs": deltas, "fit_profile": profile,
        # the trace's device time per epoch against the untraced epoch time:
        # the profiler's own host work stretches the traced wall clock
        "idle_share_steady": 1.0 - profile["device_busy_ms"] / PROFILE_ITERS / _median(deltas),
        "weights": model.weights.tolist(),
        "inside_margin_by_epoch": [r["inside_margin"] for r in readings],
        "max_centroid_err": max(r["centroid_err"] for r in readings),
        "control_mismatched_by_epoch": [r["mismatched"] for r in control],
    }
    emit("fit_kmeans", card=card, **result)


def phase_serve_kmeans(card: str):
    """StandardScaler → KMeans fitted, saved, loaded and served (module
    docstring, phase 14)."""
    import tempfile

    import numpy as np

    import flink_ml_tpu_torch.servable.megakernels as mk
    from flink_ml_tpu_torch.api.dataframe import DataFrame
    from flink_ml_tpu_torch.metrics import MLMetrics, metrics
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler
    from flink_ml_tpu_torch.native import KERNELS
    from flink_ml_tpu_torch.servable import PipelineModelServable, load_servable
    from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    X = _kmeans_published_rows()
    df = DataFrame.from_dict({"features": X})
    t0 = time.perf_counter()
    scaler = (StandardScaler().set_input_col("features").set_output_col("scaled")
              .set_with_mean(True).set_with_std(True).fit(df))
    scaled_df = scaler.transform(df)
    model = KMeans().set_features_col("scaled").set_k(KMEANS_K).set_max_iter(KMEANS_ITERS).fit(scaled_df)
    fit_s = time.perf_counter() - t0
    del scaled_df
    with tempfile.TemporaryDirectory() as tmp:
        scaler.save(f"{tmp}/scaler")
        model.save(f"{tmp}/kmeans")
        pipeline = PipelineModelServable([load_servable(f"{tmp}/scaler"), load_servable(f"{tmp}/kmeans")])
    if not np.array_equal(pipeline.servables[1].centroids, model.centroids):
        raise AssertionError("the loaded centroids differ from the fitted ones")
    mean32 = np.asarray(scaler.mean, np.float32).astype(np.float64)
    inv_std = pipeline.servables[0]._inv_std().astype(np.float64)
    C64 = np.asarray(model.centroids, np.float32).astype(np.float64)

    rng = np.random.default_rng(KMEANS_SERVE_SEED)
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    sizes = [int(min(MAX_BATCH, max(1, round(2 ** rng.uniform(0, 12))))) for _ in range(n_req)]
    sizes[::16] = [MAX_BATCH, MAX_BATCH * 1500 // 4096, MAX_BATCH // 2,
                   MAX_BATCH * 600 // 4096][: len(sizes[::16])]  # hot buckets on every run
    payloads = [rng.random((n, KMEANS_D)) for n in sizes]
    inside = [0] * n_req

    def check(i, out):
        scaled = (payloads[i].astype(np.float32).astype(np.float64) - mean32) * inv_std
        np.testing.assert_allclose(out["scaled"], scaled, rtol=1e-6, atol=1e-6)
        dist = np.sqrt(((scaled[:, None, :] - C64[None, :, :]) ** 2).sum(-1))
        top = np.sort(dist, axis=1)
        decided = top[:, 1] - top[:, 0] > KMEANS_MARGIN
        inside[i] = int((~decided).sum())
        np.testing.assert_array_equal(np.asarray(out["prediction"])[decided],
                                      np.argmin(dist, axis=1).astype(np.float64)[decided])

    config = ServingConfig(max_batch_size=MAX_BATCH, queue_capacity_rows=4 * MAX_BATCH, fusion_mode="fast")
    t0 = time.perf_counter()
    server = InferenceServer(pipeline, name="chip-smoke-kmeans", serving_config=config,
                             warmup_template=DataFrame.from_dict({"features": payloads[0][:1]}),
                             device="cuda")
    warmup_s = time.perf_counter() - t0
    scope = server.scope
    with server:
        plan = pipeline._fastpath_plan
        kinds = chain_kinds(plan)
        ingest = plan._ingest
        # The main path's run starts here: counts to 0, then traffic.
        for k in KERNELS:
            k.reset_launches()
        plain_calls, restore = _count_calls(mk, ("scale_kmeans_plain", "scale_mlp_plain",
                                                 "scale_logistic_plain", "sparse_idf_logistic_plain"))
        batches_before = len(server.executed_batch_sizes)
        fallback_before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0)
        compiles_before = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0)
        latencies = [None] * n_req
        failures = []

        def client(c):
            for i in range(c, n_req, N_CLIENTS):
                t_req = time.perf_counter()
                try:
                    resp = server.predict(DataFrame.from_dict({"features": payloads[i]}))
                    latencies[i] = (time.perf_counter() - t_req) * 1000.0
                    check(i, resp.dataframe)
                except BaseException as e:  # noqa: BLE001 — reported below, fails the run
                    failures.append(f"request {i} ({sizes[i]} rows): {type(e).__name__}: {e}")

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            restore()
        if any(th.is_alive() for th in threads):
            raise AssertionError("serve_kmeans clients did not finish within 600 s")
        launches = mk.SCALE_KMEANS.launches
        other = {k.name: k.launches for k in KERNELS if k is not mk.SCALE_KMEANS}
        batches = server.executed_batch_sizes[batches_before:]
    if failures:
        raise AssertionError(f"{len(failures)} responses failed: {failures[:5]}")
    breakdown = _dense_batch_breakdown(
        plan, DataFrame.from_dict({"features": payloads[sizes.index(MAX_BATCH)]}), ingest)
    hot = sorted(b for b, kind in kinds.items() if "megakernel" in kind)
    if hot != [b for b in kinds if b >= KMEANS_HOT_FROM]:
        raise AssertionError(
            f"hot buckets {hot}: the cost model should mark every bucket from {KMEANS_HOT_FROM} rows")
    hot_batches = sum(1 for _, bucket in batches if bucket >= KMEANS_HOT_FROM)
    fallback = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) - fallback_before
    compiles = metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) - compiles_before
    if not launches > 0:
        raise AssertionError("the kmeans megakernel never launched on the main path")
    if launches != hot_batches:
        raise AssertionError(
            f"kmeans megakernel launches {launches} != batches of bucket >= {KMEANS_HOT_FROM} {hot_batches}")
    if fallback != 0:
        raise AssertionError(f"{fallback} batches fell back to the per-stage path")
    if compiles != 0:
        raise AssertionError(f"{compiles} chains were built after warmup")
    if plain_calls:
        raise AssertionError(f"plain megakernel versions were called: {sorted(set(plain_calls))}")
    if any(other.values()):
        raise AssertionError(f"other kernels launched during KMeans serving: {other}")
    lat = sorted(latencies)
    result = {
        "fit_rows": KMEANS_ROWS, "d": KMEANS_D, "k": KMEANS_K, "fit_s": fit_s,
        "warmup_s": warmup_s, "warmed_buckets": len(kinds),
        "requests": n_req, "rows": sum(sizes), "rows_inside_margin": sum(inside),
        "batches": len(batches),
        "hot_buckets": hot,
        "hot_batches": hot_batches,
        "megakernel_launches": launches,
        "fallback_batches": fallback,
        "post_warmup_builds": compiles,
        "plain_calls": len(plain_calls),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rows_per_s": sum(sizes) / wall,
        "wall_s": wall,
        "hot_batch_breakdown_ms": breakdown,
    }
    emit("serve_kmeans", card=card, **result)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    from flink_ml_tpu_torch.native import KERNELS
    import flink_ml_tpu_torch.linalg.onehot_sparse  # noqa: F401 — defines the crossing kernels
    import flink_ml_tpu_torch.servable.megakernels  # noqa: F401 — defines the serving megakernels
    from flink_ml_tpu_torch.servable.megakernels import (
        SCALE_KMEANS,
        SCALE_LOGISTIC,
        SCALE_MLP,
        SPARSE_IDF_LOGISTIC,
    )

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    kernels = list(KERNELS)
    phase_build(kernels)
    rng = np.random.default_rng(SEED)
    measured = {SCALE_LOGISTIC.name: phase_kernels(rng, smi)}
    launches = {SCALE_LOGISTIC.name: phase_serve(rng, smi)}
    grid_errs = phase_crossings_grid(rng, smi)
    headline = _headline_data()
    cache, train_launches = phase_train(smi, headline)
    launches.update(train_launches)
    measured.update(phase_crossings_headline(cache, smi))
    del cache
    torch.cuda.empty_cache()
    measured[SPARSE_IDF_LOGISTIC.name] = phase_kernels_sparse(rng, smi, headline[0])
    launches[SPARSE_IDF_LOGISTIC.name] = phase_serve_sparse(smi, headline)
    del headline
    measured[SCALE_MLP.name] = phase_kernels_mlp(rng, smi)
    launches[SCALE_MLP.name] = phase_serve_mlp(smi)
    torch.cuda.empty_cache()
    measured[SCALE_KMEANS.name] = phase_kernels_kmeans(rng, smi)
    phase_fit_kmeans(smi)
    launches[SCALE_KMEANS.name] = phase_serve_kmeans(smi)
    lines = []
    for kernel in kernels:
        m = measured[kernel.name]
        lines.append({
            "name": kernel.name,
            "route": "cuda",
            "source": kernel.source_path,
            "replaces": kernel.replaces,
            "launches": launches[kernel.name],
            "max_abs_err": max(m["max_abs_err"], grid_errs.get(kernel.name, 0.0)),
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
        if not launches[kernel.name] > 0:
            raise AssertionError(f"{kernel.name} was never launched on its path")
    if len(lines) != 8:
        raise AssertionError(f"{len(lines)} kernels registered, expected 8")
    emit("done", seconds=time.perf_counter() - t_start, power_limit_line=smi)
    print(json.dumps({"kernels": lines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # noqa: BLE001 — any failure: traceback, nonzero exit, no result line
        traceback.print_exc()
        code = 1
    sys.exit(code)
