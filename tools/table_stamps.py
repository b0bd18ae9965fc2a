"""Where the scale → kmeans and row-local table kernels' time goes, block by
block: copies of ``csrc/megakernel_scale_kmeans.cu`` and
``csrc/megakernel_rowlocal.cu`` with ``%globaltimer`` stamps at each block's
start, after its staging barrier, after its centroid norms and at the end of
each of its warps, built beside the package's own libraries and launched
through ``scale_kmeans`` and ``rowlocal_chain`` at 4096 rows: scale → kmeans
and the head alone (d 100, k 10), feature6 → logistic, normalize alone,
normalize → kmeans and the 15-column impute.

    python3 tools/table_stamps.py [--tree PATH] [--out build/table_stamps.jsonl]

``--tree`` stamps another tree's sources and launches them through that
tree's package (a tree whose kernels walk one warp a row, without the
staging barrier, gets only the start, norms and end stamps). Prints one JSON
line per case and cache state (warm: the 20th of 20 runs; cold: after a
256 MB flush): the blocks, the kernel's span from the first block's start
to the last warp's end, the quartiles over blocks of their start (from the
first), of the staging (start to barrier), the norms and the rows (to the
block's last warp end), block 0's first thread's times at the row-local
kernel's staging steps and at each op of its first task (``block0_us``),
and the card. The stamps cost a store each; read the times as shares, not
as the kernel's speed. Needs one card and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

STAMPS = r'''
__device__ unsigned long long g_stamps[16384][12];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(slot) do { if (threadIdx.x == 0) g_stamps[blockIdx.x][slot] = gtime(); } while (0)
#define WARP_END() do { if ((threadIdx.x & 31) == 0) g_stamps[blockIdx.x][3 + threadIdx.x / 32] = gtime(); } while (0)
__device__ unsigned long long g_ops[16384][40];
#define OP_STAMP(slot) do { if (threadIdx.x == 0) g_ops[blockIdx.x][slot] = gtime(); } while (0)
'''

DUMP = r'''
extern "C" int dump_stamps(void* host, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(unsigned long long) * 12 * blocks));
}
extern "C" int dump_ops(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_ops, sizeof(unsigned long long) * 40));
}
extern "C" int reset_stamps() {
  void* p = nullptr;
  cudaError_t rc = cudaGetSymbolAddress(&p, g_stamps);
  if (rc == cudaSuccess) rc = cudaMemset(p, 0, sizeof(g_stamps));
  if (rc == cudaSuccess) rc = cudaGetSymbolAddress(&p, g_ops);
  if (rc == cudaSuccess) rc = cudaMemset(p, 0, sizeof(g_ops));
  return static_cast<int>(rc);
}
'''

# (anchor, the same text with its stamps): this tree's persistent kernels
EDITS = {
    "megakernel_scale_kmeans.cu": [
        ("  if (with_mean) rowlocal::stage(s_mean", "  STAMP(0);\n  if (with_mean) rowlocal::stage(s_mean"),
        ("  cp_async_wait<0>();\n  __syncthreads();\n  if (kMeasure != kManhattan) {",
         "  cp_async_wait<0>();\n  __syncthreads();\n  STAMP(1);\n  if (kMeasure != kManhattan) {"),
        ("  for (; task < n_tasks; task += step) {", "  STAMP(2);\n  for (; task < n_tasks; task += step) {"),
        ("    __syncwarp();  // the strips are read before the next task rewrites them\n  }\n}",
         "    __syncwarp();  // the strips are read before the next task rewrites them\n  }\n  WARP_END();\n}"),
    ],
    "megakernel_rowlocal.cu": [
        ("  stage_vectors(table, smem, warp, n_warps, lane);", "  STAMP(0);\n  stage_vectors(table, smem, warp, n_warps, lane);"),
        ("  cp_async_wait<1>();  // the model\n  __syncthreads();\n  if (kWithKmeans) {",
         "  cp_async_wait<1>();  // the model\n  __syncthreads();\n  STAMP(1);\n  if (kWithKmeans) {"),
        ("    dense_norms(ops, n_ops, smem, warp, n_warps, lane);\n    __syncthreads();\n  }\n",
         "    dense_norms(ops, n_ops, smem, warp, n_warps, lane);\n    __syncthreads();\n  }\n  STAMP(2);\n"),
        ("    __syncwarp();  // every lane is done with the region before the next copies\n  }\n}",
         "    __syncwarp();  // every lane is done with the region before the next copies\n  }\n  WARP_END();\n}"),
    ],
}
# a tree whose kernels walk one warp a row
EDITS_WARP_A_ROW = {
    "megakernel_scale_kmeans.cu": [
        ("  if (kMeasure != kManhattan) {\n    rowlocal::centroid_norms(",
         "  STAMP(0);\n  if (kMeasure != kManhattan) {\n    rowlocal::centroid_norms("),
        ("  for (int row = blockIdx.x * kRowsPerBlock + warp; row < rows;",
         "  STAMP(2);\n  for (int row = blockIdx.x * kRowsPerBlock + warp; row < rows;"),
        ("    if (lane == 0) prediction[row] = best_idx;\n  }\n}",
         "    if (lane == 0) prediction[row] = best_idx;\n  }\n  WARP_END();\n}"),
    ],
    "megakernel_rowlocal.cu": [
        ("  if (with_norms) {\n    table_norms(", "  STAMP(0);\n  if (with_norms) {\n    table_norms("),
        ("  for (int row = blockIdx.x * kRowsPerBlock + warp; row < rows;",
         "  STAMP(2);\n  for (int row = blockIdx.x * kRowsPerBlock + warp; row < rows;"),
        ("    run_row<kSlots>(table, 0, table.n_ops, row, lane, v, norms, strips[warp]);\n  }\n}",
         "    run_row<kSlots>(table, 0, table.n_ops, row, lane, v, norms, strips[warp]);\n  }\n  WARP_END();\n}"),
    ],
}
BLOCKS = 16384
# the dense interpreter's ops, and the staging steps, in block 0's thread 0
HEADER_EDITS = [
    ("  for (int n = 0; n < n_ops; ++n) {\n    const DenseOp& op = ops[n];\n    const int w = op.w;",
     "  for (int n = 0; n < n_ops; ++n) {\n    OP_STAMP(n);\n    const DenseOp& op = ops[n];\n    const int w = op.w;"),
]
KERNEL_OP_EDITS = [
    ("  STAMP(0);\n  stage_vectors(table, smem, warp, n_warps, lane);", "  STAMP(0);\n  stage_vectors(table, smem, warp, n_warps, lane);\n  OP_STAMP(33);"),
    ("  cp_async_commit();\n  decode_ops(table, ops, warp, n_warps, lane);", "  OP_STAMP(34);\n  cp_async_commit();\n  decode_ops(table, ops, warp, n_warps, lane);\n  OP_STAMP(35);"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n  STAMP(1);", "  cp_async_wait<0>();\n  OP_STAMP(36);\n  __syncthreads();\n  STAMP(1);"),
    ("    __syncwarp();  // every lane is done with the region before the next copies\n  }\n  WARP_END();", "    OP_STAMP(32);\n    __syncwarp();  // every lane is done with the region before the next copies\n  }\n  WARP_END();"),
]


def build_stamped(source):
    """The stamped copy of ``source``, built as the package builds its own
    (the tree's package: its CSRC_DIR and flags): the library's path."""
    from flink_ml_tpu_torch.native import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

    src = (CSRC_DIR / source).read_text()
    persistent = EDITS[source][0][0] in src
    edits = EDITS[source] if persistent else EDITS_WARP_A_ROW[source]
    if persistent and source == "megakernel_rowlocal.cu":
        edits = edits + KERNEL_OP_EDITS
    for anchor, stamped in edits:
        if anchor not in src:
            raise SystemExit(f"{source} has changed: no {anchor!r}")
        src = src.replace(anchor, stamped, 1)
    out = BUILD_DIR / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    header = (CSRC_DIR / "rowlocal_ops.cuh").read_text()
    if persistent:
        for anchor, stamped in HEADER_EDITS:
            if anchor not in header:
                raise SystemExit(f"rowlocal_ops.cuh has changed: no {anchor!r}")
            header = header.replace(anchor, stamped, 1)
    header = header.replace("#pragma once", "#pragma once\n#ifndef OP_STAMP\n#define OP_STAMP(slot)\n#endif", 1)
    (out / "rowlocal_ops.cuh").write_text(header)  # found before csrc's: the stamped copy includes it
    stem = Path(source).stem + "_stamped"
    cu, lib = out / f"{stem}.cu", out / f"{stem}.so"
    cu.write_text(STAMPS + src + DUMP)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(lib), str(cu)], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on the stamped copy of {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib))
    lib.dump_stamps.argtypes, lib.dump_ops.argtypes, lib.reset_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int], [
        ctypes.c_void_p], []
    return lib


def swap_in(kernel, lib):
    """The wrapper launches the stamped copy from now on."""
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    err = lib.cuda_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kernel._fn, kernel._error_string = fn, err


def read(lib, torch, np, run, cold, flush):
    """One stamped run of `run` (after a flush when `cold`): per-block phase
    times in microseconds."""
    if lib.reset_stamps():
        raise SystemExit("clearing the stamps failed")
    torch.cuda.synchronize()
    if cold:
        flush.zero_()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (12 * BLOCKS))()
    if lib.dump_stamps(ctypes.addressof(buf), BLOCKS):
        raise SystemExit("reading the stamps failed")
    a = np.array(buf, dtype=np.int64).reshape(BLOCKS, 12)
    a = a[a[:, 0] > 0]
    t0 = a[:, 0].min()
    ends = a[:, 3:].max(axis=1)

    def q(v):
        return [round(float(np.quantile(v, p)) / 1000, 3) for p in (0, .25, .5, .75, 1)]

    staged = a[:, 1] > 0
    ops = (ctypes.c_ulonglong * 40)()
    lib.dump_ops(ctypes.addressof(ops))
    o = np.array(ops, dtype=np.int64)
    block0 = {f"op{i}": round((int(o[i]) - int(t0)) / 1000, 3) for i in range(40) if o[i] > 0}
    return {
        "block0_us": block0,
        "blocks": int(len(a)),
        "kernel_us": round((int(ends.max()) - int(t0)) / 1000, 3),
        "start_us": q(a[:, 0] - t0),
        "staging_us": q(a[staged, 1] - a[staged, 0]) if staged.any() else None,
        "norms_us": q(a[:, 2] - np.where(staged, a[:, 1], a[:, 0])),
        "rows_us": q(ends - a[:, 2]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="the tree whose kernels and package run (default: this one)")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import numpy as np
    import torch

    import chip_smoke as c
    import flink_ml_tpu_torch.servable.megakernels as mk

    dev = torch.device("cuda", 0)
    card = c.nvidia_smi_line()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kmeans_lib, table_lib = build_stamped(mk.SCALE_KMEANS.source), build_stamped(mk.ROWLOCAL.source)
    swap_in(mk.SCALE_KMEANS, kmeans_lib)
    swap_in(mk.ROWLOCAL, table_lib)

    rng = np.random.default_rng(c.SEED)
    x, mean, inv_std, C = c._kmeans_inputs(rng, c.MAX_BATCH, c.KMEANS_D, c.KMEANS_K, dev)
    kw = dict(measure="euclidean", with_mean=True, with_std=True)
    scaled = mk.scale_kmeans_plain(x, mean, inv_std, C, **kw)[0]
    cases = {
        "scale_kmeans": (kmeans_lib, lambda: mk.scale_kmeans(x, mean, inv_std, C, write_scaled=True, **kw)),
        "kmeans_head": (kmeans_lib, lambda: mk.scale_kmeans(scaled, None, None, C, measure="euclidean",
                                                            with_mean=False, with_std=False, write_scaled=False)),
    }
    for name in ("feature6_logistic", "normalize_2"):
        inputs, ops = c._rowlocal_case(name, c.MAX_BATCH, c.FEATURE6_D, dev, np.random.default_rng(c.FEATURE6_SEED))
        cases[name] = (table_lib, lambda i=inputs, o=ops: mk.rowlocal_chain(i, o))
    km_ops = [mk.RowLocalOp("normalize", 0, params={"p": 2.0}),
              mk.RowLocalOp("kmeans", 1, C, params={"measure": "euclidean"})]
    cases["normalize_kmeans"] = (table_lib, lambda: mk.rowlocal_chain([x], km_ops))
    imp_rng = np.random.default_rng(c.IMPUTER_SERVE_SEED)
    cols = []
    for _ in c.IMPUTER_COLS:
        col = imp_rng.integers(0, c.IMPUTER_ARITY, c.MAX_BATCH).astype(np.float32)
        col[imp_rng.random(c.MAX_BATCH) < c.IMPUTER_MISSING_SHARE] = np.nan
        cols.append(torch.from_numpy(col).to(dev))
    surrogates = torch.from_numpy(imp_rng.random(len(cols)).astype(np.float32) * c.IMPUTER_ARITY).to(dev)
    imp_ops = [mk.RowLocalOp("impute", k, surrogates, params={"missing_is_nan": True, "missing_value": 0.0,
                                                              "column": k}) for k in range(len(cols))]
    cases["impute_15"] = (table_lib, lambda: mk.rowlocal_chain(cols, imp_ops))

    lines = []
    for name, (lib, run) in cases.items():
        for _ in range(19):
            run()
        line = {"case": name, "rows": c.MAX_BATCH, "tree": str(args.tree), "card": card,
                "warm": read(lib, torch, np, run, False, flush), "cold": read(lib, torch, np, run, True, flush)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
