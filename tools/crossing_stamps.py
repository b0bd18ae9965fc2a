"""Where the build-form crossing kernels' time goes, warp by warp: a copy of
``csrc/onehot_crossing.cu`` with ``%globaltimer`` stamps, built beside the
package's own library and launched through ``dot_crossing`` and
``mult_crossing`` at the headline unit shape (window 0 of the
headline layout: 4 sub-batches of 16,384 rows, ~1.1 M slots each).

    python3 tools/crossing_stamps.py [--out build/crossing_stamps.jsonl]

The dot's warps stamp their start, the moment their rows' bounds (row_ptr)
are in, the moment their tile's entry ids are staged, and their end; the
mult's warps their start, the moment their first groups' ids are issued,
the end of their first round of groups and their end. Prints one JSON line
per case and cache state (warm: the 20th of 20 runs; cold: after a 256 MB
flush): the warps, the
kernel's span from the first warp's start to the last warp's end, and the
quartiles over warps of their start (from the first), of each phase and of
their end, in microseconds, with the card. The stamps cost a store each;
read the times as shares, not as the kernels' speed. Needs one card and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SLOTS, WARPS = 4, 1 << 16
STAMPS = r'''
__device__ unsigned long long g_warps[65536][4];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define WARP_STAMP(w, slot) do { if ((threadIdx.x & 31) == 0) g_warps[w][slot] = gtime(); } while (0)
'''

DUMP = r'''
extern "C" int dump_stamps(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_warps, sizeof(g_warps)));
}
extern "C" int reset_stamps() {
  void* p = nullptr;
  cudaError_t rc = cudaGetSymbolAddress(&p, g_warps);
  if (rc == cudaSuccess) rc = cudaMemset(p, 0, sizeof(g_warps));
  return static_cast<int>(rc);
}
'''

# (anchor, the same text with its stamps)
EDITS = [
    # the dot
    ("  if (r0 >= rows) return;  // rows is a multiple of 128: a tile is whole or absent\n",
     "  if (r0 >= rows) return;  // rows is a multiple of 128: a tile is whole or absent\n"
     "  const int stamp_w = (blockIdx.y * gridDim.x + blockIdx.x) * kDotWarps + warp;\n"
     "  WARP_STAMP(stamp_w, 0);\n"),
    ("  const int b = __shfl_sync(kFull, rs, 0), e = __shfl_sync(kFull, re, kWarp - 1);\n",
     "  const int b = __shfl_sync(kFull, rs, 0), e = __shfl_sync(kFull, re, kWarp - 1);\n"
     "  WARP_STAMP(stamp_w, 1);\n"),
    ("    __syncwarp();\n    // lane's row in this piece",
     "    __syncwarp();\n    WARP_STAMP(stamp_w, 2);\n    // lane's row in this piece"),
    ("  out[static_cast<size_t>(s) * rows + r0 + lane] = total;",
     "  WARP_STAMP(stamp_w, 3);\n  out[static_cast<size_t>(s) * rows + r0 + lane] = total;"),
    # the mult
    ("  int g = blockIdx.x * blockDim.x + threadIdx.x;\n",
     "  int g = blockIdx.x * blockDim.x + threadIdx.x;\n  const int stamp_g0 = g;\n"
     "  const int stamp_w = ((blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x) / 32;\n"
     "  WARP_STAMP(stamp_w, 0);\n"),
    ("  if (blockIdx.x == 0 && threadIdx.x < 16) {  // threads 0-7 the head, 8-15 the tail",
     "  WARP_STAMP(stamp_w, 1);\n  if (blockIdx.x == 0 && threadIdx.x < 16) {  // threads 0-7 the head, 8-15 the tail"),
    ("    g += kMultInFlight * stride;\n",
     "    if (g == stamp_g0) WARP_STAMP(stamp_w, 2);\n    g += kMultInFlight * stride;\n"),
    ("      w[k] = gk < groups ? ld_stream16(grid_ids + 8 * gk) : make_int4(0, 0, 0, 0);\n    }\n  }\n}",
     "      w[k] = gk < groups ? ld_stream16(grid_ids + 8 * gk) : make_int4(0, 0, 0, 0);\n    }\n  }\n"
     "  WARP_STAMP(stamp_w, 3);\n}"),
]
PHASES = {"dot": ("row_ptr", "ids_staged", "walk"), "mult": ("ids_issued", "first_round", "rest")}


def build_stamped(source):
    """The stamped copy of ``source``, built with the package's flags: the
    loaded library."""
    from flink_ml_tpu_torch.native import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

    src = (CSRC_DIR / source).read_text()
    for anchor, stamped in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"{source} has changed: {src.count(anchor)} of {anchor!r}")
        src = src.replace(anchor, stamped)
    out = BUILD_DIR / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{Path(source).stem}_stamped.cu", out / f"{Path(source).stem}_stamped.so"
    cu.write_text(STAMPS + src + DUMP)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(lib), str(cu)], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on the stamped copy of {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib))
    lib.dump_stamps.argtypes, lib.reset_stamps.argtypes = [ctypes.c_void_p], []
    return lib


def swap_in(kernel, lib):
    """The wrapper launches the stamped copy from now on."""
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    err = lib.cuda_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kernel._fn, kernel._error_string = fn, err


def read(lib, torch, np, run, cold, flush, phases):
    """One stamped run of ``run`` (after a flush when ``cold``): per-warp
    phase times in microseconds."""
    if lib.reset_stamps():
        raise SystemExit("clearing the stamps failed")
    torch.cuda.synchronize()
    if cold:
        flush.zero_()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (SLOTS * WARPS))()
    if lib.dump_stamps(ctypes.addressof(buf)):
        raise SystemExit("reading the stamps failed")
    a = np.array(buf, dtype=np.int64).reshape(WARPS, SLOTS)
    a = a[(a[:, 0] > 0) & (a[:, 3] > 0)]
    # a warp whose lane 0 had no group skips the first-round stamp: its end
    a[:, 2] = np.where(a[:, 2] > 0, a[:, 2], a[:, 3])
    t0 = a[:, 0].min()

    def q(v):
        return [round(float(np.quantile(v, p)) / 1000, 3) for p in (0, .25, .5, .75, 1)]

    return {"warps": int(len(a)), "kernel_us": round((int(a[:, 3].max()) - int(t0)) / 1000, 3),
            "start_us": q(a[:, 0] - t0),
            **{f"{name}_us": q(a[:, i + 1] - a[:, i]) for i, name in enumerate(phases)},
            "end_us": q(a[:, 3] - t0)}


def headline_unit():
    """Window 0 of the headline layout, as the train phase builds it, and a
    q and mult3 from the headline phase's generator."""
    import numpy as np
    import torch

    import chip_smoke as c
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.linalg import onehot_sparse as O
    from flink_ml_tpu_torch.models.common import extract_labeled_data
    from flink_ml_tpu_torch.ops.optimizer import SGD

    idx, y = c._headline_data()
    cols = extract_labeled_data(c._sparse_frame(idx, label=y), "features", "label", None, allow_sparse=True)
    dim = cols.pop("dim")
    opt = SGD(max_iter=1, global_batch_size=c.TRAIN_BATCH, tol=0.0, learning_rate=c.TRAIN_LR,
              sparse_kernel="onehot", onehot_premat="off")
    lay, (lidx, rowid, lvals, row_ptr, entry_of) = opt._onehot_layout(DeviceDataCache(cols), dim, c.TRAIN_BATCH,
                                                                     force=True)
    dev = lvals.device
    rng = np.random.default_rng(c.SEED + 1)
    coef_perm = torch.from_numpy(rng.normal(size=lay.nblk * O.BLOCK).astype(np.float32)).to(dev)
    q = lvals[0] * O.gather_round(coef_perm, lidx[0], lay.class_meta)
    m3 = torch.from_numpy(rng.normal(size=(lay.n_sub, lay.row_hi, 128)).astype(np.float32)).to(dev)
    return q, rowid[0], m3, lay.row_hi, (row_ptr[0], entry_of[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import numpy as np
    import torch

    import chip_smoke as c
    from flink_ml_tpu_torch.linalg import onehot_sparse as O

    card = c.nvidia_smi_line()
    q, rowid, m3, row_hi, order = headline_unit()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=q.device)
    want = (O.dot_crossing(q, rowid, row_hi, order), O.mult_crossing(m3, rowid))
    lib = build_stamped(O.DOT_CROSSING.source)
    swap_in(O.DOT_CROSSING, lib)
    swap_in(O.MULT_CROSSING, lib)
    cases = {"dot": ("dot", lambda: O.dot_crossing(q, rowid, row_hi, order)),
             "mult": ("mult", lambda: O.mult_crossing(m3, rowid))}
    got = tuple(run() for _, run in cases.values())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit("the stamped copy's outputs differ from the package's kernels")
    lines = []
    for name, (kind, run) in cases.items():
        for _ in range(19):
            run()
        line = {"case": name, "shape": {"n_sub": int(q.shape[0]), "n": int(q.shape[1]), "row_hi": row_hi},
                "card": card, "warm": read(lib, torch, np, run, False, flush, PHASES[kind]),
                "cold": read(lib, torch, np, run, True, flush, PHASES[kind])}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
