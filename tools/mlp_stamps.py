"""Where the MLP serving megakernel's time goes, block by block: a copy of
``csrc/megakernel_scale_mlp.cu`` with ``%globaltimer`` stamps at its phases
and at every stage of the weights' ring, built beside the package's own
libraries and launched through ``rowlocal_mlp`` on the published network
(256 → 512 → 512 → 8, scale → mlp's products alone) at 2 and 4096 rows.

    python3 tools/mlp_stamps.py [--out build/mlp_stamps.jsonl]

Prints one JSON line per batch size: for the first, a middle and the last
block, the microseconds from the kernel's first stamp to the end of each
phase (rows staged, the prologue's exchange in, the last layer's products
done, its exchange in, the head done) on both warpgroups; the medians over
the first 64 stages of the consumer's wait for a full stage and its issue,
and of the loader's parts (the staged rows ready, the next copies issued,
the rows read, the stage handed over); and the quartiles of the blocks'
start times, which show the waves. The stamps cost a global store each;
read the times as shares, not as the kernel's speed. Needs one card and
nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STAMPS = r'''
__device__ unsigned long long g_stamps[4096][32];
__device__ unsigned long long g_steps[4096][2][4][64];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(slot) do { if ((threadIdx.x & 127) == 0) g_stamps[blockIdx.x][(slot) + (threadIdx.x >= 128 ? 16 : 0)] = gtime(); } while (0)
#define STEP_STAMP(side, what, i) do { if ((threadIdx.x & 127) == 0 && (i) < 64) g_steps[blockIdx.x][side][what][i] = gtime(); } while (0)
'''

DUMP = r'''
extern "C" int dump_stamps(void* host, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(unsigned long long) * 32 * blocks));
}
extern "C" int dump_steps(void* host, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_steps, sizeof(unsigned long long) * 2 * 4 * 64 * blocks));
}
'''

# (anchor in the source, the same text with its stamps)
EDITS = [
    ("namespace {\n\nconstexpr int kMaxHeads", STAMPS + "namespace {\n\nconstexpr int kMaxHeads"),
    ("  int t = 0;   // the ring position", "  STAMP(0);\n  int t = 0;   // the ring position"),
    ("    fence_proxy_async();  // the staged rows", "    STAMP(1);\n    fence_proxy_async();  // the staged rows"),
    ("      mbar_wait(x.bar, x.n & 1);\n      ++x.n;\n      t = consume_layers",
     "      mbar_wait(x.bar, x.n & 1);\n      STAMP(2);\n      ++x.n;\n      t = consume_layers"),
    ("#pragma unroll\n  for (int j = 0; j < kNC; ++j) fence_regs(acc[j]);",
     "  STAMP(3);\n#pragma unroll\n  for (int j = 0; j < kNC; ++j) fence_regs(acc[j]);"),
    ("  mbar_wait(x.bar, x.n & 1);\n  ++x.n;\n}", "  mbar_wait(x.bar, x.n & 1);\n  STAMP(4);\n  ++x.n;\n}"),
    ("  mbar_wait(x.bar, x.n & 1);\n  ++x.n;\n  const int lane",
     "  mbar_wait(x.bar, x.n & 1);\n  STAMP(4);\n  ++x.n;\n  const int lane"),
    ("    __syncthreads();  // the head's outputs", "    STAMP(5);\n    __syncthreads();  // the head's outputs"),
    ("    mbar_wait(&ring.full[s], (pos >> ring.log_n) & 1);",
     "    mbar_wait(&ring.full[s], (pos >> ring.log_n) & 1);\n    STEP_STAMP(0, 0, pos);"),
    ("    wgmma_commit();\n    wgmma_wait<1>();", "    wgmma_commit();\n    STEP_STAMP(0, 1, pos);\n    wgmma_wait<1>();"),
    ("// and every loader thread's; stage u - 1 is read\n",
     "// and every loader thread's; stage u - 1 is read\n      STEP_STAMP(1, 0, t + (u - begin));\n"),
    ("      stage_rows(u + kRawStages - 1);  // into stage u - 1's slot",
     "      stage_rows(u + kRawStages - 1);  // into stage u - 1's slot\n      STEP_STAMP(1, 1, t + (u - begin));"),
    ("      put_stage(ring, t + (u - begin), x, w.count, o);\n    }\n    cp_async_wait<0>();",
     "      STEP_STAMP(1, 2, t + (u - begin));\n      put_stage(ring, t + (u - begin), x, w.count, o);\n"
     "      STEP_STAMP(1, 3, t + (u - begin));\n    }\n    cp_async_wait<0>();"),
]
PHASES = {0: "start", 1: "rows_staged", 2: "prologue_in", 3: "products_done", 4: "exchange_in", 5: "head_done"}


def build_stamped():
    """The stamped copy of the kernel's source, built as the package builds
    its own: the library's path."""
    from flink_ml_tpu_torch.native import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

    src = (CSRC_DIR / "megakernel_scale_mlp.cu").read_text()
    for anchor, stamped in EDITS:
        if anchor not in src:
            raise SystemExit(f"the kernel's source has changed: no {anchor!r}")
        src = src.replace(anchor, stamped, 1)
    out = BUILD_DIR / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "megakernel_scale_mlp_stamped.cu", out / "megakernel_scale_mlp_stamped.so"
    cu.write_text(src + DUMP)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(lib), str(cu)], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on the stamped copy:\n{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as c
    from flink_ml_tpu_torch.servable.megakernels import ROWLOCAL_MLP, rowlocal_mlp

    lib = ctypes.CDLL(str(build_stamped()))
    fn = getattr(lib, ROWLOCAL_MLP.symbol)
    fn.argtypes, fn.restype = ROWLOCAL_MLP.argtypes, ctypes.c_int
    err = lib.cuda_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    ROWLOCAL_MLP._fn, ROWLOCAL_MLP._error_string = fn, err  # the wrapper launches the stamped copy
    dev = torch.device("cuda", 0)
    x, _, _, layers, labels = c._mlp_inputs(np.random.default_rng(c.SEED), 4096, c.MLP_WIDTHS, dev)
    lines = []
    for rows in (2, 4096):
        xr = x[:rows].contiguous()
        for _ in range(4):  # the last run's stamps stay
            c._mlp_head(rowlocal_mlp, [xr], [], 0, layers, labels)
        torch.cuda.synchronize()
        blocks = 8 if rows <= 64 else 256
        buf = (ctypes.c_ulonglong * (32 * blocks))()
        steps = (ctypes.c_ulonglong * (2 * 4 * 64 * blocks))()
        if lib.dump_stamps(ctypes.addressof(buf), blocks) or lib.dump_steps(ctypes.addressof(steps), blocks):
            raise SystemExit("reading the stamps failed")
        a = np.array(buf, dtype=np.int64).reshape(blocks, 32)
        s = np.array(steps, dtype=np.int64).reshape(blocks, 2, 4, 64)
        t0 = a[:, 0][a[:, 0] > 0].min()

        def us(v):
            return round((int(v) - int(t0)) / 1000, 3)

        by_block = {}
        for b in (0, blocks // 2, blocks - 1):
            by_block[b] = {side: {PHASES[i]: us(a[b, i + off]) for i in PHASES if a[b, i + off] > 0}
                           for side, off in (("consumer", 0), ("loader", 16))}
        b = 0
        cons, load = s[b, 0], s[b, 1]
        n = [i for i in range(1, 64) if cons[0, i] > 0 and load[3, i] > 0 and cons[0, i - 1] > 0]
        stage = {
            "stage_period_us": float(np.median([(cons[0, i] - cons[0, i - 1]) / 1000 for i in n])),
            "consumer_issue_us": float(np.median([(cons[1, i] - cons[0, i]) / 1000 for i in n])),
            "loader_copies_issue_us": float(np.median([(load[1, i] - load[0, i]) / 1000 for i in n])),
            "loader_read_us": float(np.median([(load[2, i] - load[1, i]) / 1000 for i in n])),
            "loader_hand_over_us": float(np.median([(load[3, i] - load[2, i]) / 1000 for i in n])),
            "full_after_hand_over_us": float(np.median([(cons[0, i] - load[3, i]) / 1000 for i in n])),
            "stages": len(n),
        }
        starts = np.sort((a[:, 0][a[:, 0] > 0] - t0) / 1000)
        line = {"rows": rows, "blocks": blocks, "kernel_us": us(a[:, 5].max()), "by_block": by_block,
                "block0_stages": stage,
                "start_quartiles_us": [round(float(np.quantile(starts, q)), 3) for q in (0, .25, .5, .75, 1)],
                "card": c.nvidia_smi_line()}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
