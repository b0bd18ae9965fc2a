"""Variants of the scale → logistic kernel, timed in turns on one card.

Copies of ``csrc/megakernel_scale_logistic.cu`` with one text edit each are
built beside the package's own libraries and launched with the wrapper's
arguments at each shape of ``chip_smoke.LOGISTIC_TIMED``:

- ``source``: the kernel as it is;
- ``fill``: R, the rows a row group takes a task, the fewest that give every
  row a task on one pass of the resident grid (the source: the fewest that
  give every SM one block of tasks), so each warp takes as few rows as it can;
- ``deep``: R always its ceiling kDepth;
- ``stcs``: scaled stored evict-first (``__stcs``), which only the host's
  readback reads next.

    python3 tools/logistic_variants.py [--out build/logistic_variants.jsonl]

Each variant's outputs are held against the plain version first (scaled
bit-equal, raw within the envelope). The variants run in the order A B C D
D C B A, 100 cold calls (after a 256 MB flush) and 200 warm ones each time;
one JSON line a variant and shape gives the median cold and each warm
reading, with the card. Needs one card and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = "megakernel_scale_logistic.cu"
EDITS = {
    "source": [],
    "fill": [("  const long long per_round = static_cast<long long>(kPer) * dev.sms * kWarps;",
              "  const long long per_round = static_cast<long long>(kPer) * resident * kWarps;")],
    "deep": [("  a.depth = static_cast<int>(depth < kDepth ? depth : kDepth);", "  a.depth = kDepth;")],
    "stcs": [("    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);",
              "    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));"),
             ("    *p = v[0];", "    __stcs(p, v[0]);")],
}


def _build(name, text):
    from flink_ml_tpu_torch.native import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"logistic_{name}.cu"
    src.write_text(text)
    lib = out / f"logistic_{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "logistic_variants.jsonl")
    args = ap.parse_args()

    import re

    import numpy as np
    import torch

    import chip_smoke as c
    from flink_ml_tpu_torch.native import CSRC_DIR
    from flink_ml_tpu_torch.servable import megakernels as mk
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff

    card = c.nvidia_smi_line()
    base = (CSRC_DIR / SOURCE).read_text()
    fns = {}
    for name, edits in EDITS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: anchor not found: {old!r}")
            text = text.replace(old, new)
        lib, log = _build(name, text)
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.megakernel_scale_logistic
        fn.argtypes = mk.SCALE_LOGISTIC.argtypes
        fn.restype = ctypes.c_int
        fns[name] = (fn, [int(r) for r in re.findall(r"Used (\d+) registers", log)])

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(c.SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as sink:
        for rows, d, with_mean, with_std, write_scaled in c.LOGISTIC_TIMED:
            x, mean, inv_std, coef = c._logistic_inputs(rng, rows, d, dev)
            scaled = torch.empty((rows, d), device=dev)
            pred = torch.empty((rows,), device=dev)
            raw = torch.empty((rows, 2), device=dev)
            path = mk.scale_logistic_path(x, mean, inv_std, coef, scaled)
            stream = torch.cuda.current_stream(dev).cuda_stream
            p_scaled, _, p_raw = mk.scale_logistic_plain(x, mean, inv_std, coef, with_mean=with_mean,
                                                         with_std=with_std)

            def call(fn):
                rc = fn(x.data_ptr(), mean.data_ptr(), inv_std.data_ptr(), coef.data_ptr(), scaled.data_ptr(),
                        pred.data_ptr(), raw.data_ptr(), rows, d, int(with_mean), int(with_std),
                        int(write_scaled), stream)
                if rc:
                    raise SystemExit(f"launch failed: CUDA error {rc}")

            for name, (fn, _) in fns.items():
                call(fn)
                torch.cuda.synchronize()
                if write_scaled and not torch.equal(scaled, p_scaled):
                    raise SystemExit(f"{name}: scaled differs at {rows} x {d}")
                if ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy()) > ULP_ENVELOPE["scale_logistic"]:
                    raise SystemExit(f"{name}: raw outside the envelope at {rows} x {d}")
                for _ in range(20):
                    call(fn)
            torch.cuda.synchronize()
            names = list(fns)
            times = {n: {"cold": [], "warm": []} for n in names}
            for name in names + names[::-1]:
                fn = fns[name][0]
                times[name]["cold"] += c._cold_times(lambda: call(fn), 100, flush)
                times[name]["warm"].append(c._warm_time(lambda: call(fn), 200))
            bytes_moved, ops, bound_ms, bound_by = c._logistic_bound(rows, d, with_mean, with_std, write_scaled)
            for name in names:
                line = {"variant": name, "rows": rows, "d": d, "with_mean": with_mean, "with_std": with_std,
                        "write_scaled": write_scaled, "path": path,
                        "ms": c._median(times[name]["cold"]), "ms_l2_warm": times[name]["warm"],
                        "bound_ms": bound_ms, "registers": fns[name][1], "card": card}
                sink.write(json.dumps(line) + "\n")
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
