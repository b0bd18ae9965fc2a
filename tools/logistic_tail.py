"""The scale → logistic kernel's rawPrediction against its plain version in
the saturated tail, for one or more trees on one card.

At rows past one pass of the kernel's persistent grid (this tree's
``chip_smoke._logistic_past_one_pass``), at each width of
``chip_smoke._logistic_check_widths``, x aligned and one float into its buffer, and
each chain of ``chip_smoke.CHAINS``, each tree's ``scale_logistic`` runs on
the same seeded inputs (``chip_smoke._logistic_inputs``) and is held against
the plain version: the whole-raw ulps (``ulp_diff`` over both columns), p's
ulps (``raw[:, 1]``), whether ``raw[:, 0]`` is ``1 - raw[:, 1]`` in float32
on both sides, the rows whose p differs from the plain p, and those among
them where the plain p is within 2^-16 of 1 (one ulp of p there is more
than the envelope's 32,768 ulps of 1 - p).

    python3 tools/logistic_tail.py --tree parent=build/parent --tree change=. \\
        [--out build/logistic_tail.jsonl]

Each tree runs in a fresh process in its own root, so it builds and imports
its own package. Prints one JSON line per width, offset and chain, tagged
with the tree, and a summary per tree last. Needs one card and nvcc.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

TOOL_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"

RUN = r"""
import importlib.util, json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
from flink_ml_tpu_torch.servable import megakernels as mk
from flink_ml_tpu_torch.servable.fusion import ulp_diff
spec = importlib.util.spec_from_file_location("tool_chip_smoke", sys.argv[1])
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
dev = torch.device("cuda", 0)
rng = np.random.default_rng(c.SEED)
near_one = np.float32(1) - np.float32(2.0 ** -16)
for d in c._logistic_check_widths():
    for offset in (0, 1):
        rows = c._logistic_past_one_pass(d, offset)
        x, mean, inv_std, coef = c._logistic_inputs(rng, rows, d, dev, offset)
        for _, with_mean, with_std, write_scaled in c.CHAINS:
            _, _, raw = mk.scale_logistic(x, mean, inv_std, coef, with_mean=with_mean, with_std=with_std,
                                          write_scaled=write_scaled)
            _, _, p_raw = mk.scale_logistic_plain(x, mean, inv_std, coef, with_mean=with_mean, with_std=with_std)
            got, want = raw.cpu().numpy(), p_raw.cpu().numpy()
            flips = got[:, 1].view(np.int32) != want[:, 1].view(np.int32)
            print(json.dumps({
                "d": d, "rows": rows, "offset": offset, "with_mean": with_mean, "with_std": with_std,
                "raw_ulps": ulp_diff(got, want), "p_ulps": ulp_diff(got[:, 1], want[:, 1]),
                "complement_exact": bool(np.array_equal((np.float32(1) - got[:, 1]).view(np.int32),
                                                        got[:, 0].view(np.int32))
                                         and np.array_equal((np.float32(1) - want[:, 1]).view(np.int32),
                                                            want[:, 0].view(np.int32))),
                "p_differs": int(flips.sum()), "p_differs_near_one": int((flips & (want[:, 1] > near_one)).sum()),
                "rows_near_one": int((want[:, 1] > near_one).sum()),
            }), flush=True)
        del x
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, metavar="NAME=PATH")
    ap.add_argument("--out", type=Path, default=Path("build") / "logistic_tail.jsonl")
    args = ap.parse_args()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    summary = []
    with args.out.open("w") as sink:
        for name, path in (t.split("=", 1) for t in args.tree):
            proc = subprocess.run([sys.executable, "-c", RUN, str(TOOL_SMOKE)], cwd=path, capture_output=True,
                                  text=True)
            if proc.returncode:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                raise SystemExit(f"{name} failed with exit code {proc.returncode}")
            lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
            for line in lines:
                sink.write(json.dumps({"tree": name, **line}) + "\n")
            over = [ln for ln in lines if ln["raw_ulps"] > 32_768]
            summary.append({
                "tree": name, "configurations": len(lines), "over_envelope": len(over),
                "max_raw_ulps": max(ln["raw_ulps"] for ln in lines), "max_p_ulps": max(ln["p_ulps"] for ln in lines),
                "complement_exact": all(ln["complement_exact"] for ln in lines),
                "over_at": [[ln["d"], ln["offset"], ln["with_mean"], ln["with_std"], ln["raw_ulps"]] for ln in over],
            })
            print(json.dumps(summary[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
