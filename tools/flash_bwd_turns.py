"""Two trees of the port, in turns on one card: the fold's backward kernels
(``chip_smoke.py``'s ``kernels_flash_bwd``) and the attention fit
(``fit_attention``) of each.

Each run is a fresh process started in the tree's own root, so it builds and
imports that tree's ``flink_ml_tpu_torch`` and calls that tree's
``chip_smoke.phase_kernels_flash_bwd`` and ``phase_fit_attention``. The
trees run in the order A, B, B, A, so drift of the card's clocks lands on
both. Unpack the other tree with ``git archive``
into a directory that ``.gitignore`` lists, for example::

    git archive <parent> | tar -x -C build/parent
    python3 tools/flash_bwd_turns.py --tree parent=build/parent --tree change=. \\
        --out build/flash_bwd_turns.jsonl

Every JSON line the phases print is kept in ``--out``, tagged with the tree
and the run; the last line of standard output is a summary per run: dq,
dkv, their sum with the divide's backward and SDPA's float32 backward
(cold medians, causal and not), and the fit's ms per step. Needs one card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

RUN = r"""
import sys
sys.path.insert(0, ".")
import numpy as np
import chip_smoke as c
from flink_ml_tpu_torch.parallel import FLASH_FOLD  # noqa: F401 (registers the fold's kernels)
card = c.nvidia_smi_line()
c.phase_kernels_flash_bwd(np.random.default_rng(c.SEED), card)
c.phase_fit_attention(card)
"""


def _summary(lines):
    out = {}
    for line in lines:
        if line.get("phase") == "kernels_flash_bwd" and "by_mask" in line:
            for mask, t in line["by_mask"].items():
                out[mask] = {"dq_ms": t["dq"]["ms"], "dkv_ms": t["dkv"]["ms"],
                             "kernels_with_divide_ms": t["kernels_with_divide_ms"],
                             "library_ms": t["library_ms"], "plain_ms": t["plain_ms"]}
        if line.get("phase") == "fit_attention" and "ms_per_step" in line:
            out["fit_ms_per_step"] = line["ms_per_step"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, metavar="NAME=PATH",
                    help="a tree to run (twice: A and B)")
    ap.add_argument("--out", type=Path, required=True, help="JSON lines of every phase, tagged")
    args = ap.parse_args()
    trees = [tuple(t.split("=", 1)) for t in args.tree]
    if len(trees) != 2:
        ap.error("give exactly two trees")
    (a, a_path), (b, b_path) = trees
    order = [(a, a_path), (b, b_path), (b, b_path), (a, a_path)]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    summary = []
    with args.out.open("w") as sink:
        for i, (name, path) in enumerate(order):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", RUN], cwd=path, capture_output=True, text=True)
            if proc.returncode:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                raise SystemExit(f"run {i} ({name}) failed with exit code {proc.returncode}")
            lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
            for line in lines:
                sink.write(json.dumps({"tree": name, "run": i, **line}) + "\n")
            summary.append({"tree": name, "run": i, "seconds": time.perf_counter() - t0, **_summary(lines)})
            print(json.dumps(summary[-1]), flush=True)
    print(json.dumps({"turns": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
