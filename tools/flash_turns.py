"""Two trees of the port, in turns on one card: phases of ``chip_smoke.py``
of each tree — by default the ring-attention fold and its backward kernels
and the attention paths that run them (``kernels_flash``,
``serve_attention``, ``kernels_flash_bwd``, ``fit_attention``), or the
phases named with ``--phases``, for example the MLP megakernel and its paths
(``kernels_mlp``, ``serve_mlp``, ``pipeline_mlp``, ``kernels_chains``), the
one-hot crossings (``crossings``: ``phase_train`` on the headline sparse
rows, then ``phase_crossings_headline`` on the cache it returns) or the
sparse serving kernel and its paths (``kernels_sparse``, ``sparse_times``,
``serve_sparse``, ``pipeline_sparse``, ``pipeline_mixed``; the pipelines
take the models ``serve_sparse`` fits, so it runs before them), or the
scale → kmeans and row-local table kernels and their paths
(``kernels_kmeans``, ``kernels_rowlocal``, ``kernels_chains``,
``serve_kmeans``, ``serve_feature6``, ``serve_imputer``,
``pipeline_kmeans``, with ``kernels_mlp`` for the MLP kernel, which
includes the same ``csrc/rowlocal_ops.cuh``), or the scale → logistic
kernel and its service (``kernels``, ``logistic_times``, ``serve``).

Each run is a fresh process started in the tree's own root, so it builds and
imports that tree's ``flink_ml_tpu_torch`` and calls that tree's
``chip_smoke`` phases. The trees run in the order A, B, B, A, so drift of
the card's clocks lands on both. Unpack the other tree with ``git archive``
into a directory that ``.gitignore`` lists, for example::

    git archive <parent> | tar -x -C build/parent
    python3 tools/flash_turns.py --tree parent=build/parent --tree change=. \\
        --out build/flash_turns.jsonl
    python3 tools/flash_turns.py --tree parent=build/parent --tree change=. \\
        --phases kernels_mlp,serve_mlp,pipeline_mlp,kernels_chains --out build/mlp_turns.jsonl
    python3 tools/flash_turns.py --tree parent=build/parent --tree change=. \\
        --phases crossings --out build/crossing_turns.jsonl
    python3 tools/flash_turns.py --tree parent=build/parent --tree change=. \\
        --phases kernels_sparse,sparse_times,serve_sparse,pipeline_sparse,pipeline_mixed,kernels_chains \\
        --out build/sparse_turns.jsonl
    python3 tools/flash_turns.py --tree parent=build/parent --tree change=. \\
        --phases kernels_kmeans,kernels_rowlocal,kernels_chains,kernels_mlp,serve_kmeans,serve_feature6,serve_imputer,pipeline_kmeans \\
        --out build/table_turns.jsonl
    python3 tools/flash_turns.py --tree parent=build/parent --tree change=. \\
        --phases kernels,logistic_times,serve --out build/logistic_turns.jsonl

``kernels`` and ``serve`` draw from one generator seeded with ``SEED``, in
``chip_smoke.py``'s order: ``serve``'s traffic comes from the generator that
``kernels`` advanced, so two trees whose ``kernels`` draw differently serve
different request sizes. ``logistic_times`` is this tool's own tree's
``chip_smoke._time_logistic`` run against each tree's package, with the
tree's build of the kernel read by ``_logistic_compiled`` (registers, spills,
the SASS's loads before the first FFMA): the kernel's cold and warm times at
every shape of this tree's ``LOGISTIC_TIMED``, ``torch.mv(x, coef)`` and the
plain version beside them, and each shape's bound.

``sparse_times`` is this tool's own tree's ``chip_smoke._time_sparse`` run
against each tree's package: the sparse kernel's cold and warm times at
every shape of this tree's ``SPARSE_TIMED`` beside ``F.embedding_bag``,
``coef[ids]`` and the bound, and the kernel's registers and spills, the
same measurement for both trees whatever their own ``kernels_sparse`` times.

Every JSON line the phases print is kept in ``--out``, tagged with the tree
and the run; the last line of standard output is a summary per run. For the
attention phases: the fold's time, SDPA's float32 forward and the fold's
share of the TF32 peak; dq, dkv, their sum with the divide's backward and
SDPA's float32 backward (cold medians, causal and not); the served
documents' ms each; the fit's ms per step and device idle share. For the
MLP phases: the MLP kernel's registers, spills and SASS counts (HGMMA,
FFMA) as each tree's build gives them; its cold and warm times at the
serving shape and at the small batch sizes beside three ``torch.addmm``,
its bound and TF32 peak share; serve_mlp's and pipeline_mlp's p50 and p99;
kernels_chains' normalize → mlp and normalize → mlp → binarize. For the
crossings: each form's dot and mult, cold and warm, with the plain
version and the library call beside each (the premat ones' bf16 ``bmm``,
the build form's ``index_add_`` and ``gather``; where the tree times them,
the build-form dot's gathers alone), the bound and the share of HBM's
3.35 TB/s that the bound's bytes over the cold time reach, the kernels'
registers and spills, the build-form routes' facts, and the train phase's
premat and build-form ms/step. For the sparse phases: ``sparse_times`` by
shape, the served p50 and p99 of serve_sparse, the IDF service and
pipeline_mixed, and
kernels_chains' ``sparse_idf`` and IDF → LR → scale. Needs one card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ATTENTION = ("kernels_flash", "serve_attention", "kernels_flash_bwd", "fit_attention")
#: each phase's call; the kernels phases take the seeded generator first
CALLS = {
    "kernels_flash": "c.phase_kernels_flash(np.random.default_rng(c.SEED), card)",
    "serve_attention": "c.phase_serve_attention(card)",
    "kernels_flash_bwd": "c.phase_kernels_flash_bwd(np.random.default_rng(c.SEED), card)",
    "fit_attention": "c.phase_fit_attention(card)",
    "kernels_mlp": "c.phase_kernels_mlp(np.random.default_rng(c.SEED), card)",
    "serve_mlp": "c.phase_serve_mlp(card)",
    "pipeline_mlp": "c.phase_pipeline_mlp(card)",
    "kernels_chains": "c.phase_kernels_chains(np.random.default_rng(c.SEED), card)",
    "crossings": "c.phase_crossings_headline(c.phase_train(card, c._headline_data())[0], card)",
    "kernels_sparse": "c.phase_kernels_sparse(np.random.default_rng(c.SEED), card, headline[0])",
    "sparse_times": ("print(json.dumps({'phase': 'sparse_times', 'card': card, 'compiled': tool._sparse_compiled(), "
                     "**tool._time_sparse(headline[0], np.random.default_rng(c.SEED))}), flush=True)"),
    "serve_sparse": "_, idf_model, lr_model = c.phase_serve_sparse(card, headline)",
    "pipeline_sparse": "c.phase_pipeline_sparse(card, headline, idf_model, lr_model)",
    "pipeline_mixed": "c.phase_pipeline_mixed(card, headline, idf_model, lr_model)",
    "kernels_kmeans": "c.phase_kernels_kmeans(np.random.default_rng(c.SEED), card)",
    "kernels_rowlocal": "c.phase_kernels_rowlocal(np.random.default_rng(c.SEED), card)",
    "serve_kmeans": "c.phase_serve_kmeans(card)",
    "serve_feature6": "c.phase_serve_feature6(card)",
    "serve_imputer": "c.phase_serve_imputer(card)",
    "pipeline_kmeans": "c.phase_pipeline_kmeans(card)",
    "kernels": "c.phase_kernels(rng, card)",
    "logistic_times": ("print(json.dumps({'phase': 'logistic_times', 'card': card, "
                       "'compiled': tool._logistic_compiled(), "
                       "**tool._time_logistic(np.random.default_rng(c.SEED))}), flush=True)"),
    "serve": "c.phase_serve(rng, card)",
}
SPARSE = ("kernels_sparse", "sparse_times", "serve_sparse", "pipeline_sparse", "pipeline_mixed")
TOOL = ("sparse_times", "logistic_times")  # phases that load this tool's own chip_smoke
TOOL_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PREMAT = {"dot": "onehot_dot_crossing_premat", "mult": "onehot_mult_crossing_premat"}
BUILD = {"dot": "onehot_dot_crossing", "mult": "onehot_mult_crossing"}

HEAD = r"""
import json, re, subprocess, sys
from pathlib import Path
sys.path.insert(0, ".")
import numpy as np
import chip_smoke as c
from flink_ml_tpu_torch.parallel import FLASH_FOLD  # noqa: F401 (registers the fold's kernels)
import flink_ml_tpu_torch.servable.megakernels as mk  # registers the serving megakernels
card = c.nvidia_smi_line()
rng = np.random.default_rng(c.SEED)  # kernels, then serve: chip_smoke's order
"""

# What the tree's compiler makes of its MLP kernel source (either tree: only
# the package's build module and cuobjdump), before the phases run.
MLP_SASS = r"""
from flink_ml_tpu_torch.native import _nvcc, build
res = build(mk.ROWLOCAL_MLP.source)
sass = subprocess.run([str(Path(_nvcc()).with_name("cuobjdump")), "--dump-sass", str(res.library)],
                      capture_output=True, text=True, timeout=300, check=True).stdout
spills = [(int(a), int(b)) for a, b in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", res.log)]
print(json.dumps({"phase": "mlp_sass", "registers": [int(r) for r in re.findall(r"Used (\d+) registers", res.log)],
                  "spill_store_bytes": sum(a for a, _ in spills), "spill_load_bytes": sum(b for _, b in spills),
                  "hgmma": len(re.findall(r"\bHGMMA\.", sass)), "ffma": len(re.findall(r"\bFFMA\b", sass)),
                  "wgmma_serialized": "wgmma.mma_async instructions are serialized" in res.log}), flush=True)
"""


# This tool's own chip_smoke (for sparse_times and logistic_times), which
# imports the tree's package, and the headline rows the sparse phases share.
TOOL_HEAD = r"""
import importlib.util
spec = importlib.util.spec_from_file_location("tool_chip_smoke", TOOL_SMOKE)
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
"""
SPARSE_HEAD = "headline = c._headline_data()\n"


def _run_script(phases):
    body = HEAD + (MLP_SASS if "kernels_mlp" in phases else "")
    if set(phases) & set(TOOL):
        body += f"TOOL_SMOKE = {str(TOOL_SMOKE)!r}\n" + TOOL_HEAD
    if set(phases) & set(SPARSE):
        body += SPARSE_HEAD
    return body + "".join(CALLS[p] + "\n" for p in phases)


def _pick(d, keys):
    return {k: d.get(k) for k in keys}


def _summary(lines):
    out = {}
    for line in lines:
        phase = line.get("phase")
        if phase == "kernels_flash" and "by_mask" in line:
            for mask, t in line["by_mask"].items():
                # a parent tree's line may lack what a later tree adds
                out[f"fold_{mask}"] = _pick(t, ("ms", "ms_l2_warm", "ms_with_normalize", "library_ms",
                                                "plain_ms", "bound_ms", "tf32_peak_share"))
        if phase == "serve_attention" and "ms_per_doc_8x8192" in line:
            out["serve_ms_per_doc"] = line["ms_per_doc_8x8192"]
            out["serve_fold_share"] = line["fold_share_of_device_time"]
            out["serve_idle_share"] = line["device_idle_share"]
        if phase == "kernels_flash_bwd" and "by_mask" in line:
            for mask, t in line["by_mask"].items():
                out[mask] = {"dq_ms": t["dq"]["ms"], "dkv_ms": t["dkv"]["ms"],
                             "kernels_with_divide_ms": t["kernels_with_divide_ms"],
                             "library_ms": t["library_ms"], "plain_ms": t["plain_ms"]}
        if phase == "fit_attention" and "ms_per_step" in line:
            out["fit_ms_per_step"] = line["ms_per_step"]
            out["fit_idle_share"] = line["device_idle_share"]
            out["fit_shares"] = {k: line[f"{k}_share_of_device_time"] for k in ("fold", "dq", "dkv")}
        if phase == "mlp_sass":
            out["mlp_compiled"] = {k: v for k, v in line.items() if k != "phase"}
        if phase == "kernels_mlp" and "ms" in line:
            out["mlp"] = _pick(line, ("ms", "ms_l2_warm", "plain_ms", "library_ms", "library_ms_l2_warm",
                                      "bound_ms", "bound_ms_f32", "tf32_peak_share", "small_batches"))
        if phase in ("serve_mlp", "pipeline_mlp"):
            served = line.get("serve", line)
            if "p50_ms" in served:
                out[phase] = _pick(served, ("p50_ms", "p99_ms", "rows_per_s", "hot_batch_breakdown_ms"))
        if phase == "train" and "ms_per_step" in line:
            out["ms_per_step"] = {"premat": line["ms_per_step"]["on"], "build": line["ms_per_step"]["off"]}
            out["ms_per_step_runs"] = line["ms_per_step_runs"]
        if phase == "crossings" and "timing" in line:
            for form, names in (("premat", PREMAT), ("build", BUILD)):
                for short, name in names.items():
                    t = line["timing"][name]
                    # the build-form dot's gathers alone, where the tree times them
                    extra = tuple(k for k in t if k.startswith("gather_ms"))
                    out[f"{form}_{short}"] = dict(
                        _pick(t, ("ms", "ms_l2_warm", "plain_ms", "library_ms", "library_ms_l2_warm",
                                  "bound_ms") + extra),
                        hbm_peak_share=t["bytes"] / (t["ms"] / 1e3) / HBM_BYTES_PER_S)
            compiled = line.get("compiled", line.get("premat_compiled"))  # an older tree: premat only
            if compiled:
                out["compiled"] = compiled
            if "build_routes" in line:
                out["build_routes"] = line["build_routes"]
        if phase == "kernels_chains" and "timing" in line:
            for name in ("normalize_mlp", "normalize_mlp_binarize", "sparse_idf", "idf_lr_scale",
                         "normalize_kmeans", "kmeans_binarize"):
                out[name] = _pick(line["timing"][name], ("ms", "ms_l2_warm", "plain_ms", "bound_ms"))
        if phase in ("kernels_kmeans", "kernels_rowlocal") and "compiled" in line:
            out[phase + "_compiled"] = line["compiled"]
        if phase == "kernels_kmeans" and "ms" in line:
            out["scale_kmeans"] = _pick(line, ("ms", "ms_l2_warm", "plain_ms", "head_alone_ms",
                                               "head_alone_ms_l2_warm", "library_ms", "library_ms_l2_warm",
                                               "ms_l2_warm_by_measure", "bound_ms"))
        if phase == "kernels_rowlocal" and "ms" in line:
            out["rowlocal"] = _pick(line, ("ms", "ms_l2_warm", "plain_ms", "normalize_alone_ms",
                                           "normalize_alone_ms_l2_warm", "library_ms", "library_ms_l2_warm",
                                           "impute_15_ms", "impute_15_ms_l2_warm", "wrapper_host_us_per_call",
                                           "bound_ms"))
        if phase in ("serve_kmeans", "serve_feature6", "serve_imputer", "pipeline_kmeans"):
            served = line.get("serve", line)
            if "p50_ms" in served:
                out[phase] = _pick(served, ("p50_ms", "p99_ms", "rows_per_s", "hot_batch_breakdown_ms"))
        if phase == "sparse_times":
            out["sparse_compiled"] = line["compiled"]
            for t in [line, *line["smaller_shapes"]]:
                out[f"sparse_{t['shape']['rows']}x{t['shape']['cap']}"] = _pick(t, (
                    "ms", "ms_l2_warm", "ms_head_only", "ms_head_only_l2_warm", "library_ms",
                    "library_ms_l2_warm", "gather_ms", "gather_ms_l2_warm", "plain_ms", "bound_ms"))
        if phase == "kernels" and "compiled" in line:
            out["logistic_compiled"] = line["compiled"]
        if phase == "kernels" and "configurations" in line:
            out["logistic_checked"] = _pick(line, ("configurations", "max_raw_ulps", "max_abs_err"))
        if phase == "logistic_times":
            out["logistic_compiled_sass"] = line["compiled"]
            for t in line["shapes"]:
                name = f"logistic_{t['rows']}x{t['d']}" + ("" if t["write_scaled"] else "_alone")
                out[name] = _pick(t, ("path", "ms", "ms_l2_warm", "bound_ms"))
            out["logistic_plain"] = _pick(line, ("plain_ms", "plain_ms_l2_warm"))
            out["logistic_library_margin"] = _pick(line, ("library_margin_ms", "library_margin_ms_l2_warm"))
        if phase == "serve" and "p50_ms" in line:
            out["serve"] = _pick(line, ("p50_ms", "p99_ms", "rows_per_s", "megakernel_launches", "hot_batches",
                                        "batches", "fallback_batches", "post_warmup_builds"))
        if phase == "serve_sparse" and "p50_ms" in line:
            out["serve_sparse"] = _pick(line, ("p50_ms", "p99_ms", "rows_per_s", "hot_batch_breakdown_ms"))
        if phase == "pipeline_sparse" and "idf_service" in line:
            out["idf_service"] = _pick(line["idf_service"], ("p50_ms", "p99_ms", "rows_per_s"))
        if phase == "pipeline_mixed" and "serve" in line:
            out["pipeline_mixed"] = _pick(line["serve"], ("p50_ms", "p99_ms", "rows_per_s"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, metavar="NAME=PATH",
                    help="a tree to run (twice: A and B)")
    ap.add_argument("--out", type=Path, required=True, help="JSON lines of every phase, tagged")
    ap.add_argument("--phases", default=",".join(ATTENTION),
                    help=f"chip_smoke phases to run, comma-separated, of {sorted(CALLS)}")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(CALLS))
    if unknown or not phases:
        ap.error(f"unknown phases {unknown}; choose from {sorted(CALLS)}")
    fitted = phases.index("serve_sparse") if "serve_sparse" in phases else len(phases)
    if any(phases.index(p) < fitted for p in ("pipeline_sparse", "pipeline_mixed") if p in phases):
        ap.error("pipeline_sparse and pipeline_mixed take serve_sparse's models: name serve_sparse before them")
    trees = [tuple(t.split("=", 1)) for t in args.tree]
    if len(trees) != 2:
        ap.error("give exactly two trees")
    (a, a_path), (b, b_path) = trees
    order = [(a, a_path), (b, b_path), (b, b_path), (a, a_path)]
    script = _run_script(phases)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    summary = []
    with args.out.open("w") as sink:
        for i, (name, path) in enumerate(order):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", script], cwd=path, capture_output=True, text=True)
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
