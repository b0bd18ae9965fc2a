"""The rows and lanes of the scale → logistic serving kernel
(``csrc/megakernel_scale_logistic.cu``) on the CPU. A CUDA kernel does not
run on the CPU, so this file holds a numpy emulation of what its lanes do:

- the two paths: 16-byte groups (float4) when d % 4 == 0 and every tensor
  starts on a 16-byte boundary, one float a group otherwise;
- lanes a row: the next power of two at or above the row's groups, at most
  32, with 32 / L rows side by side in a warp; a lane's groups i, i + L, ...
  (kSlots of them), the model held in its registers up to kModelFloats
  floats a vector and walked in chunks past that;
- the persistent walk: warps take tasks of P · R rows (R rows of each of the
  P row groups, R the fewest that need no more than one block an SM, at most
  kDepth), strided over a grid of at most the resident blocks, every row
  once; the heads of a task's rows written by consecutive lanes;
- the margin's fold order: each lane's groups in increasing order, each
  group's floats in order, by fmaf from 0, then an xor butterfly over the
  row's L lanes.

The launch plan is ``chip_smoke._logistic_plan``, the one that
``chip_smoke.py`` and ``test_torch_gpu.py`` size their grids by; it is held
here against the dispatch and the constants read from the kernel's source,
at every width on both paths. Every operation is one
correctly rounded float32 operation (``fmaf`` and ``butterfly`` of
``test_torch_rowlocal_lanes``). The emulation is held bit-equal to the
port's plain version on scaled and, on raw and prediction, against the JAX
package's ``scale_fn`` + ``dot_kernel`` + ``logistic_from_dots_fn`` and the
port's plain version under ``chip_smoke.py``'s rules (``ULP_ENVELOPE``,
prediction equal where |margin| > 1e-4). The kernel itself is held against
the plain version on the card in ``test_torch_gpu.py``. No option of either
package's ``config`` is set here.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import flink_ml_tpu.ops.kernels as jk
from chip_smoke import LOGISTIC_MODEL_FLOATS, LOGISTIC_ROW_FLOATS, _logistic_check_widths, _logistic_plan
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
from flink_ml_tpu_torch.servable.megakernels import scale_logistic_path, scale_logistic_plain
from tests.test_torch_rowlocal_lanes import butterfly, fmaf

# Small shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "flink_ml_tpu_torch" / "csrc"
          / "megakernel_scale_logistic.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARP = 32
WARPS = _constant("kWarps")
MODEL_FLOATS = _constant("kModelFloats")
ROW_FLOATS = _constant("kRowFloats")
SMS = 132  # an H100's SMs
MARGIN = 1e-4  # chip_smoke.py PREDICTION_MARGIN
F32 = np.float32
CHAINS = ((True, True), (True, False), (False, True), (False, False))
WIDTHS = (1, 3, 4, 8, 100, 128, 129, 512, 513, 1000, 4099)


def plan(d, vec):
    """(lanes, slots, held, depth) of the launch on the path of vec floats a
    group (held: the model in registers; slots: a lane's groups, or a
    chunk's past the registers; depth: R's ceiling)."""
    return _logistic_plan(d, "16-byte" if vec == 4 else "scalar")


def dispatch(vec):
    """The source's dispatch<kVec> in order: (the bound on the row's groups,
    None past the last, lanes, slots, held) of each launch."""
    body = SOURCE[SOURCE.index("cudaError_t dispatch("):]
    body = body[:body.index("\n}\n")]
    entries, scalar_only = [], False
    for line in body.splitlines():
        if "if constexpr (kVec == 1)" in line:
            scalar_only = True
        elif line.strip() == "}":
            scalar_only = False
        elif m := re.search(r"if \(groups <= (?:(\d+) \* )?(kWarp|\d+)\) return launch<kVec, (\d+), (\d+), true>", line):
            if vec == 1 or not scalar_only:
                bound = int(m[1] or 1) * (WARP if m[2] == "kWarp" else int(m[2]))
                entries.append((bound, int(m[3]), int(m[4]), True))
        elif "return launch<kVec, 32, kModelFloats / kVec, false>" in line:
            entries.append((None, WARP, MODEL_FLOATS // vec, False))
    return entries


def rows_a_group(rows, lanes, depth):
    """R: the fewest rows a row group takes a task that need no more than one
    block an SM, at most depth (the kernel's launch)."""
    per_round = (WARP // lanes) * SMS * WARPS
    return max(1, min(depth, -(-rows // per_round)))


def walk(rows, lanes, R, resident_blocks):
    """Every (row, task, row group, round) the grid's warps take, and the
    row each lane's head write takes: warp w of block b walks tasks b · WARPS
    + w, + the grid's warps, ...; task t's row group g takes rows t P R + r P
    + g; its lane k < P R writes row t P R + k from row group k % P's r =
    k // P."""
    per = WARP // lanes
    task_rows = per * R
    tasks = -(-rows // task_rows)
    grid = min(-(-tasks // WARPS), resident_blocks)
    taken, heads = [], []
    for b in range(grid):
        for w in range(WARPS):
            for t in range(b * WARPS + w, tasks, grid * WARPS):
                computed = {}
                for r in range(R):
                    for g in range(per):
                        row = t * task_rows + r * per + g
                        if row < rows:
                            taken.append(row)
                            computed[(g, r)] = row
                for k in range(WARP):
                    if k < task_rows and t * task_rows + k < rows:
                        heads.append((t * task_rows + k, computed[(k % per, k // per)]))
    return grid, taken, heads


def emulate(x, mean, inv_std, coef, with_mean, with_std, vec):
    """(scaled, prediction, raw) as the kernel's lanes compute them, float32."""
    rows, d = x.shape
    lanes = plan(d, vec)[0]
    groups = d // vec
    scaled = x.astype(F32)
    if with_mean:
        scaled = (scaled - mean).astype(F32)
    if with_std:
        scaled = (scaled * inv_std).astype(F32)
    # lane i's partial: its groups i, i + lanes, ... in order, each group's floats in order
    acc = np.zeros((rows, lanes), F32)
    for s in range(-(-groups // lanes)):
        group = s * lanes + np.arange(lanes)
        inside = group < groups
        for q in range(vec):
            j = np.minimum(group * vec + q, d - 1)
            acc = np.where(inside, fmaf(scaled[:, j], coef[j], acc), acc)
    margin = butterfly(acc, lanes)
    with np.errstate(over="ignore"):  # exp(-m) overflows to inf past m ~ -88: p = 0, as expf gives
        p = (F32(1) / (F32(1) + np.exp(-margin, dtype=F32))).astype(F32)
    return scaled, (margin >= 0).astype(F32), np.stack([(F32(1) - p).astype(F32), p], axis=1)


def _inputs(rng, rows, d):
    x = rng.normal(size=(rows, d)).astype(F32)
    mean = rng.normal(size=d).astype(F32)
    std = (np.abs(rng.normal(size=d)) + 0.5).astype(F32)
    std[0] = 0.0  # the zero-std guard: that feature scales to 0
    inv_std = np.where(std == 0, F32(0), F32(1) / np.where(std == 0, F32(1), std)).astype(F32)
    coef = (rng.normal(size=d) * (3.0 / np.sqrt(d))).astype(F32)
    x[0] = mean  # scaled 0 with the mean: a margin of exactly 0
    x[1] = x[1] * F32(40)  # saturated sigmoid tails
    return x, mean, inv_std, coef


def test_the_constants_come_from_the_kernels_source():
    assert (WARPS, MODEL_FLOATS, ROW_FLOATS) == (8, LOGISTIC_MODEL_FLOATS, LOGISTIC_ROW_FLOATS)
    assert "return !held ? 1 : (kRowFloats / (slots * vec) < lanes ? kRowFloats / (slots * vec) : lanes);" in SOURCE
    # the one plan is the source's dispatch at every width on both paths
    for vec in (4, 1):
        entries = dispatch(vec)
        assert len(entries) == (9 if vec == 4 else 11) and entries[-1][0] is None
        for d in range(vec, 4100, vec):
            groups = d // vec
            lanes, slots, held = next(e[1:] for e in entries if e[0] is None or groups <= e[0])
            assert plan(d, vec)[:3] == (lanes, slots, held), (d, vec)
    # chip_smoke's check widths launch every instance
    widths = _logistic_check_widths()
    launched = {(4, *plan(d, 4)[:3]) for d in widths if d % 4 == 0} | {(1, *plan(d, 1)[:3]) for d in widths}
    assert launched == {(vec, *e[1:]) for vec in (4, 1) for e in dispatch(vec)}


@pytest.mark.parametrize("d", WIDTHS)
def test_lanes_a_row_hold_every_element_once_within_the_register_budget(d):
    for vec in (4, 1) if d % 4 == 0 else (1,):
        lanes, slots, held, depth = plan(d, vec)
        groups = d // vec
        assert lanes & (lanes - 1) == 0 and min(groups, WARP) <= lanes <= WARP
        assert groups > 16 or lanes < 2 * groups  # the next power of two
        assert held == (d <= WARP * MODEL_FLOATS)
        if held:
            assert lanes * slots >= groups and slots * vec <= MODEL_FLOATS
            assert depth * slots * vec <= ROW_FLOATS and (WARP // lanes) * depth <= WARP
        # lane i of row group g holds groups i, i + lanes, ...: every element once
        chunk = slots * lanes
        held_by = np.zeros(d, int)
        for i in range(lanes):
            for base in range(0, groups, chunk):
                for s in range(slots):
                    group = base + s * lanes + i
                    if group < groups:
                        held_by[group * vec:(group + 1) * vec] += 1
        assert (held_by == 1).all()


@pytest.mark.parametrize("rows", (1, 33, 4099, "past"))
def test_the_persistent_walk_takes_every_row_once_and_writes_each_head_once(rows):
    resident_blocks = SMS * 2
    for d, vec in ((3, 1), (8, 4), (100, 4), (129, 1), (1000, 4)):
        lanes, _, _, depth = plan(d, vec)
        n = rows
        if rows == "past":  # past one pass of the grid at R's ceiling: warps take a second task
            n = resident_blocks * WARPS * (WARP // lanes) * depth * 2 + 5
        R = rows_a_group(n, lanes, depth)
        grid, taken, heads = walk(n, lanes, R, resident_blocks)
        assert sorted(taken) == list(range(n)), (d, vec)
        assert grid <= resident_blocks and (R == depth or grid <= SMS)
        assert sorted(w for w, _ in heads) == list(range(n)) and all(w == c for w, c in heads)
        if rows == "past":
            assert R == depth


# x aligned at each width, and as a view one float into its buffer where d
# % 4 == 0 (the scalar path; any other d takes it at any offset)
@pytest.mark.parametrize("d,offset", [(d, 0) for d in (1, 3, 4, 8, 100, 129, 1000, 4099)]
                         + [(d, 1) for d in (4, 8, 100, 1000)])
def test_the_emulated_lanes_hold_the_plain_and_jax_envelope(d, offset):
    rng = np.random.default_rng(d)
    x, mean, inv_std, coef = _inputs(rng, 37, d)
    buf = torch.zeros(x.size + offset)
    buf[offset:] = torch.from_numpy(x.reshape(-1))
    xt = buf[offset:].view(x.shape)
    path = scale_logistic_path(xt, torch.from_numpy(mean), torch.from_numpy(inv_std), torch.from_numpy(coef))
    assert path == ("16-byte" if d % 4 == 0 and not offset else "scalar")
    vec = 4 if path == "16-byte" else 1
    envelope = ULP_ENVELOPE["scale_logistic"]
    for with_mean, with_std in CHAINS:
        scaled, pred, raw = emulate(x, mean, inv_std, coef, with_mean, with_std, vec)
        p_scaled, p_pred, p_raw = (t.numpy() for t in scale_logistic_plain(
            xt, torch.from_numpy(mean), torch.from_numpy(inv_std), torch.from_numpy(coef),
            with_mean=with_mean, with_std=with_std))
        j_scaled = np.asarray(jk.scale_fn(x, mean, inv_std, with_mean=with_mean, with_std=with_std))
        j_pred, j_raw = (np.asarray(a) for a in jk.logistic_from_dots_fn(jk.dot_kernel()(j_scaled, coef)))
        where = f"d={d} offset={offset} with_mean={with_mean} with_std={with_std}"
        assert np.array_equal(scaled.view(np.int32), p_scaled.view(np.int32)), where
        assert np.array_equal(scaled, j_scaled), where
        margin = scaled.astype(np.float64) @ coef.astype(np.float64)
        decided = np.abs(margin) > MARGIN
        for name, other_pred, other_raw in (("plain", p_pred, p_raw), ("jax", j_pred, j_raw)):
            assert ulp_diff(raw, other_raw) <= envelope, (name, where)
            assert np.array_equal(pred[decided], other_pred[decided]), (name, where)
        if with_mean:  # row 0 equals the mean: a margin of exactly +0
            assert pred[0] == 1 and raw[0].tolist() == [0.5, 0.5], where
