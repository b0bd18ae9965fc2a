"""The arithmetic of the MLP serving megakernel (``csrc/megakernel_scale_mlp.cu``)
on the CPU: a plain PyTorch emulation of what the kernel computes, held
against the JAX package's ``mlp_predict_fn`` (float32), the JAX megakernel on
``("scale", "mlp")`` in Pallas interpret mode and the port's
``rowlocal_mlp_plain``, on the same numpy inputs. The kernel itself runs only
on the card (``test_torch_gpu.py``); this file checks its algorithm.

The emulation follows the kernel. Each layer's K is padded with exact zeros
to whole stages of two k-steps of 8; its output columns come in chunks of
64, and rank c of a cluster of C owns chunks ``[c·n/C, (c+1)·n/C)`` of the
layer's n; a layer of one chunk is split over K instead, into four fixed
segments of its stages whatever C, each segment's sum from zero, the four
added in order (((s0 + s1) + s2) + s3) before the bias. Every
operand is split as ``tf32_mma.cuh`` ``split`` splits it: hi is x with its low
13 mantissa bits cleared (a truncation), lo = x - hi, of which the tensor
cores read the top bits (``as_split``: lo truncated the same way). Per k-step
the kernel issues three products into the float32 accumulator, in this
order: lo(A)·hi(W), hi(A)·lo(W), hi(A)·hi(W); the emulation sums each
product's eight terms exactly (float64, in k order) and rounds once to
float32 before adding it. Then ``+ b`` after the K loop, relu on a hidden
layer, and the head: softmax as ``exp(x - max) / Σ``, the prediction the
first maximal logit's label, a NaN counting as the maximum.

Tolerance, the kernel's own gates on the card (``chip_smoke.py``
kernels_mlp): probabilities within ``ULP_ENVELOPE["scale_mlp"]`` (16,384
ulps, about 2^-9 relative) and predictions equal where the plain float32
top-two logit gap is above 1e-4 — the split sums in another order than a
float32 product. A bfloat16 control (inputs and weights rounded to bfloat16,
the emulation otherwise the same) must land outside that tolerance. A row's
outputs must not depend on how the columns are split over the cluster: the
emulation with C = 1, 2, 4 and 8 is bit-equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.ops import kernels as jk
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier
from flink_ml_tpu.servable.megakernels import build_megakernel_fn as jax_build_megakernel_fn
from flink_ml_tpu.servable.planner import FusedSegment as JFusedSegment
from flink_ml_tpu.servable.planner import build_segments as jax_build_segments

from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.ops import kernels as tk
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
from flink_ml_tpu_torch.servable.megakernels import (
    MLP_MAX_CLASSES,
    MLP_MAX_LAYERS,
    MLP_MAX_WIDTH,
    RowLocalOp,
    rowlocal_mlp_plain,
)

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

ENVELOPE = ULP_ENVELOPE["scale_mlp"]
MARGIN = 1e-4  # predictions compared where the plain top-two logits differ by more
STEP = 8  # k of one wgmma
STAGE = 16  # k of a stage of the weights' ring: K is padded to whole stages with exact zeros
SEGMENTS = 4  # a one-chunk layer's K split: each segment's sum from zero, then added in order
CHUNK = 64  # output columns of one wgmma m64n64k8
MAX_CHUNKS = 2  # chunks one rank owns in a layer (the accumulator's registers)
MAX_CLUSTER = 8
NETWORKS = {
    "256-512-512-8": (256, 512, 512, 8),  # the published network
    "100-64-2": (100, 64, 2),
    "8-16-3": (8, 16, 3),
    "limits": (MLP_MAX_WIDTH,) * MLP_MAX_LAYERS + (MLP_MAX_CLASSES,),
}
ROWS = (3, 65)


@pytest.fixture(autouse=True)
def _unset_config():
    """Every option set while a test here runs is unset after it: the test
    workers run other files in the same process."""
    before = (dict(config._values), dict(jconfig._values))
    yield
    for opts, conf, kept in ((Options, config, before[0]), (JOptions, jconfig, before[1])):
        for key, option in opts.all().items():
            if key not in kept:
                conf.unset(option)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _inputs(rows, widths, seed):
    """Rows, a scaler (a zero-std feature included) and a He-initialised
    network with small biases and class labels, float32 numpy."""
    rng = np.random.default_rng(seed)
    d = widths[0]
    std = np.abs(rng.normal(size=d)) + 0.5
    std[0] = 0.0  # the zero-std guard: that feature scales to 0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))
    layers = [((rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
               (rng.normal(size=b) * 0.1).astype(np.float32)) for a, b in zip(widths[:-1], widths[1:])]
    labels = (rng.permutation(widths[-1]) * 2.0 + 1.0).astype(np.float32)
    x = rng.normal(loc=0.5, scale=2.0, size=(rows, d)).astype(np.float32)
    mean = rng.normal(size=d).astype(np.float32)
    return x, mean, inv_std.astype(np.float32), layers, labels


def _scaled(x, mean, inv_std):
    return tk.scale_fn(_t(x), _t(mean), _t(inv_std), with_mean=True, with_std=True)


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _tf32(x):
    """x with the low 13 of its 23 mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """(hi, lo) as the tensor cores read them."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _step_product(a, b):
    """One wgmma's k-step: each column's eight products summed exactly in
    k order (float64) and rounded once to float32."""
    a, b = a.double(), b.double()
    s = a[:, :1] * b[:1, :]
    for k in range(1, a.shape[1]):
        s = s + a[:, k:k + 1] * b[k:k + 1, :]
    return s.float()


def owned_chunks(n_cols, rank, C):
    """The chunks of a layer of ``n_cols`` columns rank ``rank`` of ``C``
    owns (the kernel's ``owned_chunks``): ``range(first, first + count)``."""
    n = -(-n_cols // CHUNK)
    first = rank * n // C
    return range(first, (rank + 1) * n // C)


def emulate_layer(h, W, b, hidden, C=2):
    """One layer as the kernel computes it, its columns split over ``C``
    ranks, each rank's chunks from its own products."""
    rows, K = h.shape
    N = W.shape[1]
    K_pad, N_pad = -(-K // STAGE) * STAGE, -(-N // CHUNK) * CHUNK
    hp = torch.zeros(rows, K_pad)
    hp[:, :K] = h
    Wp = torch.zeros(K_pad, N_pad)
    Wp[:K, :N] = W
    bp = torch.zeros(N_pad)
    bp[:N] = b
    (ah, al), (wh, wl) = _split(hp), _split(Wp)

    def chain(cols, k_begin, k_end):
        """The k-steps [k_begin, k_end) of columns ``cols``, from zero."""
        acc = torch.zeros(rows, CHUNK)
        for k0 in range(k_begin, k_end, STEP):
            ks = slice(k0, k0 + STEP)
            for x, y in ((al, wh), (ah, wl), (ah, wh)):
                p = _step_product(x[:, ks], y[ks, cols])
                acc = p if k0 == k_begin and x is al else acc + p
        return acc

    out = torch.zeros(rows, N_pad)
    if N_pad == CHUNK:  # one chunk: SEGMENTS fixed K segments, whatever C, added in order
        stages = K_pad // STAGE
        bounds = [s * stages // SEGMENTS * STAGE for s in range(SEGMENTS + 1)]
        parts = [chain(slice(0, CHUNK), bounds[s], bounds[s + 1]) for s in range(SEGMENTS)]
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        v = acc + bp
        out[:] = torch.relu(v) if hidden else v
    for rank in range(C if N_pad > CHUNK else 0):
        for chunk in owned_chunks(N, rank, C):
            cols = slice(chunk * CHUNK, (chunk + 1) * CHUNK)
            v = chain(cols, 0, K_pad) + bp[cols]
            out[:, cols] = torch.relu(v) if hidden else v
    out[:, N:] = 0.0  # the next layer's padding: exact zeros
    return out[:, :N]


def emulate_head(logits, labels):
    """softmax and the first maximal logit's label, NaN the maximum."""
    nan = torch.isnan(logits)
    m = torch.where(nan.any(-1), torch.nan, logits.max(-1).values)
    e = torch.exp(logits - m[:, None])
    probs = e / e.sum(-1, keepdim=True)
    first_nan = torch.where(nan.any(-1), nan.float().argmax(-1), -1)
    top = (logits == logits.max(-1, keepdim=True).values).float().argmax(-1)  # the first maximum
    idx = torch.where(first_nan >= 0, first_nan, top)
    return labels[idx], probs


def emulate_mlp(h, layers, labels, C=2):
    """The kernel's head on its input rows ``h``: (prediction, probabilities)."""
    for i, (W, b) in enumerate(layers):
        h = emulate_layer(h, W, b, hidden=i + 1 < len(layers), C=C)
    return emulate_head(h, labels)


def _run(h, layers, labels, C=2):
    return emulate_mlp(h, [(_t(W), _t(b)) for W, b in layers], _t(labels), C)


#: Clusters of each size that fit on a card at once, as the kernel asks
#: ``cudaOccupancyMaxActiveClusters`` (one block an SM; a cluster's blocks
#: share a GPC): an illustrative table for the rule below, of the order of a
#: 132-SM card's.
ACTIVE_CLUSTERS = {2: 66, 4: 30, 8: 15}


def _cluster_size(widths, rows, active=ACTIVE_CLUSTERS):
    """The kernel's cluster size (``cluster_blocks``): the most blocks whose
    clusters, one a tile, all fit at once; else the fewest that cover the
    widest layer at MAX_CHUNKS chunks a rank."""
    widest = max(-(-w // CHUNK) for w in widths[1:])
    least = 2  # a one-chunk layer's SEGMENTS, at most two a rank
    while least * MAX_CHUNKS < widest:
        least *= 2
    tiles = -(-rows // 64)
    for C in (8, 4, 2):
        if C > least and tiles <= active[C]:
            return C
    return least


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------


def _plain_logits(h, layers):
    h = torch.as_tensor(h)
    for W, b in layers[:-1]:
        h = torch.relu(h @ _t(W) + _t(b))
    return h @ _t(layers[-1][0]) + _t(layers[-1][1])


def _decided(h, layers):
    """Rows whose plain float32 top-two logit gap is above MARGIN."""
    logits = _plain_logits(h, layers)
    if logits.shape[1] < 2:
        return np.ones(logits.shape[0], bool)
    top = torch.topk(logits, 2, dim=1).values
    return (top[:, 0] - top[:, 1] > MARGIN).numpy()


def _assert_within(pred, probs, want_pred, want_probs, decided, where):
    u = ulp_diff(np.asarray(probs, np.float32), np.asarray(want_probs, np.float32))
    assert u <= ENVELOPE, f"{where}: probabilities {u} ulps > {ENVELOPE}"
    np.testing.assert_array_equal(np.asarray(pred)[decided], np.asarray(want_pred)[decided], err_msg=where)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_emulated_kernel_matches_jax_mlp_predict_fn_and_the_plain_version(net, rows):
    widths = NETWORKS[net]
    x, mean, inv_std, layers, labels = _inputs(rows, widths, seed=rows + len(widths))
    h = _scaled(x, mean, inv_std)
    pred, probs = _run(h, layers, labels, C=_cluster_size(widths, rows))
    decided = _decided(h, layers)
    j_idx, j_probs = jk.mlp_predict_fn([(jnp.asarray(W), jnp.asarray(b)) for W, b in layers], h.numpy())
    _assert_within(pred.numpy(), probs.numpy(), labels[np.asarray(j_idx).astype(int)], j_probs, decided,
                   f"{net} rows={rows} vs JAX mlp_predict_fn")
    ops = [RowLocalOp("scale", 0, _t(mean), _t(inv_std), {"with_mean": True, "with_std": True}),
           RowLocalOp("mlp", 1, _t(labels), layers=[(_t(W), _t(b)) for W, b in layers])]
    scaled, p_pred, p_probs = rowlocal_mlp_plain([_t(x)], ops)
    assert torch.equal(scaled, h)
    _assert_within(pred.numpy(), probs.numpy(), p_pred.numpy(), p_probs.numpy(), decided,
                   f"{net} rows={rows} vs rowlocal_mlp_plain")


def _jax_scale_mlp(x, mean, inv_std, layers, labels):
    """The JAX fast tier's one megakernel program on ("scale", "mlp"), run in
    Pallas interpret mode: its outputs by name."""
    sc = jlib.StandardScalerModelServable().set_input_col("features").set_output_col("scaled")
    sc.set_with_mean(True)
    sc.set_with_std(True)
    std = np.where(inv_std == 0.0, 0.0, 1.0 / np.where(inv_std == 0.0, 1.0, inv_std))
    sc.mean, sc.std = mean.astype(np.float64), std
    mlp = jlib.MLPClassifierModelServable().set_features_col("scaled")
    arrays = {"labels": labels.astype(np.float64)}
    for i, (W, b) in enumerate(layers):
        arrays[f"W{i}"], arrays[f"b{i}"] = W, b
    mlp._apply_model_arrays(arrays)
    segs = [s for s in jax_build_segments([sc, mlp], None, JFusionTier("fast"), {}) if isinstance(s, JFusedSegment)]
    ((prog,),) = [s.programs for s in segs]
    assert [s.fusion_op for s in prog.specs] == ["scale", "mlp"]
    mega = jax_build_megakernel_fn(prog.specs, prog.models, prog.inputs, interpret=True)
    return mega(prog.models, {"features": jnp.asarray(x)})


@pytest.mark.parametrize("net", ("256-512-512-8", "100-64-2", "8-16-3"))
def test_emulated_kernel_matches_the_jax_megakernel_in_interpret_mode(net):
    widths = NETWORKS[net]
    rows = 37
    x, mean, inv_std, layers, labels = _inputs(rows, widths, seed=41)
    want = _jax_scale_mlp(x, mean, inv_std, layers, labels)
    h = torch.from_numpy(np.asarray(want["scaled"]).copy())  # the program's own scaled rows
    pred, probs = _run(h, layers, labels, C=_cluster_size(widths, rows))
    _assert_within(pred.numpy(), probs.numpy(), want["prediction"], want["rawPrediction"], _decided(h, layers),
                   f"{net} vs the JAX megakernel")


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_a_rows_outputs_do_not_depend_on_the_cluster_size(net):
    """Every column is summed by the same products in the same k order
    whichever rank owns it: C = 1, 2, 4 and 8 give the same bits."""
    widths = NETWORKS[net]
    x, mean, inv_std, layers, labels = _inputs(5, widths, seed=3)
    h = _scaled(x, mean, inv_std)
    pred, probs = _run(h, layers, labels, C=1)
    for C in (2, 4, MAX_CLUSTER):
        p, q = _run(h, layers, labels, C=C)
        assert torch.equal(p, pred) and torch.equal(q, probs), f"{net} C={C}"


@pytest.mark.parametrize("net", ("256-512-512-8", "limits"))
def test_a_bfloat16_control_lands_outside_the_tolerance(net):
    """The same emulation on inputs and weights rounded to bfloat16 misses
    the plain float32 forward by more than the envelope: the gates can tell
    the kernel's 3×TF32 arithmetic from a 16-bit one."""
    widths = NETWORKS[net]
    x, mean, inv_std, layers, labels = _inputs(65, widths, seed=9)
    h = _scaled(x, mean, inv_std)
    scaled, p_pred, p_probs = rowlocal_mlp_plain(
        [_t(x)], [RowLocalOp("scale", 0, _t(mean), _t(inv_std), {"with_mean": True, "with_std": True}),
                  RowLocalOp("mlp", 1, _t(labels), layers=[(_t(W), _t(b)) for W, b in layers])])
    pred, probs = _run(h, layers, labels)
    assert ulp_diff(probs.numpy(), p_probs.numpy()) <= ENVELOPE

    def bf16(a):
        return torch.as_tensor(a).to(torch.bfloat16).float()

    control = emulate_mlp(bf16(h), [(bf16(W), bf16(b)) for W, b in layers], _t(labels))
    u = ulp_diff(control[1].numpy(), p_probs.numpy())
    assert u > ENVELOPE, f"{net}: the bfloat16 control moved only {u} ulps"


def test_the_head_takes_the_first_maximal_logit_and_nan_as_the_maximum():
    """The kernel's NaN test case (``test_torch_gpu.py``) through the
    emulation: W the identity, so the logits are the rows."""
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [float("nan"), 5.0, float("nan"), 1.0], [-1.0, -1.0, -1.0, -1.0]])
    labels = torch.tensor([10.0, 20.0, 30.0, 40.0])
    pred, probs = emulate_mlp(x, [(torch.eye(4), torch.zeros(4))], labels)
    assert pred.tolist() == [20.0, 10.0, 10.0]
    assert torch.isnan(probs[1]).all() and not torch.isnan(probs[[0, 2]]).any()


@pytest.mark.parametrize("rows", (1, 64, 65, 2049, 4096, 4097, 65536))
@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_the_cluster_covers_every_column_once_and_fits_the_accumulator(net, rows):
    """Every chunk of every layer has exactly one owner, no rank owns more
    than MAX_CHUNKS (the accumulator's registers), and a batch of at most
    one tile gets the largest cluster; the published network at 4096 rows
    the fewest ranks that cover 512 columns (its 64 clusters of 8 would
    not fit at once either)."""
    widths = NETWORKS[net]
    C = _cluster_size(widths, rows)
    assert C in (2, 4, MAX_CLUSTER)
    for n_cols in widths[1:]:
        owned = [list(owned_chunks(n_cols, r, C)) for r in range(C)]
        assert sorted(c for o in owned for c in o) == list(range(-(-n_cols // CHUNK)))
        assert max(len(o) for o in owned) <= MAX_CHUNKS
    if rows <= 64:
        assert C == MAX_CLUSTER
    if net == "256-512-512-8" and rows >= 4096:  # 512 columns need four ranks of two chunks
        assert C == 4


def test_the_stage_layout_holds_each_weight_once_where_wgmma_reads_it():
    """The loader's thread tl writes column n = tl % 64, k rows 4·(tl // 64)
    … + 3 of a k-step as one 16-byte row at kt_offset(n, 4·(tl // 64)); the
    64 x 8 tile it fills is wgmma's K-major B: (n, k) at
    kt_offset(n, k) = ((k // 4)·8 + n // 8)·32 + (n % 8)·4 + k % 4."""
    def kt_offset(r, c, rows=CHUNK):
        return (((c >> 2) * (rows >> 3) + (r >> 3)) << 5) + ((r & 7) << 2) + (c & 3)

    written = {}
    for tl in range(128):
        n, kq = tl % CHUNK, tl // CHUNK
        for m in range(4):
            written[kt_offset(n, 4 * kq) + m] = (n, 4 * kq + m)
    assert sorted(written) == list(range(CHUNK * STEP))
    assert all(kt_offset(n, k) == off for off, (n, k) in written.items())
