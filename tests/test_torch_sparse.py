"""The port's sparse serving slice against the JAX package on the CPU: the
calling convention (``ladder_cap``, packing, the warm-cap ladder, the
readback), the segment-reduce functions of ``ops/kernels``, the sparse
megakernel's wrapper on CPU tensors, IDF fit and transform, the
LogisticRegression model's and servable's sparse transform, the sparse
serving plan in both fusion tiers (the JAX megakernel in Pallas interpret
mode, as ``tests/test_sparse_fastpath.py`` runs it), the server end to end,
and IDF → LogisticRegression saved in one package and loaded in the other.
Tests of the CUDA kernel itself are in ``test_torch_gpu.py``.

Tolerances, each with its reason:
- packing, ``segment_sum``, ``sparse_dot_fn``, ``sparse_idf_scale_fn`` and
  the tf-idf column: bit-equal (single correctly rounded float32 operations,
  and the margin a sequential fold in slot order in both packages; sums
  compare as float32 ulps, which count ±0 as one value, see
  ``test_segment_reduce_functions_bit_equal_to_jax``);
- ``idf`` and ``doc_freq`` of ``IDF.fit``: rtol 1e-12 (float64 host math);
- rawPrediction: within ``ULP_ENVELOPE["sparse_idf_logistic"]`` — the
  margins are bit-equal, the two frameworks' sigmoids may round differently
  (``test_raw_ulps_recorded`` reports the measured distance); prediction:
  equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flink_ml_tpu.ops.kernels as jk
import flink_ml_tpu.servable.lib as jlib
import flink_ml_tpu.utils.read_write as jrw
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.builder.pipeline import PipelineModel as JPipelineModel
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.linalg.sparse_batch import ladder_cap as jladder_cap
from flink_ml_tpu.linalg.vectors import SparseVector as JSparseVector
from flink_ml_tpu.models.classification.logistic_regression import (
    LogisticRegressionModel as JLRModel,
)
from flink_ml_tpu.models.feature.idf import IDF as JIDF, IDFModel as JIDFModel
from flink_ml_tpu.servable.api import load_servable as jax_load_servable
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipeline
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier, chain_score as jax_chain_score
from flink_ml_tpu.servable.sparse import (
    OffLadderError as JOffLadderError,
    pack_sparse_column as jpack,
    rebuild_sparse_column as jrebuild,
    resolve_warm_caps as jwarm_caps,
)
from flink_ml_tpu.serving.batcher import pad_to as jpad_to
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan

import flink_ml_tpu_torch.ops.kernels as tk
from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.linalg.sparse_batch import ladder_cap
from flink_ml_tpu_torch.linalg.vectors import SparseVector
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
from flink_ml_tpu_torch.models.feature.idf import IDF, IDFModel
from flink_ml_tpu_torch.servable import (
    LogisticRegressionModelServable,
    PipelineModelServable,
    load_servable,
)
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, FusionTier, chain_score, ulp_diff
from flink_ml_tpu_torch.servable.megakernels import (
    SPARSE_IDF_LOGISTIC,
    chain_eligible,
    sparse_idf_logistic,
    sparse_idf_logistic_plain,
)
from flink_ml_tpu_torch.servable.sparse import (
    OffLadderError,
    pack_sparse_column,
    rebuild_sparse_column,
    resolve_sparse_hints,
    resolve_warm_caps,
)
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
from flink_ml_tpu_torch.serving.batcher import pad_to
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

DIMS = (8, 64, 256)
CAPS = (1, 2, 4, 8, 16, 32, 64)
ENVELOPE = ULP_ENVELOPE["sparse_idf_logistic"]
COLS = ("features", "tfidf", "prediction", "rawPrediction")


@pytest.fixture(autouse=True)
def _reset_sparse_config():
    """Every option a test here sets, in either package, is unset after it:
    the test workers run other files in the same process."""
    yield
    for opt in (Options.SPARSE_FASTPATH, Options.SPARSE_NNZ_CAP_MAX, Options.SPARSE_WARMUP_CAPS,
                Options.FUSION_MEGAKERNEL_MIN_SCORE):
        config.unset(opt)
    for opt in (JOptions.SPARSE_FASTPATH, JOptions.SPARSE_NNZ_CAP_MAX, JOptions.SPARSE_WARMUP_CAPS):
        jconfig.unset(opt)


def _set_both(option: str, value) -> None:
    config.set(getattr(Options, option), value)
    jconfig.set(getattr(JOptions, option), value)


def _rows(n, dim, max_nnz, seed, min_nnz=0):
    """``n`` rows of sorted unique ids in [0, dim) with 0..max_nnz entries,
    values from a seeded numpy generator; some values are exact zeros."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(min_nnz, min(max_nnz, dim) + 1))
        idx = np.sort(rng.choice(dim, size=k, replace=False))
        vals = rng.normal(size=k) * (rng.random(k) > 0.1)
        out.append((idx, vals))
    return out


def _frames(rows, dim):
    """The same sparse rows as a port DataFrame and a JAX DataFrame."""
    return (
        DataFrame.from_dict({"features": [SparseVector(dim, i, v) for i, v in rows]}),
        JDataFrame.from_dict({"features": [JSparseVector(dim, i, v) for i, v in rows]}),
    )


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_sparse_columns_equal(port_col, jax_col):
    assert len(port_col) == len(jax_col)
    for p, j in zip(port_col, jax_col):
        assert p.size() == j.size()
        np.testing.assert_array_equal(p.indices, np.asarray(j.indices))
        np.testing.assert_array_equal(np.asarray(p.values).view(np.int64),
                                      np.asarray(j.values, np.float64).view(np.int64))


# ---------------------------------------------------------------------------
# the calling convention
# ---------------------------------------------------------------------------


def test_ladder_cap_matches_jax():
    for k in range(0, 140):
        assert ladder_cap(k) == jladder_cap(k), k


@pytest.mark.parametrize("dim,max_nnz,cap,cap_max,truncate", [
    (8, 5, None, None, False),
    (64, 33, None, None, False),
    (256, 64, None, 64, False),
    (64, 9, 4, None, True),  # warmup: a forced rung clips longer rows
    (64, 3, 16, None, False),  # a forced rung above the natural one pads
    (256, 0, None, None, False),  # every row empty: cap floor 1
])
def test_pack_sparse_column_matches_jax(dim, max_nnz, cap, cap_max, truncate):
    pdf, jdf = _frames(_rows(33, dim, max_nnz, seed=dim + max_nnz), dim)
    port = pack_sparse_column(pdf, "features", cap=cap, cap_max=cap_max, truncate=truncate)
    ref = jpack(jdf, "features", cap=cap, cap_max=cap_max, truncate=truncate)
    assert port[1:] == ref[1:]  # cap, dim, nnz total
    assert port[0].keys() == ref[0].keys()
    for name, arr in port[0].items():
        assert arr.dtype == ref[0][name].dtype, name
        np.testing.assert_array_equal(arr, ref[0][name], err_msg=name)


def test_pack_raises_off_ladder_and_on_dim_mismatch_as_jax():
    pdf, jdf = _frames(_rows(6, 64, 40, seed=2, min_nnz=40), 64)
    with pytest.raises(OffLadderError):
        pack_sparse_column(pdf, "features", cap_max=16)
    with pytest.raises(JOffLadderError):
        jpack(jdf, "features", cap_max=16)
    with pytest.raises(OffLadderError):
        pack_sparse_column(pdf, "features", cap=8)
    with pytest.raises(ValueError, match="dims"):
        pack_sparse_column(pdf, "features", dim=65)


@pytest.mark.parametrize("cap_max,caps", [
    (None, None), (16, None), (16, "1,5,16"), (64, "3"), (4, "32,64"), (1, None),
])
def test_resolve_warm_caps_matches_jax(cap_max, caps):
    if cap_max is not None:
        _set_both("SPARSE_NNZ_CAP_MAX", cap_max)
    if caps is not None:
        _set_both("SPARSE_WARMUP_CAPS", caps)
    assert resolve_warm_caps() == jwarm_caps()


def test_rebuild_sparse_column_matches_jax():
    rng = np.random.default_rng(5)
    n, K, dim = 17, 8, 100
    nnz = rng.integers(0, K + 1, n).astype(np.int32)
    ids = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K), np.float32)
    for i, k in enumerate(nnz):
        ids[i, :k] = np.sort(rng.choice(dim, k, replace=False))
        vals[i, :k] = rng.normal(size=k)
    port = rebuild_sparse_column(dim, vals.astype(np.float64), ids.astype(np.int64), nnz.astype(np.int64))
    _assert_sparse_columns_equal(port, jrebuild(dim, vals, ids, nnz))
    pdf, _ = _frames(_rows(9, dim, 7, seed=6), dim)
    arrays, _cap, _dim, _ = pack_sparse_column(pdf, "features")
    back = rebuild_sparse_column(dim, *(arrays[f"features!{p}"] for p in ("values", "ids", "nnz")))
    for a, b in zip(back, pdf.column("features")):  # the inverse of packing
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values.astype(np.float32))


# ---------------------------------------------------------------------------
# ops/kernels: the segment reduce, bit for bit
# ---------------------------------------------------------------------------


def _packed(dim, cap, seed, n=40):
    """values/ids at ``cap`` with live and padding slots, and model vectors
    holding a zero and a negative zero (no subnormals: XLA on the CPU
    flushes them to zero, PyTorch does not)."""
    rng = np.random.default_rng(seed)
    live = rng.integers(0, cap + 1, n)
    ids = np.zeros((n, cap), np.int32)
    vals = np.zeros((n, cap), np.float32)
    for i, k in enumerate(live):
        k = min(int(k), dim)
        ids[i, :k] = np.sort(rng.choice(dim, k, replace=False))
        vals[i, :k] = rng.normal(size=k) * 3
    vec = rng.normal(size=(2, dim)).astype(np.float32)
    vec[:, 0] = [0.0, -0.0]
    return vals, ids, vec[0], vec[1]


@jax.jit
def _jax_reduce(cases):
    """The JAX package's three functions at every cap's shape, as its plans
    run them (jitted; one program for all caps keeps compiles few)."""
    out = []
    for terms, vals, ids, idf, coef in cases:
        scaled = jk.sparse_idf_scale_fn(vals, ids, idf)
        out.append((jk.segment_sum(terms), scaled, jk.sparse_dot_fn(scaled, ids, coef)))
    return out


@pytest.mark.parametrize("dim", DIMS)
def test_segment_reduce_functions_bit_equal_to_jax(dim):
    cases = []
    for cap in CAPS:
        vals, ids, idf, coef = _packed(dim, cap, seed=dim * 100 + cap)
        terms = vals * np.float32(-1.5)
        terms[:, ::3] = -0.0  # signed zeros: the +0.0 start decides an all-zero row's sign
        cases.append((terms, vals, ids, idf, coef))
    refs = _jax_reduce([tuple(jnp.asarray(a) for a in case) for case in cases])
    for cap, (terms, vals, ids, idf, coef), (ref_sum, ref_scaled, ref_dot) in zip(CAPS, cases, refs):
        port_scaled = tk.sparse_idf_scale_fn(_t(vals), _t(ids, np.int32), _t(idf))
        np.testing.assert_array_equal(_bits(port_scaled.numpy()), _bits(ref_scaled))
        # Sums compare as float32 ulps, which count ±0 as one value: under
        # jit XLA simplifies 0 + x to x, so a row of -0.0 terms sums to -0.0
        # there and to +0.0 in a strict fold (and in the JAX package run
        # eagerly). Every other bit matches.
        port_sum = tk.segment_sum(_t(terms)).numpy()
        port_dot = tk.sparse_dot_fn(port_scaled, _t(ids, np.int32), _t(coef)).numpy()
        assert ulp_diff(port_sum, ref_sum) == 0, f"cap {cap}"
        assert ulp_diff(port_dot, ref_dot) == 0, f"cap {cap}"
        assert not np.signbit(port_sum[(terms == 0).all(axis=1)]).any()  # the strict fold's +0.0


def test_out_of_range_ids_gather_as_jax_does():
    vec = np.arange(5, dtype=np.float32) + 1
    ids = np.array([[7, -1, -9, 4, 0]], np.int32)
    vals = np.ones((1, 5), np.float32)
    np.testing.assert_array_equal(
        tk.sparse_idf_scale_fn(_t(vals), _t(ids, np.int32), _t(vec)).numpy(),
        np.asarray(jk.sparse_idf_scale_fn(jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(vec))),
    )


@pytest.mark.parametrize("dim", DIMS)
def test_margin_is_bit_invariant_across_the_ladder(dim):
    pdf, jdf = _frames(_rows(40, dim, 9, seed=dim), dim)
    coef = _t(np.random.default_rng(dim).normal(size=dim))
    jarrays, jcap, _, _ = jpack(jdf, "features")
    natural = None
    for cap in CAPS:
        if cap < jcap:
            continue  # below the longest row: not a rung this batch can take
        arrays, _, _, _ = pack_sparse_column(pdf, "features", cap=cap)
        margin = tk.sparse_dot_fn(_t(arrays["features!values"]), _t(arrays["features!ids"], np.int32), coef)
        natural = margin if natural is None else natural
        assert torch.equal(margin, natural), f"cap {cap}"
    ref = jk.sparse_dot_fn(jnp.asarray(jarrays["features!values"]), jnp.asarray(jarrays["features!ids"]),
                           jnp.asarray(coef.numpy()))
    assert jcap == ladder_cap(max(len(v.indices) for v in pdf.column("features")))
    np.testing.assert_array_equal(_bits(natural.numpy()), _bits(ref))


# ---------------------------------------------------------------------------
# the megakernel wrapper on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_idf,write_tfidf", [(True, True), (True, False), (False, False)])
def test_sparse_megakernel_wrapper_runs_the_plain_version_on_cpu(with_idf, write_tfidf):
    vals, ids, idf, coef = _packed(256, 16, seed=4)
    args = (_t(vals), _t(ids, np.int32), _t(idf) if with_idf else None, _t(coef))
    before = SPARSE_IDF_LOGISTIC.launches
    tfidf, margin, pred, raw = sparse_idf_logistic(*args, write_tfidf=write_tfidf)
    p_tfidf, p_margin, p_pred, p_raw = sparse_idf_logistic_plain(*args)
    assert SPARSE_IDF_LOGISTIC.launches == before  # the count is of kernel launches only
    assert (tfidf is None) == (not write_tfidf) and (p_tfidf is None) == (not with_idf)
    if write_tfidf:
        assert torch.equal(tfidf, p_tfidf)
    for a, b in ((margin, p_margin), (pred, p_pred), (raw, p_raw)):
        assert torch.equal(a, b)
    ref_in = (tk.sparse_idf_scale_fn(*args[:3]) if with_idf else args[0])
    assert torch.equal(margin, tk.sparse_dot_fn(ref_in, args[1], args[3]))


def test_sparse_megakernel_wrapper_refuses_what_it_has_no_path_for():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        sparse_idf_logistic(x, x.int(), None, torch.empty(8, device="meta"), write_tfidf=False)
    with pytest.raises(ValueError, match="needs the idf"):
        sparse_idf_logistic(torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32), None,
                            torch.zeros(8), write_tfidf=True)
    if not torch.cuda.is_available():
        before = SPARSE_IDF_LOGISTIC.launches
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SPARSE_IDF_LOGISTIC.launch(*([None] * 8 + [1, 8, 8, 0, 0, None]))
        assert SPARSE_IDF_LOGISTIC.launches == before


def test_sparse_megakernel_is_registered_with_its_source():
    assert SPARSE_IDF_LOGISTIC in native.KERNELS
    assert SPARSE_IDF_LOGISTIC.source_path == "flink_ml_tpu_torch/csrc/megakernel_sparse_idf_logistic.cu"
    assert (native.CSRC_DIR / SPARSE_IDF_LOGISTIC.source).is_file()
    assert SPARSE_IDF_LOGISTIC.replaces == "flink_ml_tpu/servable/megakernels.py:180"


# ---------------------------------------------------------------------------
# the models, the serving plan and the server
# ---------------------------------------------------------------------------


def _fitted_pair(dim, seed=3, n=48, max_nnz=9):
    """IDF fitted on seeded rows by each package, and a LogisticRegression
    of seeded coefficients: ``(port pipeline, JAX pipeline, rows)``."""
    rows = _rows(n, dim, max_nnz, seed)
    pdf, jdf = _frames(rows, dim)
    coef = np.random.default_rng(seed + 1).normal(size=dim) * 2.0

    def lr(cls):
        m = cls().set_features_col("tfidf")
        m.coefficient = coef
        return m

    port = PipelineModelServable([
        IDF().set_input_col("features").set_output_col("tfidf").fit(pdf),
        lr(LogisticRegressionModelServable),
    ])
    ref = JPipeline([
        JIDF().set_input_col("features").set_output_col("tfidf").fit(jdf),
        lr(jlib.LogisticRegressionModelServable),
    ])
    return port, ref, rows


def _assert_same_answers(port_df, jax_df, rows=None):
    n = len(port_df) if rows is None else rows
    _assert_sparse_columns_equal(port_df.column("tfidf")[:n], jax_df.column("tfidf")[:n])
    np.testing.assert_array_equal(np.asarray(port_df.column("prediction"))[:n],
                                  np.asarray(jax_df.column("prediction"))[:n])
    u = ulp_diff(np.asarray(port_df.column("rawPrediction"))[:n],
                 np.asarray(jax_df.column("rawPrediction"))[:n])
    assert u <= ENVELOPE, f"rawPrediction moved {u} ulps"
    return u


# ---------------------------------------------------------------------------
# IDF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("min_doc_freq", (0, 2))
def test_idf_fit_matches_jax(dim, min_doc_freq):
    rows = _rows(50, dim, 12, seed=dim + min_doc_freq)
    pdf, jdf = _frames(rows, dim)
    dense = np.stack([np.bincount(i, weights=v, minlength=dim) for i, v in rows])
    for port_df, jax_df in ((pdf, jdf), (DataFrame.from_dict({"features": dense}),
                                         JDataFrame.from_dict({"features": dense}))):
        port = IDF().set_input_col("features").set_output_col("o").set_min_doc_freq(min_doc_freq).fit(port_df)
        ref = JIDF().set_input_col("features").set_output_col("o").set_min_doc_freq(min_doc_freq).fit(jax_df)
        np.testing.assert_allclose(port.idf, ref.idf, rtol=1e-12)
        np.testing.assert_allclose(port.doc_freq, ref.doc_freq, rtol=1e-12)
        np.testing.assert_array_equal(port.num_docs, ref.num_docs)
        assert port.param_map_to_json() == ref.param_map_to_json()


@pytest.mark.parametrize("dim", DIMS)
def test_idf_transform_matches_jax_on_dense_and_sparse_input(dim):
    rows = _rows(30, dim, 11, seed=dim + 7)
    pdf, jdf = _frames(rows, dim)
    ref_model = JIDF().set_input_col("features").set_output_col("tfidf").fit(jdf)
    port_model = IDFModel().set_input_col("features").set_output_col("tfidf")
    port_model.idf, port_model.doc_freq, port_model.num_docs = ref_model.idf, ref_model.doc_freq, ref_model.num_docs
    _assert_sparse_columns_equal(port_model.transform(pdf, device="cpu").column("tfidf"),
                                 ref_model.transform(jdf).column("tfidf"))
    dense = np.random.default_rng(dim).normal(size=(30, dim))
    port = port_model.transform(DataFrame.from_dict({"features": dense}), device="cpu").column("tfidf")
    ref = np.asarray(ref_model.transform(JDataFrame.from_dict({"features": dense})).column("tfidf"))
    assert port.dtype == np.float64
    np.testing.assert_array_equal(port, ref)
    empty = port_model.transform(DataFrame.from_dict({"features": []}), device="cpu")
    assert len(empty.column("tfidf")) == 0


# ---------------------------------------------------------------------------
# sparse transforms never densify
# ---------------------------------------------------------------------------


def _no_vectors(monkeypatch):
    def refuse(self, name):
        raise AssertionError(f"DataFrame.vectors({name!r}) densified a column")

    monkeypatch.setattr(DataFrame, "vectors", refuse)


@pytest.mark.parametrize("entry", ["servable", "model", "idf", "plan"])
def test_sparse_columns_are_never_densified(entry, monkeypatch):
    port, _, rows = _fitted_pair(64)
    pdf = pad_to(_frames(rows, 64)[0], 64)  # one length: CPU torch rounds a tensor's tail apart
    idf, lr_servable = port.servables
    expected = port.transform(pdf, device="cpu")
    _no_vectors(monkeypatch)
    if entry == "servable":
        out = lr_servable.transform(expected, device="cpu")
    elif entry == "model":
        model = LogisticRegressionModel().set_features_col("tfidf")
        model.coefficient = lr_servable.coefficient
        out = model.transform(expected, device="cpu")
    elif entry == "idf":
        out = idf.transform(pdf, device="cpu")
    else:
        plan = CompiledServingPlan.build(port, scope="tsp-nodense", device="cpu",
                                         sparse=resolve_sparse_hints(pdf))
        out = plan.execute(pdf)
    for name in out.get_column_names():
        if name in ("prediction", "rawPrediction"):
            np.testing.assert_array_equal(out.column(name), expected.column(name))
        elif name == "tfidf":
            _assert_sparse_columns_equal(out.column(name), expected.column(name))


# ---------------------------------------------------------------------------
# the LogisticRegression model and servable against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", DIMS)
def test_logistic_sparse_transform_matches_jax(dim):
    rows = _rows(40, dim, 13, seed=dim + 11)
    pdf, jdf = _frames(rows, dim)
    coef = np.random.default_rng(dim).normal(size=dim) * 3
    model, servable = LogisticRegressionModel(), LogisticRegressionModelServable()
    jmodel, jservable = JLRModel(), jlib.LogisticRegressionModelServable()
    for m in (model, servable, jmodel, jservable):
        m.coefficient = coef
    outs = [model.transform(pdf, device="cpu"), servable.transform(pdf, device="cpu")]
    refs = [jmodel.transform(jdf), jservable.transform(jdf)]
    for out in outs:
        for ref in refs:
            np.testing.assert_array_equal(out.column("prediction"), np.asarray(ref.column("prediction")))
            assert ulp_diff(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction"))) <= ENVELOPE
    np.testing.assert_array_equal(outs[0].column("rawPrediction"), outs[1].column("rawPrediction"))


def test_raw_ulps_recorded():
    """The measured distance of the port's rawPrediction from the JAX
    package's, over the three widths (printed with ``-s``): the margins are
    bit-equal, so it is the two sigmoids' rounding alone."""
    worst = 0
    for dim in DIMS:
        port, ref, rows = _fitted_pair(dim, seed=dim)
        pdf, jdf = _frames(rows, dim)
        worst = max(worst, _assert_same_answers(port.transform(pdf, device="cpu"), ref.transform(jdf)))
    print(f"rawPrediction: at most {worst} float32 ulps from the JAX package")
    assert worst <= ENVELOPE


# ---------------------------------------------------------------------------
# the serving plan against the JAX package's
# ---------------------------------------------------------------------------


def test_a_sparse_template_builds_sparse_segments():
    port, _, rows = _fitted_pair(32)
    pdf, _ = _frames(rows, 32)
    sparse_plan = CompiledServingPlan.build(port, scope="tsp-seg", device="cpu",
                                            sparse=resolve_sparse_hints(pdf))
    (seg,) = sparse_plan.segments
    assert seg.has_sparse_inputs and seg.external_inputs == ("features",)
    assert [s.fusion_op for s in seg.specs] == ["sparse_idf", "sparse_logistic"]
    assert seg.specs[0].sparse_outputs == {"tfidf": 32}
    assert seg.programs[0].inputs == ("features!values", "features!ids", "features!nnz")
    dense_plan = CompiledServingPlan.build(port, scope="tsp-seg-d", device="cpu", sparse={})
    assert [s.fusion_op for s in dense_plan.segments[0].specs] == ["idf", "logistic"]
    assert not dense_plan.segments[0].has_sparse_inputs


def test_cost_model_prices_sparse_chains_as_jax():
    port, ref, rows = _fitted_pair(1 << 12)
    hints = {"features": 1 << 12}
    port_specs = [port.servables[0].sparse_kernel_spec(hints),
                  port.servables[1].sparse_kernel_spec({"tfidf": 1 << 12})]
    jax_specs = [ref.servables[0].sparse_kernel_spec(hints),
                 ref.servables[1].sparse_kernel_spec({"tfidf": 1 << 12})]
    tier, jtier = FusionTier("fast"), JFusionTier("fast")
    for rows_ in (1, 7, 64, 1024, 4096):
        for cap in CAPS:
            assert chain_score(port_specs, rows_, 0, cap) == jax_chain_score(jax_specs, rows_, 0, cap)
            assert tier.megakernel_hot(port_specs, rows_, 0, cap) == jtier.megakernel_hot(jax_specs, rows_, 0, cap)
    assert chain_eligible(port_specs) and chain_eligible(port_specs[1:])


def test_fast_plan_matches_jax_megakernel_plan():
    """Both packages' plans at fusion fast (every key hot): the JAX side's
    Pallas megakernel in interpret mode, the port's megakernel program on CPU
    tensors (its plain version). The same warm keys, the same answers at
    every cap of the ladder, no chain built after warmup."""
    dim = 64
    _set_both("SPARSE_NNZ_CAP_MAX", 8)
    port, ref, rows = _fitted_pair(dim, max_nnz=8)
    pdf, jdf = _frames(rows, dim)
    plan = CompiledServingPlan.build(port, scope="tsp-fast", device="cpu",
                                     fusion=FusionTier("fast", min_score=0), sparse={"features": dim})
    jplan = JPlan.build(ref, scope="tsp-fast-jax", fusion=JFusionTier("fast", min_score=0),
                        sparse={"features": dim})
    plan.warmup(pdf.take([0]), (8,))
    jplan.warmup(jdf.take([0]), (8,))
    (seg,), (jseg,) = plan.segments, jplan.segments
    assert set(seg.compiled) == set(jseg.compiled) == {(8, 1), (8, 2), (8, 4), (8, 8)}
    assert all(k == ("megakernel",) for k in chain_kinds(plan).values())
    assert {jseg.plan_label(k) for k in jseg.compiled} == {"fast+mega"}
    for max_nnz in (0, 1, 2, 3, 5, 8):
        batch = [r for r in rows if len(r[0]) <= max_nnz][:8]
        bdf, bjdf = _frames(batch, dim)
        out = plan.execute(pad_to(bdf, 8))
        jout = jplan.execute(jpad_to(bjdf, 8))
        _assert_same_answers(out, jout)
    assert set(seg.compiled) == set(jseg.compiled)  # nothing built after warmup
    assert metrics.get("tsp-fast", MLMetrics.SERVING_FASTPATH_COMPILES, 0) == 0


def test_off_ladder_batch_falls_back_under_its_reason():
    dim = 64
    config.set(Options.SPARSE_NNZ_CAP_MAX, 8)
    port, ref, _ = _fitted_pair(dim)
    long_rows = _rows(5, dim, 20, seed=9, min_nnz=9)
    pdf, jdf = _frames(long_rows, dim)
    plan = CompiledServingPlan.build(port, scope="tsp-off", device="cpu",
                                     fusion=FusionTier("fast", min_score=0), sparse={"features": dim})
    out = plan.execute(pad_to(pdf, 8))
    assert metrics.get("tsp-off", MLMetrics.fallback_reason("serving", "off_ladder"), 0) == 1
    assert metrics.get("tsp-off", MLMetrics.SERVING_FALLBACK_BATCHES, 0) == 1
    _assert_same_answers(out, ref.transform(jpad_to(jdf, 8)))


def test_dense_template_with_sparse_traffic_falls_back_under_sparse():
    dim = 16
    port, ref, rows = _fitted_pair(dim)
    pdf, jdf = _frames(rows[:5], dim)
    dense = DataFrame.from_dict({"features": np.zeros((1, dim))})
    cfg = ServingConfig(max_batch_size=8, max_delay_ms=0.0, fusion_mode="fast")
    with InferenceServer(port, name="tsp-densetpl", serving_config=cfg, device="cpu",
                         warmup_template=dense) as srv:
        resp = srv.predict(pdf)
    assert metrics.get(srv.scope, MLMetrics.fallback_reason("serving", "sparse"), 0) == 1
    _assert_same_answers(resp.dataframe, ref.transform(jdf))


def test_sparse_fastpath_off_restores_per_stage_serving():
    dim = 16
    config.set(Options.SPARSE_FASTPATH, False)
    port, ref, rows = _fitted_pair(dim)
    pdf, jdf = _frames(rows[:6], dim)
    assert resolve_sparse_hints(pdf) is None
    cfg = ServingConfig(max_batch_size=8, max_delay_ms=0.0, fusion_mode="fast")
    with InferenceServer(port, name="tsp-off-conv", serving_config=cfg, device="cpu",
                         warmup_template=pdf.take([0])) as srv:
        resp = srv.predict(pdf)
        plan = port._fastpath_plan
    assert plan.sparse_hints is None and not plan.segments[0].has_sparse_inputs
    assert metrics.get(srv.scope, MLMetrics.fallback_reason("serving", "sparse"), 0) == 1
    _assert_same_answers(resp.dataframe, ref.transform(jdf))


def test_inference_server_serves_sparse_traffic_end_to_end():
    dim = 256
    config.set(Options.SPARSE_WARMUP_CAPS, "4,16")
    config.set(Options.SPARSE_NNZ_CAP_MAX, 16)
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 2000)
    port, ref, rows = _fitted_pair(dim, n=60, max_nnz=16)
    pdf, jdf = _frames(rows, dim)
    cfg = ServingConfig(max_batch_size=16, max_delay_ms=0.5, fusion_mode="fast")
    sizes = [1, 5, 16, 3, 9, 16, 2, 8]
    starts = np.cumsum([0] + sizes[:-1]) % 40
    expected = ref.transform(jdf)  # row-wise: a row's answer is its own
    with InferenceServer(port, name="tsp-e2e", serving_config=cfg, device="cpu",
                         warmup_template=pdf.take([0])) as srv:
        for start, n in zip(starts, sizes):
            take = np.arange(start, start + n)
            resp = srv.predict(pdf.take(take))
            assert resp.dataframe.get_column_names() == list(COLS)
            _assert_same_answers(resp.dataframe, expected.take(take))
    assert metrics.get(srv.scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) == 0
    assert metrics.get(srv.scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) == 0
    # score = rows × 2 × (8 + 8 · cap): ≥ 2000 only at cap 16 from bucket 8
    hot = {(8, 16), (16, 16)}
    assert chain_kinds(port._fastpath_plan) == {
        (b, c): ("megakernel",) if (b, c) in hot else ("fused",)
        for b in (1, 2, 4, 8, 16) for c in (4, 16)
    }


# ---------------------------------------------------------------------------
# IDF → LogisticRegression saved in one package, loaded in the other
# ---------------------------------------------------------------------------


def test_jax_saved_pipeline_loads_into_the_port(tmp_path):
    dim = 64
    _, ref, rows = _fitted_pair(dim)
    jidf, jlr = ref.servables
    jmodel = JLRModel().set_features_col("tfidf")
    jmodel.coefficient = jlr.coefficient
    path = str(tmp_path / "jax-pipeline")
    JPipelineModel([jidf, jmodel]).save(path)
    port = load_servable(path)
    assert isinstance(port, PipelineModelServable)
    assert [type(s) for s in port.servables] == [IDFModel, LogisticRegressionModelServable]
    assert port.servables[0].param_map_to_json() == jidf.param_map_to_json()
    for name in ("idf", "doc_freq", "num_docs"):
        np.testing.assert_array_equal(getattr(port.servables[0], name), getattr(jidf, name))
    assert isinstance(rw.load_stage(f"{path}/stages/00000000"), IDFModel)
    pdf, jdf = _frames(rows, dim)
    _assert_same_answers(port.transform(pdf, device="cpu"), jax_load_servable(path).transform(jdf))


def test_port_saved_models_load_in_jax(tmp_path):
    dim = 64
    port, _, rows = _fitted_pair(dim)
    idf, lr = port.servables
    model = LogisticRegressionModel().set_features_col("tfidf")
    model.coefficient = lr.coefficient
    idf_dir, lr_dir = str(tmp_path / "idf"), str(tmp_path / "lr")
    idf.save(idf_dir)
    model.save(lr_dir)
    # the port's own load path, as the serving phase of chip_smoke.py uses it
    loaded = PipelineModelServable([load_servable(idf_dir), load_servable(lr_dir)])
    # the JAX package reads the same files: metadata JSON + model_data.npz
    jidf = JIDFModel()
    jidf.load_param_map_from_json(jrw.load_metadata(idf_dir)["paramMap"])
    jidf._set_model_arrays(jrw.load_model_arrays(idf_dir))
    jax_pipe = JPipeline([jidf, JLRModel.load_servable(lr_dir)])
    pdf, jdf = _frames(rows, dim)
    out = loaded.transform(pdf, device="cpu")
    _assert_same_answers(out, jax_pipe.transform(jdf))
    _assert_sparse_columns_equal(out.column("tfidf"), port.transform(pdf, device="cpu").column("tfidf"))


def test_class_table_loads_idf_models_by_both_names():
    jax_name = "flink_ml_tpu.models.feature.idf.IDFModel"
    assert rw.resolve_class(jax_name) is IDFModel
    assert rw.resolve_class(jax_name, stage=True) is IDFModel
    assert rw.resolve_class(rw.stage_class_name(IDFModel)) is IDFModel
