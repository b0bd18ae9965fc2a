"""The port's feature-chain slice against the JAX package on the CPU: the
``normalize``/``elementwise_product``/``binarize``/``impute`` bodies of
``ops/kernels``, the Normalizer, ElementwiseProduct, Binarizer and Imputer
stages (transform, ``Imputer.fit`` for the three strategies, their kernel
specs), the ``scalar`` input kind and the shape-following readback, save and
load both ways through ``CLASS_TABLE``, the serving plan of the feature6
chain (``bench.py`` ``_make_feature6_stages``) with and without the logistic
head in both fusion tiers — the port's row-local megakernel program (its
plain version on CPU tensors) against the JAX Pallas megakernel in
interpret mode, as ``tests/test_fusion.py`` runs it — the cost model's
choice per bucket, and the ``rowlocal_chain`` wrapper's device rule. Tests of
the CUDA kernel itself are in ``test_torch_gpu.py``.

Tolerances, each with its reason:
- elementwise bodies, scale, product, idf, binarize, impute and everything
  before a normalize: bit-equal (correctly rounded float32 operations, the
  thresholds and placeholders rounded to float32 in both packages);
- from a normalize on: ``ULP_ENVELOPE["feature6"]`` = 1024 ulps, the fast
  tier's contract for this chain — the row sum may run in another order;
- a binarize of such a value: equal wherever the value lies more than
  ``BIN_MARGIN`` = 1e-5 from the threshold (one ulp more or less flips 0 and
  1); the rows with an entry inside are counted and left out of the head;
- the logistic head on the remaining rows: the probability
  rawPrediction[:, 1] within the same 1024 ulps and rawPrediction[:, 0]
  equal to 1 − it in float32 in both packages (the ulp distance of 1 − p
  itself is ill-conditioned where p rounds near 1: one ulp of p moves it by
  2^-24 absolute), prediction equal where the float64 margin exceeds 1e-4.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.ops.kernels as jk
import flink_ml_tpu.servable.lib as jlib
import flink_ml_tpu.utils.read_write as jrw
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.builder.pipeline import PipelineModel as JPipelineModel
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.linalg.vectors import SparseVector as JSparseVector
from flink_ml_tpu.models.feature.binarizer import Binarizer as JBinarizer
from flink_ml_tpu.models.feature.elementwise_product import ElementwiseProduct as JElementwiseProduct
from flink_ml_tpu.models.feature.idf import IDFModel as JIDFModel
from flink_ml_tpu.models.feature.imputer import Imputer as JImputer, ImputerModel as JImputerModel
from flink_ml_tpu.models.feature.normalizer import Normalizer as JNormalizer
from flink_ml_tpu.models.feature.standard_scaler import StandardScalerModel as JStandardScalerModel
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipeline
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan

import flink_ml_tpu_torch.ops.kernels as tk
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector
from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
from flink_ml_tpu_torch.models.feature.elementwise_product import ElementwiseProduct
from flink_ml_tpu_torch.models.feature.idf import IDFModel
from flink_ml_tpu_torch.models.feature.imputer import Imputer, ImputerModel
from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScalerModel
from flink_ml_tpu_torch.params.shared import HasInputCols, HasOutputCols, HasRelativeError
from flink_ml_tpu_torch.servable import (
    LogisticRegressionModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
    load_servable,
)
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, FusionTier, chain_score, ulp_diff
from flink_ml_tpu_torch.servable.megakernels import (
    ROWLOCAL,
    RowLocalOp,
    chain_eligible,
    rowlocal_chain,
    rowlocal_chain_plain,
)
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

ENVELOPE = ULP_ENVELOPE["feature6"]
BIN_MARGIN = 1e-5
PREDICTION_MARGIN = 1e-4
N = 203  # odd: the JAX megakernel's single-tile tail path
FEATURE6_COLS = ("scaled", "norm", "weighted", "tfidf", "rescaled")


@pytest.fixture(autouse=True)
def _reset_config():
    """Every option a test here sets is unset after it: the test workers run
    other files in the same process."""
    yield
    config.unset(Options.FUSION_MEGAKERNEL_MIN_SCORE)
    jconfig.unset(JOptions.FUSION_MEGAKERNEL_MIN_SCORE)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _rows(n, d, seed):
    """Standard-normal float32 rows, with a NaN row and a row of zeros."""
    X = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    X[3] = np.nan
    X[5] = 0.0
    return X


# ---------------------------------------------------------------------------
# ops/kernels bodies against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", (1.0, 2.0, 3.0, 2.5))
@pytest.mark.parametrize("d", (1, 7, 100))
def test_normalize_fn_matches_jax(p, d):
    X = _rows(40, d, seed=d)
    X[7, 0] = np.inf
    got = tk.normalize_fn(_t(X), p).numpy()
    want = np.asarray(jk.normalize_fn(jnp.asarray(X), p))
    assert ulp_diff(got, want) <= ENVELOPE
    assert np.all(got[5] == 0.0) and np.all(np.isnan(got[3]))  # a zero row stays zero; NaN spreads


def test_elementwise_bodies_match_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    X = _rows(30, 9, seed=2)
    scaling = (np.abs(rng.standard_normal(9)) + 0.1).astype(np.float32)
    np.testing.assert_array_equal(tk.elementwise_product_fn(_t(X), _t(scaling)).numpy(),
                                  np.asarray(jk.elementwise_product_fn(jnp.asarray(X), jnp.asarray(scaling))))
    X[0, :3] = np.float32(0.05)  # exactly the threshold's float32: not greater
    for threshold in (0.05, -0.3, 0.0):
        got = tk.binarize_fn(_t(X), threshold)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jk.binarize_fn(jnp.asarray(X), threshold)))
    assert tk.binarize_fn(_t(X), 0.05)[0, :3].tolist() == [0.0] * 3
    assert tk.binarize_fn(_t(X), -1e9)[3].tolist() == [0.0] * 9  # NaN gives 0


@pytest.mark.parametrize("missing", (np.nan, 0.1, 7.0))
def test_impute_fn_matches_jax_bit_for_bit(missing):
    """A placeholder float32 cannot hold (0.1) compares as its float32
    rounding, as JAX compares it."""
    x = np.random.default_rng(3).integers(0, 10, 50).astype(np.float32)
    x[::4] = np.float32(missing)
    x[1] = np.nan
    is_nan, value = (True, 0.0) if np.isnan(missing) else (False, float(missing))
    got = tk.impute_fn(_t(x), torch.tensor(4.5), is_nan, value).numpy()
    want = np.asarray(jk.impute_fn(jnp.asarray(x), jnp.float32(4.5), is_nan, value))
    np.testing.assert_array_equal(got, want)
    assert (got[::4] == 4.5).all()


# ---------------------------------------------------------------------------
# the stages against their JAX twins
# ---------------------------------------------------------------------------


def test_shared_params_match_jax():
    from flink_ml_tpu.params.shared import (
        HasInputCols as JHasInputCols,
        HasOutputCols as JHasOutputCols,
        HasRelativeError as JHasRelativeError,
    )

    for ours, theirs, attr in ((HasInputCols, JHasInputCols, "INPUT_COLS"),
                               (HasOutputCols, JHasOutputCols, "OUTPUT_COLS"),
                               (HasRelativeError, JHasRelativeError, "RELATIVE_ERROR")):
        a, b = getattr(ours, attr), getattr(theirs, attr)
        assert (a.name, a.description, a.default_value) == (b.name, b.description, b.default_value)
        for value in (None, [], ["a"], -0.5, 0.5, 1.5):
            try:
                jax_ok = b.validator(value)
            except TypeError:
                continue
            assert a.validator(value) == jax_ok, (attr, value)


@pytest.mark.parametrize("p", (2.0, 3.0))
def test_normalizer_transform_and_spec_match_jax(p):
    X = _rows(N, 16, seed=4)
    stage = Normalizer().set_input_col("x").set_output_col("y").set_p(p)
    jstage = JNormalizer().set_input_col("x").set_output_col("y").set_p(p)
    out = stage.transform(DataFrame.from_dict({"x": X}), device="cpu")
    ref = jstage.transform(JDataFrame.from_dict({"x": X}))
    assert ulp_diff(out.column("y"), np.asarray(ref.column("y"))) <= ENVELOPE
    assert out.column("y").dtype == np.float64
    spec, jspec = stage.kernel_spec(), jstage.kernel_spec()
    assert spec.fusion_op == jspec.fusion_op == "normalize"
    assert spec.fusion_params == {"p": p}
    assert spec.model_arrays == jspec.model_arrays == {}
    assert [(n, str(t)) for n, t in spec.outputs] == [(n, str(t)) for n, t in jspec.outputs]
    assert (spec.elementwise, spec.fusable) == (jspec.elementwise, jspec.fusable)
    with pytest.raises(ValueError):
        Normalizer().set_p(0.5)


def test_elementwise_product_transform_and_spec_match_jax():
    rng = np.random.default_rng(5)
    scaling = np.abs(rng.standard_normal(6)) + 0.1
    X = _rows(20, 6, seed=6)
    stage = ElementwiseProduct().set_input_col("x").set_output_col("y").set_scaling_vec(DenseVector(scaling))
    jstage = JElementwiseProduct().set_input_col("x").set_output_col("y").set_scaling_vec(scaling)
    out = stage.transform(DataFrame.from_dict({"x": X}), device="cpu")
    ref = jstage.transform(JDataFrame.from_dict({"x": X}))
    np.testing.assert_array_equal(out.column("y"), np.asarray(ref.column("y")))
    sparse = [SparseVector(6, [0, 4], [2.0, -1.0]), SparseVector(6, [], [])]
    jsparse = [JSparseVector(6, [0, 4], [2.0, -1.0]), JSparseVector(6, [], [])]
    got = stage.transform(DataFrame.from_dict({"x": sparse}), device="cpu").column("y")
    want = jstage.transform(JDataFrame.from_dict({"x": jsparse})).column("y")
    for a, b in zip(got, want):  # sparse stays sparse, in float64 on the host
        assert isinstance(a, SparseVector)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values)
    spec, jspec = stage.kernel_spec(), jstage.kernel_spec()
    assert spec.fusion_op == jspec.fusion_op == "elementwise_product"
    assert spec.input_kinds == jspec.input_kinds == {"x": "dense"}
    assert spec.model_arrays["scaling"].dtype == np.float32
    np.testing.assert_array_equal(spec.model_arrays["scaling"], np.asarray(jspec.model_arrays["scaling"]))
    assert spec.elementwise and jspec.elementwise and not spec.fusion_params
    assert ElementwiseProduct().kernel_spec() is None


def test_binarizer_transform_and_spec_match_jax():
    """Scalar and vector columns, a float32 value exactly at the threshold,
    an integer column (float32 out, as in JAX) and a SparseVector column."""
    rng = np.random.default_rng(7)
    cols = {"s": rng.standard_normal(25), "v": rng.standard_normal((25, 4)), "i": rng.integers(-3, 3, 25)}
    cols["s"][0] = np.float32(0.05)  # at the threshold once both are float32: not greater
    thresholds = (0.05, -0.3, 0.0)
    stage = Binarizer().set_input_cols("s", "v", "i").set_output_cols("bs", "bv", "bi")
    jstage = JBinarizer().set_input_cols("s", "v", "i").set_output_cols("bs", "bv", "bi")
    stage.set_thresholds(*thresholds)
    jstage.set_thresholds(*thresholds)
    out = stage.transform(DataFrame.from_dict(cols), device="cpu")
    ref = jstage.transform(JDataFrame.from_dict(cols))
    for name in ("bs", "bv", "bi"):
        got, want = out.column(name), np.asarray(ref.column(name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
        assert str(out.get_data_types()[out.get_index(name)]) == str(ref.get_data_types()[ref.get_index(name)])
    assert out.column("bs")[0] == 0.0
    sparse = Binarizer().set_input_cols("x").set_output_cols("y").set_thresholds(0.5)
    got = sparse.transform(DataFrame.from_dict({"x": [SparseVector(5, [1, 3], [0.7, 0.2])]}),
                           device="cpu").column("y")[0]
    assert list(got.indices) == [1] and list(got.values) == [1.0]
    spec, jspec = stage.kernel_spec(), jstage.kernel_spec()
    assert spec.fusion_op == jspec.fusion_op == "binarize"
    assert spec.fusion_params == {"thresholds": thresholds}
    assert spec.input_kinds == jspec.input_kinds == {"s": "dense", "v": "dense", "i": "dense"}
    assert [o for o, _ in spec.outputs] == ["bs", "bv", "bi"] and all(t is None for _, t in spec.outputs)
    # the spec declines where the params disagree, as the twin's does
    assert Binarizer().set_input_cols("a", "b").set_output_cols("x", "y").set_thresholds(0.1).kernel_spec() is None
    assert JBinarizer().set_input_cols("a", "b").set_output_cols("x", "y").set_thresholds(0.1).kernel_spec() is None
    with pytest.raises(ValueError, match="number of thresholds"):
        Binarizer().set_input_cols("a", "b").set_output_cols("x", "y").set_thresholds(0.1).transform(
            DataFrame.from_dict({"a": np.zeros(2), "b": np.zeros(2)}), device="cpu")


def _imputer_frame(n=300, seed=8, missing=np.nan):
    rng = np.random.default_rng(seed)
    cols = {f"f{i}": rng.integers(0, 20, n).astype(np.float64) for i in range(3)}
    for c in cols.values():
        c[rng.random(n) < 0.1] = missing
    cols["f2"][:40] = 7.0  # a clear mode
    return cols


@pytest.mark.parametrize("strategy", ("mean", "median", "most_frequent"))
@pytest.mark.parametrize("missing", (np.nan, 0.1, 3.0))
def test_imputer_fit_and_transform_match_jax(strategy, missing):
    cols = _imputer_frame(missing=missing)
    cols["f0"][5] = np.nan  # a NaN is never a valid value, whatever the placeholder
    names, outs = ("f0", "f1", "f2"), ("o0", "o1", "o2")
    est = Imputer().set_input_cols(*names).set_output_cols(*outs).set_strategy(strategy).set_missing_value(missing)
    jest = JImputer().set_input_cols(*names).set_output_cols(*outs).set_strategy(strategy).set_missing_value(missing)
    model, jmodel = est.fit(DataFrame.from_dict(cols)), jest.fit(JDataFrame.from_dict(cols))
    np.testing.assert_array_equal(model.surrogates, jmodel.surrogates)
    assert model.param_map_to_json() == jmodel.param_map_to_json()
    out = model.transform(DataFrame.from_dict(cols), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict(cols))
    for o in outs:
        np.testing.assert_array_equal(out.column(o), np.asarray(ref.column(o)))
        assert out.column(o).dtype == np.float64
    spec, jspec = model.kernel_spec(), jmodel.kernel_spec()
    assert spec.fusion_op == jspec.fusion_op == "impute"
    assert spec.input_kinds == jspec.input_kinds == {n: "scalar" for n in names}
    want_params = ({"missing_is_nan": True, "missing_value": 0.0} if np.isnan(missing)
                   else {"missing_is_nan": False, "missing_value": float(missing)})
    assert spec.fusion_params == want_params
    np.testing.assert_array_equal(spec.model_arrays["surrogates"], np.asarray(jspec.model_arrays["surrogates"]))
    assert spec.model_arrays["surrogates"].dtype == np.float32
    assert [(n, str(t)) for n, t in spec.outputs] == [(n, str(t)) for n, t in jspec.outputs]


def test_imputer_refuses_a_column_with_nothing_to_fit():
    cols = {"a": np.full(4, np.nan)}
    with pytest.raises(RuntimeError, match="no valid values"):
        Imputer().set_input_cols("a").set_output_cols("b").fit(DataFrame.from_dict(cols))
    with pytest.raises(RuntimeError, match="set_model_data"):
        ImputerModel().kernel_spec()
    with pytest.raises(ValueError):
        Imputer().set_strategy("mode")


# ---------------------------------------------------------------------------
# the scalar input kind and the shape-following readback
# ---------------------------------------------------------------------------


def test_scalar_ingest_and_readback_match_the_jax_plan():
    """An Imputer's ``scalar`` columns and a Binarizer's 1-D and 2-D outputs
    (DataType None) come back as the JAX plan returns them, in both tiers."""
    cols = _imputer_frame(n=37)
    cols["v"] = np.random.default_rng(9).standard_normal((37, 3))
    model = Imputer().set_input_cols("f0", "f1").set_output_cols("o0", "o1").fit(DataFrame.from_dict(cols))
    jmodel = JImputer().set_input_cols("f0", "f1").set_output_cols("o0", "o1").fit(JDataFrame.from_dict(cols))
    binar = Binarizer().set_input_cols("o1", "v").set_output_cols("b1", "bv").set_thresholds(10.0, 0.0)
    jbinar = JBinarizer().set_input_cols("o1", "v").set_output_cols("b1", "bv").set_thresholds(10.0, 0.0)
    pipe, jpipe = PipelineModelServable([model, binar]), JPipeline([jmodel, jbinar])
    ref = JPlan.build(jpipe, scope="tfe-scalar-j").execute(JDataFrame.from_dict(cols))
    per_stage = pipe.transform(DataFrame.from_dict(cols), device="cpu")
    for tag, fusion in (("e", None), ("m", FusionTier("fast", min_score=1.0))):
        plan = CompiledServingPlan.build(pipe, scope=f"tfe-scalar-{tag}", device="cpu", fusion=fusion)
        (segment,) = plan.segments
        assert segment.input_kind("f0") == "scalar" and segment.gather(DataFrame.from_dict(cols), "f0").dtype \
            == np.float32
        out = plan.execute(DataFrame.from_dict(cols))
        if fusion is not None:
            assert chain_kinds(plan) == {37: ("megakernel",)}
        for name in ("o0", "o1", "b1", "bv"):
            np.testing.assert_array_equal(out.column(name), np.asarray(ref.column(name)), err_msg=name)
            np.testing.assert_array_equal(out.column(name), per_stage.column(name), err_msg=name)
            assert str(out.get_data_types()[out.get_index(name)]) == \
                str(ref.get_data_types()[ref.get_index(name)]), name
    assert str(out.get_data_types()[out.get_index("b1")]) == str(DataTypes.DOUBLE)


# ---------------------------------------------------------------------------
# save / load both ways
# ---------------------------------------------------------------------------


def _feature6(d, seed=9, head=False, port=True):
    """bench.py ``_make_feature6_stages`` in either package's classes, the
    logistic head's coefficient drawn after it."""
    rng = np.random.default_rng(seed)
    ns = ((StandardScalerModel, Normalizer, ElementwiseProduct, IDFModel, Binarizer,
           LogisticRegressionModelServable) if port else
          (JStandardScalerModel, JNormalizer, JElementwiseProduct, JIDFModel, JBinarizer,
           jlib.LogisticRegressionModelServable))
    Scaler, Norm, Product, Idf, Bin, Lr = ns
    scaler = Scaler().set_input_col("input").set_output_col("scaled").set_with_mean(True)
    scaler.mean = rng.standard_normal(d)
    scaler.std = np.abs(rng.standard_normal(d)) + 0.5
    scaler.std[0] = 0.0  # the zero-std guard
    idf = Idf().set_input_col("weighted").set_output_col("tfidf")
    idf.idf = np.abs(rng.standard_normal(d)) + 0.2
    idf.doc_freq = np.ones(d)
    idf.num_docs = np.asarray(400_000.0)
    rescale = Scaler().set_input_col("tfidf").set_output_col("rescaled").set_with_mean(False)
    rescale.mean = np.zeros(d)
    rescale.std = np.abs(rng.standard_normal(d)) + 0.5
    stages = [
        scaler,
        Norm().set_input_col("scaled").set_output_col("norm"),
        Product().set_scaling_vec(np.abs(rng.standard_normal(d)) + 0.1)
        .set_input_col("norm").set_output_col("weighted"),
        idf,
        rescale,
        Bin().set_input_cols("rescaled").set_output_cols("bin").set_thresholds(0.05),
    ]
    if head:
        lr = Lr().set_features_col("bin")
        lr.coefficient = rng.standard_normal(d)
        stages.append(lr)
    return stages


def _assert_feature6(out, ref, coef=None, where=""):
    """The rules of the module docstring, the head's too when ``coef`` is
    given; returns the entries inside the binarize margin."""
    def col(df, name):
        return np.asarray(df.column(name))

    np.testing.assert_array_equal(col(out, "scaled"), col(ref, "scaled"), err_msg=where)
    for name in FEATURE6_COLS[1:]:
        assert ulp_diff(col(out, name), col(ref, name)) <= ENVELOPE, (where, name)
    near = np.abs(col(ref, "rescaled") - np.float32(0.05)) <= BIN_MARGIN
    np.testing.assert_array_equal(col(out, "bin")[~near], col(ref, "bin")[~near], err_msg=where)
    if coef is not None:
        rows = ~near.any(axis=1)
        assert ulp_diff(col(out, "rawPrediction")[rows, 1], col(ref, "rawPrediction")[rows, 1]) <= ENVELOPE, where
        for df in (out, ref):
            raw = col(df, "rawPrediction").astype(np.float32)
            np.testing.assert_array_equal(raw[:, 0], np.float32(1.0) - raw[:, 1], err_msg=where)
        margin = col(ref, "bin") @ np.asarray(coef, np.float32).astype(np.float64)
        sure = rows & (np.abs(margin) > PREDICTION_MARGIN)
        np.testing.assert_array_equal(col(out, "prediction")[sure], col(ref, "prediction")[sure], err_msg=where)
    return int(near.sum())


def test_jax_saved_feature6_pipeline_loads_into_the_port(tmp_path):
    jstages = _feature6(8, head=False, port=False)
    jlr = jlib.LogisticRegressionModelServable().set_features_col("bin")
    from flink_ml_tpu.models.classification.logistic_regression import LogisticRegressionModel as JLRModel

    jmodel = JLRModel().set_features_col("bin")
    jmodel.coefficient = jlr.coefficient = np.random.default_rng(10).standard_normal(8)
    path = str(tmp_path / "jax-feature6")
    JPipelineModel(jstages + [jmodel]).save(path)
    port = PipelineModelServable.load(path)
    assert [type(s) for s in port.servables] == [
        StandardScalerModelServable, Normalizer, ElementwiseProduct, IDFModel, StandardScalerModelServable,
        Binarizer, LogisticRegressionModelServable]
    X = _rows(N, 8, seed=11)
    out = port.transform(DataFrame.from_dict({"input": X}), device="cpu")
    ref = JPipeline(jstages + [jlr]).transform(JDataFrame.from_dict({"input": X}))
    _assert_feature6(out, ref, jlr.coefficient, "jax-saved")
    for jax_name, port_cls in (
        ("flink_ml_tpu.models.feature.normalizer.Normalizer", Normalizer),
        ("flink_ml_tpu.models.feature.elementwise_product.ElementwiseProduct", ElementwiseProduct),
        ("flink_ml_tpu.models.feature.binarizer.Binarizer", Binarizer),
        ("flink_ml_tpu.models.feature.imputer.ImputerModel", ImputerModel),
    ):
        assert rw.resolve_class(jax_name) is port_cls
        assert rw.resolve_class(jax_name, stage=True) is port_cls
    assert rw.resolve_class("flink_ml_tpu.models.feature.imputer.Imputer", stage=True) is Imputer
    with pytest.raises(ValueError, match="no port class"):
        rw.resolve_class("flink_ml_tpu.models.feature.imputer.Imputer")  # an Estimator serves nothing


def test_jax_saved_imputer_loads_into_the_port(tmp_path):
    cols = _imputer_frame()
    jmodel = JImputer().set_input_cols("f0", "f1").set_output_cols("o0", "o1").fit(JDataFrame.from_dict(cols))
    jmodel.save(str(tmp_path / "jimp"))
    JImputer().set_input_cols("f0").set_output_cols("o0").set_strategy("median").save(str(tmp_path / "jest"))
    served = load_servable(str(tmp_path / "jimp"))
    assert isinstance(served, ImputerModel)
    np.testing.assert_array_equal(served.surrogates, jmodel.surrogates)
    out = served.transform(DataFrame.from_dict(cols), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict(cols))
    np.testing.assert_array_equal(out.column("o1"), np.asarray(ref.column("o1")))
    est = rw.load_stage(str(tmp_path / "jest"))
    assert isinstance(est, Imputer) and est.get_strategy() == "median"


def _json(stage):
    """A stage's params as JSON text: a NaN placeholder compares equal."""
    return json.dumps(stage.param_map_to_json(), sort_keys=True)


def test_port_saved_stages_load_in_the_jax_package(tmp_path):
    """The JAX package reads the port's directories with its own ``load``
    and ``load_stage``: the port writes the JAX twin's class name."""
    rng = np.random.default_rng(12)
    cols = _imputer_frame()
    stages = {
        "norm": (Normalizer().set_input_col("x").set_output_col("y").set_p(3.0), JNormalizer),
        "prod": (ElementwiseProduct().set_input_col("x").set_output_col("y")
                 .set_scaling_vec(DenseVector(np.abs(rng.standard_normal(5)) + 0.1)), JElementwiseProduct),
        "bin": (Binarizer().set_input_cols("x").set_output_cols("y").set_thresholds(0.2), JBinarizer),
        "imp": (Imputer().set_input_cols("f0", "f1").set_output_cols("o0", "o1").fit(DataFrame.from_dict(cols)),
                JImputerModel),
    }
    X = _rows(20, 5, seed=13)
    for name, (stage, jcls) in stages.items():
        path = str(tmp_path / name)
        stage.save(path)
        jstage = jcls.load(path)
        assert type(jrw.load_stage(path)) is jcls
        if name == "imp":
            np.testing.assert_array_equal(jstage.surrogates, stage.surrogates)
            frame, jframe = DataFrame.from_dict(cols), JDataFrame.from_dict(cols)
        else:
            frame, jframe = DataFrame.from_dict({"x": X}), JDataFrame.from_dict({"x": X})
        assert _json(jstage) == _json(stage)
        out = load_servable(path).transform(frame, device="cpu")
        ref = jstage.transform(jframe)
        for o in (("o0", "o1") if name == "imp" else ("y",)):
            assert ulp_diff(out.column(o), np.asarray(ref.column(o))) <= (ENVELOPE if name == "norm" else 0), name
        assert _json(type(stage).load(path)) == _json(stage)


# ---------------------------------------------------------------------------
# the serving plan: exact tier, and fast tier against the JAX megakernel
# ---------------------------------------------------------------------------


def _check_plan_tiers(d, head, tag):
    port_pipe = PipelineModelServable(_feature6(d, head=head))
    jax_pipe = JPipeline(_feature6(d, head=head, port=False))
    X = _rows(N, d, seed=d)
    X[6] = port_pipe.servables[0].mean.astype(np.float32)  # zero after centring: a zero row to normalize
    df, jdf = DataFrame.from_dict({"input": X}), JDataFrame.from_dict({"input": X})
    per_stage = port_pipe.transform(df, device="cpu")
    exact = CompiledServingPlan.build(port_pipe, scope=f"tfe-e{tag}", device="cpu").execute(df)
    mega_plan = CompiledServingPlan.build(port_pipe, scope=f"tfe-m{tag}", device="cpu",
                                          fusion=FusionTier("fast", min_score=1.0))
    mega = mega_plan.execute(df)
    assert chain_kinds(mega_plan) == {N: ("megakernel",)}
    j_plan = JPlan.build(jax_pipe, scope=f"tfej-m{tag}", fusion=JFusionTier("fast", min_score=1.0))
    j_mega = j_plan.execute(jdf)
    assert {s.plan_label(N) for s in j_plan.segments} == {"fast+mega"}
    names = list(FEATURE6_COLS) + ["bin"] + (["prediction", "rawPrediction"] if head else [])
    for name in names:
        np.testing.assert_array_equal(exact.column(name), per_stage.column(name), err_msg=name)
        np.testing.assert_array_equal(mega.column(name), per_stage.column(name), err_msg=name)
        assert mega.column(name).dtype == np.float64
    assert np.all(mega.column("norm")[6] == 0.0) and np.all(np.isnan(mega.column("norm")[3]))
    coef = port_pipe.servables[-1].coefficient if head else None
    return _assert_feature6(mega, j_mega, coef, f"fast d={d}")


@pytest.mark.parametrize("d", (8, 16, 100))
@pytest.mark.parametrize("head", (False, True))
def test_feature6_plan_tiers_match_jax_megakernel(d, head):
    """The port's exact tier and its megakernel program (the plain row-local
    chain on CPU tensors) equal its per-stage transform bit for bit, and
    hold the JAX Pallas megakernel in interpret mode to the module's rules."""
    inside = _check_plan_tiers(d, head, f"{d}{int(head)}")
    assert inside <= N * d // 100  # near ties are rare at these magnitudes


def test_cost_model_choice_per_bucket_equals_jax():
    """At d 100 feature6 → logistic scores 3556 per row: buckets from 512
    run the megakernel under the default bar of 10^6, in both packages;
    feature6 alone (3048) the same; the 15-column Imputer (23) never."""
    specs = [s.kernel_spec() for s in _feature6(100, head=True)]
    jspecs = [s.kernel_spec() for s in _feature6(100, head=True, port=False)]
    assert chain_score(specs, 1, width=100) == 3556
    assert chain_score(specs[:-1], 1, width=100) == 3048
    cols = tuple(f"f{i}" for i in range(15))
    frame = {c: np.arange(4.0) for c in cols}
    imp = Imputer().set_input_cols(*cols).set_output_cols(*cols).fit(DataFrame.from_dict(frame))
    jimp = JImputer().set_input_cols(*cols).set_output_cols(*cols).fit(JDataFrame.from_dict(frame))
    assert chain_score([imp.kernel_spec()], 1) == 23
    tier, jtier = FusionTier("fast"), JFusionTier("fast")
    for chain, jchain, width, hot_from in ((specs, jspecs, 100, 512), (specs[:-1], jspecs[:-1], 100, 512),
                                           ([imp.kernel_spec()], [jimp.kernel_spec()], 0, None)):
        assert chain_eligible(chain)
        for bucket in (1 << i for i in range(13)):
            hot = tier.megakernel_hot(chain, bucket, width)
            assert hot == jtier.megakernel_hot(jchain, bucket, width), bucket
            assert hot == (hot_from is not None and bucket >= hot_from), bucket
    for rows in (256, 512):
        X = _rows(rows, 100, seed=rows)
        plan = CompiledServingPlan.build(PipelineModelServable(_feature6(100, head=True)), scope=f"tfe-cost{rows}",
                                         device="cpu", fusion=FusionTier("fast"))
        plan.execute(DataFrame.from_dict({"input": X}))
        assert chain_kinds(plan) == {rows: ("megakernel",) if rows >= 512 else ("fused",)}


def test_a_batch_wider_than_the_kernel_takes_the_merged_program():
    """Normalizer carries no width: the batch shows it, and a key whose
    column is wider than ROWLOCAL_MAX_DIM is built as the merged program."""
    from flink_ml_tpu_torch.servable.megakernels import ROWLOCAL_MAX_DIM

    stage = Normalizer().set_input_col("x").set_output_col("y")
    for d, kind in ((ROWLOCAL_MAX_DIM, "megakernel"), (ROWLOCAL_MAX_DIM + 1, "fused")):
        X = np.random.default_rng(d).standard_normal((3, d))
        plan = CompiledServingPlan.build(stage, scope=f"tfe-wide{d}", device="cpu",
                                         fusion=FusionTier("fast", min_score=1.0))
        out = plan.execute(DataFrame.from_dict({"x": X}))
        assert chain_kinds(plan) == {3: (kind,)}
        np.testing.assert_array_equal(out.column("y"), stage.transform(DataFrame.from_dict({"x": X}),
                                                                       device="cpu").column("y"))


def test_port_and_jax_servers_answer_the_same_imputer_stream():
    """Both servers under fusion.mode=fast with the bar at 1.0 (as the JAX
    package's tests and bench set it): every bucket runs the megakernel and
    the fill is exact."""
    cols = _imputer_frame()
    names = ("f0", "f1", "f2")
    model = Imputer().set_input_cols(*names).set_output_cols("o0", "o1", "o2").fit(DataFrame.from_dict(cols))
    jmodel = JImputer().set_input_cols(*names).set_output_cols("o0", "o1", "o2").fit(JDataFrame.from_dict(cols))
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    jconfig.set(JOptions.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    template = {n: cols[n][:1] for n in names}
    port_cfg = ServingConfig(max_batch_size=64, max_delay_ms=0.5, fusion_mode="fast")
    from flink_ml_tpu.serving.server import InferenceServer as JServer, ServingConfig as JServingConfig

    jax_cfg = JServingConfig(max_batch_size=64, max_delay_ms=0.5, fusion_mode="fast")
    pipe = PipelineModelServable([model])
    with InferenceServer(pipe, name="tfe-pair", serving_config=port_cfg, device="cpu",
                         warmup_template=DataFrame.from_dict(template)) as port, \
            JServer(JPipeline([jmodel]), name="tfe-pair-jax", serving_config=jax_cfg,
                    warmup_template=JDataFrame.from_dict(template)) as ref:
        for lo, hi in ((0, 1), (1, 4), (4, 20), (20, 84), (84, 147)):
            part = {n: cols[n][lo:hi] for n in names}
            a, b = port.predict(DataFrame.from_dict(part)), ref.predict(JDataFrame.from_dict(part))
            assert a.bucket == b.bucket
            for o in ("o0", "o1", "o2"):
                np.testing.assert_array_equal(a.dataframe.column(o), np.asarray(b.dataframe.column(o)))
    kinds = chain_kinds(pipe._fastpath_plan)
    assert kinds and all(k == ("megakernel",) for k in kinds.values())


# ---------------------------------------------------------------------------
# the wrapper's device rule
# ---------------------------------------------------------------------------


def test_rowlocal_wrapper_runs_the_plain_version_for_cpu_tensors_without_counting():
    rng = np.random.default_rng(14)
    x = _t(rng.standard_normal((9, 6)))
    s = _t(rng.standard_normal(9))
    ops = [RowLocalOp("scale", 0, _t(rng.standard_normal(6)), _t(rng.random(6) + 0.5),
                      {"with_mean": True, "with_std": True}),
           RowLocalOp("normalize", 2, params={"p": 2.0}),
           RowLocalOp("binarize", 1, params={"threshold": 0.0}),
           RowLocalOp("logistic", 3, _t(rng.standard_normal(6)))]
    before = ROWLOCAL.launches
    got = rowlocal_chain([x, s], ops)
    want = rowlocal_chain_plain([x, s], ops)
    assert [tuple(t.shape) for t in got] == [(9, 6), (9, 6), (9,), (9,), (9, 2)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[1].numpy(), tk.normalize_fn(got[0], 2.0).numpy())
    assert ROWLOCAL.launches == before  # the count is of kernel launches only


def test_rowlocal_wrapper_raises_for_what_it_has_no_path_for():
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        rowlocal_chain([torch.empty((4, 8), device="meta")], [RowLocalOp("binarize", 0, params={"threshold": 0.0})])
    with pytest.raises(ValueError, match="at least one input"):
        rowlocal_chain([], [])


def test_rowlocal_launch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = ROWLOCAL.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ROWLOCAL.launch(None, 1, None, 1, 0, None)
    assert ROWLOCAL.launches == before
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledServingPlan.build(PipelineModelServable(_feature6(8, head=True)), device="cuda")
