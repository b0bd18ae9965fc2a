"""Tests of the port's CUDA kernels on the card: each kernel against its
plain PyTorch version, its launch count, and the serving path's use of it.

They need an NVIDIA GPU and nvcc, and skip without them. This file imports
no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.servable import (
    LogisticRegressionModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
)
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
from flink_ml_tpu_torch.servable.megakernels import (
    SCALE_LOGISTIC,
    scale_logistic,
    scale_logistic_plain,
)
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

CHAINS = [
    (True, True, True),
    (True, False, True),
    (False, True, True),
    (False, False, True),
    (False, False, False),  # LogisticRegression alone
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(rows, d, device, seed=0):
    rng = np.random.default_rng(seed)
    std = np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.5)
    std[0] = 0.0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))
    arrays = (
        rng.normal(size=(rows, d)),
        rng.normal(size=d),
        inv_std,
        rng.normal(size=d) * (3.0 / np.sqrt(d)),
    )
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("rows", (1, 33, 4096))
@pytest.mark.parametrize("d", (8, 100, 1000))
@pytest.mark.parametrize("with_mean,with_std,write_scaled", CHAINS)
def test_kernel_matches_plain_version(cuda, rows, d, with_mean, with_std, write_scaled):
    x, mean, inv_std, coef = _inputs(rows, d, cuda)
    before = SCALE_LOGISTIC.launches
    scaled, pred, raw = scale_logistic(
        x, mean, inv_std, coef, with_mean=with_mean, with_std=with_std, write_scaled=write_scaled
    )
    p_scaled, p_pred, p_raw = scale_logistic_plain(
        x, mean, inv_std, coef, with_mean=with_mean, with_std=with_std
    )
    torch.cuda.synchronize()
    assert SCALE_LOGISTIC.launches == before + 1
    if write_scaled:
        assert torch.equal(scaled, p_scaled)  # bit-equal: no contraction, same roundings
    else:
        assert scaled is None
    assert ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy()) <= ULP_ENVELOPE["scale_logistic"]
    margin = (p_scaled @ coef).cpu().numpy()
    decided = np.abs(margin) > 1e-4
    np.testing.assert_array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, mean, inv_std, coef = _inputs(8, 16, cuda)
    before = SCALE_LOGISTIC.launches
    kw = dict(with_mean=True, with_std=True, write_scaled=True)
    with pytest.raises(TypeError, match="float32"):
        scale_logistic(x.double(), mean, inv_std, coef, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        scale_logistic(x.t().contiguous().t(), mean, inv_std, coef, **kw)
    with pytest.raises(ValueError, match="shape"):
        scale_logistic(x, mean[:-1], inv_std, coef, **kw)
    with pytest.raises(ValueError, match="expected"):
        scale_logistic(x, mean.cpu(), inv_std, coef, **kw)
    empty = scale_logistic(x[:0], mean, inv_std, coef, **kw)
    assert [t.shape for t in empty] == [(0, 16), (0,), (0, 2)]
    assert SCALE_LOGISTIC.launches == before


def test_server_launches_the_kernel_for_hot_buckets_only(cuda):
    d = 100
    rng = np.random.default_rng(1)
    sc = StandardScalerModelServable().set_input_col("features").set_output_col("scaled")
    sc.set_with_mean(True)
    sc.mean, sc.std = rng.normal(size=d), np.abs(rng.normal(size=d)) + 0.5
    lr = LogisticRegressionModelServable().set_features_col("scaled")
    lr.coefficient = rng.normal(size=d) / np.sqrt(d)
    pipe = PipelineModelServable([sc, lr])
    cfg = ServingConfig(max_batch_size=2048, queue_capacity_rows=8192, fusion_mode="fast")
    template = DataFrame.from_dict({"features": rng.normal(size=(1, d))})
    with InferenceServer(pipe, name="gpu-hot", serving_config=cfg, warmup_template=template) as srv:
        SCALE_LOGISTIC.reset_launches()
        big = DataFrame.from_dict({"features": rng.normal(size=(1500, d))})
        small = DataFrame.from_dict({"features": rng.normal(size=(5, d))})
        r_big, r_small = srv.predict(big), srv.predict(small)
        assert (r_big.bucket, r_small.bucket) == (2048, 8)
        assert SCALE_LOGISTIC.launches == 1  # bucket 2048 is hot, bucket 8 is not
    ref = pipe.transform(big, device="cpu")
    np.testing.assert_array_equal(r_big.dataframe.column("scaled"), ref.column("scaled"))
    assert ulp_diff(r_big.dataframe.column("rawPrediction"), ref.column("rawPrediction")) <= (
        ULP_ENVELOPE["scale_logistic"]
    )


# ---------------------------------------------------------------------------
# the one-hot row crossings of sparse SGD
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.linalg import onehot_sparse as O  # noqa: E402

CROSSINGS = (O.DOT_CROSSING, O.MULT_CROSSING, O.DOT_CROSSING_PREMAT, O.MULT_CROSSING_PREMAT)


def _crossing_inputs(n_sub, row_hi, n, device, seed=0, live=None):
    rng = np.random.default_rng(seed)
    rowid = rng.integers(0, row_hi * 128, (n_sub, n)).astype(np.int16)
    q = rng.normal(size=(n_sub, n)).astype(np.float32)
    if live is not None:
        q[rng.random((n_sub, n)) >= live] = 0.0  # padding slots: value 0
    m3 = rng.normal(size=(n_sub, row_hi, 128)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (rowid, q, m3)]


@pytest.mark.parametrize("n_sub", (1, 4))
@pytest.mark.parametrize("row_hi", (1, 4, 128, 130))
@pytest.mark.parametrize("n", (1, 1000, 8192 + 7, 20000))
def test_crossing_kernels_match_plain_versions(cuda, n_sub, row_hi, n):
    rowid, q, m3 = _crossing_inputs(n_sub, row_hi, n, cuda, seed=n + row_hi)
    before = [k.launches for k in CROSSINGS]
    oh = O.premat_row_onehots(rowid, row_hi)
    dot = O.dot_crossing(q, rowid, row_hi)
    dot_p = O.dot_crossing_premat(q, *oh)
    mult = O.mult_crossing(m3, rowid)
    mult_p = O.mult_crossing_premat(m3, *oh)
    torch.cuda.synchronize()
    assert [k.launches for k in CROSSINGS] == [b + 1 for b in before]
    rows = row_hi * 128
    absum = torch.zeros(n_sub, rows, dtype=torch.float64, device=cuda)
    absum.scatter_add_(1, rowid.long(), q.abs().double())
    tol = 1e-5 * absum.reshape(n_sub, row_hi, 128) + 1e-6  # another summation order
    assert bool(((dot.double() - O.dot_crossing_plain(q, rowid, row_hi).double()).abs() <= tol).all())
    assert torch.equal(dot, dot_p)  # build form == premat form, bit for bit
    assert torch.equal(mult, O.mult_crossing_plain(m3, rowid))  # one nonzero term: exact
    assert torch.equal(mult_p, O.mult_crossing_premat_plain(m3, *oh))
    assert torch.equal(mult_p[:, :n], mult)


def test_crossing_kernels_select_the_window_and_skip_dead_entries(cuda):
    n_win, n_sub, row_hi, n = 3, 2, 4, 5000
    rng = np.random.default_rng(5)
    rowid = torch.from_numpy(rng.integers(0, row_hi * 128, (n_win, n_sub, n)).astype(np.int16)).to(cuda)
    lvals = torch.from_numpy((rng.random((n_win, n_sub, n)) < 0.7).astype(np.float32)).to(cuda)
    oh_hi, oh_lo = O.premat_row_onehots(rowid, row_hi)
    row_ptr, entry_of = O.row_order(rowid, row_hi, live=lvals != 0)
    for wi in range(n_win):
        q = lvals[wi] * torch.randn(n_sub, n, device=cuda)
        m3 = torch.randn(n_sub, row_hi, 128, device=cuda)
        dot = O.dot_crossing(q, rowid[wi], row_hi, (row_ptr[wi], entry_of[wi]))
        assert torch.equal(dot, O.dot_crossing_premat(q, oh_hi, oh_lo, wi))
        assert torch.equal(O.mult_crossing_premat(m3, oh_hi, oh_lo, wi)[:, :n],
                           O.mult_crossing(m3, rowid[wi]))


def test_crossing_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rowid, q, m3 = _crossing_inputs(2, 4, 100, cuda)
    oh_hi, oh_lo = O.premat_row_onehots(rowid, 4)
    before = [k.launches for k in CROSSINGS]
    with pytest.raises(TypeError, match="int16"):
        O.mult_crossing(m3, rowid.int())
    with pytest.raises(TypeError, match="float32"):
        O.dot_crossing(q.double(), rowid, 4)
    with pytest.raises(ValueError, match="shape"):
        O.dot_crossing_premat(q, oh_hi[:1], oh_lo[:1])
    with pytest.raises(ValueError, match="window"):
        O.mult_crossing_premat(m3, oh_hi, oh_lo, 1)
    with pytest.raises(ValueError, match="contiguous"):
        O.dot_crossing_premat(q.t().contiguous().t(), oh_hi, oh_lo)
    assert [k.launches for k in CROSSINGS] == before


def test_sparse_sgd_premat_and_build_forms_are_bit_identical_on_the_card(cuda):
    from flink_ml_tpu_torch.iteration import DeviceDataCache
    from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD

    rng = np.random.default_rng(6)
    n, d, K = 3000, 1 << 14, 8
    cols = {
        "indices": rng.integers(0, d, (n, K)).astype(np.int32),
        "values": (rng.random((n, K)) < 0.9).astype(np.float32),
        "labels": (rng.random(n) > 0.5).astype(np.float32),
        "weights": np.ones(n, np.float32),
    }
    cache = DeviceDataCache(cols, device=cuda)
    coefs, cpu = [], None
    for premat in ("on", "off"):
        for k in CROSSINGS:
            k.reset_launches()
        sgd = SGD(max_iter=7, global_batch_size=1024, tol=0.0, learning_rate=0.5,
                  sparse_kernel="onehot", onehot_premat=premat, device=cuda)
        coefs.append(sgd.optimize(np.zeros(d, np.float32), cache, BinaryLogisticLoss.INSTANCE))
        used = CROSSINGS[2:] if premat == "on" else CROSSINGS[:2]
        assert all(k.launches == 7 for k in used)
        assert all(k.launches == 0 for k in CROSSINGS if k not in used)
    np.testing.assert_array_equal(coefs[0], coefs[1])
    cpu = SGD(max_iter=7, global_batch_size=1024, tol=0.0, learning_rate=0.5,
              sparse_kernel="onehot", device="cpu").optimize(
        np.zeros(d, np.float32), cols, BinaryLogisticLoss.INSTANCE)
    np.testing.assert_allclose(coefs[0], cpu, rtol=1e-4, atol=1e-7)  # plain versions, other orders


# ---------------------------------------------------------------------------
# the sparse IDF → logistic megakernel
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.servable.megakernels import (  # noqa: E402
    SPARSE_IDF_LOGISTIC,
    sparse_idf_logistic,
    sparse_idf_logistic_plain,
)

SPARSE_CHAINS = [(True, True), (True, False), (False, False)]  # (with idf, keep its output)


def _sparse_inputs(rows, K, d, device, seed=0):
    """Packed rows shorter than the cap (padding id 0 / value 0), sorted
    ids, and model vectors; the same construction as the serving layout."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, K + 1, rows)
    ids = np.sort(rng.integers(0, d, (rows, K)), axis=1).astype(np.int32)
    vals = rng.normal(size=(rows, K)).astype(np.float32)
    dead = np.arange(K)[None, :] >= nnz[:, None]
    ids[dead], vals[dead] = 0, 0.0
    idf = np.abs(rng.normal(size=d)).astype(np.float32)
    coef = (rng.normal(size=d) * 0.3).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (vals, ids, idf, coef)]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d", (8, 1000, 1 << 22))
@pytest.mark.parametrize("with_idf,write_tfidf", SPARSE_CHAINS)
def test_sparse_kernel_is_bit_equal_to_its_plain_version(cuda, d, with_idf, write_tfidf):
    for rows in (1, 33, 4096):
        for K in (1, 8, 64):
            where = f"rows={rows} K={K}"
            vals, ids, idf, coef = _sparse_inputs(rows, K, d, cuda, seed=rows + K)
            idf = idf if with_idf else None
            before = SPARSE_IDF_LOGISTIC.launches
            tfidf, margin, pred, raw = sparse_idf_logistic(vals, ids, idf, coef, write_tfidf=write_tfidf)
            p_tfidf, p_margin, p_pred, p_raw = sparse_idf_logistic_plain(vals, ids, idf, coef)
            torch.cuda.synchronize()
            assert SPARSE_IDF_LOGISTIC.launches == before + 1, where
            assert (tfidf is None) == (not write_tfidf), where
            if write_tfidf:
                assert _same_bits(tfidf, p_tfidf), where
            assert _same_bits(margin, p_margin), where  # the sequential fold, in slot order
            assert torch.equal(pred, p_pred), where
            ulps = ulp_diff(raw.cpu().numpy(), p_raw.cpu().numpy())
            assert ulps <= ULP_ENVELOPE["sparse_idf_logistic"], where


def test_sparse_kernel_folds_padding_and_clamps_ids_as_the_plain_version(cuda):
    vals, ids, idf, coef = _sparse_inputs(64, 8, 100, cuda, seed=3)
    coef[0] = float("inf")  # padding slots add 0 * coef[0]: NaN, as in the plain version
    ids[:4, 0] = torch.tensor([-1, 100, -300, 7], dtype=torch.int32, device=cuda)
    _, margin, pred, raw = sparse_idf_logistic(vals, ids, idf, coef, write_tfidf=False)
    _, p_margin, p_pred, p_raw = sparse_idf_logistic_plain(vals, ids, idf, coef)
    torch.cuda.synchronize()
    assert _same_bits(margin, p_margin) and torch.equal(pred, p_pred)
    assert torch.isnan(margin).any()
    assert _same_bits(raw, p_raw)


def test_sparse_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    vals, ids, idf, coef = _sparse_inputs(8, 4, 16, cuda)
    before = SPARSE_IDF_LOGISTIC.launches
    with pytest.raises(TypeError, match="float32"):
        sparse_idf_logistic(vals.double(), ids, idf, coef, write_tfidf=True)
    with pytest.raises(TypeError, match="int32"):
        sparse_idf_logistic(vals, ids.long(), idf, coef, write_tfidf=True)
    with pytest.raises(ValueError, match="shape"):
        sparse_idf_logistic(vals, ids, idf[:-1], coef, write_tfidf=True)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_idf_logistic(vals.t().contiguous().t(), ids, idf, coef, write_tfidf=True)
    with pytest.raises(ValueError, match="K >= 1"):
        sparse_idf_logistic(vals[:, :0], ids[:, :0], idf, coef, write_tfidf=True)
    empty = sparse_idf_logistic(vals[:0], ids[:0], idf, coef, write_tfidf=True)
    assert [t.shape for t in empty] == [(0, 4), (0,), (0,), (0, 2)]
    assert SPARSE_IDF_LOGISTIC.launches == before


def test_server_launches_the_sparse_kernel_for_hot_keys_only(cuda):
    from flink_ml_tpu_torch.linalg.vectors import SparseVector
    from flink_ml_tpu_torch.models.feature.idf import IDF
    from flink_ml_tpu_torch.serving.plan import chain_kinds

    d, nnz = 1000, 39
    rng = np.random.default_rng(2)

    def frame(n, k):
        return DataFrame.from_dict({"features": [
            SparseVector(d, rng.choice(d, k, replace=False), np.ones(k)) for _ in range(n)
        ]})

    idf = IDF().set_input_col("features").set_output_col("tfidf").fit(frame(300, nnz))
    lr = LogisticRegressionModelServable().set_features_col("tfidf")
    lr.coefficient = rng.normal(size=d) * 0.2
    pipe = PipelineModelServable([idf, lr])
    cfg = ServingConfig(max_batch_size=2048, queue_capacity_rows=8192, fusion_mode="fast")
    with InferenceServer(pipe, name="gpu-sparse-hot", serving_config=cfg,
                         warmup_template=frame(1, nnz)) as srv:
        SPARSE_IDF_LOGISTIC.reset_launches()
        big, small = frame(1500, nnz), frame(5, nnz)
        r_big, r_small = srv.predict(big), srv.predict(small)
        assert (r_big.bucket, r_small.bucket) == (2048, 8)
        kinds = chain_kinds(pipe._fastpath_plan)
        assert kinds[(2048, 64)] == ("megakernel",) and kinds[(8, 64)] == ("fused",)
        assert SPARSE_IDF_LOGISTIC.launches == 1  # (2048, 64) is hot, (8, 64) is not
    ref = pipe.transform(big, device="cpu")
    for a, b in zip(r_big.dataframe.column("tfidf"), ref.column("tfidf")):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(r_big.dataframe.column("prediction"), ref.column("prediction"))
    assert ulp_diff(r_big.dataframe.column("rawPrediction"), ref.column("rawPrediction")) <= (
        ULP_ENVELOPE["sparse_idf_logistic"]
    )


# ---------------------------------------------------------------------------
# the MLP serving megakernel: scale → mlp and the MLP alone
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.ops.kernels import scale_fn  # noqa: E402
from flink_ml_tpu_torch.servable import MLPClassifierModelServable  # noqa: E402
from flink_ml_tpu_torch.servable.megakernels import (  # noqa: E402
    MLP_MAX_CLASSES,
    MLP_MAX_HEADS,
    MLP_MAX_LAYERS,
    MLP_MAX_WIDTH,
    ROWLOCAL_MLP,
    RowLocalOp,
    rowlocal_mlp,
    rowlocal_mlp_plain,
)

def _mlp_head(inputs, ops, head_src, layers, labels, run=None):
    """The table ``ops`` then one MLP head on slot ``head_src``, through
    ``rowlocal_mlp``: ``(the table's outputs, prediction, probabilities)``."""
    head = RowLocalOp("mlp", head_src, labels, layers=layers)
    outs = (run or rowlocal_mlp)(inputs, list(ops) + [head])
    return outs[:-2], outs[-2], outs[-1]


def _mlp_head_plain(inputs, ops, head_src, layers, labels):
    return _mlp_head(inputs, ops, head_src, layers, labels, run=rowlocal_mlp_plain)


#: The published network, two small ones, and one at every limit of the kernel.
MLP_NETWORKS = {
    "256-512-512-8": [256, 512, 512, 8],
    "100-64-2": [100, 64, 2],
    "8-16-3": [8, 16, 3],
    "limits": [MLP_MAX_WIDTH] * MLP_MAX_LAYERS + [MLP_MAX_CLASSES],
}
MLP_PREDICTION_MARGIN = 1e-4  # predictions compared where the plain top-two logits differ by more


def _mlp_inputs(rows, widths, device, seed=0):
    rng = np.random.default_rng(seed)
    d = widths[0]
    std = np.abs(rng.normal(size=d)).astype(np.float32) + np.float32(0.5)
    std[0] = 0.0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    layers = [
        (t(rng.normal(size=(a, b)) * np.sqrt(2.0 / a)), t(rng.normal(size=b) * 0.1))
        for a, b in zip(widths[:-1], widths[1:])
    ]
    labels = t(rng.permutation(widths[-1]) * 2.0 + 1.0)
    return t(rng.normal(size=(rows, d))), t(rng.normal(size=d)), t(inv_std), layers, labels


def _top_two_gap(layers, scaled):
    h = scaled
    for W, b in layers[:-1]:
        h = torch.relu(h @ W + b)
    logits = h @ layers[-1][0] + layers[-1][1]
    if logits.shape[1] < 2:
        return torch.full((logits.shape[0],), float("inf"), device=logits.device)
    top = torch.topk(logits, 2, dim=1).values
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("rows", (1, 2, 33, 4096))
@pytest.mark.parametrize("net", sorted(MLP_NETWORKS))
@pytest.mark.parametrize("with_mean,with_std,write_scaled", CHAINS)
def test_mlp_kernel_matches_plain_version(cuda, rows, net, with_mean, with_std, write_scaled):
    """("scale", "mlp") as a one-op table, or, without the scaled column,
    the MLP alone (an empty table) on the scaled rows."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in full float32
    x, mean, inv_std, layers, labels = _mlp_inputs(rows, MLP_NETWORKS[net], cuda, seed=rows)
    before = ROWLOCAL_MLP.launches
    kw = dict(with_mean=with_mean, with_std=with_std)
    if write_scaled:
        inputs, ops, head_src = [x], [RowLocalOp("scale", 0, mean, inv_std, kw)], 1
    else:
        inputs, ops, head_src = [scale_fn(x, mean, inv_std, **kw)], [], 0
    outs, pred, probs = _mlp_head(inputs, ops, head_src, layers, labels)
    p_outs, p_pred, p_probs = _mlp_head_plain(inputs, ops, head_src, layers, labels)
    torch.cuda.synchronize()
    assert ROWLOCAL_MLP.launches == before + 1
    assert len(outs) == len(p_outs) == len(ops)
    if write_scaled:
        assert torch.equal(outs[0], p_outs[0])  # bit-equal: no contraction, same roundings
    p_scaled = (inputs + p_outs)[head_src]
    assert probs.shape == p_probs.shape
    assert ulp_diff(probs.cpu().numpy(), p_probs.cpu().numpy()) <= ULP_ENVELOPE["scale_mlp"]
    decided = (_top_two_gap(layers, p_scaled) > MLP_PREDICTION_MARGIN).cpu().numpy()
    np.testing.assert_array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided])


def test_mlp_kernel_takes_the_first_maximal_logit_and_nan_as_the_maximum(cuda):
    W = torch.eye(4, device=cuda)
    layers = [(W, torch.zeros(4, device=cuda))]
    labels = torch.tensor([10.0, 20.0, 30.0, 40.0], device=cuda)
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [float("nan"), 5.0, float("nan"), 1.0],
                      [-1.0, -1.0, -1.0, -1.0]], device=cuda)
    _, pred, probs = _mlp_head([x], [], 0, layers, labels)
    _, p_pred, p_probs = _mlp_head_plain([x], [], 0, layers, labels)
    assert pred.tolist() == p_pred.tolist() == [20.0, 10.0, 10.0]
    assert torch.isnan(probs[1]).all() and torch.isnan(p_probs[1]).all()


def test_mlp_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, mean, inv_std, layers, labels = _mlp_inputs(8, [16, 32, 3], cuda)
    before = ROWLOCAL_MLP.launches

    def scale(mean, inv_std):
        return [RowLocalOp("scale", 0, mean, inv_std, {"with_mean": True, "with_std": True})]

    with pytest.raises(TypeError, match="float32"):
        _mlp_head([x.double()], scale(mean, inv_std), 1, layers, labels)
    with pytest.raises(ValueError, match="contiguous"):
        _mlp_head([x], scale(mean, inv_std), 1,
                     [(layers[0][0].t().contiguous().t(), layers[0][1]), layers[1]], labels)
    with pytest.raises(ValueError, match="shape"):
        _mlp_head([x], scale(mean, inv_std), 1, layers, labels[:-1])
    with pytest.raises(ValueError, match="expected"):
        _mlp_head([x], scale(mean.cpu(), inv_std), 1, layers, labels)
    for widths in ([MLP_MAX_WIDTH + 1, 4, 3], [8] + [8] * MLP_MAX_LAYERS + [3],
                   [8, 16, MLP_MAX_CLASSES + 1]):  # too wide, too deep, too many classes
        big = _mlp_inputs(2, widths, cuda)
        with pytest.raises(ValueError, match="holds"):
            _mlp_head([big[0]], scale(big[1], big[2]), 1, big[3], big[4])
    outs, pred, probs = _mlp_head([x[:0]], scale(mean, inv_std), 1, layers, labels)
    assert [t.shape for t in outs + [pred, probs]] == [(0, 16), (0,), (0, 3)]
    assert ROWLOCAL_MLP.launches == before


def test_server_launches_the_mlp_kernel_from_two_rows(cuda):
    d = 64
    rng = np.random.default_rng(2)
    sc = StandardScalerModelServable().set_input_col("features").set_output_col("scaled")
    sc.set_with_mean(True)
    sc.mean, sc.std = rng.normal(size=d), np.abs(rng.normal(size=d)) + 0.5
    mlp = MLPClassifierModelServable().set_features_col("scaled")
    mlp._apply_model_arrays({
        "W0": rng.normal(size=(d, 512)) * np.sqrt(2.0 / d), "b0": np.zeros(512),
        "W1": rng.normal(size=(512, 512)) * np.sqrt(2.0 / 512), "b1": np.zeros(512),
        "W2": rng.normal(size=(512, 4)) * np.sqrt(2.0 / 512), "b2": np.zeros(4),
        "labels": np.array([0.0, 1.0, 2.0, 3.0]),
    })
    pipe = PipelineModelServable([sc, mlp])
    cfg = ServingConfig(max_batch_size=2048, queue_capacity_rows=8192, fusion_mode="fast")
    template = DataFrame.from_dict({"features": rng.normal(size=(1, d))})
    with InferenceServer(pipe, name="gpu-mlp", serving_config=cfg, warmup_template=template) as srv:
        ROWLOCAL_MLP.reset_launches()
        big = DataFrame.from_dict({"features": rng.normal(size=(1500, d))})
        one = DataFrame.from_dict({"features": rng.normal(size=(1, d))})
        r_big, r_one = srv.predict(big), srv.predict(one)
        assert (r_big.bucket, r_one.bucket) == (2048, 1)
        assert ROWLOCAL_MLP.launches == 1  # bucket 2048 is hot, bucket 1 is not
    ref = pipe.transform(big, device="cpu")
    np.testing.assert_array_equal(r_big.dataframe.column("scaled"), ref.column("scaled"))
    np.testing.assert_allclose(r_big.dataframe.column("rawPrediction"), ref.column("rawPrediction"),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the scale → kmeans serving megakernel
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.servable import KMeansModelServable  # noqa: E402
from flink_ml_tpu_torch.servable.megakernels import (  # noqa: E402
    KMEANS_MAX_DIM,
    KMEANS_MAX_K,
    SCALE_KMEANS,
    scale_kmeans,
    scale_kmeans_plain,
)

KMEANS_MEASURES = ("euclidean", "manhattan", "cosine")
KMEANS_MARGIN = 1e-4  # predictions compared where the float64 top-two distance gap is larger


def _kmeans_inputs(rows, d, k, device, seed=0):
    """Uniform [0, 1) rows (the published generator's kind), a scaler with
    the zero-std guard, and centroids drawn from the same population."""
    rng = np.random.default_rng(seed)
    std = (rng.random(d) * 0.3 + 0.2).astype(np.float32)
    std[0] = 0.0
    inv_std = np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return t(rng.random((rows, d))), t(rng.random(d) * 0.5), t(inv_std), t(rng.normal(size=(k, d)))


def _kmeans_decided(measure, scaled, centroids):
    """Rows whose float64 top-two distance gap exceeds the margin; rows with
    a NaN distance are decided (the first NaN wins)."""
    X, C = scaled.double(), centroids.double()
    if measure == "euclidean":
        dist = torch.sqrt(((X[:, None, :] - C[None]) ** 2).sum(-1))
    elif measure == "manhattan":
        dist = (X[:, None, :] - C[None]).abs().sum(-1)
    else:
        dist = 1.0 - (X @ C.T) / X.norm(dim=1)[:, None] / C.norm(dim=1)[None, :]
    nan = torch.isnan(dist).any(dim=1)
    if dist.shape[1] < 2:
        return torch.ones_like(nan).cpu().numpy()
    top = torch.topk(torch.nan_to_num(dist, nan=0.0), 2, dim=1, largest=False).values
    return (nan | (top[:, 1] - top[:, 0] > KMEANS_MARGIN)).cpu().numpy()


@pytest.mark.parametrize("rows", (1, 33, 4096))
@pytest.mark.parametrize("d", (1, 7, 100, 256))
@pytest.mark.parametrize("k", (2, 10, 64))
@pytest.mark.parametrize("measure", KMEANS_MEASURES)
def test_kmeans_kernel_matches_plain_version(cuda, rows, d, k, measure):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in full float32
    x, mean, inv_std, C = _kmeans_inputs(rows, d, k, cuda, seed=rows + d + k)
    for with_mean, with_std, write_scaled in CHAINS:
        kw = dict(measure=measure, with_mean=with_mean, with_std=with_std)
        before = SCALE_KMEANS.launches
        scaled, pred = scale_kmeans(x, mean, inv_std, C, write_scaled=write_scaled, **kw)
        p_scaled, p_pred = scale_kmeans_plain(x, mean, inv_std, C, **kw)
        torch.cuda.synchronize()
        assert SCALE_KMEANS.launches == before + 1
        if write_scaled:
            assert torch.equal(scaled, p_scaled)  # bit-equal: no contraction, same roundings
        else:
            assert scaled is None
        assert pred.dtype == p_pred.dtype == torch.int32 and pred.shape == (rows,)
        decided = _kmeans_decided(measure, p_scaled, C)
        np.testing.assert_array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided])


@pytest.mark.parametrize("measure", KMEANS_MEASURES)
def test_kmeans_kernel_takes_the_first_minimum_and_nan_as_the_minimum(cuda, measure):
    """Duplicate centroids take the first index; a NaN feature (every
    measure) and a zero row under cosine give NaN everywhere, index 0; a
    zero centroid under cosine is a NaN column, which wins."""
    rng = np.random.default_rng(3)
    C = rng.random((4, 6)).astype(np.float32)
    C[2] = C[0]
    X = np.stack([C[0], C[0] * 0.999 + 0.0005, C[2], np.zeros(6), C[3], C[1]]).astype(np.float32)
    X[4, 2] = np.nan
    x, c = torch.from_numpy(X).to(cuda), torch.from_numpy(C).to(cuda)
    kw = dict(measure=measure, with_mean=False, with_std=False)
    _, pred = scale_kmeans(x, None, None, c, write_scaled=False, **kw)
    _, p_pred = scale_kmeans_plain(x, None, None, c, **kw)
    assert pred.tolist() == p_pred.tolist()
    assert pred[0] == pred[2] == pred[4] == 0 and pred[5] == 1
    if measure == "cosine":
        assert pred[3] == 0
        c[3] = 0.0
        _, pred = scale_kmeans(x, None, None, c, write_scaled=False, **kw)
        _, p_pred = scale_kmeans_plain(x, None, None, c, **kw)
        assert pred.tolist() == p_pred.tolist() == [3, 3, 3, 0, 0, 3]


@pytest.mark.parametrize("measure", KMEANS_MEASURES)
def test_kmeans_kernel_at_its_limits_and_past_one_grid(cuda, measure):
    """k and d at the kernel's limits, and more rows than one grid of
    blocks covers (the blocks stride over the rest)."""
    for rows, d, k in ((5, KMEANS_MAX_DIM, KMEANS_MAX_K), (10_000, 100, 10)):
        x, mean, inv_std, C = _kmeans_inputs(rows, d, k, cuda, seed=d)
        kw = dict(measure=measure, with_mean=True, with_std=True)
        scaled, pred = scale_kmeans(x, mean, inv_std, C, write_scaled=True, **kw)
        p_scaled, p_pred = scale_kmeans_plain(x, mean, inv_std, C, **kw)
        torch.cuda.synchronize()
        assert torch.equal(scaled, p_scaled)
        decided = _kmeans_decided(measure, p_scaled, C)
        np.testing.assert_array_equal(pred.cpu().numpy()[decided], p_pred.cpu().numpy()[decided])


def test_kmeans_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, mean, inv_std, C = _kmeans_inputs(8, 16, 3, cuda)
    before = SCALE_KMEANS.launches
    kw = dict(measure="euclidean", with_mean=True, with_std=True, write_scaled=True)
    with pytest.raises(TypeError, match="float32"):
        scale_kmeans(x.double(), mean, inv_std, C, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        scale_kmeans(x, mean, inv_std, C.t().contiguous().t(), **kw)
    with pytest.raises(ValueError, match="shape"):
        scale_kmeans(x, mean[:-1], inv_std, C, **kw)
    with pytest.raises(ValueError, match="expected"):
        scale_kmeans(x, mean, inv_std.cpu(), C, **kw)
    with pytest.raises(ValueError, match="holds"):
        scale_kmeans(*_kmeans_inputs(2, KMEANS_MAX_DIM + 1, 3, cuda), **kw)
    with pytest.raises(ValueError, match="holds"):
        scale_kmeans(*_kmeans_inputs(2, 8, KMEANS_MAX_K + 1, cuda), **kw)
    with pytest.raises(ValueError, match="has measures"):
        scale_kmeans(x, mean, inv_std, C, **dict(kw, measure="chebyshev"))
    empty = scale_kmeans(x[:0], mean, inv_std, C, **kw)
    assert [t.shape for t in empty] == [(0, 16), (0,)]
    assert SCALE_KMEANS.launches == before


def test_server_launches_the_kmeans_kernel_for_hot_buckets_only(cuda):
    d, k = 100, 10
    rng = np.random.default_rng(4)
    sc = StandardScalerModelServable().set_input_col("features").set_output_col("scaled")
    sc.set_with_mean(True)
    sc.mean, sc.std = np.full(d, 0.5), np.full(d, 0.29)
    km = KMeansModelServable().set_features_col("scaled").set_k(k)
    km.centroids, km.weights = rng.normal(size=(k, d)), np.ones(k)
    pipe = PipelineModelServable([sc, km])
    cfg = ServingConfig(max_batch_size=2048, queue_capacity_rows=8192, fusion_mode="fast")
    template = DataFrame.from_dict({"features": rng.random((1, d))})
    with InferenceServer(pipe, name="gpu-kmeans", serving_config=cfg, warmup_template=template) as srv:
        SCALE_KMEANS.reset_launches()
        big = DataFrame.from_dict({"features": rng.random((1500, d))})
        small = DataFrame.from_dict({"features": rng.random((5, d))})
        r_big, r_small = srv.predict(big), srv.predict(small)
        assert (r_big.bucket, r_small.bucket) == (2048, 8)
        assert SCALE_KMEANS.launches == 1  # bucket 2048 is hot (3016 per row), bucket 8 is not
    ref = pipe.transform(big, device="cpu")
    np.testing.assert_array_equal(r_big.dataframe.column("scaled"), ref.column("scaled"))
    decided = _kmeans_decided("euclidean", torch.from_numpy(ref.column("scaled")),
                              torch.from_numpy(np.asarray(km.centroids, np.float32)))
    np.testing.assert_array_equal(r_big.dataframe.column("prediction")[decided],
                                  ref.column("prediction")[decided])


# ---------------------------------------------------------------------------
# the row-local megakernel (any chain of the row-local ops ± a logistic head)
# ---------------------------------------------------------------------------

import copy  # noqa: E402

import flink_ml_tpu_torch.servable.megakernels as mk  # noqa: E402
from flink_ml_tpu_torch import native  # noqa: E402
from flink_ml_tpu_torch.models.feature.binarizer import Binarizer  # noqa: E402
from flink_ml_tpu_torch.models.feature.elementwise_product import ElementwiseProduct  # noqa: E402
from flink_ml_tpu_torch.models.feature.normalizer import Normalizer  # noqa: E402
from flink_ml_tpu_torch.servable.megakernels import (  # noqa: E402
    ROWLOCAL,
    ROWLOCAL_MAX_DIM,
    RowLocalOp,
    rowlocal_chain,
    rowlocal_chain_plain,
)

# Where an input of a binarize carries a normalize's rounding, entries within
# this margin of the threshold may round either way: they are not compared,
# and nothing downstream of them in their row. 1e-5 is ~100x the feature6
# envelope at these magnitudes.
BIN_MARGIN = 1e-5
ROWLOCAL_CASES = (
    "scale_11", "scale_10", "scale_01", "scale_00", "normalize_1", "normalize_2", "normalize_3",
    "product", "idf", "binarize", "impute_nan", "impute_value", "feature6", "feature6_logistic",
    "head_off_chain",
)


def _rowlocal_case(name, rows, d, device, seed=0):
    """``(inputs, ops)`` of one row-local chain on ``device``: standard-normal
    rows with, from 5 rows on, a zero row, a NaN, +inf and -inf; scalers with
    the zero-std guard; scalar columns with a tenth of their entries missing."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    x = rng.standard_normal((rows, d)).astype(np.float32)
    if rows >= 5:
        x[1] = 0.0
        x[2, d // 2] = np.nan
        x[3, 0] = np.inf
        x[4, d - 1] = -np.inf

    def inv_std():
        std = np.abs(rng.standard_normal(d)).astype(np.float32) + np.float32(0.5)
        std[0] = 0.0
        return t(np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std)))

    def positive(lo):
        return t(np.abs(rng.standard_normal(d)) + lo)

    def scale(src, with_mean=True, with_std=True):
        return RowLocalOp("scale", src, t(rng.standard_normal(d)), inv_std(),
                          {"with_mean": with_mean, "with_std": with_std})

    if name.startswith("scale_"):
        return [t(x)], [scale(0, name[-2] == "1", name[-1] == "1")]
    if name.startswith("normalize_"):
        return [t(x)], [RowLocalOp("normalize", 0, params={"p": float(name[-1])})]
    if name in ("product", "idf"):
        op = "elementwise_product" if name == "product" else "idf"
        return [t(x)], [RowLocalOp(op, 0, positive(0.1))]
    if name == "binarize":
        s = rng.standard_normal(rows)
        return [t(x), t(s), t(x * 0.5)], [
            RowLocalOp("binarize", 0, params={"threshold": 0.05}),
            RowLocalOp("binarize", 1, params={"threshold": -0.3}),
            RowLocalOp("binarize", 2, params={"threshold": 0.0}),
        ]
    if name.startswith("impute_"):
        missing_is_nan = name == "impute_nan"
        placeholder = np.float32(np.nan if missing_is_nan else 0.1)
        cols = [rng.integers(0, 100, rows).astype(np.float32) for _ in range(3)]
        for c in cols:
            c[rng.random(rows) < 0.1] = placeholder
        surrogates = t(rng.standard_normal(3))
        return [t(c) for c in cols], [
            RowLocalOp("impute", k, surrogates, params={"missing_is_nan": missing_is_nan,
                                                        "missing_value": 0.0 if missing_is_nan else 0.1,
                                                        "column": k})
            for k in range(3)
        ]
    ops = [
        scale(0),
        RowLocalOp("normalize", 1, params={"p": 2.0}),
        RowLocalOp("elementwise_product", 2, positive(0.1)),
        RowLocalOp("idf", 3, positive(0.2)),
        scale(4, with_mean=False),
        RowLocalOp("binarize", 5, params={"threshold": 0.05}),
    ]
    coef = t(rng.standard_normal(d) * (3.0 / np.sqrt(d)))
    if name == "feature6":
        return [t(x)], ops
    if name == "feature6_logistic":
        return [t(x)], ops + [RowLocalOp("logistic", 6, coef)]
    assert name == "head_off_chain"  # the head reads the scaler's output, not the binarizer's
    return [t(x)], [scale(0), RowLocalOp("binarize", 1, params={"threshold": 0.0}),
                    RowLocalOp("logistic", 1, coef)]


def _same_bits_or_nan(a, b):
    """Bit-equal, a NaN matching any NaN (its payload aside)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.masked_fill(na, 0.0).view(torch.int32), b.masked_fill(nb, 0.0).view(torch.int32)))


def _check_rowlocal(inputs, ops, got, want, where=""):
    """Each output against the plain version's: bit-equal until a normalize;
    from a normalize on within ``ULP_ENVELOPE["feature6"]``; a binarize of
    such an input equal outside ``BIN_MARGIN`` of its threshold, the rows
    with an entry inside left out of everything downstream; the head's
    rawPrediction within ``ULP_ENVELOPE["scale_logistic"]`` and its
    prediction equal where the float64 margin exceeds 1e-4. Returns the
    entries inside the margin."""
    plain = list(inputs) + list(want)
    rows = int(inputs[0].shape[0])
    rounded = [False] * len(inputs)  # carries a normalize's rounding
    decided = [torch.ones(rows, dtype=torch.bool, device=inputs[0].device)] * len(inputs)
    inside = 0
    k = 0
    for op in ops:
        dec = decided[op.src]
        if op.op == "logistic":
            pred, raw = got[k], got[k + 1]
            assert pred.shape == (rows,) and raw.shape == (rows, 2), where
            assert ulp_diff(raw[dec, 1].cpu().numpy(), want[k + 1][dec, 1].cpu().numpy()) \
                <= ULP_ENVELOPE["scale_logistic"], where
            for r in (raw, want[k + 1]):  # 1 - p in float32: its own ulps are ill-conditioned near p = 1
                assert _same_bits_or_nan(r[:, 0], 1.0 - r[:, 1]), where
            margin = plain[op.src].double() @ op.a.double()
            sure = dec & (margin.abs() > 1e-4)
            assert torch.equal(pred[sure], want[k][sure]), where
            rounded += [True, True]
            decided += [dec, dec]
            k += 2
            continue
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32, where
        row_mask = dec if g.dim() == 1 else dec[:, None].expand_as(g)
        if op.op == "binarize" and rounded[op.src]:
            near = (plain[op.src] - op.params["threshold"]).abs() <= BIN_MARGIN
            assert torch.equal(g[row_mask & ~near], w[row_mask & ~near]), where
            inside += int((row_mask & near).sum())
            dec = dec & ~(near if near.dim() == 1 else near.any(dim=1))
            rounded.append(False)
        elif rounded[op.src] or op.op == "normalize":
            assert ulp_diff(g[row_mask].cpu().numpy(), w[row_mask].cpu().numpy()) \
                <= ULP_ENVELOPE["feature6"], where
            rounded.append(True)
        else:
            assert _same_bits_or_nan(g[row_mask], w[row_mask]), where
            rounded.append(False)
        decided.append(dec)
        k += 1
    return inside


@pytest.mark.parametrize("name", ROWLOCAL_CASES)
@pytest.mark.parametrize("d", (1, 7, 32, 100, 257, ROWLOCAL_MAX_DIM))
def test_rowlocal_kernel_matches_plain_version(cuda, name, d):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain head's dot in full float32
    for rows in (1, 33, 4096):
        inputs, ops = _rowlocal_case(name, rows, d, cuda, seed=rows + d)
        before = ROWLOCAL.launches
        got = rowlocal_chain(inputs, ops)
        want = rowlocal_chain_plain(inputs, ops)
        torch.cuda.synchronize()
        assert ROWLOCAL.launches == before + 1
        assert len(got) == len(want)
        _check_rowlocal(inputs, ops, got, want, f"{name} rows={rows} d={d}")


def test_rowlocal_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    inputs, ops = _rowlocal_case("feature6_logistic", 8, 16, cuda)
    before = ROWLOCAL.launches
    with pytest.raises(TypeError, match="float32"):
        rowlocal_chain([inputs[0].double()], ops)
    with pytest.raises(ValueError, match="shape"):
        rowlocal_chain(inputs, [ops[0]._replace(a=ops[0].a[:-1])] + ops[1:])
    with pytest.raises(ValueError, match="reads slot"):
        rowlocal_chain(inputs, [ops[0]._replace(src=3)])
    with pytest.raises(ValueError, match="columns"):
        rowlocal_chain([torch.zeros((2, ROWLOCAL_MAX_DIM + 1), device=cuda)],
                       [RowLocalOp("binarize", 0, params={"threshold": 0.0})])
    with pytest.raises(ValueError, match="ops over"):
        rowlocal_chain(inputs, [RowLocalOp("binarize", 0, params={"threshold": 0.0})] * 33)
    empty = rowlocal_chain([inputs[0][:0]], ops)
    assert [tuple(t.shape) for t in empty][-2:] == [(0,), (0, 2)]
    assert ROWLOCAL.launches == before


def test_rowlocal_build_failure_raises_and_counts_nothing(cuda, tmp_path, monkeypatch):
    """A kernel whose source does not compile raises nvcc's error on its
    first launch: nothing falls back to the plain version."""
    (tmp_path / "csrc").mkdir()
    broken = (native.CSRC_DIR / ROWLOCAL.source).read_text() + "\nthis is not C++;\n"
    (tmp_path / "csrc" / ROWLOCAL.source).write_text(broken)
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    fresh = copy.copy(ROWLOCAL)
    fresh._fn = None
    fresh._launches = 0
    monkeypatch.setattr(mk, "ROWLOCAL", fresh)
    inputs, ops = _rowlocal_case("feature6", 4, 8, cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rowlocal_chain(inputs, ops)
    assert fresh.launches == 0


def test_server_launches_the_rowlocal_kernel_for_hot_buckets_only(cuda):
    """feature6 → logistic at d 100 scores 3556 per row: bucket 2048 is hot
    under the default bar, bucket 8 is not."""
    from flink_ml_tpu_torch.models.feature.idf import IDFModel
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScalerModel

    d = 100
    rng = np.random.default_rng(5)
    scaler = StandardScalerModel().set_input_col("input").set_output_col("scaled").set_with_mean(True)
    scaler.mean, scaler.std = rng.standard_normal(d), np.abs(rng.standard_normal(d)) + 0.5
    idf = IDFModel().set_input_col("weighted").set_output_col("tfidf")
    idf.idf, idf.doc_freq, idf.num_docs = np.abs(rng.standard_normal(d)) + 0.2, np.ones(d), np.asarray(4e5)
    rescale = StandardScalerModel().set_input_col("tfidf").set_output_col("rescaled")
    rescale.mean, rescale.std = np.zeros(d), np.abs(rng.standard_normal(d)) + 0.5
    lr = LogisticRegressionModelServable().set_features_col("bin")
    lr.coefficient = rng.standard_normal(d) * (3.0 / np.sqrt(d))
    pipe = PipelineModelServable([
        scaler, Normalizer().set_input_col("scaled").set_output_col("norm"),
        ElementwiseProduct().set_scaling_vec(np.abs(rng.standard_normal(d)) + 0.1)
        .set_input_col("norm").set_output_col("weighted"),
        idf, rescale, Binarizer().set_input_cols("rescaled").set_output_cols("bin").set_thresholds(0.05), lr,
    ])
    cfg = ServingConfig(max_batch_size=2048, queue_capacity_rows=8192, fusion_mode="fast")
    template = DataFrame.from_dict({"input": rng.standard_normal((1, d))})
    with InferenceServer(pipe, name="gpu-rowlocal", serving_config=cfg, warmup_template=template) as srv:
        ROWLOCAL.reset_launches()
        big = DataFrame.from_dict({"input": rng.standard_normal((1500, d))})
        small = DataFrame.from_dict({"input": rng.standard_normal((5, d))})
        r_big, r_small = srv.predict(big), srv.predict(small)
        assert (r_big.bucket, r_small.bucket) == (2048, 8)
        assert ROWLOCAL.launches == 1
    ref = pipe.transform(big, device="cpu")
    np.testing.assert_array_equal(r_big.dataframe.column("scaled"), ref.column("scaled"))
    assert ulp_diff(r_big.dataframe.column("norm"), ref.column("norm")) <= ULP_ENVELOPE["feature6"]
    near = np.abs(ref.column("rescaled") - 0.05) <= BIN_MARGIN
    np.testing.assert_array_equal(r_big.dataframe.column("bin")[~near], ref.column("bin")[~near])


# ---------------------------------------------------------------------------
# the ring-attention fold (csrc/flash_fold.cu)
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.models.classification.attention_classifier import (  # noqa: E402
    SelfAttentionClassifierModel,
    _forward as attention_forward,
    _init_params as attention_init_params,
)
from flink_ml_tpu_torch.parallel import (  # noqa: E402
    FLASH_FOLD,
    fused_fold,
    reference_fold,
    ring_attention,
)

# (name, causal, n_valid relative to k_pos0 or None, q_pos0, k_pos0, state)
FOLD_CASES = [
    ("first_unmasked", False, None, 0, 0, "first"),
    ("first_causal", True, None, 0, 0, "first"),
    ("carried_causal_nv_inside", True, 45, 64, 0, "carried"),
    ("mixed_nv_inside", False, 17, 0, 0, "mixed"),
    ("mixed_nv_before_block", False, 0, 0, 300, "mixed"),  # every key masked
    ("mixed_causal_kv_after", True, None, 0, 300, "mixed"),  # every key masked
    ("carried_causal_kv_before", True, None, 300, 0, "carried"),
]


def _fold_case(BH, Tq, Tk, d, state, device, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    q, k, v = (rng.standard_normal((1, BH, n, d)) for n in (Tq, Tk, Tk))
    if state == "first":
        m, l, acc = np.full((1, BH, Tq), -np.inf), np.zeros((1, BH, Tq)), np.zeros((1, BH, Tq, d))
    else:
        m = rng.standard_normal((1, BH, Tq))
        l = np.abs(rng.standard_normal((1, BH, Tq))) + 1.0
        acc = rng.standard_normal((1, BH, Tq, d))
        if state == "mixed":
            m[..., ::3], l[..., ::3], acc[..., ::3, :] = -np.inf, 0.0, 0.0
    return [t(a) for a in (q, k, v, m, l, acc)]


def _attends(Tq, Tk, q_pos0, k_pos0, causal, n_valid, device):
    q_pos = q_pos0 + torch.arange(Tq, device=device)[:, None]
    k_pos = k_pos0 + torch.arange(Tk, device=device)[None, :]
    keep = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        keep &= q_pos >= k_pos
    if n_valid is not None:
        keep &= k_pos < n_valid
    return keep


def _idle_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid, device):
    return ~_attends(Tq, Tk, q_pos0, k_pos0, causal, n_valid, device).any(dim=1)


def _check_fold_on_card(got, want, inputs, idle, s_mag, where):
    """m within 1e-6 of |m| + ``s_mag`` (the row's largest scale · Σ_d
    |q_d k_d|: a score that cancels to near 0 keeps the error of its
    terms), l and acc within 1e-5 relative (another summation order); rows
    with nothing attendable exact; m_out >= m_in; no NaN."""
    m_in, l_in, acc_in = inputs
    for g in got:
        assert not torch.isnan(g).any(), where
    gm, gl, ga = got
    wm, wl, wa = want
    assert torch.equal(torch.isneginf(gm), torch.isneginf(wm)), where
    fin = torch.isfinite(wm)
    assert torch.all((gm[fin] - wm[fin]).abs() <= 1e-6 * (wm[fin].abs() + s_mag[fin])), where
    torch.testing.assert_close(gl, wl, rtol=1e-5, atol=1e-5 * max(1.0, float(wl.abs().max())), msg=where)
    torch.testing.assert_close(ga, wa, rtol=1e-5, atol=1e-5 * max(1.0, float(wa.abs().max())), msg=where)
    assert torch.all(gm >= m_in), where
    seen = torch.isfinite(m_in)
    kept, fresh = seen & idle, ~seen & idle
    assert torch.equal(gm[kept], m_in[kept]) and torch.equal(gl[kept], l_in[kept]), where
    assert torch.equal(ga[kept], acc_in[kept]), where
    assert torch.all(torch.isneginf(gm[fresh])) and torch.all(gl[fresh] == 0), where
    assert torch.all(ga[fresh] == 0), where


@pytest.mark.parametrize("case", [c[0] for c in FOLD_CASES])
@pytest.mark.parametrize("d", (8, 64, 100, 128, 256))
@pytest.mark.parametrize("Tq,Tk", ((1, 1), (63, 200), (130, 64), (256, 257)))
@pytest.mark.parametrize("BH", (1, 3))
def test_flash_fold_kernel_matches_plain_version(cuda, case, d, Tq, Tk, BH):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsums in full float32
    _, causal, nv, q_pos0, k_pos0, state = next(c for c in FOLD_CASES if c[0] == case)
    n_valid = None if nv is None else k_pos0 + nv
    inputs = _fold_case(BH, Tq, Tk, d, state, cuda, seed=Tq + Tk + d)
    scale = 1.0 / np.sqrt(d)
    before = FLASH_FOLD.launches
    got = fused_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
    want = reference_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
    torch.cuda.synchronize()
    assert FLASH_FOLD.launches == before + 1
    idle = _idle_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid, cuda)
    s_mag = scale * torch.einsum("bhqd,bhkd->bhqk", inputs[0].abs(), inputs[1].abs()).amax(-1)
    _check_fold_on_card(got, want, inputs[3:], idle[None, None, :].expand_as(got[0]), s_mag,
                        f"{case} BH={BH} Tq={Tq} Tk={Tk} d={d}")


def test_flash_fold_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    inputs = _fold_case(2, 8, 8, 16, "first", cuda, seed=1)
    before = FLASH_FOLD.launches
    with pytest.raises(TypeError, match="float32"):
        fused_fold(inputs[0].double(), *inputs[1:], 0, 0, False, None, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        fused_fold(inputs[0].transpose(2, 3).contiguous().transpose(2, 3), *inputs[1:], 0, 0, False, None, 0.25)
    with pytest.raises(ValueError, match="shape"):
        fused_fold(*inputs[:3], inputs[3][..., :4], *inputs[4:], 0, 0, False, None, 0.25)
    big = [torch.zeros((1, 1, 4, 257), device=cuda)] * 3
    with pytest.raises(ValueError, match="head dims"):
        fused_fold(*big, torch.zeros((1, 1, 4), device=cuda), torch.zeros((1, 1, 4), device=cuda),
                   big[0], 0, 0, False, None, 0.25)
    # under grad the same limits hold, forward and backward
    grad_in = [x.clone().requires_grad_(True) for x in inputs]
    with pytest.raises(TypeError, match="float32"):
        fused_fold(grad_in[0].double(), *grad_in[1:], 0, 0, False, None, 0.25)
    with pytest.raises(ValueError, match="head dims"):
        fused_fold(*[b.clone().requires_grad_(True) for b in big], torch.zeros((1, 1, 4), device=cuda),
                   torch.zeros((1, 1, 4), device=cuda), big[0], 0, 0, False, None, 0.25)
    assert FLASH_FOLD.launches == before
    m, l, acc = fused_fold(*grad_in, 0, 0, False, None, 0.25)
    (dq,) = torch.autograd.grad(torch.sum((acc / l[..., None]) ** 2), grad_in[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_flash_fold_chain_in_ring_order_matches_float64_dense_attention(cuda):
    """One Q block folded against four K/V blocks at the positions a
    four-shard ring gives shard 2, causal and with n_valid."""
    T, shards, me, d, BH = 96, 4, 2, 64, 3
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, BH, shards * T, d)) for _ in range(3))
    n_valid = shards * T - 50
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda)  # noqa: E731
    q_blk = t(q[:, :, me * T:(me + 1) * T])
    m = torch.full((1, BH, T), -torch.inf, device=cuda)
    l = torch.zeros((1, BH, T), device=cuda)
    acc = torch.zeros((1, BH, T, d), device=cuda)
    for step in range(shards):
        src = (me - step) % shards
        m, l, acc = fused_fold(q_blk, t(k[:, :, src * T:(src + 1) * T]), t(v[:, :, src * T:(src + 1) * T]),
                               m, l, acc, me * T, src * T, True, n_valid, 1.0 / np.sqrt(d))
    out = (acc / l.clamp(min=1e-30)[..., None]).cpu().numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q[:, :, me * T:(me + 1) * T], k) / np.sqrt(d)
    q_pos, k_pos = me * T + np.arange(T)[:, None], np.arange(shards * T)[None, :]
    s = np.where((q_pos >= k_pos) & (k_pos < n_valid), s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(axis=-1, keepdims=True), v)
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-6)


def test_attention_transform_on_the_card_launches_one_fold(cuda):
    E, H, vocab, C, T = 64, 4, 50, 3, 300
    rng = np.random.default_rng(8)
    model = SelfAttentionClassifierModel().set_embedding_dim(E).set_num_heads(H)
    model.params = attention_init_params(rng, vocab, E, C)
    model.labels = np.array([2.0, 5.0, 9.0])
    tok = rng.integers(0, vocab, size=(5, T)).astype(np.float64)
    df = DataFrame.from_dict({"features": tok})
    FLASH_FOLD.reset_launches()
    out = model.transform(df)
    assert FLASH_FOLD.launches == 1
    ref = model.transform(df, device="cpu")
    np.testing.assert_allclose(out.column("rawPrediction"), ref.column("rawPrediction"), rtol=0, atol=1e-5)
    p64 = {k: torch.from_numpy(np.asarray(a, np.float64)) for k, a in model.params.items()}
    logits = attention_forward(p64, torch.from_numpy(tok.astype(np.int64)), T, H).numpy()
    top2 = np.sort(logits, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(np.asarray(out.column("prediction"))[decided],
                                  model.labels[np.argmax(logits, axis=1)][decided])
    q = torch.from_numpy(rng.standard_normal((2, 70, 2, 16)).astype(np.float32)).to(cuda)
    FLASH_FOLD.reset_launches()
    got = ring_attention(q, q, q, causal=True)
    assert FLASH_FOLD.launches == 1
    q_t = q.transpose(1, 2).contiguous()
    m0 = torch.full(q_t.shape[:3], -torch.inf, device=cuda)
    _, l, acc = reference_fold(q_t, q_t, q_t, m0, torch.zeros_like(m0), torch.zeros_like(q_t), 0, 0, True, None,
                               1.0 / np.sqrt(16))
    plain = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# the fold's backward kernels (csrc/flash_fold_bwd.cu) and training
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.models.classification.attention_classifier import SelfAttentionClassifier  # noqa: E402
from flink_ml_tpu_torch.parallel import (  # noqa: E402
    FLASH_FOLD_BWD_DKV,
    FLASH_FOLD_BWD_DQ,
    fold_bwd_dkv,
    fold_bwd_dq,
    reference_fold_bwd,
)

BWD_CASES = FOLD_CASES + [("ties_carried_nv", False, 201, 0, 0, "ties")]
BWD_RTOL = 2e-5  # of |plain| plus the tensor's largest magnitude: products and row sums in another order


def _bwd_case(BH, Tq, Tk, d, state, device, seed):
    """A fold's inputs and cotangents with q and k on a 1/8 grid in [-1, 1]:
    every score is then exact in any summation order, so the kernels and
    the plain version find the same row maxima and ties (at a near-tie the
    fold's gradient jumps, and two summation orders could pick two keys).
    ``ties``: every key duplicated once and the carried m equal to the
    block max on every third row."""
    rng = np.random.default_rng(seed)
    state_of = "carried" if state == "ties" else state
    q, k, v, m, l, acc = _fold_case(BH, Tq, Tk, d, state_of, device, seed)
    q = torch.from_numpy(rng.integers(-8, 9, size=(1, BH, Tq, d)) / 8).float().to(device)
    k_np = rng.integers(-8, 9, size=(1, BH, Tk, d)) / 8
    if state == "ties":
        k_np[:, :, 1::2] = k_np[:, :, 0:Tk - 1:2]
    k = torch.from_numpy(k_np).float().to(device)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
           for s in ((1, BH, Tq), (1, BH, Tq), (1, BH, Tq, d))]
    return [q, k, v, m, l, acc], cot


def _check_bwd_on_card(got, want, inputs, idle, unattended_keys, where, rtol=BWD_RTOL):
    """Each gradient within ``rtol`` of |plain| + the tensor's largest
    magnitude; rows with no attendable key exact (dq 0, dl_in and dacc_in
    the state times its correction, dm_in = dm / 2 where m is -inf); keys
    no query attends exactly 0 in dk and dv; no NaN."""
    names = ("dq", "dk", "dv", "dm", "dl", "dacc")
    for name, g, w in zip(names, got, want):
        assert not torch.isnan(g).any(), f"{where} {name}"
        scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        err = (g - w).abs()
        assert torch.all(err <= rtol * (w.abs() + scale)), f"{where} {name}: {float(err.max())}"
    dq, dk, dv, dm_in, dl_in, dacc_in = got
    m_in = inputs[3]
    assert torch.all(dq[idle] == 0), where
    assert torch.equal(dl_in[idle], want[4][idle]) and torch.equal(dacc_in[idle], want[5][idle]), where
    fresh = idle & torch.isneginf(m_in)
    assert torch.equal(dm_in[fresh], want[3][fresh]), where
    assert torch.all(dk[unattended_keys] == 0) and torch.all(dv[unattended_keys] == 0), where


def _unattended_keys(Tq, Tk, q_pos0, k_pos0, causal, n_valid, device):
    return ~_attends(Tq, Tk, q_pos0, k_pos0, causal, n_valid, device).any(dim=0)


@pytest.mark.parametrize("case", [c[0] for c in BWD_CASES])
@pytest.mark.parametrize("d", (8, 64, 100, 128, 256))
@pytest.mark.parametrize("Tq,Tk", ((1, 1), (63, 200), (130, 64), (256, 257)))
@pytest.mark.parametrize("BH", (1, 3))
def test_flash_fold_bwd_kernels_match_plain_version(cuda, case, d, Tq, Tk, BH):
    torch.backends.cuda.matmul.allow_tf32 = False
    _, causal, nv, q_pos0, k_pos0, state = next(c for c in BWD_CASES if c[0] == case)
    n_valid = None if nv is None else k_pos0 + nv
    inputs, (dm, dl, dacc) = _bwd_case(BH, Tq, Tk, d, state, cuda, seed=Tq + 3 * Tk + d)
    scale = 1.0 / np.sqrt(d)
    if state == "ties":  # m equal to the block max on every third row
        s = torch.einsum("bhqd,bhkd->bhqk", inputs[0], inputs[1]) * scale
        s[..., n_valid:] = -torch.inf
        inputs[3][..., ::3] = s.amax(-1)[..., ::3]
    before = (FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches)
    dq, dm_in, dl_in, dacc_in, safe, bmax, dbc = fold_bwd_dq(*inputs, q_pos0, k_pos0, causal, n_valid, scale,
                                                            dm, dl, dacc)
    dk, dv = fold_bwd_dkv(*inputs[:3], q_pos0, k_pos0, causal, n_valid, scale, dl, dacc, safe, bmax, dbc)
    want = reference_fold_bwd(*inputs, q_pos0, k_pos0, causal, n_valid, scale, dm, dl, dacc)
    torch.cuda.synchronize()
    assert (FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches) == (before[0] + 1, before[1] + 1)
    idle = _idle_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tq)
    unattended = _unattended_keys(Tq, Tk, q_pos0, k_pos0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tk)
    _check_bwd_on_card((dq, dk, dv, dm_in, dl_in, dacc_in), want, inputs, idle, unattended,
                       f"{case} BH={BH} Tq={Tq} Tk={Tk} d={d}")


@pytest.mark.parametrize("case", ("first_causal", "mixed_nv_inside", "carried_causal_kv_before", "ties_carried_nv"))
@pytest.mark.parametrize("d", (1, 7, 30, 129))
@pytest.mark.parametrize("unaligned", (False, True))
def test_flash_fold_bwd_kernels_take_any_head_dim_and_unaligned_rows(cuda, case, d, unaligned):
    """Head dims that are not a multiple of 4, and inputs whose storage
    starts 4 bytes past a 16-byte boundary, take the kernels' 4-byte copies
    and scalar stores: the same contract as the grid above."""
    torch.backends.cuda.matmul.allow_tf32 = False
    BH, Tq, Tk = 3, 63, 200
    _, causal, nv, q_pos0, k_pos0, state = next(c for c in BWD_CASES if c[0] == case)
    n_valid = None if nv is None else k_pos0 + nv
    inputs, cot = _bwd_case(BH, Tq, Tk, d, state, cuda, seed=d + 11)
    scale = 1.0 / np.sqrt(d)
    if state == "ties":  # m equal to the block max on every third row
        s = torch.einsum("bhqd,bhkd->bhqk", inputs[0], inputs[1]) * scale
        s[..., n_valid:] = -torch.inf
        inputs[3][..., ::3] = s.amax(-1)[..., ::3]
    if unaligned:
        def shifted(x):
            y = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x)
            y.copy_(x)
            assert y.is_contiguous() and y.data_ptr() % 16 == 4
            return y
        inputs, cot = [shifted(x) for x in inputs], [shifted(c) for c in cot]
    dm, dl, dacc = cot
    dq, dm_in, dl_in, dacc_in, safe, bmax, dbc = fold_bwd_dq(*inputs, q_pos0, k_pos0, causal, n_valid, scale,
                                                            dm, dl, dacc)
    dk, dv = fold_bwd_dkv(*inputs[:3], q_pos0, k_pos0, causal, n_valid, scale, dl, dacc, safe, bmax, dbc)
    want = reference_fold_bwd(*inputs, q_pos0, k_pos0, causal, n_valid, scale, dm, dl, dacc)
    torch.cuda.synchronize()
    idle = _idle_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tq)
    unattended = _unattended_keys(Tq, Tk, q_pos0, k_pos0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tk)
    _check_bwd_on_card((dq, dk, dv, dm_in, dl_in, dacc_in), want, inputs, idle, unattended,
                       f"{case} d={d} unaligned={unaligned}")


@pytest.mark.parametrize("state", ("first", "carried"))
@pytest.mark.parametrize("d", (8, 128, 256))
@pytest.mark.parametrize("every", (12, 2))
def test_flash_fold_bwd_kernels_spread_db_over_many_equal_max_keys(cuda, state, d, every):
    """Every ``every``-th key is the all-ones vector and every query
    positive, so those keys tie for each row's block max wherever they are
    attended: 12 or 13 of them (within the dq kernel's 32 max-key slots) or,
    every second key, up to 73 (past them: the dq kernel's second walk
    recomputes those rows); the other keys, entries at most 7/8, score
    lower. dB / cnt must reach each tied key in both kernels, as the plain
    VJP spreads it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    BH, Tq, Tk = 2, 140, 150
    inputs, (dm, dl, dacc) = _bwd_case(BH, Tq, Tk, d, state, cuda, seed=d)
    rng = np.random.default_rng(d)
    inputs[0] = torch.from_numpy(rng.integers(1, 9, size=(1, BH, Tq, d)) / 8).float().to(cuda)
    k = rng.integers(-8, 8, size=(1, BH, Tk, d)) / 8
    k[:, :, 5::every] = 1.0
    inputs[1] = torch.from_numpy(k).float().to(cuda)
    scale = 1.0 / np.sqrt(d)
    for causal, n_valid in ((False, None), (True, 100)):
        dq, dm_in, dl_in, dacc_in, safe, bmax, dbc = fold_bwd_dq(*inputs, 0, 0, causal, n_valid, scale,
                                                                dm, dl, dacc)
        dk, dv = fold_bwd_dkv(*inputs[:3], 0, 0, causal, n_valid, scale, dl, dacc, safe, bmax, dbc)
        want = reference_fold_bwd(*inputs, 0, 0, causal, n_valid, scale, dm, dl, dacc)
        torch.cuda.synchronize()
        s = torch.einsum("bhqd,bhkd->bhqk", inputs[0], inputs[1]) * scale
        s = torch.where(_attends(Tq, Tk, 0, 0, causal, n_valid, cuda), s, -torch.inf)
        ties = (s == s.amax(-1, keepdim=True)).sum(-1)
        if every == 2:
            assert int((ties > 32).sum()) >= BH * 10  # rows past the slots
        else:
            assert int((ties > 4).sum()) >= BH * 10 and int((ties > 32).sum()) == 0
        idle = _idle_rows(Tq, Tk, 0, 0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tq)
        unattended = _unattended_keys(Tq, Tk, 0, 0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tk)
        _check_bwd_on_card((dq, dk, dv, dm_in, dl_in, dacc_in), want, inputs, idle, unattended,
                           f"{state} d={d} every={every} causal={causal}")


@pytest.mark.parametrize("state", ("first", "carried"))
@pytest.mark.parametrize("d", (8, 128, 256))
def test_flash_fold_bwd_kernels_hold_when_every_key_is_equal(cuda, state, d):
    """Every key the same vector, as a run of one repeated token gives (the
    classifier has no position embedding): every attendable score of a row
    ties, and on a first fold dq = scale · dm · k is the difference of two
    sums about Tk times larger. The grid's contract against the plain VJP;
    under causal a row r has r + 1 tied keys, so rows within the dq kernel's
    32 slots and rows of its second walk both run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    BH, Tq, Tk = 2, 70, 150
    inputs, (dm, dl, dacc) = _bwd_case(BH, Tq, Tk, d, state, cuda, seed=d + 3)
    inputs[1] = inputs[1][:, :, :1].expand(1, BH, Tk, d).contiguous()
    scale = 1.0 / np.sqrt(d)
    for causal, n_valid in ((False, None), (True, 100)):
        dq, dm_in, dl_in, dacc_in, safe, bmax, dbc = fold_bwd_dq(*inputs, 0, 0, causal, n_valid, scale,
                                                                dm, dl, dacc)
        dk, dv = fold_bwd_dkv(*inputs[:3], 0, 0, causal, n_valid, scale, dl, dacc, safe, bmax, dbc)
        want = reference_fold_bwd(*inputs, 0, 0, causal, n_valid, scale, dm, dl, dacc)
        torch.cuda.synchronize()
        idle = _idle_rows(Tq, Tk, 0, 0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tq)
        unattended = _unattended_keys(Tq, Tk, 0, 0, causal, n_valid, cuda)[None, None, :].expand(1, BH, Tk)
        _check_bwd_on_card((dq, dk, dv, dm_in, dl_in, dacc_in), want, inputs, idle, unattended,
                           f"{state} d={d} causal={causal}")


def test_flash_fold_bwd_wrappers_reject_what_the_kernels_do_not_take(cuda):
    inputs, (dm, dl, dacc) = _bwd_case(2, 8, 8, 16, "first", cuda, seed=1)
    before = (FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches)
    with pytest.raises(TypeError, match="float32"):
        fold_bwd_dq(*inputs, 0, 0, False, None, 0.25, dm.double(), dl, dacc)
    with pytest.raises(ValueError, match="contiguous"):
        fold_bwd_dq(*inputs, 0, 0, False, None, 0.25, dm, dl, dacc.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="shape"):
        fold_bwd_dkv(*inputs[:3], 0, 0, False, None, 0.25, dl, dacc, dm[..., :4], dm, dm)
    assert (FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches) == before


CENSUS_GAP = 1e-4  # a row's float64 top-two score gap past which both kernels must pick the float64 argmax


@pytest.mark.parametrize("state", ("first", "carried"))
@pytest.mark.parametrize("d", (64, 128, 256))
def test_flash_fold_bwd_kernels_agree_on_each_rows_max_keys(cuda, state, d):
    """The max-key census, off the 1/8 grid: q and k standard normal, so the
    scores round in both kernels and only bit-equal scores let the dkv
    kernel's ``s == bmax`` find the keys the dq kernel counted. dkv run with
    ``dbc`` (kept on the rows whose float64 top-two gap is clear) and with
    ``dbc`` zeroed: the dk difference must be ``dbc · q · scale`` scattered
    to each such row's float64 argmax, within 2e-5 of |difference| + dk's
    largest magnitude (the two runs round ds · q apart). dq's block max
    lies within 1e-5 of float64's, and on the clear rows dq and everywhere
    dv hold against the float64 plain VJP."""
    torch.backends.cuda.matmul.allow_tf32 = False
    BH, Tq, Tk = 3, 300, 1000
    inputs = _fold_case(BH, Tq, Tk, d, state, cuda, seed=d + (state == "first"))
    rng = np.random.default_rng(d)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
           for s in ((1, BH, Tq), (1, BH, Tq), (1, BH, Tq, d))]
    q, k = inputs[0], inputs[1]
    scale = 1.0 / np.sqrt(d)
    dq, dm_in, dl_in, dacc_in, safe, bmax, dbc = fold_bwd_dq(*inputs, 0, 0, False, None, scale, *cot)
    s64 = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    top2 = s64.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > CENSUS_GAP) & (dbc != 0)
    assert int(clear.sum()) > 0.9 * BH * Tq
    assert torch.all((bmax.double() - top2[..., 0]).abs() <= 1e-5 * (1 + top2[..., 0].abs()))
    dbc_clear = torch.where(clear, dbc, torch.zeros_like(dbc))
    dk_with, _ = fold_bwd_dkv(q, k, inputs[2], 0, 0, False, None, scale, cot[1], cot[2], safe, bmax, dbc_clear)
    dk_zero, dv = fold_bwd_dkv(q, k, inputs[2], 0, 0, False, None, scale, cot[1], cot[2], safe, bmax,
                               torch.zeros_like(dbc))
    diff = dk_with.double() - dk_zero.double()
    want = torch.zeros_like(diff)
    argmax = s64.argmax(dim=-1)  # [1, BH, Tq]
    contrib = dbc_clear.double()[..., None] * q.double() * scale
    want.scatter_add_(2, argmax[..., None].expand(1, BH, Tq, d), contrib)
    err = (diff - want).abs()
    assert torch.all(err <= 2e-5 * (want.abs() + float(dk_zero.abs().max()))), float(err.max())
    want64 = reference_fold_bwd(*(x.double() for x in inputs), 0, 0, False, None, scale, *(c.double() for c in cot))
    for name, g, w in (("dq", dq.double()[clear], want64[0][clear]), ("dv", dv.double(), want64[2])):
        e = (g - w).abs()
        assert torch.all(e <= 2e-5 * (w.abs() + max(1.0, float(w.abs().max())))), f"{name}: {float(e.max())}"


def test_ring_attention_gradients_on_the_card_launch_both_backward_kernels(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 90, 2, 32)).astype(np.float32)) for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((2, 90, 2, 32)).astype(np.float32))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(ring_attention(*leaves, causal=True, n_valid=77), leaves, g)
    for kernel in (FLASH_FOLD, FLASH_FOLD_BWD_DQ, FLASH_FOLD_BWD_DKV):
        kernel.reset_launches()
    leaves = [x.to(cuda).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(ring_attention(*leaves, causal=True, n_valid=77), leaves, g.to(cuda))
    assert (FLASH_FOLD.launches, FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches) == (1, 1, 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_attention_fit_on_the_card_matches_the_cpu_fit(cuda):
    rng = np.random.default_rng(13)
    tok = rng.integers(0, 50, size=(5, 300))
    y = np.array([0.0, 1.0, 1.0, 0.0, 1.0])
    tok = np.where(rng.random((5, 300)) < 0.3, np.where(y[:, None] == 1.0, 7, 5), tok).astype(np.float64)
    df = DataFrame.from_dict({"features": tok, "label": y})

    def fit(device):
        est = (SelfAttentionClassifier().set_embedding_dim(64).set_num_heads(4).set_max_iter(3)
               .set_global_batch_size(2).set_learning_rate(1e-2).set_seed(2))
        return est, est.fit(df, device=device)

    for kernel in (FLASH_FOLD, FLASH_FOLD_BWD_DQ, FLASH_FOLD_BWD_DKV):
        kernel.reset_launches()
    est, model = fit(None)
    assert (FLASH_FOLD.launches, FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches) == (3, 3, 3)
    cpu_est, cpu_model = fit("cpu")
    np.testing.assert_allclose(est.loss_history, cpu_est.loss_history, rtol=1e-5)
    out = model.transform(df, device="cpu")
    ref = cpu_model.transform(df, device="cpu")
    np.testing.assert_allclose(out.column("rawPrediction"), ref.column("rawPrediction"), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the table's kmeans head, the MLP kernel's table prologue, the sparse
# kernel's head-less mode
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.servable.megakernels import (  # noqa: E402
    ROWLOCAL_MLP,
    rowlocal_mlp,
    rowlocal_mlp_plain,
    sparse_idf,
    sparse_idf_plain,
)

TABLE_KMEANS_CHAINS = ("normalize_kmeans", "scale_normalize_kmeans", "kmeans_then_ops", "two_kmeans")


def _table_kmeans_case(name, rows, d, k, measure, device, seed=0):
    """``(inputs, ops)`` of a table chain with kmeans heads: uniform rows (the
    published generator's kind) with, from 5 rows on, a zero row and a NaN;
    centroids drawn from the rows the head reads."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    x = rng.random((rows, d)).astype(np.float32)
    if rows >= 5:
        x[1] = 0.0
        x[2, d // 2] = np.nan
    std = (rng.random(d) * 0.3 + 0.2).astype(np.float32)
    std[0] = 0.0
    inv_std = t(np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std)))
    scale = RowLocalOp("scale", 0, t(rng.random(d) * 0.5), inv_std, {"with_mean": True, "with_std": True})
    norm = RowLocalOp("normalize", 0, params={"p": 2.0})
    raw_c = rng.random((k, d))
    unit_c = raw_c / np.linalg.norm(raw_c, axis=1, keepdims=True)

    def kmeans(src, c):
        return RowLocalOp("kmeans", src, t(c), params={"measure": measure})

    if name == "normalize_kmeans":
        return [t(x)], [norm, kmeans(1, unit_c)]
    if name == "scale_normalize_kmeans":
        return [t(x)], [scale, norm._replace(src=1), kmeans(2, unit_c)]
    if name == "kmeans_then_ops":  # the head mid-chain, then ops on its input
        return [t(x)], [kmeans(0, raw_c), RowLocalOp("binarize", 0, params={"threshold": 0.5})]
    assert name == "two_kmeans"  # two heads, their norms side by side in shared memory
    return [t(x)], [kmeans(0, raw_c), norm, kmeans(2, unit_c[::-1].copy())]


@pytest.mark.parametrize("name", TABLE_KMEANS_CHAINS)
@pytest.mark.parametrize("d", (1, 8, 100, 1000))
@pytest.mark.parametrize("k", (1, 10, 64))
@pytest.mark.parametrize("measure", KMEANS_MEASURES)
def test_table_kmeans_head_matches_plain_version(cuda, name, d, k, measure):
    torch.backends.cuda.matmul.allow_tf32 = False
    for rows in (1, 33, 4096):
        where = f"{name} rows={rows} d={d} k={k} {measure}"
        inputs, ops = _table_kmeans_case(name, rows, d, k, measure, cuda, seed=rows + d + k)
        before = ROWLOCAL.launches
        got = rowlocal_chain(inputs, ops)
        want = rowlocal_chain_plain(inputs, ops)
        torch.cuda.synchronize()
        assert ROWLOCAL.launches == before + 1, where
        slots_plain = list(inputs) + list(want)
        for i, op in enumerate(ops):
            g, w = got[i], want[i]
            assert g.shape == w.shape and g.dtype == w.dtype, where
            if op.op == "kmeans":
                dec = torch.from_numpy(_kmeans_decided(measure, slots_plain[op.src], op.a)).to(cuda)
                assert torch.equal(g[dec], w[dec]), where
                assert bool(((g >= 0) & (g < op.a.shape[0])).all()), where
            elif op.op == "normalize":
                assert ulp_diff(g.cpu().numpy(), w.cpu().numpy()) <= ULP_ENVELOPE["feature6"], where
            else:
                assert _same_bits_or_nan(g, w), where


@pytest.mark.parametrize("measure", KMEANS_MEASURES)
@pytest.mark.parametrize("d,k", ((7, 10), (100, 10), (256, 1024)))
def test_table_kmeans_head_gives_the_dedicated_kernels_cluster(cuda, measure, d, k):
    """("scale", "kmeans") on the table and on its own kernel: the same
    norms and distances, so the same index in every row, ties included."""
    from flink_ml_tpu_torch.servable.megakernels import SCALE_KMEANS, scale_kmeans

    x, mean, inv_std, C = _kmeans_inputs(4096, d, k, cuda, seed=d + k)
    C[3] = C[1]  # a duplicate centroid: the first index wins in both
    ops = [RowLocalOp("scale", 0, mean, inv_std, {"with_mean": True, "with_std": True}),
           RowLocalOp("kmeans", 1, C, params={"measure": measure})]
    scaled, idx = rowlocal_chain([x], ops)
    d_scaled, d_idx = scale_kmeans(x, mean, inv_std, C, measure=measure, with_mean=True,
                                   with_std=True, write_scaled=True)
    torch.cuda.synchronize()
    assert _same_bits_or_nan(scaled, d_scaled)
    assert torch.equal(idx, d_idx)


def test_table_kmeans_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.rand((8, 4), device=cuda)
    C = torch.rand((3, 4), device=cuda)
    before = ROWLOCAL.launches
    with pytest.raises(ValueError, match="shape"):
        rowlocal_chain([x], [RowLocalOp("kmeans", 0, C[:, :3].contiguous(), params={"measure": "cosine"})])
    with pytest.raises(ValueError, match="measure"):
        rowlocal_chain([x], [RowLocalOp("kmeans", 0, C, params={"measure": "chebyshev"})])
    with pytest.raises(ValueError, match="centroids"):
        rowlocal_chain([x], [RowLocalOp("kmeans", 0, torch.rand((1025, 4), device=cuda),
                                        params={"measure": "euclidean"})])
    idx_then_scale = [RowLocalOp("kmeans", 0, C, params={"measure": "euclidean"}),
                      RowLocalOp("scale", 1, params={"with_mean": False, "with_std": False})]
    with pytest.raises(ValueError, match="int32"):  # only binarize and impute read an index column
        rowlocal_chain([x], idx_then_scale)
    assert ROWLOCAL.launches == before


ROWLOCAL_MLP_CHAINS = ("normalize", "product_scale", "scale", "logistic_then_normalize")


def _rowlocal_mlp_case(name, rows, widths, device, seed=0):
    """``(inputs, ops, head_src, layers, labels)``: a table chain ending in
    the MLP, on the MLP test's inputs."""
    x, mean, inv_std, layers, labels = _mlp_inputs(rows, widths, device, seed)
    rng = np.random.default_rng(seed + 1)
    d = widths[0]
    scaling = torch.from_numpy(np.abs(rng.normal(size=d)).astype(np.float32) + 0.1).to(device)
    scale = RowLocalOp("scale", 0, mean, inv_std, {"with_mean": True, "with_std": True})
    norm = RowLocalOp("normalize", 0, params={"p": 2.0})
    if name == "normalize":
        return [x], [norm], 1, layers, labels
    if name == "product_scale":
        return [x], [RowLocalOp("elementwise_product", 0, scaling), scale._replace(src=1)], 2, layers, labels
    if name == "scale":
        return [x], [scale], 1, layers, labels
    assert name == "logistic_then_normalize"  # a logistic head, then the MLP on the normalized row
    coef = torch.from_numpy((rng.normal(size=d) * 0.1).astype(np.float32)).to(device)
    return [x], [RowLocalOp("logistic", 0, coef), norm], 3, layers, labels


@pytest.mark.parametrize("rows", (1, 2, 33, 4096))
@pytest.mark.parametrize("net", ("256-512-512-8", "100-64-2", "8-16-3", "limits"))
@pytest.mark.parametrize("name", ROWLOCAL_MLP_CHAINS)
def test_rowlocal_mlp_kernel_matches_plain_version(cuda, rows, net, name):
    torch.backends.cuda.matmul.allow_tf32 = False
    where = f"{name} rows={rows} net={net}"
    inputs, ops, head_src, layers, labels = _rowlocal_mlp_case(name, rows, MLP_NETWORKS[net], cuda,
                                                               seed=rows)
    before = ROWLOCAL_MLP.launches
    outs, pred, probs = _mlp_head(inputs, ops, head_src, layers, labels)
    p_outs, p_pred, p_probs = _mlp_head_plain(inputs, ops, head_src, layers, labels)
    torch.cuda.synchronize()
    assert ROWLOCAL_MLP.launches == before + 1, where
    _check_rowlocal(inputs, ops, outs, p_outs, where)
    assert probs.shape == p_probs.shape and pred.shape == p_pred.shape, where
    assert ulp_diff(probs.cpu().numpy(), p_probs.cpu().numpy()) <= ULP_ENVELOPE["scale_mlp"], where
    sure = _top_two_gap(layers, (list(inputs) + p_outs)[head_src]) > MLP_PREDICTION_MARGIN
    assert torch.equal(pred[sure], p_pred[sure]), where


@pytest.mark.parametrize("rows", (1, 33, 4096))
def test_rowlocal_mlp_empty_table_gives_the_scale_prologues_bits(cuda, rows):
    """("scale", "mlp") through a one-op table, and the MLP alone through an
    empty table on the scaled rows it wrote: the same head input, the same
    layer code, so the same bits."""
    inputs, ops, head_src, layers, labels = _rowlocal_mlp_case("scale", rows, [256, 512, 512, 8], cuda)
    outs, pred, probs = _mlp_head(inputs, ops, head_src, layers, labels)
    none, d_pred, d_probs = _mlp_head([outs[0]], [], 0, layers, labels)
    torch.cuda.synchronize()
    assert none == []
    assert _same_bits(probs, d_probs)
    assert torch.equal(pred, d_pred)


def test_rowlocal_mlp_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    inputs, ops, head_src, layers, labels = _rowlocal_mlp_case("normalize", 8, [8, 16, 3], cuda)
    before = ROWLOCAL_MLP.launches
    with pytest.raises(ValueError, match="reads slot"):
        _mlp_head(inputs, ops, 5, layers, labels)
    with pytest.raises(ValueError, match="shape"):
        _mlp_head(inputs, ops, head_src, [(layers[0][0][:-1], layers[0][1])] + layers[1:], labels)
    with pytest.raises(ValueError, match="holds"):
        _mlp_head(inputs, ops, head_src, layers * 5, labels)
    assert ROWLOCAL_MLP.launches == before


@pytest.mark.parametrize("d", (8, 1000, 1 << 22))
def test_sparse_idf_alone_is_bit_equal_to_float32_values_times_idf(cuda, d):
    for rows in (1, 33, 4096):
        for K in (1, 8, 64):
            where = f"rows={rows} K={K}"
            vals, ids, idf, _coef = _sparse_inputs(rows, K, d, cuda, seed=rows + K)
            before = SPARSE_IDF_LOGISTIC.launches
            tfidf = sparse_idf(vals, ids, idf)
            torch.cuda.synchronize()
            assert SPARSE_IDF_LOGISTIC.launches == before + 1, where
            assert _same_bits(tfidf, sparse_idf_plain(vals, ids, idf)), where
            assert _same_bits(tfidf, vals * idf[ids.long()]), where
    assert tuple(sparse_idf(vals[:0], ids[:0], idf).shape) == (0, 64)


# ---------------------------------------------------------------------------
# the Pipeline path on the card: the batch plan against the CPU
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.builder import Pipeline, PipelineModel  # noqa: E402
from flink_ml_tpu_torch.config import Options, config  # noqa: E402
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans  # noqa: E402
from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler  # noqa: E402


@pytest.fixture
def batch_options():
    yield
    for option in (Options.BATCH_CHUNK_ROWS, Options.BATCH_PREFETCH_DEPTH, Options.FUSION_MODE,
                   Options.FUSION_MEGAKERNEL_MIN_SCORE):
        config.unset(option)


@pytest.mark.parametrize("depth", (1, 2))
def test_pipeline_batch_transform_on_the_card_matches_the_cpu(cuda, batch_options, depth):
    """StandardScaler → Normalizer → KMeans fitted on the card, transformed
    in the fast tier over chunks with the prefetch window: the batch tier's
    chain ("scale", "normalize") on the row-local kernel, KMeans per stage;
    held against the same model's CPU transform."""
    rng = np.random.default_rng(31)
    X = rng.random((3000, 100))
    est = Pipeline([
        StandardScaler().set_input_col("features").set_output_col("scaled").set_with_mean(True),
        Normalizer().set_input_col("scaled").set_output_col("norm"),
        KMeans().set_features_col("norm").set_k(10).set_max_iter(5).set_seed(3),
    ])
    model = est.fit(DataFrame.from_dict({"features": X}))
    config.set(Options.FUSION_MODE, "fast")
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)  # every chunk hot, the ragged one too
    config.set(Options.BATCH_CHUNK_ROWS, 1024)  # 2 chunks and a ragged tail
    config.set(Options.BATCH_PREFETCH_DEPTH, depth)
    ROWLOCAL.reset_launches()
    out = model.transform(DataFrame.from_dict({"features": X}))
    assert ROWLOCAL.launches == 3
    ref = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    np.testing.assert_array_equal(out.column("scaled"), ref.column("scaled"))
    assert ulp_diff(out.column("norm"), ref.column("norm")) <= ULP_ENVELOPE["feature6"]
    C = model.stages[2].centroids
    dist = np.sqrt(((ref.column("norm")[:, None, :] - C[None]) ** 2).sum(-1))
    top = np.sort(dist, axis=1)
    decided = top[:, 1] - top[:, 0] > KMEANS_MARGIN
    np.testing.assert_array_equal(out.column("prediction")[decided], ref.column("prediction")[decided])


def test_sparse_idf_lr_batch_on_the_card_is_bit_equal_to_the_cpu(cuda, batch_options):
    from flink_ml_tpu_torch.linalg.vectors import SparseVector
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
    from flink_ml_tpu_torch.models.feature.idf import IDFModel

    d = 1 << 22
    rng = np.random.default_rng(32)
    rows = [SparseVector(d, np.sort(rng.choice(d, size=int(k), replace=False)), rng.random(int(k)) + 0.5)
            for k in rng.integers(1, 40, size=2000)]
    idf = IDFModel().set_input_col("features").set_output_col("tfidf")
    idf.idf, idf.doc_freq, idf.num_docs = np.abs(rng.normal(size=d)) + 0.1, np.ones(d), np.asarray(9.0)
    lr = LogisticRegressionModel().set_features_col("tfidf")
    lr.coefficient = rng.normal(size=d) * 0.3
    model = PipelineModel([idf, lr])
    config.set(Options.FUSION_MODE, "fast")
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    config.set(Options.BATCH_CHUNK_ROWS, 512)
    df = DataFrame(["features"], None, [rows])
    SPARSE_IDF_LOGISTIC.reset_launches()
    out = model.transform(df)
    assert SPARSE_IDF_LOGISTIC.launches == 4
    ref = model.transform(df, device="cpu")
    for r, w in zip(out.column("tfidf"), ref.column("tfidf")):
        np.testing.assert_array_equal(r.values, w.values)
    np.testing.assert_array_equal(out.column("prediction"), ref.column("prediction"))
    assert ulp_diff(out.column("rawPrediction"), ref.column("rawPrediction")) \
        <= ULP_ENVELOPE["sparse_idf_logistic"]


def test_server_runs_idf_alone_on_the_headless_sparse_kernel(cuda):
    from flink_ml_tpu_torch.linalg.vectors import SparseVector
    from flink_ml_tpu_torch.models.feature.idf import IDFModel

    d = 1000
    rng = np.random.default_rng(33)
    idf = IDFModel().set_input_col("features").set_output_col("tfidf")
    idf.idf, idf.doc_freq, idf.num_docs = np.abs(rng.normal(size=d)) + 0.1, np.ones(d), np.asarray(9.0)
    pipe = PipelineModelServable([idf])

    def frame(n):
        return DataFrame(["features"], None, [[
            SparseVector(d, np.sort(rng.choice(d, size=int(k), replace=False)), rng.random(int(k)))
            for k in rng.integers(1, 9, size=n)]])

    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    try:
        cfg = ServingConfig(max_batch_size=256, queue_capacity_rows=1024, fusion_mode="fast")
        with InferenceServer(pipe, name="gpu-idf-alone", serving_config=cfg,
                             warmup_template=frame(1)) as srv:
            SPARSE_IDF_LOGISTIC.reset_launches()
            req = frame(200)
            resp = srv.predict(req)
            assert SPARSE_IDF_LOGISTIC.launches == 1
    finally:
        config.unset(Options.FUSION_MEGAKERNEL_MIN_SCORE)
    idf32 = idf.idf.astype(np.float32)
    for v, out in zip(req.column("features"), resp.dataframe.column("tfidf")):
        np.testing.assert_array_equal(out.indices, v.indices)
        want = (v.values.astype(np.float32) * idf32[v.indices]).astype(np.float64)
        np.testing.assert_array_equal(out.values, want)


# ---------------------------------------------------------------------------
# the table's last classes: sparse ops beside dense ones, sparse runs, ops
# after an MLP head, ops reading a kmeans index
# ---------------------------------------------------------------------------

TABLE_SPARSE_CHAINS = ("idf_lr_scale", "scale_idf_lr", "idf_idf", "idf_idf_lr", "two_sparse_heads")


def _table_sparse_case(name, rows, cap, d, device, seed=0):
    """``(inputs, ops)``: a sparse column (values, ids, nnz; rows shorter
    than the cap, zero, NaN and ±inf values) beside a dense one of width 100."""
    vals, ids, idf, coef = _sparse_inputs(rows, cap, d, device, seed)
    if rows >= 4 and cap >= 2:
        vals[1, 0], vals[2, 0], vals[3, 0] = float("nan"), float("inf"), float("-inf")
    nnz = (ids != 0).sum(dim=1).to(torch.int32)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.normal(size=(rows, 100)).astype(np.float32)).to(device)
    mean = torch.from_numpy(rng.normal(size=100).astype(np.float32)).to(device)
    inv_std = torch.from_numpy(np.abs(rng.normal(size=100)).astype(np.float32)).to(device)
    scale = RowLocalOp("scale", 3, mean, inv_std, {"with_mean": True, "with_std": True})
    idf2 = (idf * 0.5 + 0.25).contiguous()
    inputs = [vals, ids, nnz, x]

    def sidf(src, a):
        return RowLocalOp("sparse_idf", src, a, params={"ids": 1})

    def slr(src):
        return RowLocalOp("sparse_logistic", src, coef, params={"ids": 1})

    return inputs, {
        "idf_lr_scale": [sidf(0, idf), slr(4), scale],
        "scale_idf_lr": [scale, sidf(0, idf), slr(5)],
        "idf_idf": [sidf(0, idf), sidf(4, idf2)],
        "idf_idf_lr": [sidf(0, idf), sidf(4, idf2), slr(5)],
        "two_sparse_heads": [slr(0), sidf(0, idf), slr(6)],
    }[name]


@pytest.mark.parametrize("name", TABLE_SPARSE_CHAINS)
@pytest.mark.parametrize("d", (8, 1000, 1 << 22))
def test_table_sparse_ops_match_plain_version(cuda, name, d):
    """tf-idf values and the scaled column bit-equal (NaN for NaN), the sparse
    heads' prediction equal (their margin is the plain version's sequential
    fold) and rawPrediction within the sparse chain's envelope."""
    for rows in (1, 33, 4096):
        for cap in (1, 8, 64, 1024):
            where = f"{name} d={d} rows={rows} cap={cap}"
            inputs, ops = _table_sparse_case(name, rows, cap, d, cuda, seed=rows + cap)
            before = ROWLOCAL.launches
            got = rowlocal_chain(inputs, ops)
            want = rowlocal_chain_plain(inputs, ops)
            torch.cuda.synchronize()
            assert ROWLOCAL.launches == before + 1, where
            k = 0
            for op in ops:
                if op.op == "sparse_logistic":
                    assert torch.equal(got[k], want[k]), where
                    assert ulp_diff(got[k + 1].cpu().numpy(), want[k + 1].cpu().numpy()) \
                        <= ULP_ENVELOPE["sparse_idf_logistic"], where
                    k += 2
                    continue
                assert got[k].dtype == want[k].dtype == torch.float32, where
                assert _same_bits_or_nan(got[k], want[k]), where
                k += 1


MLP_AFTER_CHAINS = ("mlp_scale", "normalize_mlp_binarize", "mlp_kmeans", "mlp_mlp", "mlp_scale_mlp",
                    "sparse_idf_mlp")


def _mlp_after_case(name, rows, widths, device, seed=0):
    """``(inputs, ops)``: a table with MLP heads and ops after them."""
    x, mean, inv_std, layers, labels = _mlp_inputs(rows, widths, device, seed)
    d = widths[0]
    scale = RowLocalOp("scale", 0, mean, inv_std, {"with_mean": True, "with_std": True})
    norm = RowLocalOp("normalize", 0, params={"p": 2.0})

    def mlp(src):
        return RowLocalOp("mlp", src, labels, layers=layers)

    if name == "mlp_scale":
        return [x], [mlp(0), scale]
    if name == "normalize_mlp_binarize":  # binarize of the probabilities
        return [x], [norm, mlp(1), RowLocalOp("binarize", 3, params={"threshold": 0.3})]
    if name == "mlp_kmeans":
        C = torch.from_numpy(np.random.default_rng(seed).normal(size=(10, d)).astype(np.float32)).to(device)
        return [x], [mlp(0), RowLocalOp("kmeans", 0, C, params={"measure": "euclidean"})]
    if name == "mlp_mlp":
        return [x], [mlp(0), mlp(0)]
    if name == "mlp_scale_mlp":  # the second head reads the scaled column the epilogue of the first wrote
        return [x], [mlp(0), scale, mlp(3)]
    assert name == "sparse_idf_mlp"
    vals, ids, idf, _coef = _sparse_inputs(rows, 8, 1000, device, seed)
    return [x, vals, ids], [mlp(0), RowLocalOp("sparse_idf", 1, idf, params={"ids": 2})]


@pytest.mark.parametrize("rows", (1, 33, 4096))
@pytest.mark.parametrize("net", ("256-512-512-8", "8-16-3"))
@pytest.mark.parametrize("name", MLP_AFTER_CHAINS)
def test_mlp_kernel_runs_ops_after_its_heads(cuda, rows, net, name):
    """Each head's probabilities within ULP_ENVELOPE["scale_mlp"] and its
    prediction equal past a logit gap; the ops after it as the plain
    version's: a scale or sparse IDF bit-equal, a binarize of the
    probabilities equal outside BIN_MARGIN, a kmeans index equal past a
    distance gap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    where = f"{name} rows={rows} net={net}"
    inputs, ops = _mlp_after_case(name, rows, MLP_NETWORKS[net], cuda, seed=rows)
    before = ROWLOCAL_MLP.launches
    got = rowlocal_mlp(inputs, ops)
    want = rowlocal_mlp_plain(inputs, ops)
    torch.cuda.synchronize()
    assert ROWLOCAL_MLP.launches == before + 1, where
    plain = list(inputs) + list(want)
    k = 0
    for op in ops:
        if op.op == "mlp":
            assert ulp_diff(got[k + 1].cpu().numpy(), want[k + 1].cpu().numpy()) <= ULP_ENVELOPE["scale_mlp"], where
            sure = _top_two_gap(op.layers, plain[op.src]) > MLP_PREDICTION_MARGIN
            assert torch.equal(got[k][sure], want[k][sure]), where
            k += 2
            continue
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, where
        if op.op == "binarize":
            far = (plain[op.src] - op.params["threshold"]).abs() > BIN_MARGIN
            assert torch.equal(g[far], w[far]), where
        elif op.op == "kmeans":
            dec = torch.from_numpy(_kmeans_decided("euclidean", plain[op.src], op.a)).to(cuda)
            assert torch.equal(g[dec], w[dec]), where
        elif op.op == "normalize":
            assert ulp_diff(g.cpu().numpy(), w.cpu().numpy()) <= ULP_ENVELOPE["feature6"], where
        else:
            assert _same_bits_or_nan(g, w), where
        k += 1


def test_mlp_kernel_holds_four_heads_and_refuses_a_fifth(cuda):
    x, _mean, _inv, layers, labels = _mlp_inputs(64, [8, 16, 3], cuda)
    head = RowLocalOp("mlp", 0, labels, layers=layers)
    got = rowlocal_mlp([x], [head] * MLP_MAX_HEADS)
    want = rowlocal_mlp_plain([x], [head] * MLP_MAX_HEADS)
    torch.cuda.synchronize()
    for g, w in zip(got[1::2], want[1::2]):
        assert ulp_diff(g.cpu().numpy(), w.cpu().numpy()) <= ULP_ENVELOPE["scale_mlp"]
    before = ROWLOCAL_MLP.launches
    with pytest.raises(ValueError, match="MLP heads"):
        rowlocal_mlp([x], [head] * (MLP_MAX_HEADS + 1))
    with pytest.raises(ValueError, match="MLP heads"):
        rowlocal_chain([x], [head])  # the row-local kernel has none
    assert ROWLOCAL_MLP.launches == before


@pytest.mark.parametrize("measure", KMEANS_MEASURES)
@pytest.mark.parametrize("d,k", ((7, 2), (100, 10), (256, 64)))
def test_table_ops_read_the_kmeans_index(cuda, measure, d, k):
    """binarize on the int32 index is int32, impute on it float32: both
    equal to the plain version's wherever the index is (past a distance
    gap), and exactly equal to it where the kernel's index is fed in."""
    x, _mean, _inv, C = _kmeans_inputs(4096, d, k, cuda, seed=d + k)
    for rows in (1, 33, 4096):
        ops = [RowLocalOp("kmeans", 0, C, params={"measure": measure}),
               RowLocalOp("binarize", 1, params={"threshold": 0.5}),
               RowLocalOp("impute", 1, torch.tensor([7.5], device=cuda),
                          params={"missing_is_nan": False, "missing_value": 1.0, "column": 0}),
               RowLocalOp("binarize", 2, params={"threshold": 0.5})]
        got = rowlocal_chain([x[:rows]], ops)
        want = rowlocal_chain_plain([x[:rows]], ops)
        torch.cuda.synchronize()
        assert [t.dtype for t in got] == [t.dtype for t in want] == [torch.int32, torch.int32, torch.float32,
                                                                      torch.int32]
        dec = torch.from_numpy(_kmeans_decided(measure, x[:rows], C)).to(cuda)
        for g, w in zip(got, want):
            assert torch.equal(g[dec], w[dec])
        idx = got[0]
        assert torch.equal(got[1], (idx > 0).to(torch.int32))
        assert torch.equal(got[2], torch.where(idx == 1, 7.5, idx.float()))


def test_server_runs_the_mixed_pipeline_on_the_table_kernel(cuda):
    """IDF → LR on a sparse column and a StandardScaler on a dense one,
    served: one run ("sparse_idf", "sparse_logistic", "scale"), one table
    launch a hot batch, every output against the CPU per-stage path."""
    from flink_ml_tpu_torch.linalg.vectors import SparseVector
    from flink_ml_tpu_torch.models.feature.idf import IDFModel

    d = 1 << 20
    rng = np.random.default_rng(34)
    idf = IDFModel().set_input_col("tf").set_output_col("tfidf")
    idf.idf, idf.doc_freq, idf.num_docs = np.abs(rng.normal(size=d)) + 0.1, np.ones(d), np.asarray(9.0)
    lr = LogisticRegressionModelServable().set_features_col("tfidf")
    lr.coefficient = rng.normal(size=d) * 0.3
    sc = StandardScalerModelServable().set_input_col("dense").set_output_col("scaled").set_with_mean(True)
    sc.mean, sc.std = rng.normal(size=100), np.abs(rng.normal(size=100)) + 0.5
    pipe = PipelineModelServable([idf, lr, sc])

    def frame(n):
        tf = [SparseVector(d, np.sort(rng.choice(d, size=int(k), replace=False)), rng.random(int(k)) + 0.5)
              for k in rng.integers(1, 40, size=n)]
        return DataFrame(["tf", "dense"], None, [tf, rng.normal(size=(n, 100))])

    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    try:
        cfg = ServingConfig(max_batch_size=256, queue_capacity_rows=1024, fusion_mode="fast")
        with InferenceServer(pipe, name="gpu-mixed", serving_config=cfg, warmup_template=frame(1)) as srv:
            plan = pipe._fastpath_plan
            (segment,) = plan.segments
            assert [s.fusion_op for s in segment.specs] == ["sparse_idf", "sparse_logistic", "scale"]
            ROWLOCAL.reset_launches()
            req = frame(200)
            resp = srv.predict(req).dataframe
            assert ROWLOCAL.launches == 1
    finally:
        config.unset(Options.FUSION_MEGAKERNEL_MIN_SCORE)
    ref = pipe.transform(req, device="cpu")
    np.testing.assert_array_equal(resp.column("scaled"), ref.column("scaled"))
    np.testing.assert_array_equal(resp.column("prediction"), ref.column("prediction"))
    assert ulp_diff(resp.column("rawPrediction"), ref.column("rawPrediction")) <= ULP_ENVELOPE["sparse_idf_logistic"]
    for r, w in zip(resp.column("tfidf"), ref.column("tfidf")):
        np.testing.assert_array_equal(r.indices, w.indices)
        np.testing.assert_array_equal(r.values, w.values)
