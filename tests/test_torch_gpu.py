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
# the scale → mlp serving megakernel
# ---------------------------------------------------------------------------

from flink_ml_tpu_torch.servable import MLPClassifierModelServable  # noqa: E402
from flink_ml_tpu_torch.servable.megakernels import (  # noqa: E402
    MLP_MAX_CLASSES,
    MLP_MAX_LAYERS,
    MLP_MAX_WIDTH,
    SCALE_MLP,
    scale_mlp,
    scale_mlp_plain,
)

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
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in full float32
    x, mean, inv_std, layers, labels = _mlp_inputs(rows, MLP_NETWORKS[net], cuda, seed=rows)
    before = SCALE_MLP.launches
    kw = dict(with_mean=with_mean, with_std=with_std)
    scaled, pred, probs = scale_mlp(x, mean, inv_std, layers, labels, write_scaled=write_scaled, **kw)
    p_scaled, p_pred, p_probs = scale_mlp_plain(x, mean, inv_std, layers, labels, **kw)
    torch.cuda.synchronize()
    assert SCALE_MLP.launches == before + 1
    if write_scaled:
        assert torch.equal(scaled, p_scaled)  # bit-equal: no contraction, same roundings
    else:
        assert scaled is None
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
    kw = dict(with_mean=False, with_std=False)
    _, pred, probs = scale_mlp(x, None, None, layers, labels, write_scaled=False, **kw)
    _, p_pred, p_probs = scale_mlp_plain(x, None, None, layers, labels, **kw)
    assert pred.tolist() == p_pred.tolist() == [20.0, 10.0, 10.0]
    assert torch.isnan(probs[1]).all() and torch.isnan(p_probs[1]).all()


def test_mlp_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, mean, inv_std, layers, labels = _mlp_inputs(8, [16, 32, 3], cuda)
    before = SCALE_MLP.launches
    kw = dict(with_mean=True, with_std=True, write_scaled=True)
    with pytest.raises(TypeError, match="float32"):
        scale_mlp(x.double(), mean, inv_std, layers, labels, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        scale_mlp(x, mean, inv_std, [(layers[0][0].t().contiguous().t(), layers[0][1]), layers[1]],
                  labels, **kw)
    with pytest.raises(ValueError, match="shape"):
        scale_mlp(x, mean, inv_std, layers, labels[:-1], **kw)
    with pytest.raises(ValueError, match="expected"):
        scale_mlp(x, mean.cpu(), inv_std, layers, labels, **kw)
    wide = _mlp_inputs(2, [MLP_MAX_WIDTH + 1, 4, 3], cuda)
    with pytest.raises(ValueError, match="holds"):
        scale_mlp(*wide[:3], wide[3], wide[4], **kw)
    many = _mlp_inputs(2, [8] + [8] * MLP_MAX_LAYERS + [3], cuda)
    with pytest.raises(ValueError, match="holds"):
        scale_mlp(*many[:3], many[3], many[4], **kw)
    classes = _mlp_inputs(2, [8, 16, MLP_MAX_CLASSES + 1], cuda)
    with pytest.raises(ValueError, match="holds"):
        scale_mlp(*classes[:3], classes[3], classes[4], **kw)
    empty = scale_mlp(x[:0], mean, inv_std, layers, labels, **kw)
    assert [t.shape for t in empty] == [(0, 16), (0,), (0, 3)]
    assert SCALE_MLP.launches == before


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
        SCALE_MLP.reset_launches()
        big = DataFrame.from_dict({"features": rng.normal(size=(1500, d))})
        one = DataFrame.from_dict({"features": rng.normal(size=(1, d))})
        r_big, r_one = srv.predict(big), srv.predict(one)
        assert (r_big.bucket, r_one.bucket) == (2048, 1)
        assert SCALE_MLP.launches == 1  # bucket 2048 is hot, bucket 1 is not
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
