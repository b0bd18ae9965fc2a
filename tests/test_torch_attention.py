"""The port's attention slice against the JAX package on the CPU: the plain
fold against ``reference_fold`` and the Pallas fold in interpret mode, ring
attention on one shard against ``ring_attention_sharded`` and the flash ring
program, SelfAttentionClassifierModel.transform against the JAX transform
and ``_predict_step`` with the Pallas fold, save/load both ways, and the
``fused_fold`` wrapper's device rules and what it refuses under grad (its
gradients: ``test_torch_attention_train.py``). Tests of the CUDA kernel
itself are in ``test_torch_gpu.py``.

The JAX side runs on a one-device ``MeshContext(n_data=1, n_model=1)``, so
its ring is one shard too: one fold at positions 0, as the port's.

Tolerances, each with its reason:
- the fold's ``m``: rtol 1e-6 (atol 1e-6 for values near 0) — the scores'
  dot products sum in another order in the two frameworks;
- ``l`` and ``acc``: rtol 1e-5, with an atol of 1e-5 times the tensor's
  largest magnitude — exp of those scores, summed over up to 256 keys, and
  ``acc``'s signed sums can cancel to near 0;
- rows with no attendable key in the block: exact, as the JAX fold keeps
  them (finite ``m`` in → ``m``, ``l``, ``acc`` unchanged bit for bit;
  ``m`` -inf in → -inf, 0, 0); no NaN anywhere;
- ring attention: rtol 2e-5 / atol 2e-6, the JAX package's own bound for
  its ring against dense attention (``tests/test_ring_attention.py``);
- the classifier's probabilities: atol 1e-5 (float32 logits of a 256-token
  pool, softmax); predictions equal where the float64 top-two logit gap
  exceeds 1e-4.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.models.classification.attention_classifier import (
    SelfAttentionClassifier as JSelfAttentionClassifier,
    SelfAttentionClassifierModel as JSelfAttentionClassifierModel,
    _init_params as jinit_params,
    _predict_step as jpredict_step,
)
from flink_ml_tpu.parallel import flash as jflash
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.parallel.ring import (
    _sharded_program as jsharded_program,
    ring_attention_sharded as jring_attention_sharded,
)
from flink_ml_tpu.utils import read_write as jrw

from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.models.classification.attention_classifier import (
    SelfAttentionClassifierModel,
    _forward,
    _init_params,
)
from flink_ml_tpu_torch.parallel import (
    FLASH_FOLD,
    MAX_HEAD_DIM,
    flash_available,
    fold_smem_bytes,
    fused_fold,
    reference_fold,
    ring_attention,
    ring_attention_sharded,
)
from flink_ml_tpu_torch.servable import load_servable
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

JAX_MODEL = "flink_ml_tpu.models.classification.attention_classifier.SelfAttentionClassifierModel"
MARGIN = 1e-4
PROB_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

B, H, TQ, TK, D = 1, 2, 40, 56, 8
POSITIONS = {
    "aligned": (0, 0),
    "kv_before": (TK + 8, 0),  # the queries lie after the whole block
    "kv_after": (0, TQ + 8),  # the block lies after every query
    "straddle": (16, 0),
}
N_VALID = ("none", "inside", "before_block")
STATES = ("first", "carried", "mixed")


def _fold_inputs(seed, Tq=TQ, Tk=TK, d=D, state="first", heads=H):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, heads, Tq, d)).astype(np.float32)
    k = rng.standard_normal((B, heads, Tk, d)).astype(np.float32)
    v = rng.standard_normal((B, heads, Tk, d)).astype(np.float32)
    if state == "first":
        m = np.full((B, heads, Tq), -np.inf, np.float32)
        l = np.zeros((B, heads, Tq), np.float32)
        acc = np.zeros((B, heads, Tq, d), np.float32)
    else:
        m = rng.standard_normal((B, heads, Tq)).astype(np.float32)
        l = (np.abs(rng.standard_normal((B, heads, Tq))) + 1.0).astype(np.float32)
        acc = rng.standard_normal((B, heads, Tq, d)).astype(np.float32)
        if state == "mixed":  # every third row has seen nothing yet
            m[..., ::3], l[..., ::3], acc[..., ::3, :] = -np.inf, 0.0, 0.0
    return q, k, v, m, l, acc


def _n_valid(case, k_pos0, Tk=TK):
    return {"none": None, "inside": k_pos0 + Tk // 2, "before_block": k_pos0}[case]


def _attendable_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid):
    q_pos = q_pos0 + np.arange(Tq)[:, None]
    k_pos = k_pos0 + np.arange(Tk)[None, :]
    keep = np.ones((Tq, Tk), bool)
    if causal:
        keep &= q_pos >= k_pos
    if n_valid is not None:
        keep &= k_pos < n_valid
    return keep.any(axis=1)


def _check_fold(got, want, inputs, attendable):
    """``got`` against ``want`` at the module's tolerances; the rows with
    no attendable key exactly as the JAX fold leaves them."""
    m_in, l_in, acc_in = inputs
    gm, gl, ga = (np.asarray(x) for x in got)
    wm, wl, wa = (np.asarray(x) for x in want)
    for g in (gm, gl, ga):
        assert not np.isnan(g).any()
    np.testing.assert_array_equal(np.isneginf(gm), np.isneginf(wm))
    fin = np.isfinite(wm)
    np.testing.assert_allclose(gm[fin], wm[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(wl).max()))
    np.testing.assert_allclose(ga, wa, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(wa).max()))
    idle = ~attendable  # rows with nothing attendable in this block
    seen = np.isfinite(m_in)
    kept, fresh = seen & idle[None, None, :], ~seen & idle[None, None, :]
    for out in ((gm, gl, ga), (wm, wl, wa)):
        om, ol, oa = out
        np.testing.assert_array_equal(om[kept], m_in[kept])
        np.testing.assert_array_equal(ol[kept], l_in[kept])
        np.testing.assert_array_equal(oa[kept], acc_in[kept])
        assert np.all(np.isneginf(om[fresh])) and np.all(ol[fresh] == 0.0) and np.all(oa[fresh] == 0.0)
    return int(kept.sum()), int(fresh.sum())


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("positions", sorted(POSITIONS))
@pytest.mark.parametrize("n_valid_case", N_VALID)
@pytest.mark.parametrize("causal", (False, True))
def test_reference_fold_matches_jax(causal, n_valid_case, positions, state):
    q_pos0, k_pos0 = POSITIONS[positions]
    n_valid = _n_valid(n_valid_case, k_pos0)
    inputs = _fold_inputs(7, state=state)
    scale = 1.0 / np.sqrt(D)
    got = reference_fold(*(_t(a) for a in inputs), q_pos0, k_pos0, causal, n_valid, scale)
    want = jflash.reference_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
    attendable = _attendable_rows(TQ, TK, q_pos0, k_pos0, causal, n_valid)
    kept, fresh = _check_fold(got, want, inputs[3:], attendable)
    if causal and positions == "kv_after" and state == "mixed":
        assert kept > 0 and fresh > 0  # both exact edges are reached
    # the wrapper on CPU tensors is the plain version, bit for bit
    wrapped = fused_fold(*(_t(a) for a in inputs), q_pos0, k_pos0, causal, n_valid, scale)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


# (causal, n_valid case, positions, state): the Pallas fold needs Tq a
# multiple of its 256-row tile, and interpret mode costs about a second each
PALLAS_CASES = [
    (True, "none", "aligned", "first"),
    (True, "none", "kv_after", "first"),  # every row masked: m stays -inf
    (False, "inside", "aligned", "carried"),
    (True, "inside", "kv_before", "mixed"),
    (False, "before_block", "aligned", "mixed"),
    (True, "none", "straddle", "carried"),
]


@pytest.mark.parametrize("causal,n_valid_case,positions,state", PALLAS_CASES)
def test_reference_fold_matches_the_pallas_fold_in_interpret_mode(causal, n_valid_case, positions, state):
    Tq, Tk = 256, 200
    q_pos0, k_pos0 = {"aligned": (0, 0), "kv_after": (0, Tq + 8), "kv_before": (Tk + 8, 0),
                      "straddle": (16, 0)}[positions]
    n_valid = _n_valid(n_valid_case, k_pos0, Tk)
    inputs = _fold_inputs(11, Tq=Tq, Tk=Tk, state=state)
    scale = 1.0 / np.sqrt(D)
    got = reference_fold(*(_t(a) for a in inputs), q_pos0, k_pos0, causal, n_valid, scale)
    want = jflash._fold_pallas(*(jnp.asarray(a) for a in inputs), q_pos0, k_pos0, causal, n_valid,
                               scale, interpret=True)
    kept, fresh = _check_fold(got, want, inputs[3:], _attendable_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid))
    if positions == "kv_after":
        assert fresh == B * H * Tq and np.all(np.isneginf(got[0].numpy()))


# ---------------------------------------------------------------------------
# the wrapper: plain version for CPU tensors, kernel or raise otherwise
# ---------------------------------------------------------------------------


def test_fused_fold_on_cpu_runs_the_plain_version_without_counting():
    inputs = [_t(a) for a in _fold_inputs(3, state="carried")]
    before = FLASH_FOLD.launches
    got = fused_fold(*inputs, 0, 0, True, 30, 0.25)
    want = reference_fold(*inputs, 0, 0, True, 30, 0.25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert FLASH_FOLD.launches == before  # the count is of kernel launches only


def test_fused_fold_refuses_inputs_that_require_grad():
    """Under grad the fold is an ``autograd.Function`` (its gradients are
    held in ``test_torch_attention_train.py``); what it refuses: a second
    derivative (its backward is ``once_differentiable``), and on the card
    the kernels' dtype and head-dim limits, checked before any launch."""
    import flink_ml_tpu_torch.parallel.flash as flash_mod

    inputs = [_t(a) for a in _fold_inputs(3, state="carried")]
    inputs[0].requires_grad_(True)
    m, l, acc = fused_fold(*inputs, 0, 0, False, None, 0.25)
    (dq,) = torch.autograd.grad(torch.sum((acc / l[..., None]) ** 2), inputs[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()
    # no graph is recorded under no_grad
    with torch.no_grad():
        assert all(t.grad_fn is None for t in fused_fold(*inputs, 0, 0, False, None, 0.25))
    # the checks a CUDA launch makes, forward and backward, whatever requires grad
    before = (FLASH_FOLD.launches, flash_mod.FLASH_FOLD_BWD_DQ.launches, flash_mod.FLASH_FOLD_BWD_DKV.launches)
    rows, mats = {"m": inputs[3], "l": inputs[4]}, {"acc": inputs[5]}
    with pytest.raises(TypeError, match="float32"):
        flash_mod._kernel_shapes("fold", inputs[0].double(), *inputs[1:3], rows, mats)
    wide = [torch.zeros((1, 1, 4, MAX_HEAD_DIM + 1), requires_grad=True) for _ in range(3)]
    with pytest.raises(ValueError, match="head dims"):
        flash_mod._kernel_shapes("fold", *wide)
    flash_mod._kernel_shapes("fold", *inputs[:3], rows, mats)  # what the kernels take passes
    assert (FLASH_FOLD.launches, flash_mod.FLASH_FOLD_BWD_DQ.launches,
            flash_mod.FLASH_FOLD_BWD_DKV.launches) == before


def test_fused_fold_raises_for_tensors_it_has_no_path_for():
    x = torch.empty((1, 1, 4, 8), device="meta")
    s = torch.empty((1, 1, 4), device="meta")
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        fused_fold(x, x, x, s, s, x, 0, 0, False, None, 0.25)


def test_fold_launch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = FLASH_FOLD.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLASH_FOLD.launch(*([None] * 9 + [1, 1, 1, 8, 0, 0, 0, 0, 0, 0.25, None]))
    assert FLASH_FOLD.launches == before
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ring_attention_sharded(np.zeros((1, 4, 1, 8), np.float32), np.zeros((1, 4, 1, 8), np.float32),
                               np.zeros((1, 4, 1, 8), np.float32), device="cuda")


def test_the_kernel_is_registered_with_the_pallas_site_it_replaces():
    assert FLASH_FOLD in native.KERNELS
    assert FLASH_FOLD.replaces == "flink_ml_tpu/parallel/flash.py:127"
    assert FLASH_FOLD.source_path == "flink_ml_tpu_torch/csrc/flash_fold.cu"
    assert (native.CSRC_DIR / FLASH_FOLD.source).is_file()
    # the replaced line is the Pallas fold itself
    line = (native.PACKAGE_DIR.parent / "flink_ml_tpu/parallel/flash.py").read_text().splitlines()[126]
    assert line.startswith("def _fold_pallas(")


def test_flash_available_is_rederived_for_shared_memory():
    cuda = torch.device("cuda", 0)  # a device object: nothing touches a card
    for T in (1, 63, 255, 8192, 16384, 1 << 20):  # the tiles stream: no length limit
        for d in (1, 8, 16, 32, 64, 100, 128, 256):
            assert flash_available(T, d, cuda)
        assert not flash_available(T, MAX_HEAD_DIM + 1, cuda)
        assert not flash_available(T, 128, "cpu")
    # Q hi/lo, two stages of K and Vᵀ hi/lo and the staging buffer of a
    # key tile (32 keys, 8 past a padded head dim of 128), float32, and nine
    # mbarriers, under a Hopper block's 232,448 bytes; head dims pad to 32 at least
    assert fold_smem_bytes(128) == 229_448 and fold_smem_bytes(256) == 213_064
    assert fold_smem_bytes(8) == fold_smem_bytes(32) == 4 * (2 * 64 * 32 + 2 * 4 * 32 * 32 + 2 * 32 * 32) + 8 * 9
    assert fold_smem_bytes(100) == fold_smem_bytes(128)
    assert max(fold_smem_bytes(d) for d in range(1, MAX_HEAD_DIM + 1)) <= 232_448
    # the JAX gate's TPU limits do not carry over: a ragged length runs
    assert not jflash.flash_available(8192 + 7, 128) and flash_available(8192 + 7, 128, cuda)


def test_the_route_on_the_card_is_the_kernel_or_an_error(monkeypatch):
    import flink_ml_tpu_torch.parallel.flash as flash_mod
    import flink_ml_tpu_torch.parallel.ring as ring_mod

    # ring attention, and the model through it, folds only through
    # fused_fold: there is no second route that could run the plain fold on
    # the card
    assert not hasattr(ring_mod, "reference_fold")
    calls = []

    def recorded(*args):
        calls.append(args[0].device)
        return flash_mod.fused_fold(*args)

    monkeypatch.setattr(ring_mod, "fused_fold", recorded)
    q, k, v = _qkv(22, 1, 24, 2, 8)
    ring_attention(*(_t(x) for x in (q, k, v)), causal=True)
    rng = np.random.default_rng(23)
    model = SelfAttentionClassifierModel().set_embedding_dim(16).set_num_heads(2)
    model.params = _init_params(rng, 30, 16, 3)
    model.labels = np.array([0.0, 1.0, 2.0])
    model.transform(DataFrame.from_dict({"features": rng.integers(0, 30, (2, 24)).astype(np.float64)}),
                    device="cpu")
    assert calls == [torch.device("cpu")] * 2

    # off the CPU, fused_fold never reaches the plain fold: it launches or raises
    def plain(*args):
        raise AssertionError("the plain fold was called off the CPU")

    monkeypatch.setattr(flash_mod, "reference_fold", plain)
    x = torch.empty((1, 2, 24, 8), device="meta")
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        ring_attention(x, x, x)
    # the kernel's one gate: the head dims its templates hold, on a CUDA device
    cuda = torch.device("cuda", 0)
    assert flash_available(8192, 128, cuda) and flash_available(8000, 8, cuda)
    assert not flash_available(64, 512, cuda) and not flash_available(8192, 128, "cpu")


# ---------------------------------------------------------------------------
# ring attention on one shard
# ---------------------------------------------------------------------------


def _dense_attention(q, k, v, causal, n_valid=None):
    """Float64 dense attention, [B, T, H, D]."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    T, d = q.shape[1], q.shape[3]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    keep = np.ones((T, T), bool)
    if causal:
        keep &= np.tril(np.ones((T, T), bool))
    if n_valid is not None:
        keep &= (np.arange(T) < n_valid)[None, :]
    s = np.where(keep[None, None], s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _qkv(seed, b, T, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, T, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n_valid", (None, 41))
@pytest.mark.parametrize("causal", (False, True))
def test_ring_attention_matches_jax_ring_attention_sharded(one_device_mesh, causal, n_valid):
    q, k, v = _qkv(20, 2, 48, 2, 8)
    got = ring_attention_sharded(q, k, v, causal=causal, n_valid=n_valid, device="cpu").numpy()
    want = np.asarray(jring_attention_sharded(q, k, v, causal=causal, ctx=one_device_mesh, n_valid=n_valid))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, _dense_attention(q, k, v, causal, n_valid), rtol=2e-5, atol=2e-6)
    # ring_attention on CPU tensors is the plain fold, bit for bit
    B_, T_, H_, D_ = q.shape
    q_t, k_t, v_t = (_t(x).transpose(1, 2).contiguous() for x in (q, k, v))
    m0, l0 = torch.full((B_, H_, T_), -torch.inf), torch.zeros((B_, H_, T_))
    _, l, acc = reference_fold(q_t, k_t, v_t, m0, l0, torch.zeros((B_, H_, T_, D_)), 0, 0, causal, n_valid,
                               1.0 / np.sqrt(D_))
    plain = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    assert torch.equal(plain, torch.from_numpy(got))


@pytest.mark.parametrize("n_valid", (None, 200))
@pytest.mark.parametrize("causal", (False, True))
def test_ring_attention_matches_the_jax_flash_ring_in_interpret_mode(one_device_mesh, causal, n_valid):
    q, k, v = _qkv(21, 1, 256, 2, 8)  # one 256-row Pallas Q tile
    got = ring_attention_sharded(q, k, v, causal=causal, n_valid=n_valid, device="cpu").numpy()
    program = jsharded_program(one_device_mesh.mesh, causal, n_valid is not None, True)
    with pltpu.force_tpu_interpret_mode():
        if n_valid is None:
            want = np.asarray(program(q, k, v))
        else:
            want = np.asarray(program(q, k, v, jnp.asarray(n_valid, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# the classifier: JAX fit, port transform
# ---------------------------------------------------------------------------

EMB, HEADS, SEQ, DOCS = 16, 2, 256, 10


def _documents(n=DOCS, T=SEQ, seed=0):
    """Sequences whose label is carried by which signal token dominates
    (``tests/test_attention_classifier.py``'s construction), labels 1 / 3."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 4, size=(n, T))
    y = np.where(rng.random(n) > 0.5, 3.0, 1.0)
    tok = np.where(rng.random((n, T)) < 0.3, np.where(y[:, None] == 3.0, 7, 5), tok)
    return tok.astype(np.float64), y


@pytest.fixture(scope="module")
def jax_model():
    tok, y = _documents()
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        model = (
            JSelfAttentionClassifier()
            .set_embedding_dim(EMB)
            .set_num_heads(HEADS)
            .set_max_iter(3)
            .set_learning_rate(0.05)
            .set_global_batch_size(DOCS)
            .set_seed(3)
            .fit(JDataFrame.from_dict({"features": tok, "label": y}))
        )
    return model


def _port_from_model_data(jmodel):
    model = SelfAttentionClassifierModel()
    model.load_param_map_from_json(jmodel.param_map_to_json())
    (md,) = jmodel.get_model_data()
    return model.set_model_data(md)


def _float64_logits(params, tok, n_heads):
    p64 = {name: torch.from_numpy(np.asarray(a, np.float64)) for name, a in params.items()}
    return _forward(p64, torch.from_numpy(np.asarray(tok, np.int64)), tok.shape[1], n_heads).numpy()


def _check_transform(out, want_probs, want_pred, logits64):
    probs = np.asarray(out.column("rawPrediction"))
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=PROB_ATOL)
    top2 = np.sort(logits64, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > MARGIN
    assert decided.sum() >= len(decided) - 1
    np.testing.assert_array_equal(np.asarray(out.column("prediction"))[decided], np.asarray(want_pred)[decided])


def test_transform_matches_jax_with_model_data(one_device_mesh, jax_model):
    tok, _ = _documents(8, seed=5)
    model = _port_from_model_data(jax_model)
    assert json.dumps(model.param_map_to_json(), sort_keys=True) == json.dumps(
        jax_model.param_map_to_json(), sort_keys=True)
    out = model.transform(DataFrame.from_dict({"features": tok}), device="cpu")
    ref = jax_model.transform(JDataFrame.from_dict({"features": tok}))
    _check_transform(out, np.asarray(ref.column("rawPrediction")), ref.column("prediction"),
                     _float64_logits(model.params, tok, HEADS))
    assert set(np.unique(out.column("prediction"))) <= {1.0, 3.0}


def test_transform_matches_jax_predict_step_with_the_pallas_fold(one_device_mesh, jax_model):
    tok, _ = _documents(4, seed=6)
    model = _port_from_model_data(jax_model)
    out = model.transform(DataFrame.from_dict({"features": tok}), device="cpu")
    params = {name: jnp.asarray(a) for name, a in jax_model.params.items()}
    with pltpu.force_tpu_interpret_mode():
        logits, probs = jpredict_step(one_device_mesh.mesh, HEADS, True)(
            params, jnp.asarray(tok.astype(np.int32)), jnp.asarray(SEQ, jnp.int32))
    pred = jax_model.labels[np.asarray(jnp.argmax(logits, axis=-1))]
    _check_transform(out, np.asarray(probs), pred, _float64_logits(model.params, tok, HEADS))


def test_transform_of_a_ragged_padded_length_matches_jax(one_device_mesh, jax_model):
    """A length that is no multiple of any tile: 200 tokens."""
    tok, _ = _documents(5, T=200, seed=7)
    model = _port_from_model_data(jax_model)
    out = model.transform(DataFrame.from_dict({"features": tok}), device="cpu")
    ref = jax_model.transform(JDataFrame.from_dict({"features": tok}))
    _check_transform(out, np.asarray(ref.column("rawPrediction")), ref.column("prediction"),
                     _float64_logits(model.params, tok, HEADS))


def test_jax_saved_model_loads_in_the_port(one_device_mesh, jax_model, tmp_path):
    path = str(tmp_path / "attn")
    jax_model.save(path)
    model = SelfAttentionClassifierModel.load(path)
    staged = rw.load_stage(path)
    assert type(staged) is SelfAttentionClassifierModel
    assert sorted(model.params) == sorted(jax_model.params)
    for name, a in jax_model.params.items():
        np.testing.assert_array_equal(model.params[name], a)
        np.testing.assert_array_equal(staged.params[name], a)
    np.testing.assert_array_equal(model.labels, jax_model.labels)
    tok, _ = _documents(6, seed=8)
    out = model.transform(DataFrame.from_dict({"features": tok}), device="cpu")
    via_data = _port_from_model_data(jax_model).transform(DataFrame.from_dict({"features": tok}), device="cpu")
    np.testing.assert_array_equal(np.asarray(out.column("rawPrediction")),
                                  np.asarray(via_data.column("rawPrediction")))
    ref = jax_model.transform(JDataFrame.from_dict({"features": tok}))
    _check_transform(out, np.asarray(ref.column("rawPrediction")), ref.column("prediction"),
                     _float64_logits(model.params, tok, HEADS))
    # the JAX package serves the model through no servable; neither does the port
    with pytest.raises(ValueError, match="no port class loads"):
        load_servable(path)
    with pytest.raises(ValueError, match="no port class loads"):
        rw.resolve_class(JAX_MODEL)
    assert rw.resolve_class(JAX_MODEL, stage=True) is SelfAttentionClassifierModel


def test_port_saved_model_loads_in_the_jax_package(one_device_mesh, jax_model, tmp_path):
    """The port writes the JAX twin's class name: the JAX ``load`` and
    ``load_stage`` read a port-written directory."""
    model = _port_from_model_data(jax_model)
    path = str(tmp_path / "attn")
    model.save(path)
    jmodel = JSelfAttentionClassifierModel.load(path)
    assert type(jrw.load_stage(path)) is JSelfAttentionClassifierModel
    for name, a in model.params.items():
        np.testing.assert_array_equal(np.asarray(jmodel.params[name]), a)
    assert json.dumps(jmodel.param_map_to_json(), sort_keys=True) == json.dumps(
        model.param_map_to_json(), sort_keys=True)
    tok, _ = _documents(6, seed=9)
    out = model.transform(DataFrame.from_dict({"features": tok}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": tok}))
    _check_transform(out, np.asarray(ref.column("rawPrediction")), ref.column("prediction"),
                     _float64_logits(model.params, tok, HEADS))
    again = SelfAttentionClassifierModel.load(path)
    for name, a in model.params.items():
        np.testing.assert_array_equal(again.params[name], a)


def test_init_params_and_param_defaults_match_jax():
    ours = _init_params(np.random.default_rng(5), 64, 16, 3)
    theirs = jinit_params(np.random.default_rng(5), 64, 16, 3)
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert ours[name].dtype == np.float32
        np.testing.assert_array_equal(ours[name], theirs[name])
    assert json.dumps(SelfAttentionClassifierModel().param_map_to_json(), sort_keys=True) == json.dumps(
        JSelfAttentionClassifierModel().param_map_to_json(), sort_keys=True)
    model = SelfAttentionClassifierModel()
    assert (model.get_embedding_dim(), model.get_num_heads(), model.get_vocab_size()) == (32, 4, 0)


def test_transform_rejects_out_of_range_token_ids(one_device_mesh, jax_model):
    model = _port_from_model_data(jax_model)
    tok, _ = _documents(2, T=16, seed=10)
    for bad_id in (99, -1):
        bad = tok.copy()
        bad[0, 0] = bad_id
        with pytest.raises(ValueError, match="token ids"):
            model.transform(DataFrame.from_dict({"features": bad}), device="cpu")
        with pytest.raises(ValueError, match="token ids"):
            jax_model.transform(JDataFrame.from_dict({"features": bad}))


def test_transform_without_a_device_runs_on_the_card_or_raises(jax_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = _port_from_model_data(jax_model)
    tok, _ = _documents(2, T=16, seed=11)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.transform(DataFrame.from_dict({"features": tok}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.transform(DataFrame.from_dict({"features": tok}), device="cuda")
