"""The port's attention training slice against the JAX package on the CPU:
the fold's plain VJP (``reference_fold_bwd``) against the JAX
``reference_fold_bwd``, ``jax.vjp`` of ``reference_fold`` and the Pallas
backward in interpret mode; ``torch.autograd`` through the plain fold
against the plain VJP; ``fused_fold`` as an ``autograd.Function`` on CPU
tensors; ``SelfAttentionClassifier.fit`` against the JAX fit and the JAX
flash training step; save/load both ways; the Estimator's validation and
the re-derived ``flash_train_available``. Tests of the backward kernels
themselves are in ``test_torch_gpu.py``.

The JAX side runs on a one-device ``MeshContext(n_data=1, n_model=1)``, so
its ring is one shard: one fold at positions 0, as the port's.

Tolerances, each with its reason:
- the fold's VJP: rtol 2e-5 / atol 2e-5, the JAX package's own bound for
  its hand-derived VJP against AD (``tests/test_ring_attention.py``); the
  products and row sums run in another order in the two frameworks. In
  the ties case every score is exact (q and k on a 1/8 grid, scale 1/8),
  so both frameworks find the same row maxima and ties;
- ``fused_fold``'s gradients on CPU tensors: bit-equal to the plain VJP
  (the Function's backward is that function);
- the fit's step-1 adam moment (0.1 · the gradient, in float32): rtol 1e-4
  with an atol of 1e-5 times the largest moment of any parameter — float32
  gradients of a 256-token forward and backward summed in two orders; a
  gradient that sums terms of that scale to near 0 (the bias, with the
  classes near balanced, sums to 4e-5 against a largest gradient of 0.1)
  keeps their float32 error;
- the loss of every step: rtol 1e-5 (float32 softmax cross-entropy of
  those logits);
- the parameters after each adam step of lr 1e-2: atol 1e-5. Adam divides
  each moment by its own root-mean-square, so a parameter moves by ~lr a
  step whatever its gradient's size, and a float32 difference in the
  gradient moves it by ~lr times that relative difference: 1e-2 × 1e-4 =
  1e-6, with a margin of 10. Where a gradient element is within 100 · eps
  (1e-6) of 0 at some step, adam's update ``g / (|g| + eps)`` is itself
  float32 noise (an embedding element with |g| = 1.06e-8 in JAX and
  1.08e-8 here moves by 3.4e-5 apart at step 1): those elements, 45 of
  1858 here (most in wq and wk, whose gradients are small while attention
  is near uniform) and found from the JAX run's own first moments, are
  held within lr per step, the most adam moves them, and must stay under
  5% of the parameters; the rest agree within 1.3e-6;
- the fitted model's probabilities: atol 1e-5, as ``test_torch_attention.py``
  holds the transform.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.models.classification.attention_classifier import (
    SelfAttentionClassifier as JSelfAttentionClassifier,
    SelfAttentionClassifierModel as JSelfAttentionClassifierModel,
    _init_params as jinit_params,
    _train_step as jtrain_step,
)
from flink_ml_tpu.parallel import flash as jflash
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.utils import read_write as jrw

from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.models.classification import attention_classifier as attn
from flink_ml_tpu_torch.models.classification.attention_classifier import (
    SelfAttentionClassifier,
    SelfAttentionClassifierModel,
)
from flink_ml_tpu_torch.parallel import (
    FLASH_FOLD,
    FLASH_FOLD_BWD_DKV,
    FLASH_FOLD_BWD_DQ,
    MAX_HEAD_DIM,
    flash_train_available,
    fold_bwd_dkv,
    fold_bwd_dq,
    fold_bwd_smem_bytes,
    fused_fold,
    fused_fold_bwd,
    reference_fold,
    reference_fold_bwd,
)
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

JAX_ESTIMATOR = "flink_ml_tpu.models.classification.attention_classifier.SelfAttentionClassifier"
VJP_TOL = 2e-5
GRADS = ("dq", "dk", "dv", "dm", "dl", "dacc")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


# ---------------------------------------------------------------------------
# the fold's VJP
# ---------------------------------------------------------------------------

B, H, T = 1, 2, 256  # the JAX Pallas backward tiles Tq and Tk by 256
CASES = ("first-fold", "mid-fold", "masked", "fully-masked", "plain", "ties")


def _vjp_case(case, d, seed=7):
    """Inputs of ``tests/test_ring_attention.py``'s five cases, plus
    ``ties``: q and k on a 1/8 grid with every key duplicated once (keys 2i
    and 2i + 1), scale 1/8, so every score is exact and each row's max has
    at least two keys; n_valid 201 masks key 201, the twin of key 200; the
    carried m equals the block max on every third row, lies above it on the
    next and below it on the third. Returns (tensors as numpy, q_pos0,
    k_pos0, causal, n_valid, scale)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    causal, nv, qp, kp = {
        "first-fold": (True, None, 0, 0),
        "mid-fold": (True, None, 512, 256),
        "masked": (False, 300, 0, 256),  # keys 256-299 valid, the rest masked
        "fully-masked": (False, 10, 0, 128),  # rows with nothing attendable
        "plain": (False, None, 0, 0),
        "ties": (False, 201, 0, 0),
    }[case]
    scale = 1.0 / np.sqrt(d)
    q, kb, vb = r(B, H, T, d), r(B, H, T, d), r(B, H, T, d)
    if case == "ties":
        scale = 0.125
        q = (rng.integers(-8, 9, size=(B, H, T, d)) / 8).astype(np.float32)
        kb = (rng.integers(-8, 9, size=(B, H, T, d)) / 8).astype(np.float32)
        kb[:, :, 1::2] = kb[:, :, 0::2]
    if case in ("first-fold", "fully-masked"):
        m = np.full((B, H, T), -np.inf, np.float32)
        l = np.zeros((B, H, T), np.float32)
        acc = np.zeros((B, H, T, d), np.float32)
    else:
        m, l, acc = r(B, H, T) * 0.5, np.abs(r(B, H, T)) + 0.5, r(B, H, T, d)
    if case == "ties":
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kb.astype(np.float64)) * scale
        block_max = s[..., :nv].max(axis=-1).astype(np.float32)  # exact
        m = block_max + np.float32(0.25) * np.array([0, 1, -1], np.float32)[np.arange(T) % 3]
    dm, dl, dacc = r(B, H, T), r(B, H, T), r(B, H, T, d)
    return (q, kb, vb, m, l, acc, dm, dl, dacc), qp, kp, causal, nv, scale


def _assert_grads(got, want, where, rtol=VJP_TOL, atol=VJP_TOL):
    for name, g, w in zip(GRADS, got, want):
        g = np.asarray(g)
        assert not np.isnan(g).any(), f"{where} {name}"
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol, err_msg=f"{where} {name}")


@pytest.mark.parametrize("d", (8, 64))
@pytest.mark.parametrize("case", CASES)
def test_reference_fold_bwd_matches_jax(case, d):
    """Against the JAX ``reference_fold_bwd``, ``jax.vjp`` of the JAX
    ``reference_fold`` and the Pallas backward in interpret mode."""
    (q, kb, vb, m, l, acc, dm, dl, dacc), qp, kp, causal, nv, scale = _vjp_case(case, d)
    got = reference_fold_bwd(*(_t(a) for a in (q, kb, vb, m, l, acc)), qp, kp, causal, nv, scale,
                             _t(dm), _t(dl), _t(dacc))
    jin = [jnp.asarray(a) for a in (q, kb, vb, m, l, acc)]
    jct = [jnp.asarray(a) for a in (dm, dl, dacc)]
    want_ref = jflash.reference_fold_bwd(*jin, qp, kp, causal, nv, scale, *jct)
    _, vjp = jax.vjp(lambda *x: jflash.reference_fold(*x, qp, kp, causal, nv, scale), *jin)
    want_ad = vjp(tuple(jct))
    want_pallas = jflash._fold_bwd_pallas(*jin, qp, kp, causal, nv, scale, *jct, interpret=True)
    for label, want in (("reference_fold_bwd", want_ref), ("jax.vjp", want_ad), ("pallas", want_pallas)):
        _assert_grads(got, want, f"{case} d={d} vs {label}")
    if case == "ties":  # the edge is reached: ties split, and m equal to the block max
        s = np.einsum("bhqd,bhkd->bhqk", q, kb)[..., :nv] * scale
        counts = (s == s.max(axis=-1, keepdims=True)).sum(axis=-1)
        assert (counts >= 2).mean() > 0.9  # only a max at key 200, whose twin is masked, is alone
        assert np.any(m == s.max(axis=-1))
    if case == "fully-masked":  # rows 0… have no key before n_valid 10 - k_pos0 < 0
        assert np.all(got[0].numpy() == 0.0)
        np.testing.assert_array_equal(got[3].numpy(), dm * np.float32(0.5))  # -inf vs -inf: half


@pytest.mark.parametrize("d", (8, 64))
@pytest.mark.parametrize("case", CASES)
def test_autograd_through_reference_fold_matches_reference_fold_bwd(case, d):
    """torch's ``amax`` spreads a max's gradient evenly over its ties and
    ``maximum`` splits it 0.5 / 0.5, as JAX's do: AD of the plain fold
    equals the hand-derived VJP on every case, ties included."""
    arrays, qp, kp, causal, nv, scale = _vjp_case(case, d)
    ins = [_t(a).requires_grad_(True) for a in arrays[:6]]
    out = reference_fold(*ins, qp, kp, causal, nv, scale)
    want = torch.autograd.grad(out, ins, [_t(a) for a in arrays[6:]])
    got = reference_fold_bwd(*(_t(a) for a in arrays[:6]), qp, kp, causal, nv, scale,
                             *(_t(a) for a in arrays[6:]))
    _assert_grads(got, [w.numpy() for w in want], f"{case} d={d}")


@pytest.mark.parametrize("case", CASES)
def test_fused_fold_under_grad_on_cpu_runs_the_plain_forward_and_vjp(case):
    arrays, qp, kp, causal, nv, scale = _vjp_case(case, 8)
    ins = [_t(a).requires_grad_(True) for a in arrays[:6]]
    launches = (FLASH_FOLD.launches, FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches)
    out = fused_fold(*ins, qp, kp, causal, nv, scale)
    assert all(o.grad_fn is not None for o in out)
    for a, b in zip(out, reference_fold(*(_t(a) for a in arrays[:6]), qp, kp, causal, nv, scale)):
        assert torch.equal(a.detach(), b)
    got = torch.autograd.grad(out, ins, [_t(a) for a in arrays[6:]])
    want = reference_fold_bwd(*(_t(a) for a in arrays[:6]), qp, kp, causal, nv, scale,
                              *(_t(a) for a in arrays[6:]))
    for name, g, w in zip(GRADS, got, want):
        assert torch.equal(g, w), name
    # fused_fold_bwd on CPU tensors is the plain VJP, bit for bit
    for g, w in zip(fused_fold_bwd(*(_t(a) for a in arrays[:6]), qp, kp, causal, nv, scale,
                                   *(_t(a) for a in arrays[6:])), want):
        assert torch.equal(g, w)
    assert (FLASH_FOLD.launches, FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches) == launches


def test_fused_fold_gradients_flow_through_ring_attention_on_cpu():
    """The one-shard ring under grad: the unused m's gradient arrives as
    zeros and the transposes hand strided gradients; both reach the plain
    VJP and the result equals autograd of the plain ring."""
    from flink_ml_tpu_torch.parallel import ring as ring_mod

    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.standard_normal((2, 40, 2, 8)).astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    g = _t(rng.standard_normal((2, 40, 2, 8)).astype(np.float32))
    got = torch.autograd.grad(ring_mod.ring_attention(q, k, v, causal=True, n_valid=33), (q, k, v), g)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    m0 = torch.full((2, 2, 40), -torch.inf)
    _, l, acc = reference_fold(qt, kt, vt, m0, torch.zeros(2, 2, 40), torch.zeros(2, 2, 40, 8), 0, 0, True, 33,
                               1.0 / np.sqrt(8))
    plain = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    want = torch.autograd.grad(plain, (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=VJP_TOL, atol=VJP_TOL)


# ---------------------------------------------------------------------------
# the wrappers and kernels' registration, without a card
# ---------------------------------------------------------------------------


def test_the_backward_kernels_are_registered_with_the_pallas_sites_they_replace():
    lines = (native.PACKAGE_DIR.parent / "flink_ml_tpu/parallel/flash.py").read_text().splitlines()
    for kernel, line, symbol in ((FLASH_FOLD_BWD_DQ, 463, "flash_fold_bwd_dq"),
                                 (FLASH_FOLD_BWD_DKV, 499, "flash_fold_bwd_dkv")):
        assert kernel in native.KERNELS
        assert kernel.replaces == f"flink_ml_tpu/parallel/flash.py:{line}"
        assert kernel.source_path == "flink_ml_tpu_torch/csrc/flash_fold_bwd.cu"
        assert kernel.symbol == symbol
        assert "pl.pallas_call(" in lines[line - 1]  # the replaced line is the Pallas call
        assert f"int {symbol}(" in (native.CSRC_DIR / kernel.source).read_text()
    # both are the two calls of _fold_bwd_pallas
    assert lines[310].startswith("def _fold_bwd_pallas(")


def test_backward_kernel_wrappers_take_only_cuda_tensors():
    arrays, qp, kp, causal, nv, scale = _vjp_case("plain", 8)
    x = [_t(a) for a in arrays]
    before = (FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches)
    with pytest.raises(RuntimeError, match="takes CUDA tensors"):
        fold_bwd_dq(*x[:6], qp, kp, causal, nv, scale, *x[6:])
    with pytest.raises(RuntimeError, match="takes CUDA tensors"):
        fold_bwd_dkv(*x[:3], qp, kp, causal, nv, scale, x[7], x[8], x[3], x[3], x[3])
    meta = [torch.empty(a.shape, device="meta") for a in arrays]
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        fused_fold_bwd(*meta[:6], qp, kp, causal, nv, scale, *meta[6:])
    assert (FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches) == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FLASH_FOLD_BWD_DQ.launch(*([None] * 16 + [1, 1, 1, 8, 0, 0, 0, 0, 0, 0.25, None]))
        assert (FLASH_FOLD_BWD_DQ.launches, FLASH_FOLD_BWD_DKV.launches) == before


def test_backward_shared_memory_is_budgeted_for_hopper():
    # 64 owned rows of two [rows, D_pad + 4] float32 tiles, two stages of two
    # streamed 16-row tiles, + 32 max-key slots a row (dq) or four floats a
    # streamed row (dkv), under a Hopper block's 232,448 bytes
    assert fold_bwd_smem_bytes(128) == (109_568, 101_888)
    assert max(fold_bwd_smem_bytes(128)) <= 113 * 1024  # two blocks an SM at D 128
    assert fold_bwd_smem_bytes(200) == fold_bwd_smem_bytes(256)
    assert fold_bwd_smem_bytes(256) == (207_872, 200_192)
    assert fold_bwd_smem_bytes(64) == (60_416, 52_736)
    assert fold_bwd_smem_bytes(8) == fold_bwd_smem_bytes(16)
    assert max(max(fold_bwd_smem_bytes(d)) for d in range(1, MAX_HEAD_DIM + 1)) <= 232_448
    source = (native.CSRC_DIR / "flash_fold_bwd.cu").read_text()
    for tiles in ("kOwn = 64;", "kStream = 16;", "kLd = kD + 4;", "kMaxKeys = 32;", "2 * 4 * kStream"):
        assert tiles in source  # the tiles the Python budget mirrors


def test_flash_train_available_is_rederived_for_the_card():
    cuda = torch.device("cuda", 0)  # a device object: nothing touches a card
    # the JAX gate's output budget: B 1, T 8192, H 4, D 128 is 17 MB > 9 MB
    assert 1 * 4 * 8192 * (128 + 2) * 4 > jflash._TRAIN_OUT_VMEM_BUDGET
    assert flash_train_available(8192, 128, 1, 4, cuda)
    for T, d, batch, heads in ((8192, 128, 8, 4), (8000, 64, 2, 8), (1, 1, 1, 1), (16384, 256, 4, 4)):
        assert flash_train_available(T, d, batch, heads, cuda)  # any length, any batch
        assert not flash_train_available(T, d, batch, heads, "cpu")
    assert not flash_train_available(8192, MAX_HEAD_DIM + 1, 1, 4, cuda)
    assert attn._use_flash_train(np.zeros((2, 8192), np.int32), 512, 4, 2, cuda)
    assert not attn._use_flash_train(np.zeros((2, 64), np.int32), 1024, 2, 2, cuda)
    # one shard: _pad_tokens pads nothing
    tok = np.arange(14, dtype=np.int32).reshape(2, 7)
    padded, t_real = attn._pad_tokens(tok)
    assert padded is tok and t_real == 7


# ---------------------------------------------------------------------------
# the Estimator against the JAX fit
# ---------------------------------------------------------------------------

EMB, HEADS, SEQ, VOCAB, DOCS, BATCH, ITERS, LR, SEED = 16, 2, 256, 50, 6, 4, 3, 1e-2, 3


def _documents(n=DOCS, seed=0):
    """Token sequences over a 50-token vocabulary whose label (1 or 3) is
    carried by a signal token (7 or 5) planted at a third of the positions."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, size=(n, SEQ))
    y = np.where(rng.random(n) > 0.5, 3.0, 1.0)
    y[:2] = (1.0, 3.0)  # both classes
    tok = np.where(rng.random((n, SEQ)) < 0.3, np.where(y[:, None] == 3.0, 7, 5), tok)
    return tok.astype(np.float64), y


def _configure(est):
    return (est.set_embedding_dim(EMB).set_num_heads(HEADS).set_vocab_size(VOCAB).set_max_iter(ITERS)
            .set_learning_rate(LR).set_global_batch_size(BATCH).set_seed(SEED))


def _windows(n=DOCS, batch=BATCH, iters=ITERS):
    """The fit's window schedule: (lo, weights) per step."""
    offset, out = 0, []
    for _ in range(iters):
        lo = min(offset, n - batch)
        out.append((lo, (np.arange(batch) + lo >= offset).astype(np.float32)))
        offset = 0 if offset + batch >= n else offset + batch
    return out


@pytest.fixture(scope="module")
def fitted():
    tok, y = _documents()
    port = _configure(SelfAttentionClassifier())
    model = port.fit(DataFrame.from_dict({"features": tok, "label": y}), device="cpu")
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        jmodel = _configure(JSelfAttentionClassifier()).fit(JDataFrame.from_dict({"features": tok, "label": y}))
    return tok, y, port, model, jmodel


def _jax_steps(mesh, flash):
    """The JAX fit's step program (``_train_step``), driven window by window
    from the shared initial weights: per-step losses, the parameters after
    each step, and the elements whose gradient (recovered from adam's first
    moment, mu_t = 0.1 g_t + 0.9 mu_(t-1)) lies within 1e-6 of 0, and is
    not exactly 0 (a token no window holds), at some step."""
    tok, y = _documents()
    y_idx = np.searchsorted(np.unique(y), y).astype(np.int32)
    optimizer, step = jtrain_step(mesh, HEADS, LR, flash)
    params = {k: jnp.asarray(v) for k, v in jinit_params(np.random.default_rng(SEED), VOCAB, EMB, 2).items()}
    opt_state = optimizer.init(params)
    losses, history, mus = [], [], [{k: np.zeros(v.shape, np.float32) for k, v in params.items()}]
    for lo, w in _windows():
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tok[lo:lo + BATCH].astype(np.int32)),
                                       jnp.asarray(y_idx[lo:lo + BATCH]), jnp.asarray(w), jnp.asarray(SEQ, jnp.int32))
        losses.append(float(loss))
        history.append({k: np.asarray(v) for k, v in params.items()})
        mus.append({k: np.asarray(v) for k, v in opt_state[0].mu.items()})
    flat = {k: np.zeros(v.shape, bool) for k, v in history[0].items()}
    for prev, cur in zip(mus, mus[1:]):
        for k in flat:
            g = np.abs((cur[k] - np.float32(0.9) * prev[k]) / np.float32(0.1))
            flat[k] |= (g > 0) & (g < 1e-6)
    return losses, history, mus[1], flat


@pytest.fixture(scope="module")
def jax_steps():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        return _jax_steps(ctx.mesh, False)


def _assert_params(got, want, flat, steps, where):
    """Within 1e-5, or within lr per step where adam's eps governs (module
    docstring); the flat elements are few."""
    n_flat = sum(int(f.sum()) for f in flat.values())
    assert n_flat < 0.05 * sum(f.size for f in flat.values()), n_flat
    for name, w in want.items():
        g = np.asarray(got[name])
        assert g.dtype == np.float32 and g.shape == w.shape, name
        tol = np.where(flat[name], LR * steps, 1e-5)
        err = np.abs(g - w)
        assert np.all(err <= tol), f"{where} {name}: max error {err.max()} past its tolerance"


def test_fit_matches_the_jax_fit(one_device_mesh, fitted, jax_steps):
    tok, y, port, model, jmodel = fitted
    losses, history, _, flat = jax_steps
    # the JAX fit runs exactly the step program the fixture drove
    for name, a in jmodel.params.items():
        np.testing.assert_array_equal(a, history[-1][name])
    assert sorted(model.params) == sorted(jmodel.params)
    _assert_params(model.params, jmodel.params, flat, ITERS, "fit")
    np.testing.assert_allclose(port.loss_history, losses, rtol=1e-5)
    np.testing.assert_array_equal(model.labels, jmodel.labels)
    assert model.get_vocab_size() == jmodel.get_vocab_size() == VOCAB
    assert json.dumps(model.param_map_to_json(), sort_keys=True) == json.dumps(
        jmodel.param_map_to_json(), sort_keys=True)
    held = _documents(4, seed=1)[0]
    out = model.transform(DataFrame.from_dict({"features": held}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": held}))
    np.testing.assert_allclose(np.asarray(out.column("rawPrediction")), np.asarray(ref.column("rawPrediction")),
                               rtol=0, atol=1e-5)


def test_first_step_gradient_matches_the_jax_step(jax_steps):
    """Step 1 from the shared initial weights: the port's adam moment (0.1 ·
    the gradient), loss and parameters against the JAX step's (jnp fold)."""
    losses, history, mu1, flat = jax_steps
    tok, y = _documents()
    y_idx = np.searchsorted(np.unique(y), y)
    params = {k: _t(v) for k, v in attn._init_params(np.random.default_rng(SEED), VOCAB, EMB, 2).items()}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    lo, w = _windows()[0]
    new, mu, _, loss = attn._train_step(params, zeros, dict(zeros), 1, torch.from_numpy(tok[lo:lo + BATCH]).long(),
                                        torch.from_numpy(y_idx[lo:lo + BATCH]), _t(w), SEQ, HEADS, LR)
    np.testing.assert_allclose(float(loss), losses[0], rtol=1e-5)
    scale = max(float(np.abs(m).max()) for m in mu1.values())
    for name, want in mu1.items():
        np.testing.assert_allclose(mu[name].numpy(), want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)
    _assert_params({k: v.numpy() for k, v in new.items()}, history[0], flat, 1, "step 1")


def test_fit_matches_the_jax_flash_train_step_in_interpret_mode(one_device_mesh, fitted, jax_steps):
    """The JAX flash training step — its Pallas forward and backward folds
    under interpret mode — driven window by window from the same weights:
    the port's fit takes the same losses and ends at the same weights."""
    _, _, port, model, _ = fitted
    with pltpu.force_tpu_interpret_mode():
        losses, history, _, flat = _jax_steps(one_device_mesh.mesh, True)
    np.testing.assert_allclose(port.loss_history, losses, rtol=1e-5)
    _assert_params(model.params, history[-1], {k: f | jax_steps[3][k] for k, f in flat.items()}, ITERS, "flash")


def test_fitted_port_model_loads_in_the_jax_package(one_device_mesh, fitted, tmp_path):
    """The port writes the JAX twin's class name: the JAX ``load`` reads
    the fitted model's directory."""
    tok, y, _, model, _ = fitted
    path = str(tmp_path / "attn")
    model.save(path)
    jmodel = JSelfAttentionClassifierModel.load(path)
    assert type(jrw.load_stage(path)) is JSelfAttentionClassifierModel
    held = _documents(3, seed=2)[0]
    out = model.transform(DataFrame.from_dict({"features": held}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": held}))
    np.testing.assert_allclose(np.asarray(out.column("rawPrediction")), np.asarray(ref.column("rawPrediction")),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.column("prediction")), np.asarray(ref.column("prediction")))


def test_jax_fitted_model_and_estimator_load_in_the_port(one_device_mesh, fitted, tmp_path):
    tok, y, port, _, jmodel = fitted
    path = str(tmp_path / "attn")
    jmodel.save(path)
    model = rw.load_stage(path)
    assert type(model) is SelfAttentionClassifierModel
    for name, a in jmodel.params.items():
        np.testing.assert_array_equal(model.params[name], a)
    held = _documents(3, seed=3)[0]
    out = model.transform(DataFrame.from_dict({"features": held}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": held}))
    np.testing.assert_allclose(np.asarray(out.column("rawPrediction")), np.asarray(ref.column("rawPrediction")),
                               rtol=0, atol=1e-5)
    # the Estimator: saved by JAX, loaded as the port's, and back
    est_path = str(tmp_path / "est")
    _configure(JSelfAttentionClassifier()).save(est_path)
    est = rw.load_stage(est_path)
    assert type(est) is SelfAttentionClassifier
    assert rw.resolve_class(JAX_ESTIMATOR, stage=True) is SelfAttentionClassifier
    assert json.dumps(est.param_map_to_json(), sort_keys=True) == json.dumps(
        port.param_map_to_json(), sort_keys=True)
    back = str(tmp_path / "est_back")
    est.save(back)
    jest = JSelfAttentionClassifier.load(back)
    assert (jest.get_embedding_dim(), jest.get_num_heads(), jest.get_max_iter()) == (EMB, HEADS, ITERS)


# ---------------------------------------------------------------------------
# validation and defaults
# ---------------------------------------------------------------------------


def _both(df_rows, **kw):
    tok, y = df_rows
    port = SelfAttentionClassifier().set_max_iter(1)
    jest = JSelfAttentionClassifier().set_max_iter(1)
    for est in (port, jest):
        for name, value in kw.items():
            getattr(est, f"set_{name}")(value)
    return (port, DataFrame.from_dict({"features": tok, "label": y})), (
        jest, JDataFrame.from_dict({"features": tok, "label": y}))


@pytest.mark.parametrize("kw,bad,match", [
    ({"embedding_dim": 10, "num_heads": 4}, None, "must divide evenly"),
    ({}, -1, "non-negative"),
    ({"vocab_size": 20}, 30, "vocabSize"),
])
def test_fit_reproduces_the_jax_validation_errors(one_device_mesh, kw, bad, match):
    tok, y = _documents(3)
    tok = np.minimum(tok[:, :16], 19)
    if bad is not None:
        tok[0, 0] = bad
    (port, df), (jest, jdf) = _both((tok, y), **kw)
    with pytest.raises(ValueError, match=match):
        port.fit(df, device="cpu")
    with pytest.raises(ValueError, match=match):
        jest.fit(jdf)


def test_fit_without_a_device_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tok, y = _documents(3)
    est = SelfAttentionClassifier().set_embedding_dim(8).set_num_heads(2).set_max_iter(1)
    df = DataFrame.from_dict({"features": tok[:, :16], "label": y})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.fit(df)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.fit(df, device="cuda")


def test_fit_infers_the_vocabulary_and_labels_as_jax(one_device_mesh):
    tok, y = _documents(4)
    tok = tok[:, :32]
    y = np.array([9.0, 2.0, 9.0, 4.0])
    (port, df), (jest, jdf) = _both((tok, y), embedding_dim=8, num_heads=2, global_batch_size=4, seed=1)
    model = port.fit(df, device="cpu")
    jmodel = jest.fit(jdf)
    assert model.get_vocab_size() == jmodel.get_vocab_size() == int(tok.max()) + 1
    np.testing.assert_array_equal(model.labels, [2.0, 4.0, 9.0])
    np.testing.assert_array_equal(model.labels, jmodel.labels)
    assert model.params["emb"].shape == (int(tok.max()) + 1, 8) and model.params["w_cls"].shape == (8, 3)


def test_estimator_defaults_match_jax():
    assert json.dumps(SelfAttentionClassifier().param_map_to_json(), sort_keys=True) == json.dumps(
        JSelfAttentionClassifier().param_map_to_json(), sort_keys=True)
    est = SelfAttentionClassifier()
    assert (est.get_embedding_dim(), est.get_num_heads(), est.get_vocab_size(), est.get_max_iter()) == (32, 4, 0, 20)
