"""The port's multi-rank ring (``parallel/ring.py``) and the
sequence-sharded ``SelfAttentionClassifier`` in gloo worlds of 2 and 4 ranks
on the CPU, against the JAX package's ``ring_attention_sharded`` and
classifier at the same width.

Each world is spawned once for the module (``tests/torch_sharded_worker.py``)
and runs every scenario: the whole inputs on every rank, each rank returning
its slice of the sequence. The JAX ring runs here on the conftest's host
devices, under ``shard_map`` as it is (it uses ``pcast`` and ``psum(1)``).

Tolerances, each with its source:
- the ring's forward and the VJP in q, k and v: rtol/atol 2e-5
  (``VJP_TOL``, ``tests/test_torch_attention_train.py``), against JAX at the
  same width and against the port's one-shard ring;
- every rank's outputs of the classifier: bit-equal to rank 0's;
- the classifier at width 2 against JAX's at width 2: losses rtol 1e-5 and
  probabilities within ``PROB_ATOL`` 1e-5; its parameters within 1e-5,
  except where adam's eps governs (``_assert_params``), of JAX's one-shard
  steps — JAX's width-2 step doubles its gradient (checked: its first
  moment), which moves exactly those elements.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.models.classification.attention_classifier import (
    SelfAttentionClassifier as JSelfAttentionClassifier,
)
from flink_ml_tpu.parallel.mesh import MeshContext as JMeshContext, mesh_context as jmesh_context
from flink_ml_tpu.parallel.ring import ring_attention_sharded as jring_attention_sharded

from flink_ml_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded

from tests.test_torch_attention_train import (
    BATCH,
    EMB,
    HEADS,
    ITERS,
    LR,
    SEED,
    VOCAB,
    _assert_params,
    _configure,
    _documents,
    _jax_steps,
)
from tests.torch_sharded_worker import run_world

torch.set_num_threads(1)

VJP_TOL = 2e-5
PROB_ATOL = 1e-5
WIDTHS = (2, 4)
B, T, H, D = 2, 64, 2, 8
CASES = {"causal": (True, None), "plain": (False, None), "padded": (False, 50)}
HELD_T = 251  # not a multiple of 2: the classifier pads the held documents


def _qkvg():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4)]


def _scenarios(width):
    q, k, v, g = _qkvg()
    out = [(f"ring_{c}", "ring", dict(q=q, k=k, v=v, g=g, causal=causal, n_valid=nv))
           for c, (causal, nv) in CASES.items()]
    out.append(("uneven", "ring_uneven", {}))
    if width == 2:
        tok, y = _documents()
        out.append(("clf", "attention_classifier",
                    dict(tokens=tok, labels=y, held=_documents(4, seed=1)[0][:, :HELD_T],
                         params=dict(embedding_dim=EMB, num_heads=HEADS, vocab_size=VOCAB, max_iter=ITERS,
                                     learning_rate=LR, global_batch_size=BATCH, seed=SEED))))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring"))
    return {w: run_world(w, _scenarios(w), tmp, tag="ring") for w in WIDTHS}


def _joined(ranks, key, axis=1):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _jax_ring(width, causal, n_valid):
    """JAX's sharded ring at ``width`` and its VJP with the cotangent g."""
    q, k, v, g = _qkvg()
    ctx = JMeshContext(devices=jax.devices()[:width], n_data=width)
    out, vjp = jax.vjp(lambda a, b, c: jring_attention_sharded(a, b, c, causal=causal, ctx=ctx, n_valid=n_valid),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("width", WIDTHS)
def test_the_ring_and_its_vjp_match_jax_at_the_same_width(worlds, width, case):
    ranks = worlds[width][f"ring_{case}"]
    want, want_grads = _jax_ring(width, *CASES[case])
    np.testing.assert_allclose(_joined(ranks, "out"), want, rtol=VJP_TOL, atol=VJP_TOL)
    np.testing.assert_array_equal(_joined(ranks, "out_grad_path"), _joined(ranks, "out"))
    for name, w in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(_joined(ranks, name), w, rtol=VJP_TOL, atol=VJP_TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("width", WIDTHS)
def test_the_ring_matches_the_one_shard_ring(worlds, width, case):
    causal, n_valid = CASES[case]
    q, k, v, g = _qkvg()
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    one = ring_attention(*leaves, causal=causal, n_valid=n_valid)
    grads = torch.autograd.grad(one, leaves, torch.from_numpy(g))
    np.testing.assert_array_equal(ring_attention_sharded(q, k, v, causal=causal, n_valid=n_valid,
                                                         device="cpu").numpy(), one.detach().numpy())
    ranks = worlds[width][f"ring_{case}"]
    np.testing.assert_allclose(_joined(ranks, "out"), one.detach().numpy(), rtol=VJP_TOL, atol=VJP_TOL)
    for name, w in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_joined(ranks, name), w.numpy(), rtol=VJP_TOL, atol=VJP_TOL, err_msg=name)


@pytest.mark.parametrize("width", WIDTHS)
def test_an_uneven_sequence_raises_as_jax_does(worlds, width):
    for r in worlds[width]["uneven"]:
        assert "not divisible by mesh axis" in str(r["error"])
    x = np.zeros((1, 2 * width + 1, 1, 8), np.float32)
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        jring_attention_sharded(x, x, x, ctx=JMeshContext(devices=jax.devices()[:width], n_data=width))


def test_the_classifier_splits_its_sequence_as_jax_does(worlds):
    ranks = worlds[2]["clf"]
    for r in ranks[1:]:
        for key in ranks[0]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    got = ranks[0]
    tok, y = _documents()
    ctx = JMeshContext(devices=jax.devices()[:2], n_data=2)
    losses, _history, mu2, _flat = _jax_steps(ctx.mesh, False)
    with jmesh_context(JMeshContext(devices=jax.devices()[:1], n_data=1)) as one:
        _losses1, _history1, mu1, flat = _jax_steps(one.mesh, False)
    # JAX's sharded step sums gradients that are already whole on every
    # shard: its width-2 adam sees twice the gradient (the first moment
    # doubles), which moves only the elements where adam's eps governs. The
    # port sums per-rank partials, so its width-2 fit is the one-shard fit:
    # its parameters are held to JAX's width-1 steps.
    for name in mu1:
        big = np.abs(mu1[name]) > 1e-4
        np.testing.assert_allclose(mu2[name][big], 2 * mu1[name][big], rtol=1e-4, err_msg=name)
    with jmesh_context(ctx):
        jmodel = _configure(JSelfAttentionClassifier()).fit(JDataFrame.from_dict({"features": tok, "label": y}))
        held = _documents(4, seed=1)[0][:, :HELD_T]
        jout = jmodel.transform(JDataFrame.from_dict({"features": held}))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _assert_params({k[2:]: v for k, v in got.items() if k.startswith("p_")}, _history1[-1], flat, ITERS,
                   "width 2")
    np.testing.assert_allclose(got["probs"], np.asarray(jout.vectors(jmodel.get_raw_prediction_col())),
                               rtol=0, atol=PROB_ATOL)
