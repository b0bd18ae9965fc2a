"""The port's expert-parallel mixture-of-experts (``parallel/moe.py``) in
gloo worlds of 2 and 4 ranks on the CPU, against the JAX package's
``moe_ffn_sharded`` at the same width and against a dense one-rank torch
computation of the same routing.

Each world is spawned once for the module (``tests/torch_sharded_worker.py``)
and runs every scenario: the whole inputs on every rank, each rank returning
its tokens' slice of the output, its routing, and the VJP of its slice in
its tokens, the router and its experts. The JAX side runs here on the
conftest's host devices, under ``shard_map`` as it is.

Tolerances, each with its source (``tests/test_moe.py``):
- expert ids and kept masks: exact (the kept mask read off the output's
  nonzero rows, the reference's routing written apart from the port's);
- outputs: within 1e-6 of JAX's, the dropped tokens' rows exactly 0 in both;
- gradients: within 1e-6 of the dense one-rank computation.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.parallel.mesh import MeshContext as JMeshContext
from flink_ml_tpu.parallel.moe import moe_ffn_sharded as jmoe_ffn_sharded

from flink_ml_tpu_torch.parallel.moe import moe_ffn_sharded

from tests.torch_sharded_worker import run_world

torch.set_num_threads(1)

OUT_ATOL = 1e-6
GRAD_ATOL = 1e-6
WIDTHS = (2, 4)
T, DM, HID, E = 64, 16, 32, 8
CAPACITIES = (5, 2)  # 2 drops tokens at both widths


def _inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(T, DM)).astype(np.float32)
    router = rng.normal(size=(DM, E)).astype(np.float32)
    w1 = (rng.normal(size=(E, DM, HID)) * 0.2).astype(np.float32)
    w2 = (rng.normal(size=(E, HID, DM)) * 0.2).astype(np.float32)
    g = (rng.normal(size=(T, DM)) * 0.1).astype(np.float32)  # gradients O(0.1-1): 1e-6 is >= 8 ulps
    return x, router, w1, w2, g


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe"))
    x, router, w1, w2, g = _inputs()
    sc = [(f"moe_c{c}", "moe", dict(x=x, router=router, w1=w1, w2=w2, g=g, capacity=c)) for c in CAPACITIES]
    sc.append(("moe_uneven", "moe_uneven", {}))
    return {w: run_world(w, sc, tmp, tag="moe") for w in WIDTHS}


def _jax_routing(x, router, capacity):
    """The JAX module's routing formulas on one rank's tokens."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    one_hot = jax.nn.one_hot(expert, router.shape[1], dtype=jnp.int32)
    slot = jnp.sum((jnp.cumsum(one_hot, axis=0) - 1) * one_hot, axis=1)
    return np.asarray(expert), np.asarray(slot < capacity)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("width", WIDTHS)
def test_moe_matches_jax_at_the_same_width(worlds, width, capacity):
    x, router, w1, w2, _g = _inputs()
    ranks = worlds[width][f"moe_c{capacity}"]
    ctx = JMeshContext(devices=jax.devices()[:width], n_data=width)
    want = np.asarray(jmoe_ffn_sharded(x, router, w1, w2, capacity, ctx=ctx))
    got = np.concatenate([r["out"] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)
    t = T // width
    for i, r in enumerate(ranks):
        expert, keep = _jax_routing(x[i * t:(i + 1) * t], router, capacity)
        np.testing.assert_array_equal(r["expert"], expert)
        np.testing.assert_array_equal(r["keep"], keep)
        dropped = ~keep
        assert np.all(r["out"][dropped] == 0.0) and np.all(want[i * t:(i + 1) * t][dropped] == 0.0)
    if capacity == min(CAPACITIES):
        assert not all(r["keep"].all() for r in ranks)  # the case drops tokens


def _plain_routing(xi, r, capacity):
    """Top-1 routing written apart from the port's ``route_top1``: each
    token's argmax expert and its softmax gate, and the first ``capacity``
    tokens of each expert, in token order, kept."""
    probs = torch.softmax(xi @ r, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs[torch.arange(xi.shape[0]), expert]
    keep = torch.zeros(xi.shape[0], dtype=torch.bool)
    for e in range(r.shape[1]):
        keep[torch.nonzero(expert == e)[:capacity, 0]] = True
    return expert, gate, keep


def _dense_reference(width, capacity):
    """Each token through its own expert, scaled by its gate, with the
    routing of its rank's slice — no dispatch — and its VJP."""
    x, router, w1, w2, g = (torch.from_numpy(a) for a in _inputs())
    leaves = [a.clone().requires_grad_(True) for a in (x, router, w1, w2)]
    xs, r, W1, W2 = leaves
    t = T // width
    outs = []
    for i in range(width):
        xi = xs[i * t:(i + 1) * t]
        expert, gate, keep = _plain_routing(xi, r, capacity)
        y = torch.einsum("th,thd->td", torch.relu(torch.einsum("td,tdh->th", xi, W1[expert])), W2[expert])
        outs.append(torch.where(keep[:, None], y * gate[:, None], torch.zeros_like(y)))
    out = torch.cat(outs)
    return out.detach().numpy(), [a.numpy() for a in torch.autograd.grad(out, leaves, g)]


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("width", WIDTHS)
def test_moe_gradients_match_the_dense_computation(worlds, width, capacity):
    ranks = worlds[width][f"moe_c{capacity}"]
    out, (dx, drouter, dw1, dw2) = _dense_reference(width, capacity)
    np.testing.assert_allclose(np.concatenate([r["out"] for r in ranks]), out, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), dx, rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(sum(r["drouter"] for r in ranks), drouter, rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(np.concatenate([r["dw1"] for r in ranks]), dw1, rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(np.concatenate([r["dw2"] for r in ranks]), dw2, rtol=0, atol=GRAD_ATOL)


def test_one_rank_and_the_divisibility_rule():
    x, router, w1, w2, _g = _inputs()
    got = moe_ffn_sharded(x, router, w1, w2, T, device="cpu").numpy()
    want = np.asarray(jmoe_ffn_sharded(x, router, w1, w2, T, ctx=JMeshContext(devices=jax.devices()[:1],
                                                                             n_data=1)))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)
    assert np.all(np.abs(got).sum(axis=1) > 0)  # capacity T keeps every token
    with pytest.raises(ValueError, match="must divide"):
        jmoe_ffn_sharded(x[:63], router, w1, w2, 4, ctx=JMeshContext(devices=jax.devices()[:2], n_data=2))


@pytest.mark.parametrize("width", WIDTHS)
def test_uneven_tokens_or_experts_raise_on_every_rank(worlds, width):
    for r in worlds[width]["moe_uneven"]:
        errors = r["errors"].tolist()
        assert len(errors) == 2 and all("must divide" in e for e in errors), errors
