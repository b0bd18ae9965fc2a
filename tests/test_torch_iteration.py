"""The port's bounded iteration loop and SGD's host loop against the JAX
package on the CPU: termination criteria on the same loss sequences, the
loop's epochs, listeners, lifecycles, replayed streams and kill/resume,
and SGD killed by a listener and resumed from its checkpoints.

Tolerances, each with its reason:
- the loop's outputs and epochs are exact (host arithmetic on floats);
- a resumed SGD fit is bit-equal to the port's uninterrupted fused fit: the
  host loop runs the same epoch function on the same slices, and the CPU's
  sums run in a fixed order;
- against the JAX coefficient: 1e-6 absolute — 30 epochs of float32 SGD
  whose products and sums round in another order (measured ≤ 2e-7 here).
The JAX side runs on a one-device mesh, so its local batch is the port's.
"""
import numpy as np
import pytest
import torch

from flink_ml_tpu.checkpoint import CheckpointManager as JCheckpointManager
from flink_ml_tpu.iteration import (
    IterationBodyResult as JBodyResult,
    IterationConfig as JIterationConfig,
    IterationListener as JIterationListener,
    OperatorLifeCycle as JOperatorLifeCycle,
    ReplayableDataStreamList as JReplayable,
    TerminateOnMaxIter as JTerminateOnMaxIter,
    TerminateOnMaxIterOrTol as JTerminateOnMaxIterOrTol,
    iterate_bounded_until_termination as jiterate,
)
from flink_ml_tpu.ops import SGD as JSGD
from flink_ml_tpu.ops import BinaryLogisticLoss as JBinaryLogisticLoss
from flink_ml_tpu.ops import LeastSquareLoss as JLeastSquareLoss
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.checkpoint import CheckpointManager
from flink_ml_tpu_torch.iteration import (
    IterationBodyResult,
    IterationConfig,
    IterationListener,
    OperatorLifeCycle,
    ReplayableDataStreamList,
    TerminateOnMaxIter,
    TerminateOnMaxIterOrTol,
    iterate_bounded_until_termination,
    iterate_unbounded,
)
from flink_ml_tpu_torch.iteration.iteration import _PipelineThrottle
from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, LeastSquareLoss
from flink_ml_tpu_torch.ops.optimizer import SGD

torch.set_num_threads(1)


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


def _recorder(base):
    class Recorder(base):
        def __init__(self, fail_at=None):
            self.epochs, self.terminated, self.fail_at = [], False, fail_at

        def on_epoch_watermark_incremented(self, epoch, context):
            self.epochs.append(epoch)
            if epoch == self.fail_at:
                raise RuntimeError(f"injected failure at epoch {epoch}")

        def on_iteration_terminated(self, context):
            self.terminated = True

    return Recorder


Recorder, JRecorder = _recorder(IterationListener), _recorder(JIterationListener)

PACKAGES = {
    "port": (iterate_bounded_until_termination, IterationBodyResult, IterationConfig, Recorder),
    "jax": (jiterate, JBodyResult, JIterationConfig, JRecorder),
}


# ---------------------------------------------------------------------------
# criteria
# ---------------------------------------------------------------------------

LOSSES = [3.0, 1.0, 0.5, 0.25, 0.2, 0.1, 0.05, float("nan"), 0.01, float("inf")]


@pytest.mark.parametrize("max_iter,tol", [
    (None, None), (5, None), (None, 0.2), (10, 0.05), (3, 1.0), (100, float("-inf")), (1, 0.0),
])
def test_criteria_decide_as_the_jax_package_on_the_same_losses(max_iter, tol):
    port, ref = TerminateOnMaxIterOrTol(max_iter, tol), JTerminateOnMaxIterOrTol(max_iter, tol)
    for epoch, loss in enumerate(LOSSES):
        for given in (loss, None, torch.tensor(loss, dtype=torch.float32)):
            want = ref(epoch, None if given is None else float(loss))
            assert port(epoch, given) == want, (epoch, given)
    for n in (1, 4, 9):
        assert [TerminateOnMaxIter(n)(e) for e in range(12)] == [JTerminateOnMaxIter(n)(e) for e in range(12)]


def test_criteria_read_a_tensor_loss_only_when_tol_is_finite():
    class Unreadable(torch.Tensor):
        def __float__(self):
            raise AssertionError("the loss was read without a finite tol")

    loss = torch.tensor(1.0).as_subclass(Unreadable)
    assert TerminateOnMaxIterOrTol(10, None)(0, loss)
    with pytest.raises(AssertionError, match="without a finite tol"):
        TerminateOnMaxIterOrTol(10, 0.5)(0, loss)


# ---------------------------------------------------------------------------
# the bounded loop against the JAX package's
# ---------------------------------------------------------------------------


def _run_loop(pkg, body_of, **config):
    iterate, Result, Config, Rec = PACKAGES[pkg]
    rec = Rec()
    outs = iterate([0.0], body_of(Result), config=Config(**config), listeners=[rec])
    return outs, rec.epochs, rec.terminated


@pytest.mark.parametrize("case", ["max_iter", "tol", "no_feedback", "max_epochs"])
def test_loop_epochs_outputs_and_listeners_equal_the_jax_loop(case):
    def body_of(Result):
        crit = TerminateOnMaxIter(5)
        tol = TerminateOnMaxIterOrTol(max_iter=100, tol=0.1)

        def body(variables, epoch):
            (x,) = variables
            if case == "max_iter":
                x = x + 1.0
                return Result([x], outputs=[x], termination_criteria=crit(epoch))
            if case == "tol":
                x = 0.5 ** (epoch + 1)
                return Result([x], outputs=[x], termination_criteria=tol(epoch, loss=x))
            if case == "no_feedback":
                return Result(None if epoch >= 2 else [x], outputs=[epoch])
            return Result([x + 1.0], outputs=[x + 1.0])

        return body

    config = {"max_epochs": 3} if case == "max_epochs" else {}
    got = _run_loop("port", body_of, **config)
    want = _run_loop("jax", body_of, **config)
    assert got == want
    assert got[2] is True


@pytest.mark.parametrize("lifecycle", ["ALL_ROUND", "PER_ROUND"])
def test_lifecycles_equal_the_jax_loop(lifecycle):
    def run(iterate, Result, Config, LifeCycle):
        log = []

        class Body:
            def __init__(self):
                self.calls = 0

            def __call__(self, variables, epoch):
                self.calls += 1
                log.append(self.calls)
                return Result([variables[0] + float(self.calls)], outputs=[variables[0] + float(self.calls)])

        body = Body if lifecycle == "PER_ROUND" else Body()
        config = Config(operator_life_cycle=LifeCycle[lifecycle], max_epochs=4)
        return iterate([0.0], body, config=config), log

    got = run(iterate_bounded_until_termination, IterationBodyResult, IterationConfig, OperatorLifeCycle)
    want = run(jiterate, JBodyResult, JIterationConfig, JOperatorLifeCycle)
    assert got == want
    assert got[1] == ([1, 1, 1, 1] if lifecycle == "PER_ROUND" else [1, 2, 3, 4])


def test_per_round_rejects_a_body_that_is_no_factory():
    config = IterationConfig(operator_life_cycle=OperatorLifeCycle.PER_ROUND, max_epochs=2)
    with pytest.raises(TypeError, match="factory"):
        iterate_bounded_until_termination([0.0], lambda: 3, config=config)


def test_replayed_streams_and_epoch_view_equal_the_jax_loop():
    def run(iterate, Result, Config, Replayable):
        calls = []

        def factory():
            calls.append(1)
            return iter([{"x": np.asarray([1.0, 2.0])}])

        data = Replayable(
            replay={"f": factory, "chunks": [{"x": np.asarray([4.0])}, {"x": np.asarray([8.0])}]},
            no_replay={"init": iter([{"x": np.asarray([100.0])}])},
        )
        seen = []

        def body(variables, epoch, streams):
            sums = {k: sum(float(np.sum(c["x"])) for c in streams[k]) for k in ("f", "chunks", "init")}
            seen.append(sums)
            return Result([variables[0] + sum(sums.values())], outputs=[variables[0] + sum(sums.values())])

        outs = iterate([0.0], body, config=Config(max_epochs=3), data=data)
        return outs, seen, len(calls)

    got = run(iterate_bounded_until_termination, IterationBodyResult, IterationConfig, ReplayableDataStreamList)
    want = run(jiterate, JBodyResult, JIterationConfig, JReplayable)
    assert got == want
    assert got[1][0]["init"] == 100.0 and got[1][2]["init"] == 0.0


def test_replay_rejects_one_shot_iterators_and_overlaps_and_reads_dataframes():
    with pytest.raises(TypeError, match="not replayable"):
        ReplayableDataStreamList(replay={"g": iter([1])}).epoch_view(0)
    with pytest.raises(ValueError, match="both replay"):
        ReplayableDataStreamList(replay={"a": 1}, no_replay={"a": 2})
    df = DataFrame.from_dict({"y": np.asarray([5.0, 7.0])})
    (chunk,) = list(ReplayableDataStreamList(replay={"df": df}).epoch_view(1)["df"])
    np.testing.assert_array_equal(chunk["y"], [5.0, 7.0])


def test_unbounded_loop_names_the_roadmap():
    """ROADMAP queue A 8 is ported: the unbounded loop runs instead of
    raising — nothing from an empty stream, one epoch a batch otherwise."""
    assert list(iterate_unbounded([0.0], iter(()), lambda *a: None)) == []
    got = list(iterate_unbounded(
        [0.0], iter([1.0, 2.0]),
        lambda v, batch, epoch: IterationBodyResult([v[0] + batch], outputs=[(epoch, v[0] + batch)])))
    assert got == [(0, 1.0), (1, 3.0)]


def test_throttle_depth_is_one_on_the_cpu_and_never_waits():
    throttle = _PipelineThrottle(None)
    for _ in range(3):
        throttle.admit([torch.zeros(2), np.zeros(1)])
    assert throttle.depth == 1 and throttle._inflight == []


def test_loop_kill_and_resume_lands_on_the_clean_result(tmp_path):
    """x += epoch for 10 epochs, killed at epoch 6 and resumed (JAX
    ``tests/test_checkpoint.py`` :52), in both packages."""

    def body_of(Result):
        crit = TerminateOnMaxIter(10)

        def body(variables, epoch):
            x = variables[0] + float(epoch)
            return Result([x], outputs=[x], termination_criteria=crit(epoch))

        return body

    results = {}
    for pkg, Manager in (("port", CheckpointManager), ("jax", JCheckpointManager)):
        iterate, Result, Config, Rec = PACKAGES[pkg]
        clean = iterate([np.asarray(0.0)], body_of(Result))
        mgr = Manager(str(tmp_path / pkg), max_to_keep=2)
        config = Config(checkpoint_interval=1, checkpoint_manager=mgr)
        failing = Rec(fail_at=6)
        with pytest.raises(RuntimeError, match="injected failure"):
            iterate([np.asarray(0.0)], body_of(Result), config=config, listeners=[failing])
        after = Rec()
        resumed = iterate([np.asarray(0.0)], body_of(Result), config=config, listeners=[after])
        results[pkg] = (float(clean[0]), float(resumed[0]), mgr.all_steps(), failing.epochs, after.epochs)
    assert results["port"] == results["jax"]
    assert results["port"][:2] == (45.0, 45.0)


def test_loop_restores_tensor_leaves_to_the_initial_variables_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, [torch.arange(3.0), np.asarray(5, np.int32)])
    seen = []

    def body(variables, epoch):
        seen.append((epoch, type(variables[0]).__name__, variables[0].device.type, int(variables[1])))
        return IterationBodyResult([variables[0] + 1, variables[1]], termination_criteria=epoch < 2)

    iterate_bounded_until_termination([torch.zeros(3), np.asarray(0, np.int32)], body,
                                      config=IterationConfig(checkpoint_manager=mgr))
    assert seen == [(2, "Tensor", "cpu", 5)]


# ---------------------------------------------------------------------------
# SGD's host loop: kill and resume
# ---------------------------------------------------------------------------


def _dense_data():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(128, 3)).astype(np.float32)
    return {"features": X, "labels": X @ np.asarray([1.0, -2.0, 0.5], np.float32)}


def _sparse_data():
    rng = np.random.default_rng(5)
    n, d, K = 160, 40, 6
    idx = rng.integers(0, d, size=(n, K)).astype(np.int32)
    val = rng.normal(size=(n, K)).astype(np.float32)
    val[rng.random((n, K)) < 0.2] = 0.0
    y = (rng.random(n) > 0.5).astype(np.float32)
    return {"indices": idx, "values": val, "labels": y}, d


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_sgd_kill_and_resume_is_bit_equal_to_the_fused_fit(layout, tmp_path, one_device_mesh):
    if layout == "dense":
        data, dim, loss, jloss = _dense_data(), 3, LeastSquareLoss.INSTANCE, JLeastSquareLoss.INSTANCE
    else:
        (data, dim), loss, jloss = _sparse_data(), BinaryLogisticLoss.INSTANCE, JBinaryLogisticLoss.INSTANCE
    kw = dict(max_iter=30, learning_rate=0.05, global_batch_size=32, tol=0.0)

    fused = SGD(device="cpu", **kw)
    coef_clean = fused.optimize(np.zeros(dim), data, loss)
    mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    failing = Recorder(fail_at=17)
    with pytest.raises(RuntimeError, match="injected failure"):
        SGD(device="cpu", checkpoint_manager=mgr, checkpoint_interval=5, listeners=[failing], **kw).optimize(
            np.zeros(dim), data, loss)
    assert mgr.all_steps() == [10, 15]
    resumed = SGD(device="cpu", checkpoint_manager=mgr, checkpoint_interval=5, **kw)
    coef_resumed = resumed.optimize(np.zeros(dim), data, loss)
    np.testing.assert_array_equal(coef_resumed, coef_clean)
    assert resumed.loss_history == fused.loss_history[15:]

    uninterrupted = SGD(device="cpu", listeners=[Recorder()], **kw)
    np.testing.assert_array_equal(uninterrupted.optimize(np.zeros(dim), data, loss), coef_clean)
    assert uninterrupted.loss_history == fused.loss_history

    jmgr = JCheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        JSGD(checkpoint_manager=jmgr, checkpoint_interval=5, listeners=[JRecorder(fail_at=17)], **kw).optimize(
            np.zeros(dim), data, jloss)
    coef_jax = JSGD(checkpoint_manager=jmgr, checkpoint_interval=5, **kw).optimize(np.zeros(dim), data, jloss)
    np.testing.assert_allclose(coef_resumed, coef_jax, rtol=0, atol=1e-6)
    assert failing.epochs == list(range(18))


def test_sgd_host_loop_with_tol_records_a_float_each_epoch_and_stops_as_the_fused_fit():
    data = _dense_data()
    kw = dict(max_iter=200, learning_rate=0.05, global_batch_size=32, tol=0.05, device="cpu")
    fused = SGD(**kw)
    coef = fused.optimize(np.zeros(3), data, LeastSquareLoss.INSTANCE)
    loop = SGD(listeners=[Recorder()], **kw)
    np.testing.assert_array_equal(loop.optimize(np.zeros(3), data, LeastSquareLoss.INSTANCE), coef)
    assert loop.loss_history == fused.loss_history
    assert len(loop.loss_history) < 200 and loop.loss_history[-1] < 0.05


def test_forced_onehot_with_a_manager_raises_as_the_jax_package(tmp_path, one_device_mesh):
    data, dim = _sparse_data()
    for Opt, Manager, loss in ((SGD, CheckpointManager, BinaryLogisticLoss.INSTANCE),
                               (JSGD, JCheckpointManager, JBinaryLogisticLoss.INSTANCE)):
        kw = {"device": "cpu"} if Opt is SGD else {}
        opt = Opt(max_iter=3, sparse_kernel="onehot", checkpoint_manager=Manager(str(tmp_path / Opt.__module__)),
                  checkpoint_interval=1, **kw)
        with pytest.raises(ValueError, match="runs only on the fused path"):
            opt.optimize(np.zeros(dim), data, loss)
