"""The iteration loops — twin of ``flink_ml_tpu/iteration/iteration.py``.

Reference: ``Iterations.java:149`` (``iterateBoundedStreamsUntilTermination``)
and ``:123`` (``iterateUnboundedStreams``). The host loop is the aligner: an
epoch is one turn of the loop, the feedback edge is the rebinding of
``variables`` to the body's returned feedback (tensors stay on their
device). The bounded loop stops when the criteria is exhausted, when the
body produces no feedback, or at ``max_epochs``; the unbounded one
(``iterate_unbounded``) runs one epoch per batch of its stream and yields
each epoch's outputs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, List, Optional, Sequence

import torch

__all__ = [
    "OperatorLifeCycle",
    "IterationConfig",
    "IterationBodyResult",
    "IterationContext",
    "IterationListener",
    "Iterations",
    "ReplayableDataStreamList",
    "iterate_bounded_until_termination",
    "iterate_unbounded",
]


class OperatorLifeCycle(enum.Enum):
    """ALL_ROUND passes the same body callable every epoch, so its state
    carries across rounds; PER_ROUND treats ``body`` as a zero-argument
    factory called once per epoch, whose epoch body starts fresh every
    round (cross-round state flows through ``variables``)."""

    ALL_ROUND = "ALL_ROUND"
    PER_ROUND = "PER_ROUND"


@dataclasses.dataclass
class IterationConfig:
    """Ref IterationConfig.java.

    ``pipeline_depth``: the most epochs in flight on the device before the
    loop waits for the oldest. ``None`` = auto: 1 when the variables live
    on the CPU, 8 on a CUDA device; ``0`` = unbounded.
    """

    operator_life_cycle: OperatorLifeCycle = OperatorLifeCycle.ALL_ROUND
    max_epochs: Optional[int] = None  # hard bound on top of the criteria
    checkpoint_interval: int = 0  # epochs between snapshots; 0 = off
    #: a ``flink_ml_tpu_torch.checkpoint.CheckpointManager``
    checkpoint_manager: Any = None
    pipeline_depth: Optional[int] = None


class ReplayableDataStreamList:
    """Which data streams the body re-reads every epoch (``replay``) and
    which it sees only in epoch 0 (``no_replay``).

    A replayed source is re-materialised each epoch: a fresh iterator from a
    zero-argument factory, a capacity-tier cache (its ``iter_rows``), a
    DataFrame (one chunk of its columns), a list or tuple of chunks, or any
    other object as a one-chunk stream. A one-shot
    iterator cannot be replayed and raises ``TypeError``. A non-replayed
    source is empty after epoch 0.
    """

    def __init__(self, replay: Optional[dict] = None, no_replay: Optional[dict] = None):
        self._replay = dict(replay or {})
        self._no_replay = dict(no_replay or {})
        overlap = set(self._replay) & set(self._no_replay)
        if overlap:
            raise ValueError(f"streams marked both replay and no_replay: {overlap}")

    @staticmethod
    def _fresh_iterator(source, replayed: bool = True):
        if callable(source):
            return source()
        if hasattr(source, "iter_rows"):  # capacity-tier caches
            return source.iter_rows()
        if hasattr(source, "collect") and hasattr(source, "column"):  # DataFrame
            return iter([{n: source.column(n) for n in source.get_column_names()}])
        if hasattr(source, "__next__"):
            if replayed:
                raise TypeError(
                    "a one-shot iterator/generator is not replayable; pass a "
                    "zero-arg factory, a list of chunks, or a DataFrame"
                )
            return source
        if isinstance(source, (list, tuple)):
            return iter(source)
        return iter([source])

    def epoch_view(self, epoch: int) -> dict:
        """name → iterator for this epoch (non-replayed: empty past epoch 0)."""
        view = {name: self._fresh_iterator(src) for name, src in self._replay.items()}
        for name, src in self._no_replay.items():
            view[name] = self._fresh_iterator(src, replayed=False) if epoch == 0 else iter(())
        return view


class _NoCriteria:
    """Sentinel: the body declared no criteria stream."""


NO_CRITERIA = _NoCriteria()


@dataclasses.dataclass
class IterationBodyResult:
    """Ref IterationBodyResult.java.

    ``feedback_variables``: the variables' new values; ``None`` means no
    feedback and ends the iteration. ``termination_criteria``: truthy
    continues, falsy stops; a tensor is read when the loop tests it; the
    default ``NO_CRITERIA`` stops only on missing feedback or
    ``max_epochs``.
    """

    feedback_variables: Optional[Sequence[Any]]
    outputs: Sequence[Any] = ()
    termination_criteria: Any = NO_CRITERIA

    @property
    def has_criteria(self) -> bool:
        return self.termination_criteria is not NO_CRITERIA


class IterationListener:
    """Ref IterationListener.java: ``epoch_watermark`` is the epoch that
    just completed (0-based)."""

    def on_epoch_watermark_incremented(self, epoch_watermark: int, context: "IterationContext") -> None:
        pass

    def on_iteration_terminated(self, context: "IterationContext") -> None:
        pass


class IterationContext:
    """Collector handed to listeners; ``output`` appends to the iteration's outputs."""

    def __init__(self):
        self.collected: List[Any] = []

    def output(self, value: Any) -> None:
        self.collected.append(value)


def _tensors(tree):
    """The tensors of a tree of lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _cuda_device(tree) -> Optional[torch.device]:
    return next((t.device for t in _tensors(tree) if t.is_cuda), None)


class _PipelineThrottle:
    """Bounds the epochs in flight on the device (see IterationConfig): a
    CUDA event recorded after each epoch's launches, and the oldest waited
    on once ``depth`` are in flight. Work on the CPU is done when its call
    returns, so there nothing is ever in flight."""

    def __init__(self, depth: Optional[int]):
        self.depth = depth  # None: resolved from the first admitted variables
        self._inflight: List[torch.cuda.Event] = []

    def admit(self, variables) -> None:
        device = _cuda_device(variables)
        if self.depth is None:
            self.depth = 8 if device is not None else 1
        if self.depth <= 0 or device is None:
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._inflight.append(event)
        if len(self._inflight) >= self.depth:
            self._inflight.pop(0).synchronize()


def _epoch_body(body: Callable, config: IterationConfig) -> Callable:
    """The callable to run this epoch: ``body`` itself under ALL_ROUND, the
    fresh epoch body its factory builds under PER_ROUND."""
    if config.operator_life_cycle is not OperatorLifeCycle.PER_ROUND:
        return body
    fresh = body()
    if not callable(fresh):
        raise TypeError(
            "PER_ROUND lifecycle: the body must be a zero-arg factory "
            "returning the epoch body (forEachRound), got "
            f"{type(fresh).__name__} from {body!r}"
        )
    return fresh


def _criteria_continues(criteria: Any) -> bool:
    if criteria is None:
        return False
    if isinstance(criteria, torch.Tensor):
        criteria = criteria.item()
    return bool(criteria)


def iterate_bounded_until_termination(
    initial_variables: Sequence[Any],
    body: Callable[..., IterationBodyResult],
    config: Optional[IterationConfig] = None,
    listeners: Sequence[IterationListener] = (),
    data: Optional[ReplayableDataStreamList] = None,
) -> List[Any]:
    """Run ``body`` until termination; returns the final outputs.

    ``body(variables, epoch) -> IterationBodyResult``, or with ``data``
    ``body(variables, epoch, streams)``. With a checkpoint manager the run
    resumes from its newest intact snapshot (tensor leaves restored to the
    device of the initial variables' first tensor) and snapshots the
    variables every ``checkpoint_interval`` epochs while the criteria
    continues.
    """
    config = config or IterationConfig()
    context = IterationContext()
    throttle = _PipelineThrottle(config.pipeline_depth)
    variables = list(initial_variables)
    outputs: List[Any] = []
    epoch = 0

    restored = _maybe_restore(config, variables)
    if restored is not None:
        epoch, variables = restored

    while True:
        if config.max_epochs is not None and epoch >= config.max_epochs:
            break
        epoch_body = _epoch_body(body, config)
        if data is not None:
            result = epoch_body(variables, epoch, data.epoch_view(epoch))
        else:
            result = epoch_body(variables, epoch)
        if result.outputs:
            outputs = list(result.outputs)
        for listener in listeners:
            listener.on_epoch_watermark_incremented(epoch, context)
        epoch += 1
        if result.feedback_variables is None:
            break
        variables = list(result.feedback_variables)
        throttle.admit(variables)
        if result.has_criteria and not _criteria_continues(result.termination_criteria):
            break
        _maybe_checkpoint(config, epoch, variables)

    for listener in listeners:
        listener.on_iteration_terminated(context)
    return outputs + context.collected if context.collected else outputs


def iterate_unbounded(
    initial_variables: Sequence[Any],
    stream,
    body: Callable[..., IterationBodyResult],
    config: Optional[IterationConfig] = None,
    listeners: Sequence[IterationListener] = (),
):
    """Unbounded iteration (``Iterations.iterateUnboundedStreams``,
    Iterations.java:123): one epoch per batch of ``stream`` and no
    termination criteria — the iteration lives as long as its input.
    ``body(variables, batch, epoch)`` returns the feedback and the outputs,
    and this generator yields each epoch's outputs as the epoch ends (a
    versioned model stream). A body that returns no feedback ends it.

    Kill and resume: with a checkpoint manager the snapshot is ``(epoch,
    variables)``, and the epoch *is* the stream position (one batch an
    epoch). Each snapshot is taken before the epoch's outputs are yielded,
    so a resumed run never emits an epoch its consumer has seen. On restore
    the consumed prefix is skipped — ``stream.skip(n)`` where the source
    seeks, else by dropping ``n`` batches — so the resume contract is a
    source that replays from the beginning (or seeks); one that ends inside
    the prefix raises ``ValueError``.
    """
    config = config or IterationConfig()
    context = IterationContext()
    throttle = _PipelineThrottle(config.pipeline_depth)
    variables = list(initial_variables)
    epoch = 0
    restored = _maybe_restore(config, variables)
    if restored is not None:
        epoch, variables = restored
        if epoch:
            if hasattr(stream, "skip"):
                stream.skip(epoch)
            else:
                stream = _drop_batches(stream, epoch)

    for batch in stream:
        result = _epoch_body(body, config)(variables, batch, epoch)
        for listener in listeners:
            listener.on_epoch_watermark_incremented(epoch, context)
        epoch += 1
        done = result.feedback_variables is None
        if not done:
            variables = list(result.feedback_variables)
            throttle.admit(variables)
            _maybe_checkpoint(config, epoch, variables)
        for out in result.outputs:
            yield out
        while context.collected:
            yield context.collected.pop(0)
        if done:
            break

    for listener in listeners:
        listener.on_iteration_terminated(context)
    while context.collected:
        yield context.collected.pop(0)


def _drop_batches(stream, n: int):
    """A replayed source past its first ``n`` (consumed) batches. A source
    that ends inside them breaks the resume contract, and ending there
    would look like a clean run, so it raises ``ValueError``."""
    it = iter(stream)
    for i in range(n):
        try:
            next(it)
        except StopIteration:
            raise ValueError(
                f"replayed source ended {n - i} batch(es) before the checkpointed "
                f"offset {n}; on resume the source must replay the stream from "
                "the beginning"
            ) from None
    return it


def _maybe_checkpoint(config: IterationConfig, epoch: int, variables) -> None:
    mgr = config.checkpoint_manager
    if mgr is None or not config.checkpoint_interval:
        return
    if epoch % config.checkpoint_interval == 0:
        mgr.save(epoch, variables)


def _maybe_restore(config: IterationConfig, variables):
    mgr = config.checkpoint_manager
    if mgr is None:
        return None
    first = next(_tensors(variables), None)
    return mgr.restore_latest(device=None if first is None else first.device)


class Iterations:
    """Namespace parity with ``Iterations.java``'s static API."""

    iterate_bounded_streams_until_termination = staticmethod(iterate_bounded_until_termination)
    iterate_unbounded_streams = staticmethod(iterate_unbounded)
