"""The iteration runtime: the bounded and unbounded iteration loops, the
bounded one's termination criteria, the training-data caches (``datacache.DeviceDataCache`` on the
device, ``HostDataCache`` and ``create_capacity_cache`` on the host) and the
streamed-window loop (``streaming.WindowSchedule``, ``WindowedStream``)."""
from flink_ml_tpu_torch.iteration.iteration import (
    IterationBodyResult,
    IterationConfig,
    IterationListener,
    Iterations,
    OperatorLifeCycle,
    ReplayableDataStreamList,
    iterate_bounded_until_termination,
    iterate_unbounded,
)
from flink_ml_tpu_torch.iteration.termination import (
    TerminateOnMaxIter,
    TerminateOnMaxIterOrTol,
)
from flink_ml_tpu_torch.iteration.datacache import (
    DeviceDataCache,
    HostDataCache,
    create_capacity_cache,
)
from flink_ml_tpu_torch.iteration.streaming import WindowedStream, WindowSchedule

__all__ = [
    "IterationBodyResult",
    "IterationConfig",
    "IterationListener",
    "Iterations",
    "OperatorLifeCycle",
    "ReplayableDataStreamList",
    "iterate_bounded_until_termination",
    "iterate_unbounded",
    "TerminateOnMaxIter",
    "TerminateOnMaxIterOrTol",
    "DeviceDataCache",
    "HostDataCache",
    "create_capacity_cache",
    "WindowedStream",
    "WindowSchedule",
]
