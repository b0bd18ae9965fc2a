"""The iteration runtime: the bounded iteration loop, its termination
criteria and the training-data cache (``datacache.DeviceDataCache``)."""
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
from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache

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
]
