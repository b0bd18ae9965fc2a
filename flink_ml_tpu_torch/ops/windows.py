"""Window descriptors — twin of ``flink_ml_tpu/ops/windows.py``.

Reference: ``flink-ml-core/.../common/window/Windows.java`` (GlobalWindows,
CountTumblingWindows, EventTimeTumblingWindows, EventTimeSessionWindows,
ProcessingTimeTumblingWindows, ProcessingTimeSessionWindows): value objects
that say how an unbounded stream is cut into mini-batches. Each window
``iteration/stream.py`` ``window_stream`` cuts is one training step; the
time-based ones read a timestamp column (or the arrival time).

``to_json_dict`` gives the JAX package's dicts key for key, so a param map
holding a descriptor serialises to the same JSON in both packages and
either package reads the other's.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "Windows",
    "GlobalWindows",
    "CountTumblingWindows",
    "EventTimeTumblingWindows",
    "ProcessingTimeTumblingWindows",
    "EventTimeSessionWindows",
    "ProcessingTimeSessionWindows",
]


class Windows:
    """Base descriptor; its JSON round trip is the param system's."""

    def to_json_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json_dict(payload: dict):
        """The descriptor a ``to_json_dict`` payload names, or None."""
        kind = payload.get("__type__")
        table = {
            "GlobalWindows": lambda p: GlobalWindows(),
            "CountTumblingWindows": lambda p: CountTumblingWindows(p["size"]),
            "EventTimeTumblingWindows": lambda p: EventTimeTumblingWindows(p["sizeMs"]),
            "ProcessingTimeTumblingWindows": lambda p: ProcessingTimeTumblingWindows(p["sizeMs"]),
            "EventTimeSessionWindows": lambda p: EventTimeSessionWindows(p["gapMs"]),
            "ProcessingTimeSessionWindows": lambda p: ProcessingTimeSessionWindows(p["gapMs"]),
        }
        if kind in table:
            return table[kind](payload)
        return None

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json_dict() == other.to_json_dict()

    def __hash__(self):
        return hash(tuple(sorted(self.to_json_dict().items())))


@dataclass(frozen=True, eq=False)
class GlobalWindows(Windows):
    """All input in one window that fires at the end of the stream
    (GlobalWindows.java, EndOfStreamWindows.java:36)."""

    def to_json_dict(self):
        return {"__type__": "GlobalWindows"}

    @staticmethod
    def get_instance() -> "GlobalWindows":
        return GlobalWindows()


@dataclass(frozen=True, eq=False)
class CountTumblingWindows(Windows):
    """Tumbling windows of ``size`` rows (CountTumblingWindows.java)."""

    size: int

    def to_json_dict(self):
        return {"__type__": "CountTumblingWindows", "size": self.size}

    @staticmethod
    def of(size: int) -> "CountTumblingWindows":
        return CountTumblingWindows(size)


@dataclass(frozen=True, eq=False)
class EventTimeTumblingWindows(Windows):
    """Tumbling windows of ``size_ms`` over the rows' event time."""

    size_ms: int

    def to_json_dict(self):
        return {"__type__": "EventTimeTumblingWindows", "sizeMs": self.size_ms}

    @staticmethod
    def of(size_ms: int) -> "EventTimeTumblingWindows":
        return EventTimeTumblingWindows(size_ms)


@dataclass(frozen=True, eq=False)
class ProcessingTimeTumblingWindows(Windows):
    """Tumbling windows of ``size_ms`` over the arrival time."""

    size_ms: int

    def to_json_dict(self):
        return {"__type__": "ProcessingTimeTumblingWindows", "sizeMs": self.size_ms}

    @staticmethod
    def of(size_ms: int) -> "ProcessingTimeTumblingWindows":
        return ProcessingTimeTumblingWindows(size_ms)


@dataclass(frozen=True, eq=False)
class EventTimeSessionWindows(Windows):
    """Sessions of event time closed by a gap over ``gap_ms``."""

    gap_ms: int

    def to_json_dict(self):
        return {"__type__": "EventTimeSessionWindows", "gapMs": self.gap_ms}

    @staticmethod
    def with_gap(gap_ms: int) -> "EventTimeSessionWindows":
        return EventTimeSessionWindows(gap_ms)


@dataclass(frozen=True, eq=False)
class ProcessingTimeSessionWindows(Windows):
    """Sessions of arrival time closed by a gap over ``gap_ms``."""

    gap_ms: int

    def to_json_dict(self):
        return {"__type__": "ProcessingTimeSessionWindows", "gapMs": self.gap_ms}

    @staticmethod
    def with_gap(gap_ms: int) -> "ProcessingTimeSessionWindows":
        return ProcessingTimeSessionWindows(gap_ms)
