"""Param / WithParams / ParamValidators (twin of ``flink_ml_tpu/params/param.py``).

Reference semantics preserved (flink-ml-servable-core/.../param/):
  - ``Param`` is a typed descriptor {name, description, default, validator} that can
    JSON-encode/decode its value (Param.java).
  - ``WithParams`` stages hold a param_map; ``get`` falls back to the default;
    ``set`` validates (WithParams.java default methods).
  - Params are declared as *class attributes* on stages/mixins; ``get_param_map``
    discovers them by walking the MRO (the analogue of the reference's reflection
    over public static Param fields, ParamUtils.java).
  - Validators mirror ParamValidators.java (gt, gtEq, lt, ltEq, inRange, inArray,
    notNull, nonEmptyArray, isSubSet).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, TypeVar

import numpy as np

from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector, Vector
from flink_ml_tpu_torch.ops.windows import Windows

T = TypeVar("T")

__all__ = [
    "Param",
    "ParamValidators",
    "WithParams",
    "BoolParam",
    "IntParam",
    "FloatParam",
    "StringParam",
    "ArrayParam",
    "IntArrayParam",
    "FloatArrayParam",
    "StringArrayParam",
    "VectorParam",
]


class ParamValidators:
    """Factory of validation predicates. Ref ParamValidators.java."""

    @staticmethod
    def always_true() -> Callable[[Any], bool]:
        return lambda v: True

    @staticmethod
    def gt(lower) -> Callable[[Any], bool]:
        return lambda v: v is not None and v > lower

    @staticmethod
    def gt_eq(lower) -> Callable[[Any], bool]:
        return lambda v: v is not None and v >= lower

    @staticmethod
    def lt(upper) -> Callable[[Any], bool]:
        return lambda v: v is not None and v < upper

    @staticmethod
    def lt_eq(upper) -> Callable[[Any], bool]:
        return lambda v: v is not None and v <= upper

    @staticmethod
    def in_range(lower, upper, lower_inclusive=True, upper_inclusive=True) -> Callable[[Any], bool]:
        def check(v):
            if v is None:
                return False
            ok_low = v >= lower if lower_inclusive else v > lower
            ok_up = v <= upper if upper_inclusive else v < upper
            return ok_low and ok_up

        return check

    @staticmethod
    def in_array(allowed: Sequence[Any]) -> Callable[[Any], bool]:
        allowed = list(allowed)
        return lambda v: v in allowed

    @staticmethod
    def not_null() -> Callable[[Any], bool]:
        return lambda v: v is not None

    @staticmethod
    def non_empty_array() -> Callable[[Any], bool]:
        return lambda v: v is not None and len(v) > 0

    @staticmethod
    def is_sub_set(allowed: Sequence[Any]) -> Callable[[Any], bool]:
        allowed_set = set(allowed)
        return lambda v: v is not None and set(v) <= allowed_set


class Param(Generic[T]):
    """Definition of a parameter. Ref Param.java."""

    def __init__(
        self,
        name: str,
        description: str,
        default_value: Optional[T] = None,
        validator: Callable[[Any], bool] = None,
    ):
        self.name = name
        self.description = description
        self.validator = validator or ParamValidators.always_true()
        if default_value is not None and not self.validator(default_value):
            raise ValueError(f"Invalid default value {default_value!r} for param {name}")
        self.default_value = default_value

    # JSON round-trip. Ref Param.jsonEncode/jsonDecode.
    def json_encode(self, value: T) -> Any:
        return _json_encode_value(value)

    def json_decode(self, payload: Any) -> T:
        return _json_decode_value(payload)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class BoolParam(Param[bool]):
    pass


class IntParam(Param[int]):
    pass


class FloatParam(Param[float]):
    def json_decode(self, payload):
        return None if payload is None else float(payload)


class StringParam(Param[str]):
    pass


class ArrayParam(Param[list]):
    def json_decode(self, payload):
        return None if payload is None else list(payload)


class IntArrayParam(ArrayParam):
    pass


class FloatArrayParam(ArrayParam):
    def json_decode(self, payload):
        return None if payload is None else [float(v) for v in payload]


class StringArrayParam(ArrayParam):
    pass


class VectorParam(Param[Vector]):
    def json_decode(self, payload):
        # Accept the reference's jackson shapes too: a bare {"values": ...}
        # ({"size", "indices", "values"} for sparse) or a plain list — its
        # benchmark configs carry vector params that way.
        if isinstance(payload, dict) and "__type__" not in payload:
            if "indices" in payload:
                missing = {"size", "indices", "values"} - payload.keys()
                if missing:
                    raise ValueError(
                        f"sparse vector param {self.name!r} needs keys "
                        f"size/indices/values; missing {sorted(missing)}"
                    )
                return SparseVector(payload["size"], payload["indices"], payload["values"])
            if "values" in payload:
                return DenseVector(payload["values"])
        if isinstance(payload, (list, tuple)):
            return DenseVector(payload)
        return _json_decode_value(payload)


def _json_encode_value(value: Any) -> Any:
    if isinstance(value, DenseVector):
        return {"__type__": "DenseVector", "values": value.values.tolist()}
    if isinstance(value, SparseVector):
        return {
            "__type__": "SparseVector",
            "size": value.n,
            "indices": value.indices.tolist(),
            "values": value.values.tolist(),
        }
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (list, tuple)):
        return [_json_encode_value(v) for v in value]
    if isinstance(value, Windows):
        return value.to_json_dict()
    return value


def _json_decode_value(payload: Any) -> Any:
    if isinstance(payload, dict) and "__type__" in payload:
        t = payload["__type__"]
        if t == "DenseVector":
            return DenseVector(payload["values"])
        if t == "SparseVector":
            return SparseVector(payload["size"], payload["indices"], payload["values"])
        decoded = Windows.from_json_dict(payload)
        if decoded is not None:
            return decoded
    if isinstance(payload, list):
        return [_json_decode_value(v) for v in payload]
    return payload


class WithParams:
    """Mixin giving a stage typed, validated, JSON-serializable params.

    Ref WithParams.java — the default get/set via getParamMap, plus the reflection-based
    param discovery from ParamUtils.java, realized here as an MRO walk over class
    attributes of type ``Param``.
    """

    def __init__(self, **kwargs):
        self._param_map: Dict[Param, Any] = {}
        for p in self._declared_params():
            self._param_map[p] = copy.deepcopy(p.default_value)
        for name, value in kwargs.items():
            self.set(self._param_by_name(name), value)

    @classmethod
    def _declared_params(cls) -> List[Param]:
        seen: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for attr in vars(klass).values():
                if isinstance(attr, Param):
                    seen[attr.name] = attr
        return list(seen.values())

    def _param_by_name(self, name: str) -> Param:
        for p in self._param_map:
            if p.name == name:
                return p
        raise KeyError(f"Stage {type(self).__name__} has no param named {name!r}")

    def get_param(self, name: str) -> Param:
        """Ref WithParams.getParam(String)."""
        return self._param_by_name(name)

    def get(self, param: Param) -> Any:
        if param not in self._param_map:
            raise KeyError(f"Param {param.name} is not defined on {type(self).__name__}")
        return self._param_map[param]

    def set(self, param: Param, value: Any) -> "WithParams":
        if param not in self._param_map:
            raise KeyError(f"Param {param.name} is not defined on {type(self).__name__}")
        if not param.validator(value):
            # Ref WithParams.java set(): the validator always runs, including on null.
            if value is None:
                raise ValueError(f"Parameter {param.name}'s value should not be null")
            raise ValueError(f"Parameter {param.name} is given an invalid value {value!r}")
        self._param_map[param] = value
        return self

    def get_param_map(self) -> Dict[Param, Any]:
        """Ref WithParams.getParamMap."""
        return self._param_map

    # --- persistence helpers --------------------------------------------------
    def param_map_to_json(self) -> Dict[str, Any]:
        return {p.name: p.json_encode(v) for p, v in self._param_map.items()}

    def load_param_map_from_json(self, payload: Dict[str, Any]) -> None:
        for name, encoded in payload.items():
            p = self._param_by_name(name)
            self._param_map[p] = p.json_decode(encoded)


def update_existing_params(target: WithParams, source: WithParams) -> None:
    """Copy every param value from ``source`` that ``target`` also declares.

    Ref ParamUtils.updateExistingParams — how an Estimator pushes its params onto the
    Model it produces (e.g. KMeans.fit → KMeansModel). Goes through ``target.set``
    so the target's validators run, and deep-copies so mutable values (arrays,
    vectors) are never aliased between source and target."""
    by_name = {p.name: v for p, v in source.get_param_map().items()}
    for p in list(target.get_param_map()):
        if p.name in by_name:
            target.set(p, copy.deepcopy(by_name[p.name]))
