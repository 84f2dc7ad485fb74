"""Immutable JSON value wrapper (metadata of documents and chunks)."""

from __future__ import annotations

import json as _json
from typing import Any

import numpy as np


class Json:
    """Immutable wrapper around a parsed JSON value, with indexing helpers."""

    __slots__ = ("_value",)

    NULL: "Json"

    def __init__(self, value: Any):
        if isinstance(value, Json):
            value = value._value
        object.__setattr__(self, "_value", value)

    def __setattr__(self, *a: Any) -> None:
        raise AttributeError("Json is immutable")

    @property
    def value(self) -> Any:
        return self._value

    @staticmethod
    def parse(text: str | bytes) -> "Json":
        return Json(_json.loads(text))

    def dumps(self) -> str:
        return _json.dumps(
            self._value, sort_keys=True, separators=(",", ":"), default=_jsonify
        )

    def __getitem__(self, item: Any) -> "Json":
        return Json(self._value[item])

    def get(self, key: Any, default: Any = None) -> Any:
        if isinstance(self._value, dict):
            result = self._value.get(key, default)
            return Json(result) if result is not default else default
        return default

    def as_int(self) -> int:
        return int(self._value)

    def as_float(self) -> float:
        return float(self._value)

    def as_str(self) -> str:
        return str(self._value)

    def as_bool(self) -> bool:
        if not isinstance(self._value, bool):
            raise ValueError(f"not a bool: {self._value!r}")
        return self._value

    def as_list(self) -> list:
        return list(self._value)

    def as_dict(self) -> dict:
        return dict(self._value)

    def __len__(self) -> int:
        return len(self._value)

    def __iter__(self):
        return (Json(v) for v in self._value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Json):
            return self._value == other._value
        return self._value == other

    def __hash__(self) -> int:
        return hash(self.dumps())

    def __repr__(self) -> str:
        return f"pw.Json({self._value!r})"

    def __str__(self) -> str:
        return self.dumps()


def _jsonify(value: Any) -> Any:
    if isinstance(value, Json):
        return value.value
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    raise TypeError(f"not JSON serializable: {type(value).__name__}")


def jsonable_value(v: Any) -> Any:
    """Recursively coerce Json, Pointer, numpy and tuple values to plain JSON."""
    if isinstance(v, Json):
        return jsonable_value(v.value)
    if isinstance(v, (tuple, list)):
        return [jsonable_value(x) for x in v]
    if isinstance(v, dict):
        return {k: jsonable_value(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return _jsonify(v)
    from pathway_tpu_torch.internals.keys import Pointer

    if isinstance(v, Pointer):
        return repr(v)
    return v


Json.NULL = Json(None)
