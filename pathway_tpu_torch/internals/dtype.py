"""Data-type lattice of the engine (port of ``pathway_tpu/internals/dtype.py``).

Every dtype knows its numpy storage dtype on the host and whether its columns
can live on the port's device as dense torch tensors.
"""

from __future__ import annotations

import datetime
from abc import ABC
from typing import Any, Optional, Tuple, get_args, get_origin

import numpy as np


class DType(ABC):
    """Base of the dtype lattice."""

    _name: str = "DType"

    @property
    def np_dtype(self) -> np.dtype:
        """Numpy storage dtype for a column of this type (object for boxed values)."""
        return np.dtype(object)

    @property
    def is_device_friendly(self) -> bool:
        """True when columns of this dtype can live on the device as dense torch tensors."""
        return False

    def is_optional(self) -> bool:
        return False

    def strip_optional(self) -> "DType":
        return self

    @property
    def typehint(self) -> Any:
        return Any

    def __repr__(self) -> str:
        return self._name

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self.__dict__ == getattr(other, "__dict__", None)

    def __hash__(self) -> int:
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items(), key=str))))


class _SimpleDType(DType):
    def __init__(self, name: str, np_dtype: np.dtype, device_friendly: bool, typehint: Any):
        self._name = name
        self._np = np.dtype(np_dtype)
        self._device = device_friendly
        self._hint = typehint

    @property
    def np_dtype(self) -> np.dtype:
        return self._np

    @property
    def is_device_friendly(self) -> bool:
        return self._device

    @property
    def typehint(self) -> Any:
        return self._hint


NONE = _SimpleDType("NONE", object, False, type(None))
BOOL = _SimpleDType("BOOL", np.bool_, True, bool)
INT = _SimpleDType("INT", np.int64, True, int)
FLOAT = _SimpleDType("FLOAT", np.float64, True, float)
STR = _SimpleDType("STR", object, False, str)
BYTES = _SimpleDType("BYTES", object, False, bytes)
ANY = _SimpleDType("ANY", object, False, Any)
DATE_TIME_NAIVE = _SimpleDType("DATE_TIME_NAIVE", "datetime64[ns]", False, np.datetime64)
DATE_TIME_UTC = _SimpleDType("DATE_TIME_UTC", "datetime64[ns]", False, np.datetime64)
DURATION = _SimpleDType("DURATION", "timedelta64[ns]", False, np.timedelta64)


class _JsonDType(DType):
    _name = "JSON"

    @property
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.json import Json

        return Json


JSON = _JsonDType()


class Pointer(DType):
    """128-bit row reference (reference: ``Value::Pointer`` / ``api.Pointer``)."""

    def __init__(self, *args: DType):
        self.args: Tuple[DType, ...] = tuple(args)
        self._name = "POINTER" if not args else f"Pointer({', '.join(map(repr, args))})"

    @property
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.keys import Pointer as PointerValue

        return PointerValue


POINTER = Pointer()


class Optional_(DType):
    def __init__(self, wrapped: DType):
        if isinstance(wrapped, Optional_):
            wrapped = wrapped.wrapped
        self.wrapped = wrapped
        self._name = f"Optional({wrapped!r})"

    def is_optional(self) -> bool:
        return True

    def strip_optional(self) -> DType:
        return self.wrapped

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(object)

    @property
    def typehint(self) -> Any:
        return Optional[self.wrapped.typehint]


class Array(DType):
    """N-dim numeric array column (reference ``Type::Array``); device friendly."""

    def __init__(self, n_dim: int | None = None, wrapped: DType = FLOAT):
        self.n_dim = n_dim
        self.wrapped = wrapped
        self._name = f"Array({n_dim}, {wrapped!r})"

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(object)  # ragged rows boxed; dense path promotes to device

    @property
    def is_device_friendly(self) -> bool:
        return True

    @property
    def typehint(self) -> Any:
        return np.ndarray


ANY_ARRAY = Array(None, ANY)
INT_ARRAY = Array(None, INT)
FLOAT_ARRAY = Array(None, FLOAT)


class Tuple_(DType):
    def __init__(self, *args: DType):
        self.args = tuple(args)
        self._name = f"Tuple({', '.join(map(repr, args))})"

    @property
    def typehint(self) -> Any:
        return tuple


ANY_TUPLE = Tuple_(ANY)


class List_(DType):
    def __init__(self, wrapped: DType = ANY):
        self.wrapped = wrapped
        self._name = f"List({wrapped!r})"

    @property
    def typehint(self) -> Any:
        return tuple


class Callable_(DType):
    def __init__(self, arg_types: Any = ..., return_type: DType = ANY):
        self.arg_types = arg_types
        self.return_type = return_type
        self._name = "Callable"


class Future(DType):
    """Result of an async UDF not yet awaited (reference ``Type::Future``)."""

    def __init__(self, wrapped: DType):
        self.wrapped = wrapped
        self._name = f"Future({wrapped!r})"


def wrap(input_type: Any) -> DType:
    """Map a python typehint to a DType (reference ``dtype.wrap``)."""
    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.internals.keys import Pointer as PointerValue

    if isinstance(input_type, DType):
        return input_type
    if input_type is None or input_type is type(None):
        return NONE
    if input_type is bool or input_type is np.bool_:
        return BOOL
    if input_type is int or input_type in (np.int32, np.int64):
        return INT
    if input_type is float or input_type in (np.float32, np.float64):
        return FLOAT
    if input_type is str:
        return STR
    if input_type is bytes:
        return BYTES
    if input_type is datetime.datetime:
        return DATE_TIME_NAIVE
    if input_type is datetime.timedelta:
        return DURATION
    if input_type is Json or input_type is dict:
        return JSON
    if input_type is PointerValue:
        return POINTER
    if input_type is np.ndarray:
        return ANY_ARRAY
    if input_type is Any:
        return ANY
    origin = get_origin(input_type)
    if origin is not None:
        args = get_args(input_type)
        if origin is tuple:
            if len(args) == 2 and args[1] is Ellipsis:
                return List_(wrap(args[0]))
            return Tuple_(*(wrap(a) for a in args))
        if origin is list:
            return List_(wrap(args[0]) if args else ANY)
        # typing.Optional / Union
        import typing

        if origin is typing.Union or str(origin) in ("typing.Union", "types.UnionType"):
            non_none = [a for a in args if a is not type(None)]
            if len(non_none) == 1 and len(args) == 2:
                return Optional_(wrap(non_none[0]))
            return ANY
    if isinstance(input_type, type) and issubclass(input_type, PointerValue):
        return POINTER
    return ANY


def unoptionalize(dtype: DType) -> DType:
    return dtype.strip_optional()


def types_lca(a: DType, b: DType, raising: bool = False) -> DType:
    """Least common ancestor in the lattice (reference ``dtype.types_lca``)."""
    if a == b:
        return a
    if a == NONE:
        return b if b.is_optional() or b in (ANY, NONE) else Optional_(b)
    if b == NONE:
        return a if a.is_optional() or a in (ANY, NONE) else Optional_(a)
    if a.is_optional() or b.is_optional():
        inner = types_lca(unoptionalize(a), unoptionalize(b), raising=raising)
        return inner if inner == ANY else Optional_(inner)
    if {a, b} == {INT, FLOAT}:
        return FLOAT
    if isinstance(a, Pointer) and isinstance(b, Pointer):
        return POINTER
    if isinstance(a, Array) and isinstance(b, Array):
        return ANY_ARRAY
    if isinstance(a, (Tuple_, List_)) and isinstance(b, (Tuple_, List_)):
        return ANY_TUPLE
    if raising:
        raise TypeError(f"no common supertype of {a!r} and {b!r}")
    return ANY


def dtype_issubclass(sub: DType, sup: DType) -> bool:
    if sup == ANY or sub == sup:
        return True
    if sub == NONE:
        return sup.is_optional() or sup == NONE
    if sup.is_optional():
        return dtype_issubclass(unoptionalize(sub), unoptionalize(sup))
    if sub.is_optional():
        return False
    if sub == INT and sup == FLOAT:
        return True
    if isinstance(sub, Pointer) and isinstance(sup, Pointer) and sup == POINTER:
        return True
    if isinstance(sub, Array) and isinstance(sup, Array):
        return True
    if isinstance(sub, (Tuple_, List_)) and sup in (ANY_TUPLE,):
        return True
    return False
