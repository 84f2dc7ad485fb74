"""Class-based schemas (port of ``pathway_tpu/internals/schema.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

from pathway_tpu_torch.internals import dtype as dt


@dataclass(frozen=True)
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = ...  # ... means no default
    dtype: Optional[dt.DType] = None
    name: Optional[str] = None

    @property
    def has_default(self) -> bool:
        return self.default_value is not ...


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = ...,
    dtype: Any = None,
    name: str | None = None,
) -> Any:
    """Declare per-column properties inside a Schema class body."""
    return ColumnDefinition(
        primary_key=primary_key,
        default_value=default_value,
        dtype=dt.wrap(dtype) if dtype is not None else None,
        name=name,
    )


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = ...

    @property
    def has_default(self) -> bool:
        return self.default_value is not ...


class SchemaMetaclass(type):
    _columns: Dict[str, ColumnSchema]

    def __init__(cls, name: str, bases: tuple, namespace: dict, **kwargs: Any) -> None:
        super().__init__(name, bases, namespace)
        columns: Dict[str, ColumnSchema] = {}
        for base in bases:
            columns.update(getattr(base, "_columns", {}))
        annotations = namespace.get("__annotations__", {})
        if any(isinstance(h, str) for h in annotations.values()):
            # postponed evaluation (`from __future__ import annotations`) leaves string
            # hints; resolve them with the stdlib resolver
            import typing

            try:
                hints = typing.get_type_hints(cls)
                annotations = {k: hints.get(k, v) for k, v in annotations.items()}
            except Exception:
                pass  # unresolvable forward refs fall through as raw strings
        for col_name, hint in annotations.items():
            if col_name.startswith("_"):
                continue
            definition = namespace.get(col_name)
            if isinstance(definition, ColumnDefinition):
                out_name = definition.name or col_name
                columns[out_name] = ColumnSchema(
                    name=out_name,
                    dtype=definition.dtype or dt.wrap(hint),
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                )
            else:
                columns[col_name] = ColumnSchema(name=col_name, dtype=dt.wrap(hint))
        cls._columns = columns

    def columns(cls) -> Dict[str, ColumnSchema]:
        return dict(cls._columns)

    def column_names(cls) -> list[str]:
        return list(cls._columns)

    def primary_key_columns(cls) -> list[str] | None:
        pkeys = [c.name for c in cls._columns.values() if c.primary_key]
        return pkeys or None

    def typehints(cls) -> Dict[str, Any]:
        return {n: c.dtype.typehint for n, c in cls._columns.items()}

    def dtypes(cls) -> Dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls._columns.items()}

    def default_values(cls) -> Dict[str, Any]:
        return {n: c.default_value for n, c in cls._columns.items() if c.has_default}

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        columns = dict(cls._columns)
        for name, col in other._columns.items():
            if name in columns and columns[name].dtype != col.dtype:
                raise TypeError(f"column {name!r} has conflicting dtypes in schema union")
            columns[name] = col
        return schema_from_columns(columns, name=f"{cls.__name__}|{other.__name__}")

    def with_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        columns = dict(cls._columns)
        for name, hint in kwargs.items():
            if name not in columns:
                raise ValueError(f"unknown column {name!r}")
            old = columns[name]
            columns[name] = ColumnSchema(name, dt.wrap(hint), old.primary_key, old.default_value)
        return schema_from_columns(columns, name=cls.__name__)

    def without(cls, *names: str) -> "SchemaMetaclass":
        columns = {n: c for n, c in cls._columns.items() if n not in names}
        return schema_from_columns(columns, name=cls.__name__)

    def update_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        return cls.with_types(**kwargs)

    def __repr__(cls) -> str:
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls._columns.items())
        return f"<Schema {cls.__name__}({cols})>"


class Schema(metaclass=SchemaMetaclass):
    """Subclass with annotations to declare a table schema::

        class InputSchema(pw.Schema):
            name: str
            age: int
    """


def schema_from_columns(
    columns: Mapping[str, ColumnSchema], name: str = "Schema"
) -> SchemaMetaclass:
    cls = SchemaMetaclass(name, (Schema,), {})
    cls._columns = dict(columns)
    return cls


def schema_from_types(_name: str = "Schema", **kwargs: Any) -> SchemaMetaclass:
    """Build a schema from ``column=type`` kwargs (reference ``schema_from_types``)."""
    columns = {n: ColumnSchema(n, dt.wrap(t)) for n, t in kwargs.items()}
    return schema_from_columns(columns, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any], *, name: str = "Schema"
) -> SchemaMetaclass:
    out: Dict[str, ColumnSchema] = {}
    for col_name, spec in columns.items():
        if isinstance(spec, dict):
            out[col_name] = ColumnSchema(
                name=col_name,
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", ...),
            )
        else:
            out[col_name] = ColumnSchema(name=col_name, dtype=dt.wrap(spec))
    return schema_from_columns(out, name=name)


def schema_builder(
    columns: Mapping[str, ColumnDefinition | Any],
    *,
    name: str = "Schema",
    properties: Any = None,
) -> SchemaMetaclass:
    out: Dict[str, ColumnSchema] = {}
    for col_name, definition in columns.items():
        if isinstance(definition, ColumnDefinition):
            out_name = definition.name or col_name
            out[out_name] = ColumnSchema(
                name=out_name,
                dtype=definition.dtype or dt.ANY,
                primary_key=definition.primary_key,
                default_value=definition.default_value,
            )
        else:
            out[col_name] = ColumnSchema(name=col_name, dtype=dt.wrap(definition))
    return schema_from_columns(out, name=name)
