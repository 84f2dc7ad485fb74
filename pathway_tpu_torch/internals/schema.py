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


def import_pandas(what: str) -> Any:
    """pandas, imported when a pandas helper is called: the package itself
    never needs it (the GPU machine has none)."""
    try:
        import pandas
    except ImportError as exc:
        raise ImportError(f"{what} needs the pandas package, which is not installed") from exc
    return pandas


def schema_from_pandas(
    df: Any, *, id_from: list[str] | None = None, name: str = "Schema"
) -> SchemaMetaclass:
    """A schema of a DataFrame's columns, typed from their dtypes (an object
    column from its first non-null value)."""
    import numpy as np

    import_pandas("schema_from_pandas")
    columns: Dict[str, ColumnSchema] = {}
    for col in df.columns:
        np_dtype = df[col].dtype
        if np_dtype == np.int64:
            hint: Any = int
        elif np_dtype == np.float64:
            hint = float
        elif np_dtype == np.bool_:
            hint = bool
        elif str(np_dtype).startswith("datetime64"):
            hint = dt.DATE_TIME_NAIVE
        else:
            sample = df[col].dropna()
            hint = type(sample.iloc[0]) if len(sample) else Any
        columns[str(col)] = ColumnSchema(
            name=str(col), dtype=dt.wrap(hint), primary_key=bool(id_from and col in id_from)
        )
    return schema_from_columns(columns, name=name)


def schema_from_csv(
    path: str,
    *,
    name: str = "Schema",
    properties: Any = None,
    delimiter: str = ",",
    comment_character: str | None = None,
    quote: str = '"',
    double_quote_escapes: bool = True,
    num_parsed_rows: int | None = None,
) -> SchemaMetaclass:
    """A schema inferred from a CSV file's header and its first
    ``num_parsed_rows`` rows (all when None), read with the stdlib ``csv``:
    a column is int, else float, else bool, else str."""
    import csv

    rows: list[list[str]] = []
    header: list[str] | None = None
    with open(path, newline="") as f:
        for rec in csv.reader(f, delimiter=delimiter, quotechar=quote):
            if comment_character and rec and rec[0].startswith(comment_character):
                continue
            if header is None:
                header = rec
                continue
            rows.append(rec)
            if num_parsed_rows is not None and len(rows) >= num_parsed_rows:
                break
    if header is None:
        raise ValueError(f"empty csv file {path!r}")

    def parses(values: list[str], cast: Any) -> bool:
        try:
            for v in values:
                cast(v)
        except ValueError:
            return False
        return True

    def infer(values: list[str]) -> dt.DType:
        non_empty = [v for v in values if v != ""]
        if not non_empty:
            return dt.STR
        if parses(non_empty, int):
            return dt.INT
        if parses(non_empty, float):
            return dt.FLOAT
        if all(v in ("True", "False", "true", "false") for v in non_empty):
            return dt.BOOL
        return dt.STR

    columns = {
        h: ColumnSchema(h, infer([r[i] if i < len(r) else "" for r in rows]))
        for i, h in enumerate(header)
    }
    return schema_from_columns(columns, name=name)


def is_subschema(sub: SchemaMetaclass, sup: SchemaMetaclass) -> bool:
    """Whether every column of ``sub`` is in ``sup`` with a dtype ``sup``'s accepts."""
    sup_cols = sup.columns()
    return all(
        name in sup_cols and dt.dtype_issubclass(col.dtype, sup_cols[name].dtype)
        for name, col in sub.columns().items()
    )
