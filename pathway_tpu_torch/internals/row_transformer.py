"""Class-syntax row transformers, ``@pw.transformer`` (port of
``pathway_tpu/internals/row_transformer.py``).

A transformer is a class of ``ClassArg`` inner classes, one per input table.
Their ``input_attribute`` s read the row's columns, ``attribute`` s and
``output_attribute`` s compute from them, and a row may read any row of any
argument through ``self.transformer.<arg>[pointer]`` (pointer chasing). Each
argument gives one output table of its output attributes, with the input's
universe.

Its evaluator (``engine/evaluators.py``) keeps every input row and records,
for each output row, the input rows its computation read. A commit
re-evaluates only the rows it changed and the rows that read one of them,
and emits the difference against what it emitted before: the same update
stream as the reference's recompute-and-diff of every row.
"""

from __future__ import annotations

import inspect
import types
from typing import Any, Callable, Dict, List, Set, Tuple

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import Pointer, pointer_from
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

#: (class argument, row pointer): one input row
_RowId = Tuple[str, Pointer]


class _Attr:
    kind = "input"

    def __init__(self, fn: Callable | None = None, *, output_name: str | None = None, dtype: Any = None):
        self.fn = fn
        self.output_name = output_name
        self.name: str | None = None
        self.dtype = dtype

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name
        if self.output_name is None:
            self.output_name = name


class _InputAttribute(_Attr):
    kind = "input"


class _Attribute(_Attr):
    kind = "attribute"


class _OutputAttribute(_Attr):
    kind = "output"


class _Method(_Attr):
    kind = "method"


class _InputMethod(_Attr):
    kind = "input_method"


def input_attribute(dtype: Any = None) -> _InputAttribute:
    return _InputAttribute(dtype=dtype)


def input_method(dtype: Any = None) -> _InputMethod:
    return _InputMethod(dtype=dtype)


def attribute(fn: Callable) -> _Attribute:
    return _Attribute(fn)


def output_attribute(fn: Callable | None = None, *, output_name: str | None = None):
    if fn is not None:
        return _OutputAttribute(fn)

    def wrap(f: Callable) -> _OutputAttribute:
        return _OutputAttribute(f, output_name=output_name)

    return wrap


def method(fn: Callable | None = None, **kwargs: Any):
    if fn is not None:
        return _Method(fn)

    def wrap(f: Callable) -> _Method:
        return _Method(f, **kwargs)

    return wrap


class ClassArg:
    """Base class of a transformer's inner classes; ``output=`` declares the
    output table's schema."""

    def __init_subclass__(cls, input: Any = None, output: Any = None, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        cls._pw_attrs = {}
        for klass in reversed(cls.__mro__):
            for name, value in vars(klass).items():
                if isinstance(value, _Attr):
                    cls._pw_attrs[name] = value
        cls._pw_output_schema_decl = output


class _RowReference:
    """One row of a class argument during evaluation: attribute access reads
    the row's inputs, computes (memoized) derived attributes, and follows
    pointers into the other arguments through ``self.transformer``."""

    __slots__ = ("_run", "_arg_name", "_ptr")

    def __init__(self, run: "_TransformerRun", arg_name: str, ptr: Pointer):
        self._run = run
        self._arg_name = arg_name
        self._ptr = ptr

    @property
    def id(self) -> Pointer:
        return self._ptr

    @property
    def transformer(self) -> "_TransformerNamespace":
        return _TransformerNamespace(self._run)

    def pointer_from(self, *args: Any, optional: bool = False) -> Pointer:
        return pointer_from(*args)

    def __getattr__(self, name: str) -> Any:
        run = object.__getattribute__(self, "_run")
        arg_name = object.__getattribute__(self, "_arg_name")
        ptr = object.__getattribute__(self, "_ptr")
        cls = run.transformer.class_args[arg_name]
        attr = cls._pw_attrs.get(name)
        if attr is None:
            # plain class helpers: constants, methods, staticmethods
            value = getattr(cls, name)
            if callable(value) and not isinstance(_getattr_static(cls, name), staticmethod):
                return types.MethodType(value, self)
            return value
        if attr.kind in ("input", "input_method"):
            return run.input_value(arg_name, ptr, name)
        if attr.kind == "method":
            return lambda *args: attr.fn(self, *args)
        return run.computed_value(arg_name, ptr, name, attr.fn, self)


def _getattr_static(cls: type, name: str) -> Any:
    try:
        return inspect.getattr_static(cls, name)
    except AttributeError:
        return None


class _TransformerNamespace:
    """``self.transformer.<class_arg>[ptr]``."""

    def __init__(self, run: "_TransformerRun"):
        self._run = run

    def __getattr__(self, arg_name: str) -> "_ClassArgIndexer":
        if arg_name.startswith("_"):
            raise AttributeError(arg_name)
        return _ClassArgIndexer(self._run, arg_name)


class _ClassArgIndexer:
    def __init__(self, run: "_TransformerRun", arg_name: str):
        self._run = run
        self._arg_name = arg_name

    def __getitem__(self, ptr: Pointer) -> _RowReference:
        return _RowReference(self._run, self._arg_name, ptr)

    def __call__(self, ref: _RowReference, ptr: Pointer) -> _RowReference:
        return _RowReference(self._run, self._arg_name, ptr)


class _TransformerRun:
    """One commit's evaluation: the memo of computed attributes, each with
    the input rows it read, and the read sets of the computations open."""

    def __init__(self, transformer: "RowTransformer", rows: Dict[str, Dict[Pointer, dict]]):
        self.transformer = transformer
        self.rows = rows
        self.memo: Dict[tuple, Tuple[Any, Set[_RowId]]] = {}
        self._computing: set[tuple] = set()
        self._reads: List[Set[_RowId]] = []

    def input_value(self, arg_name: str, ptr: Pointer, name: str) -> Any:
        if self._reads:
            # a read of an absent row is a dependency too: its arrival re-evaluates
            self._reads[-1].add((arg_name, ptr))
        row = self.rows.get(arg_name, {}).get(ptr)
        if row is None:
            raise KeyError(f"transformer row {ptr!r} not found in {arg_name!r}")
        return row[name]

    def computed_value(
        self, arg_name: str, ptr: Pointer, name: str, fn: Callable, ref: _RowReference
    ) -> Any:
        key = (arg_name, ptr, name)
        hit = self.memo.get(key)
        if hit is None:
            if key in self._computing:
                raise RecursionError(f"cyclic attribute dependency at {arg_name}.{name}")
            self._computing.add(key)
            self._reads.append(set())
            try:
                value = fn(ref)
            finally:
                self._computing.discard(key)
                reads = self._reads.pop()
            hit = self.memo[key] = (value, reads)
        if self._reads:
            self._reads[-1] |= hit[1]
        return hit[0]

    def output_row(self, arg_name: str, ptr: Pointer) -> Tuple[dict, Set[_RowId]]:
        """The row's output attributes and the input rows they read."""
        cls = self.transformer.class_args[arg_name]
        ref = _RowReference(self, arg_name, ptr)
        self._reads.append({(arg_name, ptr)})
        try:
            row = {
                attr.output_name: self.computed_value(arg_name, ptr, attr.name, attr.fn, ref)
                for attr in cls._pw_attrs.values()
                if attr.kind == "output"
            }
        finally:
            reads = self._reads.pop()
        return row, reads


class RowTransformer:
    def __init__(self, name: str, class_args: Dict[str, type]):
        self.name = name
        self.class_args = class_args

    def __call__(self, *tables: Table, **named: Table) -> Any:
        arg_names = list(self.class_args)
        matched: Dict[str, Table] = dict(zip(arg_names, tables))
        matched.update(named)
        if set(matched) != set(arg_names):
            raise ValueError(
                f"transformer {self.name} expects tables {arg_names}, got {sorted(matched)}"
            )
        node = G.add_node(
            pg.RowTransformerNode(
                inputs=[matched[n] for n in arg_names],
                transformer=self,
                arg_names=arg_names,
            )
        )
        result = types.SimpleNamespace()
        first: Table | None = None
        for arg_name in arg_names:
            schema = self._output_schema(arg_name)
            if first is None:
                source = node
            else:
                source = G.add_node(
                    pg.RowTransformerResultNode(inputs=[first], parent=node, result_name=arg_name)
                )
            table = Table(
                source, schema, universe=matched[arg_name]._universe, name=f"{self.name}.{arg_name}"
            )
            first = first or table
            setattr(result, arg_name, table)
        return result

    def _output_schema(self, arg_name: str) -> sch.SchemaMetaclass:
        cls = self.class_args[arg_name]
        declared = getattr(cls, "_pw_output_schema_decl", None)
        declared_cols = declared.columns() if declared is not None else {}
        columns: Dict[str, sch.ColumnSchema] = {}
        for attr in cls._pw_attrs.values():
            if attr.kind == "output":
                decl = declared_cols.get(attr.output_name)
                dtype = decl.dtype if decl is not None else dt.ANY
                columns[attr.output_name] = sch.ColumnSchema(attr.output_name, dtype)
        missing = set(declared_cols) - set(columns)
        if missing:
            raise RuntimeError(
                f"output schema validation error: {arg_name} does not produce {sorted(missing)}"
            )
        return sch.schema_from_columns(columns, f"{self.name}.{arg_name}")


def transformer(cls: type) -> RowTransformer:
    """Decorator turning a class of ``ClassArg`` inner classes into a transformer."""
    class_args = {
        name: value
        for name, value in vars(cls).items()
        if isinstance(value, type) and issubclass(value, ClassArg)
    }
    if not class_args:
        raise ValueError("@transformer class must define ClassArg inner classes")
    t = RowTransformer(cls.__name__, class_args)
    # declared output schemas are checked when the class is made, as in the reference
    for arg_name in class_args:
        t._output_schema(arg_name)
    return t
