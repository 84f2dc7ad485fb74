"""``pw.this`` / ``pw.left`` / ``pw.right`` deferred column references
(port of ``pathway_tpu/internals/thisclass.py``).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr


class ThisWildcard:
    """Deferred "all columns of this table" marker (minus exclusions); expanded
    by ``Table.select`` (reference ``*pw.this`` / ``pw.this.without(...)``)."""

    def __init__(self, kind: type, exclude: tuple = ()):
        self._kind = kind
        self._exclude = tuple(exclude)

    def __iter__(self):
        # ``select(*pw.this.without(x))`` unpacks the wildcard itself
        return iter((self,))


class ThisMetaclass(type):
    def __getattr__(cls, name: str) -> "ThisColumnReference":
        if name.startswith("__"):
            raise AttributeError(name)
        return ThisColumnReference(cls, name)

    def __getitem__(cls, name: str) -> Any:
        if isinstance(name, (list, tuple)):
            return [ThisColumnReference(cls, n) for n in name]
        return ThisColumnReference(cls, name)

    def __iter__(cls):
        # ``select(*pw.this)``: every column of the operated-on table
        return iter((ThisWildcard(cls),))

    def without(cls, *columns: Any) -> ThisWildcard:
        names = tuple(
            c.name if hasattr(c, "name") and not isinstance(c, str) else str(c)
            for c in columns
        )
        return ThisWildcard(cls, names)


class this(metaclass=ThisMetaclass):
    """Deferred reference to "the table this operation applies to"."""


class left(metaclass=ThisMetaclass):
    """Deferred reference to the left side of a join."""


class right(metaclass=ThisMetaclass):
    """Deferred reference to the right side of a join."""


class ThisColumnReference(expr.ColumnExpression):
    def __init__(self, kind: type, name: str):
        self._kind = kind
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return f"pw.{self._kind.__name__}.{self._name}"

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(f"column {self._name!r} is not callable")


def substitute(e: Any, mapping: dict[type, Any]) -> Any:
    """Replace this/left/right references by concrete table column references.

    ``mapping`` maps the marker class (this/left/right) to a Table (or Joinable).
    """
    if not isinstance(e, expr.ColumnExpression):
        return e
    return _substitute(e, mapping)


def _substitute(e: expr.ColumnExpression, mapping: dict[type, Any]) -> expr.ColumnExpression:
    import copy

    if isinstance(e, ThisColumnReference):
        target = mapping.get(e._kind)
        if target is None:
            raise ValueError(f"cannot resolve {e!r} in this context")
        if e._name == "id":
            return target.id
        return target[e._name]
    if isinstance(e, expr.ColumnReference):
        # a reference to a this-substituted table may itself need rebinding when the
        # table participating in the op was replaced (e.g. ix); leave as-is
        return e
    clone = copy.copy(e)
    for attr, value in list(vars(e).items()):
        if isinstance(value, expr.ColumnExpression):
            setattr(clone, attr, _substitute(value, mapping))
        elif isinstance(value, tuple) and any(isinstance(v, expr.ColumnExpression) for v in value):
            setattr(
                clone,
                attr,
                tuple(
                    _substitute(v, mapping) if isinstance(v, expr.ColumnExpression) else v
                    for v in value
                ),
            )
        elif isinstance(value, dict) and any(
            isinstance(v, expr.ColumnExpression) for v in value.values()
        ):
            setattr(
                clone,
                attr,
                {
                    k: _substitute(v, mapping) if isinstance(v, expr.ColumnExpression) else v
                    for k, v in value.items()
                },
            )
    return clone
