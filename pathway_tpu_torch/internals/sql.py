"""``pw.sql``: SQL queries over tables (port of ``pathway_tpu/internals/sql.py``).

Self-contained, with no sqlglot: a tokenizer and a recursive-descent parser
build a query AST (SELECT / DISTINCT, FROM with table aliases and
subqueries, INNER / LEFT / RIGHT / FULL JOIN ... ON, WHERE, GROUP BY,
HAVING, UNION [ALL]), and a planner lowers it onto the Table algebra:
equalities in ON become join conditions, the rest of ON filters the joined
rows, subqueries plan recursively, UNION is ``concat_reindex`` (+ distinct),
and column names resolve against the FROM scope, with an error for an
ambiguous one. Predicates: AND / OR / NOT, comparisons, IS [NOT] NULL,
[NOT] IN (...), [NOT] BETWEEN and [NOT] LIKE.
"""

from __future__ import annotations

import functools
import operator as op
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.joins import JoinKind
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table

# -- tokenizer --------------------------------------------------------------------

_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\d+)|(?P<str>'(?:''|[^'])*')"
    r"|(?P<id>[A-Za-z_][A-Za-z_0-9]*)|(?P<op><=|>=|<>|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.))"
)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "union", "all",
    "join", "inner", "left", "right", "full", "outer", "on", "as", "and", "or",
    "not", "is", "null", "in", "between", "like", "asc", "desc", "order",
}

_AGGS = {"count", "sum", "min", "max", "avg"}


class _Tokens:
    def __init__(self, text: str):
        self.toks: List[str] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if m is None:
                if text[pos:].strip() == "":
                    break
                raise ValueError(f"cannot tokenize SQL near {text[pos:pos+20]!r}")
            self.toks.append(m.group().strip())
            pos = m.end()
        self.pos = 0

    def peek(self, ahead: int = 0) -> Optional[str]:
        i = self.pos + ahead
        return self.toks[i] if i < len(self.toks) else None

    def peek_kw(self, *words: str) -> bool:
        tok = self.peek()
        return tok is not None and tok.lower() in words

    def next(self) -> str:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def accept_kw(self, *words: str) -> Optional[str]:
        if self.peek_kw(*words):
            return self.next().lower()
        return None

    def expect(self, word: str) -> None:
        tok = self.next() if self.pos < len(self.toks) else None
        if tok is None or tok.lower() != word.lower():
            raise ValueError(f"expected {word!r}, got {tok!r}")


# -- AST ---------------------------------------------------------------------------


@dataclass
class Ident:
    qualifier: Optional[str]
    name: str


@dataclass
class Literal:
    value: Any


@dataclass
class Star:
    qualifier: Optional[str] = None


@dataclass
class Unary:
    op: str  # "not" | "neg"
    operand: Any


@dataclass
class Binary:
    op: str
    left: Any
    right: Any


@dataclass
class Func:
    name: str
    args: List[Any]
    star: bool = False


@dataclass
class InList:
    operand: Any
    items: List[Any]
    negated: bool


@dataclass
class Between:
    operand: Any
    low: Any
    high: Any
    negated: bool


@dataclass
class Like:
    operand: Any
    pattern: str
    negated: bool


@dataclass
class IsNull:
    operand: Any
    negated: bool


@dataclass
class SelectItem:
    expression: Any
    alias: Optional[str]


@dataclass
class TableRef:
    name: Optional[str]  # None for subqueries
    subquery: Optional["Query"]
    alias: str


@dataclass
class Join:
    kind: str  # inner/left/right/outer
    table: TableRef
    on: Any


@dataclass
class Select:
    items: List[Any]  # SelectItem | Star
    distinct: bool
    base: TableRef
    joins: List[Join]
    where: Any
    group_by: List[Any]
    having: Any


@dataclass
class Query:
    selects: List[Select]  # UNION chain
    union_all: List[bool] = field(default_factory=list)  # per junction


# -- parser ------------------------------------------------------------------------


class _Parser:
    def __init__(self, text: str):
        self.t = _Tokens(text)

    def parse_query(self) -> Query:
        query = self.parse_subquery()
        if self.t.peek() is not None:
            raise ValueError(f"unexpected trailing SQL at {self.t.peek()!r}")
        return query

    def parse_select(self) -> Select:
        self.t.expect("select")
        distinct = self.t.accept_kw("distinct") is not None
        items: List[Any] = [self.parse_select_item()]
        while self.t.peek() == ",":
            self.t.next()
            items.append(self.parse_select_item())
        self.t.expect("from")
        base = self.parse_table_ref()
        joins: List[Join] = []
        while self.t.peek_kw("join", "inner", "left", "right", "full"):
            joins.append(self.parse_join())
        where = None
        if self.t.accept_kw("where"):
            where = self.parse_condition()
        group_by: List[Any] = []
        if self.t.accept_kw("group"):
            self.t.expect("by")
            group_by.append(self.parse_condition())
            while self.t.peek() == ",":
                self.t.next()
                group_by.append(self.parse_condition())
        having = None
        if self.t.accept_kw("having"):
            having = self.parse_condition()
        if self.t.peek_kw("order"):
            raise NotImplementedError(
                "ORDER BY has no meaning on an incremental table; use pw.Table.sort"
            )
        return Select(items, distinct, base, joins, where, group_by, having)

    def parse_select_item(self) -> Any:
        if self.t.peek() == "*":
            self.t.next()
            return Star()
        # qualified star: alias.*
        if (
            self.t.peek(1) == "."
            and self.t.peek(2) == "*"
            and self.t.peek() is not None
            and self.t.peek().lower() not in _KEYWORDS
        ):
            qualifier = self.t.next()
            self.t.next()
            self.t.next()
            return Star(qualifier)
        e = self.parse_condition()
        alias = None
        if self.t.accept_kw("as"):
            alias = self.t.next()
        elif (
            self.t.peek() is not None
            and re.fullmatch(r"[A-Za-z_]\w*", self.t.peek() or "")
            and (self.t.peek() or "").lower() not in _KEYWORDS
        ):
            alias = self.t.next()  # bare alias: SELECT a b
        return SelectItem(e, alias)

    def parse_table_ref(self) -> TableRef:
        if self.t.peek() == "(":
            self.t.next()
            sub = self.parse_subquery()
            self.t.expect(")")
            self.t.accept_kw("as")
            alias = self.t.next()
            return TableRef(None, sub, alias)
        name = self.t.next()
        alias = name
        if self.t.accept_kw("as"):
            alias = self.t.next()
        elif (
            self.t.peek() is not None
            and re.fullmatch(r"[A-Za-z_]\w*", self.t.peek() or "")
            and (self.t.peek() or "").lower() not in _KEYWORDS
        ):
            alias = self.t.next()
        return TableRef(name, None, alias)

    def parse_subquery(self) -> Query:
        selects = [self.parse_select()]
        union_all: List[bool] = []
        while self.t.accept_kw("union"):
            union_all.append(self.t.accept_kw("all") is not None)
            selects.append(self.parse_select())
        return Query(selects, union_all)

    def parse_join(self) -> Join:
        kind = "inner"
        kw = self.t.accept_kw("inner", "left", "right", "full")
        if kw in ("left", "right", "full"):
            kind = "outer" if kw == "full" else kw
            self.t.accept_kw("outer")
        self.t.expect("join")
        table = self.parse_table_ref()
        self.t.expect("on")
        on = self.parse_condition()
        return Join(kind, table, on)

    # expressions: or > and > not > comparison > add > mul > unary > atom
    def parse_condition(self) -> Any:
        left = self.parse_and()
        while self.t.accept_kw("or"):
            left = Binary("or", left, self.parse_and())
        return left

    def parse_and(self) -> Any:
        left = self.parse_not()
        while self.t.accept_kw("and"):
            left = Binary("and", left, self.parse_not())
        return left

    def parse_not(self) -> Any:
        if self.t.accept_kw("not"):
            return Unary("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self) -> Any:
        left = self.parse_add()
        if self.t.peek() in ("=", "<>", "!=", "<", "<=", ">", ">="):
            op = self.t.next()
            return Binary(op, left, self.parse_add())
        if self.t.peek_kw("is"):
            self.t.next()
            negated = self.t.accept_kw("not") is not None
            self.t.expect("null")
            return IsNull(left, negated)
        negated = False
        if self.t.peek_kw("not") and (self.t.peek(1) or "").lower() in ("in", "between", "like"):
            self.t.next()
            negated = True
        if self.t.accept_kw("in"):
            self.t.expect("(")
            items = [self.parse_add()]
            while self.t.peek() == ",":
                self.t.next()
                items.append(self.parse_add())
            self.t.expect(")")
            return InList(left, items, negated)
        if self.t.accept_kw("between"):
            low = self.parse_add()
            self.t.expect("and")
            high = self.parse_add()
            return Between(left, low, high, negated)
        if self.t.accept_kw("like"):
            pattern = self.t.next()
            if not pattern.startswith("'"):
                raise ValueError("LIKE requires a string literal pattern")
            return Like(left, pattern[1:-1].replace("''", "'"), negated)
        return left

    def parse_add(self) -> Any:
        left = self.parse_mul()
        while self.t.peek() in ("+", "-"):
            left = Binary(self.t.next(), left, self.parse_mul())
        return left

    def parse_mul(self) -> Any:
        left = self.parse_unary()
        while self.t.peek() in ("*", "/", "%"):
            left = Binary(self.t.next(), left, self.parse_unary())
        return left

    def parse_unary(self) -> Any:
        if self.t.peek() == "-":
            self.t.next()
            return Unary("neg", self.parse_unary())
        return self.parse_atom()

    def parse_atom(self) -> Any:
        tok = self.t.peek()
        if tok is None:
            raise ValueError("unexpected end of SQL")
        if tok == "(":
            self.t.next()
            e = self.parse_condition()
            self.t.expect(")")
            return e
        if re.fullmatch(r"\d+", tok):
            self.t.next()
            return Literal(int(tok))
        if re.fullmatch(r"\d+\.\d+", tok):
            self.t.next()
            return Literal(float(tok))
        if tok.startswith("'"):
            self.t.next()
            return Literal(tok[1:-1].replace("''", "'"))
        if tok.lower() == "null":
            self.t.next()
            return Literal(None)
        if tok.lower() in ("true", "false"):
            self.t.next()
            return Literal(tok.lower() == "true")
        # identifier / qualified identifier / function call
        name = self.t.next()
        if self.t.peek() == "(":
            self.t.next()
            if self.t.peek() == "*":
                self.t.next()
                self.t.expect(")")
                return Func(name.lower(), [], star=True)
            args = []
            if self.t.peek() != ")":
                args.append(self.parse_condition())
                while self.t.peek() == ",":
                    self.t.next()
                    args.append(self.parse_condition())
            self.t.expect(")")
            return Func(name.lower(), args)
        if self.t.peek() == ".":
            self.t.next()
            col = self.t.next()
            return Ident(name, col)
        return Ident(None, name)


# -- planner -----------------------------------------------------------------------


class _Scope:
    """FROM-clause name resolution: alias -> (Table, its column names)."""

    def __init__(self) -> None:
        self.order: List[str] = []
        self.tables: Dict[str, Table] = {}

    def add(self, alias: str, table: Table) -> None:
        if alias in self.tables:
            raise ValueError(f"duplicate table alias {alias!r}")
        self.order.append(alias)
        self.tables[alias] = table

    def resolve(self, ident: Ident) -> expr.ColumnReference:
        if ident.qualifier is not None:
            table = self.tables.get(ident.qualifier)
            if table is None:
                raise ValueError(f"unknown table alias {ident.qualifier!r}")
            return table[ident.name]
        hits = [
            alias
            for alias in self.order
            if ident.name in self.tables[alias].column_names()
        ]
        if not hits:
            raise ValueError(f"unknown column {ident.name!r}")
        if len(hits) > 1:
            raise ValueError(
                f"ambiguous column {ident.name!r} (in tables {hits}); qualify it"
            )
        return self.tables[hits[0]][ident.name]

    def all_columns(self, qualifier: Optional[str] = None) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = []
        aliases = [qualifier] if qualifier else self.order
        for alias in aliases:
            table = self.tables.get(alias)
            if table is None:
                raise ValueError(f"unknown table alias {alias!r}")
            for name in table.column_names():
                out.append((name, table[name]))
        return out


def _bind(node: Any, scope: _Scope) -> Any:
    """AST -> ColumnExpression against the scope."""
    if isinstance(node, Literal):
        return expr.ColumnConstExpression(node.value)
    if isinstance(node, Ident):
        return scope.resolve(node)
    if isinstance(node, Unary):
        operand = _bind(node.operand, scope)
        if node.op == "not":
            return expr.ColumnUnaryOpExpression(op.not_, operand)
        return expr.ColumnBinaryOpExpression(
            op.sub, expr.ColumnConstExpression(0), operand
        )
    if isinstance(node, Binary):
        mapping = {
            "=": op.eq, "<>": op.ne, "!=": op.ne, "<": op.lt, "<=": op.le,
            ">": op.gt, ">=": op.ge, "+": op.add, "-": op.sub, "*": op.mul,
            "/": op.truediv, "%": op.mod, "and": op.and_, "or": op.or_,
        }
        return expr.ColumnBinaryOpExpression(
            mapping[node.op], _bind(node.left, scope), _bind(node.right, scope)
        )
    if isinstance(node, Func):
        if node.name == "count" and node.star:
            return reducers.count()
        args = [_bind(a, scope) for a in node.args]
        if node.name in _AGGS:
            return getattr(reducers, node.name)(*args)
        if node.name == "coalesce":
            return expr.coalesce(*args)
        if node.name == "abs":
            return expr.apply_with_type(abs, float, *args)
        raise ValueError(f"unsupported SQL function {node.name!r}")
    if isinstance(node, InList):
        operand = _bind(node.operand, scope)
        comparisons = [
            expr.ColumnBinaryOpExpression(op.eq, operand, _bind(i, scope))
            for i in node.items
        ]
        out = functools.reduce(
            lambda a, b: expr.ColumnBinaryOpExpression(op.or_, a, b), comparisons
        )
        if node.negated:
            out = expr.ColumnUnaryOpExpression(op.not_, out)
        # NULL [NOT] IN (...) is NULL in SQL: the row is filtered either way
        return expr.ColumnBinaryOpExpression(op.and_, operand.is_not_none(), out)
    if isinstance(node, Between):
        operand = _bind(node.operand, scope)
        out = expr.ColumnBinaryOpExpression(
            op.and_,
            expr.ColumnBinaryOpExpression(op.ge, operand, _bind(node.low, scope)),
            expr.ColumnBinaryOpExpression(op.le, operand, _bind(node.high, scope)),
        )
        if node.negated:
            out = expr.ColumnUnaryOpExpression(op.not_, out)
        return out
    if isinstance(node, Like):
        operand = _bind(node.operand, scope)
        # % -> .* and _ -> ., everything else literal (SQL LIKE, not glob)
        regex = re.compile(
            "^"
            + "".join(
                ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                for ch in node.pattern
            )
            + "$",
            re.DOTALL,
        )
        negated = node.negated

        def like(v: Any) -> bool:
            if v is None:
                return False  # NULL [NOT] LIKE is NULL -> row filtered (SQL semantics)
            ok = regex.match(str(v)) is not None
            return (not ok) if negated else ok

        return expr.apply_with_type(like, bool, operand)
    if isinstance(node, IsNull):
        e = _bind(node.operand, scope)
        return e.is_not_none() if node.negated else e.is_none()
    raise ValueError(f"cannot bind SQL node {node!r}")


def _split_on_condition(on: Any) -> List[Any]:
    """Flatten an ON condition's top-level AND conjuncts."""
    if isinstance(on, Binary) and on.op == "and":
        return _split_on_condition(on.left) + _split_on_condition(on.right)
    return [on]


def _plan_table_ref(ref: TableRef, tables: Dict[str, Table]) -> Table:
    if ref.subquery is not None:
        return _plan_query(ref.subquery, tables)
    if ref.name not in tables:
        raise ValueError(f"unknown table {ref.name!r}")
    return tables[ref.name]


def _flatten_join(scope: _Scope) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """Materialize a multi-table scope into ONE table carrying every column,
    disambiguating clashes as alias_column."""
    taken: Dict[str, int] = {}
    exprs: Dict[str, Any] = {}
    rename: Dict[str, str] = {}  # "alias.col" -> flattened name
    for alias in scope.order:
        for col in scope.tables[alias].column_names():
            name = col if col not in taken else f"{alias}_{col}"
            while name in exprs:
                name = f"{name}_"
            taken[col] = taken.get(col, 0) + 1
            exprs[name] = scope.tables[alias][col]
            rename[f"{alias}.{col}"] = name
    return exprs, rename


def _plan_select(sel: Select, tables: Dict[str, Table]) -> Table:
    scope = _Scope()
    base = _plan_table_ref(sel.base, tables)
    scope.add(sel.base.alias, base)

    result = base
    for join in sel.joins:
        right = _plan_table_ref(join.table, tables)
        right_alias = join.table.alias
        join_scope = _Scope()
        for alias in scope.order:
            join_scope.add(alias, scope.tables[alias])
        join_scope.add(right_alias, right)
        # split ON into cross-side equi-conditions (join keys) and residual filters
        equi: List[Any] = []
        residual: List[Any] = []
        for conj in _split_on_condition(join.on):
            bound = None
            if isinstance(conj, Binary) and conj.op == "=":
                left_e = _bind(conj.left, join_scope)
                right_e = _bind(conj.right, join_scope)
                tabs_l = {id(r.table) for r in left_e._column_refs}
                tabs_r = {id(r.table) for r in right_e._column_refs}
                right_id = id(right)
                # a join key needs one side referencing ONLY the joined table and
                # the other referencing ONLY earlier tables; anything mixed is a
                # residual predicate
                l_only_right = tabs_l == {right_id}
                r_only_right = tabs_r == {right_id}
                l_no_right = bool(tabs_l) and right_id not in tabs_l
                r_no_right = bool(tabs_r) and right_id not in tabs_r
                if (l_only_right and r_no_right) or (r_only_right and l_no_right):
                    bound = expr.ColumnBinaryOpExpression(
                        op.eq, left_e, right_e
                    )
            if bound is not None:
                equi.append(bound)
            else:
                residual.append(conj)
        if not equi:
            raise ValueError(
                "JOIN ... ON needs at least one cross-table equality condition"
            )
        if residual and join.kind != "inner":
            raise NotImplementedError(
                "non-equality ON conditions are only supported for INNER JOIN"
            )
        kinds = {
            "inner": JoinKind.INNER, "left": JoinKind.LEFT,
            "right": JoinKind.RIGHT, "outer": JoinKind.OUTER,
        }
        jr = result.join(right, *equi, how=kinds[join.kind])
        # flatten: the joined table carries every visible column
        flat_scope = join_scope
        exprs, rename = _flatten_join(flat_scope)
        joined = jr.select(**exprs)
        if residual:
            res_scope = _AliasedScope(joined, rename, flat_scope)
            cond = None
            for conj in residual:
                bound = _bind(conj, res_scope)
                cond = bound if cond is None else expr.ColumnBinaryOpExpression(
                    op.and_, cond, bound
                )
            joined = joined.filter(cond)
        # the new scope: every original alias maps onto the flattened table through
        # per-alias column views
        new_scope = _Scope()
        new_scope.order = list(flat_scope.order)
        new_scope.tables = {
            alias: _AliasView(joined, {
                col: rename[f"{alias}.{col}"]
                for col in flat_scope.tables[alias].column_names()
            })
            for alias in flat_scope.order
        }
        scope = new_scope
        result = joined

    # WHERE
    if sel.where is not None:
        cond = _bind(sel.where, scope)
        filtered = result.filter(cond)
        scope = _rebased_scope(scope, result, filtered)
        result = filtered

    # SELECT list
    exprs: Dict[str, Any] = {}
    idx = 0
    for item in sel.items:
        if isinstance(item, Star):
            for name, e in scope.all_columns(item.qualifier):
                out_name = name
                while out_name in exprs:
                    out_name = out_name + "_"
                exprs[out_name] = e
            continue
        e = _bind(item.expression, scope)
        alias = item.alias
        if alias is None:
            if isinstance(item.expression, Ident):
                alias = item.expression.name
            else:
                alias = f"col_{idx}"
        exprs[alias] = e
        idx += 1

    group_exprs = [_bind(g, scope) for g in sel.group_by]
    having_e = _bind(sel.having, scope) if sel.having is not None else None

    has_aggs = any(_contains_reducer(e) for e in exprs.values()) or (
        having_e is not None and _contains_reducer(having_e)
    )
    if group_exprs or has_aggs:
        grouped = result.groupby(*group_exprs) if group_exprs else result.groupby()
        if having_e is not None:
            exprs["_pw_having"] = having_e
        out = grouped.reduce(**exprs)
        if having_e is not None:
            out = out.filter(out._pw_having).without("_pw_having")
    elif having_e is not None:
        raise ValueError("HAVING without aggregation; use WHERE")
    else:
        out = result.select(**exprs)

    if sel.distinct:
        out = _distinct(out)
    return out


class _AliasView:
    """A per-alias column view over a flattened join table (quacks like Table for
    scope resolution)."""

    def __init__(self, table: Table, mapping: Dict[str, str]):
        self._table = table
        self._mapping = mapping

    def column_names(self) -> List[str]:
        return list(self._mapping)

    def __getitem__(self, name: str) -> Any:
        return self._table[self._mapping[name]]


class _AliasedScope(_Scope):
    """Resolution over a flattened join for residual ON predicates."""

    def __init__(self, joined: Table, rename: Dict[str, str], base_scope: _Scope):
        super().__init__()
        for alias in base_scope.order:
            self.add(
                alias,
                _AliasView(joined, {
                    col: rename[f"{alias}.{col}"]
                    for col in base_scope.tables[alias].column_names()
                }),
            )


def _rebased_scope(scope: _Scope, old: Table, new: Table) -> _Scope:
    out = _Scope()
    out.order = list(scope.order)
    for alias in scope.order:
        t = scope.tables[alias]
        if isinstance(t, _AliasView):
            out.tables[alias] = _AliasView(
                new if t._table is old else t._table, t._mapping
            )
        else:
            out.tables[alias] = new if t is old else t
    return out


def _distinct(table: Table) -> Table:
    cols = [table[c] for c in table.column_names()]
    return table.groupby(*cols).reduce(
        **{c: table[c] for c in table.column_names()}
    )


def _plan_query(query: Query, tables: Dict[str, Table]) -> Table:
    parts = [_plan_select(s, tables) for s in query.selects]
    out = parts[0]
    for i, part in enumerate(parts[1:]):
        if len(part.column_names()) != len(out.column_names()):
            raise ValueError(
                "UNION requires the same number of columns "
                f"({len(out.column_names())} vs {len(part.column_names())})"
            )
        if out.column_names() != part.column_names():
            # UNION aligns by position (SQL semantics)
            mapping = dict(zip(part.column_names(), out.column_names()))
            part = part.select(**{mapping[c]: part[c] for c in part.column_names()})
        out = out.concat_reindex(part)
        if not query.union_all[i]:
            out = _distinct(out)
    return out


def sql(query: str, **tables: Table) -> Table:
    """Run a SQL query over the given tables (reference ``pw.sql``): SELECT
    [DISTINCT], table aliases, subqueries in FROM, INNER/LEFT/RIGHT/FULL JOIN ... ON,
    WHERE, GROUP BY, HAVING, UNION [ALL], and COUNT/SUM/MIN/MAX/AVG."""
    ast = _Parser(query).parse_query()
    return _plan_query(ast, tables)


def _contains_reducer(e: Any) -> bool:
    if isinstance(e, expr.ReducerExpression):
        return True
    if isinstance(e, expr.ColumnExpression):
        return any(_contains_reducer(d) for d in e._deps())
    return False
