"""Fixed-point iteration: ``pw.iterate`` (port of ``pathway_tpu/internals/iterate.py``).

The iteration body is built once, into a nested graph of its own. Each outer
commit that changes an input runs that graph to its fixed point in a nested
runner: the inputs' full state is fed in, and each round feeds back the
difference between an iterated table and its input, until no fed-back table
changes (or ``iteration_limit`` applications of the body). The outputs are
emitted as the difference from what the previous commit emitted. Used by
``pw.stdlib.graphs.bellman_ford``, ``pw.statistical.interpolate`` and the
sorted-index helpers.

The body may read only the tables passed to ``iterate``: a table of the
outer graph read from inside the body raises (pass it as an argument).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from pathway_tpu_torch.engine.columnar import Delta, StateTable
from pathway_tpu_torch.engine.datasource import DataSource
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


class _ManualSource(DataSource):
    """Nested-graph input fed by the iterate evaluator."""

    def __init__(self) -> None:
        self.queue: List[Delta] = []

    def feed(self, delta: Delta) -> None:
        self.queue.append(delta)

    def next_batch(self, column_names: List[str]) -> Delta:
        if self.queue:
            return self.queue.pop(0)
        return Delta.empty(column_names)

    def is_finished(self) -> bool:
        return False


def iteration_limit(table: Table, limit: int) -> Table:
    table._iteration_limit = limit  # type: ignore[attr-defined]
    return table


def iterate(
    func: Callable,
    iteration_limit: int | None = None,
    **kwargs: Any,
) -> Any:
    """Iterate ``func`` to a fixed point over the tables passed as kwargs.

    ``func`` receives proxy tables and returns a table, a dict or a
    namespace of tables; a returned name equal to an argument's name is fed
    back. Returns the final table, or an object with the final tables as
    attributes."""
    if iteration_limit is not None and iteration_limit < 1:
        raise ValueError("iteration_limit must be a positive integer")
    table_args = {k: v for k, v in kwargs.items() if isinstance(v, Table)}
    const_args = {k: v for k, v in kwargs.items() if not isinstance(v, Table)}

    inner_graph = pg.ParseGraph()
    saved = G._current
    proxies: Dict[str, Table] = {}
    try:
        G._current = inner_graph
        sources: Dict[str, _ManualSource] = {}
        for name, t in table_args.items():
            src = _ManualSource()
            sources[name] = src
            node = inner_graph.add_node(pg.InputNode(source=src, name=f"iterate:{name}"))
            proxies[name] = Table(node, t._schema, name=f"iterate:{name}")
        result = func(**proxies, **const_args)
        if isinstance(result, Table):
            result_map = {"result": result}
            single = True
        elif isinstance(result, dict):
            result_map = dict(result)
            single = False
        elif hasattr(result, "_asdict"):
            result_map = dict(result._asdict())
            single = False
        else:
            result_map = {k: v for k, v in vars(result).items() if isinstance(v, Table)}
            single = False
    finally:
        G._current = saved
    _check_closed(inner_graph, result_map)

    node = G.add_node(
        pg.IterateNode(
            inputs=list(table_args.values()),
            input_names=list(table_args.keys()),
            inner_graph=inner_graph,
            sources=sources,
            result_map=result_map,
            iteration_limit=iteration_limit,
        )
    )
    # the IterateNode emits the first result; the others get reader nodes
    first_name = next(iter(result_map))
    out_tables: Dict[str, Table] = {}
    primary = Table(node, result_map[first_name]._schema, name=f"iterate_out:{first_name}")
    out_tables[first_name] = primary
    for name in list(result_map)[1:]:
        reader = G.add_node(
            pg.IterateResultNode(inputs=[primary], parent=node, result_name=name)
        )
        out_tables[name] = Table(reader, result_map[name]._schema, name=f"iterate_out:{name}")

    if single:
        return out_tables[first_name]

    class _Result:
        pass

    r = _Result()
    for name, t in out_tables.items():
        setattr(r, name, t)
    return r


def _check_closed(inner_graph: pg.ParseGraph, result_map: Dict[str, Table]) -> None:
    """The body reads only tables of its own graph: a nested runner cannot
    see the outer graph's."""
    from pathway_tpu_torch.internals.expression import ColumnExpression

    own = {id(n) for n in inner_graph.nodes}

    def foreign(table: Any) -> None:
        if id(table._node) not in own:
            raise ValueError(
                f"pw.iterate: the iteration body reads table {table._name!r} of the "
                "enclosing graph; pass it to iterate as a keyword argument"
            )

    def walk(value: Any) -> None:
        if isinstance(value, ColumnExpression):
            for ref in value._column_refs:
                foreign(ref.table)
        elif isinstance(value, dict):
            for v in value.values():
                walk(v)
        elif isinstance(value, (list, tuple)):
            for v in value:
                walk(v)

    for node in inner_graph.nodes:
        for t in node.inputs:
            foreign(t)
        walk(node.config)
    for t in result_map.values():
        foreign(t)


class IterateEvaluator:
    """Runs the nested graph to its fixed point in each commit that changes
    an input (recomputed from the inputs' full state)."""

    def __init__(self, node: pg.Node, runner: Any):
        self.node = node
        self.runner = runner
        self.input_states = [StateTable(t.column_names()) for t in node.inputs]
        self.emitted: Dict[str, StateTable] = {
            name: StateTable(t.column_names()) for name, t in node.config["result_map"].items()
        }
        self.pending_outputs: Dict[str, Delta] = {}
        self.output_columns = node.output.column_names() if node.output else []
        #: body applications of the last fixed point (read by tooling)
        self.last_rounds = 0

    def has_pending(self) -> bool:
        return False

    def neu_pending(self) -> bool:
        return False

    def process(self, input_deltas: List[Delta]) -> Delta:
        from pathway_tpu_torch.engine.runner import GraphRunner

        for state, delta in zip(self.input_states, input_deltas):
            state.apply(delta)
        if all(len(d) == 0 for d in input_deltas):
            return Delta.empty(self.output_columns)

        inner_graph: pg.ParseGraph = self.node.config["inner_graph"]
        sources: Dict[str, Any] = self.node.config["sources"]
        result_map: Dict[str, Table] = self.node.config["result_map"]
        input_names: List[str] = self.node.config["input_names"]
        limit = self.node.config.get("iteration_limit")

        nested = GraphRunner(inner_graph)
        nested._materialize_all = True
        nested._runtime = self.runner._runtime
        nested.setup()
        # the inputs' full state is round 0's input
        for name, state in zip(input_names, self.input_states):
            sources[name].feed(state.snapshot())

        iteration = 0
        while True:
            nested.step()
            iteration += 1
            if limit is not None and iteration >= limit:
                # the limit counts applications of the body: limit N gives
                # f^N(x)
                break
            changed = False
            for name in input_names:
                if name not in result_map:
                    continue
                out_state = nested.state_of(result_map[name]._node)
                # the feedback edge: the iterated table's difference from the
                # proxy input
                proxy_delta = _state_diff(
                    nested.state_of(_proxy_node(inner_graph, name)), out_state
                )
                if len(proxy_delta):
                    changed = True
                    sources[name].feed(proxy_delta)
            if not changed:
                break
        self.last_rounds = iteration

        for name, table in result_map.items():
            final_state = nested.state_of(table._node)
            delta = _state_diff(self.emitted[name], final_state)
            self.emitted[name].apply(delta)
            self.pending_outputs[name] = delta
        first = next(iter(result_map))
        return self.pending_outputs.pop(first)

    def take_output(self, name: str) -> Delta:
        return self.pending_outputs.pop(
            name, Delta.empty(self.node.config["result_map"][name].column_names())
        )


def _proxy_node(inner_graph: pg.ParseGraph, name: str) -> pg.Node:
    for node in inner_graph.nodes:
        if isinstance(node, pg.InputNode) and node.name == f"iterate:{name}":
            return node
    raise KeyError(name)


def _state_diff(old: StateTable, new: StateTable) -> Delta:
    """The delta that turns ``old``'s rows into ``new``'s."""
    from pathway_tpu_torch.engine.evaluators import _delta_from_rows

    out_keys: list = []
    out_diffs: list = []
    out_rows: list = []
    new_snapshot = new.snapshot()
    old_snapshot = old.snapshot()
    names = old.column_names
    for i in range(len(old_snapshot)):
        kb = old_snapshot.keys[i].tobytes()
        new_row = new.get_row(kb)
        old_row = {c: old_snapshot.columns[c][i] for c in names}
        if new_row is None:
            out_keys.append(old_snapshot.keys[i])
            out_diffs.append(-1)
            out_rows.append(old_row)
        elif not _rows_equal(new_row, old_row):
            out_keys.append(old_snapshot.keys[i])
            out_diffs.append(-1)
            out_rows.append(old_row)
            out_keys.append(old_snapshot.keys[i])
            out_diffs.append(1)
            out_rows.append(new_row)
    absent = old.lookup(new_snapshot.keys) < 0 if len(new_snapshot) else np.zeros(0, bool)
    for i in np.nonzero(absent)[0].tolist():
        out_keys.append(new_snapshot.keys[i])
        out_diffs.append(1)
        out_rows.append({c: new_snapshot.columns[c][i] for c in new_snapshot.column_names})
    return _delta_from_rows(out_keys, out_diffs, out_rows, names)


def _rows_equal(a: dict, b: dict) -> bool:
    for k, va in a.items():
        vb = b.get(k)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            try:
                eq = np.array_equal(va, vb, equal_nan=True)
            except TypeError:  # non-numeric dtypes reject equal_nan
                eq = np.array_equal(va, vb)
            if not eq:
                return False
        elif va != vb:
            # NaN equals NaN for the fixed-point check (value semantics): an
            # iterated float column holding NaN would otherwise re-emit its
            # row forever
            if not (isinstance(va, float) and isinstance(vb, float) and va != va and vb != vb):
                return False
    return True


class IterateResultEvaluator:
    """Emits one of the iterate node's results beyond the first."""

    def __init__(self, node: pg.Node, runner: Any):
        self.node = node
        self.runner = runner

    def has_pending(self) -> bool:
        return False

    def neu_pending(self) -> bool:
        return False

    def process(self, input_deltas: List[Delta]) -> Delta:
        parent = self.node.config["parent"]
        parent_eval = self.runner.evaluators[parent.id]
        return parent_eval.take_output(self.node.config["result_name"])
