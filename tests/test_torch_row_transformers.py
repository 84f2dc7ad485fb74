"""``@pw.transformer`` row transformers on the port against the reference.

Each non-async case of the reference's ``tests/test_transformers.py`` is a
parametrised program built with both packages; its update stream (keys,
times, diffs, values) must be equal. Seeded streams add pointer chasing
across tables over several commits with re-pointed and retracted rows. The
port re-evaluates only the rows a commit changed and the rows that read
them; a counting case checks that.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from tests.torch_parity import assert_same, clear_graphs


def _simple(pkg):
    class OutputSchema(pkg.Schema):
        ret: int

    @pkg.transformer
    class foo_transformer:
        class table(pkg.ClassArg, output=OutputSchema):
            arg = pkg.input_attribute()

            @pkg.output_attribute
            def ret(self) -> int:
                return self.arg + 1

    table = pkg.debug.table_from_markdown(
        """
            | arg
        1   | 1
        2   | 2
        3   | 3
        """
    )
    return foo_transformer(table).table


def _aux_objects(pkg):
    @pkg.transformer
    class foo_transformer:
        class table(pkg.ClassArg):
            arg = pkg.input_attribute()

            const = 10

            def fun(self, a) -> int:
                return a * self.arg + self.const

            @staticmethod
            def sfun(b) -> int:
                return b * 100

            @pkg.attribute
            def attr(self) -> int:
                return self.arg / 2

            @pkg.output_attribute
            def ret(self) -> int:
                return self.arg + self.const + self.fun(1) + self.sfun(self.arg) + self.attr

    table = pkg.debug.table_from_markdown(
        """
            | arg
        1   | 10
        2   | 20
        3   | 30
        """
    )
    return foo_transformer(table).table


def _list_traversal(pkg):
    @pkg.transformer
    class list_traversal:
        class nodes(pkg.ClassArg):
            next = pkg.input_attribute()
            val = pkg.input_attribute()

        class requests(pkg.ClassArg):
            node = pkg.input_attribute()
            steps = pkg.input_attribute()

            @pkg.output_attribute
            def reached_value(self) -> int:
                node = self.transformer.nodes[self.node]
                for _ in range(self.steps):
                    node = self.transformer.nodes[node.next]
                return node.val

    return list_traversal


def _pointer_chasing(pkg):
    raw = pkg.debug.table_from_markdown(
        """
            | val
        1   | 11
        2   | 12
        3   | 13
        """
    )
    keyed = raw.with_id_from(raw.val)
    chain = keyed.select(
        next=keyed.pointer_from(pkg.apply_with_type(lambda v: min(v + 1, 13), int, keyed.val)),
        val=keyed.val,
    )
    reqs_raw = pkg.debug.table_from_markdown(
        """
            | node | steps
        10  | 11   | 2
        20  | 13   | 0
        """
    )
    reqs = reqs_raw.select(node=chain.pointer_from(reqs_raw.node), steps=reqs_raw.steps)
    return _list_traversal(pkg)(chain, reqs).requests


def _output_rename(pkg):
    @pkg.transformer
    class foo_transformer:
        class table(pkg.ClassArg):
            arg = pkg.input_attribute()

            @pkg.output_attribute(output_name="foo")
            def ret(self) -> int:
                return self.arg + 1

    out = foo_transformer(pkg.debug.table_from_markdown("| arg\n1 | 1")).table
    assert out.column_names() == ["foo"]
    return out


def _incremental(pkg):
    @pkg.transformer
    class inc:
        class table(pkg.ClassArg):
            arg = pkg.input_attribute()

            @pkg.output_attribute
            def double(self) -> int:
                return self.arg * 2

    table = pkg.debug.table_from_markdown(
        """
        arg | __time__
        1   | 0
        2   | 2
        3   | 4
        """
    )
    return inc(table).table


CASES = {
    "simple_transformer": _simple,
    "aux_objects": _aux_objects,
    "pointer_chasing_across_tables": _pointer_chasing,
    "output_attribute_rename": _output_rename,
    "transformer_incremental_update": _incremental,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transformer_case_equals_the_reference(name):
    got = assert_same(CASES[name])
    if name == "transformer_incremental_update":
        # new rows add outputs; no unchanged row is retracted
        assert all(dict(row)["__diff__"] == 1 for rows in got.values() for row in rows)


@pytest.mark.parametrize("pkg", [ref_pw, pw], ids=["reference", "port"])
def test_output_schema_validation_error(pkg):
    """A declared output column no attribute produces is refused when the class is made."""
    with pytest.raises(RuntimeError, match="output schema validation error"):

        class OutputSchema(pkg.Schema):
            foo: int

        @pkg.transformer
        class foo_transformer:
            class table(pkg.ClassArg, output=OutputSchema):
                arg = pkg.input_attribute()

                @pkg.output_attribute(output_name="bar")
                def foo(self) -> int:
                    return self.arg + 1


def _chain_stream(seed: int, n: int, commits: int, moves: int):
    """A ring of ``n`` nodes and ``n // 2`` requests; each later commit
    re-points ``moves`` nodes (a -1 / +1 pair on the node's key) and
    retracts or re-adds a few requests."""
    rng = np.random.default_rng(seed)
    nxt = list(rng.permutation(n))
    vals = rng.integers(0, 1000, n)
    nodes = [(i, int(nxt[i]), int(vals[i]), 0, 1) for i in range(n)]
    live = {r: (int(rng.integers(0, n)), int(rng.integers(0, 6))) for r in range(n // 2)}
    reqs = [(r, s, st, 0, 1) for r, (s, st) in live.items()]
    gone = {}
    for c in range(1, commits):
        t = 2 * c
        for i in rng.choice(n, moves, replace=False).tolist():
            nodes.append((i, int(nxt[i]), int(vals[i]), t, -1))
            nxt[i] = int(rng.integers(0, n))
            nodes.append((i, int(nxt[i]), int(vals[i]), t, 1))
        for r in rng.choice(n // 2, 3, replace=False).tolist():
            if r in live:
                gone[r] = live.pop(r)
                reqs.append((r, *gone[r], t, -1))
            else:
                live[r] = gone.pop(r)
                reqs.append((r, *live[r], t, 1))
    return nodes, reqs


def _chain_program(nodes, reqs):
    def program(pkg):
        node_t = pkg.debug.table_from_rows(
            pkg.schema_builder({"i": int, "nxt": int, "val": int}), nodes, is_stream=True
        )
        req_t = pkg.debug.table_from_rows(
            pkg.schema_builder({"r": int, "start": int, "steps": int}), reqs, is_stream=True
        )
        keyed = node_t.with_id_from(node_t.i)
        chain = keyed.select(next=keyed.pointer_from(keyed.nxt), val=keyed.val)
        asks = req_t.select(node=chain.pointer_from(req_t.start), steps=req_t.steps)
        return _list_traversal(pkg)(chain, asks).requests

    return program


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pointer_chasing_with_repointed_and_retracted_rows(seed):
    nodes, reqs = _chain_stream(seed, n=64, commits=4, moves=6)
    got = assert_same(_chain_program(nodes, reqs))
    assert len(got) == 4
    assert any(dict(row)["__diff__"] == -1 for t in sorted(got)[1:] for row in got[t])


def test_a_commit_re_evaluates_only_the_rows_that_read_a_change():
    """Commit 2 re-points one node of a ring: only the requests whose walk
    read that node are evaluated again."""
    calls = []

    @pw.transformer
    class walk:
        class nodes(pw.ClassArg):
            next = pw.input_attribute()
            val = pw.input_attribute()

        class requests(pw.ClassArg):
            node = pw.input_attribute()
            steps = pw.input_attribute()

            @pw.output_attribute
            def reached_value(self) -> int:
                calls.append(self.id)
                node = self.transformer.nodes[self.node]
                for _ in range(self.steps):
                    node = self.transformer.nodes[node.next]
                return node.val

    n = 16
    nodes = [(i, (i + 1) % n, 100 + i, 0, 1) for i in range(n)]
    # request r starts at node r and walks one step: it reads nodes r and r + 1
    reqs = [(r, r, 1, 0, 1) for r in range(n)]
    nodes += [(5, 6, 105, 2, -1), (5, 9, 105, 2, 1)]
    clear_graphs()
    node_t = pw.debug.table_from_rows(
        pw.schema_builder({"i": int, "nxt": int, "val": int}), nodes, is_stream=True
    )
    req_t = pw.debug.table_from_rows(
        pw.schema_builder({"r": int, "start": int, "steps": int}), reqs, is_stream=True
    )
    keyed = node_t.with_id_from(node_t.i)
    chain = keyed.select(next=keyed.pointer_from(keyed.nxt), val=keyed.val)
    asks = req_t.select(node=chain.pointer_from(req_t.start), steps=req_t.steps)
    out = walk(chain, asks).requests
    updates = pw.debug._capture_update_stream(out, device="cpu")
    clear_graphs()
    # every request once, then only the two that read node 5: request 4
    # (its value) and request 5 (its pointer)
    assert len(calls) == n + 2
    later = [u for u in updates if u["__time__"] > min(v["__time__"] for v in updates)]
    assert sorted((u["__diff__"], u["reached_value"]) for u in later) == [(-1, 106), (1, 109)]
