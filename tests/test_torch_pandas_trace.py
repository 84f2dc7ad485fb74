"""The pandas bridge, schemas from data, the debug printers, error traces
and the ``pw`` namespace of the port, against the reference.

- ``table_from_pandas`` / ``table_to_pandas`` round trips, ``schema_from_pandas``,
  ``schema_from_csv``, ``is_subschema``, ``StreamGenerator``,
  ``pandas_transformer`` and ``compute_and_print_update_stream``: the same
  rows, keys, update streams, schemas and printed text as the reference's.
- An operator's failure raises ``EngineErrorWithTrace`` naming the user's
  file and line, as ``tests/test_trace.py`` asks of the reference.
- Regressions of three faults of the port: names missing from ``pw``, keyword
  arguments the reference accepts and the port refused, and a UDF's failure
  raised bare, without the user's line.
"""

from __future__ import annotations

import sys

import numpy as np
import pandas as pd
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.internals.trace import EngineErrorWithTrace as RefEngineErrorWithTrace
from pathway_tpu_torch.engine.runner import GraphRunner
from pathway_tpu_torch.internals.parse_graph import G
from tests.torch_parity import assert_same, clear_graphs, norm


def _frame(seed: int = 0, n: int = 12) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {
            "name": [f"n{i}" for i in rng.integers(0, 1000, n)],
            "count": rng.integers(-50, 50, n),
            "score": rng.normal(size=n),
            "flag": rng.random(n) < 0.5,
        }
    )


def _records(df: pd.DataFrame) -> list:
    return sorted(
        ((norm(k),) + tuple(norm(v) for v in row) for k, row in zip(df.index, df.itertuples(index=False))),
        key=repr,
    )


@pytest.mark.parametrize(
    "kwargs, index",
    [({}, None), ({"id_from": ["name", "count"]}, None), ({}, [f"r{i}" for i in range(12)])],
    ids=["value_keys", "id_from", "own_index"],
)
def test_pandas_round_trip_equals_the_reference(kwargs, index):
    df = _frame()
    if index is not None:
        df.index = index
    if "id_from" in kwargs:
        df = df.drop_duplicates(subset=kwargs["id_from"])
    out = []
    for pkg, extra in ((ref_pw, {}), (pw, {"device": "cpu"})):
        clear_graphs()
        table = pkg.debug.table_from_pandas(df, **kwargs)
        out.append((table.schema.typehints(), pkg.debug.table_to_pandas(table, **extra)))
    clear_graphs()
    (ref_types, ref_df), (types, got_df) = out
    assert {k: repr(v) for k, v in types.items()} == {k: repr(v) for k, v in ref_types.items()}
    assert list(got_df.columns) == list(ref_df.columns) == list(df.columns)
    assert _records(got_df) == _records(ref_df)
    assert len(got_df) == len(df)
    assert sorted(got_df["count"].tolist()) == sorted(df["count"].tolist())


def test_pandas_table_streams_through_a_program_as_the_reference():
    df = _frame(3, 40)

    def program(pkg):
        t = pkg.debug.table_from_pandas(df)
        t = t.filter(t.flag).select(t.score, g=t.count % 5)
        return t.groupby(t.g).reduce(t.g, m=pkg.reducers.count(), s=pkg.reducers.sum(t.score))

    assert_same(program, rtol=1e-12)


def test_schema_from_pandas_equals_the_reference():
    df = _frame()
    df["when"] = pd.to_datetime(["2024-01-01"] * len(df))
    df["obj"] = [None] + [f"s{i}" for i in range(len(df) - 1)]
    want = ref_pw.schema_from_pandas(df, id_from=["name"])
    got = pw.schema_from_pandas(df, id_from=["name"])
    assert [(c.name, repr(c.dtype), c.primary_key) for c in got.columns().values()] == [
        (c.name, repr(c.dtype), c.primary_key) for c in want.columns().values()
    ]


def test_schema_from_csv_equals_the_reference(tmp_path):
    path = tmp_path / "data.csv"
    path.write_text(
        "# a comment line\n"
        "id,price,flag,label,empty,mixed\n"
        "1,2.5,True,a,,1\n"
        "2,3,false,\"b, c\",,x\n"
        "3,-1e3,true,d,,2\n"
    )
    for kwargs in ({}, {"comment_character": "#"}, {"comment_character": "#", "num_parsed_rows": 1}):
        want = ref_pw.schema_from_csv(str(path), **kwargs)
        got = pw.schema_from_csv(str(path), **kwargs)
        assert {n: repr(c.dtype) for n, c in got.columns().items()} == {
            n: repr(c.dtype) for n, c in want.columns().items()
        }, kwargs


def test_is_subschema_equals_the_reference():
    from pathway_tpu.internals.schema import is_subschema as ref_is_subschema
    from pathway_tpu_torch.internals.schema import is_subschema

    def schemas(pkg):
        class A(pkg.Schema):
            x: int
            y: str

        class B(pkg.Schema):
            x: int

        class C(pkg.Schema):
            x: float
            y: str

        class D(pkg.Schema):
            x: int | None

        return [A, B, C, D]

    ref_s, port_s = schemas(ref_pw), schemas(pw)
    got = [[is_subschema(a, b) for b in port_s] for a in port_s]
    want = [[ref_is_subschema(a, b) for b in ref_s] for a in ref_s]
    assert got == want
    assert got[1][0] and not got[0][1]


def test_stream_generator_equals_the_reference():
    batches = [[{"k": 1, "v": 10}, {"k": 2, "v": 20}], [{"k": 3, "v": 30}], [{"k": 1, "v": 10}]]
    by_workers = {0: [[{"k": 1, "v": 1}], [{"k": 2, "v": 2}]], 1: [[{"k": 5, "v": 5}]]}

    def program(pkg):
        schema = pkg.schema_builder({"k": int, "v": int})
        gen = pkg.debug.StreamGenerator()
        a = gen.table_from_list_of_batches(batches, schema)
        b = gen.table_from_list_of_batches_by_workers(by_workers, schema)
        return a.concat_reindex(b).groupby(pkg.this.k).reduce(pkg.this.k, s=pkg.reducers.sum(pkg.this.v))

    got = assert_same(program)
    assert len(got) == 3


@pytest.mark.parametrize("output_universe", [None, 0])
def test_pandas_transformer_equals_the_reference(output_universe):
    def program(pkg):
        inp = pkg.debug.table_from_markdown(
            """
                | foo  | bar
            0   | 10   | 100
            1   | 20   | 200
            2   | 30   | 300
            """
        )

        class Output(pkg.Schema):
            sum: int

        @pkg.pandas_transformer(output_schema=Output, output_universe=output_universe)
        def sum_cols(t: pd.DataFrame) -> pd.DataFrame:
            return pd.DataFrame(t.sum(axis=1))

        out = sum_cols(inp)
        return inp.with_columns(total=out.sum) if output_universe == 0 else out

    got = assert_same(program)
    assert len(got[min(got)]) == 3


def test_printers_print_what_the_reference_prints(capsys):
    md = """
        k | v | __time__ | __diff__
        1 | 5 | 0        | 1
        2 | 6 | 0        | 1
        1 | 5 | 2        | -1
        1 | 7 | 2        | 1
        """

    def printed(pkg, fn, **kwargs):
        clear_graphs()
        t = pkg.debug.table_from_markdown(md)
        out = t.groupby(t.k).reduce(t.k, s=pkg.reducers.sum(t.v))
        getattr(pkg.debug, fn)(out, **kwargs)
        text = capsys.readouterr().out
        clear_graphs()
        return text

    for fn in ("compute_and_print", "compute_and_print_update_stream"):
        want = printed(ref_pw, fn)
        assert printed(pw, fn, device="cpu") == want
        assert want.count("\n") >= 3
    # squash_updates=False prints the update stream (the reference ignores it)
    assert printed(pw, "compute_and_print", squash_updates=False, device="cpu") == printed(
        ref_pw, "compute_and_print_update_stream"
    )


# -- error traces ------------------------------------------------------------------------


def _inverse(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("no inverse of 0")
    return 10 // a


def test_runtime_error_carries_user_frame():
    """The port's twin of the reference's ``tests/test_trace.py`` case: the
    failure reaches the caller as ``EngineErrorWithTrace``, not bare."""
    clear_graphs()
    t = pw.debug.table_from_markdown("| a\n1 | 1")

    def boom(x):
        raise ValueError("user function exploded")

    bad = t.select(b=pw.apply(boom, t.a))  # <- the user line the trace must cite
    line = sys._getframe().f_lineno - 1
    pw.io.subscribe(bad, lambda key, row, time, is_addition: None)
    with pytest.raises(Exception) as err:
        GraphRunner(G._current).run(device="cpu")
    clear_graphs()
    assert type(err.value).__name__ == "EngineErrorWithTrace", repr(err.value)
    message = str(err.value)
    assert f"test_torch_pandas_trace.py:{line}" in message
    assert "user function exploded" in message and message.startswith("ValueError: ")
    assert "bad = t.select(b=pw.apply(boom, t.a))" in message
    assert isinstance(err.value.cause, ValueError)
    assert err.value.user_frame.line_number == line


def test_error_trace_equals_the_reference_but_for_the_package():
    """Both packages name the same operator, file and line, with the same text."""
    from pathway_tpu_torch.internals.trace import EngineErrorWithTrace

    messages = []
    for pkg, exc_type, extra in (
        (ref_pw, RefEngineErrorWithTrace, {}),
        (pw, EngineErrorWithTrace, {"device": "cpu"}),
    ):
        clear_graphs()
        t = pkg.debug.table_from_markdown("a\n1\n0")
        out = t.select(q=pkg.apply_with_type(_inverse, int, t.a))
        with pytest.raises(exc_type) as err:
            pkg.debug.compute_and_print(out, **extra)
        messages.append(str(err.value))
    clear_graphs()
    assert messages[0] == messages[1]
    assert "ZeroDivisionError" in messages[1] and "test_torch_pandas_trace.py" in messages[1]


def test_error_log_rows_stay_as_they_were_without_termination():
    """With ``terminate_on_error=False`` a UDF error is a row of the error
    log (with its trace), not an exception."""

    def program(pkg):
        t = pkg.debug.table_from_markdown("a\n1\n0\n2")
        out = t.select(q=pkg.apply_with_type(_inverse, int, t.a))
        return out.remove_errors()

    for pkg, extra in ((ref_pw, {}), (pw, {"device": "cpu"})):
        clear_graphs()
        rows = pkg.debug._capture_table(program(pkg), terminate_on_error=False, **extra)
        assert sorted(r["q"] for r in rows.values()) == [5, 10]
    clear_graphs()
    t = pw.debug.table_from_markdown("a\n1\n0")
    t.select(q=pw.apply_with_type(_inverse, int, t.a))
    log = pw.global_error_log()
    rows = pw.debug._capture_table(log, terminate_on_error=False, device="cpu")
    clear_graphs()
    assert [r["message"] for r in rows.values()] == ["ZeroDivisionError: no inverse of 0"]


# -- regressions: the pw namespace, refused keywords, bare UDF errors -------------------------

#: the reference's ``pw`` names the port still owes, and the queue item of each
OWED = {"persistence": "A5"}


_MISSING = (
    "import pathway_tpu as ref, pathway_tpu_torch as pw\n"
    "print(' '.join(sorted(set(dir(ref)) - set(dir(pw)))))\n"
)


def test_pw_namespace_lacks_only_the_owed_names():
    """Both packages freshly imported (a run imports more submodules, which
    then show as attributes): the port lacks exactly the owed names."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _MISSING], capture_output=True, text=True, cwd=repo, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert set(proc.stdout.split()) == set(OWED)
    for name in ("fill_error", "DType", "GroupedTable", "Joinable", "JoinResult", "Date", "parse_graph_G",
                 "sql", "pandas_transformer", "ClassArg", "transformer", "schema_from_csv"):
        assert name in pw.__all__ or name == "parse_graph_G", name
    assert pw.Date is pw.DateTimeNaive
    assert pw.ops.__name__ == "pathway_tpu_torch.ops"
    assert pw.parse_graph_G is G
    assert pw.fill_error.__module__ == "pathway_tpu_torch.internals.expression"


def test_fill_error_through_pw_equals_the_reference():
    def program(pkg):
        t = pkg.debug.table_from_markdown("a\n1\n0\n4")
        return t.select(q=pkg.fill_error(pkg.apply_with_type(_inverse, int, t.a), -1))

    clear_graphs()
    want = sorted(r["q"] for r in ref_pw.debug._capture_table(program(ref_pw), terminate_on_error=False).values())
    clear_graphs()
    got = sorted(
        r["q"] for r in pw.debug._capture_table(program(pw), terminate_on_error=False, device="cpu").values()
    )
    clear_graphs()
    assert got == want == [-1, 2, 10]


def _splitter_keyword():
    from pathway_tpu.xpacks.llm.splitters import TokenCountSplitter as RefSplitter
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    text = " ".join(f"w{i}." if i % 7 == 0 else f"w{i}" for i in range(300))
    splitter = TokenCountSplitter(min_tokens=5, max_tokens=40, encoding_name="cl100k_base")
    assert splitter.encoding_name == "cl100k_base"
    ref = RefSplitter(min_tokens=5, max_tokens=40, encoding_name="cl100k_base")
    assert splitter.func(text) == ref.func(text)


def _knn_keyword():
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn

    data = pw.debug.table_from_rows(
        pw.schema_builder({"v": np.ndarray}), [(np.arange(4, dtype=np.float32) + i,) for i in range(3)]
    )
    BruteForceKnn(data.v, dimensions=4, auxiliary_space=64, device="cpu")


def _knn_factory_keyword():
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory

    factory = BruteForceKnnFactory(dimensions=4, auxiliary_space=64, device="cpu")
    assert factory.auxiliary_space == 64
    data = pw.debug.table_from_rows(pw.schema_builder({"v": np.ndarray}), [(np.ones(4, np.float32),)])
    factory.build_inner_index(data.v)


@pytest.mark.parametrize(
    "case", [_splitter_keyword, _knn_keyword, _knn_factory_keyword],
    ids=["splitter_encoding_name", "brute_force_knn_auxiliary_space", "factory_auxiliary_space"],
)
def test_keywords_the_reference_accepts_are_accepted(case):
    clear_graphs()
    case()
    clear_graphs()


def test_compute_and_print_squash_updates(capsys):
    printed = []
    for pkg, extra in ((ref_pw, {}), (pw, {"device": "cpu"})):
        clear_graphs()
        pkg.debug.compute_and_print(pkg.debug.table_from_markdown("a\n3"), squash_updates=True, **extra)
        printed.append(capsys.readouterr().out)
    clear_graphs()
    assert printed[0] == printed[1]
    assert printed[1].splitlines()[0] == "| a"
