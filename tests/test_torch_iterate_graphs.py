"""``pw.iterate`` and the stdlib on the engine's operators, port against reference.

Each program runs through both packages and both update streams must be
equal (rows within one time as a multiset): ``iterate`` with and without a
limit, with several results, over a stream with retractions and over NaN
columns; pagerank and louvain on seeded graphs (identical ranks and
clusterings: the port's keys are the reference's bit for bit, and
louvain's tie-breaking hashes them); ``ordered.diff``;
``statistical.interpolate``. ``bellman_ford`` is held against scipy's
Dijkstra: the reference's body reads the outer ``edges`` table, which its
nested runner cannot see, and leaves every vertex but the sources at
``inf`` (ROADMAP, faults of the reference). A last test runs a pipeline
with an ``iterate`` through both packages' ``pw.run`` in a process of its
own and compares the profiler's operator tables: the nested runner adds no
row. The port runs with ``device="cpu"``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_update_stream as ref_capture
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.internals.parse_graph import G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(v):
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        return ("nan",)
    return v


def _stream(updates: list) -> dict:
    by_time: dict = {}
    for u in updates:
        row = tuple(sorted((k, _norm(v)) for k, v in u.items() if k != "__time__"))
        by_time.setdefault(u["__time__"], []).append(row)
    return {t: sorted(rows, key=repr) for t, rows in by_time.items()}


@pytest.fixture(autouse=True)
def _no_fusion(monkeypatch):
    # the port has no operator fusion: the reference runs its per-node dispatch
    monkeypatch.setenv("PATHWAY_FUSION", "off")


def _assert_same(program, **kwargs) -> dict:
    REF_G.clear()
    want = _stream(ref_capture(program(ref_pw), **kwargs))
    REF_G.clear()
    G.clear()
    got = _stream(capture(program(pw), device="cpu", **kwargs))
    G.clear()
    assert got == want
    assert got, "the program emitted nothing: the case compares nothing"
    return got


# -- iterate -----------------------------------------------------------------------------


def _doubling(pw):
    t = pw.debug.table_from_markdown(
        """
        a
        1
        5
        """
    )
    return pw.iterate(lambda t: dict(t=t.select(a=pw.if_else(t.a < 100, t.a * 2, t.a))), t=t).t


def _limited(limit):
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
              | v
            1 | 0
            2 | 10
            """
        )
        return pw.iterate(lambda t: dict(t=t.select(v=t.v + 1)), iteration_limit=limit, t=t).t

    return program


def _collatz(pw):
    t = pw.debug.table_from_markdown(
        """
          | v
        1 | 6
        2 | 7
        3 | 1
        """
    )

    def collatz(t):
        nxt = pw.if_else(t.v == 1, t.v, pw.if_else(t.v % 2 == 0, t.v // 2, 3 * t.v + 1))
        return dict(t=t.select(v=nxt))

    return pw.iterate(collatz, t=t).t


def _nan_column(pw):
    t = pw.debug.table_from_rows(pw.schema_builder({"x": float}), [(float("nan"),), (2.0,)])
    return pw.iterate(lambda state: dict(state=state.select(x=state.x)), state=t).state


def _two_results(pw):
    t = pw.debug.table_from_markdown(
        """
          | v
        1 | 3
        2 | 8
        """
    )

    def step(t):
        half = t.select(v=pw.if_else(t.v > 1, t.v // 2, t.v))
        return dict(t=half, seen=t.select(w=t.v * 10))

    res = pw.iterate(step, t=t)
    return res.t.join(res.seen, res.t.id == res.seen.id).select(res.t.v, res.seen.w)


def _streaming(pw):
    t = pw.debug.table_from_markdown(
        """
          | v | __time__ | __diff__
        1 | 3 | 0        | 1
        2 | 9 | 0        | 1
        1 | 3 | 2        | -1
        3 | 40 | 2       | 1
        """
    )
    return pw.iterate(lambda t: dict(t=t.select(v=pw.if_else(t.v < 50, t.v + 7, t.v))), t=t).t


def _constant_argument(pw):
    t = pw.debug.table_from_markdown(
        """
          | v
        1 | 1
        """
    )
    return pw.iterate(
        lambda t, cap: dict(t=t.select(v=pw.if_else(t.v < cap, t.v * 3, t.v))), t=t, cap=100
    ).t


ITERATE = {
    "doubling": _doubling,
    "limit_1": _limited(1),
    "limit_3": _limited(3),
    "collatz": _collatz,
    "nan_column": _nan_column,
    "two_results": _two_results,
    "streaming": _streaming,
    "constant_argument": _constant_argument,
}


@pytest.mark.parametrize("name", sorted(ITERATE))
def test_iterate_streams_equal_the_reference(name):
    _assert_same(ITERATE[name])


def test_iterate_limit_below_one_raises_in_both():
    for pkg, graph in ((ref_pw, REF_G), (pw, G)):
        graph.clear()
        t = pkg.debug.table_from_markdown(
            """
              | v
            1 | 0
            """
        )
        with pytest.raises(ValueError):
            pkg.iterate(lambda t: dict(t=t), iteration_limit=0, t=t)
        graph.clear()


def test_iterate_body_reading_an_outer_table_raises():
    G.clear()
    t = pw.debug.table_from_markdown(
        """
          | v
        1 | 0
        """
    )
    outer = t.select(w=t.v + 1)
    with pytest.raises(ValueError, match="enclosing graph"):
        pw.iterate(lambda t: dict(t=t.select(v=outer.w)), t=t)
    G.clear()


# -- graphs -------------------------------------------------------------------------------


def _random_graph(seed: int, nv: int, ne: int):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, nv + 1) ** 0.8
    p /= p.sum()
    return rng.choice(nv, ne, p=p), rng.choice(nv, ne, p=p), rng.integers(1, 17, ne)


def _pagerank(seed):
    def program(pw):
        u, v, _w = _random_graph(seed, 60, 240)
        V = pw.debug.table_from_rows(
            pw.schema_builder({"name": int}), [(i,) for i in range(60)]
        ).with_id_from(pw.this.name)
        E = pw.debug.table_from_rows(
            pw.schema_builder({"a": int, "b": int}), list(zip(u.tolist(), v.tolist()))
        )
        E = E.select(u=V.pointer_from(E.a), v=V.pointer_from(E.b))
        return pw.stdlib.graphs.pagerank(E, steps=5)

    return program


def _planted(seed: int, n: int, k: int):
    rng = np.random.default_rng(seed)
    size = n // k
    rows: dict = {}
    for _ in range(n * 2):
        a = int(rng.integers(0, n))
        b = (a // size) * size + int(rng.integers(0, size)) if rng.random() < 0.85 else int(
            rng.integers(0, n)
        )
        if a != b:
            key = (min(a, b), max(a, b))
            rows[key] = rows.get(key, 0.0) + 1.0
    return [(a, b, w) for (a, b), w in rows.items()] + [(b, a, w) for (a, b), w in rows.items()]


def _louvain(seed, levels, iterations):
    def program(pw):
        edges = _planted(seed, 48, 6)
        V = pw.debug.table_from_rows(
            pw.schema_builder({"name": int}), [(i,) for i in range(48)]
        ).with_id_from(pw.this.name)
        E = pw.debug.table_from_rows(
            pw.schema_builder({"a": int, "b": int, "weight": float}), edges
        )
        WE = E.select(u=V.pointer_from(E.a), v=V.pointer_from(E.b), weight=E.weight)
        g = pw.stdlib.graphs.WeightedGraph.from_vertices_and_weighted_edges(V.select(), WE)
        clustering = pw.stdlib.graphs.louvain_communities(
            g, levels=levels, iterations_per_level=iterations
        )
        modularity = pw.stdlib.graphs.exact_modularity(g, clustering)
        return clustering.select(c=clustering.c, q=0.0).concat_reindex(
            modularity.select(c=None, q=modularity.modularity)
        )

    return program


GRAPHS = {
    **{f"pagerank_{s}": _pagerank(s) for s in (0, 1, 2)},
    "louvain_1x6": _louvain(0, 1, 6),
    "louvain_2x4": _louvain(1, 2, 4),
    "louvain_3x3": _louvain(2, 3, 3),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_algorithms_equal_the_reference(name):
    _assert_same(GRAPHS[name])


def _bellman_ford_run(pkg, graph, u, v, w, sources, nv, **kwargs) -> np.ndarray:
    graph.clear()
    V = pkg.debug.table_from_rows(
        pkg.schema_builder({"name": int, "is_source": bool}),
        [(i, i in sources) for i in range(nv)],
    ).with_id_from(pkg.this.name)
    E = pkg.debug.table_from_rows(
        pkg.schema_builder({"a": int, "b": int, "d": float}),
        list(zip(u.tolist(), v.tolist(), w.astype(float).tolist())),
    )
    E = E.select(u=V.pointer_from(E.a), v=V.pointer_from(E.b), dist=E.d)
    res = pkg.stdlib.graphs.bellman_ford(V.select(V.is_source), E)
    res = res.join(V, res.id == V.id).select(V.name, res.dist_from_source)
    cap = capture if pkg is pw else ref_capture
    rows = cap(res, **kwargs)
    graph.clear()
    out = np.full(nv, -1.0)
    for r in rows:
        if r["__diff__"] > 0:
            out[r["name"]] = r["dist_from_source"]
    return out


def _dijkstra(u, v, w, sources, nv) -> np.ndarray:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    best: dict = {}
    for a, b, c in zip(u.tolist(), v.tolist(), w.tolist()):
        best[(a, b)] = min(c, best.get((a, b), c))
    pairs = list(best)
    m = csr_matrix(
        ([float(best[p]) for p in pairs], ([p[0] for p in pairs], [p[1] for p in pairs])),
        shape=(nv, nv),
    )
    return dijkstra(m, indices=sorted(sources), min_only=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bellman_ford_equals_dijkstra(seed):
    u, v, w = _random_graph(seed, 80, 320)
    sources = {0, 7, 33}
    got = _bellman_ford_run(pw, G, u, v, w, sources, 80, device="cpu")
    assert np.array_equal(got, _dijkstra(u, v, w, sources, 80))


def test_reference_bellman_ford_leaves_non_sources_at_infinity():
    """The reference's fault, documented (ROADMAP): its iteration body reads
    the outer ``edges`` table, so no edge relaxes."""
    u, v, w = _random_graph(0, 30, 120)
    got = _bellman_ford_run(ref_pw, REF_G, u, v, w, {0}, 30)
    want = _dijkstra(u, v, w, {0}, 30)
    assert got[0] == 0.0 and np.isfinite(want).sum() > 1
    assert all(math.isinf(x) for i, x in enumerate(got) if i != 0)


# -- ordered.diff and statistical.interpolate ------------------------------------------------


def _diff(pw):
    t = pw.debug.table_from_markdown(
        """
        t | v   | g | __time__
        1 | 1.0 | a | 0
        2 | 4.0 | a | 0
        3 | 9.0 | b | 0
        5 | 7.0 | a | 2
        4 | 2.0 | b | 2
        0 | 3.0 | a | 4
        """
    )
    return pw.ordered.diff(t, t.t, t.v, instance=t.g)


def _interpolate_runs(pw):
    t = pw.debug.table_from_markdown(
        """
        t | v
        1 | 1.0
        2 |
        3 |
        4 | 7.0
        5 |
        """
    )
    return pw.statistical.interpolate(t, t.t, t.v)


def _interpolate_stream(pw):
    t = pw.debug.table_from_markdown(
        """
        t  | v    | __time__
        1  | 2.0  | 0
        4  |      | 0
        9  |      | 0
        6  | 12.0 | 2
        12 | 4.0  | 4
        0  |      | 4
        """
    )
    return t.interpolate(t.t, t.v)


def _random_interpolate(seed):
    def program(pw):
        rng = np.random.default_rng(seed)
        ts = rng.permutation(40)
        lines = ["t | v | __time__"]
        for i, t in enumerate(ts.tolist()):
            v = "" if rng.random() < 0.35 else f"{float(rng.integers(-9, 9))}"
            lines.append(f"{t} | {v} | {2 * (i // 8)}")
        tab = pw.debug.table_from_markdown("\n".join(lines))
        return pw.statistical.interpolate(tab, tab.t, tab.v)

    return program


ORDERED = {
    "diff": _diff,
    "interpolate_runs": _interpolate_runs,
    "interpolate_stream": _interpolate_stream,
    **{f"interpolate_random_{s}": _random_interpolate(s) for s in (0, 1)},
}


@pytest.mark.parametrize("name", sorted(ORDERED))
def test_ordered_and_statistical_equal_the_reference(name):
    _assert_same(ORDERED[name])


# -- the profiler's operator table with a nested runner ---------------------------------------

_ITERATE_PROFILE = r'''
import json

def build(pw):
    t = pw.debug.table_from_markdown("""
      | v | __time__ | __diff__
    1 | 3 | 0        | 1
    2 | 9 | 0        | 1
    1 | 3 | 2        | -1
    3 | 40 | 2       | 1
    """)
    it = pw.iterate(lambda t: dict(t=t.select(v=pw.if_else(t.v < 50, t.v + 7, t.v))), t=t).t
    out = it.groupby().reduce(s=pw.reducers.sum(it.v))
    pw.io.subscribe(out, on_change=lambda *a, **k: None)

def run(pkg):
    if pkg == "ref":
        import pathway_tpu as pw
        from pathway_tpu.engine import profile
        kwargs = {}
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import profile
        kwargs = {"device": "cpu"}
    profile.reset_profile()
    build(pw)
    pw.run(**kwargs)
    return {
        "totals": [[e["node"], e["name"], e["kind"], e["rows"], e["retractions"], e["calls"]]
                   for e in profile.get_profiler().operator_totals()],
        "commits": profile.get_profiler().commits,
    }

print(json.dumps({pkg: run(pkg) for pkg in ("ref", "port")}))
'''


def test_nested_iterate_runner_leaves_the_operator_table_equal_to_the_reference():
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "PATHWAY_FUSION": "off"}
    for name in ("PATHWAY_PROFILE", "PATHWAY_FLIGHT_RECORDER", "PATHWAY_PROCESS_ID"):
        env.pop(name, None)
    proc = subprocess.run([sys.executable, "-c", _ITERATE_PROFILE], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["port"] == out["ref"]
    kinds = [row[2] for row in out["port"]["totals"]]
    assert "iterate" in kinds and "rowwise" not in kinds[kinds.index("iterate"):]


# -- stdlib.utils and the small graph cases of the reference's tests ----------------------------


def _apply_all_rows(pw):
    t = pw.debug.table_from_markdown(
        """
          | colA | colB
        1 | 1    | 10
        2 | 2    | 20
        3 | 3    | 30
        """
    )

    def add_total_sum(c1, c2):
        s = sum(c1) + sum(c2)
        return [x + s for x in c1]

    return pw.stdlib.utils.col.apply_all_rows(
        t.colA, t.colB, fun=add_total_sum, result_col_name="res"
    )


def _multiapply_all_rows(pw):
    t = pw.debug.table_from_markdown(
        """
          | colA | colB | __time__
        1 | 1    | 10   | 0
        2 | 2    | 20   | 2
        """
    )

    def both(c1, c2):
        s = sum(c1) + sum(c2)
        return [x + s for x in c1], [x + s for x in c2]

    return pw.stdlib.utils.col.multiapply_all_rows(
        t.colA, t.colB, fun=both, result_col_names=["r1", "r2"]
    )


def _majority(pw):
    t = pw.debug.table_from_markdown(
        """
          | group | vote
        0 | 1     | pizza
        1 | 1     | pizza
        2 | 1     | hotdog
        3 | 2     | pasta
        4 | 2     | pasta
        5 | 2     | hotdog
        """
    )
    return pw.stdlib.utils.col.groupby_reduce_majority(t.group, t.vote)


def _arg_rows(pw):
    t = pw.debug.table_from_markdown(
        """
          | g | v  | __time__ | __diff__
        1 | a | 3  | 0        | 1
        2 | a | 8  | 0        | 1
        3 | b | 5  | 0        | 1
        2 | a | 8  | 2        | -1
        4 | b | -1 | 2        | 1
        """
    )
    hi = pw.stdlib.utils.filtering.argmax_rows(t, t.g, what=t.v)
    lo = pw.stdlib.utils.filtering.argmin_rows(t, t.g, what=t.v)
    return hi.select(hi.g, hi.v, side=1).concat_reindex(lo.select(lo.g, lo.v, side=0))


def _unpack(pw):
    t = pw.debug.table_from_rows(
        pw.schema_builder({"data": pw.Json, "pair": tuple}),
        [(pw.Json({"field_a": 13, "field_b": "foo"}), (1, "x")),
         (pw.Json({"field_a": 17}), (2, "y"))],
    )

    class DataSchema(pw.Schema):
        field_a: int
        field_b: str | None

    fields = pw.stdlib.utils.col.unpack_col_dict(t.data, schema=DataSchema)
    pair = pw.stdlib.utils.col.unpack_col(t.pair, "n", "s")
    return fields.select(fields.field_a, fields.field_b, n=pair.n, s=pair.s)


def _flatten_column(pw):
    import warnings

    t = pw.debug.table_from_rows(pw.schema_builder({"pet": str}), [("Dog",), ("Cat",)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pw.stdlib.utils.col.flatten_column(t.pet)


def _two_triangles(pw):
    edges = []
    for a, b, w in [(0, 1, 10), (1, 2, 10), (0, 2, 10), (3, 4, 10), (4, 5, 10), (3, 5, 10),
                    (2, 3, 1)]:
        edges += [(a, b, float(w)), (b, a, float(w))]
    V = pw.debug.table_from_rows(pw.schema_from_types(v=int), [(i,) for i in range(7)]
                                 ).with_id_from(pw.this.v)
    E = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int, weight=float), edges)
    WE = E.select(u=V.pointer_from(E.a), v=V.pointer_from(E.b), weight=E.weight)
    g = pw.stdlib.graphs.WeightedGraph.from_vertices_and_weighted_edges(V, WE)
    flat = pw.stdlib.graphs.louvain_communities(g, levels=1, iterations_per_level=6)
    level = pw.stdlib.graphs.louvain_level(g, 6)
    return flat.select(v=V.v, c=flat.c, lc=level.ix(flat.id).c)


UTILS = {
    "apply_all_rows": _apply_all_rows,
    "multiapply_all_rows": _multiapply_all_rows,
    "groupby_reduce_majority": _majority,
    "argmax_argmin_rows": _arg_rows,
    "unpack_col_and_dict": _unpack,
    "flatten_column": _flatten_column,
    "louvain_two_triangles_and_isolated": _two_triangles,
}


@pytest.mark.parametrize("name", sorted(UTILS))
def test_stdlib_utils_and_graph_cases_equal_the_reference(name):
    _assert_same(UTILS[name])


def test_truncate_to_minutes_is_the_references():
    import datetime

    from pathway_tpu.stdlib.utils.bucketing import truncate_to_minutes as ref_truncate
    from pathway_tpu_torch.stdlib.utils.bucketing import truncate_to_minutes

    ts = datetime.datetime(2026, 7, 30, 12, 34, 56, 789000)
    assert truncate_to_minutes(ts) == ref_truncate(ts) == datetime.datetime(2026, 7, 30, 12, 34)
