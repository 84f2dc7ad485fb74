"""The rest of the reducers on the port against the reference.

Each program runs through both packages and both update streams must be
equal (rows within one time as a multiset), with inserts and retractions in
one commit: argmin / argmax, unique, any, avg, ndarray, the custom
(``BaseCustomAccumulator`` through ``udf_reducer``) and stateful reducers,
the HMM reducer of ``stdlib/ml/hmm.py``. ``avg`` is exact on float64; its
columnar state summing float32 batches of at least 32,768 rows (the device
path: torch's sorted segment sum here, XLA's in the reference) agrees within
rtol 1e-6. The port runs with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_update_stream as ref_capture
from pathway_tpu.engine.columnar import Error as RefError
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.engine.columnar import Error
from pathway_tpu_torch.internals.parse_graph import G


def _norm(v):
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, (Error, RefError)):
        return ("error",)
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), v.tobytes())
    if isinstance(v, np.generic):
        return v.item()
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


_STREAM = """
  | g | v   | w | __time__ | __diff__
1 | a | 1.5 | 3 | 0        | 1
2 | a | 4.0 | 3 | 0        | 1
3 | b | 2.0 | 5 | 0        | 1
4 | b | 2.0 | 5 | 0        | 1
1 | a | 1.5 | 3 | 2        | -1
5 | a | 0.5 | 3 | 2        | 1
6 | c | 9.0 | 1 | 2        | 1
3 | b | 2.0 | 5 | 4        | -1
4 | b | 2.0 | 5 | 4        | -1
7 | a | 7.0 | 3 | 4        | 1
"""


def _reduced(make):
    def program(pw):
        t = pw.debug.table_from_markdown(_STREAM)
        return t.groupby(t.g).reduce(t.g, r=make(pw, t))

    return program


REDUCERS = {
    "argmin": lambda pw, t: pw.reducers.argmin(t.v),
    "argmax": lambda pw, t: pw.reducers.argmax(t.v),
    "unique": lambda pw, t: pw.reducers.unique(t.w),
    "any": lambda pw, t: pw.reducers.any(t.v),
    "avg": lambda pw, t: pw.reducers.avg(t.v),
    "avg_int": lambda pw, t: pw.reducers.avg(t.w),
    "ndarray": lambda pw, t: pw.reducers.ndarray(t.v),
    "ndarray_sorted": lambda pw, t: pw.reducers.ndarray(t.v, sort_by=t.w),
    "count": lambda pw, t: pw.reducers.count(),
    "sum": lambda pw, t: pw.reducers.sum(t.v),
    "sorted_tuple": lambda pw, t: pw.reducers.sorted_tuple(t.v),
}


@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_reducer_streams_equal_the_reference(name):
    _assert_same(_reduced(REDUCERS[name]))


def _ties(pw):
    t = pw.debug.table_from_markdown(
        """
          | g | v
        1 | a | 1
        2 | a | 1
        3 | a | 1
        """
    )
    return t.groupby(t.g).reduce(lo=pw.reducers.argmin(t.v), hi=pw.reducers.argmax(t.v))


def _global_reduce(pw):
    t = pw.debug.table_from_markdown(_STREAM)
    return t.reduce(
        m=pw.reducers.avg(t.v), a=pw.reducers.argmax(t.w), n=pw.reducers.count(),
        arr=pw.reducers.ndarray(t.w),
    )


def _random_stream(seed):
    def program(pw):
        rng = np.random.default_rng(seed)
        lines = ["  | g | v | __time__ | __diff__"]
        live: dict = {}
        for step in range(60):
            t = 2 * (step // 6)
            rid = int(rng.integers(1, 25))
            if rid in live and rng.random() < 0.5:
                g, v = live.pop(rid)
                lines.append(f"{rid} | {g} | {v} | {t} | -1")
            elif rid not in live:
                g, v = int(rng.integers(0, 4)), int(rng.integers(-20, 20))
                live[rid] = (g, v)
                lines.append(f"{rid} | {g} | {v} | {t} | 1")
        tab = pw.debug.table_from_markdown("\n".join(lines))
        return tab.groupby(tab.g).reduce(
            tab.g, mx=pw.reducers.argmax(tab.v), mn=pw.reducers.argmin(tab.v),
            a=pw.reducers.any(tab.v), m=pw.reducers.avg(tab.v), arr=pw.reducers.ndarray(tab.v),
        )

    return program


CASES = {
    "ties": _ties,
    "global_reduce": _global_reduce,
    **{f"random_{s}": _random_stream(s) for s in (0, 1, 2, 3)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reducer_cases_equal_the_reference(name):
    _assert_same(CASES[name])


def test_unique_conflict_raises_when_terminating_and_poisons_otherwise():
    def program(pw):
        t = pw.debug.table_from_markdown(
            """
              | g | v
            1 | a | 1
            2 | a | 2
            3 | b | 5
            """
        )
        return t.groupby(t.g).reduce(t.g, v=pw.reducers.unique(t.v))

    for pkg, cap, graph, extra in (
        (ref_pw, ref_capture, REF_G, {}),
        (pw, capture, G, {"device": "cpu"}),
    ):
        graph.clear()
        with pytest.raises(Exception) as info:
            cap(program(pkg), **extra)
        err = info.value
        assert isinstance(err, ValueError) or isinstance(getattr(err, "cause", None), ValueError)
        graph.clear()
    _assert_same(program, terminate_on_error=False)


# -- custom and stateful reducers ---------------------------------------------------------


def _custom(retractable: bool):
    def program(pw):
        class Mean(pw.BaseCustomAccumulator):
            def __init__(self, total, n):
                self.total, self.n = total, n

            @classmethod
            def from_row(cls, row):
                return cls(row[0], 1)

            def update(self, other):
                self.total += other.total
                self.n += other.n

            if retractable:
                def retract(self, other):
                    self.total -= other.total
                    self.n -= other.n

            def compute_result(self):
                return (self.total, self.n)

        t = pw.debug.table_from_markdown(_STREAM)
        mean = pw.reducers.udf_reducer(Mean)
        return t.groupby(t.g).reduce(t.g, r=mean(t.w))

    return program


def _stateful_single(pw):
    t = pw.debug.table_from_markdown(
        """
        g | v | __time__
        a | 1 | 0
        a | 2 | 0
        b | 5 | 2
        a | 3 | 2
        """
    )
    total = pw.reducers.stateful_single(lambda state, v: (state or 0) + v)
    return t.groupby(t.g).reduce(t.g, s=total(t.v))


def _stateful_many(pw):
    t = pw.debug.table_from_markdown(_STREAM)

    def combine(state, rows):
        return sum(row[0] * diff for row, diff in rows) + (state or 0)

    return t.groupby(t.g).reduce(t.g, s=pw.reducers.stateful_many(combine)(t.w))


CUSTOM = {
    "custom_retractable": _custom(True),
    "custom_rebuilt": _custom(False),
    "stateful_single": _stateful_single,
    "stateful_many": _stateful_many,
}


@pytest.mark.parametrize("name", sorted(CUSTOM))
def test_custom_and_stateful_reducers_equal_the_reference(name):
    _assert_same(CUSTOM[name])


# -- the HMM reducer --------------------------------------------------------------------------


def _manul_graph():
    import networkx as nx
    from functools import partial

    def emission(observation, state):
        table = {
            ("HUNGRY", "GRUMPY"): 0.9,
            ("HUNGRY", "HAPPY"): 0.1,
            ("FULL", "GRUMPY"): 0.7,
            ("FULL", "HAPPY"): 0.3,
        }
        return np.log(table[(state, observation)])

    g = nx.DiGraph()
    for s in ("HUNGRY", "FULL"):
        g.add_node(s, calc_emission_log_ppb=partial(emission, state=s))
    g.add_edge("HUNGRY", "HUNGRY", log_transition_ppb=np.log(0.4))
    g.add_edge("HUNGRY", "FULL", log_transition_ppb=np.log(0.6))
    g.add_edge("FULL", "HUNGRY", log_transition_ppb=np.log(0.6))
    g.add_edge("FULL", "FULL", log_transition_ppb=np.log(0.4))
    g.graph["start_nodes"] = ["HUNGRY", "FULL"]
    return g


@pytest.mark.parametrize("kwargs", [{"num_results_kept": 3}, {"beam_size": 1}, {}],
                         ids=["kept_3", "beam_1", "plain"])
def test_hmm_reducer_streams_equal_the_reference(kwargs):
    pytest.importorskip("networkx")

    def program(pw):
        obs = pw.debug.table_from_markdown(
            """
            observation | __time__
            HAPPY       | 0
            HAPPY       | 2
            GRUMPY      | 4
            GRUMPY      | 6
            HAPPY       | 8
            GRUMPY      | 10
            """
        )
        reducer = pw.reducers.udf_reducer(pw.stdlib.ml.hmm.create_hmm_reducer(_manul_graph(), **kwargs))
        return obs.reduce(decoded_state=reducer(pw.this.observation))

    got = _assert_same(program)
    if kwargs == {"num_results_kept": 3}:
        final = [dict(r)["decoded_state"] for r in got[max(got)] if dict(r)["__diff__"] > 0]
        assert final == [("HUNGRY", "FULL", "HUNGRY")]


# -- avg's columnar state over float32 batches ------------------------------------------------


@pytest.mark.parametrize("n", [(1 << 15), (1 << 15) + 513])
def test_avg_state_float32_batches_agree_with_the_reference(n, monkeypatch):
    """A float32 batch of at least 32,768 rows takes the segment sum's device
    path in both (here torch's sorted segment sum on the CPU, JAX's XLA
    segment sum in the reference): averages within rtol 1e-6; integer
    counts exact, also after a retraction batch."""
    from pathway_tpu.internals import reducers as ref_reducers
    from pathway_tpu_torch.engine.expression_evaluator import get_runtime
    from pathway_tpu_torch.internals import reducers

    monkeypatch.setitem(get_runtime(), "device", "cpu")
    rng = np.random.default_rng(n)
    m = 300
    slots = rng.integers(0, m, n)
    vals = rng.normal(size=n).astype(np.float32)
    uniq, inverse = np.unique(slots, return_inverse=True)
    diffs = np.ones(n, dtype=np.int64)
    cnt = np.bincount(inverse, minlength=len(uniq)).astype(np.int64)
    states = [ref_reducers.reducers.avg(ref_pw.this.v)._reducer.make_state(),
              reducers.reducers.avg(pw.this.v)._reducer.make_state()]
    for st in states:
        st.ensure(m)
        st.update(slots, uniq, inverse, [vals], diffs, cnt, cnt)
    assert states[1].vals.dtype == np.float32  # the float32 (device) segment sum ran
    want, got = (st.values(uniq) for st in states)
    scale = np.bincount(inverse, weights=np.abs(vals), minlength=len(uniq)) / cnt
    assert np.all(np.abs(got - want) <= 1e-6 * scale)
    assert np.array_equal(states[0].counts[uniq], states[1].counts[uniq])
    # retract the first half
    half = n // 2
    sub_u, sub_inv = np.unique(slots[:half], return_inverse=True)
    sub_cnt = -np.bincount(sub_inv, minlength=len(sub_u)).astype(np.int64)
    for st in states:
        after = st.counts[sub_u] + sub_cnt
        st.update(slots[:half], sub_u, sub_inv, [vals[:half]], -np.ones(half, np.int64),
                  sub_cnt, after)
    assert np.array_equal(states[0].counts[uniq], states[1].counts[uniq])
    want, got = (np.asarray(st.values(uniq), dtype=object) for st in states)
    for w, g_, s in zip(want, got, scale):
        assert (w is None) == (g_ is None)
        if w is not None:
            assert abs(g_ - w) <= 2e-6 * s


def test_reducer_namespace_has_the_references_entries():
    names = {n for n in dir(ref_pw.reducers) if not n.startswith("_")}
    assert names <= {n for n in dir(pw.reducers) if not n.startswith("_")}
    for name in ("count", "sum", "avg"):
        reducer = getattr(pw.reducers, name)(pw.this.v) if name != "count" else pw.reducers.count()
        assert reducer._reducer.semigroup
    for name in ("min", "max", "argmin", "argmax", "unique", "any", "ndarray", "tuple"):
        assert not getattr(pw.reducers, name)(pw.this.v)._reducer.semigroup
