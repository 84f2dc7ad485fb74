"""``pw.sql`` on the port against the reference.

Every case of the reference's ``tests/test_sql.py`` is a parametrised
program here, built with both packages from one definition; each query's
update stream (keys, times, diffs, values) must be equal. Seeded random
tables add a JOIN + WHERE + GROUP BY / HAVING query with ``AVG`` (floats
within rtol 1e-9) and a query over a stream with retractions.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from tests.torch_parity import assert_same, clear_graphs

USERS = """
    uid | name  | age
    1   | alice | 30
    2   | bob   | 25
    3   | carol | 35
    """
ORDERS = """
    oid | user_id | total
    10  | 1       | 100
    11  | 1       | 50
    12  | 2       | 75
    13  | 9       | 20
    """
PEOPLE = """
    name  | age
    alice | 30
    bob   | 25
    carol |
    dave  | 40
    """


def _query(text: str, **tables: str):
    """The program ``pkg.sql(text, **markdown tables)``."""

    def program(pkg):
        return pkg.sql(
            text, **{name: pkg.debug.table_from_markdown(md) for name, md in tables.items()}
        )

    return program


CASES = {
    "inner_join_with_aliases": [
        _query(
            "SELECT u.name, o.total FROM users u JOIN orders o ON u.uid = o.user_id",
            users=USERS, orders=ORDERS,
        )
    ],
    "left_join_pads_nulls": [
        _query(
            "SELECT u.name, o.total FROM users u LEFT JOIN orders o ON u.uid = o.user_id",
            users=USERS, orders=ORDERS,
        )
    ],
    "join_group_by_having": [
        _query(
            "SELECT u.name, SUM(o.total) AS spent FROM users u "
            "JOIN orders o ON u.uid = o.user_id GROUP BY u.name HAVING SUM(o.total) > 60",
            users=USERS, orders=ORDERS,
        )
    ],
    "join_residual_on_condition": [
        _query(
            "SELECT u.name, o.total FROM users u JOIN orders o "
            "ON u.uid = o.user_id AND o.total > 60",
            users=USERS, orders=ORDERS,
        )
    ],
    "subquery_in_from": [
        _query(
            "SELECT name FROM (SELECT name, age FROM users WHERE age > 26) grown "
            "WHERE grown.age < 34",
            users=USERS,
        )
    ],
    "subquery_with_aggregation_joined": [
        _query(
            "SELECT u.name, s.spent FROM users u "
            "JOIN (SELECT user_id, SUM(total) AS spent FROM orders GROUP BY user_id) s "
            "ON u.uid = s.user_id",
            users=USERS, orders=ORDERS,
        )
    ],
    "union_all_and_union_distinct": [
        _query("SELECT v FROM a UNION ALL SELECT v FROM b", a="v\n1\n2", b="v\n2\n3"),
        _query("SELECT v FROM a UNION SELECT v FROM b", a="v\n1\n2", b="v\n2\n3"),
    ],
    "distinct": [_query("SELECT DISTINCT color FROM t", t="color\nred\nred\nblue")],
    "predicates_in_between_like_null": [
        _query("SELECT name FROM t WHERE age IN (25, 40)", t=PEOPLE),
        _query("SELECT name FROM t WHERE age BETWEEN 26 AND 40", t=PEOPLE),
        _query("SELECT name FROM t WHERE age IS NULL", t=PEOPLE),
        _query("SELECT name FROM t WHERE name LIKE 'a%' OR name LIKE '%ve'", t=PEOPLE),
        _query(
            "SELECT name FROM t WHERE NOT (age > 26) OR age NOT BETWEEN 0 AND 35",
            t="name | age\nalice | 30\nbob | 25\ndave | 40",
        ),
    ],
    "count_star_and_expressions": [
        _query(
            "SELECT grp, COUNT(*) AS n, SUM(v) + 1 AS s1 FROM t GROUP BY grp",
            t="grp | v\na | 1\na | 2\nb | 5",
        )
    ],
    "star_select_through_join": [
        _query(
            "SELECT * FROM users u JOIN orders o ON u.uid = o.user_id WHERE o.total > 90",
            users=USERS, orders=ORDERS,
        )
    ],
    # planning refuses an unqualified column of two joined tables
    "ambiguous_column_errors": [
        (ValueError, "ambiguous", _query("SELECT v FROM a JOIN b ON a.v = b.v", a="v\n1", b="v\n2"))
    ],
}


def _refused_as_the_reference(exc: type, match: str, program) -> None:
    messages = []
    for pkg in (ref_pw, pw):
        clear_graphs()
        with pytest.raises(exc, match=match) as info:
            program(pkg)
        messages.append(str(info.value))
    clear_graphs()
    assert messages[0] == messages[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sql_case_equals_the_reference(name):
    """The twelve cases of the reference's ``tests/test_sql.py``."""
    for case in CASES[name]:
        if isinstance(case, tuple):
            _refused_as_the_reference(*case)
        else:
            assert_same(case)


def _seeded_tables(pkg, seed: int, n_docs: int = 400, n_cats: int = 8):
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, n_cats, n_docs)
    scores = rng.integers(0, 1000, n_docs)
    sizes = rng.integers(1, 50, n_docs)
    docs = pkg.debug.table_from_rows(
        pkg.schema_builder({"doc": int, "cat": int, "score": int, "size": int}),
        [(i, int(cats[i]), int(scores[i]), int(sizes[i])) for i in range(n_docs)],
    )
    meta = pkg.debug.table_from_rows(
        pkg.schema_builder({"cid": int, "label": str, "weight": int}),
        [(c, f"cat{c}", int(w)) for c, w in enumerate(rng.integers(1, 5, n_cats))],
    )
    return docs, meta


@pytest.mark.parametrize("seed", [0, 1])
def test_sql_seeded_join_where_group_having_avg(seed):
    query = (
        "SELECT m.label, COUNT(*) AS n, SUM(d.score * m.weight) AS ws, AVG(d.size) AS mean "
        "FROM docs d JOIN meta m ON d.cat = m.cid "
        "WHERE d.score BETWEEN 100 AND 900 AND m.label NOT LIKE 'cat7' "
        "GROUP BY m.label HAVING COUNT(*) > 10"
    )

    def program(pkg):
        docs, meta = _seeded_tables(pkg, seed)
        return pkg.sql(query, docs=docs, meta=meta)

    got = assert_same(program, rtol=1e-9)
    assert sum(len(rows) for rows in got.values()) >= 3


def test_sql_over_a_stream_with_retractions():
    """Rows arrive, are replaced and retracted over several times: every
    time's update of the grouped, filtered, unioned result is the reference's."""
    rng = np.random.default_rng(7)
    events = []
    live = {}
    for t in range(0, 12, 2):
        for _ in range(12):
            k = int(rng.integers(0, 20))
            if k in live and rng.random() < 0.5:
                events.append((k, k % 3, live.pop(k), t, -1))
            elif k not in live:
                live[k] = int(rng.integers(0, 100))
                events.append((k, k % 3, live[k], t, 1))

    def program(pkg):
        schema = pkg.schema_builder({"k": int, "g": int, "v": int})
        s = pkg.debug.table_from_rows(schema, events, is_stream=True)
        return pkg.sql(
            "SELECT g, SUM(v) AS total, MAX(v) AS top FROM s WHERE v >= 10 GROUP BY g "
            "UNION ALL SELECT k AS g, v + 0 AS total, v AS top FROM s WHERE v < 10",
            s=s,
        )

    got = assert_same(program)
    assert len(got) > 2
