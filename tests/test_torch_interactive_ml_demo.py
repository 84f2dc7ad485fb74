"""Interactive mode, viz, the fuzzy joins, the dataset loaders and
``pw.demo`` on the port against the reference.

Each program is built with both packages from the same seeded inputs. The
demo streams and ``LiveTable`` run a connector thread whose commit
boundaries depend on timing: their results are compared as final states.
Fuzzy-join weights agree within rtol 1e-12.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from tests.torch_parity import RUN_TIMEOUT_S, clear_graphs, final_rows, norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": ref_pw, "port": pw}


def _both(program) -> tuple:
    """(reference, port) final states of ``program(pkg) -> Table``."""
    clear_graphs()
    want = final_rows(ref_pw, program(ref_pw))
    clear_graphs()
    got = final_rows(pw, program(pw))
    clear_graphs()
    return want, got


# -- interactive mode ----------------------------------------------------------


def _people(pkg):
    t = pkg.debug.table_from_markdown(
        """
        name  | age
        Alice | 10
        Bob   | 9
        Carol | 31
        """
    )
    return t.filter(t.age > 9).select(t.name, older=t.age + 1)


def _live_snapshot(pkg) -> list:
    pkg.enable_interactive_mode()
    live = _people(pkg).live(device="cpu") if pkg is pw else _people(pkg).live()
    live._thread.join(RUN_TIMEOUT_S)
    assert not live._thread.is_alive() and not live.failed
    return live


def test_live_table_snapshot_after_a_run_equals_the_reference():
    snaps = {}
    for name, pkg in PACKAGES.items():
        clear_graphs()
        live = _live_snapshot(pkg)
        snaps[name] = sorted(norm(row) for row in live.snapshot())
        if pkg is pw:
            assert isinstance(live, pw.LiveTable) and "Carol | 32" in str(live)
            assert sorted(live.to_pandas()["older"]) == [11, 32]
    clear_graphs()
    assert snaps["port"] == snaps["ref"] == sorted(
        norm(r) for r in ({"name": "Alice", "older": 11}, {"name": "Carol", "older": 32}))


_LIVE_FIRST = (
    "import {pkg} as pw\n"
    "t = pw.debug.table_from_markdown('a\\n1')\n"
    "try:\n"
    "    t.live()\n"
    "except (AttributeError, RuntimeError) as exc:\n"
    "    print(type(exc).__name__)\n"
)


@pytest.mark.parametrize("pkg", ["pathway_tpu", "pathway_tpu_torch"])
def test_table_live_before_enable_interactive_mode_raises(pkg):
    """A fresh process: once enabled, ``Table.live`` stays for the session."""
    proc = subprocess.run(
        [sys.executable, "-c", _LIVE_FIRST.format(pkg=pkg)], capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "AttributeError"


# -- viz -----------------------------------------------------------------------


def test_viz_table_snapshot_equals_the_reference():
    snaps = {}
    for name, pkg in PACKAGES.items():
        clear_graphs()
        collector = pkg.viz.table_snapshot(_people(pkg))
        if pkg is pw:
            pw.run(device="cpu")
        else:
            ref_pw.run()
        snaps[name] = sorted(norm(row) for row in collector.snapshot())
    clear_graphs()
    assert snaps["port"] == snaps["ref"] and len(snaps["port"]) == 2


@pytest.mark.parametrize("name", ["ref", "port"])
@pytest.mark.parametrize("call", ["plot", "show"])
def test_viz_plot_and_show_raise_without_bokeh(monkeypatch, name, call):
    for module in ("bokeh", "panel"):
        monkeypatch.setitem(sys.modules, module, None)  # any import of it raises
    pkg = PACKAGES[name]
    clear_graphs()
    t = _people(pkg)
    args = (t, lambda source: None) if call == "plot" else (t,)
    with pytest.raises(ImportError, match="bokeh/panel"):
        getattr(pkg.viz, call)(*args)
    clear_graphs()


# -- fuzzy joins ---------------------------------------------------------------


def _names(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    syllables = ["an", "bel", "cor", "da", "el", "fin", "gar", "ho", "is", "ju", "ka", "lo"]
    out = []
    for _ in range(n):
        words = ["".join(rng.choice(syllables, rng.integers(2, 4))) for _ in range(rng.integers(1, 4))]
        out.append(" ".join(words))
    return out


def _perturbed(names: list, seed: int) -> list:
    rng = np.random.default_rng(seed + 100)
    out = []
    for name in names:
        words = name.split()
        if len(words) > 1 and rng.random() < 0.5:
            words = words[::-1]
        word = words[0]
        if rng.random() < 0.5:
            i = int(rng.integers(0, len(word)))
            word = word[:i] + "x" + word[i + 1:]
        out.append(" ".join([word.upper() if rng.random() < 0.3 else word] + words[1:]))
    return out


def _pairs(rows: list) -> list:
    return sorted((dict(row)["left"], dict(row)["right"], dict(row)["weight"]) for _k, row in rows)


def _same_pairs(want: list, got: list) -> None:
    assert [(l, r) for l, r, _w in got] == [(l, r) for l, r, _w in want]
    for (_l, _r, w_got), (_l2, _r2, w_want) in zip(got, want):
        assert math.isclose(w_got, w_want, rel_tol=1e-12, abs_tol=0.0)
    assert got, "no pair matched: the case compares nothing"


GENERATIONS = ["AUTO", "LETTERS", "TRIGRAMS"]
NORMALIZATIONS = ["NONE", "INVERSE_COUNT", "LOG_INVERSE"]


@pytest.mark.parametrize("normalization", NORMALIZATIONS)
@pytest.mark.parametrize("generation", GENERATIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzzy_match_equals_the_reference(seed, generation, normalization):
    left, right = _names(seed, 24), _perturbed(_names(seed, 24), seed)

    def program(pkg):
        ops = pkg.ml.smart_table_ops
        schema = pkg.schema_builder({"name": str})
        lt = pkg.debug.table_from_rows(schema, [(s,) for s in left])
        rt = pkg.debug.table_from_rows(schema, [(s,) for s in right])
        return pkg.ml.fuzzy_match(
            lt.name, rt.name,
            generation=getattr(ops.FuzzyJoinFeatureGeneration, generation),
            normalization=getattr(ops.FuzzyJoinNormalization, normalization),
        )

    want, got = _both(program)
    _same_pairs(_pairs(want), _pairs(got))


@pytest.mark.parametrize("generation", GENERATIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzzy_self_match_equals_the_reference(seed, generation):
    names = _names(seed, 16) + _perturbed(_names(seed, 16), seed)

    def program(pkg):
        t = pkg.debug.table_from_rows(pkg.schema_builder({"name": str}), [(s,) for s in names])
        gen = getattr(pkg.ml.smart_table_ops.FuzzyJoinFeatureGeneration, generation)
        return pkg.ml.fuzzy_self_match(t.name, generation=gen)

    want, got = _both(program)
    pairs = _pairs(got)
    _same_pairs(_pairs(want), pairs)
    assert all(left < right for left, right, _w in pairs)


@pytest.mark.parametrize("projection", [False, True], ids=["all_columns", "projected"])
def test_fuzzy_match_tables_and_smart_fuzzy_match_equal_the_reference(projection):
    left, right = _names(5, 20), _perturbed(_names(5, 20), 5)

    def tables(pkg):
        schema = pkg.schema_builder({"name": str, "city": str})
        lt = pkg.debug.table_from_rows(schema, [(s, f"city{i % 3}") for i, s in enumerate(left)])
        rt = pkg.debug.table_from_rows(schema, [(s, f"city{i % 4}") for i, s in enumerate(right)])
        return lt, rt

    def matched_tables(pkg):
        lt, rt = tables(pkg)
        proj = {"name": True} if projection else None
        return pkg.ml.fuzzy_match_tables(lt, rt, left_projection=proj, right_projection=proj)

    def smart(pkg):
        lt, rt = tables(pkg)
        return pkg.ml.smart_fuzzy_match(lt.name, rt.name)

    for program in (matched_tables, smart):
        want, got = _both(program)
        _same_pairs(_pairs(want), _pairs(got))


# -- datasets ------------------------------------------------------------------


def test_load_synthetic_classification_equals_the_reference():
    pytest.importorskip("pandas")
    finals = {}
    for name, pkg in PACKAGES.items():
        finals[name] = []
        for i in range(4):  # X_train, y_train, X_test, y_test: one graph each
            clear_graphs()
            tables = pkg.ml.datasets.load_synthetic_classification(
                n_train=40, n_test=10, dim=6, n_classes=3, seed=4)
            finals[name].append(final_rows(pkg, tables[i]))
    clear_graphs()
    assert finals["port"] == finals["ref"]
    assert [len(rows) for rows in finals["port"]] == [40, 40, 10, 10]


def test_load_mnist_sample_raises_without_scikit_learn(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    for pkg in PACKAGES.values():
        with pytest.raises(ImportError, match="scikit-learn"):
            pkg.ml.datasets.load_mnist_sample()


# -- pw.demo -------------------------------------------------------------------


@pytest.mark.parametrize("nb_rows,offset", [(30, 0), (12, 100)])
def test_range_stream_equals_the_reference(nb_rows, offset):
    want, got = _both(lambda pkg: pkg.demo.range_stream(nb_rows=nb_rows, offset=offset))
    assert got == want
    assert sorted(dict(row)["value"] for _k, row in got) == list(range(offset, offset + nb_rows))


def test_noisy_linear_stream_equals_the_reference():
    want, got = _both(lambda pkg: pkg.demo.noisy_linear_stream(nb_rows=20))
    assert got == want and len(got) == 20
    for _k, row in got:
        row = dict(row)
        assert abs(row["y"] - row["x"]) <= 0.1


def test_generate_custom_stream_reduced_equals_the_reference():
    def program(pkg):
        t = pkg.demo.generate_custom_stream(
            {"k": lambda i: i % 5, "v": lambda i: i * i},
            schema=pkg.schema_from_types(k=int, v=int), nb_rows=40, input_rate=0,
        )
        return t.groupby(t.k).reduce(t.k, total=pkg.reducers.sum(t.v))

    want, got = _both(program)
    assert got == want and len(got) == 5


def test_replay_csv_equals_the_reference(tmp_path):
    path = tmp_path / "rows.csv"
    rng = np.random.default_rng(9)
    lines = ["name,count,score,extra"]
    lines += [f"n{i},{int(rng.integers(0, 99))},{rng.random():.6f},x{i}" for i in range(25)]
    path.write_text("\n".join(lines) + "\n")

    def program(pkg):
        schema = pkg.schema_from_types(name=str, count=int, score=float)
        return pkg.demo.replay_csv(str(path), schema=schema, input_rate=0)

    want, got = _both(program)
    assert got == want and len(got) == 25
    assert all(set(dict(row)) == {"name", "count", "score"} for _k, row in got)
