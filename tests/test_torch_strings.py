"""The port's ``.str`` namespace against the reference's: every one of the 20
methods over the same rows (None, an empty string and unparsable values
among them) through both engines, with the same values and the same output
dtypes."""

from __future__ import annotations

from typing import Optional

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_update_stream as ref_capture
from pathway_tpu.engine.columnar import Error as RefError
from pathway_tpu.internals.expressions.string import StringNamespace as RefStringNamespace
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.engine.columnar import Error
from pathway_tpu_torch.internals.expressions.string import StringNamespace
from pathway_tpu_torch.internals.parse_graph import G

ROWS = [
    "  Hello World  ",
    "",
    None,
    "42",
    " -7 ",
    "3.5e2",
    "not a number",
    "yes",
    "OFF",
    "Ja",
    "a,b,,c",
    "xXhello worldXx",
    "hello hello hello",
    "ßtraße",
]

# one case per method (the first of each name), then the options
CASES = {
    "len": lambda s: s.str.len(),
    "lower": lambda s: s.str.lower(),
    "upper": lambda s: s.str.upper(),
    "reversed": lambda s: s.str.reversed(),
    "strip": lambda s: s.str.strip(),
    "strip_chars": lambda s: s.str.strip("xX "),
    "lstrip": lambda s: s.str.lstrip(),
    "lstrip_chars": lambda s: s.str.lstrip("xX"),
    "rstrip": lambda s: s.str.rstrip(),
    "rstrip_chars": lambda s: s.str.rstrip("xX "),
    "count": lambda s: s.str.count("l"),
    "count_range": lambda s: s.str.count("l", 1, 9),
    "find": lambda s: s.str.find("o"),
    "find_range": lambda s: s.str.find("l", 3, 12),
    "rfind": lambda s: s.str.rfind("o"),
    "rfind_range": lambda s: s.str.rfind("hello", 0, 11),
    "startswith": lambda s: s.str.startswith("he"),
    "endswith": lambda s: s.str.endswith("lo"),
    "swapcase": lambda s: s.str.swapcase(),
    "title": lambda s: s.str.title(),
    "replace": lambda s: s.str.replace("l", "L"),
    "replace_count": lambda s: s.str.replace("hello", "bye", 2),
    "split": lambda s: s.str.split(),
    "split_sep_max": lambda s: s.str.split(",", 1),
    "slice": lambda s: s.str.slice(1, 4),
    "slice_negative": lambda s: s.str.slice(-3, -1),
    "parse_int": lambda s: s.str.parse_int(),
    "parse_int_optional": lambda s: s.str.parse_int(optional=True),
    "parse_float": lambda s: s.str.parse_float(),
    "parse_float_optional": lambda s: s.str.parse_float(optional=True),
    "parse_bool": lambda s: s.str.parse_bool(),
    "parse_bool_optional": lambda s: s.str.parse_bool(optional=True),
    "parse_bool_custom": lambda s: s.str.parse_bool(
        true_values=["ja", "YES"], false_values=["off", "nein"], optional=True
    ),
    "parse_bool_custom_strict": lambda s: s.str.parse_bool(
        true_values=["ja"], false_values=["nein"]
    ),
}

METHODS = {
    "len", "lower", "upper", "reversed", "strip", "lstrip", "rstrip", "count",
    "find", "rfind", "startswith", "endswith", "swapcase", "title", "replace",
    "split", "slice", "parse_int", "parse_float", "parse_bool",
}


def _norm(v):
    if isinstance(v, (Error, RefError)):
        return ("error",)
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        return ("nan",)
    return (type(v).__name__, v)


def _program(pkg, case: str):
    t = pkg.debug.table_from_rows(
        pkg.schema_builder({"s": Optional[str]}), [(s,) for s in ROWS]
    )
    return t.select(t.s, out=CASES[case](t.s))


def _run(case: str) -> tuple:
    REF_G.clear()
    for attr in ("_global_error_log", "_error_log_source", "_error_log_stack"):
        REF_G._current.__dict__.pop(attr, None)
    ref_t = _program(ref_pw, case)
    ref_dtype = repr(ref_t.schema.dtypes()["out"])
    want = ref_capture(ref_t, terminate_on_error=False)
    REF_G.clear()
    G.clear()
    port_t = _program(pw, case)
    port_dtype = repr(port_t.schema.dtypes()["out"])
    got = capture(port_t, device="cpu", terminate_on_error=False)
    G.clear()

    def rows(updates):
        return sorted(
            ((u["__time__"], u["__diff__"], _norm(u["s"]), _norm(u["out"])) for u in updates),
            key=repr,
        )

    return (ref_dtype, rows(want)), (port_dtype, rows(got))


@pytest.fixture(autouse=True)
def _no_fusion(monkeypatch):
    # the port has no operator fusion: the reference runs its per-node dispatch
    monkeypatch.setenv("PATHWAY_FUSION", "off")


def test_the_cases_cover_every_method_of_the_reference():
    def methods(cls):
        return [n for n in vars(cls) if not n.startswith("_")]

    assert set(methods(RefStringNamespace)) == METHODS
    # the reference's order, and a case named after each method
    assert methods(StringNamespace) == methods(RefStringNamespace)
    assert METHODS <= set(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_string_method_equals_the_reference(case):
    (ref_dtype, want), (port_dtype, got) = _run(case)
    assert port_dtype == ref_dtype
    assert got == want
    assert len(got) == len(ROWS)
    # None in gives None out; a bool column has no None, and there both
    # engines' column tidying reads it as False
    none_out = [out for _t, _d, s, out in got if s == ("NoneType", None)]
    assert none_out == [("bool", False) if case in ("startswith", "endswith")
                        else ("NoneType", None)]


def test_parse_failures_are_errors_unless_optional():
    _ref, (_dt, strict) = _run("parse_int")
    _ref, (_dt, optional) = _run("parse_int_optional")
    by_s = {s: out for _t, _d, s, out in strict}
    assert by_s[("str", "not a number")] == ("error",)
    assert by_s[("str", "")] == ("error",)
    assert by_s[("str", " -7 ")] == ("int", -7)
    by_s = {s: out for _t, _d, s, out in optional}
    assert by_s[("str", "not a number")] == ("NoneType", None)
    assert by_s[("str", "42")] == ("int", 42)
