"""Shared helpers of the port's parity tests: one program, built once with
``pathway_tpu`` and once with ``pathway_tpu_torch``, and the two update
streams compared (keys, times, diffs and values; rows within one time as a
multiset). The port runs with ``device="cpu"``; the reference without its
operator fusion, which the port does not have."""

from __future__ import annotations

import math
import threading

import numpy as np

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_table as ref_capture_table
from pathway_tpu.debug import _capture_update_stream as ref_capture
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_table as capture_table
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.internals.parse_graph import G


def norm(v):
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, (tuple, list)):
        return tuple(norm(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, norm(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), v.tobytes())
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, float) and v != v:
        return ("nan",)
    return v


def stream(updates: list) -> dict:
    by_time: dict = {}
    for u in updates:
        row = tuple(sorted((k, norm(v)) for k, v in u.items() if k != "__time__"))
        by_time.setdefault(u["__time__"], []).append(row)
    return {t: sorted(rows, key=repr) for t, rows in by_time.items()}


def clear_graphs() -> None:
    """Fresh graphs; the reference's ``clear`` keeps its cached global error
    log table, whose node the cleared graph no longer holds."""
    REF_G.clear()
    for attr in ("_global_error_log", "_error_log_source", "_error_log_stack"):
        REF_G._current.__dict__.pop(attr, None)
    G.clear()


def both(program) -> tuple:
    """(reference stream, port stream) of ``program(pkg) -> Table``."""
    clear_graphs()
    want = stream(ref_capture(program(ref_pw)))
    clear_graphs()
    got = stream(capture(program(pw), device="cpu"))
    clear_graphs()
    return want, got


def close(a, b, rtol: float) -> bool:
    """Equal, but floats within ``rtol`` of each other."""
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(close(x, y, rtol) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k], rtol) for k in a)
    return a == b


def assert_same(program, rtol: float = 0.0) -> dict:
    want, got = both(program)
    if rtol:
        assert close(got, want, rtol), (got, want)
    else:
        assert got == want
    assert got, "the program emitted nothing: the case compares nothing"
    return got


RUN_TIMEOUT_S = 60.0  # a run that has not ended by then is a deadlock


def bounded(fn):
    """``fn()`` on a thread, failing the test if it has not returned in
    ``RUN_TIMEOUT_S`` (a loop-back source that never closes hangs a run)."""
    out: dict = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as exc:  # noqa: BLE001
            out["error"] = exc

    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    thread.join(RUN_TIMEOUT_S)
    assert not thread.is_alive(), f"the run did not end in {RUN_TIMEOUT_S} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def final_rows(pkg, table) -> list:
    """Run the graph; the table's final rows as sorted (key, row) pairs. For
    streams whose commit boundaries depend on timing."""
    if pkg is pw:
        rows = bounded(lambda: capture_table(table, device="cpu"))
    else:
        rows = bounded(lambda: ref_capture_table(table))
    return sorted(
        (norm(r["__key__"]), tuple(sorted((k, norm(v)) for k, v in r.items() if k != "__key__")))
        for r in rows.values()
    )
