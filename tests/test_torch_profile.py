"""The port's metrics plane against the reference's, on the CPU: the
log-bucketed histograms, the per-operator commit profiles, the engine
profiler's folds and snapshot, the flight recorder, and the profile and
``/metrics`` families a pipeline gives through both packages' engines.

The same inputs, made from a numpy seed, go through both packages. Bucket
edges, quantiles and the OpenMetrics text must be equal byte for byte; the
profiles of the same pipeline must give the same operators with the same
rows, retractions and calls, and the same metric families and label sets.
Wall-clock values (``ts``, ``ts_mono``, operator seconds) are the only
fields left out of a comparison."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from pathway_tpu.engine import profile as ref_profile
from pathway_tpu_torch.engine import profile as port_profile

PROFILES = {"ref": ref_profile, "port": port_profile}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WALL_KEYS = ("ts", "ts_mono", "pid")


def _observations(seed: int) -> list:
    """Seeded latencies over the whole bucket range plus the edge cases of
    ``_bucket_of``: 0, negatives, values below 2**-20, every bound exactly
    (inclusive ``le``), just above and below each bound, and past 64 s."""
    rng = np.random.default_rng(seed)
    values = list(np.exp2(rng.uniform(-24.0, 8.0, size=400)))
    values += list(rng.uniform(0.0005, 0.2, size=200))
    values += [0.0, -1.0, -1e-9, 2.0**-21, 2.0**-20, 1e-7, 64.0, 64.0000001, 1e9, 65.0]
    bounds = ref_profile.LogHistogram.bounds
    values += list(bounds)
    values += [math.nextafter(b, math.inf) for b in bounds]
    values += [math.nextafter(b, 0.0) for b in bounds]
    rng.shuffle(values)
    return [float(v) for v in values]


@pytest.fixture(autouse=True)
def _fresh_planes():
    for mod in PROFILES.values():
        mod.reset_profile()
    yield
    for mod in PROFILES.values():
        mod.reset_profile()


# -- LogHistogram ---------------------------------------------------------------


def test_bucket_bounds_equal_the_reference():
    assert port_profile.LogHistogram.bounds == ref_profile.LogHistogram.bounds
    assert port_profile._MIN_EXP == ref_profile._MIN_EXP == -20
    assert port_profile._MAX_EXP == ref_profile._MAX_EXP == 6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_of_equals_the_reference(seed):
    ref_h, port_h = ref_profile.LogHistogram(), port_profile.LogHistogram()
    for v in _observations(seed):
        clamped = max(0.0, v)
        assert port_h._bucket_of(clamped) == ref_h._bucket_of(clamped), v


def test_bucket_edges_are_inclusive_and_overflow_past_64_seconds():
    h = port_profile.LogHistogram()
    for v in (0.0, -3.0, 2.0**-25):
        h.observe(v)
    assert h.counts[0] == 3
    for i, b in enumerate(h.bounds):
        assert h._bucket_of(b) == i
        assert h._bucket_of(math.nextafter(b, math.inf)) == i + 1
    h.observe(64.0)
    h.observe(64.5)
    assert h.counts[len(h.bounds) - 1] == 1 and h.counts[-1] == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantiles_percentiles_and_text_equal_the_reference(seed):
    ref_h, port_h = ref_profile.LogHistogram(), port_profile.LogHistogram()
    for v in _observations(seed):
        ref_h.observe(v)
        port_h.observe(v)
    assert port_h.counts == ref_h.counts
    assert (port_h.count, port_h.sum) == (ref_h.count, ref_h.sum)
    for q in np.linspace(0.0, 1.0, 41):
        assert port_h.quantile(float(q)) == ref_h.quantile(float(q)), q
    assert port_h.percentiles() == ref_h.percentiles()
    name, help_text = "pathway_rest_latency_seconds", "Log-bucketed pathway_rest_latency_seconds"
    port_text = "\n".join(port_h.openmetrics_lines(name, help_text))
    assert port_text.encode() == "\n".join(ref_h.openmetrics_lines(name, help_text)).encode()
    port_h.reset()
    assert port_h.count == 0 and port_h.sum == 0.0 and port_h.quantile(0.5) == 0.0
    assert set(port_h.counts) == {0}


def test_empty_histogram_equals_the_reference():
    ref_h, port_h = ref_profile.LogHistogram(), port_profile.LogHistogram()
    assert port_h.quantile(0.99) == ref_h.quantile(0.99) == 0.0
    assert port_h.openmetrics_lines("x", "y") == ref_h.openmetrics_lines("x", "y")


def test_histogram_registry_is_process_wide_per_name():
    h = port_profile.histogram("pathway_test_seconds")
    assert port_profile.histogram("pathway_test_seconds") is h
    assert port_profile.histograms()["pathway_test_seconds"] is h
    h.observe(0.5)
    port_profile.reset_profile()
    assert port_profile.histograms()["pathway_test_seconds"].count == 0


# -- commit profiles and the engine profiler --------------------------------------


def _profiles(mod, seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n):
        ops = [
            (node, name, kind, float(rng.uniform(0.0, 0.01)), int(rng.integers(0, 50)),
             int(rng.integers(0, 5)), False)
            for node, name, kind in ((0, "input", "input"), (1, "rowwise", "rowwise"),
                                     (2, "groupby", "groupby"), (3, "output", "output"))
        ]
        out.append(mod.CommitProfile(
            commit=c, rank=0, duration_s=float(rng.uniform(1e-5, 0.3)),
            input_rows=int(rng.integers(0, 100)), output_rows=int(rng.integers(0, 100)),
            neu=False, ops=ops,
        ))
    return out


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in _WALL_KEYS}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_profile_dict_and_slowest_op_equal_the_reference(seed):
    for ref_p, port_p in zip(_profiles(ref_profile, seed, 8), _profiles(port_profile, seed, 8)):
        assert _strip(port_p.as_dict()) == _strip(ref_p.as_dict())
        assert port_p.slowest_op() == ref_p.slowest_op()
    empty = port_profile.CommitProfile(
        commit=0, rank=0, duration_s=0.0, input_rows=0, output_rows=0, neu=False, ops=[]
    )
    assert empty.slowest_op() is None


@pytest.mark.parametrize("n_commits", [1, 63, 64, 65, 200])
def test_profiler_folds_and_snapshot_equal_the_reference(n_commits):
    assert port_profile.EngineProfiler._FOLD_EVERY == ref_profile.EngineProfiler._FOLD_EVERY
    ref_prof, port_prof = ref_profile.EngineProfiler(), port_profile.EngineProfiler()
    for ref_p, port_p in zip(_profiles(ref_profile, 7, n_commits),
                             _profiles(port_profile, 7, n_commits)):
        ref_prof.record_commit(ref_p)
        port_prof.record_commit(port_p)
    # the hot path only appends: the fold runs every _FOLD_EVERY commits
    assert len(port_prof._pending) == len(ref_prof._pending) == n_commits % 64
    assert port_prof.commits == ref_prof.commits == n_commits
    assert port_prof.operator_totals() == ref_prof.operator_totals()
    assert port_prof._pending == []  # a reader folds first
    assert port_prof.snapshot() == ref_prof.snapshot()
    assert port_prof.commit_hist.openmetrics_lines("c", "h") == ref_prof.commit_hist.openmetrics_lines(
        "c", "h")
    port_prof.reset()
    assert port_prof.operator_totals() == [] and port_prof.commits == 0


@pytest.mark.parametrize("raw", ["", "1", "0", "false", "NO", "off", "yes"])
def test_profiling_gate_equals_the_reference(raw, monkeypatch):
    monkeypatch.setenv("PATHWAY_PROFILE", raw)
    assert port_profile.profiling_enabled() == ref_profile.profiling_enabled()


def test_autoscale_signals_equal_the_reference():
    from pathway_tpu.engine import telemetry as ref_tel
    from pathway_tpu.engine.brownout import reset_brownout as ref_reset
    from pathway_tpu_torch.engine import telemetry as port_tel
    from pathway_tpu_torch.engine.brownout import reset_brownout as port_reset

    ref_reset()
    port_reset()
    for tel in (ref_tel, port_tel):
        tel.stage_reset()
        tel.stage_add_many({"embed.shed": 3.0, "rest.shed": 2.0, "exchange.barrier_wait_s": 0.5})
    for v in _observations(4)[:50]:
        ref_profile.histogram("pathway_commit_duration_seconds").observe(v)
        port_profile.histogram("pathway_commit_duration_seconds").observe(v)
    try:
        assert port_profile.autoscale_signals(42) == ref_profile.autoscale_signals(42)
    finally:
        ref_tel.stage_reset()
        port_tel.stage_reset()


# -- the flight recorder ------------------------------------------------------------


def _fill(mod, rec):
    for p in _profiles(mod, 3, 10):
        rec.record_commit(p)
    rec.record_event("brownout", action="engage", from_level=0, to_level=2, occupancy=0.9)
    rec.record_event("index_swap", generation=1, torn=True)
    rec.note_barrier(b"18:3:i0")


@pytest.mark.parametrize("ring", ["4", "64", "junk", "0"])
def test_flight_recorder_ring_dump_and_summary_equal_the_reference(ring, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER_COMMITS", ring)
    payloads = {}
    for name, mod in PROFILES.items():
        rec = mod.FlightRecorder()
        _fill(mod, rec)
        out = tmp_path / name
        out.mkdir()
        path = rec.dump("crash: TestError", directory=str(out))
        assert path == str(out / "flight-rank-0.json")
        assert rec.dumps == 1
        assert not [p for p in os.listdir(out) if ".tmp." in p]  # atomic rename
        payloads[name] = json.loads(open(path).read())
    port, ref = payloads["port"], payloads["ref"]
    # "trace" is what each package's registered tracer gives: the port has
    # none, while the reference's tracing plane may have registered its
    # hooks in this process
    assert port.pop("trace") is None
    ref.pop("trace")
    assert _strip(port) == _strip(ref)
    want = {"4": 4, "64": 10, "junk": 10, "0": 1}[ring]
    assert len(port["profiles"]) == want
    assert port["summary"]["pending_barrier"] == "18:3:i0"
    assert port["summary"]["last_commit"] == 9
    assert port_profile.flight_summary_line(port) == ref_profile.flight_summary_line(ref)


def test_flight_recorder_env_gates_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER", "0")
    for name, mod in PROFILES.items():
        rec = mod.FlightRecorder()
        assert not rec.enabled
        _fill(mod, rec)
        assert rec.dump("crash", directory=str(tmp_path)) is None
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER", "1")
    monkeypatch.delenv("PATHWAY_FLIGHT_RECORDER_DIR", raising=False)
    rec = port_profile.FlightRecorder()
    assert rec.dump("crash") is None  # no dump directory known
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER_DIR", str(tmp_path))
    assert rec.dump("crash") == str(tmp_path / "flight-rank-0.json")
    rec.configure(rank=3, default_dir=None)
    assert rec.dump_path() == str(tmp_path / "flight-rank-3.json")


def test_flight_summary_line_equals_the_reference():
    cases = [
        {},
        {"reason": "sigterm"},
        {"summary": {"last_commit": 7, "slowest_operator": None, "pending_barrier": None}},
        {"reason": "crash: KeyError",
         "summary": {"last_commit": 3, "pending_barrier": "4:1:i0",
                     "slowest_operator": {"name": "groupby", "kind": "groupby", "seconds": 0.0123}}},
    ]
    for payload in cases:
        assert port_profile.flight_summary_line(payload) == ref_profile.flight_summary_line(payload)


def test_trace_hooks_ride_every_dump(tmp_path):
    flushed = []
    port_profile.register_trace_hooks(lambda: [{"span": "commit"}],
                                      lambda d, reason: flushed.append((d, reason)))
    try:
        rec = port_profile.FlightRecorder()
        path = rec.dump("fence", directory=str(tmp_path))
        assert json.loads(open(path).read())["trace"] == [{"span": "commit"}]
        assert flushed == [(str(tmp_path), "fence")]
        port_profile.register_trace_hooks(lambda: 1 / 0, lambda d, r: 1 / 0)
        assert rec.dump("fence", directory=str(tmp_path)) == path  # never raises
    finally:
        port_profile.register_trace_hooks(None, None)


def test_recorder_is_process_wide_and_reset_keeps_its_config():
    rec = port_profile.get_flight_recorder()
    assert port_profile.get_flight_recorder() is rec
    rec.record_event("brownout", action="engage")
    port_profile.reset_profile()
    assert rec.payload("x")["events"] == []
    assert port_profile.get_flight_recorder() is rec


# -- the same pipelines through both packages' pw.run --------------------------------

# Each pipeline runs with ``pw.run(with_http_server=True)``, and ``/metrics``
# is scraped at the stream's end. Runs in a process of its own: daemon servers that other test files leave
# running feed each package's process-wide profiler, so totals read in this
# process would not be the pipelines' own.
_PIPELINES = r'''
import json, os, socket, sys, urllib.request
import numpy as np

def build(pw, G, which, on_end):
    G.clear()
    if which == "groupby_retractions":
        t = pw.debug.table_from_markdown("""
        a | b | __time__ | __diff__
        1 | 10 | 2 | 1
        2 | 20 | 2 | 1
        1 | 11 | 4 | 1
        1 | 10 | 6 | -1
        3 | 30 | 6 | 1
        """)
        out = t.groupby(pw.this.a).reduce(pw.this.a, n=pw.reducers.count(), s=pw.reducers.sum(pw.this.b))
    elif which == "filter_select_join":
        rng = np.random.default_rng(5)
        rows = [(int(k), int(v)) for k, v in zip(rng.integers(0, 8, 40), rng.integers(0, 100, 40))]
        left = pw.debug.table_from_rows(pw.schema_builder({"k": int, "v": int}), rows)
        right = pw.debug.table_from_rows(pw.schema_builder({"k": int, "w": int}),
                                         [(k, k * 3) for k in range(0, 8, 2)])
        f = left.filter(pw.this.v > 30).select(pw.this.k, v2=pw.this.v * 2)
        out = f.join_left(right, f.k == right.k).select(k=f.k, v2=f.v2, w=right.w)
    else:  # flatten_concat
        t = pw.debug.table_from_markdown("""
        xs
        1
        2
        """).select(xs=pw.apply_with_type(lambda x: tuple(range(x)), tuple, pw.this.xs))
        u = pw.debug.table_from_markdown("""
        xs
        3
        """).select(xs=pw.apply_with_type(lambda x: tuple(range(x)), tuple, pw.this.xs))
        out = t.concat_reindex(u).flatten(pw.this.xs)
    pw.io.subscribe(out, on_change=lambda *a, **k: None, on_end=on_end)

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

def run(pkg, which):
    if pkg == "ref":
        import pathway_tpu as pw
        from pathway_tpu.engine import profile, telemetry
        from pathway_tpu.internals.parse_graph import G
        kwargs = {}
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import profile, telemetry
        from pathway_tpu_torch.internals.parse_graph import G
        kwargs = {"device": "cpu"}
    port = free_port()
    os.environ["PATHWAY_MONITORING_HTTP_PORT"] = str(port)
    scraped = []

    def on_end():
        # the stream's end, the run's endpoint still up: the same stage
        # counter and histogram in both (the reference's run adds lint.*)
        telemetry.stage_reset()
        telemetry.stage_add("embed.cache_hits", 5)
        profile.histogram("pathway_rest_latency_seconds").observe(0.004)
        scraped.append(urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics").read().decode())

    profile.reset_profile()
    build(pw, G, which, on_end)
    pw.run(with_http_server=True, **kwargs)
    totals = [
        [e["node"], e["name"], e["kind"], e["rows"], e["retractions"], e["calls"]]
        for e in profile.get_profiler().operator_totals()
    ]
    ring = profile.get_flight_recorder().payload("end")["profiles"]
    return {"totals": totals, "metrics": scraped[0] if scraped else "", "commits": profile.get_profiler().commits,
            "ring_commits": [p["commit"] for p in ring],
            # per commit, as a multiset: the port runs the sources first
            "ring_ops": [sorted([o["node"], o["name"], o["kind"], o["rows"], o["retractions"]]
                                for o in p["ops"]) for p in ring]}

out = {}
for which in ("groupby_retractions", "filter_select_join", "flatten_concat"):
    out[which] = {pkg: run(pkg, which) for pkg in ("ref", "port")}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def pipelines():
    # the port has no operator fusion yet: the reference runs its stock
    # per-node dispatch, one profile row per operator as in the port
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "PATHWAY_FUSION": "off"}
    for name in ("PATHWAY_PROFILE", "PATHWAY_FLIGHT_RECORDER", "PATHWAY_FLIGHT_RECORDER_COMMITS",
                 "PATHWAY_PROCESS_ID"):
        env.pop(name, None)
    proc = subprocess.run([sys.executable, "-c", _PIPELINES], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


PIPELINE_NAMES = ["groupby_retractions", "filter_select_join", "flatten_concat"]


@pytest.mark.parametrize("which", PIPELINE_NAMES)
def test_pipeline_operator_totals_equal_the_reference(pipelines, which):
    ref, port = pipelines[which]["ref"], pipelines[which]["port"]
    assert port["totals"] == ref["totals"]
    assert port["commits"] == ref["commits"]
    assert port["ring_commits"] == ref["ring_commits"]
    assert port["ring_ops"] == ref["ring_ops"]
    if which == "groupby_retractions":
        groupby = [t for t in port["totals"] if t[2] == "groupby"]
        assert groupby and groupby[0][4] > 0  # retractions counted


def _families(text: str) -> dict:
    from .utils import validate_openmetrics

    fams = validate_openmetrics(text)
    return {
        name: (fam["type"], sorted({json.dumps(s[1], sort_keys=True) for s in fam["samples"]}))
        for name, fam in fams.items()
    }


@pytest.mark.parametrize("which", PIPELINE_NAMES)
def test_pipeline_metric_families_and_labels_equal_the_reference(pipelines, which):
    ref, port = pipelines[which]["ref"], pipelines[which]["port"]
    assert port["metrics"], "the port's /metrics did not answer at the stream's end"
    port_fams = _families(port["metrics"])
    assert port_fams == _families(ref["metrics"])
    for fam in ("pathway_operator_seconds", "pathway_operator_rows",
                "pathway_operator_retractions", "pathway_commit_duration_seconds",
                "pathway_rest_latency_seconds", "pathway_stage", "commits"):
        assert fam in port_fams, fam
