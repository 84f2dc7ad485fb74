"""The port's monitoring surface on the CPU: ``MonitoringServer``
(``/status``, ``/metrics``, ``/healthz``), ``pw.run(with_http_server=True)``
across back-to-back runs, the strict OpenMetrics grammar over the whole plane
(serving histograms included), the ``engine`` key of ``/v1/statistics``, the
serving path's histograms and flight events under the reference's names,
``MonitoringLevel`` and the plain-lines monitor, the crash dump, and an
import of the package with ``opentelemetry``, ``psutil`` and ``rich``
absent.

Where the reference computes the same thing from the same inputs (the
brownout ladder's events, the encoder service's queue-depth and occupancy
histograms, the tiered store's events and ratio histograms), the port's
values must equal the reference's; wall-clock values (``ts``, seconds) are
left out."""

from __future__ import annotations

import ast
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pathway_tpu_torch as pw
from pathway_tpu.engine import profile as ref_profile
from pathway_tpu.engine import telemetry as ref_tel
from pathway_tpu_torch.engine import profile as port_profile
from pathway_tpu_torch.engine import telemetry as port_tel
from pathway_tpu_torch.engine.http_server import (
    DEFAULT_MONITORING_HTTP_PORT,
    MonitoringServer,
    ProberStats,
    maybe_start_http_server,
)
from pathway_tpu_torch.engine.runner import COMMIT_LOG_LEN, GraphRunner
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.trace import EngineErrorWithTrace

from .utils import validate_openmetrics

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pathway_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_planes():
    from pathway_tpu.engine.brownout import reset_brownout as ref_reset
    from pathway_tpu_torch.engine.brownout import reset_brownout as port_reset

    for mod in (ref_profile, port_profile):
        mod.reset_profile()
    ref_reset()
    port_reset()
    yield
    for mod in (ref_profile, port_profile):
        mod.reset_profile()
    ref_reset()
    port_reset()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _get(url: str) -> tuple:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in ("ts", "ts_mono", "pid")}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


def _events(mod, kind: str) -> list:
    return [_strip(e) for e in mod.get_flight_recorder().payload("t")["events"] if e["kind"] == kind]


def _small_graph(on_commit=None):
    G.clear()
    t = pw.debug.table_from_markdown(
        """
        a | __time__ | __diff__
        1 | 2        | 1
        2 | 2        | 1
        1 | 4        | -1
        """
    )
    out = t.groupby(pw.this.a).reduce(pw.this.a, n=pw.reducers.count())
    pw.io.subscribe(out, on_change=on_commit or (lambda *a, **k: None))


# -- MonitoringServer -----------------------------------------------------------


def test_status_and_metrics_serve_the_plane_and_healthz_reports_liveness():
    stats = ProberStats()
    stats.record_commit(3, 2, {0: 3}, False)
    # the stage counters are process-wide: an earlier test file on this
    # worker whose embed cache hit has left this one above 0
    port_tel.stage_reset("embed.cache_hits")
    port_tel.stage_add("embed.cache_hits", 5)
    port_profile.histogram("pathway_rest_latency_seconds").observe(0.004)
    server = MonitoringServer(stats, 0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        for path in ("/status", "/metrics"):
            status, ctype, body = _get(base + path)
            assert status == 200 and ctype == "application/openmetrics-text"
            fams = validate_openmetrics(body)
            assert fams["commits"]["samples"] == [("commits_total", {}, 1.0)]
            assert fams["input_rows"]["samples"] == [("input_rows_total", {}, 3.0)]
            assert fams["pathway_rest_latency_seconds"]["type"] == "histogram"
            stages = {s[1]["stage"]: s[2] for s in fams["pathway_stage"]["samples"]}
            assert stages["embed.cache_hits"] == 5
        status, ctype, body = _get(base + "/healthz")
        assert (status, ctype) == (200, "application/json")
        assert json.loads(body) == {"alive": True, "state": "running"}
        server.health_source = lambda: {"commit": 7}
        assert json.loads(_get(base + "/healthz")[2]) == {"alive": True, "commit": 7, "state": "running"}

        def failing():
            raise TimeoutError("peer gone")

        server.health_source = failing
        assert json.loads(_get(base + "/healthz")[2]) == {
            "alive": True, "error": "peer gone", "state": "degraded"}
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/nope")
        assert err.value.code == 404
    finally:
        port_tel.stage_reset("embed.cache_hits")
        server.close()
        server.close()  # idempotent


def test_label_escaping_round_trips_through_the_strict_grammar():
    port_tel.stage_add('we"ird\\stage', 1)
    port_tel.stage_add("join(a,b){x}", 2)
    try:
        fams = validate_openmetrics(ProberStats().to_openmetrics())
        values = {s[1]["stage"]: s[2] for s in fams["pathway_stage"]["samples"]}
        assert values['we\\"ird\\\\stage'] == 1
        assert values["join(a,b){x}"] == 2
    finally:
        port_tel.stage_reset()


def test_the_monitoring_port_follows_the_reference_config(monkeypatch):
    from pathway_tpu.internals.config import PathwayConfig as RefConfig
    from pathway_tpu_torch.internals.config import PathwayConfig, env_float, get_pathway_config

    for raw in (None, "", "21000", "junk"):
        if raw is None:
            monkeypatch.delenv("PATHWAY_MONITORING_HTTP_PORT", raising=False)
        else:
            monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", raw)
        monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
        assert vars(PathwayConfig.from_env()) == vars(RefConfig.from_env())
    assert get_pathway_config().process_id == 1
    monkeypatch.setenv("PATHWAY_X", "2.5")
    assert env_float("PATHWAY_X", 1.0) == 2.5 and env_float("PATHWAY_Y", 1.0) == 1.0
    assert DEFAULT_MONITORING_HTTP_PORT == 20000
    base = _free_port()
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(base - 1))
    assert maybe_start_http_server(ProberStats(), False) is None
    server = maybe_start_http_server(ProberStats(), True)
    try:
        assert server is not None and server.port == base  # base + process_id
        # the port in use: a warning and no server, never a failed run
        assert maybe_start_http_server(ProberStats(), True) is None
    finally:
        server.close()


def test_back_to_back_runs_serve_metrics_and_release_the_port(monkeypatch):
    port = _free_port()
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
    monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)
    for _run in range(2):
        scraped = []

        def on_change(*_a, **_k):
            scraped.append(_get(f"http://127.0.0.1:{port}/metrics")[2])

        _small_graph(on_change)
        pw.run(with_http_server=True, device="cpu")
        assert scraped, "the monitoring endpoint did not answer during the run"
        # the last change is delivered in the second commit: the first
        # commit's profile is in
        fams = validate_openmetrics(scraped[-1])
        assert fams["commits"]["samples"] == [("commits_total", {}, 1.0)]
        assert "pathway_operator_seconds" in fams
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            # released when the run ended (a listener may rebind over the
            # closed connections' TIME_WAIT, as the next run's does)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))


def test_a_stepped_run_closes_the_endpoint(monkeypatch):
    port = _free_port()
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
    _small_graph()
    runner = GraphRunner(G)
    runner.run(max_commits=1, with_http_server=True, device="cpu")
    assert runner._http_server is None
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))


# -- the runner's hooks -----------------------------------------------------------


def test_profiling_gate_and_commit_log_bound(monkeypatch):
    monkeypatch.setenv("PATHWAY_PROFILE", "0")
    _small_graph()
    runner = GraphRunner(G)
    runner.run(device="cpu")
    assert runner._profiler is None and runner._profile_ops is None
    assert port_profile.get_profiler().commits == 0
    assert runner.prober_stats.commits == 3
    monkeypatch.setenv("PATHWAY_PROFILE", "1")
    from pathway_tpu_torch.engine.expression_evaluator import get_runtime

    tokens = []
    _small_graph(lambda *a, **k: tokens.append(get_runtime()["commit_token"]))
    runner = GraphRunner(G)
    runner.run(device="cpu")
    assert runner._profiler is port_profile.get_profiler()
    ring = port_profile.get_flight_recorder().payload("t")["profiles"]
    assert [p["commit"] for p in ring] == [0, 1, 2]
    assert runner.commit_log.maxlen == COMMIT_LOG_LEN
    # the sink sees the commit it runs in: one token per commit that moved rows
    assert sorted(set(tokens)) == [(id(runner), 0), (id(runner), 1)]


def test_a_crashing_run_dumps_the_flight_recorder(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER_DIR", str(tmp_path))
    G.clear()
    t = pw.debug.table_from_markdown(
        """
        a
        1
        """
    )

    def boom(x: int) -> int:
        raise RuntimeError("operator exploded")

    pw.io.subscribe(t.select(b=pw.apply_with_type(boom, int, pw.this.a)), lambda *a, **k: None)
    # the operator's error reaches the caller wrapped with its user line, as
    # in the reference, and the dump names what reached the runner's top
    with pytest.raises(EngineErrorWithTrace) as err:
        pw.run(device="cpu")
    assert isinstance(err.value.cause, RuntimeError)
    payload = json.loads((tmp_path / "flight-rank-0.json").read_text())
    assert payload["reason"] == "crash: EngineErrorWithTrace"
    assert payload["rank"] == 0
    assert "last commit" in port_profile.flight_summary_line(payload)


def test_no_dump_directory_no_dump(tmp_path, monkeypatch):
    monkeypatch.delenv("PATHWAY_FLIGHT_RECORDER_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    G.clear()
    t = pw.debug.table_from_markdown("a\n1")
    pw.io.subscribe(t.select(b=pw.apply_with_type(lambda x: 1 // 0, int, pw.this.a)),
                    lambda *a, **k: None)
    with pytest.raises(EngineErrorWithTrace) as err:
        pw.run(device="cpu")
    assert isinstance(err.value.cause, ZeroDivisionError)
    assert not list(tmp_path.iterdir())
    assert port_profile.get_flight_recorder().dumps == 0


def test_monitoring_levels_equal_the_reference_and_plain_lines_print(capsys):
    from pathway_tpu.internals.monitoring import MonitoringLevel as RefLevel

    assert [(m.name, m.value) for m in pw.MonitoringLevel] == [(m.name, m.value) for m in RefLevel]
    _small_graph()
    pw.run(monitoring_level=pw.MonitoringLevel.ALL, device="cpu")
    err = capsys.readouterr().err
    assert "[pathway-tpu-torch] commit=" in err and "rows_processed=" in err
    _small_graph()
    pw.run(monitoring_level="none", device="cpu")
    assert "[pathway-tpu-torch]" not in capsys.readouterr().err


# -- serving histograms and events under the reference's names ----------------------


def _literal_calls(root: str, funcs: set) -> set:
    out = set()
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
                if name in funcs and isinstance(node.args[0], ast.Constant):
                    out.add(node.args[0].value)
    return out


PORT_HISTOGRAMS = {
    "pathway_commit_duration_seconds",
    "pathway_rest_latency_seconds",
    "pathway_encsvc_queue_depth_rows",
    "pathway_encsvc_tick_occupancy",
    "pathway_encsvc_tick_seconds",
    "pathway_ivf_prefetch_stall_seconds",
    "pathway_ivf_tier_hit_ratio",
    "pathway_ivf_tier_occupancy_ratio",
    "pathway_ivf_quant_rescore_depth",
    "pathway_ivf_quant_recall_ratio",
}


def test_histogram_and_event_names_are_the_reference_names():
    ref_root = os.path.join(REPO, "pathway_tpu")
    port_hists = _literal_calls(PKG, {"histogram"})
    assert port_hists == PORT_HISTOGRAMS
    assert port_hists <= _literal_calls(ref_root, {"histogram", "_histogram"})
    events = _literal_calls(PKG, {"record_event", "_record_event"})
    assert events == {"brownout", "quant_swap", "index_rebuild", "index_swap",
                      # the chaos harness's kills and the tiered store's quant abort
                      "chaos_kill", "chaos_checkpoint_kill", "chaos_rebuild_kill",
                      "chaos_replica_kill", "chaos_quant_kill",
                      # the deterministic scheduler's failing schedules
                      "modelcheck"}
    assert events <= port_tel.FLIGHT_EVENT_KINDS
    assert port_tel.FLIGHT_EVENT_KINDS == ref_tel.FLIGHT_EVENT_KINDS
    assert port_tel.STAGE_NAMESPACES == ref_tel.STAGE_NAMESPACES
    assert port_tel.TRACE_SPAN_KINDS == ref_tel.TRACE_SPAN_KINDS
    stages = _literal_calls(PKG, {"stage_add", "stage_timer"})
    for name in stages:
        assert any(name.startswith(ns) for ns in port_tel.STAGE_NAMESPACES), name


def test_brownout_events_equal_the_reference():
    from pathway_tpu.engine.brownout import BrownoutState as RefState
    from pathway_tpu_torch.engine.brownout import BrownoutState

    rng = np.random.default_rng(3)
    samples = np.concatenate([rng.uniform(0.0, 1.0, 40), np.full(5, 0.95), np.zeros(10)])
    ref, port = RefState(enabled=True, hold_s=0.05), BrownoutState(enabled=True, hold_s=0.05)
    for i, frac in enumerate(samples):
        now = 100.0 + 0.02 * i
        assert port.observe_occupancy(float(frac), now=now) == ref.observe_occupancy(float(frac), now=now)
    got, want = _events(port_profile, "brownout"), _events(ref_profile, "brownout")
    assert got == want and len(got) >= 2
    assert {e["action"] for e in got} == {"engage", "release"}
    assert set(got[0]) == {"kind", "action", "from_level", "to_level", "occupancy"}
    assert all(e["occupancy"] == round(e["occupancy"], 3) for e in got)


class _HashEncoder:
    dim = 8

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self._first = True

    def encode_device(self, texts):
        if self._first:
            self._first = False
            self.entered.set()
            self.release.wait(timeout=10)
        return np.stack([np.frombuffer(str(t).encode().ljust(8, b"\0")[:8], np.uint8)
                         .astype(np.float32) for t in texts])


def _until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"{what} did not happen in {timeout}s"
        time.sleep(0.005)


def test_encoder_service_histograms_equal_the_reference():
    from pathway_tpu.models import encoder_service as ref_svc
    from pathway_tpu_torch.models import encoder_service as port_svc

    texts = {}
    for name, mod, prof in (("ref", ref_svc, ref_profile), ("port", port_svc, port_profile)):
        enc = _HashEncoder()
        svc = mod.EncoderService(enc, prewarm=False, max_in_flight=64)
        threads = [threading.Thread(target=svc.submit, args=([f"q{i}", f"r{i}"],)) for i in range(12)]
        threads[0].start()
        _until(enc.entered.is_set, what="tick 1")
        for t in threads[1:]:
            t.start()
        _until(lambda: svc.queue_depth_rows() == 24, what="the pile-up")
        enc.release.set()
        for t in threads:
            t.join(timeout=10)
        hists = prof.histograms()
        _until(lambda: hists["pathway_encsvc_tick_seconds"].count == svc.ticks == 2,
               what="the tick observations")
        svc.close()
        texts[name] = {h: "\n".join(hists[h].openmetrics_lines(h, "x"))
                       for h in ("pathway_encsvc_queue_depth_rows", "pathway_encsvc_tick_occupancy")}
        assert hists["pathway_encsvc_tick_occupancy"].sum == (2 + 22) / 64
    assert texts["port"] == texts["ref"]


# -- the tiered store -------------------------------------------------------------------


def _clustered(n, dim, n_centers, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(n_centers, dim)).astype(np.float32)
    docs = (centers[rng.integers(0, n_centers, n)] + rng.normal(size=(n, dim))).astype(np.float32)
    return centers, docs


@pytest.fixture
def _knobs_clear(monkeypatch):
    for name in ("PATHWAY_IVF_TIERED", "PATHWAY_IVF_HBM_BUDGET_MB", "PATHWAY_IVF_QUANT",
                 "PATHWAY_IVF_SPILL_DIR", "PATHWAY_IVF_RESCORE_K", "PATHWAY_IVF_PREFETCH"):
        monkeypatch.delenv(name, raising=False)


def test_tiered_quant_events_and_histograms_equal_the_reference(_knobs_clear):
    from pathway_tpu.ops import knn_tiers as ref_tiers
    from pathway_tpu_torch.ops.knn_tiers import TieredIvfKnnStore

    _, docs = _clustered(3000, 32, 8, seed=1)
    n, dim = docs.shape
    keys = [f"d{i}" for i in range(n)]
    # promotion inline (no prefetch thread): which clusters are hot when a
    # search observes the occupancy histogram must not follow thread timing
    ref = ref_tiers.TieredIvfKnnStore(dim, metric="l2sq", n_clusters=8, n_probe=3, quant="int8",
                                      prefetch=False)
    ref.add_many(keys, docs)
    ref.search_batch(docs[:1], 1)
    sample = docs[np.random.default_rng(0).choice(n, 8 * ref_tiers._TRAIN_SAMPLE_PER_CLUSTER,
                                                  replace=False)] if n > 8 * ref_tiers._TRAIN_SAMPLE_PER_CLUSTER else docs
    cents = ref_tiers._train_centroids(sample, 8, 8)
    port = TieredIvfKnnStore(dim, metric="l2sq", n_clusters=8, n_probe=3, quant="int8", device="cpu",
                             prefetch=False)
    port.add_many(keys, docs)
    port.set_centroids(cents)
    for mod in (ref_profile, port_profile):
        mod.reset_profile()
    for store in (ref, port):
        rng = np.random.default_rng(5)
        for i in range(n):
            if i % 3:
                store.remove(f"d{i}")
        fresh = (docs[rng.integers(0, n, 300)] + 0.5).astype(np.float32)
        store.add_many([f"n{i}" for i in range(300)], fresh)
        store._flush()
        for cid in range(store.n_clusters):
            store._maintain_cluster(cid)
    got, want = _events(port_profile, "quant_swap"), _events(ref_profile, "quant_swap")
    assert got and sorted(map(json.dumps, got)) == sorted(map(json.dumps, want))
    q = docs[::97] + 0.1
    for mod in (ref_profile, port_profile):
        mod.reset_profile()
    for _ in range(3):
        np.testing.assert_array_equal(port.search_batch(q, 10)[1], ref.search_batch(q, 10)[1])
    assert port.quant_recall_audit(q[:8], k=5) == ref.quant_recall_audit(q[:8], k=5)
    port_h, ref_h = port_profile.histograms(), ref_profile.histograms()
    for name in ("pathway_ivf_tier_hit_ratio", "pathway_ivf_tier_occupancy_ratio",
                 "pathway_ivf_quant_rescore_depth", "pathway_ivf_quant_recall_ratio"):
        assert port_h[name].count > 0, name
        assert port_h[name].openmetrics_lines(name, "x") == ref_h[name].openmetrics_lines(name, "x")
    ref.close()
    port.close()


def _rebuilt_store(monkeypatch, torn: bool):
    from pathway_tpu_torch.ops.knn_tiers import TieredIvfKnnStore

    if torn:
        flips = iter([True])
        monkeypatch.setattr(TieredIvfKnnStore, "_swap_torn", lambda self: next(flips, False))
    _, docs = _clustered(1000, 16, 8, seed=15)
    store = TieredIvfKnnStore(16, n_clusters=8, n_probe=8, device="cpu")
    store.add_many([f"d{i}" for i in range(1000)], docs)
    store.search_batch(docs[:4], 3)
    for i in range(1000):
        store.remove(f"d{i}")
    _, fresh = _clustered(1000, 16, 8, seed=16)
    store.add_many([f"n{i}" for i in range(1000)], fresh)
    for _attempt in range(2 if torn else 1):
        store.search_batch(fresh[:1], 1)  # schedules a rebuild
        _until(lambda: store._rebuild_thread is None, timeout=60, what="the rebuild")
        store.search_batch(fresh[:1], 1)  # the commit boundary that swaps
    return store


@pytest.mark.parametrize("torn", [False, True])
def test_rebuild_and_swap_events_carry_the_reference_fields(torn, monkeypatch, _knobs_clear):
    store = _rebuilt_store(monkeypatch, torn)
    rebuilds, swaps = _events(port_profile, "index_rebuild"), _events(port_profile, "index_swap")
    assert len(rebuilds) == (2 if torn else 1)
    assert set(rebuilds[0]) == {"kind", "generation", "clusters", "rows"}
    assert rebuilds[0]["generation"] == 1 and rebuilds[0]["rows"] == 1000
    if torn:
        assert swaps[0] == {"kind": "index_swap", "generation": 1, "torn": True}
        swaps = swaps[1:]
    assert len(swaps) == 1 and set(swaps[0]) == {"kind", "generation", "pause_s", "clusters"}
    assert swaps[0]["generation"] == store.generation == 1
    assert swaps[0]["clusters"] == store.n_clusters
    store.close()


def test_prefetch_stall_histogram_counts_spilled_loads(tmp_path, _knobs_clear):
    from pathway_tpu_torch.ops.knn_tiers import DirSpillStore, TieredIvfKnnStore

    centers, docs = _clustered(4000, 16, 8, seed=5)
    store = TieredIvfKnnStore(16, n_clusters=8, n_probe=2, device="cpu", hbm_budget_bytes=30_000,
                              spill_store=DirSpillStore(str(tmp_path / "spill")))
    store.add_many([f"d{i}" for i in range(4000)], docs)
    rng = np.random.default_rng(6)
    q0 = (centers[np.zeros(8, dtype=int)] + rng.normal(size=(8, 16))).astype(np.float32)
    for _ in range(6):
        store.search_batch(q0, 5)
    assert store.tier_stats()["spilled"] > 0
    port_profile.reset_profile()
    store.search_batch(docs[:32], 5)
    stall = port_profile.histograms()["pathway_ivf_prefetch_stall_seconds"]
    assert stall.count == store.tier_stats()["probe_spilled"] > 0
    assert abs(stall.sum - store.stats["prefetch_stall_s"]) <= store.stats["prefetch_stall_s"]
    hit = port_profile.histograms()["pathway_ivf_tier_hit_ratio"]
    assert hit.count == 1 and hit.sum < 1.0
    store.close()


# -- /v1/statistics and the whole plane through a served store ---------------------------

_TINY = dict(vocab_size=4096, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)


def _docs(n: int = 24) -> list:
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(300)]
    return [
        {"data": " ".join(rng.choice(words, size=int(rng.integers(5, 12)))).encode(),
         "_metadata": {"path": f"/data/doc{i}.txt", "modified_at": 100 + i, "seen_at": 1000 + i}}
        for i in range(n)
    ]


def _server():
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    G.clear()
    docs = _docs()
    embedder = SentenceTransformerEmbedder(
        device="cpu", encoder_service=True,
        encoder_config=EncoderConfig(**_TINY, dtype=torch.float32),
    )
    table = pw.debug.table_from_rows(
        pw.schema_builder({"data": bytes, "_metadata": pw.Json}),
        [(d["data"], pw.Json(d["_metadata"])) for d in docs],
    )
    return docs, VectorStoreServer(table, embedder=embedder)


def _engine_keys() -> tuple:
    ref_profile.get_profiler().record_commit(ref_profile.CommitProfile(
        commit=0, rank=0, duration_s=0.01, input_rows=1, output_rows=1, neu=False,
        ops=[(0, "input", "input", 0.001, 1, 0, False)]))
    snap = ref_profile.get_profiler().snapshot()
    return set(snap), set(snap["commit_duration_ms"]), set(snap["operators"][0])


def test_served_plane_passes_the_strict_grammar_with_rest_and_encoder_histograms(monkeypatch):
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient

    mport = _free_port()
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(mport))
    monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)
    want_keys, want_pct, want_op = _engine_keys()
    port_profile.reset_profile()
    docs, server = _server()
    server.run_server(host="127.0.0.1", port=0, threaded=True, with_http_server=True)
    try:
        client = VectorStoreClient(url=server.webserver.url, timeout=60)
        _until(lambda: client.get_vectorstore_statistics().get("file_count") == len(docs),
               timeout=60, what="ingest")
        answered = 0
        for i, d in enumerate(docs[:6]):  # new texts: each takes a service tick
            assert client.query(d["data"].decode() + f" zz{i}", k=3)
            answered += 1
        stats = client.get_vectorstore_statistics()
        svc = server.embedder.pipeline.service
        hists = port_profile.histograms()
        _until(lambda: hists["pathway_encsvc_tick_seconds"].count == svc.stats()["svc_ticks"] > 0,
               what="the tick observations")
        _status, _ctype, body = _get(f"http://127.0.0.1:{mport}/metrics")
    finally:
        server.close()
    fams = validate_openmetrics(body)
    rest = fams["pathway_rest_latency_seconds"]
    count = [s[2] for s in rest["samples"] if s[0] == "pathway_rest_latency_seconds_count"][0]
    # every answered request: the retrieves and the statistics polls
    n_stats = port_profile.histograms()["pathway_rest_latency_seconds"].count - answered
    assert n_stats >= 2 and count == answered + n_stats
    for name in ("pathway_encsvc_queue_depth_rows", "pathway_encsvc_tick_occupancy",
                 "pathway_encsvc_tick_seconds", "pathway_commit_duration_seconds"):
        assert fams[name]["type"] == "histogram", name
    kinds = {s[1]["kind"] for s in fams["pathway_operator_seconds"]["samples"]}
    assert {"input", "rowwise", "external_index", "output"} <= kinds
    engine = stats["engine"]
    assert set(engine) == want_keys
    assert set(engine["commit_duration_ms"]) == want_pct
    assert engine["operators"] and all(set(op) == want_op for op in engine["operators"])
    assert engine["commits"] >= 1


def test_statistics_engine_value_is_pinned_per_commit():
    from pathway_tpu_torch.debug import _capture_update_stream

    docs, server = _server()
    queries = pw.debug.table_from_markdown(
        """
        q | __time__
        1 | 2
        2 | 2
        3 | 6
        """
    )
    rows = _capture_update_stream(server.statistics_query(queries), device="cpu")
    engines = {}
    for r in rows:
        assert r["__diff__"] == 1
        engines.setdefault(r["__time__"], []).append(r["result"].value["engine"])
    first, later = engines[min(engines)], engines[max(engines)]
    assert len(first) == 2 and first[0] == first[1]
    assert later[0]["commits"] > first[0]["commits"]


# -- without opentelemetry, psutil and rich; without a card --------------------------------


def test_the_package_imports_and_serves_without_optional_packages():
    code = (
        "import sys, json, urllib.request\n"
        "for m in ('opentelemetry', 'psutil', 'rich'):\n"
        "    sys.modules[m] = None\n"
        "import pathway_tpu_torch as pw\n"
        "from pathway_tpu_torch.engine import telemetry\n"
        "from pathway_tpu_torch.engine.http_server import MonitoringServer, ProberStats\n"
        "rec = telemetry.MetricsRecorder.get(ProberStats())\n"
        "assert not rec._enabled\n"
        "rec.record_commit(1, 1, 0.1)\n"
        "with telemetry.span('x', a=1):\n"
        "    pass\n"
        "stats = ProberStats()\n"
        "server = MonitoringServer(stats, 0)\n"
        "body = urllib.request.urlopen(f'http://127.0.0.1:{server.port}/metrics').read().decode()\n"
        "server.close()\n"
        "assert body.endswith('# EOF\\n') and 'commits_total 0' in body\n"
        "t = pw.debug.table_from_markdown('a\\n1\\n2')\n"
        "pw.io.subscribe(t, lambda *a, **k: None)\n"
        "pw.run(monitoring_level=pw.MonitoringLevel.ALL, device='cpu')\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PATHWAY_TELEMETRY": "1", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"
    assert "[pathway-tpu-torch] commit=" in proc.stderr


def test_the_telemetry_off_run_stays_import_free():
    code = (
        "import sys\n"
        "import pathway_tpu_torch as pw\n"
        "t = pw.debug.table_from_markdown('a\\n1\\n2')\n"
        "pw.io.subscribe(t, lambda *a, **k: None)\n"
        "pw.run(monitoring_level=pw.MonitoringLevel.NONE, device='cpu')\n"
        "bad = [m for m in sys.modules if m.startswith(('opentelemetry', 'psutil', 'rich'))]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("PATHWAY_TELEMETRY", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_an_explicit_commit_source_wakes_the_loop_at_its_markers_only():
    """With ``autocommit_duration_ms=None`` only ``commit()`` (and the end)
    wakes the commit loop: rows pushed one by one run no idle commit each."""

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for batch in range(3):
                for i in range(40):
                    self.next(k=f"{batch}-{i}", v=i)
                    time.sleep(0.001)
                self.commit()

    G.clear()
    schema = pw.schema_builder({"k": pw.column_definition(dtype=str, primary_key=True),
                                "v": pw.column_definition(dtype=int)})
    t = pw.io.python.read(Feed(), schema=schema, autocommit_duration_ms=None)
    seen = []
    pw.io.subscribe(t, lambda key, row, time, is_addition: seen.append(row["k"]))
    runner = GraphRunner(G)
    runner.run(device="cpu")
    assert len(seen) == 120
    assert [rows for _s, rows in runner.commit_log] == [40, 40, 40]
    # the three batches, and at most a few wakes at the markers and the end
    assert runner.prober_stats.commits <= 8, runner.prober_stats.commits
