"""REST admission of the port (``pathway_tpu_torch/io/http/_server.py``) and
the slice under concurrent load, on the CPU.

Admission is driven against a live route whose engine is held inside a
gated UDF (a blocked encoder stands behind it): past ``max_pending`` the
route sheds with 429 and an integer ``Retry-After`` before pushing a row;
the overload probe sheds the same way; brownout rung 2 tightens the cap;
the quiesce window answers 429 at once; a noisy client's sheds count under
its own id, at most 32 ids before "other"; a dropped or failed request
releases its slot. Client ids and ``Retry-After`` values are the
reference's on the same inputs.

The slice: a tiny-encoder ``VectorStoreServer`` with the encoder service
on answers 8 client threads' concurrent ``/v1/retrieve`` calls, and the
answers equal the reference's (its ``VectorStoreServer`` graph on the same
documents, weights and queries) to the bar of ``test_torch_vector_store.py``
(texts overlap >= 0.99, ``dist`` within 1e-3: the two encoders' bf16
weights and f16 wire differ by ~5e-4). At forced brownout rung 2 the live
``DocumentStore`` of ``test_torch_document_store_live.py`` (integer
vectors, inner product) answers exactly as the reference's, ``n_probe``
halved in both packages."""

from __future__ import annotations

import concurrent.futures
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.engine import brownout as ref_bo
from pathway_tpu.io.http import _server as ref_server
from pathway_tpu.models.encoder import EncoderConfig as RefConfig
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as RefEmbedder
from pathway_tpu.xpacks.llm.vector_store import VectorStoreServer as RefServer
from pathway_tpu_torch.engine import brownout as port_bo
from pathway_tpu_torch.engine import telemetry
from pathway_tpu_torch.engine.runner import GraphRunner
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector
from pathway_tpu_torch.io.http import _server as port_server
from pathway_tpu_torch.models.encoder import EncoderConfig, params_from_jax
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer
from tests import test_torch_document_store_live as live
from tests.test_torch_vector_store import _TINY, _ask, _docs, _requests

torch.set_num_threads(1)

ROUTE = "/v1/retrieve"


@pytest.fixture(autouse=True)
def fresh_ladders():
    ref_bo.reset_brownout()
    port_bo.reset_brownout()
    yield
    ref_bo.reset_brownout()
    port_bo.reset_brownout()


class _Route:
    """A live REST route whose engine echoes the request's text through a UDF
    held at ``gate`` (set: open)."""

    def __init__(self, **admission):
        self.gate = threading.Event()
        self.entered = []
        G.clear()
        self.ws = PathwayWebserver(host="127.0.0.1", port=0)

        class Q(pw.Schema):
            text: str

        queries, writer = rest_connector(
            webserver=self.ws, route=ROUTE, schema=Q, delete_completed_queries=True, **admission
        )

        def echo(text: str) -> str:
            self.entered.append(text)
            self.gate.wait(30)
            return text

        writer(queries.select(result=pw.apply(echo, pw.this.text)))
        self.runner = GraphRunner(G)
        self.thread = threading.Thread(target=lambda: self.runner.run(device="cpu"), daemon=True)
        self.thread.start()
        self.ws.wait_for_routes([ROUTE])
        self.subject = self.ws.subjects[ROUTE]

    def post(self, text: str, client: str = "c", timeout: float = 30.0):
        """(status, Retry-After or None, body, seconds)."""
        req = urllib.request.Request(
            self.ws.url + ROUTE, data=json.dumps({"text": text}).encode(),
            headers={"Content-Type": "application/json", "X-Pathway-Client": client},
        )
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.headers.get("Retry-After"), json.loads(r.read()), time.monotonic() - t0
        except urllib.error.HTTPError as exc:
            return exc.code, exc.headers.get("Retry-After"), json.loads(exc.read()), time.monotonic() - t0

    def in_flight(self) -> int:
        return len(self.subject.futures)

    def close(self) -> None:
        self.gate.set()
        self.ws.close()
        self.runner.stop()
        self.thread.join(timeout=30)
        G.clear()


def _until(pred, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"{what} did not happen in {timeout}s"
        time.sleep(0.005)


def _background(fn, *args):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return fut


def test_sheds_past_max_pending_with_an_integer_retry_after():
    route = _Route(max_pending=2, retry_after=lambda: 2.5)
    try:
        a = _background(route.post, "first")
        _until(lambda: route.entered == ["first"], what="the engine holding 'first'")
        b = _background(route.post, "second")
        _until(lambda: route.in_flight() == 2, what="two requests in flight")
        before = telemetry.stage_snapshot("rest.shed").get("rest.shed", 0.0)
        status, retry, body, took = route.post("third")
        assert (status, retry) == (429, "3") and "cap 2" in body["error"]
        assert retry == ref_bo.retry_after_int(2.5)
        assert telemetry.stage_snapshot("rest.shed")["rest.shed"] == before + 1
        assert route.subject.shed_requests == 1 and "third" not in route.entered
        route.gate.set()
        assert a.result(timeout=30)[:3:2] == (200, "first")
        assert b.result(timeout=30)[:3:2] == (200, "second")
        assert route.post("fourth")[:3:2] == (200, "fourth")
        _until(lambda: route.in_flight() == 0, what="every slot released")
    finally:
        route.close()


def test_overload_probe_sheds_before_the_push():
    full = [True]
    route = _Route(overload_probe=lambda: full[0], retry_after=lambda: 0.2)
    try:
        route.gate.set()
        status, retry, body, _t = route.post("probe")
        assert (status, retry) == (429, "1") and "embed queue full" in body["error"]
        assert route.entered == [] and route.in_flight() == 0
        full[0] = False
        assert route.post("probe")[:3:2] == (200, "probe")
    finally:
        route.close()


def test_brownout_rung_two_tightens_the_cap():
    route = _Route(max_pending=4)
    try:
        assert port_bo.get_brownout().observe_occupancy(0.9) == 2  # cap 4 x 0.25 = 1
        a = _background(route.post, "held")
        _until(lambda: route.in_flight() == 1, what="one request in flight")
        status, retry, body, _t = route.post("over")
        assert (status, retry) == (429, "1")
        assert "cap 1" in body["error"] and "brownout rung 2" in body["error"]
        port_bo.reset_brownout()
        route.gate.set()
        assert a.result(timeout=30)[0] == 200
    finally:
        route.close()


def test_quiesce_window_answers_429_and_does_not_hang():
    route = _Route(max_pending=64)
    try:
        route.gate.set()
        assert route.post("before")[0] == 200
        port_bo.get_brownout().enter_quiesce(3.0)
        before = telemetry.stage_snapshot("rest.").get("rest.quiesce_shed", 0.0)
        status, retry, _body, took = route.post("during")
        assert (status, retry) == (429, "3") and took < 2.0
        assert telemetry.stage_snapshot("rest.")["rest.quiesce_shed"] == before + 1
        port_bo.get_brownout().exit_quiesce()
        assert route.post("after")[:3:2] == (200, "after")
    finally:
        route.close()


def test_noisy_client_sheds_are_its_own_and_bounded():
    route = _Route(max_pending=1)
    try:
        held = _background(route.post, "held", "polite")
        _until(lambda: route.in_flight() == 1, what="one request in flight")
        flood = [route.post("flood", "flood") for _ in range(6)]
        assert all(s == 429 and r == "1" for s, r, _b, _t in flood)
        polite = route.post("polite 1", "polite")
        assert polite[0] == 429 and polite[3] < 5.0  # shed fast, not parked
        for i in range(40):  # rotating ids fold into "other" past 32
            assert route.post("x", f"id{i}")[0] == 429
        counts = telemetry.stage_snapshot("rest.shed.client.")
        assert counts["rest.shed.client.flood"] >= 6 and route.subject.shed_by_client["flood"] == 6
        assert route.subject.shed_by_client["polite"] == 1
        assert len(route.subject.shed_by_client) == 33 and route.subject.shed_by_client["other"] == 10
        route.gate.set()
        assert held.result(timeout=30)[0] == 200
        assert route.post("polite 2", "polite")[:3:2] == (200, "polite 2")
    finally:
        route.close()


def test_a_dropped_request_releases_its_slot():
    route = _Route(max_pending=2)
    try:
        held = _background(route.post, "held")
        _until(lambda: route.entered == ["held"], what="the engine holding 'held'")
        body = json.dumps({"text": "dropped"}).encode()
        with socket.create_connection(("127.0.0.1", route.ws.port)) as sock:
            sock.sendall(
                f"POST {ROUTE} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body
            )
            _until(lambda: route.in_flight() == 2, what="the dropped request admitted")
        # the client hung up while the engine still holds 'held': its slot frees
        _until(lambda: route.in_flight() == 1, what="the dropped request's slot released")
        later = _background(route.post, "later")
        _until(lambda: route.in_flight() == 2, what="'later' admitted")
        route.gate.set()
        assert held.result(timeout=30)[:3:2] == (200, "held")
        assert later.result(timeout=30)[:3:2] == (200, "later")
        _until(lambda: route.in_flight() == 0, what="every slot released")
    finally:
        route.close()


def test_a_failed_request_releases_its_slot():
    route = _Route(max_pending=1)
    try:
        pending = _background(route.post, "pending")
        _until(lambda: route.in_flight() == 1, what="one request in flight")
        route.ws.close()  # the server closes before the engine answers
        status = pending.result(timeout=30)[0]
        assert status == 500
        _until(lambda: route.in_flight() == 0, what="the failed request's slot released")
    finally:
        route.close()


@pytest.mark.parametrize(
    "raw",
    [None, "", "flood", "Client-7_x", "a b/c;d", "ü" * 10, "x" * 80, "../../etc", "-_-"],
)
def test_client_ids_equal_the_reference(raw):
    headers = {} if raw is None else {"X-Pathway-Client": raw}
    assert port_server._client_id(headers) == ref_server._client_id(
        types.SimpleNamespace(headers=headers)
    )
    assert port_server._MAX_SHED_CLIENTS == ref_server._MAX_SHED_CLIENTS == 32


# -- the slice under concurrent load --------------------------------------------------


def _reference_answers(docs, reqs, ref_embedder):
    """The reference ``VectorStoreServer`` graph on the documents, with the
    queries a commit after them, run to its end."""
    from pathway_tpu.engine.runner import GraphRunner as RefRunner
    from pathway_tpu.internals.parse_graph import G as REF_G

    REF_G.clear()
    table = ref_pw.debug.table_from_rows(
        ref_pw.schema_builder({"data": bytes, "_metadata": ref_pw.Json}),
        [(d["data"], ref_pw.Json(d["_metadata"])) for d in docs],
    )
    server = RefServer(table, embedder=ref_embedder, index_factory="ivf")
    schema = ref_pw.schema_builder({
        "qid": ref_pw.column_definition(dtype=int, primary_key=True),
        "query": str, "k": int,
        "metadata_filter": ref_pw.column_definition(dtype=str | None),
        "filepath_globpattern": ref_pw.column_definition(dtype=str | None),
    })
    rows = [(i, r["query"], r["k"], r.get("metadata_filter"), r.get("filepath_globpattern"), 2, 1)
            for i, r in enumerate(reqs)]
    queries = ref_pw.debug.table_from_rows(schema, rows, is_stream=True)
    result = server.retrieve_query(queries)
    qid_of, answer_of = {}, {}
    ref_pw.io.subscribe(
        queries, on_change=lambda key, row, time, is_addition: qid_of.__setitem__(key, row["qid"])
    )
    ref_pw.io.subscribe(
        result,
        on_change=lambda key, row, time, is_addition: answer_of.__setitem__(key, row["result"])
        if is_addition else None,
    )
    RefRunner(REF_G._current).run(monitoring_level=ref_pw.MonitoringLevel.NONE)
    REF_G.clear()
    out = [None] * len(reqs)
    for key, qid in qid_of.items():
        value = answer_of[key]
        out[qid] = json.loads(json.dumps(value.value if hasattr(value, "value") else value))
    return out


def test_concurrent_retrieve_equals_the_reference():
    docs = _docs()
    reqs = _requests(docs)
    ref_embedder = RefEmbedder(encoder_config=RefConfig(**_TINY, dtype=jnp.float32),
                               encsvc_prewarm=False)
    want = _reference_answers(docs, reqs, ref_embedder)
    params = params_from_jax(jax.tree.map(np.asarray, ref_embedder.encoder.params))
    embedder = SentenceTransformerEmbedder(
        device="cpu", params=params, encoder_config=EncoderConfig(**_TINY, dtype=torch.float32)
    )
    assert embedder.pipeline.service is not None  # the default path is under test
    G.clear()
    table = pw.debug.table_from_rows(
        pw.schema_builder({"data": bytes, "_metadata": pw.Json}),
        [(d["data"], pw.Json(d["_metadata"])) for d in docs],
    )
    server = VectorStoreServer(table, embedder=embedder, index_factory="ivf")
    server.run_server(host="127.0.0.1", port=0, threaded=True)
    try:
        client = VectorStoreClient(url=server.webserver.url, timeout=60)
        _ask(client, reqs[0])  # trains the index
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda r: _ask(client, r), reqs))
        stats = client.get_vectorstore_statistics()["embedder"]
    finally:
        server.close()
        G.clear()
    overlaps = []
    for req, a, b in zip(reqs, want, got):
        ta = {x["text"]: x["dist"] for x in a}
        tb = {x["text"]: x["dist"] for x in b}
        assert len(b) == len(a), req
        overlaps.append(len(ta.keys() & tb.keys()) / max(len(ta), 1))
        for t in ta.keys() & tb.keys():
            assert abs(ta[t] - tb[t]) <= 1e-3, (req, t, ta[t], tb[t])
    assert np.mean(overlaps) >= 0.99, overlaps
    # the answers went through the service, and nothing was shed
    assert stats["svc_rows"] >= 1 and stats["coalesce_shed_requests"] == 0
    assert server.webserver.subjects[ROUTE].shed_requests == 0
    assert set(stats) >= {"cache_hits", "coalesce_requests", "semantic_exact_hits",
                          "svc_ticks", "pad_waste_ratio"}


def test_rung_two_live_document_store_equals_the_reference_exactly():
    for ladder in (ref_bo.get_brownout(), port_bo.get_brownout()):
        assert ladder.observe_occupancy(0.9) == 2
    want = live._run(live.REF, "ivf", live._int_vec, live.ref_nn.BruteForceKnnMetricKind.IP)
    got = live._run(live.PORT, "ivf", live._int_vec, live.port_nn.BruteForceKnnMetricKind.IP)
    assert ref_bo.get_brownout().level() == port_bo.get_brownout().level() == 2
    assert sorted(got) == sorted(want)
    for phase_stream in want:
        assert got[phase_stream] == want[phase_stream], phase_stream
    # one probe of two clusters: some answers are not full-probe answers
    port_bo.reset_brownout()
    ref_bo.reset_brownout()
    full = live._run(live.PORT, "ivf", live._int_vec, live.port_nn.BruteForceKnnMetricKind.IP)
    assert any(full[k] != got[k] for k in got if k[1] == "retrieve")


def test_a_burst_of_clients_is_accepted_not_reset():
    """64 clients at once, each opening a connection per request: the listen
    backlog holds the burst (with the standard library's default of 5 the
    kernel resets or delays the overflow by its SYN retry, 1 s then 3 s)."""
    from pathway_tpu_torch.io.http import JsonServer

    server = JsonServer("127.0.0.1", 0, {"/x": lambda req: (time.sleep(0.02), req.payload)[1]})
    server.start()
    try:
        def one(i):
            req = urllib.request.Request(server.url + "/x", data=json.dumps({"i": i}).encode())
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return json.loads(r.read()) == {"i": i}
            except OSError:
                return False

        with concurrent.futures.ThreadPoolExecutor(64) as pool:
            ok = list(pool.map(one, range(512)))
    finally:
        server.close()
    assert all(ok), f"{ok.count(False)} of 512 requests failed"
