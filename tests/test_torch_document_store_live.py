"""A live ``DocumentStore`` on the port's engine against the reference's.

Documents stream in through a python connector (keyed by ``path``) and
queries through three more; the same script of steps drives both engines:
add documents, query, replace documents (``_remove`` of the old row and the
new row under the same key, in one commit), query, remove a document, query.
``retrieve_query``, ``statistics_query`` and ``inputs_query`` are captured
with ``pw.io.subscribe``, and each step's updates (key, diff, values) must be
equal. Commit boundaries follow the connector threads' timing in both
engines, so a step's updates are compared as a multiset.

The embedder maps a text to an integer vector (word hashes weighted into 16
buckets) and the index scores by inner product, so every score is exact and
the answers must be identical, with the brute-force index and with IVF
(every cluster probed, so the answer does not depend on how k-means splits
the corpus). Equal scores would rank by the IVF page layout, which follows
k-means; the script's queries have no equal scores among their top k + 1
(checked), so the order is the scores'. The reference's CPU IVF search is held against its Pallas
kernel in interpret mode on the final corpus. A float embedder (cosine)
then asks for identical top-k id sets apart from near-tie swaps and scores
within rtol 1e-5.
"""

from __future__ import annotations

import threading
import time
import zlib

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.engine.runner import GraphRunner as RefRunner
from pathway_tpu.internals import expression as ref_expr
from pathway_tpu.internals import udfs as ref_udfs
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu.stdlib.indexing import nearest_neighbors as ref_nn
from pathway_tpu.xpacks.llm.document_store import DocumentStore as RefDocumentStore
from pathway_tpu_torch.engine.runner import GraphRunner
from pathway_tpu_torch.internals import expression as port_expr
from pathway_tpu_torch.internals import udfs as port_udfs
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as port_nn
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore


@pytest.fixture(autouse=True, scope="module")
def _ladders_at_rung_zero():
    """Both packages' brownout ladders start at rung 0: another test file in
    this process may have left one engaged, and rung 2 halves IVF n_probe."""
    from pathway_tpu.engine.brownout import reset_brownout as ref_reset
    from pathway_tpu_torch.engine.brownout import reset_brownout as port_reset

    ref_reset()
    port_reset()
    yield


DIM = 16
K = 3
VOCAB = [f"w{i}" for i in range(3000)]


def _int_vec(text: str) -> np.ndarray:
    v = np.zeros(DIM, dtype=np.float32)
    for word in str(text).split():
        h = zlib.crc32(word.encode())
        v[h % DIM] += (h >> 8) % 121 - 60
        v[(h >> 16) % DIM] += (h >> 24) % 61 - 30
    return v


def _float_vec(text: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(str(text).encode()))
    return rng.normal(size=DIM).astype(np.float32)


class _Side:
    """One package's pieces: ``pw`` module, UDF base, expressions, store,
    factories and graph."""

    def __init__(self, mod, udfs, expr, store_cls, nn, graph, runner_cls, run_kwargs, factory_kwargs):
        self.pw, self.udfs, self.expr, self.store_cls, self.nn = mod, udfs, expr, store_cls, nn
        self.graph, self.runner_cls = graph, runner_cls
        self.run_kwargs, self.factory_kwargs = run_kwargs, factory_kwargs

    def embedder(self, vec):
        expr = self.expr

        class Embedder(self.udfs.UDF):
            def __init__(self):
                super().__init__()
                self.func = vec

            def __call__(self, column):
                return expr.BatchApplyExpression(
                    lambda texts: [vec(t) for t in texts], np.ndarray, False, True, (column,), {}
                )

            def get_embedding_dimension(self, **kwargs):
                return DIM

        return Embedder()

    def splitter(self):
        class ThreeWords(self.udfs.UDF):
            def __init__(self):
                super().__init__()

                def split(txt, metadata=None):
                    words = str(txt).split()
                    meta = metadata if metadata is not None else {}
                    return [(" ".join(words[i : i + 3]), meta) for i in range(0, len(words), 3)]

                self.func = split

        return ThreeWords()

    def factory(self, kind, vec, metric):
        emb = self.embedder(vec)
        if kind == "ivf":
            return self.nn.IvfKnnFactory(
                dimensions=DIM, n_clusters=2, n_probe=2, metric=metric, embedder=emb,
                **self.factory_kwargs,
            )
        return self.nn.BruteForceKnnFactory(
            dimensions=DIM, metric=metric, embedder=emb, **self.factory_kwargs
        )


REF = _Side(ref_pw, ref_udfs, ref_expr, RefDocumentStore, ref_nn, REF_G, RefRunner, {}, {})
PORT = _Side(pw, port_udfs, port_expr, DocumentStore, port_nn, PORT_G, GraphRunner,
             {"device": "cpu"}, {"device": "cpu"})


def _docs(seed: int, n: int, tag: str) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        words = rng.choice(VOCAB, size=int(rng.integers(4, 10)))
        path = f"/data/{i % 3}/doc{i}.txt"
        out[path] = {
            "data": " ".join(words),
            "_metadata": {"path": path, "tag": tag, "modified_at": 100 * seed + i, "seen_at": i},
        }
    return out


def _script() -> list:
    first = _docs(1, 12, "a")
    replaced = {p: v for p, v in _docs(2, 12, "b").items() if p.endswith(("doc1.txt", "doc4.txt", "doc7.txt"))}
    gone = ["/data/2/doc5.txt", "/data/0/doc9.txt"]
    return [("docs", first, {}, []), ("ask", None), ("docs", replaced, first, []), ("ask", None),
            ("docs", {}, None, gone), ("ask", None)]


def _chunks(docs) -> set:
    out = set()
    for doc in docs:
        words = doc["data"].split()
        out |= {" ".join(words[i : i + 3]) for i in range(0, len(words), 3)}
    return out


def _dead_chunks(phase: int) -> set:
    """Chunk texts of the documents replaced or removed before ``phase`` that
    no live document has."""
    live: dict = {}
    dead: list = []
    for step in _script()[:phase]:
        if step[0] == "docs":
            _, new, _old, gone = step
            dead += [live[p] for p in gone] + [live[p] for p in new if p in live]
            for path in gone:
                live.pop(path)
            live.update(new)
    return _chunks(dead) - _chunks(live.values())


def _live_after(phase: int) -> dict:
    live: dict = {}
    for step in _script()[:phase]:
        if step[0] == "docs":
            _, new, _old, gone = step
            for path in gone:
                live.pop(path)
            live.update(new)
    return live


def test_scripted_queries_have_no_equal_scores_in_their_top_k():
    for phase, step in enumerate(_script()):
        if step[0] != "ask":
            continue
        live = _live_after(phase)
        corpus = np.stack([_int_vec(c) for c in sorted(_chunks(live.values()))])
        for q in _queries(live, phase % 4):
            top = np.sort(corpus @ _int_vec(q["query"]))[::-1][: q["k"] + 1]
            assert len(set(top.tolist())) == len(top), q


def _queries(live: dict, round_: int) -> list:
    """Exact copies of chunk texts, a perturbed one, a filter and a glob."""
    texts = []
    for doc in sorted(live.values(), key=lambda d: d["_metadata"]["path"]):
        words = doc["data"].split()
        texts.append(" ".join(words[:3]))
    out = [{"query": t, "k": K} for t in texts[round_ :: 4]]
    out.append({"query": texts[0] + " w1 w2", "k": K + 1})
    out.append({"query": texts[1], "k": K, "metadata_filter": "tag == 'a'"})
    out.append({"query": texts[2], "k": K, "filepath_globpattern": "/data/1/*"})
    return out


class _Harness:
    def __init__(self, side: _Side, kind: str, vec, metric):
        self.side = side
        self.log: list = []
        self.phase = 0
        self.doc_updates = 0
        self.lock = threading.Lock()
        p = side.pw

        class Feed(p.io.python.ConnectorSubject):
            def __init__(self):
                super().__init__()
                self.done = threading.Event()

            def run(self):
                self.done.wait()

        self.feeds = {name: Feed() for name in ("docs", "retrieve", "statistics", "inputs")}
        side.graph.clear()
        doc_schema = p.schema_builder({
            "path": p.column_definition(dtype=str, primary_key=True),
            "data": p.column_definition(dtype=str),
            "_metadata": p.column_definition(dtype=p.Json),
        })
        q_schema = p.schema_builder({
            "qid": p.column_definition(dtype=int, primary_key=True),
            "query": p.column_definition(dtype=str),
            "k": p.column_definition(dtype=int),
            "metadata_filter": p.column_definition(dtype=str | None),
            "filepath_globpattern": p.column_definition(dtype=str | None),
        })
        info_schema = p.schema_builder({
            "qid": p.column_definition(dtype=int, primary_key=True),
            "metadata_filter": p.column_definition(dtype=str | None),
            "filepath_globpattern": p.column_definition(dtype=str | None),
        })

        def read(name, schema):
            return p.io.python.read(self.feeds[name], schema=schema, autocommit_duration_ms=5)

        docs = read("docs", doc_schema)
        store = side.store_cls(docs, retriever_factory=side.factory(kind, vec, metric),
                               splitter=side.splitter())
        for name, result in (
            ("retrieve", store.retrieve_query(read("retrieve", q_schema))),
            ("statistics", store.statistics_query(read("statistics", info_schema))),
            ("inputs", store.inputs_query(read("inputs", info_schema))),
        ):
            p.io.subscribe(result, on_change=self._recorder(name))

        def count_docs(key, row, time, is_addition):
            with self.lock:
                self.doc_updates += 1

        p.io.subscribe(store.input_docs, on_change=count_docs)
        self.runner = side.runner_cls(side.graph)
        self.thread = threading.Thread(
            target=lambda: self.runner.run(**side.run_kwargs), daemon=True
        )
        self.thread.start()
        _wait(lambda: all(f._source is not None for f in self.feeds.values()))

    def _recorder(self, stream):
        def on_change(key, row, time, is_addition):
            with self.lock:
                self.log.append((self.phase, stream, key.as_int(), is_addition, row))

        return on_change

    def net(self, stream):
        with self.lock:
            counts: dict = {}
            for _ph, s, key, add, _row in self.log:
                if s == stream:
                    counts[key] = counts.get(key, 0) + (1 if add else -1)
        return {k for k, c in counts.items() if c}

    def push_docs(self, new: dict, old: dict | None, gone: list, live: dict) -> None:
        feed = self.feeds["docs"]
        n = 0
        for path in gone:
            feed._remove({"path": path, **self._doc_row(live[path])})
            n += 1
        for path, doc in new.items():
            if old and path in old:
                feed._remove({"path": path, **self._doc_row(old[path])})
                n += 1
            feed.next(path=path, **self._doc_row(doc))
            n += 1
        with self.lock:
            target = self.doc_updates + n
        _wait(lambda: self.doc_updates >= target)

    def _doc_row(self, doc: dict) -> dict:
        return {"data": doc["data"], "_metadata": self.side.pw.Json(doc["_metadata"])}

    def ask(self, stream: str, rows: list, first_qid: int) -> None:
        feed = self.feeds[stream]
        keys = set()
        for i, row in enumerate(rows):
            qid = first_qid + i
            full = {"qid": qid, "metadata_filter": None, "filepath_globpattern": None, **row}
            feed.next(**full)
            keys.add(_key(qid))
        _wait(lambda: keys <= self.net(stream))
        for i, row in enumerate(rows):
            full = {"qid": first_qid + i, "metadata_filter": None, "filepath_globpattern": None, **row}
            feed._remove(full)
        _wait(lambda: not (keys & self.net(stream)))

    def finish(self) -> None:
        for feed in self.feeds.values():
            feed.done.set()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()
        self.side.graph.clear()


def _key(qid: int) -> int:
    from pathway_tpu_torch.internals.keys import pointer_from

    return pointer_from(qid).as_int()


def _wait(pred, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "the engine did not get there in time"
        time.sleep(0.005)


def _norm(v):
    if isinstance(v, (ref_pw.Json, pw.Json)):
        return _norm(v.value)
    if isinstance(v, (ref_pw.Pointer, pw.Pointer)):
        return ("ptr", v.as_int())
    if isinstance(v, dict):
        # both statistics carry their profiler's snapshot under "engine":
        # wall-clock timings, compared in test_torch_monitoring.py
        return tuple(sorted((k, _norm(x)) for k, x in v.items() if k != "engine"))
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _run(side: _Side, kind: str, vec, metric) -> dict:
    h = _Harness(side, kind, vec, metric)
    live: dict = {}
    qid = 1000
    try:
        for step in _script():
            if step[0] == "docs":
                _, new, old, gone = step
                h.push_docs(new, old, gone, live)
                for path in gone:
                    live.pop(path)
                live.update(new)
            else:
                h.ask("retrieve", _queries(live, h.phase % 4), qid)
                qid += 100
                h.ask("statistics", [{}], qid)
                h.ask("inputs", [{"metadata_filter": "tag == 'b'"}], qid + 1)
                qid += 100
            with h.lock:
                h.phase += 1
    finally:
        h.finish()
    if kind == "ivf":
        # every cluster was probed (k-means splits can add clusters), so the
        # answers are exact search's
        (store,) = [ev.index.store for ev in h.runner.evaluators.values() if hasattr(ev, "index")]
        assert store.n_probe == store.n_clusters, (store.n_probe, store.n_clusters)
    by_phase: dict = {}
    for phase, stream, key, add, row in h.log:
        by_phase.setdefault((phase, stream), []).append((key, add, _norm(row)))
    return {k: sorted(v, key=repr) for k, v in by_phase.items()}


@pytest.mark.parametrize("kind", ["brute_force", "ivf"])
def test_live_document_store_equals_the_reference_exactly(kind):
    want = _run(REF, kind, _int_vec, ref_nn.BruteForceKnnMetricKind.IP)
    got = _run(PORT, kind, _int_vec, port_nn.BruteForceKnnMetricKind.IP)
    assert {s for _p, s in want} == {"retrieve", "statistics", "inputs"}
    assert sorted(got) == sorted(want)
    for phase_stream in want:
        assert got[phase_stream] == want[phase_stream], phase_stream
    # no replaced or removed text is served after its commit
    for (phase, stream), rows in got.items():
        if stream == "retrieve":
            served = {dict(x)["text"] for _k, add, row in rows if add for x in dict(row)["result"]}
            assert served and not served & _dead_chunks(phase), phase


def test_reference_cpu_ivf_search_equals_its_pallas_kernel_on_the_final_corpus():
    """The reference answers through its numpy CPU path; on the final corpus
    of the script and its queries, that path and its Pallas kernel (interpret
    mode) give the same slots and scores."""
    from pathway_tpu.ops.knn_ivf import IvfKnnStore

    live: dict = {}
    for step in _script():
        if step[0] == "docs":
            _, new, _old, gone = step
            for path in gone:
                live.pop(path)
            live.update(new)
    chunks = []
    for doc in live.values():
        words = doc["data"].split()
        chunks += [" ".join(words[i : i + 3]) for i in range(0, len(words), 3)]
    store = IvfKnnStore(DIM, metric="ip", initial_capacity=64, n_clusters=2, n_probe=2)
    store.add_many(list(range(len(chunks))), np.stack([_int_vec(c) for c in chunks]))
    queries = np.stack([_int_vec(q["query"]) for q in _queries(live, 2)])
    numpy_scores, numpy_slots, _valid = store.search_batch(queries, K)
    pallas_scores, pallas_slots = store._search_device(queries, K, impl="pallas_interpret")
    np.testing.assert_array_equal(numpy_scores, pallas_scores)
    np.testing.assert_array_equal(numpy_slots, pallas_slots)


def test_live_document_store_float_vectors_within_tolerance():
    want = _run(REF, "ivf", _float_vec, ref_nn.BruteForceKnnMetricKind.COS)
    got = _run(PORT, "ivf", _float_vec, port_nn.BruteForceKnnMetricKind.COS)
    assert sorted(got) == sorted(want)
    compared = 0
    for phase_stream, rows in want.items():
        if phase_stream[1] != "retrieve":
            assert got[phase_stream] == rows, phase_stream
            continue
        ours = {(key, add): dict(row)["result"] for key, add, row in got[phase_stream]}
        for key, add, row in rows:
            a = [dict(x) for x in dict(row)["result"]]
            b = [dict(x) for x in ours[(key, add)]]
            assert len(a) == len(b)
            texts_a, texts_b = [x["text"] for x in a], [x["text"] for x in b]
            if set(texts_a) != set(texts_b):
                # a near-tie swap at the boundary: the scores still agree
                assert len(set(texts_a) ^ set(texts_b)) <= 2
                assert abs(a[-1]["dist"] - b[-1]["dist"]) <= 1e-5 * abs(a[-1]["dist"]) + 1e-6
            for x, y in zip(a, b):
                assert y["dist"] == pytest.approx(x["dist"], rel=1e-5, abs=1e-6)
            compared += 1
    assert compared > 0
