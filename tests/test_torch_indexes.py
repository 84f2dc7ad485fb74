"""The rest of the index family, the port against the reference, on the CPU.

- ``USearchKnn`` / ``UsearchKnnFactory``, ``LshKnnFactory`` and the three
  ``default_*_knn_document_index`` helpers answer integer-vector queries
  with the reference's documents and scores, exactly (integer corpora make
  every l2sq / ip score exact in any order of summation).
- ``BM25Index`` gives the reference's keys and scores bit for bit under
  seeded streams of adds, removals and filtered searches, directly and
  through ``default_full_text_document_index`` on the engine.
- The hybrid's reciprocal-rank fusion equals the reference's
  ``_HybridInstance`` fed with the same ``(vector, text)`` tuples, over
  ``BruteForceKnn`` and ``IvfKnn``, query by query and in one batch; the
  port's ``DocumentStore`` over ``HybridIndexFactory`` serves that fusion.
  The reference's own ``DocumentStore`` over the hybrid raises (its
  ``HybridIndex`` hands the inner indexes the raw text column): the port's
  ``preprocess_data`` is a difference by design.
- The engine's external-index operator serves an index instance that has
  only ``add`` / ``remove`` / ``search``, as the reference does.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_table as ref_capture
from pathway_tpu.internals.json import Json as RefJson
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu.internals.udfs import UDF as RefUDF
from pathway_tpu.ops.knn import BruteForceKnnIndex as RefBf
from pathway_tpu.ops.knn import IvfKnnIndex as RefIvf
from pathway_tpu.stdlib import indexing as ref_ix
from pathway_tpu.stdlib.indexing.bm25 import BM25Index as RefBM25
from pathway_tpu.stdlib.indexing.hybrid_index import _HybridInstance as RefHybrid
from pathway_tpu_torch.debug import _capture_table as capture
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, IvfKnnIndex
from pathway_tpu_torch.stdlib import indexing as ix
from pathway_tpu_torch.stdlib.indexing.bm25 import BM25Index
from pathway_tpu_torch.stdlib.indexing.hybrid_index import _HybridInstance

N, D, Q, K = 256, 16, 24, 5


@pytest.fixture(autouse=True)
def _fresh_graphs():
    G.clear()
    REF_G.clear()
    yield
    G.clear()
    REF_G.clear()


def _vectors(seed: int = 0, spread: int = 8):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(-spread, spread + 1, size=(N, D)).astype(np.float32),
        rng.integers(-spread, spread + 1, size=(Q, D)).astype(np.float32),
    )


def _vector_tables(p, docs, queries):
    data = p.debug.table_from_rows(
        p.schema_builder({"doc": int, "vec": np.ndarray}), [(i, docs[i]) for i in range(len(docs))]
    )
    q = p.debug.table_from_rows(
        p.schema_builder({"qid": int, "qvec": np.ndarray}),
        [(i, queries[i]) for i in range(len(queries))],
    )
    return data, q


def _answers(rows: dict) -> dict:
    """qid -> (docs, scores) of a collapsed query_as_of_now result."""
    return {
        int(r["qid"]): (tuple(int(d) for d in r["doc"]),
                        tuple(float(s) for s in r["_pw_index_reply_score"]))
        for r in rows.values()
    }


def _run_index(p, make, docs, queries, **cap):
    data, q = _vector_tables(p, docs, queries)
    index = make(p, data)
    res = index.query_as_of_now(q.qvec, number_of_matches=K)
    return _answers((ref_capture if p is ref_pw else capture)(res, **cap))


# (name, reference builder, port builder): each returns a DataIndex over data.vec
_VECTOR_CASES = {
    "usearch_l2sq": (
        lambda p, d: ref_ix.DataIndex(d, ref_ix.USearchKnn(
            d.vec, dimensions=D, metric=ref_ix.USearchMetricKind.L2SQ)),
        lambda p, d: ix.DataIndex(d, ix.USearchKnn(
            d.vec, dimensions=D, metric=ix.USearchMetricKind.L2SQ, device="cpu")),
    ),
    "usearch_factory_ip": (
        lambda p, d: ref_ix.USearchKnnFactory(
            dimensions=D, metric=ref_ix.USearchMetricKind.IP).build_index(d.vec, d),
        lambda p, d: ix.USearchKnnFactory(
            dimensions=D, metric=ix.USearchMetricKind.IP, device="cpu").build_index(d.vec, d),
    ),
    "lsh_factory": (
        lambda p, d: ref_ix.LshKnnFactory(
            dimensions=D, n_or=6, n_and=2, bucket_length=24.0).build_index(d.vec, d),
        lambda p, d: ix.LshKnnFactory(
            dimensions=D, n_or=6, n_and=2, bucket_length=24.0, device="cpu").build_index(d.vec, d),
    ),
    "default_brute_force": (
        lambda p, d: ref_ix.default_brute_force_knn_document_index(
            d.vec, d, dimensions=D, metric=ref_ix.BruteForceKnnMetricKind.L2SQ),
        lambda p, d: ix.default_brute_force_knn_document_index(
            d.vec, d, dimensions=D, metric=ix.BruteForceKnnMetricKind.L2SQ, device="cpu"),
    ),
    "default_usearch": (
        lambda p, d: ref_ix.default_usearch_knn_document_index(
            d.vec, d, dimensions=D, metric=ref_ix.USearchMetricKind.L2SQ),
        lambda p, d: ix.default_usearch_knn_document_index(
            d.vec, d, dimensions=D, metric=ix.USearchMetricKind.L2SQ, device="cpu"),
    ),
    "default_lsh": (
        lambda p, d: ref_ix.default_lsh_knn_document_index(d.vec, d, dimensions=D),
        lambda p, d: ix.default_lsh_knn_document_index(d.vec, d, dimensions=D, device="cpu"),
    ),
}


@pytest.mark.parametrize("case", sorted(_VECTOR_CASES))
def test_vector_indexes_answer_as_the_reference(case):
    make_ref, make_port = _VECTOR_CASES[case]
    # the LSH helper keeps the default buckets (4.0 wide): a narrower corpus
    docs, queries = _vectors(spread=1 if case == "default_lsh" else 8)
    want = _run_index(ref_pw, make_ref, docs, queries)
    got = _run_index(pw, make_port, docs, queries, device="cpu")
    assert got == want
    assert sum(len(v[0]) for v in got.values()) > Q  # not an empty answer set


def test_usearch_cosine_default_is_the_dense_store_within_float_rounding():
    """``USearchKnn``'s default metric is cosine (a division by norms: the
    scores agree to float rounding, the documents exactly)."""
    docs, queries = _vectors(1)
    want = _run_index(
        ref_pw, lambda p, d: ref_ix.DataIndex(d, ref_ix.USearchKnn(d.vec, dimensions=D)),
        docs, queries)
    got = _run_index(
        pw, lambda p, d: ix.DataIndex(d, ix.USearchKnn(d.vec, dimensions=D, device="cpu")),
        docs, queries, device="cpu")
    assert got.keys() == want.keys()
    for qid in want:
        assert got[qid][0] == want[qid][0], qid
        np.testing.assert_allclose(got[qid][1], want[qid][1], rtol=1e-6)


# -- BM25 ---------------------------------------------------------------------

_WORDS = [f"w{i}" for i in range(40)] + ["The", "cat", "x_1", "Über"]
_text = st.lists(st.sampled_from(_WORDS), min_size=0, max_size=12).map(" ".join)
_op = st.one_of(
    st.tuples(st.just("add"), st.integers(0, 15), _text, st.sampled_from(["a", "b", None])),
    st.tuples(st.just("remove"), st.integers(0, 15)),
    st.tuples(st.just("search"), _text, st.integers(1, 8),
              st.sampled_from([None, "owner == 'a'", "owner == 'b'"])),
)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(ops=st.lists(_op, min_size=1, max_size=60))
def test_bm25_index_streams_are_bitwise_the_reference(ops):
    port, ref = BM25Index(), RefBM25()
    for op in ops:
        if op[0] == "add":
            _k, key, text, owner = op
            port.add(key, text, Json({"owner": owner}) if owner else None)
            ref.add(key, text, RefJson({"owner": owner}) if owner else None)
        elif op[0] == "remove":
            port.remove(op[1])
            ref.remove(op[1])
        else:
            _k, query, limit, flt = op
            got, want = port.search(query, limit, flt), ref.search(query, limit, flt)
            assert [k for k, _ in got] == [k for k, _ in want]
            # bitwise: the same float operations in the same order
            assert [s.hex() for _, s in got] == [s.hex() for _, s in want]
    assert port.total_len == ref.total_len
    assert dict(port.postings) == dict(ref.postings)


def _texts(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    vocab = np.array([f"t{i}" for i in range(300)])
    return [" ".join(vocab[rng.integers(0, 300, int(rng.integers(4, 16)))]) for _ in range(n)]


def _doc_stream(p, texts: list, seed: int):
    """Documents added at time 2, a third of them retracted (and some
    re-added with new texts) at time 4."""
    rng = np.random.default_rng(seed)
    rows = [(i, texts[i], "a" if i % 3 else "b", 2, 1) for i in range(len(texts))]
    for i in rng.choice(len(texts), len(texts) // 3, replace=False).tolist():
        rows.append((i, texts[i], "a" if i % 3 else "b", 4, -1))
        if i % 2:
            rows.append((i, texts[(i * 7) % len(texts)] + " extra", "a", 4, 1))
    schema = p.schema_builder({
        "doc": p.column_definition(dtype=int, primary_key=True), "text": str, "owner": str,
    })
    return p.debug.table_from_rows(schema, rows, is_stream=True)


def _text_queries(p, queries: list, filtered: bool):
    schema = p.schema_builder({
        "qid": p.column_definition(dtype=int, primary_key=True), "q": str, "flt": str,
    })
    flt = "owner == 'a'" if filtered else None
    return p.debug.table_from_rows(
        schema, [(i, q, flt, 6, 1) for i, q in enumerate(queries)], is_stream=True)


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filtered"])
def test_full_text_document_index_streams_equal_the_reference(filtered):
    texts = _texts(120, 3)
    queries = [t.split()[0] + " " + t.split()[-1] for t in _texts(16, 4)] + texts[:8]
    out = {}
    for p in (ref_pw, pw):
        docs = _doc_stream(p, texts, 5)
        meta = docs.select(docs.doc, docs.text, m=p.apply_with_type(
            lambda o: (RefJson if p is ref_pw else Json)({"owner": o}), p.Json, docs.owner))
        index = (ref_ix if p is ref_pw else ix).default_full_text_document_index(
            meta.text, meta, metadata_column=meta.m)
        q = _text_queries(p, queries, filtered)
        res = index.query_as_of_now(q.q, number_of_matches=K, metadata_filter=q.flt)
        rows = (ref_capture(res) if p is ref_pw else capture(res, device="cpu"))
        out[p] = {
            int(r["qid"]): (tuple(int(d) for d in r["doc"]),
                            tuple(s.hex() for s in r["_pw_index_reply_score"]))
            for r in rows.values()
        }
    assert out[pw] == out[ref_pw]
    assert sum(len(v[0]) for v in out[pw].values()) > len(queries)


# -- hybrid -------------------------------------------------------------------


def _hybrid_pair(kind: str, docs: np.ndarray):
    if kind == "brute_force":
        ref_knn, port_knn = RefBf(D, metric="l2sq"), BruteForceKnnIndex(D, metric="l2sq", device="cpu")
    else:
        ref_knn = RefIvf(D, metric="l2sq", n_clusters=8, n_probe=3)
        port_knn = IvfKnnIndex(D, metric="l2sq", n_clusters=8, n_probe=3, device="cpu")
    return RefHybrid([ref_knn, RefBM25()], 60.0), _HybridInstance([port_knn, BM25Index()], 60.0)


@pytest.mark.parametrize("kind", ["brute_force", "ivf"])
def test_hybrid_fusion_equals_the_reference_instance(kind):
    docs, queries = _vectors(2)
    texts = _texts(N, 6)
    qtexts = [" ".join(t.split()[:3]) for t in _texts(Q, 7)]
    ref, port = _hybrid_pair(kind, docs)
    for i in range(N):
        ref.add(i, (docs[i], texts[i]), None)
    port.add_many(list(range(N)), [(docs[i], texts[i]) for i in range(N)], None)
    # a first search trains the IVF index on the same rows in both packages
    assert port.search((queries[0], qtexts[0]), 5) == ref.search((queries[0], qtexts[0]), 5)
    # retractions; no re-adds: the stores hand out freed slots in different
    # orders (ROADMAP), and slots break the ties of integer scores
    for i in range(0, N, 9):
        ref.remove(i)
        port.remove(i)
    limits = [int(x) for x in np.random.default_rng(8).integers(1, 12, Q)]
    want = [ref.search((queries[j], qtexts[j]), limits[j]) for j in range(Q)]
    one_by_one = [port.search((queries[j], qtexts[j]), limits[j]) for j in range(Q)]
    batched = port.search_many([(queries[j], qtexts[j]) for j in range(Q)], limits, [None] * Q)
    assert one_by_one == want
    assert batched == want
    assert all(len(w) == min(lim, N) or len(w) > 0 for w, lim in zip(want, limits))
    assert port.search_seconds[0] > 0 and port.search_seconds[1] > 0


def test_hybrid_search_many_asks_each_inner_index_once_per_batch():
    calls = []

    class Counting(BruteForceKnnIndex):
        def search_many(self, vecs, limits, filters=None):
            calls.append((len(vecs), tuple(limits)))
            return super().search_many(vecs, limits, filters)

    docs, queries = _vectors(3)
    port = _HybridInstance([Counting(D, device="cpu"), BM25Index()], 60.0)
    port.add_many(list(range(N)), [(docs[i], f"d{i}") for i in range(N)], None)
    port.search_many([(queries[j], "d1 d2") for j in range(Q)], [3] * Q, None)
    assert calls == [(Q, (10,) * Q)]  # max(2 * limit, 10) for every query, one call


class _FakeEmbedder(UDF):
    """``tests/mocks.FakeEmbedder`` for the port: a seeded unit vector per text."""

    def __init__(self, dim: int = 16, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
        self.func = lambda text: _fake_embedding(text, self.dim)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self.dim


def _fake_embedding(text: str, dim: int = 16) -> np.ndarray:
    digest = hashlib.sha256(str(text).encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    v = rng.normal(size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


def _doc_rows(texts: list) -> list:
    return [(t.encode(), {"path": f"/d/{i}.txt", "owner": "a" if i % 4 else "b"})
            for i, t in enumerate(texts)]


def test_document_store_over_the_hybrid_serves_the_reference_fusion():
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    texts = _texts(60, 9)
    queries = [" ".join(t.split()[:4]) for t in texts[:12]] + _texts(4, 10)
    docs = pw.debug.table_from_rows(
        pw.schema_builder({"data": bytes, "_metadata": pw.Json}),
        [(d, Json(m)) for d, m in _doc_rows(texts)],
    )
    factory = ix.HybridIndexFactory([
        ix.BruteForceKnnFactory(dimensions=16, metric=ix.BruteForceKnnMetricKind.COS,
                                embedder=_FakeEmbedder(), device="cpu"),
        ix.TantivyBM25Factory(),
    ], k=60)
    store = DocumentStore(docs, retriever_factory=factory)
    q = pw.debug.table_from_rows(
        pw.schema_builder({"qid": int, "query": str, "k": int, "metadata_filter": str}),
        [(i, s, 6, "owner == 'a'" if i % 3 == 0 else None) for i, s in enumerate(queries)],
    )
    res = store.retrieve_query(q)
    got = {int(r["qid"]): r["result"].value
           for r in capture(q.join_left(res, q.id == res.id).select(q.qid, res.result),
                            device="cpu").values()}
    # the reference's fusion over the same (vector, text) values, keyed by text
    ref = RefHybrid([RefBf(16, metric="cos"), RefBM25()], 60.0)
    for d, m in _doc_rows(texts):
        ref.add(d.decode(), (_fake_embedding(d.decode()), d.decode()), RefJson(m))
    for i, s in enumerate(queries):
        flt = "owner == 'a'" if i % 3 == 0 else None
        want = ref.search((_fake_embedding(s), s), 6, flt)
        assert [x["text"] for x in got[i]] == [t for t, _ in want], i
        assert [x["dist"] for x in got[i]] == [-score for _, score in want], i


def test_reference_document_store_over_the_hybrid_raises():
    """The reference's ``HybridIndex`` leaves the data column raw: its inner
    embedding index gets a string (ROADMAP, a fault of the reference)."""
    from pathway_tpu.xpacks.llm.document_store import DocumentStore as RefStore

    class RefFake(RefUDF):
        def __init__(self):
            super().__init__()
            self.func = lambda text: _fake_embedding(text)

        def get_embedding_dimension(self, **kwargs):
            return 16

    docs = ref_pw.debug.table_from_rows(
        ref_pw.schema_builder({"data": bytes, "_metadata": ref_pw.Json}),
        [(d, RefJson(m)) for d, m in _doc_rows(_texts(8, 11))],
    )
    factory = ref_ix.HybridIndexFactory([
        ref_ix.BruteForceKnnFactory(dimensions=16, metric=ref_ix.BruteForceKnnMetricKind.COS,
                                    embedder=RefFake()),
        ref_ix.TantivyBM25Factory(),
    ])
    store = RefStore(docs, retriever_factory=factory)
    q = ref_pw.debug.table_from_rows(
        ref_pw.schema_builder({"query": str, "k": int}), [("t1 t2", 3)])
    with pytest.raises(Exception, match="TypeError: expected a vector, got str"):
        ref_capture(store.retrieve_query(q))


# -- the evaluator's per-row fallback -----------------------------------------


class _ScanIndex:
    """A user's index with only ``add`` / ``remove`` / ``search``: the
    documents whose number is nearest the query's, ties to the lower key."""

    def __init__(self):
        self.rows = {}

    def add(self, key, value, filter_data=None):
        self.rows[key] = float(value)

    def remove(self, key):
        self.rows.pop(key, None)

    def search(self, query, limit, filter_expr=None):
        ranked = sorted(self.rows.items(), key=lambda kv: (abs(kv[1] - float(query)), str(kv[0])))
        return [(k, -abs(v - float(query))) for k, v in ranked[:limit]]


def _scan_inner(base):
    class ScanInner(base.InnerIndex):
        def make_instance_factory(self):
            return _ScanIndex

    return ScanInner


def test_external_index_serves_an_instance_without_bulk_methods():
    assert not hasattr(_ScanIndex, "add_many") and not hasattr(_ScanIndex, "search_many")
    out = {}
    for p, base, cap in ((ref_pw, ref_ix, ref_capture), (pw, ix, capture)):
        schema = p.schema_builder({
            "doc": p.column_definition(dtype=int, primary_key=True), "x": float,
        })
        rows = [(i, float((i * 37) % 50), 2, 1) for i in range(40)]
        rows += [(i, float((i * 37) % 50), 4, -1) for i in range(0, 40, 5)]
        rows += [(100 + i, float(i) + 0.25, 4, 1) for i in range(6)]
        data = p.debug.table_from_rows(schema, rows, is_stream=True)
        index = base.DataIndex(data, _scan_inner(base)(data.x))
        qs = p.debug.table_from_rows(
            p.schema_builder({"qid": p.column_definition(dtype=int, primary_key=True),
                              "qx": float}),
            [(j, float(j) * 4.5, 6, 1) for j in range(10)], is_stream=True)
        res = index.query_as_of_now(qs.qx, number_of_matches=4)
        rows_out = cap(res, device="cpu") if p is pw else cap(res)
        out[p] = {int(r["qid"]): (tuple(int(d) for d in r["doc"]),
                                  tuple(r["_pw_index_reply_score"])) for r in rows_out.values()}
    assert out[pw] == out[ref_pw]
    assert all(len(v[0]) == 4 for v in out[pw].values())
