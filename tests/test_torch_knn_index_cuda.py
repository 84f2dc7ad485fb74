"""BASELINE config 1 on the card: ``KNNIndex`` over a static CSV, through
``io.csv.read`` and ``pw.run``, with the index on ``cuda``; and the hybrid
``DocumentStore`` (IVF on the card beside BM25) answering retrieve queries.
Needs an NVIDIA GPU and skips without one; this file imports neither JAX nor
the reference package, so it runs on the GPU machine:

    python -m pytest tests/test_torch_knn_index_cuda.py -m cuda

Integer-valued vectors make every euclidean score exact, so the answers must
be the float64 brute force's, distance for distance."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import hashlib

import pathway_tpu_torch as pw
from pathway_tpu_torch.debug import _capture_table
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.stdlib.ml import KNNIndex


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the index runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", ["exact", "ivf"])
def test_knn_index_over_a_static_csv_on_the_card(card, tmp_path, approximate):
    rng = np.random.default_rng(0)
    docs = rng.integers(-8, 9, size=(2000, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(64, 32)).astype(np.float32)
    for name, rows in (("docs.csv", docs), ("queries.csv", queries)):
        lines = ["doc,vec"] + [
            f"{i}," + " ".join(repr(float(x)) for x in row) for i, row in enumerate(rows)
        ]
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    G.clear()
    to_vec = pw.apply_with_type(
        lambda s: np.array(s.split(), dtype=np.float32), np.ndarray, pw.this.vec
    )
    schema = pw.schema_from_types(doc=int, vec=str)
    data = pw.io.csv.read(str(tmp_path / "docs.csv"), schema=schema, mode="static").select(
        pw.this.doc, vec=to_vec
    )
    q = pw.io.csv.read(str(tmp_path / "queries.csv"), schema=schema, mode="static").select(
        qid=pw.this.doc, qvec=to_vec
    )
    extra = {} if approximate == "exact" else dict(
        exact=False, approximate="ivf", n_clusters=16, n_probe=16
    )
    index = KNNIndex(data.vec, data, n_dimensions=32, **extra)
    res = index.get_nearest_items(q.qvec, k=10, with_distances=True)
    net: dict = {}
    for u in capture(res):
        item = (int(u["qid"]), tuple(int(x) for x in u["doc"]),
                tuple(float(x) for x in u["dist"]))
        net[item] = net.get(item, 0) + u["__diff__"]
    G.clear()
    answers = {qid: (ids, dist) for (qid, ids, dist), c in net.items() if c}
    assert len(answers) == len(queries)
    d2 = ((queries.astype(np.float64)[:, None, :] - docs[None]) ** 2).sum(-1)
    for qid, (ids, dist) in answers.items():
        assert list(dist) == list(-np.sort(d2[qid])[:10])
        assert all(-d2[qid][j] == d for j, d in zip(ids, dist))


def _hash_embedding(text: str, dim: int = 32) -> np.ndarray:
    digest = hashlib.sha256(str(text).encode()).digest()
    v = np.random.default_rng(int.from_bytes(digest[:8], "little")).normal(size=dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


@pytest.mark.cuda
def test_hybrid_document_store_on_the_card(card):
    """``DocumentStore`` over ``HybridIndexFactory([IvfKnnFactory(COS),
    TantivyBM25Factory()])``: the IVF side on the card (``n_probe ==
    n_clusters``, so exact) launches ``score_pages``, and every served
    ranking is the reciprocal-rank fusion of the exact cosine list and the
    BM25 list computed here."""
    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.internals.udfs import UDF
    from pathway_tpu_torch.stdlib.indexing import (
        BruteForceKnnMetricKind,
        HybridIndexFactory,
        IvfKnnFactory,
        TantivyBM25Factory,
    )
    from pathway_tpu_torch.stdlib.indexing.bm25 import BM25Index
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    class HashEmbedder(UDF):
        def __init__(self):
            super().__init__()
            self.func = _hash_embedding

        def get_embedding_dimension(self, **kwargs):
            return 32

    rng = np.random.default_rng(1)
    vocab = [f"w{i}" for i in range(400)]
    texts = list(dict.fromkeys(
        " ".join(rng.choice(vocab, int(rng.integers(5, 20)))) for _ in range(600)))
    questions = [" ".join(t.split()[:4]) for t in texts[:40]]
    G.clear()
    docs = pw.debug.table_from_rows(
        pw.schema_builder({"data": bytes, "_metadata": pw.Json}),
        [(t.encode(), pw.Json({"path": f"/d/{i}"})) for i, t in enumerate(texts)])
    factory = HybridIndexFactory([
        IvfKnnFactory(embedder=HashEmbedder(), metric=BruteForceKnnMetricKind.COS,
                      n_clusters=4, n_probe=4, device="cuda"),
        TantivyBM25Factory(),
    ], k=60)
    store = DocumentStore(docs, retriever_factory=factory)
    q = pw.debug.table_from_rows(pw.schema_builder({"qid": int, "query": str, "k": int}),
                                 [(i, s, 8) for i, s in enumerate(questions)])
    res = store.retrieve_query(q)
    _cuda.reset_launch_counts()
    rows = _capture_table(q.join_left(res, q.id == res.id).select(q.qid, res.result))
    assert _cuda.KERNEL_LAUNCHES.get(knn_ivf.SCORE_PAGES, 0) > 0
    G.clear()
    got = {int(r["qid"]): [(d["text"], d["dist"]) for d in r["result"].value]
           for r in rows.values()}
    mat = np.stack([_hash_embedding(t) for t in texts]).astype(np.float64)
    bm25 = BM25Index()
    for t in texts:
        bm25.add(t, t)
    for i, s in enumerate(questions):
        cos = mat @ _hash_embedding(s).astype(np.float64)
        knn = [(texts[j], cos[j]) for j in np.argsort(-cos, kind="stable")[:16]]
        fused: dict = {}
        for lst in (knn, bm25.search(s, 16)):
            for rank, (key, _score) in enumerate(lst):
                fused[key] = fused.get(key, 0.0) + 1.0 / (60 + rank + 1)
        want = sorted(fused.items(), key=lambda kv: -kv[1])[:8]
        assert [t for t, _ in got[i]] == [t for t, _ in want], i
        assert [d for _, d in got[i]] == [-f for _, f in want], i
