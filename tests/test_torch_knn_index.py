"""BASELINE config 1 at a small size: ``KNNIndex`` over a static CSV, the
port against the reference, on the CPU.

512 x 16 integer-valued vectors (every score is exact in any order of
summation) and 32 queries, made from a seed. The port's ``KNNIndex`` in its
exact, ``"ivf"`` and ``"lsh"`` modes must give the reference's nearest items
and distances, per query, exactly: through tables built in memory, through
``io.csv.read`` of the same vectors, and with the native tables off. The
LSH index's buckets come from the same ``default_rng(seed)`` projections, so
its candidates are the reference's. The card's run of the same pipeline is
``tests/test_torch_knn_index_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu.native as ref_native
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_update_stream as ref_capture
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu.ops.knn import LshKnnIndex as RefLsh
from pathway_tpu.stdlib.ml.index import KNNIndex as RefKNNIndex
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.ops.knn import LshKnnIndex, score_candidates
from pathway_tpu_torch.stdlib.ml import KNNIndex

REF_LIB = ref_native.get_lib()  # loaded before a test disables the port's

N, D, Q, K = 512, 16, 32, 5


def _data(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(-8, 9, size=(N, D)).astype(np.float32),
        rng.integers(-8, 9, size=(Q, D)).astype(np.float32),
    )


MODES = {
    "exact": {},
    "ivf": dict(exact=False, approximate="ivf", n_clusters=8, n_probe=3),
    "lsh": dict(exact=False, approximate="lsh", n_or=6, n_and=2, bucket_length=24.0),
}


def _tables(p, docs, queries, source: str, tmp_path):
    if source == "memory":
        data = p.debug.table_from_rows(
            p.schema_builder({"doc": int, "vec": np.ndarray}),
            [(i, docs[i]) for i in range(len(docs))],
        )
        q = p.debug.table_from_rows(
            p.schema_builder({"qvec": np.ndarray}), [(queries[i],) for i in range(len(queries))]
        )
        return data, q
    # the CSV files of config 1: the vector as space-separated floats
    for name, rows, col in (("docs.csv", docs, "vec"), ("queries.csv", queries, "qvec")):
        path = tmp_path / name
        if not path.exists():
            lines = [f"doc,{col}"] + [
                f"{i}," + " ".join(repr(float(x)) for x in row) for i, row in enumerate(rows)
            ]
            path.write_text("\n".join(lines) + "\n")
    to_vec = p.apply_with_type(lambda s: np.array(s.split(), dtype=np.float32), np.ndarray,
                               p.this.vec)
    raw = p.io.csv.read(str(tmp_path / "docs.csv"), schema=p.schema_from_types(doc=int, vec=str),
                        mode="static")
    data = raw.select(p.this.doc, vec=to_vec)
    rq = p.io.csv.read(str(tmp_path / "queries.csv"),
                       schema=p.schema_from_types(doc=int, qvec=str), mode="static")
    q = rq.select(qvec=p.apply_with_type(
        lambda s: np.array(s.split(), dtype=np.float32), np.ndarray, p.this.qvec))
    return data, q


def _answers(updates: list) -> dict:
    """Per query key, its answer in the final state of the update stream:
    (nearest ids, their distances). A re-answered query's retraction and new
    answer share a commit, in either order."""
    net: dict = {}
    for u in updates:
        answer = (tuple(int(x) for x in u["doc"]), tuple(float(x) for x in u["dist"]))
        item = (u["__key__"].as_int(), answer)
        net[item] = net.get(item, 0) + u["__diff__"]
    assert all(c in (0, 1) for c in net.values())
    final = [item for item, c in net.items() if c]
    out = dict(final)
    assert len(out) == len(final)  # one answer per query
    return out


def _assert_same_answers(got: dict, want: dict, *, exact: bool, ties: bool) -> None:
    """Distances equal (exactly, or within rtol 1e-5 where the metric divides
    and takes roots); ids equal, or with ``ties`` (the IVF store breaks ties
    in its own order, as ``test_torch_ivf.py`` allows) equal as sets above
    the last distance, whose tied ids may be any of the tied rows."""
    assert got.keys() == want.keys()
    for key, (w_ids, w_d) in want.items():
        g_ids, g_d = got[key]
        if exact:
            assert g_d == w_d
        else:
            np.testing.assert_allclose(g_d, w_d, rtol=1e-5)
        if not ties:
            assert g_ids == w_ids
            continue
        assert len(g_ids) == len(w_ids)
        if w_d:
            last = w_d[-1]
            strict = [i for i, d in zip(w_ids, w_d) if not np.isclose(d, last, rtol=1e-6)]
            assert set(strict) <= set(g_ids), (key, g_ids, w_ids)


def _run_both(mode: str, metric: str, source: str, tmp_path) -> tuple:
    docs, queries = _data()
    kw = dict(MODES[mode], distance_type=metric)
    if source == "csv" and mode == "ivf":
        # a file source's commits split where its drain meets the autocommit
        # tick, and the IVF index trains on what it holds at its first
        # search: probing every cluster makes the answers independent of that
        kw["n_probe"] = kw["n_clusters"]
    REF_G.clear()
    data, q = _tables(ref_pw, docs, queries, source, tmp_path)
    res = RefKNNIndex(data.vec, data, n_dimensions=D, **kw).get_nearest_items(
        q.qvec, k=K, with_distances=True
    )
    want = _answers(ref_capture(res))
    REF_G.clear()
    G.clear()
    data, q = _tables(pw, docs, queries, source, tmp_path)
    res = KNNIndex(data.vec, data, n_dimensions=D, device="cpu", **kw).get_nearest_items(
        q.qvec, k=K, with_distances=True
    )
    got = _answers(capture(res, device="cpu"))
    G.clear()
    return want, got


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_nearest_items_equal_the_reference(mode, metric, tmp_path):
    want, got = _run_both(mode, metric, "memory", tmp_path)
    assert len(got) == Q
    _assert_same_answers(got, want, exact=metric == "euclidean", ties=mode == "ivf")
    if mode != "lsh":
        assert all(len(ids) == K for ids, _ in got.values())
    else:
        assert sum(len(ids) for ids, _ in got.values()) > Q  # the buckets found candidates


@pytest.mark.parametrize("mode", sorted(MODES))
def test_static_csv_pipeline_equals_the_reference(mode, tmp_path):
    want, got = _run_both(mode, "euclidean", "csv", tmp_path)
    assert len(got) == Q
    _assert_same_answers(got, want, exact=True, ties=mode == "ivf")


def test_static_csv_pipeline_without_native_tables(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", "1")
    want, got = _run_both("exact", "euclidean", "csv", tmp_path)
    assert len(got) == Q
    _assert_same_answers(got, want, exact=True, ties=False)


def test_exact_answers_are_the_float64_brute_force(tmp_path):
    docs, queries = _data()
    _, got = _run_both("exact", "euclidean", "memory", tmp_path)
    d2 = ((queries.astype(np.float64)[:, None, :] - docs[None]) ** 2).sum(-1)
    want = sorted(tuple(-np.sort(d2[i])[:K]) for i in range(Q))
    assert sorted(d for _, d in got.values()) == want
    for ids, dist in got.values():  # every id's distance is its own
        q = [i for i in range(Q) if tuple(-np.sort(d2[i])[:K]) == dist]
        assert any(all(-d2[i][j] == d for j, d in zip(ids, dist)) for i in q)


def test_lsh_buckets_and_scores_equal_the_reference():
    docs, queries = _data(1)
    ref, port = RefLsh(D, metric="cos", n_or=4, n_and=3), LshKnnIndex(
        D, metric="cos", n_or=4, n_and=3, device="cpu"
    )
    np.testing.assert_array_equal(port.projections, ref.projections)
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    for i, v in enumerate(docs):
        ref.add(i, v)
    port.add_many(list(range(len(docs))), docs)
    assert port._bucket_ids(queries[0]) == ref._bucket_ids(queries[0])
    for q in queries[:8]:
        assert port.search(q, 7) == ref.search(q, 7)
    for i in range(0, N, 3):
        ref.remove(i)
        port.remove(i)
    assert port.search_many(list(queries[:8]), [4] * 8) == [ref.search(q, 4) for q in queries[:8]]


@pytest.mark.parametrize("metric", ["l2sq", "cos", "ip"])
def test_score_candidates_is_the_reference_epilogue(metric):
    import torch

    from pathway_tpu.ops.knn import _score_candidates

    docs, queries = _data(2)
    want = np.asarray(_score_candidates(docs, queries[0], metric))
    got = score_candidates(torch.from_numpy(docs), torch.from_numpy(queries[0]), metric).numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_index_rejects_the_reference_contradictions():
    t = pw.debug.table_from_rows(pw.schema_builder({"vec": np.ndarray}), [])
    with pytest.raises(ValueError, match="not a KNNIndex mode"):
        KNNIndex(t.vec, t, n_dimensions=4, approximate="hnsw", device="cpu")
    with pytest.raises(ValueError, match="requires exact=False"):
        KNNIndex(t.vec, t, n_dimensions=4, approximate="ivf", device="cpu")
    G.clear()
