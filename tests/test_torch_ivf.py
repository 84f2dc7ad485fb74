"""Port parity: ``pathway_tpu_torch.ops.knn_ivf`` / ``ops.knn`` against the
reference ``pathway_tpu.ops.knn_ivf`` / ``ops.knn`` on the CPU.

The integer corpus (the reference's ``_int_store`` trick) makes every dot
product exact in f32 whatever the summation order, so the page scorer, the
layout and the search must agree BITWISE: identical slots, identical scores,
ties included. The float-corpus checks state their tolerances inline."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn as ref_knn
from pathway_tpu.ops import knn_ivf as ref_ivf
from pathway_tpu_torch.ops import knn as port_knn
from pathway_tpu_torch.ops import knn_ivf as port_ivf


@pytest.fixture(autouse=True, scope="module")
def _ladders_at_rung_zero():
    """Both packages' brownout ladders start at rung 0: another test file in
    this process may have left one engaged, and rung 2 halves IVF n_probe."""
    from pathway_tpu.engine.brownout import reset_brownout as ref_reset
    from pathway_tpu_torch.engine.brownout import reset_brownout as port_reset

    ref_reset()
    port_reset()
    yield


# one intra-op thread: the suite runs files in parallel beside timing-sensitive
# cluster tests, and these tensors are small
torch.set_num_threads(1)

METRICS = ["l2sq", "cos", "ip"]


def _int_corpus(n=1500, dim=32, seed=5):
    rng = np.random.default_rng(seed)
    docs = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(24, dim)).astype(np.float32)
    return docs, queries


def _clustered(n, dim, n_clusters, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(n_clusters, dim)).astype(np.float32)
    labels = rng.integers(0, n_clusters, n)
    docs = (centers[labels] + rng.normal(size=(n, dim))).astype(np.float32)
    return centers, docs


def _ref_store(docs, metric, n_clusters=8, n_probe=3):
    n, dim = docs.shape
    ref = ref_ivf.IvfKnnStore(
        dim, metric=metric, initial_capacity=2 * n, n_clusters=n_clusters, n_probe=n_probe
    )
    ref.add_many(list(range(n)), docs)
    ref.search_batch(docs[:1], 1)  # train + build index
    ref._ensure_index()
    return ref


def _port_store(docs, metric, n_clusters=8, n_probe=3, **kw):
    n, dim = docs.shape
    port = port_ivf.IvfKnnStore(
        dim, metric=metric, initial_capacity=2 * n, n_clusters=n_clusters, n_probe=n_probe,
        device="cpu", **kw,
    )
    port.add_many(list(range(n)), docs)
    return port


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("metric", METRICS)
def test_score_pages_plain_bitwise_vs_pallas_and_xla(metric):
    docs, queries = _int_corpus()
    ref = _ref_store(docs, metric)
    ref._ensure_packed()
    packed, pn, pm, _rows, _fp, _np = ref._packed
    rng = np.random.default_rng(11)
    page_ids = rng.integers(0, pn.shape[0], size=(8, 20)).astype(np.int32)
    q = queries[:8]
    pallas = np.asarray(
        ref_ivf._score_pages_pallas(packed, pn, pm, jnp.asarray(q), jnp.asarray(page_ids),
                                    metric, interpret=True)
    )
    xla = np.asarray(
        ref_ivf._score_pages_xla(packed, pn, pm, jnp.asarray(q), jnp.asarray(page_ids), metric)
    )
    got = port_ivf.score_pages(_t(packed), _t(pn), _t(pm), _t(q), _t(page_ids), metric)
    assert got.dtype == torch.float32 and got.shape == pallas.shape
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    assert np.isinf(pallas).any()  # the sentinel / pad rows were exercised


def test_score_pages_plain_slot_chunking_is_invisible():
    rng = np.random.default_rng(3)
    packed = _t(rng.normal(size=(16 * port_ivf.PAGE, 24)).astype(np.float32))
    pn = torch.sum(packed**2, dim=1).reshape(16, port_ivf.PAGE)
    pm = torch.zeros_like(pn)
    q = _t(rng.normal(size=(8, 24)).astype(np.float32))
    ids = _t(rng.integers(0, 16, size=(8, 10)).astype(np.int32))
    a = port_ivf.score_pages_plain(packed, pn, pm, q, ids, "l2sq", slot_chunk=3)
    b = port_ivf.score_pages_plain(packed, pn, pm, q, ids, "l2sq", slot_chunk=64)
    assert torch.equal(a, b)


def test_score_pages_cuda_wrapper_refuses_cpu_tensors():
    z = torch.zeros((port_ivf.PAGE, 4))
    pn = torch.zeros((1, port_ivf.PAGE))
    with pytest.raises(ValueError):
        port_ivf.score_pages_cuda(z, pn, pn, torch.zeros((8, 4)),
                                  torch.zeros((8, 1), dtype=torch.int32), "ip")


@pytest.mark.parametrize("metric", METRICS)
def test_layout_and_search_identical_given_reference_centroids(metric):
    docs, queries = _int_corpus()
    ref = _ref_store(docs, metric)
    assert ref.n_clusters == 8  # no split: the trained centroids are the final ones
    port = _port_store(docs, metric)
    port._flush()
    port.set_centroids(np.asarray(ref._centroids))
    port._ensure_index()
    for name in ("_first_page", "_n_pages", "_page_rows", "_csr_offsets", "_csr_rows"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert port._max_pages == ref._max_pages
    want_s, want_i = ref._search_device(queries, 10, impl="pallas_interpret")
    got_s, got_i = port._search_device(queries, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("k", [4, 9, 12])
def test_host_helpers_match_reference(k):
    rng = np.random.default_rng(8)
    scores = rng.permutation(54).reshape(6, 9).astype(np.float32)  # distinct: no ties
    scores[1, 3] = -np.inf
    ids = rng.integers(0, 100, size=(6, 9))
    for got, want in zip(port_knn.topk_rows(scores, ids, k), ref_knn.topk_rows(scores, ids, k)):
        np.testing.assert_array_equal(got, want)
    slots = np.arange(k, dtype=np.int64)
    vecs = rng.normal(size=(k, 3)).astype(np.float32)
    for got, want in zip(port_knn.pad_pow2(slots, vecs), ref_knn.pad_pow2(slots, vecs)):
        np.testing.assert_array_equal(got, want)
    assert port_knn.pow2_target(16, 16 * k) == ref_knn.pow2_target(16, 16 * k)


def test_ties_break_toward_lower_position():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = port_knn.topk_lowest_first(scores, 4)
    assert idx.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]]
    assert vals.tolist()[0] == [3.0, 3.0, 3.0, 2.0]


def test_own_kmeans_agrees_with_reference_assignments():
    _c, docs = _clustered(4000, 32, 16, seed=1)
    ref = _ref_store(docs, "l2sq", n_clusters=16, n_probe=4)
    port = _port_store(docs, "l2sq", n_clusters=16, n_probe=4)
    port._prepare_search()
    live = np.array(sorted(ref.slot_of.values()))
    assert port.n_clusters == ref.n_clusters
    agree = np.mean(port._assign[live] == ref._assign[live])
    assert agree >= 0.99, agree
    np.testing.assert_allclose(
        port._centroids.numpy(), np.asarray(ref._centroids), rtol=1e-4, atol=1e-4
    )


def test_full_probe_matches_reference_brute_force():
    docs, queries = _int_corpus(n=600, dim=16, seed=2)
    keys = [f"d{i}" for i in range(len(docs))]
    bf = ref_knn.BruteForceKnnIndex(16, initial_capacity=1024)
    bf.add_many(keys, list(docs))
    port = port_knn.IvfKnnIndex(16, initial_capacity=1024, n_clusters=8, n_probe=8, device="cpu")
    port.add_many(keys, docs)
    want = bf.search_many(list(queries), [7] * len(queries))
    got = port.search_many(queries, [7] * len(queries))
    for w, g in zip(want, got):
        assert [s for _, s in g] == [s for _, s in w]  # integer scores: exact
        assert {k for k, _ in g} == {k for k, _ in w} or len({s for _, s in w}) < len(w)


@pytest.mark.parametrize("metric", ["l2sq", "ip"])
def test_dense_store_matches_reference_search(metric):
    docs, queries = _int_corpus(n=700, dim=16, seed=4)
    ref = ref_knn.DenseKNNStore(16, metric=metric, initial_capacity=512)
    port = port_knn.DenseKNNStore(16, metric=metric, initial_capacity=512, device="cpu")
    for store in (ref, port):
        store.add_many(list(range(len(docs))), docs)
        store.remove(5)
        store.remove(9)
    rs, ri, rv = ref.search_batch(queries, 9)
    ps, pi, pv = port.search_batch(queries, 9)
    assert port.capacity == ref.capacity == 1024
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv, rv)


def test_add_remove_grow_stay_consistent():
    _c, docs = _clustered(600, 16, 8, seed=3)
    keys = [f"d{i}" for i in range(len(docs))]
    idx = port_knn.IvfKnnIndex(16, initial_capacity=256, n_clusters=8, n_probe=8, device="cpu")
    idx.add_many(keys[:300], docs[:300])
    assert idx.search_many(docs[:1], [1])[0][0][0] == "d0"  # trains on the first half
    idx.add_many(keys[300:], docs[300:])  # grows and retrains (size doubled)
    store = idx.store
    assert store.capacity == 1024 and len(store) == 600
    assert idx.search_many(docs[450:451], [1])[0][0][0] == "d450"
    idx.remove("d450")
    assert idx.search_many(docs[450:451], [1])[0][0][0] != "d450"
    idx.add("d450", docs[450] + 100.0)  # re-add under the same key, elsewhere
    assert idx.search_many([docs[450] + 100.0], [1])[0][0][0] == "d450"
    store._prepare_search()
    live = sorted(store.slot_of.values())
    assert sorted(store._csr_rows.tolist()) == live
    assert sorted(store._page_rows[store._page_rows >= 0].tolist()) == live
    n_pages = len(store._page_rows) // port_ivf.PAGE
    assert n_pages & (n_pages - 1) == 0 and (store._page_rows[-port_ivf.PAGE:] == -1).all()
    keys_out, vecs = store.export_rows()
    assert len(keys_out) == 600 and vecs.shape == (600, 16)


def test_filtered_search_overfetches_and_filters():
    docs, _q = _int_corpus(n=400, dim=16, seed=6)
    idx = port_knn.IvfKnnIndex(16, n_clusters=4, n_probe=4, device="cpu")
    meta = [{"owner": "a" if i % 3 == 0 else "b", "path": f"/x/{i % 2}/f{i}"} for i in range(400)]
    idx.add_many(list(range(400)), docs, filter_data=meta)
    res = idx.search_many(docs[:4], [5] * 4, ["owner == 'a'", None,
                                              "globmatch('/x/1/*', path)", None])
    assert all(meta[k]["owner"] == "a" for k, _ in res[0]) and len(res[0]) == 5
    assert all(meta[k]["path"].startswith("/x/1/") for k, _ in res[2])
    assert res[1][0][0] == 1 and res[3][0][0] == 3
