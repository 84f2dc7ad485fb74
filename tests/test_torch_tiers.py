"""Port parity and behaviour of the tiered / int8 IVF store:
``pathway_tpu_torch.ops.knn_tiers`` against the reference
``pathway_tpu.ops.knn_tiers`` on the CPU, and the reference's tiered-index
and quantized-tower behaviour tests (``tests/test_tiered_index.py``,
``tests/test_quant.py``) ported to the port's store.

Parity is given the same initial centroids (the reference's k-means run on
the sample the reference's store draws; the port's own k-means differs
slightly, ROADMAP §C). Bars:
- int8: identical ids and bitwise scores (exact integer dots, the
  reference's host epilogue and rescore);
- fp32: top-k id sets identical but for a near-tie swap at the edge, and
  scores within rtol 1e-5 plus an atol of 1e-5 of the largest |score| (ip
  scores sit near 0; the block dots sum in another order than numpy's
  BLAS)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn_tiers as ref_tiers
from pathway_tpu_torch.engine import telemetry
from pathway_tpu_torch.engine.brownout import get_brownout, reset_brownout
from pathway_tpu_torch.ops import knn_quant
from pathway_tpu_torch.ops.knn_tiers import (
    DirSpillStore,
    TieredIvfKnnStore,
    _ClusterPages,
    tiering_enabled,
)

torch.set_num_threads(1)

METRICS = ["l2sq", "cos", "ip"]
PAGE = knn_quant.PAGE


@pytest.fixture(autouse=True, scope="module")
def _ladders_at_rung_zero():
    """Both packages' brownout ladders start at rung 0: another test file in
    this process may have left one engaged, and rung 2 halves n_probe."""
    from pathway_tpu.engine.brownout import reset_brownout as ref_reset

    ref_reset()
    reset_brownout()
    yield


@pytest.fixture(autouse=True)
def _knobs_clear(monkeypatch):
    for name in ("PATHWAY_IVF_TIERED", "PATHWAY_IVF_HBM_BUDGET_MB", "PATHWAY_IVF_QUANT",
                 "PATHWAY_IVF_SPILL_DIR", "PATHWAY_IVF_RESCORE_K", "PATHWAY_IVF_PREFETCH"):
        monkeypatch.delenv(name, raising=False)


def _clustered(n, dim, n_centers, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(n_centers, dim)).astype(np.float32)
    docs = (
        centers[rng.integers(0, n_centers, n)] + rng.normal(size=(n, dim))
    ).astype(np.float32)
    return centers, docs


def _exact_top(docs, queries, k):
    qn = np.sum(queries * queries, axis=1)[:, None]
    dn = np.sum(docs * docs, axis=1)[None, :]
    dist = qn + dn - 2.0 * queries @ docs.T
    return np.argsort(dist, axis=1)[:, :k]


def _store(dim, n_clusters, n_probe, **kw):
    return TieredIvfKnnStore(dim, n_clusters=n_clusters, n_probe=n_probe, device="cpu", **kw)


def _int8_store(dim, n_clusters, n_probe, **kw):
    return _store(dim, n_clusters, n_probe, quant="int8", **kw)


def _assert_rescore_bitwise(store, queries, scores, idx):
    """Every returned score equals the pinned epilogue over the returned
    pair's fp32 source row, bit for bit."""
    qn = np.sum(queries * queries, axis=1)
    for r in range(len(queries)):
        m = idx[r] >= 0
        slots = idx[r][m].astype(int)
        if slots.size == 0:
            continue
        vecs = np.stack([store._vector_of(int(s)) for s in slots]).astype(np.float32)
        norms = np.sum(vecs * vecs, axis=1)
        exact = knn_quant.rescore_pairs(
            np.repeat(queries[r : r + 1], slots.size, axis=0), vecs, norms,
            np.repeat(qn[r : r + 1], slots.size), store.metric,
        ).astype(np.float32)
        np.testing.assert_array_equal(exact, scores[r][m])


# -- parity with the reference ----------------------------------------------------


def _pair(docs, metric, quant, n_clusters=8, n_probe=3):
    """The reference's store and the port's over the same rows and the same
    initial centroids (trained by the reference on its own sample)."""
    n, dim = docs.shape
    keys = [f"d{i}" for i in range(n)]
    ref = ref_tiers.TieredIvfKnnStore(dim, metric=metric, n_clusters=n_clusters,
                                      n_probe=n_probe, quant=quant)
    ref.add_many(keys, docs)
    ref.search_batch(docs[:1], 1)  # the reference trains on its sample
    rng = np.random.default_rng(0)
    cap = n_clusters * ref_tiers._TRAIN_SAMPLE_PER_CLUSTER
    sample = docs if n <= cap else docs[rng.choice(n, cap, replace=False)]
    cents = ref_tiers._train_centroids(sample, n_clusters, 8)
    port = _store(dim, n_clusters, n_probe, metric=metric, quant=quant)
    port.add_many(keys, docs)
    port.set_centroids(cents)
    assert port.n_clusters == ref.n_clusters
    np.testing.assert_array_equal(port._cents, ref._cents)
    return ref, port


def _churn(store, docs, rng_seed=5):
    """Removals of two thirds of the rows (compacting every cluster), 300 new
    rows, then a maintenance pass over every cluster (recenter, re-assign,
    compaction, int8 recalibration)."""
    rng = np.random.default_rng(rng_seed)
    for i in range(len(docs)):
        if i % 3:
            store.remove(f"d{i}")
    fresh = (docs[rng.integers(0, len(docs), 300)] + 0.5).astype(np.float32)
    store.add_many([f"n{i}" for i in range(300)], fresh)
    store._flush()
    for cid in range(store.n_clusters):
        store._maintain_cluster(cid)


@pytest.mark.parametrize("metric", METRICS)
def test_int8_store_bitwise_with_reference_centroids(metric):
    _, docs = _clustered(3000, 32, 8, seed=1)
    ref, port = _pair(docs, metric, "int8")
    q = docs[::97] + 0.1
    for stage in ("fresh", "churned"):
        if stage == "churned":
            _churn(ref, docs)
            _churn(port, docs)
            assert port.stats["compactions"] == ref.stats["compactions"] > 0
            assert port.stats["quant_recalibrations"] == ref.stats["quant_recalibrations"] > 0
            assert port.n_clusters == ref.n_clusters
        rs, ri, rv = ref.search_batch(q, 10)
        ps, pi, pv = port.search_batch(q, 10)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pv, rv)
    _assert_rescore_bitwise(port, q, ps, pi)
    ref.close()
    port.close()


@pytest.mark.parametrize("metric", METRICS)
def test_fp32_store_meets_the_float_bar(metric):
    _, docs = _clustered(3000, 32, 8, seed=2)
    ref, port = _pair(docs, metric, "off")
    q = docs[::89] + 0.1
    for stage in ("fresh", "churned"):
        if stage == "churned":
            _churn(ref, docs)
            _churn(port, docs)
        rs, ri, _ = ref.search_batch(q, 10)
        ps, pi, _ = port.search_batch(q, 10)
        for r in range(len(q)):
            same = len(set(ri[r].tolist()) & set(pi[r].tolist()))
            assert same >= 9, (stage, r)  # a near-tie swap at the edge at most
        both = ri == pi
        np.testing.assert_allclose(ps[both], rs[both], rtol=1e-5, atol=1e-5 * np.abs(rs).max())
    ref.close()
    port.close()


def test_probe_and_quant_state_match_reference():
    _, docs = _clustered(2000, 16, 4, seed=3)
    ref, port = _pair(docs, "l2sq", "int8", n_clusters=4, n_probe=2)
    for a, b in zip(port._quant_cents(), ref._quant_cents()):
        np.testing.assert_array_equal(a, b)
    rq, pq = ref.quant_state(), port.quant_state()
    assert rq["mode"] == pq["mode"] == "int8"
    assert rq["clusters"].keys() == pq["clusters"].keys()
    for cid in rq["clusters"]:
        np.testing.assert_array_equal(pq["clusters"][cid]["qscale"], rq["clusters"][cid]["qscale"])
    rk, rv = ref.export_rows()
    pk, pv = port.export_rows()
    assert dict(zip(pk, map(tuple, pv))) == dict(zip(rk, map(tuple, rv)))
    ref.close()
    port.close()


# -- residency / scoring -----------------------------------------------------------


def test_tiered_full_probe_matches_exact():
    _, docs = _clustered(3000, 24, 12, seed=1)
    store = _store(24, 12, 12)
    store.add_many([f"d{i}" for i in range(3000)], docs)
    q = docs[:40]
    _s, idx, valid = store.search_batch(q, 10)
    assert valid[:, 0].all()
    exact = _exact_top(docs, q, 10)
    for r in range(40):
        assert {store.key_of[int(i)] for i in idx[r] if i >= 0} == {f"d{j}" for j in exact[r]}
    store.close()


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_residency_never_changes_results_bitwise(quant, tmp_path):
    """Everything hot against a tiny budget with a frozen spill tier: the
    same corpus and queries give bitwise identical scores and slots."""
    centers, docs = _clustered(4000, 16, 8, seed=2)
    keys = [f"d{i}" for i in range(4000)]
    rng = np.random.default_rng(3)
    q = (centers[np.zeros(16, dtype=int)] + rng.normal(size=(16, 16))).astype(np.float32)
    tiered = _store(16, 8, 2, quant=quant, hbm_budget_bytes=30_000,
                    spill_store=DirSpillStore(str(tmp_path / "spill")))
    allhot = _store(16, 8, 2, quant=quant)
    tiered.add_many(keys, docs)
    allhot.add_many(keys, docs)
    for _ in range(6):  # settle the EWMA; spill and demotion engage
        rt = tiered.search_batch(q, 10)
        rh = allhot.search_batch(q, 10)
    time.sleep(0.3)  # the prefetch worker drains its queue
    rt = tiered.search_batch(q, 10)
    rh = allhot.search_batch(q, 10)
    stats = tiered.tier_stats()
    assert stats["spilled"] > 0 or stats["spills"] > 0, stats
    np.testing.assert_array_equal(rt[0], rh[0])
    np.testing.assert_array_equal(rt[1], rh[1])
    tiered.close()
    allhot.close()


def test_hot_tier_respects_budget_with_demotions():
    _, docs = _clustered(4000, 16, 8, seed=4)
    budget = 50_000
    store = _store(16, 8, 8, hbm_budget_bytes=budget)
    store.add_many([f"d{i}" for i in range(4000)], docs)
    before = telemetry.stage_snapshot("index.").get("index.demotions", 0.0)
    for _ in range(8):
        store.search_batch(docs[:16], 5)
    time.sleep(0.5)  # promotions are async
    assert store.tiers.hot_bytes <= budget, store.tier_stats()
    assert store.tiers.counts()["hot"] < 8, store.tier_stats()
    assert telemetry.stage_snapshot("index.").get("index.demotions", 0.0) > before
    store.close()


def test_spill_prefetch_and_stall_accounting(tmp_path):
    centers, docs = _clustered(4000, 16, 8, seed=5)
    store = _store(16, 8, 2, hbm_budget_bytes=30_000,
                   spill_store=DirSpillStore(str(tmp_path / "spill")))
    store.add_many([f"d{i}" for i in range(4000)], docs)
    rng = np.random.default_rng(6)
    q0 = (centers[np.zeros(8, dtype=int)] + rng.normal(size=(8, 16))).astype(np.float32)
    for _ in range(6):
        store.search_batch(q0, 5)  # a narrow working set: the rest freezes
    assert store.tier_stats()["spilled"] > 0, store.tier_stats()
    stages0 = telemetry.stage_snapshot("index.")
    _s, idx, valid = store.search_batch(docs[:32], 5)  # every cluster probed
    assert valid[:, 0].all()
    stats = store.tier_stats()
    assert stats["probe_spilled"] > 0, stats
    stages = telemetry.stage_snapshot("index.")
    for name in ("index.probes", "index.probe_spilled", "index.prefetch_requests"):
        assert stages.get(name, 0) > stages0.get(name, 0), name
    assert "index.prefetch_stall_s" in stages
    assert stats["prefetch_stall_s"] >= 0.0
    store.close()


def test_a_lost_spill_blob_is_a_typed_failure(tmp_path):
    centers, docs = _clustered(3000, 16, 8, seed=25)
    spill = DirSpillStore(str(tmp_path / "spill"))
    store = _store(16, 8, 2, hbm_budget_bytes=30_000, spill_store=spill, prefetch=False)
    store.add_many([f"d{i}" for i in range(3000)], docs)
    q0 = (centers[np.zeros(4, dtype=int)] + 0.1).astype(np.float32)
    for _ in range(6):
        store.search_batch(q0, 5)
    frozen = [c for c in range(store.n_clusters) if store.tiers.residency(c) == "spilled"]
    assert frozen
    for key in spill.list("ivf-spill"):
        spill.delete(key)
    with pytest.raises(Exception, match="spill tier lost"):
        store.search_batch(docs[:32], 5)
    store.close()


# -- incremental maintenance / background rebuild ---------------------------------


def test_churn_is_incremental_not_stop_the_world():
    _, docs = _clustered(2000, 16, 8, seed=7)
    store = _store(16, 8, 8)
    store.add_many([f"d{i}" for i in range(2000)], docs)
    store.search_batch(docs[:4], 3)
    gen0 = store.generation
    rng = np.random.default_rng(8)
    for wave in range(4):
        fresh = (docs[rng.integers(0, 2000, 40)]).astype(np.float32)
        store.add_many([f"w{wave}-{i}" for i in range(40)], fresh)
        for i in range(20):
            store.remove(f"w{wave}-{i}") if wave else store.remove(f"d{i}")
        store.search_batch(fresh[:2], 1)
    assert store.generation == gen0
    assert not store._rebuild_inflight(), store.tier_stats()
    probe_vec = docs[150:151]
    store.add("fresh-row", probe_vec[0])
    _s, idx, _v = store.search_batch(probe_vec, 1)
    assert store.key_of.get(int(idx[0, 0])) == "fresh-row"
    store.remove("fresh-row")
    _s, idx, _v = store.search_batch(probe_vec, 1)
    assert store.key_of.get(int(idx[0, 0])) != "fresh-row"
    store.close()


def test_drifted_cluster_splits_without_global_retrain():
    _, docs = _clustered(800, 8, 4, seed=9)
    store = _store(8, 4, 4)
    store.add_many([f"d{i}" for i in range(800)], docs)
    store.search_batch(docs[:4], 3)
    gen0, c0 = store.generation, store.n_clusters
    blob = (np.full((600, 8), 40.0) + np.random.default_rng(10).normal(size=(600, 8))
            ).astype(np.float32)
    for s in range(0, 600, 100):
        store.add_many([f"b{i}" for i in range(s, s + 100)], blob[s : s + 100])
        store.search_batch(blob[:2], 1)
    assert store.generation == gen0
    assert store.n_clusters > c0 or store.stats["splits"] > 0, store.tier_stats()
    store.close()


def _wait_rebuild(store, timeout=60.0):
    """Until the rebuild worker has finished (its result then waits for the
    next commit boundary)."""
    deadline = time.monotonic() + timeout
    while store._rebuild_thread is not None and time.monotonic() < deadline:
        time.sleep(0.05)


def test_background_rebuild_swaps_at_commit_boundary():
    _, docs = _clustered(1500, 16, 8, seed=11)
    store = _store(16, 8, 8)
    store.add_many([f"d{i}" for i in range(1500)], docs)
    store.search_batch(docs[:4], 3)
    gen0 = store.generation
    for i in range(1500):
        store.remove(f"d{i}")
    _, fresh = _clustered(1600, 16, 8, seed=12)
    store.add_many([f"n{i}" for i in range(1600)], fresh)
    r_old = store.search_batch(fresh[:8], 5)
    assert store._rebuild_inflight() or store.generation > gen0
    assert np.isfinite(r_old[0][:, 0]).all()  # the old generation answered
    _wait_rebuild(store)
    store.search_batch(fresh[:1], 1)  # the commit boundary that swaps
    store.search_batch(fresh[:1], 1)
    assert store.generation == gen0 + 1, store.tier_stats()
    exact = _exact_top(fresh, fresh[:20], 10)
    _s, idx, _v = store.search_batch(fresh[:20], 10)
    hits = sum(len({store.key_of.get(int(i)) for i in idx[r] if i >= 0}
                   & {f"n{j}" for j in exact[r]}) for r in range(20))
    assert hits / 200 >= 0.95
    assert store.stats["swaps"] == 1
    assert store.stats["max_pause_s"] < 5.0
    # rows of the new generation can be removed and re-added after the swap
    store.remove("n3")
    store.add("n3b", fresh[3])
    _s, idx, _v = store.search_batch(fresh[3:4], 1)
    assert store.key_of.get(int(idx[0, 0])) == "n3b"
    keys, _vecs = store.export_rows()
    assert "n3" not in keys and "n3b" in keys and len(keys) == 1600
    store.close()


def test_rebuild_dirty_churn_reconciled_at_swap():
    _, docs = _clustered(1200, 16, 8, seed=13)
    store = _store(16, 8, 8)
    store.add_many([f"d{i}" for i in range(1200)], docs)
    store.search_batch(docs[:4], 3)
    for i in range(1200):
        store.remove(f"d{i}")
    _, fresh = _clustered(1200, 16, 8, seed=14)
    store.add_many([f"n{i}" for i in range(1200)], fresh)
    store.search_batch(fresh[:1], 1)  # schedules the rebuild
    assert store._rebuild_inflight()
    late = fresh[:5] + 0.25
    store.add_many([f"late{i}" for i in range(5)], late)
    store.remove("n0")
    _wait_rebuild(store)
    store.search_batch(fresh[:1], 1)
    assert store.generation >= 1
    _s, idx, _v = store.search_batch(late, 1)
    assert {store.key_of.get(int(i)) for i in idx[:, 0]} == {f"late{i}" for i in range(5)}
    _s, idx, _v = store.search_batch(fresh[:1], 3)
    assert "n0" not in {store.key_of.get(int(i)) for i in idx[0] if i >= 0}
    store.close()


def test_torn_swap_leaves_the_old_generation_intact_then_retries(monkeypatch):
    """A swap abandoned before anything re-points (the reference's
    ``tier_swap_torn`` injection, here by patching the port's seam once):
    the old generation keeps serving exact results, and the next maintenance
    pass rebuilds and swaps cleanly."""
    torn = iter([True])
    monkeypatch.setattr(TieredIvfKnnStore, "_swap_torn", lambda self: next(torn, False))
    _, docs = _clustered(1000, 16, 8, seed=15)
    store = _store(16, 8, 8)
    store.add_many([f"d{i}" for i in range(1000)], docs)
    store.search_batch(docs[:4], 3)
    for i in range(1000):
        store.remove(f"d{i}")
    _, fresh = _clustered(1000, 16, 8, seed=16)
    store.add_many([f"n{i}" for i in range(1000)], fresh)
    store.search_batch(fresh[:1], 1)  # schedules rebuild attempt 0
    _wait_rebuild(store)
    r_torn = store.search_batch(fresh[:10], 5)  # the torn swap boundary
    assert store.stats["swaps_torn"] == 1, store.tier_stats()
    assert store.generation == 0
    exact = _exact_top(fresh, fresh[:10], 5)
    for r in range(10):
        assert {store.key_of.get(int(i)) for i in r_torn[1][r] if i >= 0} == {
            f"n{j}" for j in exact[r]}
    store.search_batch(fresh[:1], 1)
    _wait_rebuild(store)
    store.search_batch(fresh[:1], 1)
    assert store.generation == 1, store.tier_stats()
    assert store.stats["swaps"] == 1
    store.close()


def test_a_failed_rebuild_is_a_typed_failure_at_the_swap(monkeypatch):
    from pathway_tpu_torch.ops import knn_tiers

    _, docs = _clustered(800, 16, 4, seed=17)
    store = _store(16, 4, 4)
    store.add_many([f"d{i}" for i in range(800)], docs)
    store.search_batch(docs[:2], 1)

    def boom(*_a, **_k):
        raise ValueError("k-means exploded")

    monkeypatch.setattr(knn_tiers, "_train_centroids", boom)
    for i in range(800):
        store.remove(f"d{i}")
    store.add_many([f"n{i}" for i in range(800)], docs + 1.0)
    store.search_batch(docs[:1], 1)
    _wait_rebuild(store)
    with pytest.raises(knn_tiers.TieredIndexError, match="k-means exploded"):
        store.search_batch(docs[:1], 1)
    store.close()


def test_brownout_rung2_probe_never_triggers_promotion_churn():
    reset_brownout()
    try:
        _, docs = _clustered(2000, 16, 8, seed=17)
        store = _store(16, 8, 8, hbm_budget_bytes=60_000)
        store.add_many([f"d{i}" for i in range(2000)], docs)
        store.search_batch(docs[:2], 1)
        time.sleep(0.3)
        before = telemetry.stage_snapshot("index.").get("index.prefetch_requests", 0.0)
        get_brownout().observe_occupancy(0.95)
        assert get_brownout().nprobe_shift() == 1
        assert store._effective_n_probe() == 4
        for _ in range(4):
            store.search_batch(docs[:8], 3)
        after = telemetry.stage_snapshot("index.").get("index.prefetch_requests", 0.0)
        assert after == before, (before, after)
        store.close()
    finally:
        reset_brownout()


# -- knobs ---------------------------------------------------------------------------


def test_tiering_enabled_knob_as_the_reference(monkeypatch):
    from pathway_tpu_torch.ops.knn import IvfKnnIndex

    cases = [({}, False), ({"PATHWAY_IVF_HBM_BUDGET_MB": "64"}, True),
             ({"PATHWAY_IVF_HBM_BUDGET_MB": "64", "PATHWAY_IVF_TIERED": "off"}, False),
             ({"PATHWAY_IVF_TIERED": "on"}, True), ({"PATHWAY_IVF_QUANT": "int8"}, True),
             ({"PATHWAY_IVF_QUANT": "int8", "PATHWAY_IVF_TIERED": "off"}, False),
             ({"PATHWAY_IVF_HBM_BUDGET_MB": "junk"}, False)]
    for env, want in cases:
        for name in ("PATHWAY_IVF_TIERED", "PATHWAY_IVF_HBM_BUDGET_MB", "PATHWAY_IVF_QUANT"):
            monkeypatch.delenv(name, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tiering_enabled() == ref_tiers.tiering_enabled() == want, env
        index = IvfKnnIndex(16, n_clusters=4, n_probe=2, device="cpu")
        assert isinstance(index.store, TieredIvfKnnStore) == want, env
        if want:
            assert index.store.quant == env.get("PATHWAY_IVF_QUANT", "off")
            index.store.close()


def test_budget_knob_is_read_at_construction(monkeypatch):
    monkeypatch.setenv("PATHWAY_IVF_HBM_BUDGET_MB", "0.5")
    store = _store(16, 4, 2)
    assert store.tier_stats()["budget_bytes"] == 1 << 19 == ref_tiers.hbm_budget_bytes()
    store.close()


@pytest.mark.parametrize("raw", ["fp8", "int4"])
def test_a_refused_quant_mode_refuses_the_store_and_the_index(raw, monkeypatch):
    from pathway_tpu_torch.ops.knn import IvfKnnIndex

    monkeypatch.setenv("PATHWAY_IVF_QUANT", raw)
    with pytest.raises(knn_quant.QuantConfigError):
        _store(16, 4, 2)
    with pytest.raises(knn_quant.QuantConfigError):
        IvfKnnIndex(16, n_clusters=4, n_probe=2, device="cpu")


# -- the quantized tower ---------------------------------------------------------------


def test_int8_full_probe_matches_exact_topk():
    _, docs = _clustered(3000, 24, 12, seed=31)
    store = _int8_store(24, 12, 12)
    store.add_many([f"d{i}" for i in range(3000)], docs)
    q = docs[:40]
    scores, idx, valid = store.search_batch(q, 10)
    assert valid.all()
    exact = _exact_top(docs, q, 10)
    for r in range(40):
        assert {store.key_of[int(i)] for i in idx[r] if i >= 0} == {f"d{j}" for j in exact[r]}
    _assert_rescore_bitwise(store, q, scores, idx)
    assert store.quant_recall_audit(q[:16], k=5) == 1.0
    store.close()


def test_rescore_bitwise_after_churn_and_dead_rows_masked():
    _, docs = _clustered(4000, 16, 8, seed=32)
    store = _int8_store(16, 8, 8)
    store.add_many([f"d{i}" for i in range(4000)], docs)
    store.search_batch(docs[:4], 5)
    for i in range(0, 1500):
        store.remove(f"d{i}")
    q = docs[2000:2032]
    scores, idx, _v = store.search_batch(q, 10)
    dead = {f"d{i}" for i in range(1500)}
    for r in range(len(q)):
        got = {store.key_of.get(int(i)) for i in idx[r] if i >= 0}
        assert not (got & dead) and None not in got
    _assert_rescore_bitwise(store, q, scores, idx)
    store.close()


def test_rescore_depth_follows_env_and_clamps_to_k(monkeypatch):
    monkeypatch.setenv("PATHWAY_IVF_RESCORE_K", "4")
    _, docs = _clustered(600, 8, 4, seed=33)
    store = _int8_store(8, 4, 4)
    store.add_many([f"d{i}" for i in range(600)], docs)

    def observed_depth(k):
        s0 = telemetry.stage_snapshot("index.quant.")
        scores, idx, valid = store.search_batch(docs[:8], k)
        assert valid.all()
        for r in range(8):
            assert store.key_of[int(idx[r][0])] == f"d{r}"
            assert np.count_nonzero(idx[r] >= 0) == k
        _assert_rescore_bitwise(store, docs[:8], scores, idx)
        s1 = telemetry.stage_snapshot("index.quant.")
        assert s1["index.quant.batches"] == s0.get("index.quant.batches", 0) + 1
        return s1["index.quant.rescore_depth"] - s0.get("index.quant.rescore_depth", 0)

    assert observed_depth(2) == 4.0
    assert observed_depth(12) == 12.0
    store.close()


def test_scale_recalibration_rides_maintenance_after_churn():
    _, docs = _clustered(2000, 16, 4, seed=42)
    store = _int8_store(16, 4, 4)
    store.add_many([f"d{i}" for i in range(2000)], docs)
    store.search_batch(docs[:4], 5)
    for i in range(0, 2000, 3):
        store.remove(f"d{i}")
    for cid in range(store.n_clusters):
        store._maintain_cluster(cid)
    assert store.stats["quant_recalibrations"] >= 1, store.stats
    q = docs[1:33]
    live = [i for i in range(2000) if i % 3 != 0]
    exact = _exact_top(docs[live], q, 5)
    scores, idx, _v = store.search_batch(q, 5)
    for r in range(32):
        assert {store.key_of.get(int(i)) for i in idx[r] if i >= 0} == {
            f"d{live[j]}" for j in exact[r]}
    _assert_rescore_bitwise(store, q, scores, idx)
    store.close()


def test_sidecars_survive_blob_roundtrip_bit_exact():
    rng = np.random.default_rng(36)
    n = PAGE + 40
    vecs = rng.normal(scale=3.0, size=(n, 12)).astype(np.float32)
    norms = np.sum(vecs * vecs, axis=1)
    block = _ClusterPages(12, cap=2 * PAGE, quant=True)
    block.append(np.arange(n, dtype=np.int64), vecs, norms)
    thawed = _ClusterPages.from_blob(12, block.to_blob(), quant=True)
    np.testing.assert_array_equal(thawed.qvecs[:n], block.qvecs[:n])
    np.testing.assert_array_equal(thawed.qscale, block.qscale)
    np.testing.assert_array_equal(thawed.qzero, block.qzero)
    ref_block = ref_tiers._ClusterPages.from_blob(12, block.to_blob(), quant=True)
    np.testing.assert_array_equal(ref_block.qvecs[:n], block.qvecs[:n])
    np.testing.assert_array_equal(ref_block.qscale, block.qscale)


def test_recalibrated_scale_wins_blob_roundtrip():
    rng = np.random.default_rng(37)
    vecs = rng.normal(size=(PAGE, 12)).astype(np.float32)
    norms = np.sum(vecs * vecs, axis=1)
    block = _ClusterPages(12, cap=PAGE, quant=True)
    block.append(np.arange(PAGE, dtype=np.int64), vecs, norms)
    derived = float(block.qscale[0])
    tight = np.float32(derived / 2.0)
    block.qscale[0] = tight
    block.qvecs[:PAGE] = knn_quant.quantize_rows(vecs, float(tight))
    block._drop_quant_caches()
    thawed = _ClusterPages.from_blob(12, block.to_blob(), quant=True)
    assert thawed.qscale[0] == tight != np.float32(derived)
    np.testing.assert_array_equal(thawed.qvecs[:PAGE], block.qvecs[:PAGE])


def test_pre_quant_blob_thaws_into_quant_store():
    rng = np.random.default_rng(38)
    vecs = rng.normal(size=(PAGE, 12)).astype(np.float32)
    norms = np.sum(vecs * vecs, axis=1)
    plain = _ClusterPages(12, cap=PAGE, quant=False)
    plain.append(np.arange(PAGE, dtype=np.int64), vecs, norms)
    thawed = _ClusterPages.from_blob(12, plain.to_blob(), quant=True)
    assert thawed.quant
    want_codes, want_scale, _ = knn_quant.quantize_block(thawed.vecs)
    np.testing.assert_array_equal(thawed.qvecs[:PAGE], want_codes[:PAGE])
    np.testing.assert_array_equal(thawed.qscale, want_scale)


def test_block_payload_and_mask_cache_follow_mutations():
    rng = np.random.default_rng(46)
    vecs = rng.normal(size=(PAGE, 8)).astype(np.float32)
    norms = np.sum(vecs * vecs, axis=1)
    block = _ClusterPages(8, cap=PAGE, quant=True)
    block.append(np.arange(PAGE, dtype=np.int64), vecs, norms)
    m0 = block.maskadd(PAGE)
    assert block.maskadd(PAGE) is m0 and np.all(m0 == 0.0)
    block.invalidate(3)
    m1 = block.maskadd(PAGE)
    assert m1 is not m0 and m1[3] == -np.inf
    codes, srow, pn, pm = block.payload()
    np.testing.assert_array_equal(codes, block.qvecs[:PAGE])
    np.testing.assert_array_equal(srow, knn_quant.row_scales(block.qscale, PAGE))
    assert pm is m1 and pn.shape == (PAGE,)


def test_mirror_of_a_churned_block_never_installs():
    """A promotion whose block mutated while it was being staged is dropped
    (the reference's mutation-count check)."""
    from pathway_tpu_torch.ops.knn_tiers import TierManager

    tiers = TierManager(8, 0, budget_bytes=0, device="cpu")
    rng = np.random.default_rng(47)
    block = _ClusterPages(8, cap=PAGE)
    vecs = rng.normal(size=(10, 8)).astype(np.float32)
    block.append(np.arange(10), vecs, np.sum(vecs * vecs, axis=1))
    tiers.install(0, block)
    real = tiers._device_mirror

    def churning(b):
        b.invalidate(2)
        return real(b)

    tiers._device_mirror = churning
    assert not tiers.promote(0)
    assert tiers.residency(0) == "cold" and not tiers.staging
    tiers._device_mirror = real
    assert tiers.promote(0) and tiers.residency(0) == "hot"


# -- the int8 probe step: the queries staged once per search -----------------------


def _int_corpus(n, dim, n_centers, seed):
    """Integer rows around integer centers: every dot is exact, and the
    coarse affinity has exact ties, which both stores must break alike."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-20, 21, size=(n_centers, dim))
    docs = centers[rng.integers(0, n_centers, n)] + rng.integers(-3, 4, size=(n, dim))
    return docs.astype(np.float32)


def _spy_probed(store):
    """The probed set of every search of ``store``, in order."""
    seen = []
    real = store._touch

    def touch(probed, counts, allow_promote):
        seen.append(np.array(probed))
        return real(probed, counts, allow_promote)

    store._touch = touch
    return seen


@pytest.mark.parametrize("metric", METRICS)
def test_query_staging_grows_and_shrinks_with_the_batch(metric, monkeypatch):
    """Batches of 1, 8, 3, 32 and 1 queries in turn: the staging buffer
    grows to the largest batch and is reused after it, each probe reads its
    batch's padded rows, and every call gives the reference's probed set,
    slots and scores bitwise."""
    docs = _int_corpus(3000, 32, 8, seed=31)
    ref, port = _pair(docs, metric, "int8")
    ref_seen, port_seen = _spy_probed(ref), _spy_probed(port)
    probes = []
    real_scores = knn_quant.ProbeTable.scores

    def scores(table, q_codes, q_scales, stream=None):
        probes.append((q_codes.shape[0], port._stage.host.numel()))
        return real_scores(table, q_codes, q_scales, stream)

    monkeypatch.setattr(knn_quant.ProbeTable, "scores", scores)
    rng = np.random.default_rng(32)
    for nq in (1, 8, 3, 32, 1):
        q = docs[rng.choice(len(docs), nq, replace=False)] + rng.integers(
            -1, 2, size=(nq, 32)).astype(np.float32)
        rs, ri, rv = ref.search_batch(q, 10)
        ps, pi, pv = port.search_batch(q, 10)
        np.testing.assert_array_equal(port_seen[-1], ref_seen[-1])
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pv, rv)
    assert [rows for rows, _ in probes] == [8, 8, 8, 32, 8]
    caps = [cap for _, cap in probes]
    assert caps == sorted(caps) and caps[0] < caps[3] == caps[4], caps
    assert port.tier_stats()["query_sends"] == 5
    ref.close()
    port.close()


@pytest.mark.parametrize("quant", ["int8", "off"])
def test_a_search_sends_its_query_data_once(quant, monkeypatch):
    """The probe (int8) and the block scorer read views of one packed
    buffer, so a search copies its query data to a card once, not five
    times; each view starts on a 16-byte boundary, the probe reads the
    padded rows and the scorer the batch's own."""
    from pathway_tpu_torch.ops import knn_tiers as port_tiers

    docs = _int_corpus(2000, 32, 4, seed=34)
    store = _store(32, 4, 2, quant=quant)
    store.add_many([f"d{i}" for i in range(len(docs))], docs)
    seen = {}
    real_scores = knn_quant.ProbeTable.scores
    name = "quant_score_blocks" if quant == "int8" else "score_blocks"
    real_scorer = getattr(port_tiers, name)

    def scores(table, q_codes, q_scales, stream=None):
        seen["probe"] = (q_codes, q_scales)
        return real_scores(table, q_codes, q_scales, stream)

    def scorer(blocks, groups, *args):
        seen["scorer"] = args[:-2]
        return real_scorer(blocks, groups, *args)

    monkeypatch.setattr(knn_quant.ProbeTable, "scores", scores)
    monkeypatch.setattr(port_tiers, name, scorer)
    for i in range(3):
        store.search_batch(docs[i * 7 : i * 7 + 5], 10)
        tensors = list(seen.get("probe", ())) + list(seen["scorer"])
        assert len(tensors) == (5 if quant == "int8" else 2)
        assert len({t.untyped_storage().data_ptr() for t in tensors}) == 1
        assert all(t.data_ptr() % 16 == 0 and t.is_contiguous() for t in tensors)
        assert all(t.shape[0] == 5 for t in seen["scorer"])
        if quant == "int8":
            assert all(t.shape[0] == 8 for t in seen["probe"])
        assert store.tier_stats()["query_sends"] == i + 1
    store.close()


def test_threads_search_one_store_with_the_answers_of_one():
    """The engine's commit loop and direct callers (a timing, the recall
    audit) may search one store at once: the searches take turns, so with
    more threads than cores and a short switch interval each thread gets the
    answers a lone caller gets, bitwise, and every search sent its query
    data once (a lost update of the counts would show)."""
    import sys
    import threading

    docs = _int_corpus(3000, 32, 8, seed=35)
    store = _int8_store(32, 8, 3)
    store.add_many([f"d{i}" for i in range(len(docs))], docs)
    batches = [docs[i : i + n] + 1.0 for i, n in ((0, 1), (40, 8), (90, 3), (200, 32))]
    want = [store.search_batch(q, 10) for q in batches]
    n_threads, reps = 8, 2
    got, errors = {}, []

    def worker(t):
        try:
            got[t] = [store.search_batch(q, 10) for _ in range(reps) for q in batches]
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for t in range(n_threads):
        for i, res in enumerate(got[t]):
            for a, b in zip(res, want[i % len(batches)]):
                np.testing.assert_array_equal(a, b)
    searches = len(batches) * (1 + n_threads * reps)
    assert store.tier_stats()["query_sends"] == store._batches == searches
    store.close()
