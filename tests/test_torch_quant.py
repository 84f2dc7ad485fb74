"""Port parity: ``pathway_tpu_torch.ops.knn_quant`` and the int8 block
scorers' plain versions (``ops/score_blocks.py``) against the reference
``pathway_tpu.ops.knn_quant`` on the CPU, and the quantization knobs.

Tolerances: none. Quantization is the reference's numpy code; the int8 dot
is exact integers (dim <= 1040); the plain epilogues repeat the reference's
order of operations with correctly rounded square roots. So codes, scales,
approximate scores, affinities and rescored scores are compared bitwise.
The fp32 block scorer sums its dots in another order than numpy's BLAS: it
is held to 1e-5 of the dot's scale |q|^2 + |d|^2 (of 1 for cos)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn_quant as ref_quant
from pathway_tpu_torch.ops import knn_quant as port_quant
from pathway_tpu_torch.ops import score_blocks

torch.set_num_threads(1)

METRICS = ["l2sq", "cos", "ip"]
PAGE = port_quant.PAGE


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _block(rng, cap, dim, dead_frac=0.2, dead_page=False):
    vecs = rng.normal(scale=3.0, size=(cap, dim)).astype(np.float32)
    norms = np.sum(vecs * vecs, axis=1).astype(np.float32)
    dead = rng.random(cap) < dead_frac
    if dead_page:
        dead[:PAGE] = True
    mask = np.where(dead, np.float32(-np.inf), np.float32(0.0)).astype(np.float32)
    return vecs, norms, mask


# -- mode resolution ------------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "", "off", "0", "false", "none", "No", "int8", " INT8 "])
def test_quant_mode_resolves_as_the_reference(raw, monkeypatch):
    monkeypatch.delenv("PATHWAY_IVF_QUANT", raising=False)
    assert port_quant.quant_mode(raw) == ref_quant.quant_mode(raw)


@pytest.mark.parametrize("raw,match", [("fp8", "reserved"), ("int4", "unknown"), ("int8x", "unknown")])
def test_quant_mode_refuses_reserved_and_unknown_modes(raw, match, monkeypatch):
    with pytest.raises(port_quant.QuantConfigError, match=match):
        port_quant.quant_mode(raw)
    monkeypatch.setenv("PATHWAY_IVF_QUANT", raw)
    with pytest.raises(port_quant.QuantConfigError, match=match):
        port_quant.quant_mode()


@pytest.mark.parametrize("raw,want", [(None, 64), ("4", 4), ("0", 1), ("junk", 64)])
def test_rescore_k_follows_env_as_the_reference(raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv("PATHWAY_IVF_RESCORE_K", raising=False)
    else:
        monkeypatch.setenv("PATHWAY_IVF_RESCORE_K", raw)
    assert port_quant.rescore_k() == ref_quant.rescore_k() == want


def test_quant_encode_gating_follows_index_mode(monkeypatch):
    from pathway_tpu_torch.models.encoder import quant_encode_enabled

    monkeypatch.delenv("PATHWAY_IVF_QUANT_ENCODE", raising=False)
    monkeypatch.setenv("PATHWAY_IVF_QUANT", "int8")
    assert quant_encode_enabled()
    monkeypatch.setenv("PATHWAY_IVF_QUANT", "off")
    assert not quant_encode_enabled()
    monkeypatch.setenv("PATHWAY_IVF_QUANT_ENCODE", "on")
    assert quant_encode_enabled()
    monkeypatch.setenv("PATHWAY_IVF_QUANT", "int8")
    monkeypatch.setenv("PATHWAY_IVF_QUANT_ENCODE", "off")
    assert not quant_encode_enabled()


def test_quant_encode_refuses_a_misspelled_index_mode(monkeypatch):
    """The encoder reads the index's mode through ``quant_mode``: ``fp8``
    or a typo is refused, never read as "off"."""
    from pathway_tpu_torch.models.encoder import quant_encode_enabled

    monkeypatch.delenv("PATHWAY_IVF_QUANT_ENCODE", raising=False)
    for raw in ("fp8", "int-8"):
        monkeypatch.setenv("PATHWAY_IVF_QUANT", raw)
        with pytest.raises(port_quant.QuantConfigError):
            quant_encode_enabled()


_TINY = dict(vocab_size=4096, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)


@pytest.fixture
def knobs_clear(monkeypatch):
    for name in ("PATHWAY_IVF_TIERED", "PATHWAY_IVF_HBM_BUDGET_MB", "PATHWAY_IVF_QUANT",
                 "PATHWAY_IVF_QUANT_ENCODE", "PATHWAY_IVF_SPILL_DIR"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _served_index(monkeypatch):
    """A port ``VectorStoreServer(index_factory="ivf")`` over a few
    documents, asked once over REST; returns the external index its engine
    built, and the server."""
    import pathway_tpu_torch as tpw
    from pathway_tpu_torch.engine.evaluators import ExternalIndexEvaluator
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer

    G.clear()
    embedder = SentenceTransformerEmbedder(
        device="cpu", encoder_config=EncoderConfig(**_TINY, dtype=torch.float32),
        encoder_service=False,
    )
    docs = [(f"document number {i} about topic {i % 5}".encode(),
             tpw.Json({"path": f"/d/{i}.txt", "modified_at": i, "seen_at": i})) for i in range(40)]
    table = tpw.debug.table_from_rows(
        tpw.schema_builder({"data": bytes, "_metadata": tpw.Json}), docs)
    server = VectorStoreServer(table, embedder=embedder, index_factory="ivf")
    server.run_server(host="127.0.0.1", port=0, threaded=True)
    client = VectorStoreClient(url=server.webserver.url, timeout=60)
    client.query("document number 3 about topic 3", k=3)
    index = next(ev.index for ev in server.runner.evaluators.values()
                 if isinstance(ev, ExternalIndexEvaluator))
    return index, embedder, server


def test_int8_opt_in_serves_from_a_tiered_int8_store(knobs_clear):
    """``PATHWAY_IVF_QUANT=int8`` alone makes ``VectorStoreServer(
    index_factory="ivf")`` serve from the tiered store in int8, and puts the
    encoder in lattice mode, as the reference does (its
    ``tests/test_quant.py::test_quant_opt_in_resolves_tiered_store_under_auto``)."""
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops.knn_tiers import TieredIvfKnnStore

    knobs_clear.setenv("PATHWAY_IVF_QUANT", "int8")
    index, embedder, server = _served_index(knobs_clear)
    try:
        assert isinstance(index.store, TieredIvfKnnStore)
        assert index.store.quant == "int8"
        assert embedder.encoder.quant_encode and embedder.encoder.quant_tag == "quant:int8"
    finally:
        index.store.close()
        server.close()
        G.clear()


def test_no_knobs_keep_the_untiered_store(knobs_clear):
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops.knn_ivf import IvfKnnStore

    index, embedder, server = _served_index(knobs_clear)
    try:
        assert type(index.store) is IvfKnnStore
        assert not embedder.encoder.quant_encode
    finally:
        server.close()
        G.clear()


# -- quantization ---------------------------------------------------------------


@pytest.mark.parametrize("cap", [PAGE, 3 * PAGE, 2 * PAGE + 40])
def test_page_codes_and_scales_bitwise(cap):
    rng = np.random.default_rng(cap)
    vecs = rng.normal(scale=4.0, size=(cap, 24)).astype(np.float32)
    vecs[PAGE:2 * PAGE] = 0.0  # an all-zero page keeps scale 1.0
    for got, want in zip(port_quant.quantize_block(vecs), ref_quant.quantize_block(vecs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = port_quant.quantize_block(vecs, pages=[1])
    want = ref_quant.quantize_block(vecs, pages=[1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _codes, qscale, _ = port_quant.quantize_block(vecs)
    np.testing.assert_array_equal(port_quant.row_scales(qscale, cap),
                                  ref_quant.row_scales(qscale, cap))


def test_query_codes_and_scales_bitwise():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(33, 48)).astype(np.float32)
    q[5] = 0.0
    for got, want in zip(port_quant.quantize_queries(q), ref_quant.quantize_queries(q)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_lattice_encoded_queries_requantize_code_stable():
    rng = np.random.default_rng(48)
    raw = rng.normal(size=(32, 24)).astype(np.float32)
    codes1, scales1 = port_quant.quantize_queries(raw)
    lattice = (codes1.astype(np.float32) * scales1[:, None]).astype(np.float32)
    codes2, _ = port_quant.quantize_queries(lattice)
    np.testing.assert_array_equal(codes1, codes2)


def test_the_encoders_lattice_rows_requantize_code_stable():
    """The port's encoder in lattice mode (f32 wire) emits rows whose
    re-quantization gives back codes that reconstruct the rows exactly
    (the scorer adds no rounding of its own)."""
    from pathway_tpu_torch.models.encoder import EncoderConfig, TorchSentenceEncoder

    enc = TorchSentenceEncoder("pw-test-tiny", config=EncoderConfig(**_TINY, dtype=torch.float32),
                               device="cpu", quant_encode=True, transfer_dtype="float32")
    rows = enc.encode_device([f"query number {i} of the lattice" for i in range(16)])
    rows = rows.float().numpy()
    codes, scales = port_quant.quantize_queries(rows)
    assert np.max(np.abs(codes.astype(np.float32) * scales[:, None] - rows)) <= 1e-6 * np.max(
        np.abs(rows))
    codes2, _ = port_quant.quantize_queries(codes.astype(np.float32) * scales[:, None])
    np.testing.assert_array_equal(codes, codes2)


# -- scores ---------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dead_page", [False, True])
def test_quant_score_block_plain_bitwise_vs_reference_host_path(metric, dead_page):
    """The plain version of the int8 block scorer equals the reference's
    host path (``approx_scores``; l2sq with the fused ``negnorm``, as
    ``knn_tiers.search_batch`` inlines it) and the jitted kernel's ip
    branch, bit for bit, over pages that are partly or wholly dead."""
    rng = np.random.default_rng(44)
    cap, dim, nq = 3 * PAGE, 32, 9
    vecs, norms, mask = _block(rng, cap, dim, dead_page=dead_page)
    qvecs, qscale, _ = ref_quant.quantize_block(vecs)
    srow = ref_quant.row_scales(qscale, cap)
    queries = rng.normal(size=(nq, dim)).astype(np.float32)
    q_codes, q_scales = ref_quant.quantize_queries(queries)
    qn = np.sum(queries * queries, axis=1)
    if metric == "l2sq":
        want = ref_quant.approx_scores(
            q_codes.astype(np.float32), q_scales, qn, qvecs.astype(np.float32), srow, norms,
            metric, negnorm=(mask - norms).astype(np.float32))
    else:
        want = ref_quant.approx_scores(
            q_codes.astype(np.float32), q_scales, qn, qvecs.astype(np.float32), srow, norms,
            metric, maskadd=mask)
    got = port_quant.quant_score_block_plain(
        _t(qvecs), _t(srow), _t(norms), _t(mask), _t(q_codes), _t(q_scales), _t(qn), metric
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_quant.approx_scores(q_codes.astype(np.float32), q_scales, qn,
                                 qvecs.astype(np.float32), srow, norms, metric, maskadd=mask),
        ref_quant.approx_scores(q_codes.astype(np.float32), q_scales, qn,
                                qvecs.astype(np.float32), srow, norms, metric, maskadd=mask))


def test_int8_dot_past_the_exact_limit_matches_reference():
    rng = np.random.default_rng(3)
    dim = port_quant._INT8_EXACT_DIM_LIMIT + 16
    a = rng.integers(-127, 128, size=(4, dim)).astype(np.int8)
    b = rng.integers(-127, 128, size=(6, dim)).astype(np.int8)
    want = ref_quant.int8_dot(a, b)
    np.testing.assert_array_equal(port_quant.int8_dot(a, b), want)
    np.testing.assert_array_equal(port_quant.code_dot(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("nq", [1, 5, 16])
def test_quant_probe_plain_bitwise_vs_reference(nq):
    import jax.numpy as jnp

    rng = np.random.default_rng(nq)
    c_now, c_pad, dim = 11, 16, 32
    cents = rng.normal(size=(c_now, dim)).astype(np.float32)
    codes = np.zeros((c_pad, dim), dtype=np.int8)
    scales = np.ones(c_pad, dtype=np.float32)
    cn = np.full(c_pad, np.inf, dtype=np.float32)
    m = np.max(np.abs(cents), axis=1)
    scales[:c_now] = m / 127.0
    codes[:c_now] = np.clip(np.rint(cents / scales[:c_now, None]), -127, 127).astype(np.int8)
    cn[:c_now] = np.sum(cents * cents, axis=1)
    q_codes, q_scales = ref_quant.quantize_queries(rng.normal(size=(nq, dim)).astype(np.float32))
    want = ref_quant.coarse_affinity(q_codes, q_scales, codes, scales, cn)
    args = (_t(codes), _t(scales), _t(cn), _t(q_codes), _t(q_scales))
    got = port_quant.quant_probe(*args)  # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_quant.quant_probe_plain(*args).numpy(), want)
    assert np.isneginf(want[:, c_now:]).all()
    jitted = np.asarray(ref_quant.quant_probe_kernel(*(jnp.asarray(a) for a in (
        codes, scales, cn, q_codes, q_scales))))
    np.testing.assert_array_equal(got.numpy(), jitted)
    np.testing.assert_array_equal(
        port_quant.coarse_affinity(q_codes, q_scales, codes, scales, cn), want)


@pytest.mark.parametrize("metric", METRICS)
def test_rescore_pairs_and_host_scores_bitwise(metric):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(40, 24)).astype(np.float32)
    v = rng.normal(size=(40, 24)).astype(np.float32)
    qn, vn = np.sum(q * q, axis=1), np.sum(v * v, axis=1)
    np.testing.assert_array_equal(port_quant.rescore_pairs(q, v, vn, qn, metric),
                                  ref_quant.rescore_pairs(q, v, vn, qn, metric))
    np.testing.assert_array_equal(port_quant.host_metric_scores(q[:5], v, vn, qn[:5], metric),
                                  ref_quant.host_metric_scores(q[:5], v, vn, qn[:5], metric))


def _work(rng, dim, caps, nq, quant):
    """A search batch's work list over blocks of ``caps`` rows, each probed
    by a subset of the queries, laid out as the store lays out ``buf_s``."""
    blocks, host, offsets, gq, gcol = [], [], [0], [], []
    widths = np.zeros(nq, dtype=np.int64)
    for n in caps:
        vecs, norms, mask = _block(rng, n, dim, dead_page=n > PAGE)
        if quant:
            codes, qscale, _ = ref_quant.quantize_block(vecs)
            arrs = (codes, ref_quant.row_scales(qscale, n), norms, mask)
        else:
            arrs = (vecs, norms, mask)
        host.append(arrs)
        blocks.append(tuple(_t(a) for a in arrs))
        qs = np.sort(rng.choice(nq, size=max(1, nq // 2 + 1), replace=False))
        gq.append(qs)
        gcol.append(widths[qs].copy())
        widths[qs] += n
        offsets.append(offsets[-1] + len(qs))
    groups = score_blocks.BlockGroups(np.asarray(offsets), np.concatenate(gq), np.concatenate(gcol))
    return blocks, host, groups, int(widths.max())


@pytest.mark.parametrize("metric", METRICS)
def test_quant_score_blocks_work_list_bitwise_vs_reference(metric):
    """The whole batch's int8 work list (the wrapper on CPU tensors) places
    each block's reference host scores at its columns, -inf elsewhere."""
    rng = np.random.default_rng(7)
    dim, nq = 32, 7
    blocks, host, groups, width = _work(rng, dim, [40, PAGE, 2 * PAGE], nq, True)
    queries = rng.normal(size=(nq, dim)).astype(np.float32)
    q_codes, q_scales = ref_quant.quantize_queries(queries)
    qn = np.sum(queries * queries, axis=1)
    got = score_blocks.quant_score_blocks(
        blocks, groups, _t(q_codes), _t(q_scales), _t(qn), width, metric).numpy()
    want = np.full((nq, width), -np.inf, dtype=np.float32)
    for b, (codes, srow, norms, mask) in enumerate(host):
        sel = slice(groups.offsets[b], groups.offsets[b + 1])
        qs, ds = groups.queries[sel], groups.cols[sel]
        sub = ref_quant.approx_scores(q_codes[qs].astype(np.float32), q_scales[qs], qn[qs],
                                      codes.astype(np.float32), srow, norms, metric, maskadd=mask)
        want[qs[:, None], ds[:, None] + np.arange(len(norms))[None, :]] = sub
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", METRICS)
def test_fp32_score_blocks_work_list_vs_reference_kernel(metric):
    """The fp32 work list against the reference's jitted
    ``_score_block_kernel`` per block, within 1e-5 of the dot's scale."""
    import jax.numpy as jnp

    from pathway_tpu.ops.knn_tiers import _score_block_kernel

    rng = np.random.default_rng(8)
    dim, nq = 32, 6
    blocks, host, groups, width = _work(rng, dim, [17, PAGE, 3 * PAGE], nq, False)
    queries = rng.normal(size=(nq, dim)).astype(np.float32)
    qn = np.sum(queries * queries, axis=1)
    got = score_blocks.score_blocks(blocks, groups, _t(queries), _t(qn), width, metric).numpy()
    for b, (vecs, norms, mask) in enumerate(host):
        sel = slice(groups.offsets[b], groups.offsets[b + 1])
        qs, ds = groups.queries[sel], groups.cols[sel]
        want = np.asarray(_score_block_kernel(
            jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(mask), jnp.asarray(queries[qs]),
            metric))
        sub = got[qs[:, None], ds[:, None] + np.arange(len(norms))[None, :]]
        np.testing.assert_array_equal(np.isfinite(sub), np.isfinite(want))
        fin = np.isfinite(want)
        scale = np.ones_like(want) if metric == "cos" else qn[qs][:, None] + norms[None, :]
        assert np.all(np.abs(sub[fin] - want[fin]) <= 1e-5 * scale[fin])
    covered = np.zeros((nq, width), dtype=bool)
    for b, (vecs, _n, _m) in enumerate(host):
        sel = slice(groups.offsets[b], groups.offsets[b + 1])
        covered[groups.queries[sel][:, None],
                groups.cols[sel][:, None] + np.arange(len(vecs))[None, :]] = True
    assert np.isneginf(got[~covered]).all()


def test_block_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On the CPU the wrappers count no launch; the card wrapper refuses
    CPU tensors instead of running."""
    from pathway_tpu_torch.ops import _cuda

    rng = np.random.default_rng(9)
    blocks, _host, groups, width = _work(rng, 32, [PAGE], 3, True)
    q_codes, q_scales = ref_quant.quantize_queries(rng.normal(size=(3, 32)).astype(np.float32))
    qn = torch.ones(3)
    before = dict(_cuda.KERNEL_LAUNCHES)
    score_blocks.quant_score_blocks(blocks, groups, _t(q_codes), _t(q_scales), qn, width, "ip")
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        score_blocks._score_blocks_cuda(1, blocks, groups, _t(q_codes), _t(q_scales), qn,
                                        width, "ip")
    with pytest.raises(ValueError, match="CUDA"):
        port_quant.quant_probe_cuda(blocks[0][0], blocks[0][1], blocks[0][2],
                                    _t(q_codes), _t(q_scales))


# -- caches ---------------------------------------------------------------------


def test_embed_and_semantic_caches_key_on_quant_mode():
    from pathway_tpu_torch.models.embed_pipeline import EmbedCache
    from pathway_tpu_torch.models.encoder_service import SemanticQueryCache

    vec = np.arange(4, dtype=np.float32)
    plain = EmbedCache(16, model="m")
    tagged = EmbedCache(16, model="m|quant:int8")
    plain.put("hello", vec)
    assert plain.get("hello") is not None
    assert tagged.get("hello") is None
    sem_plain = SemanticQueryCache(16, mode="exact")
    sem_tagged = SemanticQueryCache(16, mode="exact", key_tag="quant:int8")
    sem_plain.put("hello world", vec)
    assert sem_plain.get("hello world") is not None
    assert sem_tagged.get("hello world") is None


def test_the_pipelines_caches_take_the_encoders_quant_tag(knobs_clear):
    """The embed pipeline salts its content cache and tags its semantic keys
    with the lattice mode the encoder resolved through ``quant_mode``."""
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    knobs_clear.setenv("PATHWAY_IVF_QUANT", "int8")
    emb = SentenceTransformerEmbedder(device="cpu", encoder_service=False,
                                      encoder_config=EncoderConfig(**_TINY))
    pipe = emb.pipeline
    assert pipe.cache._salt.endswith(b"|quant:int8")
    assert pipe.semantic_cache._canon("hello").startswith("quant:int8\x00")


@pytest.mark.chaos
def test_quant_chaos_plan_serves_old_scales_then_recovers_as_the_reference(monkeypatch):
    """The reference's ``quant`` chaos test on both packages' int8 stores
    (the same rows and initial centroids): every recalibration of rebuild
    attempt 0 drops its new sidecars, the old scales serve exact answers,
    and with the plan lifted maintenance recalibrates; the stats, the ids
    and the scores equal the reference's, bitwise
    (``tests/test_quant.py:399-455``)."""
    import json

    from pathway_tpu.internals import chaos as ref_chaos
    from pathway_tpu_torch.internals import chaos as port_chaos

    from .test_torch_tiers import _assert_rescore_bitwise, _clustered, _exact_top, _pair

    def set_plan(plan):
        monkeypatch.setenv("PATHWAY_CHAOS_PLAN", json.dumps(plan))
        ref_chaos.reset_chaos()
        port_chaos.reset_chaos()

    monkeypatch.setenv("PATHWAY_CHAOS_SEED", "5")
    monkeypatch.delenv("PATHWAY_RESTART_COUNT", raising=False)
    try:
        set_plan({"index": [{"op": "quant", "rank": 0, "at": 0}]})
        _, docs = _clustered(1200, 16, 4, seed=43)
        ref, port = _pair(docs, "l2sq", "int8", n_clusters=4, n_probe=4)
        q = docs[1:17]
        live = [i for i in range(1200) if i % 2 == 1]
        exact = _exact_top(docs[live], q, 5)
        for store in (ref, port):
            for i in range(0, 1200, 2):
                store.remove(f"d{i}")
            for cid in range(store.n_clusters):
                store._maintain_cluster(cid)
        keys = ("quant_chaos_aborts", "quant_recalibrations")
        assert {k: port.stats[k] for k in keys} == {k: ref.stats[k] for k in keys}
        assert port.stats["quant_chaos_aborts"] >= 1 and port.stats["quant_recalibrations"] == 0

        def answers(store):
            scores, idx, _v = store.search_batch(q, 5)
            return scores, idx, [[store.key_of.get(int(i)) for i in row if i >= 0]
                                 for row in idx]

        for lifted in (False, True):
            rs, _ri, rk = answers(ref)
            ps, pi, pk = answers(port)
            assert pk == rk
            assert [set(r) for r in pk] == [{f"d{live[j]}" for j in e} for e in exact]
            np.testing.assert_array_equal(ps, rs)
            _assert_rescore_bitwise(port, q, ps, pi)
            if lifted:
                break
            # the plan lifted: the next maintenance pass recalibrates
            aborts = port.stats["quant_chaos_aborts"]
            set_plan({})
            for store in (ref, port):
                for cid in range(store.n_clusters):
                    store._maintain_cluster(cid)
            assert {k: port.stats[k] for k in keys} == {k: ref.stats[k] for k in keys}
            assert port.stats["quant_chaos_aborts"] == aborts
            assert port.stats["quant_recalibrations"] >= 1
        ref.close()
        port.close()
    finally:
        ref_chaos.reset_chaos()
        port_chaos.reset_chaos()
