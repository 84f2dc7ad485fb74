"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels
have no CPU mode) and skips without one; this file imports neither JAX nor
the reference package, so it also runs on the GPU machine:

    python -m pytest tests/test_torch_kernels.py -m cuda

Integer-valued inputs make every f32 dot exact in any summation order, so
kernel and plain version must agree bitwise."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from pathway_tpu_torch.ops import _cuda
from pathway_tpu_torch.ops import knn_ivf

METRICS = ["l2sq", "cos", "ip"]
PAGE = knn_ivf.PAGE


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _int_rows(rng, n, d):
    return rng.integers(-8, 9, size=(n, d)).astype(np.float32)


def _page_ids(rng, case, n_pages):
    """(q, n_slots) int32 page ids: the work shapes the kernel groups by page."""
    sentinel = n_pages - 1
    if case == "random":
        return rng.integers(0, n_pages, size=(8, 11)).astype(np.int32)
    if case == "duplicates":  # 3 pages shared by every query, many times each
        return rng.choice(np.array([1, 5, sentinel]), size=(8, 40)).astype(np.int32)
    if case == "sentinel":  # one page in >= 1000 slots, as the all-pad page
        ids = np.full((8, 300), sentinel, dtype=np.int32)
        ids[:, :20] = rng.integers(0, n_pages, size=(8, 20))
        return ids
    if case == "q64":  # more queries per page than one pass of the kernel
        ids = rng.integers(0, 6, size=(64, 12)).astype(np.int32)
        ids[:, -3:] = sentinel
        return ids
    raise AssertionError(case)


def _int_inputs(card, d, dtype, case, seed=0):
    rng = np.random.default_rng(seed + d)
    n_pages = 16
    packed = torch.from_numpy(_int_rows(rng, n_pages * PAGE, d)).to(getattr(torch, dtype))
    packed = packed.to(card)
    pn = torch.sum(packed.float() ** 2, dim=1).reshape(n_pages, PAGE).contiguous()
    mask = rng.random((n_pages, PAGE)) < 0.1
    mask[-1] = True
    pm = torch.from_numpy(np.where(mask, -np.inf, 0.0).astype(np.float32)).to(card)
    ids = _page_ids(rng, case, n_pages)
    q = torch.from_numpy(_int_rows(rng, ids.shape[0], d)).to(card)
    return packed, pn, pm, q, torch.from_numpy(ids).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "duplicates", "sentinel", "q64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [40, 384])  # 40: a ragged last stage of columns
def test_score_pages_kernel_matches_plain(card, metric, dtype, d, case):
    args = _int_inputs(card, d, dtype, case)
    before = _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES]
    got = knn_ivf.score_pages(*args, metric)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES] == before + 1
    want = knn_ivf.score_pages_plain(*args, metric)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 30), ("bfloat16", 36)])
def test_score_pages_kernel_refuses_ragged_rows(card, dtype, d):
    """Rows are copied in 16-byte pieces: d must be a multiple of 4 (f32) or
    8 (bf16) pages; the wrapper raises for other widths instead of launching."""
    args = _int_inputs(card, d, dtype, "random")
    before = _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES]
    with pytest.raises(ValueError, match="multiple of"):
        knn_ivf.score_pages(*args, "l2sq")
    assert _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES] == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates", "q64"])
def test_score_pages_kernel_is_deterministic(card, case):
    """A float corpus, where the order of the sums shows: two launches on the
    same inputs are bitwise equal (no atomics; a pair's score does not depend
    on the block or pass that computed it)."""
    rng = np.random.default_rng(3)
    n_pages, d = 16, 384
    packed = torch.from_numpy(rng.normal(size=(n_pages * PAGE, d)).astype(np.float32)).to(card)
    pn = torch.sum(packed**2, dim=1).reshape(n_pages, PAGE).contiguous()
    pm = torch.zeros_like(pn)
    ids = _page_ids(rng, case, n_pages)
    q = torch.from_numpy(rng.normal(size=(ids.shape[0], d)).astype(np.float32)).to(card)
    ids = torch.from_numpy(ids).to(card)
    for metric in METRICS:
        a = knn_ivf.score_pages_cuda(packed, pn, pm, q, ids, metric)
        b = knn_ivf.score_pages_cuda(packed, pn, pm, q, ids, metric)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_page_work_graph_replays_the_grouping(card):
    """The wrapper's CUDA-graph replay of ``group_page_work`` gives the work
    list of the eager torch ops, call after call on one shape (one graph)
    and on another shape (a second graph)."""
    rng = np.random.default_rng(4)
    for case in ["random", "sentinel", "random", "duplicates", "sentinel"]:
        ids = torch.from_numpy(_page_ids(rng, case, 16)).to(card)
        got = knn_ivf.page_work(ids, 16)
        for a, b, c in zip(got, knn_ivf.group_page_work(ids, 16),
                           knn_ivf.group_page_work(ids.cpu(), 16)):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)


@pytest.mark.cuda
def test_score_pages_kernel_does_not_sync_the_host(card):
    args = _int_inputs(card, 384, "float32", "sentinel")
    knn_ivf.score_pages_cuda(*args, "cos")  # builds and loads the kernel first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = knn_ivf.score_pages_cuda(*args, "cos")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, knn_ivf.score_pages_plain(*args, "cos"))


@pytest.mark.cuda
def test_score_pages_kernel_from_two_threads(card):
    """Two host threads score batches of one shape on the shared default
    stream, so both replay the same grouping graph: each result still equals
    the plain version of its own batch."""
    batches = [_int_inputs(card, 384, "float32", case, seed=s)
               for s, case in enumerate(["duplicates", "duplicates"])]
    assert batches[0][4].shape == batches[1][4].shape
    assert not torch.equal(batches[0][4], batches[1][4])
    results = {0: [], 1: []}
    start = threading.Barrier(2)

    def run(i):
        start.wait()
        for _ in range(50):
            results[i].append(knn_ivf.score_pages_cuda(*batches[i], "l2sq"))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for i in (0, 1):
        want = knn_ivf.score_pages_plain(*batches[i], "l2sq")
        assert len(results[i]) == 50
        assert all(torch.equal(got, want) for got in results[i])


@pytest.mark.cuda
def test_store_on_card_refuses_ragged_width_before_ingest(card):
    with pytest.raises(ValueError, match="multiple of"):
        knn_ivf.IvfKnnStore(30)
    assert knn_ivf.IvfKnnStore(32)._data.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_search_on_card_matches_cpu(card, metric):
    """The whole IVF query on the card (probe, kernel, top-k) returns the
    CPU store's slots and scores when both hold the same integer-valued
    centroids (so the probe's affinities are exact on both devices too)."""
    rng = np.random.default_rng(7)
    docs = _int_rows(rng, 3000, 32)
    queries = _int_rows(rng, 20, 32)
    stores = []
    for dev in ("cpu", card):
        store = knn_ivf.IvfKnnStore(32, metric=metric, n_clusters=8, n_probe=3, device=dev)
        store.add_many(list(range(len(docs))), docs)
        stores.append(store)
    cpu, gpu = stores
    cpu._prepare_search()
    cents = torch.round(cpu._centroids)
    for store in stores:
        store._flush()
        store.set_centroids(cents)
        store._ensure_index()
    np.testing.assert_array_equal(gpu._page_rows, cpu._page_rows)
    before = _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES]
    gs, gi = gpu._search_device(queries, 10)
    assert _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES] > before
    cs, ci = cpu._search_device(queries, 10)
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_array_equal(gs, cs)


# -- the query encoder's CUDA graphs (one per pow2 bucket) ------------------------

_ENCODER = dict(vocab_size=4096, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)


def _encoder(card, **kw):
    from pathway_tpu_torch.models.encoder import EncoderConfig, TorchSentenceEncoder

    return TorchSentenceEncoder("pw-test-tiny", config=EncoderConfig(**_ENCODER), device=card, **kw)


def _bucket_ids(rng, batch, seq):
    """Token ids of a (batch, seq) bucket, each row a random length of real
    tokens followed by pad id 0, the last rows all pad."""
    ids = rng.integers(2000, 4000, size=(batch, seq))
    lens = rng.integers(1, seq + 1, size=batch)
    ids[np.arange(seq)[None, :] >= lens[:, None]] = 0
    ids[-1] = 0
    return ids


@pytest.mark.cuda
def test_graph_replay_matches_the_eager_forward_of_every_bucket(card):
    from pathway_tpu_torch.models.encoder_service import EncoderService

    enc = _encoder(card)
    svc = EncoderService(enc, prewarm=True)
    assert svc.wait_warm(timeout_s=300.0) and svc.prewarm_error is None
    shapes = svc._prewarm_shapes()
    assert enc.graphs_captured == svc.prewarm_compiles == len(shapes) == 20
    rng = np.random.default_rng(0)
    for batch, seq in shapes:
        for _ in range(2):  # a replay after another bucket's replay still holds
            ids = _bucket_ids(rng, batch, seq)
            eager = enc.encode_ids(ids, graph=False).float()
            replay = enc.encode_ids(ids, graph=True).float()
            real = torch.linalg.norm(eager, dim=1) > 0
            cos = torch.sum(eager * replay, dim=1)[real] / (
                torch.linalg.norm(eager, dim=1) * torch.linalg.norm(replay, dim=1)
            )[real]
            assert float(cos.min()) >= 0.99999, (batch, seq)
            assert torch.equal(replay[~real], eager[~real])  # all-pad rows pool to zeros
    assert enc.graphs_captured == 20  # no bucket was captured twice
    svc.close()


@pytest.mark.cuda
def test_page_work_graphs_capture_while_the_encoder_prewarms(card):
    """Two threads capture CUDA graphs at once: the encoder service's
    pre-warm (20 buckets) and the scorer's work-list graph for new shapes. A
    capture opens with a device-wide synchronize, which fails while the other
    thread's capture is open, so captures take ``GRAPH_CAPTURE_LOCK``."""
    from pathway_tpu_torch.models.encoder_service import EncoderService

    enc = _encoder(card)
    svc = EncoderService(enc, prewarm=True)
    rng = np.random.default_rng(3)
    shapes = 0
    try:
        while not svc.wait_warm(timeout_s=0.0) or shapes < 8:
            n_slots = 5 + shapes % 40
            ids = torch.from_numpy(rng.integers(0, 9, size=(8, n_slots)).astype(np.int32))
            work = knn_ivf.page_work(ids.to(card), 10)
            want = knn_ivf.group_page_work(ids, 10)
            for got, ref in zip(work, want):
                assert torch.equal(got.cpu(), ref), n_slots
            shapes += 1
        assert svc.prewarm_error is None and enc.graphs_captured == 20
    finally:
        svc.close()


def test_graph_streams_are_kept_per_device_and_never_share_the_capture_stream(monkeypatch):
    """Every capture site warms up on one kept side stream and captures on a
    stream of the high-priority pool, made once per device: a site that
    took a new pool stream per shape was handed, once the pool wrapped, the
    stream another thread was capturing on (C10). Pool streams are faked
    here, so the bookkeeping runs on the CPU."""
    from pathway_tpu_torch import device as device_mod

    made = []

    class FakeStream:
        def __init__(self, dev=None, priority=0):
            self.dev, self.priority = torch.device(dev), priority
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(device_mod, "_GRAPH_STREAMS", {})
    first = device_mod.graph_streams(torch.device("cuda"))
    for _shape in range(40):
        assert device_mod.graph_streams("cuda:0") is first
    other = device_mod.graph_streams("cuda:1")
    assert len(made) == 4 and other is not first and other.side.dev == torch.device("cuda:1")
    for streams in (first, other):
        assert streams.side is not streams.capture
        assert streams.side.priority == 0 and streams.capture.priority < 0


@pytest.mark.cuda
def test_graph_rows_survive_the_next_replay(card):
    """The service hands out rows of a replay: the next replay of the same
    bucket must not overwrite them."""
    enc = _encoder(card)
    a = enc.encode_device(["first query of the bucket"])
    a_copy = a.clone()
    enc.encode_device(["second query, other words entirely"])
    torch.cuda.synchronize()
    assert torch.equal(a, a_copy)


@pytest.mark.cuda
def test_query_path_replays_and_ingest_stays_eager(card):
    enc = _encoder(card)
    enc.encode_device(["one query"])
    assert enc.graphs_captured == 1
    enc.encode_pipelined([f"document {i} " * (i % 5 + 1) for i in range(300)], sub_batch=128)
    enc.encode_device([f"q {i}" for i in range(100)])  # 128-row bucket: past GRAPH_MAX_BATCH
    assert enc.graphs_captured == 1


@pytest.mark.cuda
def test_a_failed_capture_raises(card):
    enc = _encoder(card)
    forward = enc._encode_ids

    def syncing(ids):
        out = forward(ids)
        out.sum().item()  # a host sync: illegal inside a capture
        return out

    enc._encode_ids = syncing
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        enc.encode_device(["no eager fallback"])
    assert enc.graphs_captured == 0


@pytest.mark.cuda
def test_no_encoder_service_thread_outlives_pw_run(card):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    emb = SentenceTransformerEmbedder("pw-test-tiny", device=card,
                                      encoder_config=EncoderConfig(**_ENCODER))
    G.clear()
    t = pw.debug.table_from_rows(pw.schema_builder({"q": str}), [("a query",), ("another",)])
    res = t.select(v=emb.device_expression(t.q))
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: None)
    GraphRunner(G).run()
    G.clear()
    assert [th.name for th in threading.enumerate() if th.name.startswith("pathway:encsvc-")] == []
    emb.pipeline.service.close()


@pytest.mark.cuda
def test_brownout_rung_two_replays_a_grouping_graph_of_its_own(card):
    """Rung 2 halves n_probe, so the probed-page ids have half the slots: the
    scorer's grouping replays a graph captured for that shape, and the
    search still equals the plain scorer's."""
    from pathway_tpu_torch.engine.brownout import get_brownout, reset_brownout

    rng = np.random.default_rng(9)
    docs = _int_rows(rng, 3000, 32)
    queries = torch.from_numpy(_int_rows(rng, 8, 32)).to(card)
    store = knn_ivf.IvfKnnStore(32, metric="ip", n_clusters=8, n_probe=4, device=card)
    store.add_many(list(range(len(docs))), docs)
    store._prepare_search()
    reset_brownout()
    try:
        slots = {}
        for level in (0, 2):
            if level:
                get_brownout().observe_occupancy(0.9)
            _p, _pn, _pm, _q, page_ids = store.scoring_inputs(queries)
            assert page_ids.shape[1] == (4 if level == 0 else 2) * store._max_pages
            keys_before = set(knn_ivf._WORK_GRAPHS)
            got_s, got_i = store._search_device_launch(queries, 10)
            want_s, want_i = store._search_device_launch(queries, 10, impl="plain")
            assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
            assert any(k[2] == tuple(page_ids.shape) for k in knn_ivf._WORK_GRAPHS)
            if level:
                assert set(knn_ivf._WORK_GRAPHS) - keys_before
            slots[level] = got_i
        assert not torch.equal(slots[0], slots[2])
    finally:
        reset_brownout()


# -- the tiered store's block scorers and int8 probe (csrc/score_blocks.cu) -------

from pathway_tpu_torch.ops import knn_quant, knn_tiers, score_blocks  # noqa: E402


def _quantize_rows(vecs):
    """Page codes and per-row scales of ``n`` rows, quantized as the first
    ``n`` rows of a block whose capacity is a whole number of pages."""
    n, d = vecs.shape
    cap = -(-n // PAGE) * PAGE
    padded = np.zeros((cap, d), dtype=np.float32)
    padded[:n] = vecs
    codes, qscale, _ = knn_quant.quantize_block(padded)
    return codes[:n], knn_quant.row_scales(qscale, cap)[:n]


def _block_inputs(card, rng, d, caps, nq, quant, dead_page=True):
    """Blocks of ragged row counts, each with ~10% dead rows and (when
    ``dead_page``) its first page all dead, probed by overlapping query
    groups; returns (payloads, groups, width)."""
    payloads, offsets, gq, gcol = [], [0], [], []
    widths = np.zeros(nq, dtype=np.int64)
    for n in caps:
        vecs = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
        norms = np.sum(vecs * vecs, axis=1).astype(np.float32)
        dead = rng.random(n) < 0.1
        if dead_page:
            dead[:PAGE] = True
        mask = np.where(dead, np.float32(-np.inf), np.float32(0.0)).astype(np.float32)
        if quant:
            codes, srow = _quantize_rows(vecs)
            arrs = (codes, srow, norms, mask)
        else:
            arrs = (vecs, norms, mask)
        payloads.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in arrs))
        qs = np.sort(rng.choice(nq, size=max(1, nq * 2 // 3), replace=False))
        gq.append(qs)
        gcol.append(widths[qs].copy())
        widths[qs] += n
        offsets.append(offsets[-1] + len(qs))
    groups = score_blocks.BlockGroups(
        np.asarray(offsets, dtype=np.int64), np.concatenate(gq), np.concatenate(gcol))
    return payloads, groups, int(widths.max())


def _queries(card, rng, nq, d, quant):
    q = rng.normal(size=(nq, d)).astype(np.float32)
    qn = torch.from_numpy(np.sum(q * q, axis=1).astype(np.float32)).to(card)
    if quant:
        codes, scales = knn_quant.quantize_queries(q)
        return torch.from_numpy(codes).to(card), torch.from_numpy(scales).to(card), qn
    return torch.from_numpy(q).to(card), None, qn


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nq", [1, 3, 9, 17])  # odd counts, more than one pass of 8
@pytest.mark.parametrize("d", [32, 384])
def test_quant_score_blocks_bitwise_equal_to_plain(card, metric, nq, d):
    """int8 codes: the dot is exact integers, the epilogue uses no FMA, so
    the kernel equals its plain version bit for bit over ragged capacities
    (1, 127, 129, 300 and 1000 rows) and a dead first page."""
    rng = np.random.default_rng(nq * 1000 + d)
    payloads, groups, width = _block_inputs(card, rng, d, [1, 127, 129, 300, 1000], nq, True)
    codes, scales, qn = _queries(card, rng, nq, d, True)
    before = _cuda.KERNEL_LAUNCHES[score_blocks.QUANT_SCORE_BLOCKS]
    got = score_blocks.quant_score_blocks(payloads, groups, codes, scales, qn, width, metric)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[score_blocks.QUANT_SCORE_BLOCKS] == before + 1
    want = score_blocks.quant_score_blocks_plain(payloads, groups, codes, scales, qn, width, metric)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 5, 33])
def test_quant_probe_bitwise_equal_to_plain(card, nq):
    rng = np.random.default_rng(nq)
    cents = rng.normal(size=(70, 384)).astype(np.float32)
    c_pad = 128
    codes = np.zeros((c_pad, 384), dtype=np.int8)
    scales = np.ones(c_pad, dtype=np.float32)
    cn = np.full(c_pad, np.inf, dtype=np.float32)
    m = np.max(np.abs(cents), axis=1)
    scales[:70] = m / 127.0
    codes[:70] = np.clip(np.rint(cents / scales[:70, None]), -127, 127).astype(np.int8)
    cn[:70] = np.sum(cents * cents, axis=1)
    qc, qs, _qn = _queries(card, rng, nq, 384, True)
    args = [torch.from_numpy(a).to(card) for a in (codes, scales, cn)] + [qc, qs]
    before = _cuda.KERNEL_LAUNCHES[knn_quant.QUANT_PROBE]
    got = knn_quant.quant_probe(*args)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[knn_quant.QUANT_PROBE] == before + 1
    want = knn_quant.quant_probe_plain(*args)
    assert torch.equal(got, want)
    assert torch.isneginf(got[:, 70:]).all()
    host = knn_quant.coarse_affinity(qc.cpu().numpy(), qs.cpu().numpy(), codes, scales, cn)
    np.testing.assert_array_equal(got.cpu().numpy(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("quant", [False, True])
def test_block_scores_do_not_depend_on_capacity_or_batch_position(card, metric, quant):
    """A row's score is the same bits whether its block holds 300 or 1000
    rows and whether its query is row 0 or row 6 of the batch; the fp32
    scorer agrees with its plain version within 1e-5 of the dot's scale."""
    rng = np.random.default_rng(11)
    d = 384
    big, groups, _ = _block_inputs(card, rng, d, [1000], 1, quant, dead_page=False)
    small = tuple(t[:300] for t in big[0])
    qv, qsc, qn = _queries(card, rng, 8, d, quant)

    def run(payload, n_rows, qrow):
        g = score_blocks.BlockGroups(np.array([0, 1]), np.array([qrow]), np.array([0]))
        if quant:
            out = score_blocks.quant_score_blocks([payload], g, qv, qsc, qn, n_rows, metric)
        else:
            out = score_blocks.score_blocks([payload], g, qv, qn, n_rows, metric)
        return out[qrow, :300]

    a = run(big[0], 1000, 0)
    b = run(small, 300, 0)
    qv[6], qn[6] = qv[0], qn[0]
    if quant:
        qsc[6] = qsc[0]
    c = run(big[0], 1000, 6)
    assert torch.equal(a, b) and torch.equal(a, c)
    if not quant:
        want = score_blocks.score_block_plain(*small, qv[:1], qn[:1], metric)[0]
        tol = 1e-5 if metric == "cos" else 1e-5 * (qn[0] + small[1])
        fin = torch.isfinite(want)
        assert bool(((a[fin] - want[fin]).abs() <= (tol if metric == "cos" else tol[fin])).all())


@pytest.mark.cuda
def test_block_scorer_refuses_ragged_rows_and_host_tensors(card):
    rng = np.random.default_rng(12)
    payloads, groups, width = _block_inputs(card, rng, 40, [200], 2, True)
    codes, scales, qn = _queries(card, rng, 2, 40, True)
    with pytest.raises(ValueError, match="multiple of 16"):
        score_blocks.quant_score_blocks(payloads, groups, codes, scales, qn, width, "ip")
    with pytest.raises(ValueError, match="CUDA"):
        score_blocks._score_blocks_cuda(1, [], groups, codes.cpu(), scales.cpu(), qn.cpu(), 1, "ip")


@pytest.mark.cuda
def test_wrappers_raise_when_the_library_fails_to_load(card, monkeypatch):
    """No fallback: with ``nvcc`` failing, a CUDA tensor makes the wrapper
    raise instead of quietly taking the plain version."""
    def broken(_source):
        raise RuntimeError("nvcc failed for score_blocks.cu")

    monkeypatch.setattr(_cuda, "load", broken)
    rng = np.random.default_rng(13)
    payloads, groups, width = _block_inputs(card, rng, 32, [200], 2, True)
    codes, scales, qn = _queries(card, rng, 2, 32, True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        score_blocks.quant_score_blocks(payloads, groups, codes, scales, qn, width, "l2sq")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        knn_quant.quant_probe(payloads[0][0][:8], payloads[0][1][:8], payloads[0][2][:8],
                              codes, scales)


def _clustered_docs(n, d, nc, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(scale=5.0, size=(nc, d)).astype(np.float32)
    return c, (c[rng.integers(0, nc, n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "off"])
def test_tiered_residency_never_changes_results_on_card(card, quant, tmp_path):
    """All-hot store against a store with a small budget and a spill tier,
    on the card, same centroids: ids and scores bitwise equal; the budgeted
    store staged cold blocks and kept hot bytes within its budget. For int8
    the card store also equals the CPU store (plain versions) bitwise."""
    centers, docs = _clustered_docs(6000, 32, 8, 21)
    keys = [f"d{i}" for i in range(6000)]
    q = (centers[np.zeros(16, dtype=int)] + np.random.default_rng(22).normal(size=(16, 32))
         ).astype(np.float32)
    cents = docs[np.random.default_rng(23).choice(6000, 8, replace=False)]
    hot = knn_tiers.TieredIvfKnnStore(32, n_clusters=8, n_probe=3, quant=quant, device=card)
    tiered = knn_tiers.TieredIvfKnnStore(
        32, n_clusters=8, n_probe=3, quant=quant, device=card, hbm_budget_bytes=60_000,
        spill_store=knn_tiers.DirSpillStore(str(tmp_path / "spill")))
    cpu = knn_tiers.TieredIvfKnnStore(32, n_clusters=8, n_probe=3, quant=quant, device="cpu")
    for s in (hot, tiered, cpu):
        s.add_many(keys, docs)
        s.set_centroids(cents)
    for _ in range(6):
        rh, rt, rc = (s.search_batch(q, 10) for s in (hot, tiered, cpu))
    import time

    time.sleep(0.5)
    rh, rt, rc = (s.search_batch(q, 10) for s in (hot, tiered, cpu))
    stats = tiered.tier_stats()
    assert stats["staged_blocks"] > 0 and stats["hot_bytes"] <= 60_000, stats
    assert stats["spills"] > 0 or stats["spilled"] > 0, stats
    np.testing.assert_array_equal(rt[1], rh[1])
    np.testing.assert_array_equal(rt[0], rh[0])
    if quant == "int8":
        np.testing.assert_array_equal(rc[1], rh[1])
        np.testing.assert_array_equal(rc[0], rh[0])
    for s in (hot, tiered, cpu):
        s.close()


# -- the int8 block scorer: bulk-copied tiles on a persistent grid ----------------


def _probed_blocks(card, rng, d, caps, probes, nq, masked_page=False):
    """int8 blocks of ``caps`` rows (~10% dead rows; with ``masked_page``
    every row of the first block's first page dead), block b probed by the
    queries ``probes[b]`` (possibly none), laid out as the store lays out a
    batch. Returns (payloads, groups, width)."""
    payloads, offsets, gq, gcol = [], [0], [], []
    widths = np.zeros(nq, dtype=np.int64)
    for b, (n, qs) in enumerate(zip(caps, probes)):
        vecs = rng.normal(scale=2.0, size=(max(n, 1), d)).astype(np.float32)
        codes, srow = _quantize_rows(vecs)
        norms = np.sum(vecs * vecs, axis=1).astype(np.float32)
        dead = rng.random(len(vecs)) < 0.1
        if masked_page and b == 0:
            dead[:PAGE] = True
        mask = np.where(dead, np.float32(-np.inf), np.float32(0.0)).astype(np.float32)
        arrs = tuple(np.ascontiguousarray(a[:n]) for a in (codes, srow, norms, mask))
        payloads.append(tuple(torch.from_numpy(a).to(card) for a in arrs))
        qs = np.sort(np.asarray(qs, dtype=np.int64))
        gq.append(qs)
        gcol.append(widths[qs].copy())
        widths[qs] += n
        offsets.append(offsets[-1] + len(qs))
    groups = score_blocks.BlockGroups(
        np.asarray(offsets, dtype=np.int64), np.concatenate(gq), np.concatenate(gcol))
    return payloads, groups, int(max(widths.max(), 1))


def _shape_case(case):
    """(d, caps, probes, nq, masked_page) of one kernel case."""
    r = score_blocks.tile_rows(384)
    single = {"n=0": 0, "n=1": 1, "n=R-1": r - 1, "n=R": r, "n=R+1": r + 1, "n=20000": 20000}
    if case in single:  # the block beside a small one, both probed by 3 queries
        return 384, [single[case], 5], [[0, 2, 4], [1, 2, 3]], 5, False
    if case == "tiles>resident":  # 313 tiles of 128 rows against one block per SM
        return 384, [15000, 25000], [[0, 1], [1]], 2, False
    if case == "tiles<SMs":
        return 384, [200, 130, 7], [[0], [0, 1], [1]], 2, False
    if case == "17 queries":  # three passes: 8, 8, 1; two blocks no query probes
        return 384, [300, 500, 260], [[], list(range(17)), []], 17, False
    if case == "70 queries":  # more entries than a stage holds
        return 384, [140, 300], [list(range(70)), [3, 69]], 70, False
    if case in ("d=16", "d=1024"):
        d = int(case[2:])
        r = score_blocks.tile_rows(d)
        return d, [r - 1, 3 * r + 1, 1000], [[0, 1], [1, 2, 3], [0, 3]], 4, False
    if case == "all-masked page":
        return 384, [300, 129], [[0, 1], [1]], 2, True
    if case == "5000 blocks":  # too many to keep their first tiles in shared memory
        return 32, [1 + b % 3 for b in range(5000)], [[b % 4] for b in range(5000)], 4, False
    raise AssertionError(case)


SHAPE_CASES = ["n=0", "n=1", "n=R-1", "n=R", "n=R+1", "n=20000", "tiles>resident", "tiles<SMs",
               "17 queries", "70 queries", "d=16", "d=1024", "all-masked page", "5000 blocks"]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", SHAPE_CASES)
def test_quant_score_blocks_kernel_bitwise_at_every_shape(card, case, metric):
    """The int8 kernel equals its plain version bit for bit, -inf cells
    included, over ragged tiles, grids of more and fewer tiles than the card
    holds, multi-pass and overflowing groups, unprobed blocks, d from 16 to
    1024, a page with every row dead and a batch of 5,000 blocks."""
    d, caps, probes, nq, masked_page = _shape_case(case)
    rng = np.random.default_rng(len(case) * 100 + d)
    payloads, groups, width = _probed_blocks(card, rng, d, caps, probes, nq, masked_page)
    codes, scales, qn = _queries(card, rng, nq, d, True)
    before = _cuda.KERNEL_LAUNCHES[score_blocks.QUANT_SCORE_BLOCKS]
    got = score_blocks.quant_score_blocks(payloads, groups, codes, scales, qn, width, metric)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[score_blocks.QUANT_SCORE_BLOCKS] == before + 1
    want = score_blocks.quant_score_blocks_plain(
        payloads, groups, codes, scales, qn, width, metric)
    assert torch.equal(got, want)
    if masked_page:
        for qi, col in zip(groups.queries[:2].tolist(), groups.cols[:2].tolist()):
            assert torch.isneginf(got[qi, col:col + PAGE]).all()


def _block_in_one_buffer(card, rng, n, d):
    """One int8 block of ``n`` rows whose codes, scales, norms and mask are
    views of one allocation, as a staged block's tensors are fresh ones."""
    vecs = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
    codes, srow = _quantize_rows(vecs)
    norms = np.sum(vecs * vecs, axis=1).astype(np.float32)
    mask = np.where(rng.random(n) < 0.1, np.float32(-np.inf), np.float32(0.0)).astype(np.float32)
    buf = torch.empty(n * d + 12 * n, dtype=torch.uint8, device=card)
    block = (buf[:n * d].view(torch.int8).view(n, d),) + tuple(
        buf[n * d + 4 * n * i:n * d + 4 * n * (i + 1)].view(torch.float32) for i in range(3))
    for t, a in zip(block, (codes, srow, norms, mask)):
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return block


@pytest.mark.cuda
def test_quant_score_blocks_rebuilds_its_work_list_for_a_reused_address(card):
    """A block freed after one call and a block of other rows that the
    caching allocator puts at the same addresses: the second call scores
    the second block's rows, since no pointer or list outlives a call."""
    rng = np.random.default_rng(31)
    n = 60_000  # 24 MB: a segment of its own, the best fit for the next block
    groups = score_blocks.BlockGroups(np.array([0, 2]), np.array([0, 1]), np.array([0, 0]))
    args = (groups, *_queries(card, rng, 2, 384, True), n, "cos")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    first = _block_in_one_buffer(card, rng, n, 384)
    out1 = score_blocks.quant_score_blocks([first], *args)
    torch.cuda.synchronize()
    ptrs = [t.data_ptr() for t in first]
    del first
    second = _block_in_one_buffer(card, np.random.default_rng(32), n, 384)
    assert [t.data_ptr() for t in second] == ptrs
    out2 = score_blocks.quant_score_blocks([second], *args)
    assert torch.equal(out2, score_blocks.quant_score_blocks_plain([second], *args))
    assert not torch.equal(out2, out1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_threads,calls", [(2, 40), (12, 15)])
def test_quant_score_blocks_from_two_threads_on_two_streams(card, n_threads, calls):
    """Host threads, each on its own stream, score different batches at
    once (12 of them, more than the card machine's cores, with a short
    switch interval): the pinned staging of the work lists is never shared
    by two copies in flight, and every result equals its own batch's plain
    version."""
    import sys

    rng = np.random.default_rng(33)
    batches = []
    for _ in range(n_threads):
        payloads, groups, width = _probed_blocks(
            card, rng, 384, [3000, 700, 129], [[0, 2], [1], [0, 1, 2]], 3)
        batches.append((payloads, groups, *_queries(card, rng, 3, 384, True), width))
    torch.cuda.synchronize()
    results = {i: [] for i in range(n_threads)}
    start = threading.Barrier(n_threads)

    def run(i):
        payloads, groups, codes, scales, qn, width = batches[i]
        with torch.cuda.stream(torch.cuda.Stream()):
            start.wait()
            for _ in range(calls):
                results[i].append(score_blocks.quant_score_blocks(
                    payloads, groups, codes, scales, qn, width, "l2sq"))
            torch.cuda.current_stream().synchronize()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for i in range(n_threads):
        payloads, groups, codes, scales, qn, width = batches[i]
        want = score_blocks.quant_score_blocks_plain(
            payloads, groups, codes, scales, qn, width, "l2sq")
        assert len(results[i]) == calls
        assert all(torch.equal(got, want) for got in results[i])


@pytest.mark.cuda
def test_quant_score_blocks_does_not_sync_the_host(card):
    rng = np.random.default_rng(34)
    payloads, groups, width = _probed_blocks(card, rng, 384, [2000, 300], [[0], [0, 1]], 2)
    args = (payloads, groups, *_queries(card, rng, 2, 384, True), width, "ip")
    score_blocks.quant_score_blocks(*args)  # builds the kernel and a pinned buffer first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = score_blocks.quant_score_blocks(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, score_blocks.quant_score_blocks_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["query", "columns", "offsets", "dtype", "alignment", "rows"])
def test_quant_score_blocks_refuses_a_bad_work_list(card, fault):
    """Each check made before a launch raises ``ValueError`` and launches
    nothing: a query outside the batch, columns past the output, offsets
    that do not match the blocks, a payload of the wrong type, one off a
    16-byte boundary, one of the wrong row count."""
    rng = np.random.default_rng(35)
    payloads, groups, width = _probed_blocks(card, rng, 32, [200, 50], [[0, 1], [1]], 2)
    codes, scales, qn = _queries(card, rng, 2, 32, True)
    off, gq, gcol = groups.offsets.copy(), groups.queries.copy(), groups.cols.copy()
    codes_b, srow_b, norms_b, mask_b = payloads[1]
    if fault == "query":
        gq[-1] = 2
    elif fault == "columns":
        gcol[-1] = width - 10
    elif fault == "offsets":  # one entry left out of every group
        off[-1] -= 1
    elif fault == "dtype":
        payloads[1] = (codes_b, srow_b.double(), norms_b, mask_b)
    elif fault == "alignment":
        payloads[1] = (codes_b[1:], srow_b[1:], norms_b[1:], mask_b[1:])
    else:
        payloads[1] = (codes_b, srow_b, norms_b[:49], mask_b)
    before = _cuda.KERNEL_LAUNCHES[score_blocks.QUANT_SCORE_BLOCKS]
    with pytest.raises(ValueError):
        score_blocks.quant_score_blocks(payloads, score_blocks.BlockGroups(off, gq, gcol),
                                        codes, scales, qn, width, "ip")
    assert _cuda.KERNEL_LAUNCHES[score_blocks.QUANT_SCORE_BLOCKS] == before


# -- the int8 coarse probe: a warp per centroid row, the queries staged ------------


def _probe_inputs(card, rng, c_pad, q_pad, d):
    """A probe table as the tiered store builds it: ``n_real`` (about 3/4 of
    ``c_pad``) quantized centroids, the rest pad rows with ``cn = +inf``;
    and ``q_pad`` query code rows. Returns (the five card tensors, n_real)."""
    n_real = max(1, c_pad * 3 // 4 - 1)
    cents = rng.normal(size=(n_real, d)).astype(np.float32)
    codes = np.zeros((c_pad, d), dtype=np.int8)
    scales = np.ones(c_pad, dtype=np.float32)
    cn = np.full(c_pad, np.inf, dtype=np.float32)
    scales[:n_real] = np.max(np.abs(cents), axis=1) / 127.0
    codes[:n_real] = np.clip(np.rint(cents / scales[:n_real, None]), -127, 127).astype(np.int8)
    cn[:n_real] = np.sum(cents * cents, axis=1)
    qc, qs, _qn = _queries(card, rng, q_pad, d, True)
    return [torch.from_numpy(a).to(card) for a in (codes, scales, cn)] + [qc, qs], n_real


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 100, 384])  # 100: a multiple of 4, not of 16
@pytest.mark.parametrize("q_pad", [8, 32, 64])
@pytest.mark.parametrize("c_pad", [8, 128, 4096])
def test_quant_probe_kernel_bitwise_at_every_shape(card, c_pad, q_pad, d):
    """The kernel equals its plain version bit for bit, and pad centroids
    score -inf, at the store's table sizes (one cluster block of 8, the
    smoke's 128, a store split many times) and batch pads."""
    rng = np.random.default_rng(c_pad * 7 + q_pad * 3 + d)
    args, n_real = _probe_inputs(card, rng, c_pad, q_pad, d)
    before = _cuda.KERNEL_LAUNCHES[knn_quant.QUANT_PROBE]
    got = knn_quant.quant_probe(*args)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[knn_quant.QUANT_PROBE] == before + 1
    assert torch.equal(got, knn_quant.quant_probe_plain(*args))
    assert torch.isneginf(got[:, n_real:]).all() and torch.isfinite(got[:, :n_real]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("q_pad,d", [(160, 384), (9, 6144), (3, 6148), (5, 4)])
def test_quant_probe_kernel_chunks_queries_and_takes_wide_rows(card, q_pad, d):
    """Many query groups of 8 (160 rows), the widest rows the kernel stages
    (two groups), rows past them (read from device memory), the narrowest
    row: bitwise the plain version (run on the CPU, which takes the int64
    dot past the f32-exact width)."""
    rng = np.random.default_rng(q_pad + d)
    args, _n_real = _probe_inputs(card, rng, 16, q_pad, d)
    got = knn_quant.quant_probe(*args)
    want = knn_quant.quant_probe_plain(*(t.cpu() for t in args))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("q_pad", [8, 32])
def test_quant_probe_scores_do_not_depend_on_table_capacity_or_query_order(card, q_pad):
    """A (query, centroid) score is the same bits in a table of twice the
    capacity (another grid) and with the batch's rows reversed."""
    rng = np.random.default_rng(40 + q_pad)
    (qc, cs, cn, q, qs), n_real = _probe_inputs(card, rng, 128, q_pad, 384)
    wide = [torch.cat([t, t[-1:].expand(t.shape[0], *t.shape[1:])]).contiguous()
            for t in (qc, cs, cn)]
    a = knn_quant.quant_probe(qc, cs, cn, q, qs)
    w = knn_quant.quant_probe(*wide, q, qs)
    f = knn_quant.quant_probe(qc, cs, cn, q.flip(0).contiguous(), qs.flip(0).contiguous())
    assert torch.equal(a[:, :n_real], w[:, :n_real])
    assert torch.equal(a, f.flip(0))


@pytest.mark.cuda
def test_quant_probe_refuses_a_misaligned_or_foreign_query(card):
    rng = np.random.default_rng(41)
    (qc, cs, cn, q, qs), _n = _probe_inputs(card, rng, 16, 8, 32)
    table = knn_quant.ProbeTable(qc, cs, cn)
    flat = torch.zeros(8 * 32 + 2, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="4-byte"):
        table.scores(flat[2:].view(8, 32), qs)
    with pytest.raises(ValueError, match="expected"):
        table.scores(q.cpu(), qs)
    with pytest.raises(ValueError, match="expected"):
        knn_quant.ProbeTable(qc, cs.double(), cn)


def _int8_tiered(card, docs, cents):
    store = knn_tiers.TieredIvfKnnStore(32, n_clusters=8, n_probe=3, quant="int8", device=card)
    store.add_many([f"d{i}" for i in range(len(docs))], docs)
    store.set_centroids(cents)
    return store


@pytest.mark.cuda
def test_tiered_search_on_shared_query_views_equals_separate_copies(card, monkeypatch):
    """The probe and the block scorer read views of one staged copy of the
    batch's query data (one copy per search); the same searches with each
    view copied into a tensor of its own give the same bits."""
    centers, docs = _clustered_docs(6000, 32, 8, 24)
    cents = docs[np.random.default_rng(25).choice(6000, 8, replace=False)]
    q = (centers[np.arange(16) % 8] + np.random.default_rng(26).normal(size=(16, 32))
         ).astype(np.float32)
    batches = [q[:1], q[:8], q[:3], q]
    shared = _int8_tiered(card, docs, cents)
    want = [shared.search_batch(b, 10) for b in batches]
    assert shared.tier_stats()["query_sends"] == len(batches)
    real_upload = knn_tiers._QueryStage.upload
    monkeypatch.setattr(knn_tiers._QueryStage, "upload",
                        lambda self, n, layout: [v.clone() for v in real_upload(self, n, layout)])
    apart = _int8_tiered(card, docs, cents)
    for b, w in zip(batches, want):
        for x, y in zip(apart.search_batch(b, 10), w):
            np.testing.assert_array_equal(x, y)
    shared.close()
    apart.close()


@pytest.mark.cuda
def test_tiered_search_from_two_threads_on_two_streams(card):
    """Two threads search one int8 store at once, each on a stream of its
    own: the searches take turns over the store's staging buffers, and each
    thread gets a lone caller's answers bitwise."""
    centers, docs = _clustered_docs(6000, 32, 8, 27)
    cents = docs[np.random.default_rng(28).choice(6000, 8, replace=False)]
    q = (centers[np.arange(32) % 8] + np.random.default_rng(29).normal(size=(32, 32))
         ).astype(np.float32)
    batches = [q[:1], q[:8], q[:3], q]
    store = _int8_tiered(card, docs, cents)
    want = [store.search_batch(b, 10) for b in batches]
    got, errors = {}, []

    def worker(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream(card)):
                got[t] = [store.search_batch(b, 10) for _ in range(10) for b in batches]
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for t in range(2):
        for i, res in enumerate(got[t]):
            for a, b in zip(res, want[i % len(batches)]):
                np.testing.assert_array_equal(a, b)
    assert store.tier_stats()["query_sends"] == store._batches
    store.close()
