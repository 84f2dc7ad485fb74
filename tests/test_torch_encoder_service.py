"""Port parity of the query-serving embed path: the semantic query cache, the
encoder service, the coalescer (as the deadline batcher and as the
admission shim), the pipeline's query lookups and the embedder
(``pathway_tpu_torch/models/encoder_service.py``,
``models/embed_pipeline.py``, ``xpacks/llm/embedders.py``) against the
reference's (``pathway_tpu/models/...``), on the CPU.

Deterministic decisions are compared value for value: the same put / get
trace gives the same hits, misses, evictions and rows in every semantic
mode; the same tick splits into the same length-sorted dispatches; the same
queue state and encode-time average give the same ``Retry-After``; the same
query sequence gives the same cache counters. Behaviour under concurrency
(own rows per client, dedup inside a tick, an error reaching every waiter,
the deadline anchored at arrival, shedding) is driven through both packages
with the same mock encoder and must hold in both. The tiny encoder's
weights come from the reference (``params_from_jax``); the engine tests show
that a retraction reaches neither the encoder nor the semantic cache and that
no service thread outlives ``pw.run``."""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

import pathway_tpu_torch as pw
from pathway_tpu.models import embed_pipeline as ref_pipe
from pathway_tpu.models import encoder_service as ref_svc
from pathway_tpu.models.encoder import EncoderConfig as RefConfig
from pathway_tpu.models.encoder import JaxSentenceEncoder
from pathway_tpu_torch.engine import telemetry as port_tel
from pathway_tpu_torch.engine.runner import GraphRunner
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.models import embed_pipeline as port_pipe
from pathway_tpu_torch.models import encoder_service as port_svc
from pathway_tpu_torch.models.encoder import EncoderConfig, TorchSentenceEncoder, params_from_jax
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

torch.set_num_threads(1)

PKGS = {"ref": (ref_svc, ref_pipe), "port": (port_svc, port_pipe)}


@pytest.fixture(autouse=True)
def fresh_ladders():
    """Each coalescer probe feeds its package's brownout ladder an occupancy
    sample: a full test queue engages rung 2, which must not outlive the test."""
    from pathway_tpu.engine.brownout import reset_brownout as ref_reset
    from pathway_tpu_torch.engine.brownout import reset_brownout as port_reset

    ref_reset()
    port_reset()
    yield
    ref_reset()
    port_reset()
TINY = dict(vocab_size=8192, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)


def _hash_rows(texts):
    out = []
    for t in texts:
        h = np.frombuffer(str(t).encode().ljust(8, b"\0")[:8], dtype=np.uint8)
        out.append(h.astype(np.float32))
    return out


class _HashEncoder:
    """Instant deterministic encoder: a row encodes its text's identity."""

    dim = 8

    def __init__(self):
        self.calls = []

    def encode_device(self, texts):
        self.calls.append(list(texts))
        return np.stack(_hash_rows(texts))


class _GatedHashEncoder(_HashEncoder):
    """Holds the first dispatch until ``release`` is set, so a burst piles up."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()
        self.entered = threading.Event()
        self._first = True

    def encode_device(self, texts):
        if self._first:
            self._first = False
            self.entered.set()
            self.release.wait(timeout=10)
        return super().encode_device(texts)


def _until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"{what} did not happen in {timeout}s"
        time.sleep(0.005)


# -- the semantic query cache ---------------------------------------------------


def _semantic_trace(seed: int):
    """put / get / seed operations over texts, their whitespace and case
    variants, near matches (a word dropped or added) and unrelated texts."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(40)] + ["What", "is", "RAG?", "index", "Vector"]
    bases = [" ".join(rng.choice(vocab, size=int(rng.integers(3, 9)))) for _ in range(24)]

    def variant(text: str) -> str:
        words = text.split()
        kind = int(rng.integers(0, 5))
        if kind == 0:
            return "  " + "   ".join(words).upper() + " "
        if kind == 1 and len(words) > 3:
            return " ".join(words[:-1])
        if kind == 2:
            return text + " " + str(rng.choice(vocab))
        if kind == 3:
            return " ".join(rng.choice(vocab, size=len(words)))
        return text

    ops = []
    for _ in range(300):
        r = rng.random()
        base = bases[int(rng.integers(len(bases)))]
        if r < 0.35:
            ops.append(("put", variant(base), rng.normal(size=4).astype(np.float32)))
        elif r < 0.45:
            ops.append(("seed", variant(base), rng.normal(size=4).astype(np.float32)))
        else:
            ops.append(("get", variant(base), None))
    return ops


@pytest.mark.parametrize(
    "mode,threshold,size,key_tag",
    [
        ("exact", 0.95, 8, ""),
        ("exact", 0.95, 64, "quant:int8"),
        ("cosine", 0.8, 8, ""),
        ("cosine", 0.95, 32, ""),
        ("cosine", 0.999, 16, "quant:int8"),
        ("off", 0.95, 8, ""),
    ],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_semantic_cache_trace_equals_the_reference(mode, threshold, size, key_tag, seed):
    kw = dict(mode=mode, threshold=threshold, key_tag=key_tag)
    ref = ref_svc.SemanticQueryCache(size, **kw)
    port = port_svc.SemanticQueryCache(size, **kw)
    hits = 0
    for op, text, vec in _semantic_trace(seed):
        if op == "get":
            want, got = ref.get(text), port.get(text)
            assert (got is None) == (want is None), text
            if want is not None:
                hits += 1
                assert np.array_equal(got, want) and not got.flags.writeable
        else:
            getattr(ref, op)(text, vec)
            getattr(port, op)(text, vec)
        assert len(port) == len(ref)
    assert port.stats() == ref.stats()
    if mode != "off":
        assert hits > 0 and ref.stats()["semantic_misses"] > 0
    if mode == "cosine" and threshold < 0.9:
        assert ref.stats()["semantic_cosine_hits"] > 0


def test_cosine_proxy_equals_the_reference():
    """The port's own XXH32 gives the reference's (``xxhash``) proxies."""
    ref = ref_svc.SemanticQueryCache(4, mode="cosine")
    port = port_svc.SemanticQueryCache(4, mode="cosine")
    for text in ["how do i restart a crashed worker rank", "", "ünïcode wörds ok", "a a a b"]:
        np.testing.assert_array_equal(port._proxy(text), ref._proxy(text))


def test_default_canonicalize_equals_the_reference():
    for text in ["  What   is  RAG? ", "\tTabs\nand\r\nlines", "", "ÄÖÜ ß"]:
        assert port_svc.default_canonicalize(text) == ref_svc.default_canonicalize(text)


# -- the encoder service ----------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_solo_submit_waits_for_no_window(pkg):
    svc_mod, _pipe = PKGS[pkg]
    svc = svc_mod.EncoderService(_HashEncoder(), tick_ms=5_000.0, prewarm=False)
    t0 = time.perf_counter()
    out = svc.submit(["solo"])
    assert time.perf_counter() - t0 < 2.0
    assert np.array_equal(out[0], _hash_rows(["solo"])[0])
    svc.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_concurrent_clients_coalesce_and_get_their_own_rows(pkg):
    svc_mod, _pipe = PKGS[pkg]
    enc = _GatedHashEncoder()
    svc = svc_mod.EncoderService(enc, prewarm=False)
    results: dict = {}

    def client(i: int) -> None:
        results[i] = svc.submit([f"query {i}"])[0]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    threads[0].start()
    _until(enc.entered.is_set, what="tick 1")
    for t in threads[1:]:
        t.start()
    _until(lambda: svc.queue_depth_rows() == 16, what="the pile-up")
    enc.release.set()
    for t in threads:
        t.join(timeout=10)
    for i in range(16):
        assert np.array_equal(results[i], _hash_rows([f"query {i}"])[0]), i
    # tick 1 held one row; the 15 others rode one tick
    assert (svc.ticks, svc.requests, svc.max_tick_rows) == (2, 16, 15)
    assert svc.queue_depth_rows() == 0
    svc.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_dedups_equal_texts_in_a_tick(pkg):
    svc_mod, _pipe = PKGS[pkg]
    enc = _GatedHashEncoder()
    svc = svc_mod.EncoderService(enc, prewarm=False)
    out: list = [None] * 8

    def client(i: int) -> None:
        out[i] = svc.submit(["same question"])[0]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    threads[0].start()
    _until(enc.entered.is_set, what="tick 1")
    for t in threads[1:]:
        t.start()
    _until(lambda: svc.queue_depth_rows() == 8, what="the pile-up")
    enc.release.set()
    for t in threads:
        t.join(timeout=10)
    assert all(np.array_equal(v, _hash_rows(["same question"])[0]) for v in out)
    assert enc.calls == [["same question"], ["same question"]]
    assert svc.ticks == 2 and svc.dedup_rows == 6
    svc.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_error_reaches_every_waiter_and_releases_the_slots(pkg):
    svc_mod, _pipe = PKGS[pkg]

    class _Failing(_GatedHashEncoder):
        def encode_device(self, texts):
            super().encode_device(texts)
            raise RuntimeError("encoder exploded")

    enc = _Failing()
    svc = svc_mod.EncoderService(enc, prewarm=False)
    errors: list = []

    def client(i: int) -> None:
        try:
            svc.submit([f"q{i}"])
        except RuntimeError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    threads[0].start()
    _until(enc.entered.is_set, what="tick 1")
    for t in threads[1:]:
        t.start()
    _until(lambda: svc.queue_depth_rows() == 4, what="the pile-up")
    enc.release.set()
    for t in threads:
        t.join(timeout=10)
    assert errors == ["encoder exploded"] * 4
    assert svc.queue_depth_rows() == 0
    svc.encoder = _HashEncoder()  # the worker survives a failing tick
    assert np.array_equal(svc.submit(["later"])[0], _hash_rows(["later"])[0])
    svc.close()


def test_service_large_tick_splits_as_the_reference():
    texts = [f"{'w ' * (i % 7 + 1)}q{i}" for i in range(10)]
    calls = {}
    for pkg, (svc_mod, _pipe) in PKGS.items():
        enc = _HashEncoder()
        svc = svc_mod.EncoderService(enc, sub_batch=4, prewarm=False)
        out = svc.submit(texts)
        for i, t in enumerate(texts):
            assert np.array_equal(out[i], _hash_rows([t])[0]), (pkg, i)
        calls[pkg] = enc.calls
        assert svc.batches == 3
        svc.close()
    assert calls["port"] == calls["ref"]
    lengths = [len(t.split()) for b in calls["port"] for t in b]
    assert lengths == sorted(lengths) and [len(b) for b in calls["port"]] == [4, 4, 2]


@pytest.mark.parametrize("pending,ewma", [(0, 0.0), (3, 0.02), (40, 0.3), (1000, 2.0)])
def test_service_local_cap_sheds_with_the_reference_retry_after(pending, ewma):
    got = {}
    for pkg, (svc_mod, pipe_mod) in PKGS.items():
        svc = svc_mod.EncoderService(_HashEncoder(), prewarm=False, max_in_flight=16,
                                     max_queue_rows=pending + 1)
        svc._queued_rows = pending  # the queue state, without racing a worker
        svc._encode_ewma_s = ewma
        with pytest.raises(pipe_mod.EmbedOverloadError) as info:
            svc.submit(["a", "b"])
        got[pkg] = info.value.retry_after_s
        assert svc.shed_requests == 1
        svc._queued_rows = 0
        assert len(svc.submit(["ok"], enforce_cap=False)) == 1
        svc.close()
    assert got["port"] == got["ref"] >= 1.0


def test_prewarm_buckets_equal_the_reference():
    ref_enc = JaxSentenceEncoder("pw-test-tiny", config=RefConfig(**TINY), max_length=128)
    port_enc = TorchSentenceEncoder("pw-test-tiny", config=EncoderConfig(**TINY),
                                    max_length=128, device="cpu")
    for kw in ({}, {"prewarm_max_batch": 8, "max_in_flight": 8}, {"max_in_flight": 20}):
        ref = ref_svc.EncoderService(ref_enc, prewarm=False, **kw)
        port = port_svc.EncoderService(port_enc, prewarm=False, **kw)
        assert port._prewarm_shapes() == ref._prewarm_shapes()
        ref.close()
        port.close()
    shapes = port_svc.EncoderService(port_enc, prewarm=False)._prewarm_shapes()
    assert len(shapes) == 20 and shapes[0] == (8, 8) and shapes[-1] == (64, 128)


def test_prewarm_walks_every_bucket_and_reports_its_time():
    enc = TorchSentenceEncoder("pw-test-tiny", config=EncoderConfig(**TINY),
                               max_length=64, device="cpu")
    before = port_tel.stage_snapshot("embed.svc.").get("embed.svc.prewarm_compiles", 0.0)
    svc = port_svc.EncoderService(enc, prewarm=True, prewarm_max_batch=8, max_in_flight=8)
    assert svc.wait_warm(timeout_s=120.0)
    assert svc.prewarm_compiles == 4 and svc.prewarm_s > 0.0 and svc.prewarm_error is None
    assert port_tel.stage_snapshot("embed.svc.")["embed.svc.prewarm_compiles"] == before + 4
    stats = svc.stats()
    assert stats["svc_warm"] and stats["svc_prewarm_compiles"] == 4
    row = svc.submit(["warm bucket query"])[0]
    assert torch.equal(row, enc.encode_device(["warm bucket query"])[0])
    svc.close()


def test_stop_worker_aborts_the_prewarm_without_a_worker():
    enc = TorchSentenceEncoder("pw-test-tiny", config=EncoderConfig(**TINY), device="cpu")
    svc = port_svc.EncoderService(enc, prewarm=True, prewarm_max_batch=256, max_in_flight=256)
    svc.stop_worker()
    assert svc._prewarm_thread is None or not svc._prewarm_thread.is_alive()
    assert svc._prewarm_abort.is_set() and svc.warm
    svc.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_mock_encoders_are_warm_at_once(pkg):
    svc = PKGS[pkg][0].EncoderService(_HashEncoder(), prewarm=True)
    assert svc.warm and svc.prewarm_compiles == 0
    svc.close()


# -- the coalescer: deadline batcher and admission shim ---------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_coalescer_concurrent_rows_do_not_leak(pkg):
    batches = []

    def encode_rows(texts):
        batches.append(list(texts))
        time.sleep(0.02)
        return _hash_rows(texts)

    co = PKGS[pkg][1].QueryCoalescer(encode_rows, max_wait_ms=10.0, max_batch=64)
    results: dict = {}

    def client(i: int) -> None:
        results[i] = co.embed([f"query {i}"])[0]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(16):
        assert np.array_equal(results[i], _hash_rows([f"query {i}"])[0]), i
    assert co.batches < co.requests and co.coalesced_rows == 16
    assert sum(len(b) for b in batches) + co.dedup_rows == 16
    co.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_coalescer_deadline_anchors_at_arrival(pkg):
    release = threading.Event()
    gate_used = [False]

    def encode_rows(texts):
        if not gate_used[0]:
            gate_used[0] = True
            release.wait(5.0)
        return _hash_rows(texts)

    co = PKGS[pkg][1].QueryCoalescer(encode_rows, max_wait_ms=400.0, max_batch=64)
    t_done: dict = {}

    def client(name: str) -> None:
        co.embed([name])
        t_done[name] = time.perf_counter()

    first = threading.Thread(target=client, args=("first",))
    first.start()
    time.sleep(0.1)
    second = threading.Thread(target=client, args=("second",))
    second.start()
    time.sleep(0.5)  # 'second' waited out its window behind the busy encoder
    t_release = time.perf_counter()
    release.set()
    first.join()
    second.join()
    assert t_done["second"] - t_release < 0.3
    co.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_coalescer_error_reaches_every_waiter(pkg):
    def encode_rows(texts):
        raise RuntimeError("encoder exploded")

    co = PKGS[pkg][1].QueryCoalescer(encode_rows, max_wait_ms=10.0, max_batch=8)
    errors = []

    def client(i: int) -> None:
        try:
            co.embed([f"q{i}"])
        except RuntimeError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == ["encoder exploded"] * 3
    co._encode_rows = _hash_rows
    assert np.array_equal(co.embed(["later"])[0], _hash_rows(["later"])[0])
    co.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_coalescer_cap_sheds_direct_callers_and_reopens(pkg):
    pipe_mod = PKGS[pkg][1]
    release = threading.Event()

    def encode_rows(texts):
        release.wait(10.0)
        return _hash_rows(texts)

    co = pipe_mod.QueryCoalescer(encode_rows, max_wait_ms=5.0, max_batch=1, max_queue_rows=2)
    done: dict = {}

    def client(name, texts):
        done[name] = co.embed(texts)

    ta = threading.Thread(target=client, args=("a", ["a"]))
    ta.start()
    _until(lambda: (co._queued_rows, co.requests) == (0, 1), what="row a in flight")
    tb = threading.Thread(target=client, args=("b", ["b1", "b2"]))
    tb.start()
    _until(lambda: co._queued_rows == 2, what="row b queued")
    with pytest.raises(pipe_mod.EmbedOverloadError) as info:
        co.embed(["c"])
    assert info.value.retry_after_s >= 1.0 and co.shed_requests == 1
    release.set()
    ta.join(timeout=10)
    tb.join(timeout=10)
    assert np.array_equal(done["b"][1], _hash_rows(["b2"])[0])
    assert np.array_equal(co.embed(["d"])[0], _hash_rows(["d"])[0])
    co.close()


@pytest.mark.parametrize("queued,extra,ewma", [(0, 2, 0.0), (0, 20, 2.0), (9, 1, 0.05), (300, 0, 0.7)])
@pytest.mark.parametrize("shim", [False, True])
def test_retry_after_and_overload_probe_equal_the_reference(queued, extra, ewma, shim):
    got = {}
    for pkg, (svc_mod, pipe_mod) in PKGS.items():
        svc = svc_mod.EncoderService(_HashEncoder(), prewarm=False, max_in_flight=32) if shim else None
        co = pipe_mod.QueryCoalescer(
            _hash_rows, max_wait_ms=100.0, max_batch=2, max_queue_rows=10, service=svc
        )
        if shim:
            svc._queued_rows, svc._encode_ewma_s = queued, ewma
        else:
            co._queued_rows, co._encode_ewma_s = queued, ewma
        got[pkg] = (co.retry_after_s(extra_rows=extra), co.overloaded(extra_rows=extra))
        co.close()
        if svc is not None:
            svc._queued_rows = 0
            svc.close()
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_engine_path_bypasses_the_cap(pkg):
    co = PKGS[pkg][1].QueryCoalescer(_hash_rows, max_wait_ms=1.0, max_queue_rows=2)
    co._queued_rows = 5
    assert co.overloaded()
    got = co.embed(["x", "y", "z"], enforce_cap=False)
    assert np.array_equal(got[2], _hash_rows(["z"])[0]) and co.shed_requests == 0
    co._queued_rows = 0
    assert not co.overloaded()
    co.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_shim_sheds_when_the_service_is_backed_up(pkg):
    svc_mod, pipe_mod = PKGS[pkg]
    enc = _GatedHashEncoder()
    pipe = pipe_mod.EmbedPipeline(enc, model="shed", cache_size=0, max_queue_rows=2, prewarm=False)
    assert pipe.coalescer._service is pipe.service
    done: dict = {}

    def client(name, texts):
        done[name] = pipe.coalescer.embed(texts)

    ta = threading.Thread(target=client, args=("a", ["a"]))
    ta.start()
    _until(lambda: pipe.service.queue_depth_rows() == 1, what="row a in flight")
    tb = threading.Thread(target=client, args=("b", ["b"]))
    tb.start()
    _until(lambda: pipe.service.queue_depth_rows() == 2, what="row b queued")
    assert pipe.coalescer.overloaded()
    with pytest.raises(pipe_mod.EmbedOverloadError) as info:
        pipe.coalescer.embed(["c"])
    assert info.value.retry_after_s >= 1.0 and pipe.coalescer.shed_requests == 1
    td = threading.Thread(
        target=lambda: done.update(d=pipe.coalescer.embed(["d"], enforce_cap=False))
    )
    td.start()
    enc.release.set()
    for t in (ta, tb, td):
        t.join(timeout=10)
    assert all(k in done for k in "abd")
    assert not pipe.coalescer.overloaded()
    pipe.service.close()


def test_port_shed_counts_on_embed_shed():
    before = port_tel.stage_snapshot("embed.").get("embed.shed", 0.0)
    co = port_pipe.QueryCoalescer(_hash_rows, max_queue_rows=1)
    co._queued_rows = 1
    with pytest.raises(port_pipe.EmbedOverloadError):
        co.embed(["x"])
    assert port_tel.stage_snapshot("embed.")["embed.shed"] == before + 1
    co._queued_rows = 0
    co.close()


# -- the pipeline's query path -------------------------------------------------------


def _query_script():
    base = ["What is a Vector  Index?", "tumbling windows", "what is rag", "ivf pages"]
    return [
        [base[0]], [base[1], base[2]], ["  what IS a vector index?  "], [base[0], base[3]],
        ["TUMBLING   windows"], [base[2]], ["what is rag", "What is RAG"], ["new one"],
    ]


def test_query_lookups_and_promotion_equal_the_reference():
    """Content hash first, then the semantic cache, each promoting into the
    other: the same query sequence gives the same counters in both."""
    pipes = {}
    for pkg, (_svc, pipe_mod) in PKGS.items():
        pipes[pkg] = pipe_mod.EmbedPipeline(_HashEncoder(), model="m", cache_size=64, prewarm=False)
    for texts in _query_script():
        rows = {}
        for pkg, pipe in pipes.items():
            rows[pkg] = pipe.embed_query_rows(texts)
            _until(lambda: pipe.service.ticks == pipe.service.requests and
                   len(pipe.cache) >= len(pipe.semantic_cache) - 1, what="cache fill")
        for a, b in zip(rows["port"], rows["ref"]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        want = pipes["ref"].stats()
        got = pipes["port"].stats()
        for key in ("cache_hits", "cache_misses", "semantic_exact_hits",
                    "semantic_cosine_hits", "semantic_misses", "svc_rows", "svc_requests"):
            assert got[key] == want[key], (texts, key)
    assert pipes["port"].stats()["semantic_exact_hits"] >= 2
    assert set(pipes["port"].stats()) == set(pipes["ref"].stats())
    for pipe in pipes.values():
        pipe.service.close()


@pytest.fixture(scope="module")
def tiny_pair():
    ref = JaxSentenceEncoder("pw-test-tiny", config=RefConfig(**TINY), max_length=64)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    port = TorchSentenceEncoder("pw-test-tiny", config=EncoderConfig(**TINY), max_length=64,
                                device="cpu", params=params)
    return ref, port


def test_exact_semantic_hit_is_the_bitwise_encode(tiny_pair):
    _ref, enc = tiny_pair
    pipe = port_pipe.EmbedPipeline(enc, model="t", cache_size=64, prewarm=False)
    pipe.embed_query_rows(["What is a Vector  Index?"])
    _until(lambda: len(pipe.cache) >= 1, what="cache fill")
    variant = "  what IS a vector index?  "
    before = enc.dispatches
    row = pipe.embed_query_rows([variant])[0]
    assert enc.dispatches == before  # no forward
    assert pipe.semantic_cache.stats()["semantic_exact_hits"] == 1
    np.testing.assert_array_equal(np.asarray(row), enc.encode([variant])[0])
    pipe.service.close()


def test_query_rows_agree_with_the_reference_encoder(tiny_pair):
    ref, enc = tiny_pair
    texts = ["what is a vector index", "tumbling window aggregation semantics", "ivf"]
    got = {}
    for pkg, pipe_mod, e in (("ref", ref_pipe, ref), ("port", port_pipe, enc)):
        pipe = pipe_mod.EmbedPipeline(e, model="agree", cache_size=64, prewarm=False)
        got[pkg] = np.stack([np.asarray(v, dtype=np.float32) for v in pipe.embed_query_rows(texts)])
        pipe.service.close()
    cos = np.sum(got["port"] * got["ref"], axis=1) / (
        np.linalg.norm(got["port"], axis=1) * np.linalg.norm(got["ref"], axis=1)
    )
    assert cos.min() >= 0.999, cos


def test_reingest_is_never_served_from_the_semantic_cache(tiny_pair):
    _ref, enc = tiny_pair
    pipe = port_pipe.EmbedPipeline(enc, model="t5", cache_size=64, prewarm=False)
    text = "document chunk about cats"
    truth = pipe.encode_batch([text])[0]
    poison = np.full(TINY["hidden_size"], 777.0, dtype=np.float32)
    pipe.semantic_cache.put(text, poison)
    pipe.cache.clear()
    again = pipe.encode_batch(["  DOCUMENT chunk about cats  "])[0]
    assert not np.array_equal(again, poison)
    np.testing.assert_array_equal(pipe.encode_batch([text])[0], truth)
    pipe.service.close()


def test_cache_fill_is_one_copy_on_the_worker_after_the_answer(tiny_pair):
    _ref, enc = tiny_pair
    pipe = port_pipe.EmbedPipeline(enc, model="fill", cache_size=64, prewarm=False)
    threads = []
    orig = pipe.cache.put

    def put(text, vec):
        threads.append(threading.current_thread().name)
        orig(text, vec)

    pipe.cache.put = put
    rows = pipe.embed_query_rows(["one", "two", "three"])
    _until(lambda: len(threads) == 3, what="cache fill")
    assert set(threads) == {"pathway:encsvc-worker"}
    for t, r in zip(["one", "two", "three"], rows):
        np.testing.assert_array_equal(pipe.cache.get(t), r.float().numpy())
    pipe.service.close()


def test_pipeline_knobs_and_env_defaults(monkeypatch):
    enc = _HashEncoder()
    monkeypatch.delenv("PATHWAY_EMBED_MAX_QUEUE_ROWS", raising=False)
    monkeypatch.delenv("PATHWAY_ENCSVC", raising=False)
    pipe = port_pipe.EmbedPipeline(enc, prewarm=False)
    assert pipe.coalescer.max_queue_rows == 4096 and pipe.service is not None
    assert pipe.semantic_cache.mode == "exact" and pipe.semantic_cache.max_entries == 4096
    assert pipe.service.max_in_flight == 256 and pipe.service.prewarm_max_batch == 64
    pipe.service.close()
    monkeypatch.setenv("PATHWAY_EMBED_MAX_QUEUE_ROWS", "17")
    monkeypatch.setenv("PATHWAY_ENCSVC", "off")
    monkeypatch.setenv("PATHWAY_ENCSVC_SEMANTIC", "cosine")
    for pipe_mod in (port_pipe, ref_pipe):
        pipe = pipe_mod.EmbedPipeline(enc, prewarm=False)
        assert pipe.coalescer.max_queue_rows == 17 and pipe.service is None
        assert pipe.semantic_cache.mode == "cosine"
        pipe.coalescer.close()
    off = port_pipe.EmbedPipeline(enc, cache_size=0, max_queue_rows=0, prewarm=False)
    assert off.semantic_cache.mode == "off" and off.coalescer.max_queue_rows == 0


# -- the embedder and the engine -----------------------------------------------------


def _embedder(**kw):
    return SentenceTransformerEmbedder(
        "pw-test-tiny", device="cpu", encoder_config=EncoderConfig(**TINY), **kw
    )


def test_embedder_default_runs_the_service_and_off_gives_the_deadline_coalescer():
    emb = _embedder(encsvc_prewarm=False)
    assert emb.pipeline.service is not None
    assert emb.pipeline.coalescer._service is emb.pipeline.service
    assert emb.pipeline.semantic_cache.mode == "exact"
    legacy = _embedder(encoder_service=False, max_wait_ms=7.0, max_coalesce_batch=9)
    assert legacy.pipeline.service is None
    assert (legacy.pipeline.coalescer.max_wait_ms, legacy.pipeline.coalescer.max_batch) == (7.0, 9)
    tuned = _embedder(semantic_cache="cosine", semantic_cache_size=5, semantic_threshold=0.5,
                      encsvc_tick_ms=3.0, encsvc_max_in_flight=32, encsvc_prewarm=False)
    sem, svc = tuned.pipeline.semantic_cache, tuned.pipeline.service
    assert (sem.mode, sem.max_entries, sem.threshold) == ("cosine", 5, 0.5)
    assert (svc.tick_s, svc.max_in_flight) == (0.003, 32)
    for e in (emb, tuned):
        e.pipeline.service.close()


@pytest.mark.parametrize("service", [True, False])
def test_retraction_reaches_neither_the_encoder_nor_the_semantic_cache(service):
    emb = _embedder(embed_cache_size=64, encoder_service=service, encsvc_prewarm=False)
    forwards = []
    orig = emb.encoder.encode_device
    emb.encoder.encode_device = lambda t: (forwards.append(list(t)), orig(t))[1]
    sem_gets = []
    orig_get = emb.pipeline.semantic_cache.get
    emb.pipeline.semantic_cache.get = lambda t: (sem_gets.append(t), orig_get(t))[1]
    G.clear()
    t = pw.debug.table_from_rows(
        pw.schema_builder({"id": pw.column_definition(dtype=int, primary_key=True), "q": str}),
        [(1, "what is a cat", 0, 1), (2, "what is a dog", 0, 1), (1, "what is a cat", 2, -1)],
        is_stream=True,
    )
    res = t.select(v=emb.device_expression(t.q))
    got = []
    pw.io.subscribe(
        res, on_batch=lambda keys, diffs, columns, time: got.extend(zip(columns["v"], diffs.tolist()))
    )
    GraphRunner(G).run(device="cpu")
    G.clear()
    assert len(sem_gets) == 2 and sum(len(b) for b in forwards) == 2
    ret = [np.asarray(v) for v, d in got if d == -1]
    ins = [np.asarray(v) for v, d in got if d == 1]
    assert len(ret) == 1 and any(np.array_equal(ret[0], v) for v in ins)


def test_no_service_thread_outlives_pw_run():
    emb = _embedder(embed_cache_size=64)  # pre-warm on: a thread of its own
    G.clear()
    t = pw.debug.table_from_rows(pw.schema_builder({"q": str}), [("a query",), ("another",)])
    res = t.select(v=emb.device_expression(t.q))
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: None)
    GraphRunner(G).run(device="cpu")
    G.clear()
    alive = [th.name for th in threading.enumerate() if th.name.startswith("pathway:encsvc-")]
    assert alive == []
    assert emb.pipeline.service.warm
    # the service respawns its worker on the next submit
    assert len(emb.pipeline.embed_query_rows(["after the run"])) == 1
    assert emb.pipeline.service.worker_alive()
    emb.pipeline.service.close()


def test_index_takes_device_rows_beside_cached_host_rows():
    """A commit's query rows mix rows of the encoder's tensor (misses) with
    the caches' host rows (hits); the index answers them as one batch, as it
    answers the same vectors given all on the host."""
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

    rng = np.random.default_rng(3)
    docs = rng.integers(-8, 9, size=(200, 16)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(5, 16)).astype(np.float32)
    index = BruteForceKnnIndex(16, metric="ip", device="cpu")
    index.add_many([f"d{i}" for i in range(len(docs))], list(docs))
    mixed = [torch.from_numpy(q).half() if i % 2 else q for i, q in enumerate(queries)]
    host = [np.asarray(torch.from_numpy(q).half().float()) if i % 2 else q
            for i, q in enumerate(queries)]
    assert index.search_many(mixed, [4] * 5) == index.search_many(host, [4] * 5)


def test_service_under_thread_stress_keeps_rows_and_counters():
    """More submitting threads than cores, with a short switch interval: every
    client gets its own rows, the counters add up and no slot leaks."""
    import sys

    enc = _HashEncoder()
    svc = port_svc.EncoderService(enc, prewarm=False, max_in_flight=32)
    errors: list = []
    sent = [0] * 48

    def client(c: int) -> None:
        rng = np.random.default_rng(c)
        for k in range(15):
            texts = [f"c{c}k{k}r{r}" if rng.random() < 0.8 else "shared"
                     for r in range(int(rng.integers(1, 6)))]
            rows = svc.submit(texts)
            sent[c] += len(texts)
            if not all(np.array_equal(r, w) for r, w in zip(rows, _hash_rows(texts))):
                errors.append((c, k))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert svc.requests == 48 * 15 and svc.total_rows == sum(sent)
    assert svc.queue_depth_rows() == 0
    assert svc.total_rows - svc.dedup_rows == sum(len(b) for b in enc.calls)
    svc.close()


@pytest.mark.parametrize("fails", [False, True])
def test_statistics_carry_the_pipeline_counters_or_leave_them_out(fails):
    """``/v1/statistics``'s payload carries ``pipeline_stats()`` under
    ``embedder``; a stats call that raises leaves the key out and the
    commit goes on."""
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
        BruteForceKnnFactory,
        BruteForceKnnMetricKind,
    )
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    emb = _embedder(encsvc_prewarm=False)
    if fails:
        def broken():
            raise RuntimeError("stats broke")

        emb.pipeline_stats = broken
    G.clear()
    docs = pw.debug.table_from_rows(
        pw.schema_builder({"data": bytes, "_metadata": pw.Json}),
        [(b"one text", pw.Json({"path": "/a"})), (b"two texts", pw.Json({"path": "/b"}))],
    )
    store = DocumentStore(
        docs, retriever_factory=BruteForceKnnFactory(embedder=emb, metric=BruteForceKnnMetricKind.COS)
    )
    asks = pw.debug.table_from_rows(pw.schema_builder({"n": int}), [(1,)])
    got = []
    pw.io.subscribe(store.statistics_query(asks),
                    on_change=lambda key, row, time, is_addition: got.append(row["result"].value))
    GraphRunner(G).run(device="cpu")
    G.clear()
    assert got and got[-1]["file_count"] == 2
    if fails:
        assert "embedder" not in got[-1]
    else:
        assert set(got[-1]["embedder"]) == set(emb.pipeline.stats())
        assert got[-1]["embedder"]["svc_warm"] is True
    emb.pipeline.service.close()
