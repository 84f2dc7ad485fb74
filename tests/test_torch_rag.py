"""The RAG top of the stack, the port against the reference, on the CPU.

Async applies (results, errors, retries with a fake clock, caches, executor
capacity, a REST route), the prompts, the question answerers with the
reference's ``FakeChat`` (copied here for the port), the rerankers (the
encoder's weights carried from the reference), ``QARestServer``'s routes and
its ``/_schema`` document on both packages, and the chat / reranker classes
whose client package the GPU machine lacks.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import random
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_table as ref_capture
from pathway_tpu.engine.columnar import Error as RefError
from pathway_tpu.internals.json import Json as RefJson
from pathway_tpu.internals.parse_graph import G as REF_G
from pathway_tpu_torch.debug import _capture_table as capture
from pathway_tpu_torch.engine.columnar import Error
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.udfs import UDF

from .mocks import FakeChat as RefFakeChat
from .mocks import FakeEmbedder as RefFakeEmbedder
from .mocks import fake_embedding


@pytest.fixture(autouse=True)
def _fresh_graphs():
    G.clear()
    REF_G.clear()
    yield
    G.clear()
    REF_G.clear()


class FakeEmbedder(UDF):
    """``tests/mocks.FakeEmbedder`` for the port."""

    def __init__(self, dim: int = 16, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
        self.func = lambda text: fake_embedding(text, self.dim)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self.dim


class FakeChat(UDF):
    """``tests/mocks.FakeChat`` for the port: echoes the last message."""

    def __init__(self, prefix: str = "ANSWER:", **kwargs):
        super().__init__(**kwargs)
        self.prefix = prefix

        def chat(messages, **kw):
            if isinstance(messages, Json):
                messages = messages.value
            content = messages if isinstance(messages, str) else messages[-1]["content"]
            return f"{self.prefix}{content[-80:]}"

        self.func = chat


def _chat(p, fn):
    """A chat UDF of package ``p`` whose function is ``fn``."""
    base = UDF if p is pw else ref_pw.UDF

    class Chat(base):
        def __init__(self):
            super().__init__()
            self.func = fn

    return Chat()


def _json_cls(p):
    return Json if p is pw else RefJson


def _last_content(p, messages) -> str:
    return (messages.value if isinstance(messages, _json_cls(p)) else messages)[-1]["content"]


def _cap(p, table, **kw):
    if p is pw:
        return capture(table, device="cpu", **kw)
    return ref_capture(table, **kw)


def _both(build) -> dict:
    """Run ``build(p)`` -> table on both packages: {package: rows sorted by
    key, without the key column (the packages' pointer classes differ)}."""
    out = {}
    for p in (ref_pw, pw):
        rows = _cap(p, build(p))
        out[p] = [{c: v for c, v in rows[k].items() if c != "__key__"} for k in sorted(rows)]
    return out


# -- async applies ------------------------------------------------------------


async def _double(x: int) -> int:
    await asyncio.sleep(0)
    return 2 * x


def test_apply_async_and_async_udfs_give_the_reference_results():
    def build(p):
        t = p.debug.table_from_rows(p.schema_builder({"x": int}), [(i,) for i in range(20)])

        @p.udf
        async def inc(x: int) -> int:
            await asyncio.sleep(0)
            return x + 1

        return t.select(t.x, a=p.apply_async(_double, t.x), b=inc(t.x))

    out = _both(build)
    assert [dict(r) for r in out[pw]] == [dict(r) for r in out[ref_pw]]
    assert sorted(r["a"] for r in out[pw]) == [2 * i for i in range(20)]
    assert type(pw.apply_async(_double, pw.this.x)).__name__ == "AsyncApplyExpression"


def _failing_table(p):
    t = p.debug.table_from_rows(p.schema_builder({"x": int}), [(i,) for i in range(8)])

    async def f(x: int) -> int:
        if x == 3:
            raise ValueError("three")
        return x * 10

    return t.select(t.x, y=p.apply_async(f, t.x))


def test_async_errors_poison_the_row_or_fail_the_run_as_the_reference():
    for p, err in ((ref_pw, RefError), (pw, Error)):
        rows = _cap(p, _failing_table(p), terminate_on_error=False)
        bad = sorted(r["x"] for r in rows.values() if isinstance(r["y"], err))
        assert bad == [3], p
        assert sorted(r["y"] for r in rows.values() if not isinstance(r["y"], err)) == [
            0, 10, 20, 40, 50, 60, 70]
        with pytest.raises(Exception, match="three"):
            _cap(p, _failing_table(p))


def test_run_coro_inside_a_running_loop_uses_a_loop_of_its_own():
    from pathway_tpu_torch.engine.expression_evaluator import _run_coro

    async def inner():
        return threading.current_thread().name, id(asyncio.get_running_loop())

    async def outer():
        here = id(asyncio.get_running_loop())
        name, loop_id = _run_coro(inner())
        return here, name, loop_id

    here, name, loop_id = asyncio.run(outer())
    assert loop_id != here and name != threading.current_thread().name
    assert _run_coro(inner())[0] == threading.current_thread().name


def test_async_udf_served_from_rest_threads():
    """A REST route whose answer is an async UDF: concurrent requests from
    client threads, each answered, and no thread left behind."""
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector

    before = {t.ident for t in threading.enumerate()}

    @pw.udf
    async def shout(q: str) -> str:
        await asyncio.sleep(0.001)
        return q.upper()

    web = PathwayWebserver("127.0.0.1", 0)
    queries, writer = rest_connector(webserver=web, route="/shout",
                                     schema=pw.schema_from_types(query=str),
                                     delete_completed_queries=True)
    writer(queries.select(result=shout(queries.query)))
    runner = GraphRunner(G)
    thread = threading.Thread(target=runner.run, kwargs={"device": "cpu"}, daemon=True)
    thread.start()
    web.wait_for_routes(["/shout"])

    def ask(i: int) -> str:
        req = urllib.request.Request(f"{web.url}/shout", data=json.dumps({"query": f"q{i}"}).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(ask, range(48)))
    finally:
        web.close()
        runner.stop()
        thread.join(30)
    assert got == [f"Q{i}" for i in range(48)]
    assert not thread.is_alive()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    assert not left, left


# -- retries, caches, capacity ------------------------------------------------


def _retry_delays(udfs, strategy_factory, monkeypatch, failures: int) -> tuple:
    delays = []

    async def fake_sleep(seconds, *a, **k):
        delays.append(seconds)

    monkeypatch.setattr(asyncio, "sleep", fake_sleep)
    calls = {"n": 0}

    async def flaky(x):
        calls["n"] += 1
        if calls["n"] <= failures:
            raise RuntimeError(f"failure {calls['n']}")
        return x + 1

    random.seed(7)
    try:
        result = asyncio.run(strategy_factory(udfs).invoke(flaky, 41))
    except RuntimeError as e:
        result = f"raised: {e}"
    monkeypatch.undo()
    return result, delays, calls["n"]


@pytest.mark.parametrize("failures", [0, 2, 3, 5])
@pytest.mark.parametrize("strategy", ["exponential", "fixed", "none"])
def test_retry_strategies_wait_as_the_reference(strategy, failures, monkeypatch):
    import pathway_tpu.internals.udfs as ref_udfs
    import pathway_tpu_torch.internals.udfs as udfs

    make = {
        "exponential": lambda m: m.ExponentialBackoffRetryStrategy(
            max_retries=3, initial_delay=100, backoff_factor=3, jitter_ms=40),
        "fixed": lambda m: m.FixedDelayRetryStrategy(max_retries=4, delay_ms=250),
        "none": lambda m: m.NoRetryStrategy(),
    }[strategy]
    got = _retry_delays(udfs, make, monkeypatch, failures)
    want = _retry_delays(ref_udfs, make, monkeypatch, failures)
    assert got == want
    if strategy == "fixed" and 0 < failures <= 4:
        assert got[1] == [0.25] * failures


def _cached_udf_run(p, cache) -> tuple:
    calls = []

    def f(x: int) -> int:
        calls.append(x)
        return x * x

    square = p.udf(f, cache_strategy=cache)
    t = p.debug.table_from_rows(p.schema_builder({"x": int}), [(i % 5,) for i in range(15)])
    rows = _cap(p, t.select(y=square(t.x)))
    return sorted(r["y"] for r in rows.values()), sorted(calls)


def test_in_memory_cache_calls_once_per_argument():
    for p in (ref_pw, pw):
        ys, calls = _cached_udf_run(p, p.udfs.InMemoryCache())
        assert ys == sorted([(i % 5) ** 2 for i in range(15)])
        assert calls == [0, 1, 2, 3, 4], p


def test_disk_cache_persists_across_instances(tmp_path):
    for p in (ref_pw, pw):
        d = tmp_path / p.__name__
        ys, calls = _cached_udf_run(p, p.udfs.DiskCache("sq", directory=str(d)))
        assert calls == [0, 1, 2, 3, 4]
        G.clear()
        REF_G.clear()
        ys2, calls2 = _cached_udf_run(p, p.udfs.DiskCache("sq", directory=str(d)))
        assert ys2 == ys and calls2 == [], p
        assert (d / "udf-cache-sq.db").exists()


def _capacity_run(p) -> tuple:
    state = {"now": 0, "max": 0}

    async def slow(x: int) -> int:
        state["now"] += 1
        state["max"] = max(state["max"], state["now"])
        await asyncio.sleep(0.002)
        state["now"] -= 1
        return -x

    udf = p.udf(slow, executor=p.udfs.async_executor(capacity=2))
    schema = p.schema_builder({"x": p.column_definition(dtype=int, primary_key=True)})
    rows = [(i, 2, 1) for i in range(8)] + [(100 + i, 4, 1) for i in range(8)]
    t = p.debug.table_from_rows(schema, rows, is_stream=True)
    out = _cap(p, t.select(t.x, y=udf(t.x)))
    return sorted(r["y"] for r in out.values()), state["max"]


def test_async_executor_capacity_holds_in_every_commit():
    """At most ``capacity`` calls in flight, in each of two commits. The
    reference keeps one semaphore across the commits' event loops, so its
    second commit that waits raises (ROADMAP: a fault of the reference)."""
    ys, most = _capacity_run(pw)
    assert ys == sorted(-x for x in [*range(8), *range(100, 108)])
    assert most == 2
    with pytest.raises(Exception, match="bound to a different event loop"):
        _capacity_run(ref_pw)


def test_executor_and_udf_names_are_exported():
    for name in ("udfs", "apply_async", "AsyncRetryStrategy", "CacheStrategy", "DiskCache",
                 "ExponentialBackoffRetryStrategy", "FixedDelayRetryStrategy",
                 "FullyAsyncExecutor", "InMemoryCache", "NoRetryStrategy", "async_executor",
                 "auto_executor", "fully_async_executor", "sync_executor"):
        assert hasattr(pw, name) and hasattr(ref_pw, name), name
    e = pw.udf(_double, executor=pw.fully_async_executor())(pw.this.x)
    assert type(e).__name__ == "FullyAsyncApplyExpression" and e._source_fun is _double
    assert pw.udfs.wrap_async(_double, capacity=1, retry_strategy=pw.NoRetryStrategy(),
                              cache_strategy=pw.InMemoryCache()) is not _double


# -- prompts ------------------------------------------------------------------


def test_prompts_are_the_reference_strings():
    from pathway_tpu.xpacks.llm import prompts as ref_prompts
    from pathway_tpu_torch.xpacks.llm import prompts

    docs = ({"text": "alpha", "metadata": {}}, "beta", {"no_text": 1})
    ref_docs = docs + (RefJson({"text": "gamma"}),)
    port_docs = docs + (Json({"text": "gamma"}),)
    cases = [
        ("prompt_qa", ("q?", None), {}),
        ("prompt_qa", ("q?", None), {"information_not_found_response": "nope",
                                     "additional_rules": "be brief"}),
        ("prompt_short_qa", ("q?", None), {"additional_rules": "x"}),
        ("prompt_citing_qa", ("q?", None), {}),
    ]
    for name, args, kw in cases:
        want = getattr(ref_prompts, name)(args[0], ref_docs, **kw)
        assert getattr(prompts, name)(args[0], port_docs, **kw) == want, name
    assert prompts.prompt_summarize(("a", 1)) == ref_prompts.prompt_summarize(("a", 1))
    assert prompts.prompt_query_rewrite("q") == ref_prompts.prompt_query_rewrite("q")
    assert prompts.rerank_prompt("d", "q") == ref_prompts.rerank_prompt("d", "q")


# -- question answering -------------------------------------------------------

_DOCS = [
    ("the cat sits on the mat", "/data/cats.txt", 10),
    ("dogs chase the ball in the park", "/data/dogs.txt", 20),
    ("quantum computing uses qubits", "/data/qc.txt", 30),
    ("a cat and a dog share the garden", "/data/pets.txt", 40),
    ("tea is brewed from leaves", "/data/tea.txt", 50),
]


def _store(p):
    json_cls = Json if p is pw else RefJson
    rows = [(t.encode(), json_cls({"path": path, "modified_at": m, "seen_at": m + 1}))
            for t, path, m in _DOCS]
    docs = p.debug.table_from_rows(p.schema_builder({"data": bytes, "_metadata": p.Json}), rows)
    if p is pw:
        from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory, BruteForceKnnMetricKind
        from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

        factory = BruteForceKnnFactory(dimensions=16, metric=BruteForceKnnMetricKind.COS,
                                       embedder=FakeEmbedder(), device="cpu")
    else:
        from pathway_tpu.stdlib.indexing import BruteForceKnnFactory, BruteForceKnnMetricKind
        from pathway_tpu.xpacks.llm.document_store import DocumentStore

        factory = BruteForceKnnFactory(dimensions=16, metric=BruteForceKnnMetricKind.COS,
                                       embedder=RefFakeEmbedder())
    return DocumentStore(docs, retriever_factory=factory)


def _qa_module(p):
    if p is pw:
        from pathway_tpu_torch.xpacks.llm import question_answering
    else:
        from pathway_tpu.xpacks.llm import question_answering
    return question_answering


def _same_docs(got: list, want: list) -> None:
    assert [d["text"] for d in got] == [d["text"] for d in want]
    assert [d["metadata"] for d in got] == [d["metadata"] for d in want]
    np.testing.assert_allclose([d["dist"] for d in got], [d["dist"] for d in want], atol=1e-6)


_QUESTIONS = [("what does the cat do?", True), ("who chases the ball?", False),
              ("tell me about qubits", True)]


def test_base_rag_answers_equal_the_reference():
    def build(p):
        qa = _qa_module(p).BaseRAGQuestionAnswerer(
            (FakeChat if p is pw else RefFakeChat)(), _store(p), search_topk=2)
        q = p.debug.table_from_rows(
            p.schema_builder({"prompt": str, "filters": str, "return_context_docs": bool}),
            [(s, None, ctx) for s, ctx in _QUESTIONS])
        return qa.answer_query(q)

    out = _both(build)
    for got, want in zip(out[pw], out[ref_pw]):
        g, w = got["result"].value, want["result"].value
        assert g["response"] == w["response"] and g["response"].startswith("ANSWER:")
        assert ("context_docs" in g) == ("context_docs" in w)
        if "context_docs" in w:
            _same_docs(g["context_docs"], w["context_docs"])
            assert len(g["context_docs"]) == 2


def test_per_query_model_override_and_summaries_equal_the_reference():
    def build(p):
        chat = _chat(p, lambda messages, model=None, **kw: f"model={model}")
        qa = _qa_module(p).BaseRAGQuestionAnswerer(chat, _store(p), default_llm_name="base")
        q = p.debug.table_from_rows(
            p.schema_builder({"prompt": str, "model": str}),
            [("cat?", None), ("dog?", "big"), ("tea?", "small")])
        return qa.answer_query(q)

    out = _both(build)
    assert [r["result"].value for r in out[pw]] == [r["result"].value for r in out[ref_pw]]
    assert sorted(r["result"].value["response"] for r in out[pw]) == [
        "model=base", "model=big", "model=small"]

    def summarize(p):
        qa = _qa_module(p).BaseRAGQuestionAnswerer(
            (FakeChat if p is pw else RefFakeChat)(), _store(p))
        q = p.debug.table_from_rows(p.schema_builder({"text_list": p.Json}),
                                    [((Json if p is pw else RefJson)(["one", "two"]),)])
        return qa.summarize_query(q)

    out = _both(summarize)
    assert [r["result"] for r in out[pw]] == [r["result"] for r in out[ref_pw]]


def _picky(p, word: str):
    """A chat that says it has no information until its sources hold ``word``."""

    def chat(messages, **kw):
        sources = _last_content(p, messages).split("Sources:")[1].split("Question:")[0]
        n = len([x for x in sources.split("\n\n") if x.strip()])
        return f"found with {n}" if word in sources else "No information"

    return _chat(p, chat)


@pytest.mark.parametrize("word", ["qubits", "leaves", "garden", "nowhere"])
def test_adaptive_rag_grows_the_context_as_the_reference(word):
    def build(p):
        qa = _qa_module(p).AdaptiveRAGQuestionAnswerer(
            _picky(p, word), _store(p), n_starting_documents=1, factor=2, max_iterations=3)
        q = p.debug.table_from_rows(p.schema_builder({"prompt": str}),
                                    [("what does the cat do?",), ("about tea",)])
        return qa.answer_query(q)

    out = _both(build)
    assert [r["result"] for r in out[pw]] == [r["result"] for r in out[ref_pw]]
    if word == "nowhere":
        assert all(r["result"] == "No information" for r in out[pw])


def test_deck_retriever_and_format_answer():
    from pathway_tpu.xpacks.llm.question_answering import _format_answer as ref_format
    from pathway_tpu_torch.xpacks.llm.question_answering import DeckRetriever, _format_answer

    with pytest.raises(NotImplementedError):
        DeckRetriever()
    assert _format_answer("a", ({"t": 1},), True).value == ref_format("a", ({"t": 1},), True).value
    assert _format_answer("a", (), False).value == {"response": "a"}


# -- rerankers ----------------------------------------------------------------


@pytest.fixture(scope="module")
def rerankers():
    import jax

    from pathway_tpu.xpacks.llm.rerankers import EncoderReranker as RefReranker
    from pathway_tpu_torch.models.encoder import params_from_jax
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    ref = RefReranker()
    params = params_from_jax(jax.tree.map(np.asarray, ref.encoder.params))
    return ref, EncoderReranker(params=params, device="cpu")


_PAIRS = [
    ("the cat sits on the mat", "where is the cat"),
    ("dogs chase the ball in the park", "where is the cat"),
    ("quantum computing uses qubits", "what are qubits"),
    ("tea is brewed from leaves", "what are qubits"),
    ("a cat and a dog share the garden", "pets in the garden"),
    ("the cat sits on the mat", "pets in the garden"),
]


def test_encoder_reranker_scores_with_the_reference_weights(rerankers):
    ref, port = rerankers

    def build(p, rr):
        t = p.debug.table_from_rows(p.schema_builder({"i": int, "doc": str, "query": str}),
                                    [(i, d, q) for i, (d, q) in enumerate(_PAIRS)])
        return t.select(t.i, score=rr(t.doc, t.query))

    want = {r["i"]: r["score"] for r in ref_capture(build(ref_pw, ref)).values()}
    got = {r["i"]: r["score"] for r in capture(build(pw, port), device="cpu").values()}
    assert got.keys() == want.keys()
    # the bf16 encoders agree to cosine >= 0.999 per row (ROADMAP); on these
    # pairs the dots differ by at most 3.6e-4
    np.testing.assert_allclose([got[i] for i in sorted(got)], [want[i] for i in sorted(want)],
                               atol=2e-3)
    assert np.argsort([got[i] for i in range(6)]).tolist()[-1] == np.argsort(
        [want[i] for i in range(6)]).tolist()[-1]
    # one batch call equals the per-pair function the reference applies
    batch = port.score_batch([d for d, _ in _PAIRS], [q for _, q in _PAIRS])
    np.testing.assert_allclose(batch, [port.func(d, q) for d, q in _PAIRS], atol=1e-6)


def _rerankers_module(p):
    if p is pw:
        from pathway_tpu_torch.xpacks.llm import rerankers
    else:
        from pathway_tpu.xpacks.llm import rerankers
    return rerankers


def test_rerank_topk_filter_and_llm_reranker_equal_the_reference():
    def rater(p):
        def chat(messages, **kw):
            doc = _last_content(p, messages).split("Document: ")[1]
            return f"Rating: {1 + len(doc) % 5}" if "tea" not in doc else "unsure"

        return _chat(p, chat)

    def build(p):
        rr = _rerankers_module(p)
        t = p.debug.table_from_rows(p.schema_builder({"i": int, "doc": str, "query": str}),
                                    [(i, d, q) for i, (d, q) in enumerate(_PAIRS)])
        scored = t.select(t.i, t.doc, score=rr.LLMReranker(rater(p))(t.doc, t.query))
        grouped = scored.reduce(docs=p.reducers.tuple(scored.doc, sort_by=scored.i),
                                scores=p.reducers.tuple(scored.score, sort_by=scored.i))
        return grouped.select(top=rr.rerank_topk_filter(grouped.docs, grouped.scores, k=3))

    out = _both(build)
    assert [r["top"] for r in out[pw]] == [r["top"] for r in out[ref_pw]]
    assert len(out[pw][0]["top"][0]) == 3


def test_chats_and_rerankers_without_their_package_raise_as_the_reference(monkeypatch):
    from pathway_tpu.xpacks.llm import llms as ref_llms
    from pathway_tpu.xpacks.llm import rerankers as ref_rr
    from pathway_tpu_torch.xpacks.llm import llms, rerankers

    msgs = [{"role": "user", "content": "hi"}]
    for name, missing in (("OpenAIChat", "openai client library is not installed"),
                          ("LiteLLMChat", "litellm is not installed"),
                          ("CohereChat", "cohere client library is not installed")):
        for mod in (ref_llms, llms):
            monkeypatch.setitem(sys.modules, {"OpenAIChat": "openai", "LiteLLMChat": "litellm",
                                              "CohereChat": "cohere"}[name], None)
            chat = getattr(mod, name)(capacity=2)  # built without the package
            with pytest.raises(ImportError, match=missing):
                asyncio.run(chat.func(msgs))
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    for mod in (ref_llms, llms):
        with pytest.raises(ImportError):
            mod.HFPipelineChat(model="any")
    for mod in (ref_rr, rerankers):
        with pytest.raises(ImportError):
            mod.CrossEncoderReranker("any")
    assert llms.prompt_chat_single_qa("q?").value == ref_llms.prompt_chat_single_qa("q?").value
    assert llms._coerce_messages("x") == ref_llms._coerce_messages("x")
    assert llms._coerce_messages(Json(msgs)) == ref_llms._coerce_messages(RefJson(msgs))


# -- QARestServer over REST, both packages -------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _post(url: str, route: str, payload: dict):
    req = urllib.request.Request(url + route, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(url: str, route: str):
    with urllib.request.urlopen(url + route, timeout=60) as resp:
        return json.loads(resp.read())


_REQUESTS = [
    ("/v2/answer", {"prompt": "what does the cat do?", "return_context_docs": True}),
    ("/v2/answer", {"prompt": "who chases the ball?"}),
    ("/v1/pw_ai_answer", {"prompt": "tell me about qubits", "return_context_docs": True}),
    ("/v1/retrieve", {"query": "cat on a mat", "k": 2}),
    ("/v1/retrieve", {"query": "tea", "k": 4, "filepath_globpattern": "**/t*"}),
    ("/v2/list_documents", {}),
    ("/v1/statistics", {}),
]


def _qa(p):
    return _qa_module(p).BaseRAGQuestionAnswerer(
        (FakeChat if p is pw else RefFakeChat)(), _store(p), search_topk=3)


def run_reference_server(port: int) -> None:
    """The reference's ``QARestServer`` over the same documents, serving
    until its process is killed (the reference's runner has no stop, and a
    run left in this process would feed the reference's process-wide
    profiler under other test files)."""
    from pathway_tpu.xpacks.llm.servers import QARestServer as RefServer

    RefServer("127.0.0.1", port, _qa(ref_pw)).run()


def _ask_all(url: str) -> dict:
    return {"answers": [_post(url, route, payload) for route, payload in _REQUESTS],
            "schema": _get(url, "/_schema")}


@pytest.fixture(scope="module")
def served():
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_port = _free_port()
    ref_proc = subprocess.Popen(
        [sys.executable, "-c",
         f"from tests.test_torch_rag import run_reference_server; run_reference_server({ref_port})"],
        cwd=repo, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    G.clear()
    from pathway_tpu_torch.xpacks.llm.servers import QARestServer

    server = QARestServer("127.0.0.1", 0, _qa(pw))
    try:
        server.run(threaded=True, device="cpu")
        port_out = {**_ask_all(f"http://127.0.0.1:{server.webserver.port}"),
                    "port": server.webserver.port}
        url = f"http://127.0.0.1:{ref_port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                _post(url, "/v1/statistics", {})
                break
            except OSError:
                assert ref_proc.poll() is None, ref_proc.stderr.read().decode()[-2000:]
                assert time.monotonic() < deadline, "reference server never came up"
                time.sleep(0.3)
        ref_out = {**_ask_all(url), "port": ref_port}
    finally:
        server.close()
        G.clear()
        ref_proc.kill()
        ref_proc.wait(timeout=30)
        ref_proc.stderr.close()
    return {ref_pw: ref_out, pw: port_out}


def test_qa_rest_server_routes_answer_as_the_reference(served):
    got, want = served[pw]["answers"], served[ref_pw]["answers"]
    for (route, payload), g, w in zip(_REQUESTS, got, want):
        if route in ("/v2/answer", "/v1/pw_ai_answer"):
            assert g["response"] == w["response"], payload
            assert ("context_docs" in g) == ("context_docs" in w)
            if "context_docs" in w:
                _same_docs(g["context_docs"], w["context_docs"])
        elif route == "/v1/retrieve":
            _same_docs(g, w)
            assert g, payload
        elif route == "/v2/list_documents":
            canon = lambda rows: sorted(json.dumps(r, sort_keys=True) for r in rows)  # noqa: E731
            assert canon(g) == canon(w) and len(g) == len(_DOCS)
        else:
            for key in ("file_count", "last_modified", "last_indexed"):
                assert g[key] == w[key], key
            assert g["file_count"] == len(_DOCS)


def test_openapi_schema_equals_the_reference(served):
    got, want = served[pw]["schema"], served[ref_pw]["schema"]
    assert got["servers"] == [{"url": f"http://127.0.0.1:{served[pw]['port']}"}]
    assert want["servers"] == [{"url": f"http://127.0.0.1:{served[ref_pw]['port']}"}]
    assert {k: v for k, v in got.items() if k != "servers"} == {
        k: v for k, v in want.items() if k != "servers"}
    assert sorted(got["paths"]) == ["/v1/pw_ai_answer", "/v1/retrieve", "/v1/statistics",
                                    "/v2/answer", "/v2/list_documents"]


def test_endpoint_documentation_generates_the_reference_entries():
    from pathway_tpu.io.http._server import EndpointDocumentation as RefDoc
    from pathway_tpu.xpacks.llm.question_answering import BaseRAGQuestionAnswerer as RefQA
    from pathway_tpu_torch.io.http import EndpointDocumentation
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

    kw = dict(summary="Answer", description="Ask", tags=["rag"], method_types=["POST"])
    for method in ("GET", "POST"):
        for name in ("AnswerQuerySchema", "RetrieveQuerySchema", "InputsQuerySchema"):
            got = EndpointDocumentation(**kw).generate_docs(
                method, getattr(BaseRAGQuestionAnswerer, name))
            want = RefDoc(**kw).generate_docs(method, getattr(RefQA, name))
            assert got == want, (method, name)
            got = EndpointDocumentation().generate_docs(
                method, getattr(BaseRAGQuestionAnswerer, name))
            assert got == RefDoc().generate_docs(method, getattr(RefQA, name))
    from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector

    web = PathwayWebserver("127.0.0.1", 0)
    try:
        with pytest.raises(ValueError, match="collides"):
            rest_connector(webserver=web, route="/_schema", methods=("GET",))
    finally:
        web.close()
