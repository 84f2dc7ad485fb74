"""The RAG leftovers, the port against the reference, on the CPU, with fakes
only (neither machine has the client packages):

- ``ImageParser`` / ``SlideParser`` on PIL images, as
  ``tests/test_xpack_llm.py:154-210`` runs them: outputs and the messages
  sent to the vision LLM equal the reference's;
- ``PypdfParser``, ``ParseUnstructured`` and the default slide rasterizer
  raise the reference's ``ImportError`` without their package;
- ``OpenAIEmbedder``, ``LiteLLMEmbedder`` and ``GeminiEmbedder`` over fake
  client modules give the reference's vectors, directly and through each
  package's engine; a known model's width needs no probe;
- ``SentenceTransformerEmbedder`` is a ``BaseEmbedder`` whose width needs no
  encode;
- ``SlidesDocumentStore`` retrieves what the reference's does, on
  integer-valued vectors (exact L2 scores);
- the module-level names the port's ``parsers`` and ``embedders`` define
  equal the reference's.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import io
import sys
import types

import numpy as np
import pytest

import pathway_tpu as ref_pw
import pathway_tpu_torch as pw
from pathway_tpu.debug import _capture_table as ref_capture
from pathway_tpu.xpacks.llm import embedders as ref_embedders
from pathway_tpu.xpacks.llm import parsers as ref_parsers
from pathway_tpu_torch.debug import _capture_table as capture
from pathway_tpu_torch.xpacks.llm import embedders as port_embedders
from pathway_tpu_torch.xpacks.llm import parsers as port_parsers

from .torch_parity import clear_graphs

PARSERS = (ref_parsers, port_parsers)
EMBEDDERS = (ref_embedders, port_embedders)


@pytest.fixture(autouse=True)
def _fresh_graphs():
    clear_graphs()
    yield
    clear_graphs()


def _own_names(module) -> list:
    """The names a module defines (not the ones it imports)."""
    return sorted(
        n for n in dir(module)
        if not n.startswith("__")
        and not isinstance(getattr(module, n), types.ModuleType)
        and getattr(getattr(module, n), "__module__", module.__name__) == module.__name__
    )


@pytest.mark.parametrize("pair", [PARSERS, EMBEDDERS], ids=["parsers", "embedders"])
def test_module_level_names_equal_the_references(pair):
    ref, port = pair
    assert _own_names(port) == _own_names(ref)


# -- the vision parsers -----------------------------------------------------------


def _png(size, color) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, color=color).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("size,width", [((2000, 1000), 640), ((300, 200), 1280),
                                        ((1281, 7), 1280), ((500, 400), None)])
def test_image_parser_equals_the_reference(size, width):
    """Decode, downsize, base64 and the OpenAI ``image_url`` message: the
    documents and every message equal the reference's."""
    from PIL import Image

    data = _png(size, (200, 30, 30))
    out = []
    for mod in PARSERS:
        seen = []

        def fake_vision(messages, seen=seen):
            seen.append(messages)
            return "a red rectangle"

        docs = mod.ImageParser(llm=fake_vision, downsize_horizontal_width=width).func(data)
        out.append((docs, seen))
    assert out[1] == out[0]
    docs, (messages,) = out[1]
    assert docs == [("a red rectangle", {"width": size[0], "height": size[1], "format": "png"})]
    content = messages[0]["content"]
    assert content[0] == {"type": "text", "text": port_parsers.DEFAULT_IMAGE_PARSE_PROMPT}
    url = content[1]["image_url"]["url"]
    assert url.startswith("data:image/png;base64,")
    sent = Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1])))
    if width and size[0] > width:
        assert sent.size == (width, max(1, int(size[1] * width / size[0])))
    else:
        assert sent.size == size
    # no metadata when asked
    assert port_parsers.ImageParser(llm=lambda m: "x", include_metadata=False).func(data) == [
        ("x", {})]


def test_slide_parser_equals_the_reference():
    from PIL import Image

    slides = [Image.new("RGB", (100 + 700 * (c == 20), 80), color=(0, 0, c))
              for c in (10, 20, 30)]
    out = []
    for mod in PARSERS:
        calls = []

        def fake_vision(messages, calls=calls):
            calls.append(messages)
            return f"slide #{len(calls)}"

        parser = mod.SlideParser(llm=fake_vision, downsize_horizontal_width=400,
                                 _rasterizer=lambda contents: slides)
        out.append((parser.func(b"%PDF-fake"), calls))
    assert out[1] == out[0]
    docs, calls = out[1]
    assert [d[0] for d in docs] == ["slide #1", "slide #2", "slide #3"]
    assert [d[1] for d in docs] == [{"slide": i, "slide_count": 3} for i in range(3)]
    assert len(calls) == 3


@pytest.mark.parametrize("cls", ["ImageParser", "SlideParser"])
def test_vision_parsers_require_an_llm_as_the_reference(cls):
    messages = []
    for mod in PARSERS:
        with pytest.raises(ValueError, match="vision-capable") as exc:
            getattr(mod, cls)().func(b"not-an-image")
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("build,package", [
    (lambda m: m.PypdfParser().func(b"%PDF-1.4"), "pypdf"),
    (lambda m: m.ParseUnstructured().func(b"some text"), "unstructured"),
    (lambda m: m.UnstructuredParser(mode="elements").func("text"), "unstructured"),
    (lambda m: m.SlideParser(llm=lambda msgs: "x").func(b"%PDF"), "pdf2image"),
    (lambda m: m.ImageParser(llm=lambda msgs: "x").func(b"png"), "PIL"),
])
def test_parsers_without_their_package_raise_the_references_import_error(
        build, package, monkeypatch):
    for name in (package, f"{package}.Image"):
        monkeypatch.setitem(sys.modules, name, None)  # any import of it raises
    messages = []
    for mod in PARSERS:
        with pytest.raises(ImportError) as exc:
            build(mod)
        messages.append(str(exc.value))
    if package != "PIL":  # the reference adds no message of its own for PIL
        assert messages[1] == messages[0]
        assert package.lower() in messages[1].lower()


# -- the API embedders over fake clients ----------------------------------------------


def _vec(text: str, model: str, dim: int) -> list:
    digest = hashlib.sha256(f"{model}|{text}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little")).normal(size=dim).tolist()


class _Item:
    def __init__(self, embedding):
        self.embedding = embedding

    def __getitem__(self, key):
        assert key == "embedding"
        return self.embedding


class _Response:
    def __init__(self, vectors):
        self.data = [_Item(v) for v in vectors]


def _fake_clients(monkeypatch) -> dict:
    """Fake ``openai``, ``litellm`` and ``google.generativeai`` modules in
    ``sys.modules``; ``calls`` records every request."""
    calls: list = []

    class AsyncEmbeddings:
        async def create(self, input, model, **kw):
            calls.append(("openai", tuple(input), model, tuple(sorted(kw.items()))))
            return _Response([_vec(t, model, kw.get("dimensions", 12)) for t in input])

    class AsyncOpenAI:
        def __init__(self, api_key=None):
            self.api_key = api_key
            self.embeddings = AsyncEmbeddings()
            self.closed = False

        async def close(self):
            self.closed = True

    openai = types.ModuleType("openai")
    openai.AsyncOpenAI = AsyncOpenAI

    litellm = types.ModuleType("litellm")

    async def aembedding(input, model, **kw):
        calls.append(("litellm", tuple(input), model, tuple(sorted(kw.items()))))
        return _Response([_vec(t, model, kw.get("dimensions", 10)) for t in input])

    litellm.aembedding = aembedding

    genai = types.ModuleType("google.generativeai")

    def embed_content(content, model, **kw):
        calls.append(("gemini", content, model, tuple(sorted(kw.items()))))
        return {"embedding": _vec(content, model, kw.get("output_dimensionality", 6))}

    genai.embed_content = embed_content
    try:
        import google  # noqa: F401 - a namespace package may be installed
    except ImportError:
        google = types.ModuleType("google")
        monkeypatch.setitem(sys.modules, "google", google)
    monkeypatch.setattr(sys.modules["google"], "generativeai", genai, raising=False)
    monkeypatch.setitem(sys.modules, "openai", openai)
    monkeypatch.setitem(sys.modules, "litellm", litellm)
    monkeypatch.setitem(sys.modules, "google.generativeai", genai)
    return {"calls": calls}


EMBEDDER_CASES = [
    ("OpenAIEmbedder", {"model": "custom-embedder", "api_key": "k"}),
    ("OpenAIEmbedder", {"model": "text-embedding-3-small", "dimensions": 7}),
    ("LiteLLMEmbedder", {"model": "mistral/mistral-embed"}),
    ("LiteLLMEmbedder", {"model": "openai/text-embedding-3-large", "dimensions": 5}),
    ("GeminiEmbedder", {"model": "models/custom"}),
    ("GeminiEmbedder", {"model": "models/embedding-001", "output_dimensionality": 4}),
]
TEXTS = ["the cat sat", "", "qubits entangle", "the cat sat"]


@pytest.mark.parametrize("cls,kwargs", EMBEDDER_CASES)
def test_api_embedders_give_the_references_vectors(cls, kwargs, monkeypatch):
    fakes = _fake_clients(monkeypatch)
    out = []
    for mod in EMBEDDERS:
        del fakes["calls"][:]
        emb = getattr(mod, cls)(**kwargs)
        assert isinstance(emb, mod.BaseEmbedder)

        async def embed_all(emb=emb):
            return [await emb.func(t) for t in TEXTS]

        vectors = asyncio.run(embed_all())
        out.append((vectors, emb.get_embedding_dimension(), list(fakes["calls"])))
    assert out[1] == out[0]
    vectors, dim, calls = out[1]
    assert len(vectors[0]) == dim and vectors[0] == vectors[3]
    assert calls[1][1] == (".",) or calls[1][1] == "."  # an empty text embeds "."


def _embedded(p, emb, texts: list) -> list:
    t = p.debug.table_from_rows(p.schema_builder({"text": str}), [(s,) for s in texts])
    res = t.select(t.text, vec=emb(t.text))
    rows = capture(res, device="cpu") if p is pw else ref_capture(res)
    return sorted((r["text"], [float(x) for x in r["vec"]]) for r in rows.values())


@pytest.mark.parametrize("cls,kwargs", EMBEDDER_CASES[::2])
def test_api_embedders_through_the_engine_equal_the_reference(cls, kwargs, monkeypatch):
    _fake_clients(monkeypatch)
    got = []
    for p, mod in zip((ref_pw, pw), EMBEDDERS):
        clear_graphs()
        got.append(_embedded(p, getattr(mod, cls)(capacity=2, **kwargs), TEXTS[:3]))
    assert got[1] == got[0] and len(got[1]) == 3


def test_the_openai_client_is_made_per_loop_and_the_old_one_closed(monkeypatch):
    _fake_clients(monkeypatch)
    emb = port_embedders.OpenAIEmbedder(model="m")
    asyncio.run(emb.func("a"))
    first = emb._client
    asyncio.run(emb.func("b"))
    assert emb._client is not first and first.closed


@pytest.mark.parametrize("cls,kwargs,want", [
    ("OpenAIEmbedder", {}, 1536),
    ("OpenAIEmbedder", {"model": "text-embedding-3-large"}, 3072),
    ("OpenAIEmbedder", {"model": "text-embedding-ada-002", "dimensions": 256}, 256),
    ("LiteLLMEmbedder", {"model": "openai/text-embedding-3-small"}, 1536),
    ("LiteLLMEmbedder", {"model": "gemini/text-embedding-004"}, None),
    ("GeminiEmbedder", {}, 768),
    ("GeminiEmbedder", {"model": "models/text-embedding-004"}, 768),
    ("GeminiEmbedder", {"output_dimensionality": 64}, 64),
])
def test_known_widths_skip_the_probe(cls, kwargs, want, monkeypatch):
    """A known model's width (or an explicit one) needs no client: the
    packages are unimportable here, so a probe would raise."""
    for name in ("openai", "litellm", "google.generativeai"):
        monkeypatch.setitem(sys.modules, name, None)
    dims = []
    for mod in EMBEDDERS:
        emb = getattr(mod, cls)(**kwargs)
        assert emb._dimension == want
        if want is None:
            with pytest.raises(ImportError):
                emb.get_embedding_dimension()
        else:
            dims.append(emb.get_embedding_dimension())
    assert dims == ([want, want] if want is not None else [])
    assert port_embedders._known_dim(kwargs.get("model")) == ref_embedders._known_dim(
        kwargs.get("model"))


# -- the local encoder ---------------------------------------------------------------


def test_sentence_transformer_embedder_is_a_base_embedder_whose_width_needs_no_encode():
    from pathway_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(vocab_size=4096, hidden_size=32, num_layers=1, num_heads=2,
                        intermediate_size=64, max_position=64)
    emb = port_embedders.SentenceTransformerEmbedder(
        device="cpu", encoder_config=cfg, encoder_service=False)
    assert isinstance(emb, port_embedders.BaseEmbedder)
    encodes = []
    real = emb.encoder.encode_device
    emb.encoder.encode_device = lambda *a, **k: encodes.append(a) or real(*a, **k)
    assert emb.get_embedding_dimension() == 32
    assert encodes == []
    # still the batch UDF and the query path of before
    t = pw.debug.table_from_rows(pw.schema_builder({"text": str}), [("a b",), ("c",)])
    assert type(emb(t.text)).__name__ == "BatchApplyExpression"
    assert type(emb.device_expression(t.text)).__name__ == "BatchApplyExpression"
    vecs = _embedded(pw, emb, ["a b", "c"])
    assert [len(v) for _t, v in vecs] == [32, 32]


# -- SlidesDocumentStore -------------------------------------------------------------

SLIDE_TEXTS = {(d, s): f"deck {d} slide {s} covers topic {7 * d + s}"
               for d in range(5) for s in range(3 + d % 2)}


class _StandIn:
    """A rasterized slide: ``size``, ``resize`` and ``save`` (what the
    parser reads), the slide's id in its saved bytes."""

    def __init__(self, tag: str, size=(1600, 900)):
        self.tag, self.size = tag, size

    def resize(self, size):
        return _StandIn(self.tag, size)

    def save(self, buf, format):
        buf.write(f"{self.tag}|{self.size[0]}x{self.size[1]}|{format}".encode())


def _rasterize(contents: bytes) -> list:
    deck = int(contents.decode().split("-")[1])
    return [_StandIn(f"{deck}:{s}") for s in range(3 + deck % 2)]


def _describe(messages) -> str:
    url = messages[0]["content"][1]["image_url"]["url"]
    tag, size, fmt = base64.b64decode(url.split(",", 1)[1]).decode().split("|")
    assert size == "1280x720" and fmt == "PNG"
    d, s = map(int, tag.split(":"))
    return SLIDE_TEXTS[(d, s)]


def _int_vector(text: str) -> np.ndarray:
    digest = hashlib.sha256(str(text).encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    return rng.integers(-8, 9, 16).astype(np.float32)


def _slides_store(p):
    base = pw.UDF if p is pw else ref_pw.UDF

    class IntEmbedder(base):
        def __init__(self):
            super().__init__()
            self.func = _int_vector

        def get_embedding_dimension(self, **kwargs):
            return 16

    rows = [(f"deck-{d}".encode(), p.Json({"path": f"/decks/{d}.pdf"})) for d in range(5)]
    docs = p.debug.table_from_rows(p.schema_builder({"data": bytes, "_metadata": p.Json}), rows)
    if p is pw:
        from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory, BruteForceKnnMetricKind
        from pathway_tpu_torch.xpacks.llm.document_store import SlidesDocumentStore

        kw = {"device": "cpu"}
        parsers = port_parsers
    else:
        from pathway_tpu.stdlib.indexing import BruteForceKnnFactory, BruteForceKnnMetricKind
        from pathway_tpu.xpacks.llm.document_store import SlidesDocumentStore

        kw = {}
        parsers = ref_parsers
    factory = BruteForceKnnFactory(dimensions=16, metric=BruteForceKnnMetricKind.L2SQ,
                                   embedder=IntEmbedder(), **kw)
    parser = parsers.SlideParser(llm=_describe, _rasterizer=_rasterize)
    return SlidesDocumentStore(docs, retriever_factory=factory, parser=parser)


def test_slides_document_store_retrieves_as_the_reference():
    queries = [SLIDE_TEXTS[(0, 1)], SLIDE_TEXTS[(3, 3)], SLIDE_TEXTS[(4, 0)], "unrelated words"]
    got = []
    for p in (ref_pw, pw):
        clear_graphs()
        store = _slides_store(p)
        q = p.debug.table_from_rows(p.schema_builder({"qid": int, "query": str, "k": int}),
                                    [(i, s, 3) for i, s in enumerate(queries)])
        res = store.retrieve_query(q)
        joined = q.join_left(res, q.id == res.id).select(q.qid, res.result)
        rows = capture(joined, device="cpu") if p is pw else ref_capture(joined)
        got.append({int(r["qid"]): r["result"].value for r in rows.values()})
    assert got[1] == got[0]
    for qid, (d, s) in enumerate([(0, 1), (3, 3), (4, 0)]):
        top = got[1][qid][0]
        assert top["text"] == SLIDE_TEXTS[(d, s)] and top["dist"] == 0.0
        assert top["metadata"]["slide"] == s
        assert top["metadata"]["slide_count"] == 3 + d % 2
        assert top["metadata"]["path"] == f"/decks/{d}.pdf"
    assert all(len(v) == 3 for v in got[1].values())
