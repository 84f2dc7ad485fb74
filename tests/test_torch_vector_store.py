"""Port parity over REST: the reference ``VectorStoreServer`` (its dataflow
engine, aiohttp) and the port's (``pathway_tpu_torch``: its own engine,
stdlib HTTP) serve the same document table with the same encoder weights and
``index_factory="ivf"``, and answer the same ``/v1/retrieve``,
``/v1/statistics`` and ``/v1/inputs`` requests. Both are queried through the
port's ``VectorStoreClient``.

The encoder computes in f32 here with bf16 weights and the f16 wire, so the
two stores' embeddings differ by ~5e-4 (bf16 embedding rows through the
fast-variance LayerNorm; the reference's own eager and jitted forwards differ
as much). Tolerances: retrieved texts overlap >= 0.99 (near-tie swaps
allowed, as in ``test_ivf_index.py``), ``dist`` within 1e-3. The filters
keep 3/4 of the corpus, so the over-fetched candidates always hold k
matches and a filtered answer is as well-defined as an unfiltered one."""

from __future__ import annotations

import json
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as pw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.json import Json
from pathway_tpu.models.encoder import EncoderConfig as RefConfig
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as RefEmbedder
from pathway_tpu.xpacks.llm.vector_store import VectorStoreServer as RefServer
from pathway_tpu_torch.models.encoder import EncoderConfig, params_from_jax
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer


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

_TINY = dict(vocab_size=4096, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
K = 5


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _docs(n: int = 240, seed: int = 0) -> list:
    """Topical documents: 16 topics of 24 words, each document 8-30 words,
    4/5 of them from its topic (retrieval answers come from one topic, as
    in a real corpus, instead of from a sea of near-equal random bags)."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i}" for i in range(2000)])
    topics = rng.choice(len(vocab), size=(16, 24), replace=False)

    def text(i: int) -> str:
        n_words = int(rng.integers(8, 31))
        own = vocab[topics[i % 16, rng.integers(0, 24, n_words)]]
        other = vocab[rng.integers(0, len(vocab), n_words)]
        return " ".join(np.where(rng.random(n_words) < 0.8, own, other))

    return [
        {
            "data": text(i).encode(),
            "_metadata": {
                "path": f"/data/{i % 4}/doc{i}.txt",
                "owner": "b" if i % 4 == 0 else "a",
                "modified_at": 100 + i,
                "seen_at": 1000 + i,
            },
        }
        for i in range(n)
    ]


def _requests(docs: list) -> list:
    rng = np.random.default_rng(1)
    texts = [d["data"].decode() for d in docs]
    reqs = [{"query": texts[i], "k": K} for i in range(0, 96, 4)]  # exact copies
    for i in range(1, 48, 4):  # perturbed: drop one word, swap two
        w = texts[i].split()
        del w[int(rng.integers(len(w)))]
        a, b = rng.choice(len(w), 2, replace=False)
        w[a], w[b] = w[b], w[a]
        reqs.append({"query": " ".join(w), "k": K})
    for i in range(2, 26, 4):
        reqs.append({"query": texts[i], "k": K, "metadata_filter": "owner == 'a'"})
        reqs.append({"query": texts[i + 1], "k": K, "filepath_globpattern": "/data/[123]/*"})
    return reqs


def _ask(client: VectorStoreClient, req: dict) -> list:
    extra = {k: v for k, v in req.items() if k not in ("query", "k")}
    return client.query(req["query"], k=req["k"], **extra)


def _ref_embedder() -> RefEmbedder:
    return RefEmbedder(encoder_config=RefConfig(**_TINY, dtype=jnp.float32), encoder_service=False)


def run_reference_server(port: int) -> None:
    """The reference's engine-backed server over ``_docs()``, serving until
    its process is killed: the reference's runner has no stop, and a run
    left in the test process would feed the reference's process-wide
    profiler under other test files."""
    from pathway_tpu.internals.parse_graph import G

    G.clear()
    table = pw.debug.table_from_rows(
        pw.schema_builder({"data": bytes, "_metadata": pw.Json}),
        [(d["data"], Json(d["_metadata"])) for d in _docs()],
    )
    RefServer(table, embedder=_ref_embedder(), index_factory="ivf").run_server(
        host="127.0.0.1", port=port
    )


@pytest.fixture(scope="module")
def answers():
    import os
    import subprocess

    docs = _docs()
    reqs = _requests(docs)
    # reference: engine-backed server on a free port, in a process of its own
    ref_port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_proc = subprocess.Popen(
        [sys.executable, "-c",
         "from tests.test_torch_vector_store import run_reference_server; "
         f"run_reference_server({ref_port})"],
        cwd=repo, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        ref_client = VectorStoreClient(url=f"http://127.0.0.1:{ref_port}", timeout=60)
        deadline = time.monotonic() + 120
        while True:
            try:
                _ask(ref_client, reqs[0])
                break
            except OSError:
                assert ref_proc.poll() is None, ref_proc.stderr.read().decode()[-2000:]
                assert time.monotonic() < deadline, "reference server never came up"
                time.sleep(0.3)
        ref = {
            "retrieve": [_ask(ref_client, r) for r in reqs],
            "statistics": ref_client.get_vectorstore_statistics(),
            "inputs": ref_client.get_input_files(),
        }
    finally:
        ref_proc.kill()
        ref_proc.wait(timeout=30)
        ref_proc.stderr.close()
    # port: the same weights (the reference's seeded init, made here again),
    # the same documents, a bound port of its own
    params = params_from_jax(jax.tree.map(np.asarray, _ref_embedder().encoder.params))
    embedder = SentenceTransformerEmbedder(
        device="cpu", params=params, encoder_config=EncoderConfig(**_TINY, dtype=torch.float32)
    )
    from pathway_tpu_torch.internals.parse_graph import G as PORT_G

    PORT_G.clear()
    port_table = tpw.debug.table_from_rows(
        tpw.schema_builder({"data": bytes, "_metadata": tpw.Json}),
        [(d["data"], tpw.Json(d["_metadata"])) for d in docs],
    )
    server = VectorStoreServer(port_table, embedder=embedder, index_factory="ivf")
    server.run_server(host="127.0.0.1", port=0, threaded=True)
    try:
        assert server.webserver.port != 0
        client = VectorStoreClient(url=server.webserver.url, timeout=60)
        port = {
            "retrieve": [_ask(client, r) for r in reqs],
            "statistics": client.get_vectorstore_statistics(),
            "inputs": client.get_input_files(),
        }
    finally:
        server.close()
    PORT_G.clear()
    return reqs, ref, port


def test_retrieve_texts_and_dists_match(answers):
    reqs, ref, port = answers
    overlaps = []
    for req, a, b in zip(reqs, ref["retrieve"], port["retrieve"]):
        ta = {x["text"]: x["dist"] for x in a}
        tb = {x["text"]: x["dist"] for x in b}
        assert len(b) == len(a), req
        overlaps.append(len(ta.keys() & tb.keys()) / max(len(ta), 1))
        for t in ta.keys() & tb.keys():
            assert abs(ta[t] - tb[t]) <= 1e-3, (req, t, ta[t], tb[t])
        metas = {x["text"]: x["metadata"] for x in a}
        assert all(x["metadata"] == metas[x["text"]] for x in b if x["text"] in metas)
    assert np.mean(overlaps) >= 0.99, overlaps


def test_exact_copies_come_back_first(answers):
    reqs, ref, port = answers
    for req, a, b in zip(reqs[:24], ref["retrieve"], port["retrieve"]):
        assert b[0]["text"] == a[0]["text"] == req["query"]
        assert b[0]["dist"] == pytest.approx(-1.0, abs=1e-3)


def test_filters_give_the_reference_results(answers):
    reqs, ref, port = answers
    filtered = [i for i, r in enumerate(reqs) if len(r) > 2]
    assert filtered
    overlaps = []
    for i in filtered:
        a = [x["text"] for x in ref["retrieve"][i]]
        b = [x["text"] for x in port["retrieve"][i]]
        assert len(b) == len(a) == K, reqs[i]
        overlaps.append(len(set(a) & set(b)) / K)
        if "metadata_filter" in reqs[i]:
            assert all(x["metadata"]["owner"] == "a" for x in port["retrieve"][i])
        else:
            assert all(x["metadata"]["path"][6] in "123" for x in port["retrieve"][i])
    assert np.mean(overlaps) >= 0.99, overlaps


def test_statistics_and_inputs_match(answers):
    _reqs, ref, port = answers
    for key in ("file_count", "last_modified", "last_indexed"):
        assert port["statistics"][key] == ref["statistics"][key], key
    assert port["statistics"]["file_count"] == 240

    def canon(rows: list) -> list:
        return sorted(json.dumps(r, sort_keys=True) for r in rows)

    assert canon(port["inputs"]) == canon(ref["inputs"])
