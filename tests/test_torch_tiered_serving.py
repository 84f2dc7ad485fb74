"""Port parity over REST for the int8 tiered store: with
``PATHWAY_IVF_QUANT=int8`` and a hot budget of 16 KiB (most clusters cold),
the reference ``VectorStoreServer`` (its engine, aiohttp) and the port's
serve the same document table with the same encoder weights and
``index_factory="ivf"``, both encoders in lattice mode, both indexes the
tiered int8 store; they answer the same ``/v1/retrieve`` requests through
the port's ``VectorStoreClient``. Then brownout rung 2 is forced on the
port's server: requests keep answering and make no promotion prefetch
(the reference's ``tests/test_zz_tiered_serving.py``).

Tolerances: the two encoders compute in f32 with bf16 weights and differ by
~5e-4 per component (``test_torch_vector_store.py``); the lattice rounds
each component to a step of max|v| / 127, so a component within 5e-4 of a
rounding boundary may land one step apart. Retrieved texts overlap >= 0.99
(near-tie swaps allowed) and ``dist`` agrees within 2e-3 (a few components
one step apart)."""

from __future__ import annotations

import socket
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

torch.set_num_threads(1)

_TINY = dict(vocab_size=4096, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
K = 5
KNOBS = {"PATHWAY_IVF_QUANT": "int8", "PATHWAY_IVF_HBM_BUDGET_MB": "0.016"}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _docs(n: int = 240, seed: int = 0) -> list:
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
            "_metadata": {"path": f"/data/{i % 4}/doc{i}.txt", "modified_at": 100 + i,
                          "seen_at": 1000 + i},
        }
        for i in range(n)
    ]


def _requests(docs: list) -> list:
    rng = np.random.default_rng(1)
    texts = [d["data"].decode() for d in docs]
    reqs = [texts[i] for i in range(0, 96, 4)]  # exact copies
    for i in range(1, 48, 4):  # perturbed: drop one word, swap two
        w = texts[i].split()
        del w[int(rng.integers(len(w)))]
        a, b = rng.choice(len(w), 2, replace=False)
        w[a], w[b] = w[b], w[a]
        reqs.append(" ".join(w))
    return reqs


def _ref_embedder() -> RefEmbedder:
    return RefEmbedder(encoder_config=RefConfig(**_TINY, dtype=jnp.float32), encoder_service=False)


def run_reference_server(port: int) -> None:
    """The reference's server over ``_docs()`` with ``KNOBS`` in the
    environment, serving until its process is killed: the reference's
    runner has no stop, and a run left in the test process would feed the
    reference's process-wide profiler under other test files."""
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
def served():
    import os
    import subprocess
    import sys

    from pathway_tpu_torch.engine.brownout import reset_brownout as port_reset
    from pathway_tpu_torch.engine.evaluators import ExternalIndexEvaluator
    from pathway_tpu_torch.internals.parse_graph import G as PORT_G

    port_reset()
    docs = _docs()
    reqs = _requests(docs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PATHWAY_IVF_TIERED", "PATHWAY_IVF_QUANT_ENCODE")}
    ref_port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_proc = subprocess.Popen(
        [sys.executable, "-c",
         "from tests.test_torch_tiered_serving import run_reference_server; "
         f"run_reference_server({ref_port})"],
        cwd=repo, env={**env, **KNOBS, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        ref_client = VectorStoreClient(url=f"http://127.0.0.1:{ref_port}", timeout=60)
        deadline = time.monotonic() + 120
        while True:
            try:
                ref_client.query(reqs[0], k=K)
                break
            except OSError:
                assert ref_proc.poll() is None, ref_proc.stderr.read().decode()[-2000:]
                assert time.monotonic() < deadline, "reference server never came up"
                time.sleep(0.3)
        ref = [ref_client.query(r, k=K) for r in reqs]
    finally:
        ref_proc.kill()
        ref_proc.wait(timeout=30)
        ref_proc.stderr.close()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PATHWAY_IVF_TIERED", raising=False)
        mp.delenv("PATHWAY_IVF_QUANT_ENCODE", raising=False)
        for k, v in KNOBS.items():
            mp.setenv(k, v)
        # the reference's embedder as its server built it (seeded weights, the knobs)
        ref_embedder = _ref_embedder()
        params = params_from_jax(jax.tree.map(np.asarray, ref_embedder.encoder.params))
        embedder = SentenceTransformerEmbedder(
            device="cpu", params=params, encoder_service=False,
            encoder_config=EncoderConfig(**_TINY, dtype=torch.float32),
        )
        PORT_G.clear()
        port_table = tpw.debug.table_from_rows(
            tpw.schema_builder({"data": bytes, "_metadata": tpw.Json}),
            [(d["data"], tpw.Json(d["_metadata"])) for d in docs],
        )
        server = VectorStoreServer(port_table, embedder=embedder, index_factory="ivf")
        server.run_server(host="127.0.0.1", port=0, threaded=True)
        client = VectorStoreClient(url=server.webserver.url, timeout=60)
        port = [client.query(r, k=K) for r in reqs]
    index = next(ev.index for ev in server.runner.evaluators.values()
                 if isinstance(ev, ExternalIndexEvaluator))
    try:
        yield reqs, ref, port, client, index, ref_embedder, embedder
    finally:
        index.store.close()
        server.close()
        PORT_G.clear()


def test_both_serve_from_the_tiered_int8_store(served):
    from pathway_tpu_torch.ops.knn_tiers import TieredIvfKnnStore

    _reqs, _ref, _port, _client, index, ref_embedder, embedder = served
    assert isinstance(index.store, TieredIvfKnnStore) and index.store.quant == "int8"
    assert embedder.encoder.quant_encode and ref_embedder.encoder.quant_encode
    stats = index.store.tier_stats()
    assert stats["budget_bytes"] == int(0.016 * (1 << 20))
    assert stats["hot_bytes"] <= stats["budget_bytes"]
    assert stats["probe_cold"] > 0


def test_retrieve_texts_and_dists_match_the_reference(served):
    reqs, ref, port, *_ = served
    overlaps = []
    for req, a, b in zip(reqs, ref, port):
        ta = {x["text"]: x["dist"] for x in a}
        tb = {x["text"]: x["dist"] for x in b}
        assert len(b) == len(a), req
        overlaps.append(len(ta.keys() & tb.keys()) / max(len(ta), 1))
        for t in ta.keys() & tb.keys():
            assert abs(ta[t] - tb[t]) <= 2e-3, (req, t, ta[t], tb[t])
    assert np.mean(overlaps) >= 0.99, overlaps


def test_exact_copies_come_back_first(served):
    reqs, ref, port, *_ = served
    for req, a, b in zip(reqs[:24], ref, port):
        assert b[0]["text"] == a[0]["text"] == req
        assert b[0]["dist"] == pytest.approx(-1.0, abs=1e-3)


def test_browned_out_retrieve_serves_without_promotion_churn(served):
    """Rung 2 on the port's server: answers keep coming, with n_probe
    halved, and the browned-out window makes no promotion prefetch request."""
    from pathway_tpu_torch.engine import telemetry
    from pathway_tpu_torch.engine.brownout import get_brownout, reset_brownout

    reqs, _ref, port, client, index, *_ = served
    reset_brownout()
    try:
        before = telemetry.stage_snapshot("index.").get("index.prefetch_requests", 0.0)
        for i in range(6):
            get_brownout().observe_occupancy(0.95)
            assert get_brownout().nprobe_shift() == 1
            ans = client.query(reqs[i], k=K)
            assert ans and ans[0]["text"] == reqs[i]
        after = telemetry.stage_snapshot("index.").get("index.prefetch_requests", 0.0)
        assert after == before, (before, after)
        assert index.store._effective_n_probe() == max(1, index.store.n_probe >> 1)
    finally:
        reset_brownout()
