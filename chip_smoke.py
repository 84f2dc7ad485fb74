#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--chunks 393216] [--untiered-chunks 196608] [--requests 256]
                          [--concurrent 2048] [--clients 32] [--report PATH] [--kernels-only]
                          [--config4-only] [--rag-only] [--ops-only] [--persist-only]
                          [--chaos-only]

Drives ``pathway_tpu_torch`` only (no JAX) through these phases; any failure
exits non-zero and prints no result line.

1. Device: the card's name and ``nvidia-smi`` name / power limit. No CUDA → exit 2.
2. Build: the native host module (``csrc/pathway_native.cc``, g++; the
   run fails without it), then every CUDA kernel of the path, from
   ``pathway_tpu_torch/csrc``, with the registers, shared memory and spills
   ``ptxas`` reports.
3. Kernel vs plain version: the IVF page scorer against its plain PyTorch
   version for l2sq / cos / ip over f32 and bf16 pages, on random page ids,
   on duplicate-heavy ones (three pages in every slot, one of them the
   all-pad sentinel) and on 64 queries — an integer corpus
   must score identically, a float corpus within 1e-5 of the dot's scale
   |q|^2 + |p|^2 (1 for cos): the same f32 products summed in another order.
4. The slice, through the port's dataflow engine, with the encoder
   service on (the default query path: content cache → semantic cache →
   coalescer shim → continuously-batched service replaying one CUDA graph
   per pow2 bucket). Pre-warm first: ``wait_warm()``, the graphs captured,
   the card memory their pool holds, and every bucket's replay against its
   eager forward (cosine ≥ 0.99999 per row; bitwise equality reported).
   Then a ``ConnectorSubject``
   streams the first ``--untiered-chunks`` seeded documents (16-96 words, keyed by ``path``)
   through ``pw.io.python.read`` in commits of BATCH rows into
   ``VectorStoreServer`` (full MiniLM-L6 width, seeded weights,
   ``index_factory="ivf"``), served by ``rest_connector`` on localhost;
   ``pw.run`` drives the commits. Ingest ends when ``/v1/statistics`` counts
   every document (docs/s, median commit, host seconds of key derivation,
   parse/split, embed and the index). ``--requests`` ``/v1/retrieve`` requests
   follow (p50 / p99; the first one, which trains the IVF index, timed
   apart): exact copies come back first with dist ≈ -1, filters and globs do
   not leak, the kernel's launch count rose, the plain scorer on the card
   gives the same top-10 on the first 16 requests, the served answers equal
   a re-run, recall@10 against exact search over every request is printed.
   Then the live wave, one commit: WAVE documents removed, WAVE replaced by
   new texts under their keys, WAVE added. Freshness (push → an exact copy of
   a new document served first) and the first retrieve after the commit
   (it rebuilds the IVF layout) are timed; no removed or replaced text may be
   served again, every replaced key's new text comes back first, and
   ``/v1/statistics`` and ``/v1/inputs`` count the new set. The page scorer
   is held against its plain version, within the tolerance of phase 3, and
   timed at two shapes of the main path, each with its own bound: a batch of
   8 real queries, and one served request (1 query padded with 7 zero rows).
   Before the live wave, three serving phases: ``--clients`` threads send
   ``--concurrent`` distinct ``/v1/retrieve`` requests (requests/s, p50 /
   p99, service ticks and rows per tick, dedup rows, sheds, which must be
   0, the full garbage collections that started during it, the highest
   brownout level), each answer's top-10 held against the
   solo answer to its query (mean overlap ≥ 0.99); 64 of them re-sent as
   whitespace / case variants must hit the semantic cache with no forward
   and get the original's answer bitwise; brownout rung 2, forced, answers
   16 requests with ``n_probe`` halved (equal to the halved search of the
   same rows, the scorer held against its plain version there), and after
   the reset the answers are the rung-0 answers again.
   The metrics plane, on the same run (profiling on, as by default): the
   server runs with ``with_http_server=True`` on a free port, and
   ``/metrics`` is scraped after ingest, after the solo phase and after the
   concurrent phase (wall ms, bytes). Each scrape must pass the strict
   OpenMetrics grammar and hold ``commits_total``, the commit-duration
   histogram, a ``pathway_operator_seconds`` series for every operator of
   the graph and ``pathway_rest_latency_seconds`` with its ``_count`` equal
   to the requests answered so far, and from the solo phase on the three
   ``pathway_encsvc_*`` histograms; ``/v1/statistics``' ``engine`` key, read
   just before, must agree with it (commits, every top operator). After
   ingest and after the concurrent phase the operators are printed by
   seconds (calls, rows, ms per commit, us per row, ms per request), with
   the plane's own host us per commit on this graph; rung 2 must leave a
   ``brownout`` flight event; ingest docs/s and solo p50 are printed beside
   run S4's; the live wave's commit comes from its commit profile; a flight
   dump into a temporary directory ends the phase with its summary line.
5. The tiered int8 store (``smoke-1M-ivf-int8-tiered``, cut to ``--chunks``
   393,216 so that the smoke stays within half of its limit): the same corpus
   through a second ``VectorStoreServer(index_factory="ivf")`` built with
   ``PATHWAY_IVF_QUANT=int8``, ``PATHWAY_IVF_HBM_BUDGET_MB=128``,
   ``PATHWAY_IVF_RESCORE_K=64`` and prefetch on (the encoder in lattice
   mode): ingest, solo and concurrent retrieve, the tier census (hot bytes
   within the budget), recall@10 against exact search over the same
   lattice-rounded rows, rung 2 issuing no promotion prefetch, the live
   wave; the tiered searches' copies of query data to the card (one per
   search); each kernel of ``csrc/score_blocks.cu`` (the int8 and fp32
   block scorers, the int8 probe) against its plain version and timed at
   the path's shapes (the int8 scorer at an 8-query batch, one request and
   the concurrent phase's largest batch, the fp32 scorer at an 8-query
   batch and one request; each block scorer's wrapper split into checks,
   work list, copy, output fill and launch; the probe on the served table
   at 1, 8 and 32 queries and on a seeded table of 3,000 centroids, with
   the probe step's host time split by part), every kernel also by CUDA
   graph replay (the device alone) beside the launch floor, the empty
   kernel ``pw_empty`` through the same ctypes path; the same bits at two
   block capacities and two batch positions; residency invariance: 64 queries
   through an all-hot store and a 128 MiB store with a spill directory
   (every other served row, the served centroids), int8 and fp32, bitwise
   equal. The metrics plane as in phase 4, with the tiered store's
   histograms: tier hit and occupancy ratios and rescore depth from the
   solo phase on, the recall ratio after ``quant_recall_audit`` on the
   served queries, and the prefetch stall (a spilled cluster's load, which
   only the residency check's spill directory gives) in a last scrape.
6. BASELINE config 1: 10,000 x 128 seeded float32 vectors and 1,000 queries
   written as two CSV files, read by ``pw.io.csv.read(mode="static")``
   (the native parse, its rows/s beside ``csv.DictReader``'s), ``vec``
   parsed to arrays, ``KNNIndex(docs.vec, docs, n_dimensions=128)`` (exact,
   euclidean, then cosine) on the card, ``get_nearest_items(k=10,
   with_distances=True)``, ``pw.run``; every query's ids and distances
   against an exact float64 brute force (the same ids except near-tie
   swaps, distances within rtol 1e-5); ``pw.run`` seconds, the index
   operator's, and the index alone (build; the 1,000 queries as one batch).
   Then the ``native:`` line: the native host module's library, build
   seconds, compiler and ``Python.h``, the key-index and multimap classes
   the served phases' operators held (only the native tables: phase 2
   fails without the library), and key derivation per million keys through
   the native and the numpy paths.
7. BASELINE config 4, a streaming index with a tumbling window. Part A is
   the reference's own config-4 window (``bench.py`` ``bench_streaming_window``)
   at its size: 200,000 seeded rows (64 sensors, 20 commits, ``t`` in
   [100c, 100c + 100), ``value = t % 7``) through
   ``table_from_rows(is_stream=True)`` → ``windowby(t, tumbling(50),
   instance=sensor)`` → ``reduce(sum, count)`` → ``pw.io.subscribe``; the
   final windows must equal a numpy groupby exactly (rows/s, window
   updates). Part B: 32,768 chunks of the corpus (``source`` 0-63, an event
   time ``t``) written as 16 jsonlines files of 2,048 rows and dropped one by
   one into a directory that ``pw.io.jsonlines.read(mode="streaming")``
   polls (the stand-in for Kafka; each file is one commit), embedded by
   ``SentenceTransformerEmbedder`` (full width) into
   ``KNNIndex(..., cosine, exact=False, approximate="ivf")`` on the card,
   and beside it ``windowby(t, tumbling(100), instance=source,
   common_behavior(delay=100, cutoff=50, keep_results=True))``. File c
   holds 64 rows one window late and 64 two windows late, written first:
   every window whose threshold passed must hold the numpy groupby's ``n``
   and ``t_max`` over all on-time rows and the one-window-late rows, none of
   the two-back rows. After the last file, 64 queries through
   ``get_nearest_items_asof_now(k=10)``: the served top-10 against a
   kernel re-run and the plain scorer on the same store (overlap ≥ 0.99),
   recall@10 against exact search, the page scorer's launches on this path
   (must be > 0). Docs/s, the window-close latency per file (file written →
   the last of its 64 closed windows delivered; p50, max, beside the
   poller's 0.5 s), the neu-phase commits and their operator seconds. The
   streaming read never ends: the run is stopped (``GraphRunner.stop``), so
   the last file's windows never flush; the line says so.
8. The RAG server (``rag-hybrid-65k``, cut to 32,768 chunks so that the
   smoke stays within half of its limit): the first 32,768 chunks of the
   corpus through a python connector (commits of 16,384) into a
   ``DocumentStore`` over ``HybridIndexFactory([IvfKnnFactory(embedder,
   COS), TantivyBM25Factory()], k=60)``, behind
   ``AdaptiveRAGQuestionAnswerer(n_starting_documents=2, factor=2,
   max_iterations=4)`` with a deterministic chat (the path of the first
   context document holding the question's marker word, else "No
   information") and ``QARestServer``. 256 sequential ``/v2/answer``, 1,024
   from 32 clients (none may be shed), 64 ``/v1/retrieve`` (k=16) and one
   ``/_schema``. Checks: every ``/v1/retrieve`` ranking equals the
   reciprocal-rank fusion, recomputed here, of its IVF and BM25 lists (the
   first 16 also with the plain scorer's IVF list), every ``/v2/answer``
   equals the chat's answer over the documents its index instance retrieves
   for it; ``score_pages`` held against its plain version at an 8-question
   batch. Printed: ingest docs/s, answer p50 / p99 (and requests/s under 32
   clients), the adaptive rounds, the index operator's split between IVF
   and BM25 and the async apply's share, full collections, ``score_pages``
   launches on this path. Then the 64 x 16 retrieved pairs through
   ``EncoderReranker`` and ``rerank_topk_filter(k=5)``: scores within 1e-3
   of ``np.dot`` of the encoder's batch embeddings, the same top 5 bar near
   ties.
9. The engine's remaining operators and the stdlib on them (``ops-stdlib``,
   ``pw.run`` on the card each time). Part A: ``pagerank(steps=5)`` on a
   seeded power-law graph (8,192 vertices, 65,536 edges) must equal a
   numpy replay of its integer formulation exactly; ``bellman_ford`` from 16
   sources on the same graph (integer weights 1-16) must equal scipy's
   Dijkstra exactly; ``louvain_communities`` on a 2,048-vertex planted
   partition: ``exact_modularity`` equal to numpy's modularity of the
   returned clustering within 1e-12 and at least the planted partition's
   minus 0.05. Part B: 16 commits of 4,096 events (4,096 Zipf-skewed
   sensors, timestamps out of order within blocks of 64, float32 values, 10%
   None) through a python connector → ``pw.stateful.deduplicate`` (value
   moved by > 0.5), ``pw.ordered.diff`` per sensor, ``pw.statistical.
   interpolate`` (one sensor's events), ``groupby(sensor).reduce(avg,
   argmax, unique, any, count, ndarray)``, ``update_cells`` of 64 late
   corrections, a filter whose predicate raises on some rows and a
   ``remove_errors`` after a raising column, with ``global_error_log``:
   every output equals a numpy replay of the same commits (``avg`` within
   rtol 1e-6), the log holds one row per failing row; events/s and the
   segment sums that ran on the card. Part C: 16,384 chunks, then 4,096
   re-deliveries under the same path (half a new text and a higher
   version, the rest the same or an older version) →
   ``pw.stateful.deduplicate(instance=path, value=version, acceptor=new >
   old)`` → the encoder → ``KNNIndex(ivf, cosine)``, then 64 as-of-now
   queries with the exact text of latest versions: every top hit is that
   latest version and every list equals the plain scorer's over the
   deduplicated rows bar near ties (deliveries/s, ``score_pages``
   launches). Part D: ``pw.sql`` (a JOIN with an 8-category metadata
   table, a JOIN with a GROUP BY / HAVING subquery, a WHERE) picks documents
   of 32,768 seeded f32 vectors of 384 dims (no encoder) for
   ``KNNIndex(ivf, cosine)`` with every cluster probed: the selection must
   equal a numpy replay and the top-10 of 64 queries a float64 brute force
   over it bar near ties (``score_pages`` launches); a ``@pw.transformer``
   list traversal over 4,096 nodes and 4,096 requests runs two commits, the
   second re-pointing 64 nodes: each commit's rows equal a replay and the
   second emits only the requests whose value changed; a failing UDF raises
   ``EngineErrorWithTrace`` naming this file and line. Part E: part C's
   16,384 chunks through a python connector in 16 explicit commits of
   1,024, then a 17th removing 512 rows of the first four, into a
   ``pw.AsyncTransformer`` (``instance`` the chunk's topic; ``invoke``
   awaits 2 ms, the stand-in for an API call, and returns the cleaned text
   and the topic; ``capacity=128``, two retries; a seeded 1/128 of the rows
   fail on every attempt, another 1/64 on the first only) whose
   ``successful`` table feeds the encoder and ``KNNIndex(ivf, cosine)``:
   ``successful`` / ``failed`` must equal a replay that fails each (topic,
   commit) group holding an always-failing row, 64 as-of-now queries with
   the text of successful chunks must find their chunk first (cosine ≥
   0.999), 16 with the text of failed or removed chunks must not find it,
   the subscriber below the transformer must hear the end after the last
   invocation, and the run must end by itself (seconds, rows/s through the
   transformer, invocations in flight at peak, ``score_pages`` launches).
   The query path does not wait for the encoder's pre-warm. PyYAML's
   presence is printed.
10. Persistence, a crash and a resume of the ingest (``persist-resume-16k``):
   the first 16,384 chunks as 16 jsonlines files of 1,024 under a directory
   that ``pw.io.jsonlines.read(mode="streaming")`` polls → the encoder (full
   width, seeded) → ``KNNIndex(ivf, cosine)`` with 2 clusters, both probed.
   Run 1, in a child process (this script with ``--persist-child``) with
   ``persistence_config`` on a filesystem store, starts with files 1-8 and is
   killed with SIGKILL once the journal holds 4 whole files and before it
   holds all 8. While it is down, files 9-16 come, file 3 is rewritten (new
   texts under new ids) and file 5 is deleted. Run 0, here, without
   persistence, ingests the final 15 files; Run 2, here, resumes on Run 1's
   store: the journal replays through the encoder and the index, and the
   scanner reads only what the journal lacks or what changed. Checks: the
   index and the sink hold exactly the 15,360 final chunks, none twice, and
   the sink equals Run 0's; Run 2 read from disk exactly files 9-16, the new
   file 3 and the files the kill cut short; 64 as-of-now queries with exact
   chunk texts get that chunk first (cosine ≥ 0.9999) and top-10 sets equal
   to Run 0's bar near ties (1e-5 cosine); 16 queries with texts of deleted
   chunks never get them; ``score_pages`` launched on Run 2's path. Printed:
   Run 1's and Run 0's docs/s, the journal's bytes per chunk and
   ``record_commit`` ms per commit, Run 2's replay seconds and rows, its time
   to the first answered query, the phase's seconds.
11. Fault injection (``chaos-16k``): seeded chaos plans
   (``PATHWAY_CHAOS_PLAN``, ``internals/chaos.py``). Part A, here: a
   ``TieredIvfKnnStore`` (int8, d = 384, 65,536 seeded rows in 64 clusters,
   an HBM budget of half its int8 payload) under the ``quant`` plan: half
   the rows removed, maintenance on every cluster, every recalibration
   aborted (``quant_chaos_aborts`` >= 1, no recalibration), 64 queries' top-10
   equal to a float64 brute force over the live rows bar near ties (1e-5);
   the plan lifted, maintenance recalibrates and the answers stay exact.
   Then ``tier_swap_torn`` with ``PATHWAY_IVF_REBUILD_DRIFT=0.1``: rebuild
   attempt 0 is torn (generation 0, exact answers), the next swaps
   (generation 1, exact answers). Part B: phase 10's ingest with a splitter
   and the tiered int8 index (``PATHWAY_IVF_QUANT=int8``), 4,096 chunks in 8
   files, in a child under the plan ``{"kill": [{"rank": 0, "commit": 6,
   "run": 0}]}``: the child dies with SIGKILL at commit 6 (return code -9,
   ``chaos_kill`` with commit 6 in its flight-recorder dump, the journal's
   last commit below 6, 2-7 files journaled); Run 2, here, with
   ``PATHWAY_RESTART_COUNT=1`` and the same plan, resumes: 4,096 chunks in
   the index and the sink, none twice, 64 exact chunk texts first (cosine >=
   0.9999), the int8 kernels launched. Part A runs while the child runs.
   Part C, here: ``SlidesDocumentStore`` over the encoder and an untiered
   IVF index, parsed by ``SlideParser`` with a fake vision LLM and a fake
   rasterizer (stand-in images), 256 decks of 8 slides; 16 exact slide texts
   get their slide first with ``slide`` / ``slide_count``;
   ``get_embedding_dimension()`` runs no encode; ``score_pages`` launched.
12. One JSON line listing every kernel with its launches and times, and the
   launch floor under ``empty``; the page scorer also carries its launches
   on phase 7's path (``launches_config4``), phase 8's (``launches_rag``),
   phase 9's (``launches_ops``, part C; ``launches_sql``, part D;
   ``launches_async``, part E), phase 10's (``launches_persist``) and phase
   11's part C (``launches_slides``); the tiered kernels carry phase 11's
   part A launches (``launches_chaos``) and part B's Run 2
   (``launches_resume``).
13. Last line: ``{"ok": true, "device": {...}}``.

``--kernels-only`` stops after phase 2 and measures the launch floor, the
int8 probe (``PROBE_SHAPES``) and the block scorers (``SYNTHETIC_SHAPES``)
alone on seeded inputs of the tiered path's shapes, as phase 5 measures
them, printing the measurements as its last line. ``--config4-only`` runs
phase 7 alone after the build, on a corpus of its own size; ``--rag-only``,
``--ops-only``, ``--persist-only`` and ``--chaos-only`` run phase 8, phase 9,
phase 10 and phase 11 alone the same way.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
N_CHECKED = 16  # served requests that the plain scorer re-scores on the card


def log(msg: str) -> None:
    print(msg, flush=True)


class GcPauses:
    """The process's full (generation 2) garbage collections, each as
    (start on the ``perf_counter`` clock, seconds), recorded by the ``gc``
    callback that ``main`` installs: every thread stops for one, so a
    request caught by it waits it out."""

    def __init__(self) -> None:
        self.pauses: list = []
        self._start = None

    def __call__(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        now = time.perf_counter()
        if phase == "start":
            self._start = now
        elif self._start is not None:
            self.pauses.append((self._start, now - self._start))
            self._start = None

    def within(self, t0: float, t1: float) -> list:
        """Seconds of each full collection that started between t0 and t1."""
        return [s for start, s in self.pauses if t0 <= start < t1]


GC_PAUSES = GcPauses()


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unavailable"
    except (OSError, subprocess.TimeoutExpired):
        return "unavailable"


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(make_launch, per_graph: int = 50, replays: int = 20) -> float:
    """Device ms per launch with the host out of the loop: ``make_launch()``
    runs with a side stream current (a launcher binds the stream it is made
    on), its ``launch`` is warmed there, then ``per_graph`` launches are
    captured in one CUDA graph, and the graph is replayed ``replays`` times
    between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch = make_launch()
        for _ in range(3):
            launch()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        for _ in range(per_graph):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def keeping(pair):
    """The ``launch`` of a launcher's ``(launch, out)``, holding ``out``
    alive for as long as the launch is (a graph writes into it)."""
    launch, out = pair
    return lambda: (launch(), out)


def gc_line(phase: dict) -> str:
    """The full garbage collections that started during a timed phase."""
    pauses = phase["gc_pauses_s"]
    longest = f" (longest {max(pauses) * 1e3:.0f} ms)" if pauses else ""
    return f"full GC pauses {len(pauses)}{longest}"


def launch_floor(torch, card: str) -> dict:
    """The empty kernel of ``csrc/score_blocks.cu`` through the probe's
    ctypes path, timed both ways: by graph replay (device ms per launch) and
    in a Python loop of launches between two events."""
    from pathway_tpu_torch.ops import knn_quant

    dev = torch.device("cuda")
    floor = {"graph_ms": graph_time_ms(lambda: knn_quant.empty_launcher(dev)),
             "loop_ms": cuda_time_ms(knn_quant.empty_launcher(dev), 100)}
    log(f"  launch floor (the empty kernel, same ctypes path): graph replay "
        f"{floor['graph_ms']:.5f} ms per launch, Python loop {floor['loop_ms']:.5f} ms [{card}]")
    return floor


def host_times_ms(fns: dict, reps: int = 9) -> dict:
    """Median host-clock ms of each function, run to the end of its device
    work. The functions take turns, so a drift in clocks or load touches
    each alike."""
    import torch

    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


# -- phase 3 ------------------------------------------------------------------


def float_tolerance(torch, pn, queries, page_ids, metric: str, fin):
    """Allowed |kernel - plain| per finite score of a float corpus: 1e-5 of
    the dot's scale |q|^2 + |p|^2 (of 1 for cos). The two sum the same f32
    products in another order, so the error scales with the terms, not with
    the score, which for ip can sit near 0."""
    if metric == "cos":
        return torch.full((int(fin.sum()),), 1e-5, device=pn.device)
    qn = torch.sum(queries.float() ** 2, dim=1)[:, None, None]
    return 1e-5 * (qn + pn[page_ids.long()]).reshape(page_ids.shape[0], -1)[fin]


def phase3_page_ids(torch, gen, case: str, n_pages: int):
    """The work shapes phase 3 holds the kernel to: uniform random pages;
    three pages (one the all-pad sentinel) shared by every query in every
    slot; 64 queries, more than one pass of the kernel per page."""
    sentinel = n_pages - 1
    if case == "random":
        return torch.randint(0, n_pages, (8, 96), generator=gen, dtype=torch.int32)
    if case == "duplicates":
        pick = torch.randint(0, 3, (8, 200), generator=gen)
        return torch.tensor([7, 300, sentinel], dtype=torch.int32)[pick]
    ids = torch.randint(0, 6, (64, 48), generator=gen, dtype=torch.int32)
    ids[:, 40:] = sentinel
    return ids


def check_kernel_vs_plain(torch, knn_ivf, seed: int) -> float:
    """Kernel against plain version on synthetic pages; returns max |err|
    over the float corpora."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dev = torch.device("cuda")
    n_pages, d = 512, 384
    mask = torch.where(
        torch.rand((n_pages, knn_ivf.PAGE), generator=gen) < 0.1, float("-inf"), 0.0
    )
    mask[-1] = float("-inf")  # the last page is all pad, as the sentinel page
    worst = 0.0
    for case in ("random", "duplicates", "q64"):
        page_ids = phase3_page_ids(torch, gen, case, n_pages)
        q = page_ids.shape[0]
        for corpus in ("int", "float"):
            if corpus == "int":
                rows = torch.randint(-8, 9, (n_pages * knn_ivf.PAGE, d), generator=gen).float()
                queries = torch.randint(-8, 9, (q, d), generator=gen).float()
            else:
                rows = torch.randn((n_pages * knn_ivf.PAGE, d), generator=gen)
                queries = torch.randn((q, d), generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                packed = rows.to(dtype).to(dev).contiguous()
                pn = torch.sum(packed.float() ** 2, dim=1).reshape(n_pages, knn_ivf.PAGE)
                args = (packed, pn.contiguous(), mask.to(dev), queries.to(dev), page_ids.to(dev))
                for metric in ("l2sq", "cos", "ip"):
                    got = knn_ivf.score_pages_cuda(*args, metric)
                    want = knn_ivf.score_pages_plain(*args, metric)
                    torch.cuda.synchronize()
                    same_mask = torch.equal(torch.isinf(got), torch.isinf(want))
                    fin = torch.isfinite(want)
                    err = (got[fin] - want[fin]).abs()
                    if corpus == "int":
                        ok = same_mask and torch.equal(got[fin], want[fin])
                    else:
                        tol = float_tolerance(torch, pn, args[3], args[4], metric, fin)
                        ok = same_mask and bool((err <= tol).all())
                        worst = max(worst, float(err.max()))
                    log(
                        f"  score_pages {case:10s} q={q:2d} {corpus:5s} {str(dtype)[6:]:8s} "
                        f"{metric:4s} max|err|={float(err.max()):.3g} "
                        f"{'ok' if ok else 'MISMATCH'}"
                    )
                    if not ok:
                        raise SystemExit(f"score_pages disagrees with its plain version ({case}, "
                                         f"{corpus}, {dtype}, {metric})")
    return worst


# -- phase 4 ------------------------------------------------------------------


def make_corpus(n: int, seed: int):
    """Seeded topical corpus: 4096 topics of 64 words each over a 32768-word
    vocabulary; every chunk is 16-96 words, 3/4 from its topic."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    wl = rng.integers(3, 10, 32768)
    vocab = ["".join(letters[rng.integers(0, 26, k)]) for k in wl]
    topics = rng.integers(0, len(vocab), (4096, 64))
    topic = rng.integers(0, 4096, n)
    lens = rng.integers(16, 97, n)
    total = int(lens.sum())
    owner = np.repeat(topic, lens)
    from_topic = rng.random(total) < 0.75
    words = np.where(
        from_topic,
        topics[owner, rng.integers(0, 64, total)],
        rng.integers(0, len(vocab), total),
    )
    bounds = np.concatenate([[0], np.cumsum(lens)])
    vocab_arr = np.array(vocab, dtype=object)
    docs = []
    for i in range(n):
        text = " ".join(vocab_arr[words[bounds[i] : bounds[i + 1]]])
        t = int(topic[i])
        docs.append({
            "data": text,
            "_metadata": {
                "path": f"/corpus/{t % 16:02d}/doc{i}.txt", "topic": t,
                "modified_at": i, "seen_at": i,
            },
        })
    return docs


# make_corpus's longest chunk: a splitter with this many words keeps every
# chunk whole
CHUNK_MAX_WORDS = 96


def perturb(text: str, rng) -> str:
    words = text.split()
    drop = set(rng.choice(len(words), size=3, replace=False).tolist())
    kept = [w for i, w in enumerate(words) if i not in drop]
    i, j = rng.choice(len(kept), size=2, replace=False)
    kept[i], kept[j] = kept[j], kept[i]
    return " ".join(kept)


def score_pages_bound(torch, knn_ivf, packed, queries, page_ids):
    """The least time the card could take to score ``page_ids``: the larger
    of the bytes the function must move over the memory rate (each distinct
    probed page, its norms and mask once, the queries, the page ids, the
    scores written) and its f32 FMA work over the f32 rate. Returns
    (ms, "bytes" or "operations", bytes, flops, distinct pages)."""
    q, n_slots = page_ids.shape
    d = packed.shape[1]
    pages = int(torch.unique(page_ids).numel())
    nbytes = (
        pages * knn_ivf.PAGE * d * packed.element_size()  # each probed page once
        + 2 * pages * knn_ivf.PAGE * 4  # its norms and mask
        + queries.numel() * 4 + page_ids.numel() * 4  # queries, page ids
        + q * n_slots * knn_ivf.PAGE * 4  # scores out
    )
    flops = 2.0 * q * n_slots * knn_ivf.PAGE * d
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, flops, pages


def score_pages_launcher(torch, knn_ivf, args):
    """``launch()`` of the page scorer's two kernels on the stream current
    now, its work list built once by the plain grouping (the list that the
    wrapper's graph replays), for timing by graph replay; counts nothing."""
    from pathway_tpu_torch.ops import _cuda

    packed, pn, pm, q, page_ids, metric = args
    n_pages, page = pn.shape
    nq, n_slots = page_ids.shape
    work = knn_ivf.group_page_work(page_ids, n_pages)
    fn = _cuda.load(knn_ivf.SCORE_PAGES_SOURCE).pw_score_pages  # typed by score_pages_cuda
    out = torch.empty((nq, n_slots * page), dtype=torch.float32, device=packed.device)
    tiles = torch.empty(nq * n_slots * page + nq, dtype=torch.float32, device=packed.device)
    stream = torch.cuda.current_stream()
    c_args = (
        packed.data_ptr(), 0 if packed.dtype == torch.float32 else 1, pn.data_ptr(),
        pm.data_ptr(), q.data_ptr(), page_ids.data_ptr(), work.rank.data_ptr(),
        work.pages.data_ptr(), work.n_probed.data_ptr(), tiles.data_ptr(), out.data_ptr(),
        n_pages, nq, n_slots, packed.shape[1], knn_ivf._METRICS[metric], stream.device_index,
        stream.cuda_stream,
    )

    keep = (work, out, tiles)

    def launch() -> None:
        _cuda.check(fn(*c_args), knn_ivf.SCORE_PAGES)
        len(keep)  # the closure keeps the work list and the outputs alive

    return launch


def measure_scorer(torch, knn_ivf, store, queries, label: str, card: str):
    """Hold the page scorer against its plain version at the shapes the
    query path gives it for ``queries`` (padded to their pow2 bucket), time
    it, its work grouping alone and the plain version, and compute its
    bound."""
    packed, pn, pm, q, page_ids = store.scoring_inputs(queries)
    metric = store.metric
    args = (packed, pn, pm, q, page_ids, metric)
    got = knn_ivf.score_pages_cuda(*args)
    want = knn_ivf.score_pages_plain(*args)
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise SystemExit(f"score_pages masks disagree at the {label}'s shapes")
    err = (got[fin] - want[fin]).abs()
    max_err = float(err.max())
    if not bool((err <= float_tolerance(torch, pn, q, page_ids, metric, fin)).all()):
        raise SystemExit(f"score_pages disagrees with its plain version at the {label}'s "
                         f"shapes ({metric}, max |err| {max_err:.3g})")
    ms = cuda_time_ms(lambda: knn_ivf.score_pages_cuda(*args), 50)
    graph_ms = graph_time_ms(lambda: score_pages_launcher(torch, knn_ivf, args))
    # the grouping alone, as the wrapper runs it (a CUDA graph replay)
    group_ms = cuda_time_ms(lambda: knn_ivf.page_work(page_ids, pn.shape[0]), 50)
    plain_ms = cuda_time_ms(lambda: knn_ivf.score_pages_plain(*args), 5, warmup=1)
    qn_, n_slots = page_ids.shape
    d = packed.shape[1]
    sentinel_slots = int((page_ids == pn.shape[0] - 1).sum())
    rows = torch.arange(qn_, device=page_ids.device)[:, None]
    pairs = int(torch.unique(page_ids.long() * qn_ + rows).numel())
    bound, bound_by, nbytes, flops, pages = score_pages_bound(torch, knn_ivf, packed, q, page_ids)
    log(
        f"  score_pages, {label}: q={qn_} ({len(queries)} real) slots={n_slots} d={d}; "
        f"{qn_ * n_slots - sentinel_slots} real slots, {sentinel_slots} sentinel slots, "
        f"{pages} distinct pages, {pairs} distinct (page, query) pairs; kernel {ms:.4f} ms "
        f"(its grouping alone {group_ms:.4f} ms, {group_ms / ms:.1%}; its two launches by "
        f"graph replay {graph_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms "
        f"({bound_by}; {bound / ms:.1%} of it) [{card}]"
    )
    rec = {
        "q": qn_, "real_queries": len(queries), "n_slots": n_slots, "d": d,
        "real_slots": qn_ * n_slots - sentinel_slots, "sentinel_slots": sentinel_slots,
        "distinct_pages": pages, "distinct_pairs": pairs, "bytes": nbytes, "flops": flops,
        "max_abs_err": max_err, "ms": ms, "graph_ms": graph_ms, "group_ms": group_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "scores": got,
    }
    return rec


GRAPH_COS = 0.99999  # a bucket's graph replay against its eager forward, cosine per row
CONCURRENT_OVERLAP = 0.99  # mean top-10 overlap of concurrent answers with solo answers


def check_prewarm(torch, sl, seed: int, card: str) -> dict:
    """Wait for the encoder service's pre-warm, then hold each bucket's graph
    replay against the eager forward of the same ids (cosine per row), and
    report whether the two are bitwise equal."""
    import numpy as np

    svc = sl.embedder.pipeline.service
    enc = sl.embedder.encoder
    if not svc.wait_warm(600.0):
        raise SystemExit("the encoder service's pre-warm did not finish")
    if svc.prewarm_error:
        raise SystemExit(f"the pre-warm failed: {svc.prewarm_error}")
    shapes = svc._prewarm_shapes()
    if not (svc.prewarm_compiles == enc.graphs_captured == len(shapes)):
        raise SystemExit(f"{enc.graphs_captured} graphs captured, {svc.prewarm_compiles} "
                         f"buckets warmed, {len(shapes)} expected")
    log(f"  pre-warm: {len(shapes)} buckets (batch 8-{shapes[-1][0]} x seq 8-{shapes[-1][1]}), "
        f"{enc.graphs_captured} CUDA graphs captured in {svc.prewarm_s:.2f}s; their pool holds "
        f"{svc.prewarm_pool_bytes} bytes ({svc.prewarm_pool_bytes / 2**20:.1f} MiB, memory_reserved "
        f"after the pre-warm minus before) [{card}]")
    rng = np.random.default_rng(seed + 3)
    buckets = []
    for batch, seq in shapes:
        ids = rng.integers(2000, enc.config.vocab_size - 1000, size=(batch, seq))
        lens = rng.integers(1, seq + 1, size=batch)
        ids[np.arange(seq)[None, :] >= lens[:, None]] = 0
        eager = enc.encode_ids(ids, graph=False).float()
        replay = enc.encode_ids(ids, graph=True).float()
        cos = torch.sum(eager * replay, dim=1) / torch.clamp(
            torch.linalg.norm(eager, dim=1) * torch.linalg.norm(replay, dim=1), min=1e-30
        )
        rec = {"batch": batch, "seq": seq, "min_cos": float(cos.min()),
               "max_abs_err": float((eager - replay).abs().max()),
               "bitwise": bool(torch.equal(eager, replay))}
        buckets.append(rec)
        if rec["min_cos"] < GRAPH_COS:
            raise SystemExit(f"bucket ({batch}, {seq}): graph replay vs eager cosine "
                             f"{rec['min_cos']:.7f} < {GRAPH_COS}")
    log("  pre-warm, replay vs eager per bucket (min cos / max |err| / bitwise): " + "; ".join(
        f"({b['batch']},{b['seq']}) {b['min_cos']:.7f}/{b['max_abs_err']:.3g}/"
        f"{'yes' if b['bitwise'] else 'no'}" for b in buckets))
    return {
        "buckets": len(shapes), "graphs": enc.graphs_captured, "prewarm_s": svc.prewarm_s,
        "pool_bytes": svc.prewarm_pool_bytes, "replay_vs_eager": buckets,
        "min_cos": min(b["min_cos"] for b in buckets),
        "bitwise_buckets": sum(b["bitwise"] for b in buckets),
        "memory_reserved_bytes": int(torch.cuda.memory_reserved()),
    }


BATCH = 16384  # documents per ingest commit
WAVE = 1024  # documents the live wave removes, replaces and adds (each)


def until(condition, poll_s: float, failure: str, timeout_s: float = 900.0) -> None:
    """Poll ``condition`` every ``poll_s`` until it holds; exit after ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while not condition():
        if time.perf_counter() > deadline:
            raise SystemExit(f"{failure} within {timeout_s:.0f}s")
        time.sleep(poll_s)


# -- the metrics plane ------------------------------------------------------------

# The strict OpenMetrics grammar (the repo's test checker, copied: the smoke
# runs without the tests beside it). Checks: metadata before samples, one
# contiguous block per family, counter samples named <family>_total,
# histogram buckets ascending and monotone with +Inf == _count, # EOF last.

import re as _re

_METRIC_NAME_RE = _re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = _re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:[^"}]|"(?:[^"\\]|\\.)*")*)\})?'
    r" (?P<value>[^ ]+)(?: (?P<ts>[0-9.+-eE]+))?$"
)
_LABEL_PAIR_RE = _re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class GrammarError(Exception):
    pass


def _need(cond, msg: str) -> None:
    if not cond:
        raise GrammarError(msg)


def _om_parse_labels(raw: str) -> dict:
    """Parse a label body positionally (a comma inside a quoted value is legal)."""
    labels: dict = {}
    pos = 0
    while pos < len(raw):
        m = _LABEL_PAIR_RE.match(raw, pos)
        _need(m, f"malformed label body at ...{raw[pos:]!r}")
        labels[m.group(1)] = m.group(2)
        pos = m.end()
        if pos < len(raw):
            _need(raw[pos] == ",", f"expected ',' between labels at ...{raw[pos:]!r}")
            pos += 1
    return labels


def validate_openmetrics(text: str) -> dict:
    """Check ``text`` against the strict grammar; returns
    {family: {"type": ..., "help": ..., "samples": [(name, labels, value)]}}.
    Raises :class:`GrammarError` on the first fault."""
    lines = text.split("\n")
    _need(lines[-1] == "", "exposition must end with a newline")
    lines = lines[:-1]
    _need(lines, "empty exposition")
    _need(lines[-1] == "# EOF", f"missing # EOF terminator (last: {lines[-1]!r})")
    families: dict = {}
    family_order: list = []
    current_family = None
    for lineno, line in enumerate(lines[:-1], 1):
        _need(line == line.strip(), f"line {lineno}: stray whitespace {line!r}")
        _need(line != "# EOF", f"line {lineno}: # EOF before the end")
        if line.startswith("# "):
            parts = line.split(" ", 3)
            _need(len(parts) >= 3 and parts[1] in ("HELP", "TYPE"),
                  f"line {lineno}: malformed metadata {line!r}")
            kind, name = parts[1], parts[2]
            _need(_METRIC_NAME_RE.fullmatch(name), f"line {lineno}: bad metric family name {name!r}")
            fam = families.setdefault(name, {"type": None, "help": None, "samples": []})
            _need(not fam["samples"], f"line {lineno}: {kind} for {name} AFTER its samples")
            if kind == "TYPE":
                _need(fam["type"] is None, f"line {lineno}: duplicate TYPE for {name}")
                _need(len(parts) == 4 and parts[3] in (
                    "counter", "gauge", "histogram", "summary", "unknown", "info",
                ), f"line {lineno}: bad TYPE {line!r}")
                fam["type"] = parts[3]
            else:
                _need(fam["help"] is None, f"line {lineno}: duplicate HELP for {name}")
                fam["help"] = parts[3] if len(parts) == 4 else ""
            continue
        m = _SAMPLE_RE.match(line)
        _need(m, f"line {lineno}: malformed sample {line!r}")
        name, raw_labels, raw_value = m.group("name"), m.group("labels"), m.group("value")
        fam_name = None
        for suffix in ("_total", "_bucket", "_count", "_sum", ""):
            base = name[: -len(suffix)] if suffix and name.endswith(suffix) else (
                name if not suffix else None
            )
            if base and base in families:
                fam_name = base
                break
        _need(fam_name, f"line {lineno}: sample {name!r} has no TYPE/HELP metadata")
        fam = families[fam_name]
        _need(fam["type"] is not None, f"line {lineno}: {fam_name} samples precede TYPE")
        if fam["type"] == "counter":
            _need(name == fam_name + "_total",
                  f"line {lineno}: counter sample must be {fam_name}_total, got {name!r}")
        if fam["type"] == "histogram":
            _need(name in (fam_name + "_bucket", fam_name + "_count", fam_name + "_sum"),
                  f"line {lineno}: bad histogram sample name {name!r}")
        labels = _om_parse_labels(raw_labels or "")
        try:
            value = float(raw_value.replace("+Inf", "inf"))
        except ValueError as exc:
            raise GrammarError(f"line {lineno}: bad value {raw_value!r}") from exc
        if fam_name != current_family:
            _need(fam_name not in family_order,
                  f"line {lineno}: family {fam_name} samples are not contiguous")
            family_order.append(fam_name)
            current_family = fam_name
        fam["samples"].append((name, labels, value))
    for fam_name, fam in families.items():
        if fam["type"] != "histogram" or not fam["samples"]:
            continue
        buckets = [(lb, v) for (n, lb, v) in fam["samples"] if n.endswith("_bucket")]
        counts = {n: v for (n, lb, v) in fam["samples"] if not n.endswith("_bucket")}
        _need(buckets, f"{fam_name}: histogram without buckets")
        prev_le, prev_count = float("-inf"), 0.0
        for lb, v in buckets:
            _need("le" in lb, f"{fam_name}: bucket without le label")
            le = float(lb["le"].replace("+Inf", "inf"))
            _need(le > prev_le, f"{fam_name}: le bounds not ascending at {lb['le']}")
            _need(v >= prev_count, f"{fam_name}: bucket counts not monotone at le={lb['le']}")
            prev_le, prev_count = le, v
        _need(prev_le == float("inf"), f"{fam_name}: missing +Inf bucket")
        _need(counts.get(fam_name + "_count") == prev_count, f"{fam_name}: _count != +Inf bucket")
        _need(fam_name + "_sum" in counts, f"{fam_name}: missing _sum")
    return families


SERVING_HISTOGRAMS = ("pathway_encsvc_queue_depth_rows", "pathway_encsvc_tick_occupancy",
                      "pathway_encsvc_tick_seconds")
TIERED_HISTOGRAMS = ("pathway_ivf_prefetch_stall_seconds", "pathway_ivf_tier_hit_ratio",
                     "pathway_ivf_tier_occupancy_ratio", "pathway_ivf_quant_rescore_depth",
                     "pathway_ivf_quant_recall_ratio")
# the same phases' numbers from run S4 in PERF.md (NVIDIA H100 80GB HBM3, 700 W):
# ingest docs/s and solo p50 ms, untiered at 524,288 chunks and tiered at 1M
# (the tiered phase now serves 393,216)
S4 = {"untiered": (5754, 12.84), "tiered": (5945, 22.32)}


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def operator_totals() -> dict:
    """The engine profiler's per-operator totals, keyed by (node, name, kind)."""
    from pathway_tpu_torch.engine.profile import get_profiler

    return {(e["node"], e["name"], e["kind"]): e for e in get_profiler().operator_totals()}


def operator_table(sl, before: dict, after: dict, commits: int, label: str, card: str,
                   requests: int = 0, top: int = 14) -> list:
    """Print the operators by their seconds between two profiler readings:
    calls, rows, seconds, ms per commit, us per row (and ms per request when
    the phase answered ``requests``; ``sl=None``: a graph that is not a
    ``Slice``, without stages and columns). Returns the rows."""
    stage_of = sl.stage_of() if sl is not None else {}
    rows = []
    for key, e in after.items():
        b = before.get(key, {"seconds": 0.0, "rows": 0, "calls": 0, "retractions": 0})
        d = {k: e[k] - b[k] for k in ("seconds", "rows", "calls", "retractions")}
        if d["calls"] <= 0:
            continue
        node, name, kind = key
        rows.append({"node": node, "name": name, "kind": kind, "stage": stage_of.get(node, "?"),
                     "columns": sl.columns_of(node) if sl is not None else "", **d,
                     "ms_per_commit": d["seconds"] * 1e3 / max(commits, 1),
                     "us_per_row": d["seconds"] * 1e6 / d["rows"] if d["rows"] else None,
                     "ms_per_request": d["seconds"] * 1e3 / requests if requests else None})
    rows.sort(key=lambda r: r["seconds"], reverse=True)
    total = sum(r["seconds"] for r in rows)
    per_req = f", {total * 1e3 / requests:.3f} ms per request" if requests else ""
    log(f"  operators, {label}: {len(rows)} operators, {total:.3f} s over {commits} commits "
        f"({total * 1e3 / max(commits, 1):.3f} ms per commit{per_req}) [{card}]")
    log("    node kind            stage        calls       rows   seconds  ms/commit  us/row"
        + ("  ms/request" if requests else "") + "  columns")
    for r in rows[:top]:
        us = f"{r['us_per_row']:8.2f}" if r["us_per_row"] is not None else "       -"
        req = f"  {r['ms_per_request']:10.4f}" if requests else ""
        log(f"    {r['node']:4d} {r['kind']:15s} {r['stage']:11s} {r['calls']:6d} {r['rows']:10d} "
            f"{r['seconds']:9.3f} {r['ms_per_commit']:10.4f} {us}{req}  {r['columns']}")
    return rows


def ring_shape(min_rows: int) -> dict:
    """Rows per operator of the largest commit in the flight recorder's ring
    with at least ``min_rows`` input rows (an empty dict when there is none)."""
    from pathway_tpu_torch.engine.profile import get_flight_recorder

    ring = [p for p in get_flight_recorder().payload("shape")["profiles"]
            if p["input_rows"] >= min_rows]
    if not ring:
        return {}
    p = max(ring, key=lambda p: p["input_rows"])
    return {"input_rows": p["input_rows"], "rows": {o["node"]: o["rows"] for o in p["ops"]}}


def plane_cost(sl, card: str, label: str, shapes: dict) -> dict:
    """Host us per commit of the metrics plane on this graph: for every
    operator of the runner's graph, the two clocks, the tuple and the
    retraction count the runner adds per turn (at the rows that operator
    emitted in a real commit of the phase, ``shapes``), then the
    ``CommitProfile``, the profiler's and the flight recorder's
    ``record_commit`` and ``ProberStats.record_commit``, into instances of
    their own; each timed function runs 128 commits (two profiler folds)."""
    import numpy as np

    from pathway_tpu_torch.engine import profile as prof_mod
    from pathway_tpu_torch.engine.http_server import ProberStats

    nodes = list(sl.server.runner.graph.nodes)
    profiler, recorder, stats = prof_mod.EngineProfiler(), prof_mod.FlightRecorder(), ProberStats()
    clock = time.perf_counter

    sources = [n for n in nodes if n.kind == "input"]
    idle_ops = [(n.id, n.name, n.kind, 0.0, 0, 0, False) for n in nodes if n.kind != "input"]

    def make(rows_of):
        # rows_of None: an idle commit (the sources' turns, then the other
        # operators' zero-second turns appended at once, as the runner does)
        turns = sources if rows_of is None else nodes
        diffs = {n.id: np.ones((rows_of or {}).get(n.id, 0), dtype=np.int64) for n in nodes}

        def commits() -> None:
            for c in range(128):
                ops, counts = [], {}
                for n in turns:
                    t0 = clock()
                    d = diffs[n.id]
                    rows = len(d)
                    if rows:
                        counts[n.id] = rows
                    ops.append((n.id, n.name, n.kind, clock() - t0, rows,
                                int(np.count_nonzero(d < 0)) if rows else 0, False))
                if rows_of is None:
                    ops.extend(idle_ops)
                p = prof_mod.CommitProfile(commit=c, rank=0, duration_s=0.01, input_rows=1,
                                           output_rows=1, neu=False, ops=ops)
                profiler.record_commit(p)
                recorder.record_commit(p)
                stats.record_commit(1, 1, counts, False)

        return commits

    named = {"idle commit": None}
    named.update({k: v["rows"] for k, v in shapes.items() if v})
    fns = {name: make(rows_of) for name, rows_of in named.items()}
    fns["empty"] = lambda: None
    t = host_times_ms(fns)
    out = {name: max(t[name] - t["empty"], 0.0) * 1e3 / 128 for name in named}
    log(f"  metrics plane cost, {label}: host us per commit over the graph's {len(nodes)} "
        f"operators (per-operator clocks + record_commit, median of 9 x 128 commits): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out.items())
        + "; input rows of those commits: "
        + ", ".join(f"{k} {v['input_rows']}" for k, v in shapes.items() if v) + f" [{card}]")
    return out


def beside_s4(which: str, ingest: dict, ret: dict, card: str) -> None:
    """This run's ingest rate and solo p50 next to run S4's (a range between
    two runs, not a claim: host clocks move between calls)."""
    docs_s, p50 = S4[which]
    log(f"  {which} beside S4: ingest {ingest['docs_per_s']:.0f} docs/s (S4 {docs_s}), solo p50 "
        f"{ret['p50_ms']:.2f} ms (S4 {p50}), with the metrics plane on [{card}]")


def check_scrape(sl, label: str, card: str, need: tuple = (), engine=None) -> dict:
    """GET the runner's /metrics, hold it to the strict grammar and to the
    families the served path must show by now: the commit counter, the
    commit-duration and REST-latency histograms, a
    ``pathway_operator_seconds`` series for every operator of the graph, and
    the histograms ``need`` names (a histogram with no observation yet is
    not exported). ``engine``: the ``/v1/statistics`` engine snapshot read
    just before, held against the scrape. Prints its wall ms and size."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{sl.metrics_port}/metrics", timeout=60) as r:
        ctype = r.headers.get("Content-Type")
        body = r.read().decode()
    ms = (time.perf_counter() - t0) * 1e3
    try:
        fams = validate_openmetrics(body)
    except GrammarError as exc:
        raise SystemExit(f"/metrics {label}: not valid OpenMetrics: {exc}") from None
    if ctype != "application/openmetrics-text":
        raise SystemExit(f"/metrics {label}: Content-Type {ctype!r}")
    hists = ("pathway_commit_duration_seconds", "pathway_rest_latency_seconds", *need)
    missing = [f for f in ("commits", "pathway_operator_seconds", *hists) if f not in fams]
    if missing:
        raise SystemExit(f"/metrics {label}: families missing: {missing}")
    for f in hists:
        if fams[f]["type"] != "histogram":
            raise SystemExit(f"/metrics {label}: {f} is a {fams[f]['type']}, not a histogram")
    ops = {(s[1]["operator"], s[1]["kind"], s[1]["node"])
           for s in fams["pathway_operator_seconds"]["samples"]}
    graph = {(n.name, n.kind, str(n.id)) for n in sl.server.runner.graph.nodes}
    if graph - ops:
        raise SystemExit(f"/metrics {label}: no pathway_operator_seconds series for "
                         f"{sorted(graph - ops)}")
    value = {s[0]: s[2] for f in fams.values() for s in f["samples"] if not s[1]}
    rest = int(value["pathway_rest_latency_seconds_count"])
    answered = sl.answered()
    if rest != sum(answered.values()):
        raise SystemExit(f"/metrics {label}: pathway_rest_latency_seconds_count {rest}, but "
                         f"{sum(answered.values())} requests were answered ({answered})")
    commits = int(value["commits_total"])
    extra = ""
    if engine is not None:
        # /v1/statistics' engine snapshot, read just before: its commits are
        # the ones recorded before its own commit, and each of its operators
        # has grown at most since then
        by_key = {}
        for fam in ("pathway_operator_seconds", "pathway_operator_rows"):
            for _n, lb, v in fams[fam]["samples"]:
                by_key.setdefault((lb["node"], lb["operator"], lb["kind"]), {})[fam] = v
        if not 0 < engine["commits"] <= commits <= engine["commits"] + 16:
            raise SystemExit(f"/metrics {label}: commits_total {commits} against the engine "
                             f"snapshot's {engine['commits']}")
        for op in engine["operators"]:
            got = by_key.get((str(op["node"]), op["name"], op["kind"]))
            if got is None or got["pathway_operator_seconds"] < op["seconds"] or \
                    got["pathway_operator_rows"] < op["rows"]:
                raise SystemExit(f"/metrics {label}: operator {op} disagrees with the scrape {got}")
        topop = engine["operators"][0]
        extra = (f"; /v1/statistics engine: {engine['commits']} commits, commit p50 "
                 f"{engine['commit_duration_ms']['p50']:.2f} ms, top operator node {topop['node']} "
                 f"{topop['kind']} {topop['seconds']:.3f} s, all {len(engine['operators'])} "
                 f"agree with the scrape")
    hist_counts = ", ".join(f"{h} {int(value[h + '_count'])}" for h in need) or "no serving histogram yet"
    log(f"  /metrics {label}: {len(body)} bytes in {ms:.2f} ms, {len(fams)} families, strict "
        f"grammar ok; commits_total {commits}, pathway_operator_seconds for all {len(graph)} "
        f"operators; pathway_rest_latency_seconds_count {rest} = requests answered "
        f"({', '.join(f'{k} {v}' for k, v in sorted(answered.items()))}); {hist_counts}{extra} [{card}]")
    return {"label": label, "bytes": len(body), "ms": ms, "families": len(fams),
            "commits_total": commits, "rest_count": rest, "answered": answered,
            "histogram_counts": {h: int(value[h + "_count"]) for h in hists}}


def brownout_events(label: str) -> list:
    """The flight recorder's brownout events; at least one must be there."""
    from pathway_tpu_torch.engine.profile import get_flight_recorder

    events = [e for e in get_flight_recorder().payload("brownout")["events"]
              if e["kind"] == "brownout"]
    if not events or not any(e["action"] == "engage" and e["to_level"] == 2 for e in events):
        raise SystemExit(f"{label}: no brownout flight event engaging rung 2 ({events})")
    return events


def flight_dump(label: str, card: str) -> dict:
    """Dump the flight recorder into a temporary directory, read it back and
    print its summary line."""
    import shutil
    import tempfile

    from pathway_tpu_torch.engine.profile import flight_summary_line, get_flight_recorder

    tmp = tempfile.mkdtemp(prefix="pw-flight-")
    try:
        path = get_flight_recorder().dump(f"smoke: {label}", directory=tmp)
        if path is None:
            raise SystemExit(f"{label}: the flight recorder wrote no dump")
        with open(path) as f:
            payload = json.load(f)
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = flight_summary_line(payload)
    kinds: dict = {}
    for e in payload["events"]:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    log(f"  flight dump, {label}: {size} bytes, {len(payload['profiles'])} commit profiles, "
        f"events {kinds}; {line} [{card}]")
    return {"bytes": size, "profiles": len(payload["profiles"]), "events": kinds, "summary": line}


def doc_row(doc: dict, Json) -> dict:
    """A corpus document as a row of the documents table (keyed by ``path``)."""
    meta = doc["_metadata"]
    return {"path": meta["path"], "data": doc["data"], "_metadata": Json(meta)}


def make_wave(docs: list, seed: int):
    """The live wave: WAVE documents removed, WAVE replaced by new texts under
    their keys, WAVE new documents. Returns (removed, [(old, new)], added)."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    n = len(docs)
    picks = rng.choice(n, size=2 * WAVE, replace=False)
    fresh = make_corpus(2 * WAVE, seed + 11)
    removed = [docs[i] for i in picks[:WAVE]]
    replaced, added = [], []
    for j, i in enumerate(picks[WAVE:]):
        meta = dict(docs[i]["_metadata"], topic=fresh[j]["_metadata"]["topic"],
                    modified_at=n + j, seen_at=n + j)
        replaced.append((docs[i], {"data": fresh[j]["data"], "_metadata": meta}))
    for j in range(WAVE):
        new = fresh[WAVE + j]
        t = new["_metadata"]["topic"]
        meta = {"path": f"/corpus/{t % 16:02d}/doc{n + j}.txt", "topic": t,
                "modified_at": n + WAVE + j, "seen_at": n + WAVE + j}
        added.append({"data": new["data"], "_metadata": meta})
    return removed, replaced, added


class Slice:
    """The port's main path through its engine: documents stream in through a
    python connector into ``VectorStoreServer(index_factory="ivf")``, queries
    arrive over REST, and a live wave removes, replaces and adds documents.
    ``device``: the card (``None``) or ``"cpu"`` for a rehearsal."""

    def __init__(self, docs: list, batch: int, seed: int, device=None, encoder_config=None):
        import threading

        import pathway_tpu_torch as pw
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
        from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer

        self.docs, self.batch, self.seed = docs, batch, seed
        self.removed, self.replaced, self.added = make_wave(docs, seed)
        slice_ = self

        class CorpusFeed(pw.io.python.ConnectorSubject):
            """Pushes the corpus in commits of ``batch`` rows, then the live
            wave as one commit when it is released."""

            def run(self):
                for start in range(0, len(slice_.docs), slice_.batch):
                    for doc in slice_.docs[start : start + slice_.batch]:
                        self.next(**doc_row(doc, pw.Json))
                    self.commit()
                slice_.wave_go.wait()
                slice_.wave_pushed = time.perf_counter()
                for doc in slice_.removed:
                    self._remove(doc_row(doc, pw.Json))
                for old, new in slice_.replaced:
                    self._remove(doc_row(old, pw.Json))
                    self.next(**doc_row(new, pw.Json))
                for doc in slice_.added:
                    self.next(**doc_row(doc, pw.Json))
                self.commit()
                slice_.stop.wait()

        self.wave_go, self.stop = threading.Event(), threading.Event()
        self.wave_pushed = None
        G.clear()
        schema = pw.schema_builder({
            "path": pw.column_definition(dtype=str, primary_key=True),
            "data": pw.column_definition(dtype=str),
            "_metadata": pw.column_definition(dtype=pw.Json),
        })
        self.embedder = SentenceTransformerEmbedder(
            seed=seed, sub_batch=1024, device=device, encoder_config=encoder_config
        )
        table = pw.io.python.read(CorpusFeed(), schema=schema, autocommit_duration_ms=None)
        self.server = VectorStoreServer(table, embedder=self.embedder, index_factory="ivf")
        self._answered: dict = {}
        answered_lock = threading.Lock()

        class CountingClient(VectorStoreClient):
            """Counts the requests each route answered (every route's answer
            lands in ``pathway_rest_latency_seconds``)."""

            def _post(self, route, data):
                out = super()._post(route, data)
                with answered_lock:
                    slice_._answered[route] = slice_._answered.get(route, 0) + 1
                return out

        self.client_cls = CountingClient
        self.metrics_port = None

    # -- the main path --------------------------------------------------------

    def answered(self) -> dict:
        """Requests answered so far, by route."""
        return dict(self._answered)

    def ingest(self) -> dict:
        """Serve (with the engine's /metrics endpoint on a free port), stream
        the corpus in, wait until /v1/statistics counts it."""
        from pathway_tpu_torch.internals import keys

        keys.KEY_DERIVATION.update(seconds=0.0, keys=0)
        self.metrics_port = free_port()
        os.environ["PATHWAY_MONITORING_HTTP_PORT"] = str(self.metrics_port)
        os.environ.pop("PATHWAY_PROCESS_ID", None)
        t0 = time.perf_counter()
        self.server.run_server(host="127.0.0.1", port=0, threaded=True, with_http_server=True)
        self.client = self.client_cls(url=self.server.webserver.url, timeout=600)
        n = len(self.docs)
        until(lambda: self.client.get_vectorstore_statistics().get("file_count") == n, 0.5,
              "the corpus was not ingested")
        ingest_s = time.perf_counter() - t0
        runner = self.server.runner
        log_ = [(s, rows) for s, rows in runner.commit_log if rows >= self.batch // 2]
        commits = [s for s, _rows in log_]
        stages = self.stage_seconds()
        stages["key_derivation"] = keys.KEY_DERIVATION["seconds"]
        return {
            "docs": n, "ingest_s": ingest_s, "docs_per_s": n / ingest_s,
            "commits": len(commits), "commit_median_s": statistics.median(commits),
            "commit_max_s": max(commits), "commit_log": log_, "stages_s": stages,
            "keys_derived": keys.KEY_DERIVATION["keys"],
        }

    def stage_of(self) -> dict:
        """Each operator's stage: the documents' input, parse/split, the
        chunk embed, the index, or the rest of the engine."""
        from pathway_tpu_torch.engine.evaluators import ExternalIndexEvaluator

        runner = self.server.runner
        store = self.server.store
        first = self.server.docs[0]._node.id
        chunked = store.chunked_docs._node.id
        embed = store.index._index_table._node.id
        out = {}
        for node in runner.graph.nodes:
            nid = node.id
            if nid == first:
                out[nid] = "input"
            elif first < nid <= chunked:
                out[nid] = "parse_split"
            elif nid == embed:
                out[nid] = "embed"
            elif isinstance(runner.evaluators.get(nid), ExternalIndexEvaluator):
                out[nid] = "index"
            else:
                out[nid] = "engine_rest"
        return out

    def columns_of(self, nid: int) -> str:
        """The output columns of operator ``nid`` (names it in a table)."""
        for node in self.server.runner.graph.nodes:
            if node.id == nid:
                cols = node.output.column_names() if node.output is not None else []
                return ",".join(cols)[:48]
        return ""

    def stage_seconds(self) -> dict:
        """Host seconds of the engine's operators so far, by stage, from the
        engine profiler's per-operator totals."""
        out = dict.fromkeys(("input", "parse_split", "embed", "index", "engine_rest"), 0.0)
        stage_of = self.stage_of()
        for (nid, _name, _kind), e in operator_totals().items():
            if nid in stage_of:
                out[stage_of[nid]] += e["seconds"]
        return out

    @property
    def store(self):
        from pathway_tpu_torch.engine.evaluators import ExternalIndexEvaluator

        for ev in self.server.runner.evaluators.values():
            if isinstance(ev, ExternalIndexEvaluator):
                return ev.index.store
        raise RuntimeError("no external index in the graph")

    def text_of(self, key) -> str:
        """The chunk text the index holds under ``key``."""
        from pathway_tpu_torch.internals.keys import pointers_to_keys

        state = self.server.runner.state_of(self.server.store.chunked_docs._node)
        return state.get_row(pointers_to_keys([key]).tobytes())["text"]

    def asks(self, n_requests: int) -> list:
        """The first N_CHECKED: half exact copies, one filter, one glob, the
        rest perturbed; after them exact and perturbed take turns."""
        import numpy as np

        rng = np.random.default_rng(self.seed + 1)
        docs = self.docs
        picks = rng.choice(len(docs), size=n_requests, replace=False).tolist()
        n_exact = N_CHECKED // 2
        out = []
        for j, i in enumerate(picks):
            text = docs[i]["data"]
            if j < n_exact or (j >= N_CHECKED and j % 2 == 0):
                out.append(("exact", i, text, {}))
            elif j == n_exact:
                out.append(("filter", i, perturb(text, rng),
                            {"metadata_filter": f"topic == {docs[i]['_metadata']['topic']}"}))
            elif j == n_exact + 1:
                glob = docs[i]["_metadata"]["path"].rsplit("/", 1)[0] + "/*"
                out.append(("glob", i, perturb(text, rng), {"filepath_globpattern": glob}))
            else:
                out.append(("perturbed", i, perturb(text, rng), {}))
        return out

    def retrieve(self, asks: list) -> dict:
        """The first retrieve (it trains the IVF index and builds its layout),
        then every ask once, timed, then /v1/statistics and /v1/inputs."""
        import numpy as np

        t1 = time.perf_counter()
        self.client.query(asks[0][2], k=10, **asks[0][3])
        first_ms = (time.perf_counter() - t1) * 1e3
        self.client.query(asks[1][2], k=10, **asks[1][3])  # warm-up
        lat, answers = [], []
        for _kind, _i, text, extra in asks:
            t1 = time.perf_counter()
            answers.append(self.client.query(text, k=10, **extra))
            lat.append((time.perf_counter() - t1) * 1e3)
        stats = self.client.get_vectorstore_statistics()
        inputs = self.client.get_input_files()
        n = len(self.docs)
        if stats.get("file_count") != n or len(inputs) != n:
            raise SystemExit(f"statistics/inputs wrong: {stats.get('file_count')} / {len(inputs)}")
        docs = self.docs
        for (kind, i, text, extra), ans in zip(asks, answers):
            # a filter may leave fewer than k of the over-fetched candidates
            want_n = 10 if kind in ("exact", "perturbed") else len(ans)
            if not 1 <= len(ans) == want_n or not all(np.isfinite(a["dist"]) for a in ans):
                raise SystemExit(f"{kind} query {i}: {len(ans)} answers / non-finite dist")
            if kind == "exact" and (ans[0]["text"] != text or abs(ans[0]["dist"] + 1.0) > 1e-3):
                raise SystemExit(f"exact query {i}: top hit {ans[0]['text'][:40]!r} "
                                 f"dist {ans[0]['dist']}")
            if kind == "filter" and any(
                a["metadata"]["topic"] != docs[i]["_metadata"]["topic"] for a in ans
            ):
                raise SystemExit("metadata_filter leaked other topics")
            if kind == "glob" and any(
                not a["metadata"]["path"].startswith(extra["filepath_globpattern"][:-1])
                for a in ans
            ):
                raise SystemExit("filepath_globpattern leaked other paths")
        return {
            "first_retrieve_ms": first_ms, "lat_ms": lat, "answers": answers,
            "p50_ms": statistics.median(lat), "p99_ms": float(np.percentile(lat, 99)),
        }

    def concurrent(self, asks: list, clients: int) -> dict:
        """``clients`` threads send one ``/v1/retrieve`` (k=10) for each ask,
        all at once. Returns the latencies, the wall time, the answers, the
        service's ticks, rows and dedup rows over the phase, the shed
        requests and the highest brownout level seen."""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        from pathway_tpu_torch.engine import telemetry
        from pathway_tpu_torch.engine.brownout import get_brownout

        svc = self.embedder.pipeline.service
        subject = self.server.webserver.subjects["/v1/retrieve"]
        ladder = get_brownout()
        before = svc.stats()
        shed0 = telemetry.stage_snapshot("embed.shed").get("embed.shed", 0.0)
        engages0 = ladder.snapshot()["engages"]
        levels, done = [ladder.level()], threading.Event()

        def watch() -> None:
            while not done.wait(0.002):
                levels.append(ladder.level())

        def one(ask):
            t1 = time.perf_counter()
            ans = self.client.query(ask[2], k=10)
            return (time.perf_counter() - t1) * 1e3, ans

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            done_ = list(pool.map(one, asks))
        wall = time.perf_counter() - t0
        gc_s = GC_PAUSES.within(t0, t0 + wall)
        done.set()
        watcher.join()
        after = svc.stats()
        lat = [t for t, _a in done_]
        ticks = after["svc_ticks"] - before["svc_ticks"]
        rows = after["svc_rows"] - before["svc_rows"]
        return {
            "requests": len(asks), "clients": clients, "wall_s": wall,
            "requests_per_s": len(asks) / wall, "lat_ms": lat, "gc_pauses_s": gc_s,
            "p50_ms": statistics.median(lat), "p99_ms": float(np.percentile(lat, 99)),
            "ticks": ticks, "rows": rows, "rows_per_tick": rows / max(ticks, 1),
            "max_tick_rows": after["svc_max_tick_rows"],
            "dedup_rows": after["svc_dedup_rows"] - before["svc_dedup_rows"],
            # the route's sheds and the coalescer's both count on "embed.shed"
            "shed": int(telemetry.stage_snapshot("embed.shed").get("embed.shed", 0.0) - shed0),
            "route_shed_total": subject.shed_requests,
            "max_brownout_level": max(max(levels), 1 if ladder.snapshot()["engages"] > engages0 else 0),
            "answers": [a for _t, a in done_],
        }

    def semantic(self, texts: list) -> dict:
        """Send ``texts`` (answered before, so cached), then their canonical
        variants (whitespace runs, case): the variants must hit the semantic
        cache, run no forward and get the originals' answers bitwise."""
        pipe = self.embedder.pipeline
        sem = pipe.semantic_cache
        until(lambda: all(sem._canon(t) in sem._data for t in texts), 0.01,
              "the semantic cache was not filled")
        variants = [
            "  " + "   ".join(w.upper() if i % 2 == 0 else w for i, w in enumerate(t.split())) + " \t"
            for t in texts
        ]
        hits0 = sem.stats()["semantic_exact_hits"]
        forwards0 = self.embedder.encoder.dispatches
        rows0 = pipe.service.stats()["svc_rows"]
        originals = [self.client.query(t, k=10) for t in texts]
        answers = [self.client.query(v, k=10) for v in variants]
        return {
            "queries": len(texts),
            "semantic_hits": sem.stats()["semantic_exact_hits"] - hits0,
            "forwards": self.embedder.encoder.dispatches - forwards0,
            "service_rows": pipe.service.stats()["svc_rows"] - rows0,
            "equal_to_original": sum(a == b for a, b in zip(answers, originals)),
            "originals": originals,
            "answers": answers,
        }

    def brownout(self, asks: list) -> dict:
        """Hold the ladder at rung 2 (an occupancy sample of 0.9 before each
        request) and answer ``asks``."""
        from pathway_tpu_torch.engine.brownout import get_brownout

        ladder = get_brownout()
        answers = []
        for _kind, _i, text, _extra in asks:
            ladder.observe_occupancy(0.9)
            if ladder.level() != 2:
                raise SystemExit("brownout rung 2 did not engage")
            answers.append(self.client.query(text, k=10))
            if ladder.level() != 2:
                raise SystemExit("brownout rung 2 released while a request was served")
        return {"answers": answers, "n_probe": self.store._effective_n_probe()}

    def live_wave(self) -> dict:
        """Release the wave; time the first retrieve after its commit (an
        exact copy of a new document: freshness), then check that no removed
        or replaced text is served, that every replaced key's new text comes
        back first for its exact copy, and that /v1/statistics and /v1/inputs
        count the new set."""
        from concurrent.futures import ThreadPoolExecutor

        last_new = max(d["_metadata"]["modified_at"] for d in self.added)
        probe = self.added[0]
        self.wave_go.set()
        until(lambda: self.client.get_vectorstore_statistics().get("last_modified") == last_new,
              0.01, "the live wave was not applied")
        applied_s = time.perf_counter() - self.wave_pushed
        # the wave's commit profile, from the flight recorder's ring (it lands
        # when the commit ends, just after the commit answered the poll)
        from pathway_tpu_torch.engine.profile import get_flight_recorder

        def find_wave():
            ring = get_flight_recorder().payload("wave")["profiles"]
            return next((p for p in reversed(ring) if p["input_rows"] >= 3 * WAVE), None)

        until(lambda: find_wave() is not None, 0.002,
              "the live wave's commit profile was not recorded", timeout_s=60.0)
        wave_profile = find_wave()
        t1 = time.perf_counter()
        ans = self.client.query(probe["data"], k=10)
        first_ms = (time.perf_counter() - t1) * 1e3
        freshness_s = time.perf_counter() - self.wave_pushed
        if ans[0]["text"] != probe["data"] or ans[0]["metadata"]["path"] != probe["_metadata"]["path"]:
            raise SystemExit("a new document's exact copy did not come back first after the wave")
        live_texts = {d["data"] for d in self.docs} - {d["data"] for d in self.removed}
        live_texts -= {old["data"] for old, _new in self.replaced}
        live_texts |= {new["data"] for _old, new in self.replaced} | {d["data"] for d in self.added}
        dead = ({d["data"] for d in self.removed} | {old["data"] for old, _ in self.replaced}) - live_texts
        asks = [(new["data"], new) for _old, new in self.replaced]
        asks += [(d["data"], None) for d in self.removed[:256]]
        asks += [(old["data"], None) for old, _new in self.replaced[:256]]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            answers = list(pool.map(lambda a: self.client.query(a[0], k=10), asks))
        checks_s = time.perf_counter() - t1
        for (text, new), ans in zip(asks, answers):
            served = {a["text"] for a in ans}
            if served & dead:
                raise SystemExit("a removed or replaced text was served after the wave")
            if new is not None and (
                ans[0]["text"] != new["data"] or ans[0]["metadata"] != new["_metadata"]
            ):
                raise SystemExit(f"replaced key {new['_metadata']['path']}: its new text "
                                 "did not come back first")
        stats = self.client.get_vectorstore_statistics()
        inputs = self.client.get_input_files()
        want_paths = {d["_metadata"]["path"] for d in self.docs}
        want_paths -= {d["_metadata"]["path"] for d in self.removed}
        want_paths |= {d["_metadata"]["path"] for d in self.added}
        if stats.get("file_count") != len(want_paths) or {m["path"] for m in inputs} != want_paths \
                or len(inputs) != len(want_paths):
            raise SystemExit(f"statistics/inputs after the wave: {stats.get('file_count')} / "
                             f"{len(inputs)}, expected {len(want_paths)}")
        slowest = max(wave_profile["ops"], key=lambda o: o["seconds"])
        return {
            "removed": len(self.removed), "replaced": len(self.replaced), "added": len(self.added),
            "applied_s": applied_s, "first_retrieve_ms": first_ms, "freshness_s": freshness_s,
            "wave_commit_s": wave_profile["duration_s"],
            "wave_commit_rows": wave_profile["input_rows"],
            "wave_slowest_operator": {k: slowest[k] for k in ("node", "kind", "seconds", "rows")},
            "checked_queries": len(asks), "checks_s": checks_s,
        }

    def close(self) -> None:
        self.stop.set()
        self.server.close()


def key_seconds_per_million(n: int = 1 << 20) -> dict:
    """Host seconds to derive a million keys: flatten's derived keys and the
    connector's primary keys (document paths), through the native module and
    through the numpy path (``PATHWAY_TPU_DISABLE_NATIVE``); both give the
    same keys."""
    import numpy as np

    from pathway_tpu_torch.internals.keys import derived_keys, keys_from_rows, sequential_keys

    parents = sequential_keys(0, n)
    idx = np.zeros(n, dtype=np.int64)
    paths = [(f"/corpus/{i % 16:02d}/doc{i}.txt",) for i in range(n)]
    out, keys = {}, {}
    for path in ("native", "numpy"):
        if path == "numpy":
            os.environ["PATHWAY_TPU_DISABLE_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            flat = derived_keys(parents, idx, "flatten")
            flatten_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            by_path = keys_from_rows(paths)
            paths_s = time.perf_counter() - t0
        finally:
            os.environ.pop("PATHWAY_TPU_DISABLE_NATIVE", None)
        keys[path] = (flat.tobytes(), by_path.tobytes())
        out[path] = {"flatten_s_per_m": flatten_s * (1 << 20) / n,
                     "path_s_per_m": paths_s * (1 << 20) / n}
    if keys["native"] != keys["numpy"]:
        raise SystemExit("the native and numpy key paths derived different keys")
    return out


# -- the native host module ----------------------------------------------------

# the classes of the key indexes and multimaps the engine's operators held,
# by served phase (``record_tables``)
TABLES_SEEN: dict = {}


def record_tables(label: str, runner) -> dict:
    """Count the ``KeyIndex`` / ``MultiMap`` classes held by the runner's
    operators (their state tables, group indexes and join sides). On the card
    every one must be the native module's table."""
    from pathway_tpu_torch.engine.index import KeyIndex, MultiMap

    found: dict = {}

    def visit(obj, depth: int) -> None:
        if isinstance(obj, (KeyIndex, MultiMap)):
            found[type(obj).__name__] = found.get(type(obj).__name__, 0) + 1
            return
        attrs = getattr(obj, "__dict__", None)
        if depth and attrs:
            for name, value in attrs.items():
                if name != "runner":
                    visit(value, depth - 1)

    for evaluator in runner.evaluators.values():
        visit(evaluator, 2)
    TABLES_SEEN[label] = found
    python = {k: v for k, v in found.items() if not k.startswith("_Native")}
    if not found or python:
        raise SystemExit(f"{label}: the engine ran on tables other than the native ones: {found}")
    return found


def native_build(card: str) -> dict:
    """Build and load the native module; the run fails without it."""
    from pathway_tpu_torch import native

    if native.disabled():
        raise SystemExit("PATHWAY_TPU_DISABLE_NATIVE is set: the smoke runs on the native tables")
    native.require_lib()
    info = dict(native.BUILD_INFO)
    log(f"  native module: {os.path.relpath(info['path'])} built in {info['build_s']:.1f}s by "
        f"{info['compiler']}, Python.h {info['python_h']} [{card}]")
    return info


# -- BASELINE config 1: KNNIndex over a static CSV -------------------------------

CONFIG1 = {"docs": 10_000, "queries": 1_000, "dim": 128, "k": 10}


def config1_data(seed: int, tmp: str) -> tuple:
    """The seeded vectors of config 1 and their two CSV files (``doc``,
    ``vec``: the vector as space-separated floats, each printed so that it
    parses back to the same float32)."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    docs = rng.standard_normal((CONFIG1["docs"], CONFIG1["dim"])).astype(np.float32)
    queries = rng.standard_normal((CONFIG1["queries"], CONFIG1["dim"])).astype(np.float32)
    paths = []
    for name, rows in (("docs.csv", docs), ("queries.csv", queries)):
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            f.write("doc,vec\n")
            for i, row in enumerate(rows.tolist()):
                f.write(f"{i}," + " ".join(repr(x) for x in row) + "\n")
        paths.append(path)
    return docs, queries, paths


def config1_check(docs, queries, answers: dict, metric: str) -> dict:
    """Each query's ids and distances against an exact float64 brute force:
    the same ids except near-tie swaps, distances within rtol 1e-5."""
    import numpy as np

    d64, q64 = docs.astype(np.float64), queries.astype(np.float64)
    if metric == "euclidean":
        exact = -(((q64 ** 2).sum(1)[:, None] + (d64 ** 2).sum(1)[None, :]) - 2.0 * q64 @ d64.T)
    else:
        exact = (q64 @ d64.T) / (np.linalg.norm(q64, axis=1)[:, None]
                                 * np.linalg.norm(d64, axis=1)[None, :])
    k = CONFIG1["k"]
    worst, swaps = 0.0, 0
    if len(answers) != len(queries):
        raise SystemExit(f"config 1 ({metric}): {len(answers)} of {len(queries)} queries answered")
    for qi, (ids, dist) in answers.items():
        order = np.argsort(-exact[qi], kind="stable")[:k]
        if len(ids) != k:
            raise SystemExit(f"config 1 ({metric}): query {qi} has {len(ids)} answers")
        got = np.asarray(dist, dtype=np.float64)
        want = exact[qi][order]
        if not np.allclose(got, want, rtol=1e-5, atol=0.0):
            raise SystemExit(f"config 1 ({metric}): query {qi} distances {got} != {want}")
        if not np.allclose(got, exact[qi][list(ids)], rtol=1e-5, atol=0.0):
            raise SystemExit(f"config 1 ({metric}): query {qi} ids carry other distances")
        worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
        if set(ids) != set(order.tolist()):
            # a swap is allowed only among rows tied with the k-th to within the tolerance
            kth = want[-1]
            extra = set(ids) ^ set(order.tolist())
            if not all(np.isclose(exact[qi][j], kth, rtol=1e-5, atol=0.0) for j in extra):
                raise SystemExit(f"config 1 ({metric}): query {qi} ids {ids} != {order.tolist()}")
            swaps += 1
    return {"max_rel_err": worst, "near_tie_swaps": swaps}


def run_config1(torch, args, card: str, device=None) -> dict:
    """BASELINE config 1 on one chip (``device="cpu"`` for a rehearsal): ``pw.io.csv.read(mode="static")`` of the
    seeded CSV files, ``vec`` parsed to arrays, ``KNNIndex(docs.vec, docs,
    n_dimensions=128)`` (exact, euclidean; then cosine),
    ``get_nearest_items(queries.qvec, k=10, with_distances=True)``, ``pw.run``.
    Every query's answer is held against an exact float64 brute force."""
    import tempfile

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.profile import reset_profile
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.io import fs
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.stdlib.ml import KNNIndex

    out: dict = {"card": card, **CONFIG1}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        docs, queries, (docs_csv, queries_csv) = config1_data(args.seed, tmp)
        out["data_s"] = time.perf_counter() - t0
        schema = pw.schema_from_types(doc=int, vec=str)
        t0 = time.perf_counter()
        rows = fs._parse_file(docs_csv, "csv", schema, False)
        parse_s = time.perf_counter() - t0
        os.environ["PATHWAY_TPU_DISABLE_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            py_rows = fs._parse_file(docs_csv, "csv", schema, False)
            py_parse_s = time.perf_counter() - t0
        finally:
            os.environ.pop("PATHWAY_TPU_DISABLE_NATIVE", None)
        if rows != py_rows or len(rows) != CONFIG1["docs"]:
            raise SystemExit("config 1: the native CSV parse disagrees with csv.DictReader")
        out["csv_rows_per_s"] = len(rows) / parse_s
        out["csv_rows_per_s_python"] = len(rows) / py_parse_s
        log(f"  CSV parse of docs.csv ({os.path.getsize(docs_csv)} bytes): native "
            f"{out['csv_rows_per_s']:.0f} rows/s, csv.DictReader {out['csv_rows_per_s_python']:.0f} "
            f"rows/s [{card}]")

        def to_vec(column):
            return pw.apply_with_type(lambda s: np.array(s.split(), dtype=np.float32),
                                      np.ndarray, column)

        for metric in ("euclidean", "cosine"):
            G.clear()
            reset_profile()
            docs_t = pw.io.csv.read(docs_csv, schema=schema, mode="static")
            docs_t = docs_t.select(docs_t.doc, vec=to_vec(docs_t.vec))
            q_t = pw.io.csv.read(queries_csv, schema=schema, mode="static")
            q_t = q_t.select(qid=q_t.doc, qvec=to_vec(q_t.vec))
            knn = KNNIndex(docs_t.vec, docs_t, n_dimensions=CONFIG1["dim"], distance_type=metric,
                           device=device)
            made = []
            inner = knn.index.inner_index
            make = inner._make_index

            def recording(make=make):
                index = make()
                made.append(index)
                return index

            inner._make_index = recording  # to read the store's device after the run
            res = knn.get_nearest_items(q_t.qvec, k=CONFIG1["k"], with_distances=True)
            net: dict = {}

            def on_change(key, row, time, is_addition, net=net):
                item = (int(row["qid"]), tuple(int(x) for x in row["doc"]),
                        tuple(float(x) for x in row["dist"]))
                net[item] = net.get(item, 0) + (1 if is_addition else -1)

            pw.io.subscribe(res, on_change)
            t0 = time.perf_counter()
            pw.run(device=device)
            run_s = time.perf_counter() - t0
            G.clear()
            if len(made) != 1 or made[0].store.device.type != (device or "cuda"):
                raise SystemExit(f"config 1: the index is not on the card ({made})")
            answers = {qid: (ids, dist) for (qid, ids, dist), c in net.items() if c > 0}
            check = config1_check(docs, queries, answers, metric)
            ops = operator_totals()
            index_s = sum(e["seconds"] for (_n, _name, kind), e in ops.items()
                          if kind == "external_index")
            # the index alone at the same shapes: build (10,000 adds and their
            # flush to the card), then the 1,000 queries as one batch
            keys_ = list(range(len(docs)))
            idx = BruteForceKnnIndex(CONFIG1["dim"], metric="l2sq" if metric == "euclidean"
                                     else "cos", device=device)
            sync = torch.cuda.synchronize if device is None else (lambda: None)
            sync()
            t0 = time.perf_counter()
            idx.add_many(keys_, docs)
            idx.build()
            sync()
            build_s = time.perf_counter() - t0
            batch_ms = []
            for _ in range(5):
                sync()
                t0 = time.perf_counter()
                idx.search_many(queries, [CONFIG1["k"]] * len(queries))
                sync()
                batch_ms.append((time.perf_counter() - t0) * 1e3)
            out[metric] = {"pw_run_s": run_s, "index_operator_s": index_s,
                           "index_build_s": build_s, "query_batch_ms": statistics.median(batch_ms),
                           **check}
            log(f"  config 1 ({metric}): {len(answers)} queries answered, index on "
                f"{made[0].store.device.type}, pw.run "
                f"{run_s:.2f} s (index operator {index_s:.2f} s); index alone: build "
                f"{build_s * 1e3:.1f} ms, {len(queries)} queries x k={CONFIG1['k']} in one batch "
                f"{out[metric]['query_batch_ms']:.2f} ms (median of 5); vs float64 brute force: "
                f"max rel err {check['max_rel_err']:.2e}, {check['near_tie_swaps']} near-tie "
                f"swaps [{card}]")
    return out


# -- BASELINE config 4: a streaming index with a tumbling window -------------------

#: Part A: the reference's own config-4 window (``bench.py`` ``bench_streaming_window``)
CONFIG4_WINDOW = {"rows": 200_000, "sensors": 64, "commits": 20, "duration": 50}
#: Part B: streaming files -> embed -> IVF index beside a tumbling window
CONFIG4_STREAM = {"chunks": 32_768, "files": 16, "sources": 64, "late": 64, "window": 100,
                  "delay": 100, "cutoff": 50, "queries": 64, "k": 10}
FS_REFRESH_S = 0.5  # the fs connector's polling interval (``io/fs.py``)


def config4_window_rows(seed: int, sizes: dict) -> list:
    """Part A's stream, as ``bench_streaming_window`` makes it: ``commits``
    commits of equal size, ``t`` in ``[100c, 100c + 100)``, ``sensors``
    sensors, ``value = t % 7`` (as a float), seeded with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    per = sizes["rows"] // sizes["commits"]
    rows = []
    for c in range(sizes["commits"]):
        ts = rng.integers(c * 100, (c + 1) * 100, per)
        sensors = rng.integers(0, sizes["sensors"], per)
        rows.extend((s, t, float(t % 7), 2 * c, 1) for t, s in zip(ts.tolist(), sensors.tolist()))
    return rows


def config4_window(torch, args, card: str, sizes: dict, device=None) -> dict:
    """Part A: ``table_from_rows(is_stream=True)`` → ``windowby(t,
    tumbling(duration=50), instance=sensor)`` → ``reduce(sum, count)`` →
    ``pw.io.subscribe``; the final windows must equal a numpy groupby."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G

    rows = config4_window_rows(args.seed, sizes)
    G.clear()
    schema = pw.schema_builder({"sensor": int, "t": int, "value": float})
    tbl = pw.debug.table_from_rows(schema, rows, is_stream=True)
    win = tbl.windowby(
        tbl.t, window=pw.temporal.tumbling(duration=sizes["duration"]), instance=tbl.sensor
    ).reduce(
        sensor=pw.this._pw_instance,
        start=pw.this._pw_window_start,
        total=pw.reducers.sum(pw.this.value),
        n=pw.reducers.count(),
    )
    final: dict = {}
    updates = [0]

    def on_change(key, row, time, is_addition):
        updates[0] += 1
        if is_addition:
            final[key] = (row["sensor"], row["start"], row["total"], row["n"])
        elif final.get(key, (None,) * 4)[2:] == (row["total"], row["n"]):
            del final[key]

    pw.io.subscribe(win, on_change)
    t0 = time.perf_counter()
    pw.run(device=device)
    run_s = time.perf_counter() - t0
    G.clear()
    arr = np.array([(s, t, v) for s, t, v, _c, _d in rows], dtype=np.float64)
    sensor, t, value = arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64), arr[:, 2]
    start = t // sizes["duration"] * sizes["duration"]
    groups = sensor * (1 << 32) + start
    uniq, inverse = np.unique(groups, return_inverse=True)
    want = {
        (int(g >> 32), int(g & 0xFFFFFFFF)): (float(s), int(n))
        for g, s, n in zip(uniq, np.bincount(inverse, weights=value),
                           np.bincount(inverse))
    }
    got = {(s, st): (float(tot), int(n)) for s, st, tot, n in final.values()}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))[:4]
        raise SystemExit(f"config 4 part A: windows differ from the numpy groupby: {bad}")
    out = {"rows": len(rows), "windows": len(got), "window_updates": updates[0],
           "pw_run_s": run_s, "rows_per_s": len(rows) / run_s}
    log(f"  part A (bench_streaming_window, not cut): {len(rows)} rows in "
        f"{sizes['commits']} commits, {len(got)} windows equal the numpy groupby; "
        f"pw.run {run_s:.2f} s = {out['rows_per_s']:.0f} rows/s, {updates[0]} window "
        f"updates [{card}]")
    return out


def config4_files(docs: list, seed: int, sizes: dict) -> tuple:
    """Part B's files: ``files`` jsonlines files of ``chunks / files`` rows
    (``text``, ``source``, ``t``). File c holds 64 rows two windows late
    (``t`` in window c-2; from c = 2), then 64 rows one window late (window
    c-1; from c = 1), then its on-time rows (window c), whose largest ``t``
    is 100c + 99: when file c arrives, the stream's time has passed every
    two-back row's freeze threshold (100c - 50) and none of the
    previous-window rows' (100c + 50). Returns the files' rows and each row's
    role (0 on time, 1 previous window, 2 two back)."""
    import numpy as np

    rng = np.random.default_rng(seed + 4)
    w, per = sizes["window"], sizes["chunks"] // sizes["files"]
    files, it = [], iter(docs)
    for c in range(sizes["files"]):
        rows, roles = [], []
        for back in (2, 1):
            if c - back < 0:
                continue
            lo = (c - back) * w
            for t in rng.integers(lo, lo + w, sizes["late"]).tolist():
                rows.append({"text": next(it)["data"], "source": int(rng.integers(0, sizes["sources"])),
                             "t": int(t)})
                roles.append(back)
        n_on = per - len(rows)
        ts = rng.integers(c * w, (c + 1) * w, n_on)
        ts[0] = c * w + w - 1
        for j, t in enumerate(ts.tolist()):
            rows.append({"text": next(it)["data"], "source": j % sizes["sources"], "t": int(t)})
            roles.append(0)
        files.append((rows, roles))
    return files


def config4_expected(files: list, sizes: dict) -> dict:
    """(source, window start) → (n, t_max) over the admitted rows of the
    windows that closed (every window but the last file's): all on-time
    rows, the previous-window late rows, none of the two-back rows."""
    want: dict = {}
    last = (len(files) - 1) * sizes["window"]
    for rows, roles in files:
        for row, role in zip(rows, roles):
            if role == 2:
                continue
            start = row["t"] // sizes["window"] * sizes["window"]
            if start >= last:
                continue
            n, tmax = want.get((row["source"], start), (0, -1))
            want[(row["source"], start)] = (n + 1, max(tmax, row["t"]))
    return want


def config4_stream(torch, args, card: str, docs: list, sizes: dict, device=None,
                   encoder_config=None) -> dict:
    """Part B: jsonlines files dropped one by one into a directory that
    ``pw.io.jsonlines.read(mode="streaming")`` polls (the stand-in for
    Kafka) → ``SentenceTransformerEmbedder`` → ``KNNIndex(..., cosine,
    exact=False, approximate="ivf")``, and beside it
    ``windowby(t, tumbling(100), instance=source, common_behavior(delay=100,
    cutoff=50, keep_results=True))``. After the last file, 64 queries through
    ``get_nearest_items_asof_now(k=10)``; then the run is stopped (a
    streaming read never ends)."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import profile as profile_mod
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.ops.knn import topk_lowest_first
    from pathway_tpu_torch.stdlib.ml import KNNIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    clock = time.perf_counter  # the callbacks' ``time`` argument shadows the module
    files = config4_files(docs, args.seed, sizes)
    total = sum(len(rows) for rows, _ in files)
    w = sizes["window"]
    qrng = np.random.default_rng(args.seed + 5)
    picks = qrng.choice(total, sizes["queries"], replace=False)
    all_rows = [row for rows, _ in files for row in rows]
    q_texts = [all_rows[i]["text"] if j % 2 == 0 else perturb(all_rows[i]["text"], qrng)
               for j, i in enumerate(picks.tolist())]

    tmp = tempfile.mkdtemp(prefix="pw_config4_")
    watch, staging = os.path.join(tmp, "watch"), os.path.join(tmp, "staging")
    os.makedirs(watch)
    os.makedirs(staging)
    go, closed_ev, counted_ev, answered_ev = (threading.Event() for _ in range(4))
    state = {"count_at": {}, "answers": {}, "need_close": None, "need_count": 0}
    closes: dict = {}  # window start -> [wall time of each window's callback]
    windows: dict = {}
    lock = threading.Lock()

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self):
            go.wait()
            for qid, text in enumerate(q_texts):
                self.next(qid=qid, text=text)
            self.commit()

    G.clear()
    profile_mod.reset_profile()
    schema = pw.schema_from_types(text=str, source=int, t=int)
    docs_t = pw.io.jsonlines.read(watch, schema=schema, mode="streaming",
                                  autocommit_duration_ms=None, object_pattern="*.jsonl")
    emb = SentenceTransformerEmbedder(seed=args.seed, sub_batch=1024, device=device,
                                      encoder_config=encoder_config)
    docs_v = docs_t.select(docs_t.text, docs_t.source, docs_t.t, vec=emb(docs_t.text))
    knn = KNNIndex(docs_v.vec, docs_v, n_dimensions=emb.get_embedding_dimension(),
                   distance_type="cosine", exact=False, approximate="ivf", device=device)
    made = []
    inner = knn.index.inner_index
    make = inner._make_index

    def recording(make=make):
        index = make()
        made.append(index)
        return index

    inner._make_index = recording  # to read the store after the run
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, text=str),
                                autocommit_duration_ms=None)
    qv = queries.select(queries.qid, qvec=emb(queries.text))
    res = knn.get_nearest_items_asof_now(qv.qvec, k=sizes["k"])
    behavior = pw.temporal.common_behavior(delay=sizes["delay"], cutoff=sizes["cutoff"],
                                           keep_results=True)
    win = docs_t.windowby(
        docs_t.t, window=pw.temporal.tumbling(duration=w), instance=docs_t.source,
        behavior=behavior,
    ).reduce(source=pw.this._pw_instance, start=pw.this._pw_window_start,
             n=pw.reducers.count(), t_max=pw.reducers.max(pw.this.t))
    counted = docs_v.reduce(n=pw.reducers.count())
    texts: dict = {}  # row key -> text, to read the store's slots

    def on_window(key, row, time, is_addition):
        now = clock()
        with lock:
            if is_addition:
                windows[key] = (row["source"], row["start"], row["n"], row["t_max"])
                closes.setdefault(row["start"], []).append(now)
                need = state["need_close"]
                if need is not None and len(closes.get(need, ())) >= sizes["sources"]:
                    closed_ev.set()
            else:
                windows.pop(key, None)

    def on_count(key, row, time, is_addition):
        if is_addition:
            with lock:
                state["count_at"][row["n"]] = clock()
                if row["n"] >= state["need_count"]:
                    counted_ev.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            with lock:
                state["answers"][row["qid"]] = set(row["text"])
                if len(state["answers"]) >= sizes["queries"]:
                    answered_ev.set()

    def on_doc(key, row, time, is_addition):
        if is_addition:
            texts[key] = row["text"]

    pw.io.subscribe(docs_t.select(docs_t.text), on_doc)
    pw.io.subscribe(win, on_window)
    pw.io.subscribe(counted, on_count)
    pw.io.subscribe(res, on_answer)

    commits: list = []
    recorder = profile_mod.get_profiler()
    record = recorder.record_commit

    def recording_commit(profile, record=record):
        commits.append(profile)
        record(profile)

    recorder.record_commit = recording_commit
    runner = GraphRunner(G)
    thread = threading.Thread(target=runner.run, kwargs={"device": device}, daemon=True,
                              name="config4-run")

    def wait_for(event, seconds: float, failure: str) -> None:
        deadline = clock() + seconds
        while not event.wait(0.25):
            if not thread.is_alive() or clock() > deadline:
                raise SystemExit(f"config 4 part B: {failure}")

    _cuda.reset_launch_counts()
    writes = []
    try:
        thread.start()
        for c, (rows, _roles) in enumerate(files):
            with lock:
                closed_ev.clear()
                counted_ev.clear()
                state["need_close"] = (c - 1) * w if c >= 1 else None
                state["need_count"] = sum(len(r) for r, _ in files[: c + 1])
            path = os.path.join(staging, f"part{c:02d}.jsonl")
            with open(path, "w") as f:
                f.write("".join(json.dumps(r) + "\n" for r in rows))
            writes.append(clock())
            os.rename(path, os.path.join(watch, f"part{c:02d}.jsonl"))
            wait_for(counted_ev, 300, f"file {c}'s rows never reached the index")
            if c >= 1:
                wait_for(closed_ev, 300, f"file {c} did not close window {(c - 1) * w}")
        ingest_end = state["count_at"][total]
        go.set()
        wait_for(answered_ev, 300, "the queries were not answered")
        if device is None:
            torch.cuda.synchronize()
        launches = dict(_cuda.KERNEL_LAUNCHES)
    finally:
        runner.stop()
        thread.join(60)
        recorder.record_commit = record
        shutil.rmtree(tmp, ignore_errors=True)
    if thread.is_alive():
        raise SystemExit("config 4 part B: the run did not stop")
    store = made[0].store if made else None
    if store is None or store.device.type != (device or "cuda"):
        raise SystemExit(f"config 4 part B: the index is not on the card ({made})")
    if device is None and launches.get(knn_ivf.SCORE_PAGES, 0) <= 0:
        raise SystemExit("config 4 part B: the query path never launched the score_pages kernel")

    # windows: every window whose threshold passed, against numpy
    want = config4_expected(files, sizes)
    got = {(s, st): (n, tmax) for s, st, n, tmax in windows.values()}
    last_start = (len(files) - 1) * w
    flushed_last = any(st == last_start for _s, st in got)
    got_closed = {k: v for k, v in got.items() if k[1] != last_start}
    if got_closed != want:
        bad = sorted(set(got_closed.items()) ^ set(want.items()))[:4]
        raise SystemExit(f"config 4 part B: windows differ from the numpy groupby: {bad}")
    close_lat = []
    for c in range(1, len(files)):
        stamps = closes.get((c - 1) * w, [])
        if len(stamps) < sizes["sources"]:
            raise SystemExit(f"config 4 part B: window {(c - 1) * w} closed {len(stamps)} times")
        close_lat.append(max(stamps) - writes[c])

    # answers: the served top-10 against the kernel and the plain scorer on
    # the same store; recall@10 against exact search over the same rows
    sync = torch.cuda.synchronize if device is None else (lambda: None)
    qe = emb.embed_queries(q_texts)
    _ks, ki = store._search_device_launch(qe, sizes["k"])
    _ps, pi = store._search_device_launch(qe, sizes["k"], impl="plain")
    sync()
    n_q, k = sizes["queries"], sizes["k"]
    rerun = [{texts[store.key_of[int(s)]] for s in ki[r].tolist()} for r in range(n_q)]
    served = [state["answers"][q] for q in range(n_q)]
    live = torch.from_numpy(np.fromiter(store.slot_of.values(), dtype=np.int64)).to(store.device)
    vecs = store._data[live].float()
    cos = (qe @ vecs.T) / torch.clamp(
        torch.linalg.norm(qe, dim=1)[:, None] * torch.linalg.norm(vecs, dim=1)[None, :], min=1e-30)
    exact = live[topk_lowest_first(cos, k)[1]]
    overlap = lambda a, b: float(np.mean([len(x & y) / k for x, y in zip(a, b)]))  # noqa: E731
    return {
        "files": files, "total": total, "windows_closed": got_closed,
        "flushed_last": flushed_last, "close_lat": close_lat, "writes": writes,
        "ingest_end": ingest_end, "commits": commits, "launches": launches, "store": store,
        "served_vs_rerun": overlap(served, rerun),
        "kernel_vs_plain": overlap([set(ki[r].tolist()) for r in range(n_q)],
                                   [set(pi[r].tolist()) for r in range(n_q)]),
        "recall": overlap([set(ki[r].tolist()) for r in range(n_q)],
                          [set(exact[r].tolist()) for r in range(n_q)]),
    }


def run_config4(torch, args, card: str, docs: list, device=None, encoder_config=None,
                sizes: "dict | None" = None) -> tuple:
    """BASELINE config 4 on one chip (``device="cpu"`` and small ``sizes``
    with a tiny ``encoder_config`` for a rehearsal): Part A, the reference's
    own window at its size; Part B, streaming files → embed → IVF index
    beside a tumbling window with a behavior. Returns the report and the
    page scorer's launches on Part B's path."""
    sizes = sizes or {}
    window_sizes = {**CONFIG4_WINDOW, **sizes.get("window", {})}
    stream_sizes = {**CONFIG4_STREAM, **sizes.get("stream", {})}
    out: dict = {"card": card, "window": config4_window(torch, args, card, window_sizes, device)}
    t0 = time.perf_counter()
    b = config4_stream(torch, args, card, docs, stream_sizes, device, encoder_config)
    stream_s = time.perf_counter() - t0
    gc_pauses = GC_PAUSES.within(t0, t0 + stream_s)
    lat_ms = [x * 1e3 for x in b["close_lat"]]
    docs_per_s = b["total"] / (b["ingest_end"] - b["writes"][0])
    neu = [p for p in b["commits"] if p.neu]
    neu_ops: dict = {}
    for p in b["commits"]:
        for _node, name, kind, seconds, rows, retractions, is_neu in p.ops:
            if is_neu:
                e = neu_ops.setdefault(f"{kind}/{name}", [0.0, 0, 0])
                e[0] += seconds
                e[1] += rows
                e[2] += retractions
    all_s = sum(op[3] for p in b["commits"] for op in p.ops)
    neu_s = sum(e[0] for e in neu_ops.values())
    closed = b["windows_closed"]
    out["stream"] = {
        "chunks": b["total"], "files": len(b["files"]), "windows_checked": len(closed),
        "last_windows_flushed": b["flushed_last"], "docs_per_s": docs_per_s,
        "window_close_ms": {"p50": statistics.median(lat_ms), "max": max(lat_ms),
                            "all": lat_ms, "refresh_interval_ms": FS_REFRESH_S * 1e3},
        "commits": len(b["commits"]), "neu_commits": len(neu), "operator_s": all_s,
        "neu_operator_s": neu_s,
        "neu_ops": {k: {"seconds": v[0], "rows": v[1], "retractions": v[2]}
                    for k, v in sorted(neu_ops.items(), key=lambda kv: -kv[1][0])},
        "served_vs_rerun": b["served_vs_rerun"], "kernel_vs_plain": b["kernel_vs_plain"],
        "recall_at_10": b["recall"], "score_pages_launches": b["launches"].get("score_pages", 0),
        "n_clusters": b["store"].n_clusters, "n_probe": b["store"].n_probe, "phase_s": stream_s,
        "gc_pauses_s": gc_pauses,
    }
    s = out["stream"]
    log(f"  part B: {s['chunks']} chunks in {s['files']} jsonlines files through the fs "
        f"poller (refresh {FS_REFRESH_S} s) → embed → KNNIndex(ivf, cosine) on "
        f"{b['store'].device.type}: {docs_per_s:.0f} docs/s from the first file written to "
        f"the commit that indexed the last chunk [{card}]")
    log(f"  part B windows: {len(closed)} windows whose threshold passed equal the numpy "
        f"groupby over the admitted rows (on-time + previous-window late rows, no two-back "
        f"row); last file's windows flushed: {b['flushed_last']} (the streaming read never "
        f"closes, so the stream never drains; the run was stopped)")
    log(f"  part B window-close latency (file written → last of its {CONFIG4_STREAM['sources']} "
        f"closed windows delivered), {len(lat_ms)} files: p50 {s['window_close_ms']['p50']:.1f} "
        f"ms, max {s['window_close_ms']['max']:.1f} ms (fs refresh interval "
        f"{FS_REFRESH_S * 1e3:.0f} ms); {gc_line(s)} during part B [{card}]")
    log(f"  part B neu phase: {len(neu)} of {len(b['commits'])} commits ran it; operator "
        f"seconds {neu_s:.4f} of {all_s:.3f} [{card}]")
    for name, e in list(s["neu_ops"].items())[:8]:
        log(f"    neu {name:28s} {e['seconds']:9.4f} s {e['rows']:8d} rows "
            f"{e['retractions']:8d} retractions")
    operator_table(None, {}, operator_totals(), len(b["commits"]), "config 4 part B", card)
    log(f"  part B answers: served vs kernel re-run top-10 overlap {b['served_vs_rerun']:.4f}, "
        f"kernel vs plain scorer {b['kernel_vs_plain']:.4f}; recall@10 vs exact search "
        f"{b['recall']:.4f} (n_probe {b['store'].n_probe} of {b['store'].n_clusters} "
        f"clusters); score_pages launches on this path: {s['score_pages_launches']}")
    if b["served_vs_rerun"] < 0.99 or b["kernel_vs_plain"] < 0.99:
        raise SystemExit("config 4 part B: served answers disagree with the scorers")
    return out, s["score_pages_launches"]


def run_slice(torch, args, card: str, docs: list):
    import numpy as np

    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.ops.knn import topk_lowest_first

    sl = Slice(docs, BATCH, args.seed)
    launches, phase_launches = {}, {}

    def read_counts(phase: str) -> None:
        """Read the launch counts of the path just driven into ``launches``."""
        torch.cuda.synchronize()
        phase_launches[phase] = dict(_cuda.KERNEL_LAUNCHES)
        for name, n in _cuda.KERNEL_LAUNCHES.items():
            launches[name] = launches.get(name, 0) + n

    try:
        # before the engine starts: nothing else is on the card, so the
        # reserved memory measures the graph pools
        prewarm = check_prewarm(torch, sl, args.seed, card)
        # main path, part 1: ingest through pw.run, retrieve through rest_connector
        from pathway_tpu_torch.engine.profile import get_profiler, reset_profile

        reset_profile()
        _cuda.reset_launch_counts()
        ingest = sl.ingest()
        store = sl.store
        metrics = {"scrapes": [], "operators": {}}
        metrics["operators"]["ingest"] = operator_table(
            sl, {}, operator_totals(), get_profiler().commits, "ingest", card)
        metrics["shapes"] = {"ingest commit": ring_shape(min_rows=BATCH // 2)}
        metrics["scrapes"].append(check_scrape(
            sl, "after ingest", card, engine=sl.client.get_vectorstore_statistics()["engine"]))
        log(
            f"  ingest: {ingest['docs']} docs in {ingest['ingest_s']:.1f}s = "
            f"{ingest['docs_per_s']:.0f} docs/s through pw.run, {ingest['commits']} commits of "
            f"{BATCH} rows, median commit {ingest['commit_median_s']:.2f}s "
            f"(first {ingest['commit_log'][0][0]:.2f}s, max {ingest['commit_max_s']:.2f}s) [{card}]"
        )
        log("  ingest host seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ingest["stages_s"].items()) + f" ({ingest['keys_derived']} keys)")
        asks = sl.asks(args.requests)
        ret = sl.retrieve(asks)
        read_counts("ingest_and_solo")
        metrics["scrapes"].append(check_scrape(
            sl, "after the solo phase", card, SERVING_HISTOGRAMS,
            sl.client.get_vectorstore_statistics()["engine"]))
        beside_s4("untiered", ingest, ret, card)
        log(f"  first retrieve after ingest (trains the IVF index, builds its layout): "
            f"{ret['first_retrieve_ms']:.1f} ms; {store.n_clusters} clusters, max_pages "
            f"{store._max_pages}, n_probe {store.n_probe} [{card}]")
        log(f"  solo retrieve: {len(ret['lat_ms'])} sequential requests through the encoder "
            f"service, p50 {ret['p50_ms']:.2f} ms, p99 {ret['p99_ms']:.2f} ms, max "
            f"{max(ret['lat_ms']):.2f} ms [{card}]")
        if launches.get(knn_ivf.SCORE_PAGES, 0) <= 0:
            raise SystemExit("the retrieve path never launched the score_pages kernel")
        n_exacts = sum(a[0] == "exact" for a in asks)
        log(f"  exact-copy queries: {n_exacts}/{n_exacts} return their own chunk first, dist ≈ -1")

        # the served queries again, N_CHECKED to a batch (not counted): the
        # kernel vs the plain scorer, every batch IVF vs exact search
        answers = ret["answers"]
        qv = torch.cat([sl.embedder.embed_queries([a[2]]) for a in asks])
        live = torch.from_numpy(np.fromiter(store.slot_of.values(), dtype=np.int64)).cuda()
        vecs = store._data[live].float()
        vnorm = torch.linalg.norm(vecs, dim=1)
        ki, exact_slots = [], []
        for start in range(0, len(asks), N_CHECKED):
            qb = qv[start : start + N_CHECKED]
            ki.append(store._search_device_launch(qb, 10)[1])
            cos = (qb @ vecs.T) / torch.clamp(
                torch.linalg.norm(qb, dim=1)[:, None] * vnorm[None, :], min=1e-30
            )
            exact_slots.append(live[topk_lowest_first(cos, 10)[1]])
        ki, exact_slots = torch.cat(ki), torch.cat(exact_slots)
        _ps, pi = store._search_device_launch(qv[:N_CHECKED], 10, impl="plain")
        overlap = np.mean([
            len(set(ki[r].tolist()) & set(pi[r].tolist())) / 10 for r in range(N_CHECKED)
        ])
        served = [
            {a["text"] for a in ans} for (kind, _i, _t, _e), ans in zip(asks, answers)
            if kind in ("exact", "perturbed")
        ]
        rows_kernel = [
            {sl.text_of(store.key_of[int(s)]) for s in ki[r].tolist()}
            for r, a in enumerate(asks) if a[0] in ("exact", "perturbed")
        ]
        served_same = np.mean([len(a & b) / 10 for a, b in zip(served, rows_kernel)])
        log(f"  kernel vs plain scorer top-10 overlap {overlap:.4f} (first {N_CHECKED} queries); "
            f"served vs re-run {served_same:.4f}")
        if overlap < 0.99 or served_same < 0.99:
            raise SystemExit("kernel and plain scorer disagree on the served queries")
        recalls = [
            len(set(ki[r].tolist()) & set(exact_slots[r].tolist())) / 10 for r in range(len(asks))
        ]
        recall, recall_16 = float(np.mean(recalls)), float(np.mean(recalls[:N_CHECKED]))
        log(f"  recall@10 vs exact search over the same embeddings: {recall:.4f} over "
            f"{len(asks)} queries ({recall_16:.4f} over the first {N_CHECKED}; "
            f"n_probe {store.n_probe} of {store.n_clusters} clusters)")

        # where one request's time goes (not counted): the query embed and the
        # index search each alone beside the whole request
        # index search alone beside the whole request. Each call sends a new
        # text (the caches would answer a repeated one): the request and
        # embed_query take the service path (cache miss, coalescer shim,
        # service tick, graph replay); embed_query_graph is the replay
        # without the service, embed_query_eager the eager forward (no graph)
        one = asks[-1][2]
        fresh = itertools.count()

        def new_text() -> str:
            return f"{one} zq{next(fresh)}"

        enc = sl.embedder.encoder
        q1 = sl.embedder.embed_queries([one])
        t = host_times_ms({
            "request": lambda: sl.client.query(new_text(), k=10),
            "embed_query": lambda: sl.embedder.pipeline.embed_query_rows([new_text()]),
            "embed_query_graph": lambda: enc.encode_device([new_text()]),
            "embed_query_eager": lambda: enc._dispatch(*enc._tokenize([new_text()])),
            "index_search": lambda: store.search_batch(q1, 10),
        })
        retrieve_stages = dict(t, engine_and_http=t["request"] - t["embed_query"] - t["index_search"])
        log("  solo retrieve stages (ms, median of 9, one request): "
            + ", ".join(f"{k} {v:.2f}" for k, v in retrieve_stages.items()) + f" [{card}]")

        # the page scorer alone (not counted) at two shapes of the main path,
        # on the index the requests above searched: a batch of 8 real
        # queries, and one served request (1 query + 7 zero pad rows)
        timed = measure_scorer(torch, knn_ivf, store, qv[:8], "timed batch", card)
        served_rec = measure_scorer(torch, knn_ivf, store, qv[-1:], "served request", card)
        got = timed.pop("scores")
        served_rec.pop("scores")
        topk_ms = cuda_time_ms(lambda: topk_lowest_first(got, 16), 20)
        log(f"  top-16 over the {got.shape[1]} scores per query: {topk_ms:.4f} ms [{card}]")

        # main path, part 2: concurrent retrieve, distinct queries that the
        # solo phase did not send (exact and perturbed kinds only)
        solo_texts = {a[2] for a in asks}
        conc = [a for a in sl.asks(args.requests + args.concurrent + 1024)[N_CHECKED:]
                if a[2] not in solo_texts][: args.concurrent]
        if len(conc) < args.concurrent:
            raise SystemExit("not enough distinct queries for the concurrent phase")
        ops0, commits0 = operator_totals(), get_profiler().commits
        _cuda.reset_launch_counts()
        cc = sl.concurrent(conc, args.clients)
        read_counts("concurrent")
        record_tables("untiered", sl.server.runner)
        metrics["operators"]["concurrent"] = operator_table(
            sl, ops0, operator_totals(), get_profiler().commits - commits0,
            "concurrent retrieve", card, requests=len(conc))
        metrics["shapes"]["concurrent commit"] = ring_shape(min_rows=1)
        metrics["plane_us_per_commit"] = plane_cost(sl, card, "untiered", metrics["shapes"])
        metrics["scrapes"].append(check_scrape(
            sl, "after the concurrent phase", card, SERVING_HISTOGRAMS,
            sl.client.get_vectorstore_statistics()["engine"]))
        if cc["shed"] or cc["route_shed_total"]:
            raise SystemExit(f"the concurrent phase shed {cc['shed']} requests")
        if any(len(a) != 10 or not all(np.isfinite(x["dist"]) for x in a) for a in cc["answers"]):
            raise SystemExit("a concurrent answer has fewer than 10 results or a non-finite dist")
        log(f"  concurrent retrieve: {cc['requests']} distinct requests from {cc['clients']} "
            f"threads in {cc['wall_s']:.2f}s = {cc['requests_per_s']:.1f} requests/s, p50 "
            f"{cc['p50_ms']:.2f} ms, p99 {cc['p99_ms']:.2f} ms [{card}]")
        log(f"  concurrent retrieve: {cc['ticks']} service ticks, {cc['rows']} rows, "
            f"{cc['rows_per_tick']:.2f} rows per tick (max {cc['max_tick_rows']}), dedup_rows "
            f"{cc['dedup_rows']}, shed {cc['shed']}, {gc_line(cc)}, highest brownout level "
            f"{cc['max_brownout_level']}, score_pages launches "
            f"{phase_launches['concurrent'].get(knn_ivf.SCORE_PAGES, 0)}")
        # each answer against the solo answer to its query (not counted):
        # the query embedded alone, searched on the same index
        solo_sets = []
        for start in range(0, len(conc), N_CHECKED):
            part = conc[start : start + N_CHECKED]
            qb = torch.cat([sl.embedder.embed_queries([a[2]]) for a in part])
            for row in store._search_device_launch(qb, 10)[1].tolist():
                solo_sets.append({sl.text_of(store.key_of[int(x)]) for x in row})
        overlaps = [len({x["text"] for x in ans} & want) / 10
                    for ans, want in zip(cc["answers"], solo_sets)]
        conc_overlap = float(np.mean(overlaps))
        log(f"  concurrent vs solo answers: top-10 overlap mean {conc_overlap:.4f}, min "
            f"{min(overlaps):.2f}, {sum(o == 1.0 for o in overlaps)} of {len(overlaps)} identical")
        if conc_overlap < CONCURRENT_OVERLAP:
            raise SystemExit("concurrent answers disagree with the solo answers")

        # main path, part 3: the semantic query cache
        _cuda.reset_launch_counts()
        sem = sl.semantic([a[2] for a in conc[:64]])
        read_counts("semantic")
        sem_vs_conc = sum(a == b for a, b in zip(sem["answers"], cc["answers"][:64]))
        log(f"  semantic cache: {sem['queries']} canonical variants (whitespace runs, case): "
            f"semantic_hits +{sem['semantic_hits']}, encoder forwards +{sem['forwards']}, service "
            f"rows +{sem['service_rows']}, {sem['equal_to_original']} answers bitwise equal to "
            f"the original text's ({sem_vs_conc} also to the concurrent phase's)")
        if (sem["semantic_hits"], sem["forwards"], sem["service_rows"], sem["equal_to_original"]) != (
            sem["queries"], 0, 0, sem["queries"]
        ):
            raise SystemExit("the semantic cache did not answer every variant with the original's answer")

        # main path, part 4: brownout rung 2, forced, on 16 solo queries
        from pathway_tpu_torch.engine.brownout import get_brownout, reset_brownout

        b_asks = asks[N_CHECKED : N_CHECKED + 16]
        _cuda.reset_launch_counts()
        bo = sl.brownout(b_asks)
        read_counts("brownout")
        metrics["brownout_events"] = len(brownout_events("brownout rung 2"))
        if bo["n_probe"] != max(1, store.n_probe >> 1):
            raise SystemExit(f"rung 2 searched with n_probe {bo['n_probe']}, not {store.n_probe} halved")
        # the served answers are the halved search of the same cached rows
        # (not counted), and the scorer holds against its plain version there
        get_brownout().observe_occupancy(0.9)
        pipe = sl.embedder.pipeline
        qb = torch.from_numpy(np.stack([pipe.cache.get(a[2]) for a in b_asks])).cuda()
        sc, slots = store._search_device_launch(qb, 10)
        for r, ans in enumerate(bo["answers"]):
            want = sorted((sl.text_of(store.key_of[int(x)]), -float(v))
                          for x, v in zip(slots[r].tolist(), sc[r].tolist()))
            if sorted((a["text"], a["dist"]) for a in ans) != want:
                raise SystemExit("a rung-2 answer is not the halved search of its query")
        rung2 = measure_scorer(torch, knn_ivf, store, qv[:8], "rung 2 batch", card)
        rung2.pop("scores")
        reset_brownout()
        again = [sl.client.query(a[2], k=10) for a in b_asks]
        solo_answers = ret["answers"][N_CHECKED : N_CHECKED + 16]
        if again != solo_answers:
            raise SystemExit("after reset_brownout the answers are not the rung-0 answers")
        changed = sum(a != b for a, b in zip(bo["answers"], solo_answers))
        log(f"  brownout rung 2: 16 requests answered with n_probe {bo['n_probe']} of "
            f"{store.n_probe} (score_pages launches {phase_launches['brownout'].get(knn_ivf.SCORE_PAGES, 0)}), "
            f"each the halved search of its query; {changed} of 16 answers differ from rung 0; "
            f"after reset_brownout all 16 equal the rung-0 answers; brownout flight events "
            f"{metrics['brownout_events']}")

        # main path, part 5: the live wave
        _cuda.reset_launch_counts()
        wave = sl.live_wave()
        read_counts("live_wave")
        log(f"  live wave: {wave['removed']} removed, {wave['replaced']} replaced, "
            f"{wave['added']} added in one commit ({wave['wave_commit_s']:.2f}s, slowest operator "
            f"node {wave['wave_slowest_operator']['node']} {wave['wave_slowest_operator']['kind']} "
            f"{wave['wave_slowest_operator']['seconds']:.2f}s); applied "
            f"{wave['applied_s']:.2f}s after the push; first retrieve after it "
            f"{wave['first_retrieve_ms']:.1f} ms (rebuilds the IVF layout); freshness "
            f"{wave['freshness_s']:.2f}s [{card}]")
        log(f"  live wave checks: {wave['checked_queries']} exact-copy queries in "
            f"{wave['checks_s']:.1f}s: no removed or replaced text served, every replaced "
            f"key's new text first, statistics and inputs count the new set")
        metrics["flight"] = flight_dump("untiered store", card)
    finally:
        sl.close()
    keys_per_m = key_seconds_per_million()
    log("  key derivation, host seconds per million keys: " + "; ".join(
        f"{path}: flatten {v['flatten_s_per_m']:.2f}, document paths {v['path_s_per_m']:.2f}"
        for path, v in keys_per_m.items()))

    kernel = {
        "name": knn_ivf.SCORE_PAGES,
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/score_pages.cu",
        "replaces": "pathway_tpu/ops/knn_ivf.py:200",
        "launches": int(launches.get(knn_ivf.SCORE_PAGES, 0)),
        "max_abs_err": max(timed["max_abs_err"], served_rec["max_abs_err"]),
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": None,  # no single PyTorch call gathers pages and scores them
        "graph_ms": timed["graph_ms"],
        "served_ms": served_rec["ms"],
        "served_graph_ms": served_rec["graph_ms"],
        "served_bound_ms": served_rec["bound_ms"],
    }
    report = {
        "card": card,
        "chunks": len(docs),
        "batch": BATCH,
        "ingest": ingest,
        "retrieve_ms": ret["lat_ms"],
        "retrieve_p50_ms": ret["p50_ms"],
        "retrieve_p99_ms": ret["p99_ms"],
        "first_retrieve_after_ingest_ms": ret["first_retrieve_ms"],
        "retrieve_stages_ms": retrieve_stages,
        "live_wave": wave,
        "key_seconds_per_million": keys_per_m,
        "topk_ms": topk_ms,
        "recall_at_10": recall,
        "recall_at_10_first_16": recall_16,
        "kernel_vs_plain_overlap": overlap,
        "served_vs_rerun": served_same,
        "n_clusters": store.n_clusters,
        "n_probe": store.n_probe,
        "max_pages": store._max_pages,
        "score_pages_timed_batch": timed,
        "score_pages_served_request": served_rec,
        "score_pages_rung2_batch": rung2,
        "launches": launches,
        "phase_launches": phase_launches,
        "prewarm": prewarm,
        "concurrent": {k: v for k, v in cc.items() if k != "answers"},
        "concurrent_vs_solo_overlap": conc_overlap,
        "semantic": {k: v for k, v in sem.items() if k not in ("answers", "originals")},
        "brownout": {"n_probe": bo["n_probe"], "answers_changed": changed},
        "metrics": metrics,
    }
    return kernel, report

# -- phase 8: the RAG server (hybrid retrieval, adaptive answers) --------------

RAG = {"chunks": 32_768, "batch": 16_384, "sequential": 256, "concurrent": 1_024,
       "clients": 32, "retrieve": 64, "k": 16, "checked": 16, "rerank_k": 5,
       "n0": 2, "factor": 2, "max_iter": 4, "rrf_k": 60}
RERANK_TOL = 1e-3  # reranker score vs np.dot of the encoder's batch embeddings
NOT_FOUND = "No information"


def rag_prompt(question: str, docs) -> str:
    """The smoke's prompt template: the question and each context document's
    path and text, as JSON (the chat below reads it back)."""
    return json.dumps({"question": question,
                       "sources": [[d["metadata"]["path"], d["text"]] for d in docs]})


def rag_chat_answer(content: str) -> str:
    """The smoke chat's reply to a prompt of :func:`rag_prompt`: the path of
    the first source whose text holds the question's marker word (its last
    word), else the not-found reply."""
    prompt = json.loads(content)
    marker = prompt["question"].split()[-1]
    for path, text in prompt["sources"]:
        if marker in text.split():
            return path
    return NOT_FOUND


def make_rag_chat():
    """A deterministic ``BaseChat`` without network: :func:`rag_chat_answer`
    on the last message."""
    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.xpacks.llm.llms import BaseChat

    class RagChat(BaseChat):
        def __init__(self):
            super().__init__()

            def chat(messages, **kwargs):
                if isinstance(messages, Json):
                    messages = messages.value
                return rag_chat_answer(messages[-1]["content"])

            self.func = chat

    return RagChat()


def adaptive_answer(question: str, docs: list, sizes: dict) -> tuple:
    """What ``AdaptiveRAGQuestionAnswerer`` answers over ``docs`` (the
    documents retrieved for the question, in order) with the smoke's chat:
    (answer, rounds asked)."""
    n, answer = sizes["n0"], None
    for r in range(sizes["max_iter"]):
        answer = rag_chat_answer(rag_prompt(question, docs[:n]))
        if answer and NOT_FOUND not in answer:
            return answer, r + 1
        if n >= len(docs):
            return answer, r + 1
        n *= sizes["factor"]
    return answer, sizes["max_iter"]


def rag_questions(docs: list, n: int, seed: int) -> list:
    """``n`` questions: a perturbed chunk (its text drives BM25, its
    embedding IVF) and, as its last word, a marker word drawn from another
    chunk of the same topic, so the chunk whose text holds it sits at some
    rank of the fused list and the adaptive loop runs 1-4 rounds."""
    import numpy as np

    rng = np.random.default_rng(seed + 13)
    by_topic: dict = {}
    for i, d in enumerate(docs):
        by_topic.setdefault(d["_metadata"]["topic"], []).append(i)
    out = []
    for i in rng.choice(len(docs), size=n, replace=False).tolist():
        mates = by_topic[docs[i]["_metadata"]["topic"]]
        j = mates[int(rng.integers(len(mates)))]
        words = docs[j]["data"].split()
        out.append(perturb(docs[i]["data"], rng) + " " + words[int(rng.integers(len(words)))])
    return out


def rrf(lists: list, limit: int, k: float) -> list:
    """The reference's reciprocal-rank fusion of inner (key, score) lists."""
    fused: dict = {}
    for results in lists:
        for rank, (key, _score) in enumerate(results):
            fused[key] = fused.get(key, 0.0) + 1.0 / (k + rank + 1)
    return sorted(fused.items(), key=lambda kv: -kv[1])[:limit]


def run_rag(torch, args, card: str, docs: list, device=None, encoder_config=None,
            sizes: "dict | None" = None) -> tuple:
    """Phase 8: documents → parse / split → encoder → ``HybridIndexFactory(
    [IvfKnnFactory(embedder, COS), TantivyBM25Factory()], k=60)`` in a
    ``DocumentStore`` → ``AdaptiveRAGQuestionAnswerer`` with a deterministic
    chat → ``QARestServer``; traffic, checks, then ``EncoderReranker`` over
    the retrieved pairs. ``device="cpu"`` and small ``sizes`` with a tiny
    ``encoder_config`` rehearse it. Returns (report, score_pages launches on
    the path)."""
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import profile as profile_mod
    from pathway_tpu_torch.engine import telemetry
    from pathway_tpu_torch.internals.keys import pointers_to_keys
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.stdlib.indexing import (
        BruteForceKnnMetricKind,
        HybridIndexFactory,
        IvfKnnFactory,
        TantivyBM25Factory,
    )
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.question_answering import AdaptiveRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.servers import QARestServer

    sz = {**RAG, **(sizes or {})}
    docs = docs[: sz["chunks"]]
    n_docs = len(docs)
    stop = threading.Event()

    class CorpusFeed(pw.io.python.ConnectorSubject):
        def run(self):
            for start in range(0, n_docs, sz["batch"]):
                for doc in docs[start : start + sz["batch"]]:
                    self.next(**doc_row(doc, pw.Json))
                self.commit()
            stop.wait()

    G.clear()
    profile_mod.reset_profile()
    telemetry.stage_reset("eval.async_udf")
    schema = pw.schema_builder({
        "path": pw.column_definition(dtype=str, primary_key=True),
        "data": pw.column_definition(dtype=str),
        "_metadata": pw.column_definition(dtype=pw.Json),
    })
    emb = SentenceTransformerEmbedder(seed=args.seed, sub_batch=1024, device=device,
                                      encoder_config=encoder_config)
    table = pw.io.python.read(CorpusFeed(), schema=schema, autocommit_duration_ms=None)
    factory = HybridIndexFactory(
        [IvfKnnFactory(embedder=emb, metric=BruteForceKnnMetricKind.COS, device=device),
         TantivyBM25Factory()], k=sz["rrf_k"])
    store = DocumentStore(table, retriever_factory=factory)
    # each query surface makes its own index instance; keep them by surface,
    # in the order QARestServer serves them
    surfaces: list = []
    hybrid = store.index.inner_index
    make_factory = hybrid.make_instance_factory

    def recording_factory(make_factory=make_factory):
        made: list = []
        surfaces.append(made)
        make = make_factory()
        return lambda: made.append(make()) or made[-1]

    hybrid.make_instance_factory = recording_factory
    qa = AdaptiveRAGQuestionAnswerer(
        make_rag_chat(), store, n_starting_documents=sz["n0"], factor=sz["factor"],
        max_iterations=sz["max_iter"], prompt_template=rag_prompt)
    server = QARestServer("127.0.0.1", 0, qa)
    answer_at = {"/v1/pw_ai_answer": 0, "/v2/answer": 1, "/v1/retrieve": 2}
    if len(surfaces) != 3:
        raise SystemExit(f"RAG: {len(surfaces)} index surfaces, expected 3")
    url = f"http://127.0.0.1:{server.webserver.port}"

    def post(route: str, payload: dict):
        req = urllib.request.Request(url + route, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    questions = rag_questions(docs, sz["sequential"] + sz["concurrent"] + sz["retrieve"],
                              args.seed)
    seq_q = questions[: sz["sequential"]]
    conc_q = questions[sz["sequential"] : sz["sequential"] + sz["concurrent"]]
    ret_q = questions[sz["sequential"] + sz["concurrent"] :]
    out: dict = {"card": card, "chunks": n_docs, "batch": sz["batch"]}
    sync = torch.cuda.synchronize if device is None else (lambda: None)
    t_phase = time.perf_counter()
    _cuda.reset_launch_counts()
    try:
        # ingest
        t0 = time.perf_counter()
        server.run(threaded=True, device=device)
        until(lambda: post("/v1/statistics", {}).get("file_count") == n_docs, 0.5,
              "RAG: the corpus was not ingested")
        ingest_s = time.perf_counter() - t0
        commits = [s for s, rows in server.runner.commit_log if rows >= sz["batch"] // 2]
        out["ingest"] = {"docs_per_s": n_docs / ingest_s, "ingest_s": ingest_s,
                         "commits": len(commits),
                         "commit_median_s": statistics.median(commits) if commits else None,
                         "gc_pauses_s": GC_PAUSES.within(t0, t0 + ingest_s)}
        ops_ingest = operator_totals()
        async0 = telemetry.stage_snapshot("eval.async_udf")

        # /v2/answer, sequential (the first trains the IVF index: timed apart)
        t1 = time.perf_counter()
        post("/v2/answer", {"prompt": seq_q[0]})
        first_ms = (time.perf_counter() - t1) * 1e3
        served: dict = {}
        lat = []
        t0 = time.perf_counter()
        for q in seq_q:
            t1 = time.perf_counter()
            served[q] = post("/v2/answer", {"prompt": q})
            lat.append((time.perf_counter() - t1) * 1e3)
        seq = {"first_ms": first_ms, "p50_ms": statistics.median(lat),
               "p99_ms": float(np.percentile(lat, 99)), "lat_ms": lat,
               "gc_pauses_s": GC_PAUSES.within(t0, time.perf_counter())}

        # /v2/answer from many clients
        shed = []

        def one(q):
            t1 = time.perf_counter()
            try:
                ans = post("/v2/answer", {"prompt": q})
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    shed.append(q)
                    return None, q
                raise
            return (time.perf_counter() - t1) * 1e3, (q, ans)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(sz["clients"]) as pool:
            done = list(pool.map(one, conc_q))
        wall = time.perf_counter() - t0
        lat_c = [t for t, _ in done if t is not None]
        for _t, qa_pair in done:
            if isinstance(qa_pair, tuple):
                served[qa_pair[0]] = qa_pair[1]
        conc = {"requests": len(conc_q), "clients": sz["clients"], "wall_s": wall,
                "requests_per_s": len(conc_q) / wall, "p50_ms": statistics.median(lat_c),
                "p99_ms": float(np.percentile(lat_c, 99)), "shed": len(shed),
                "route_shed": sum(s.shed_requests for s in server.webserver.subjects.values()),
                "gc_pauses_s": GC_PAUSES.within(t0, t0 + wall)}
        if shed or conc["route_shed"]:
            raise SystemExit(f"RAG: {len(shed)} /v2/answer requests shed ({conc['route_shed']} "
                             f"on the routes' admission)")

        # /v1/retrieve, k=16, and the OpenAPI document
        retrieved = [post("/v1/retrieve", {"query": q, "k": sz["k"]}) for q in ret_q]
        with urllib.request.urlopen(url + "/_schema", timeout=60) as resp:
            schema_doc = json.loads(resp.read())
        sync()
        launches = dict(_cuda.KERNEL_LAUNCHES)
        ops_after = operator_totals()
        async1 = telemetry.stage_snapshot("eval.async_udf")
        traffic_s = time.perf_counter() - t_phase - ingest_s
        # the hybrid instances' seconds in IVF and BM25 (ingest and traffic;
        # read before the checks below search the same instances)
        insts = [i for made in surfaces for i in made]
        split = {"ivf_search_s": sum(i.search_seconds[0] for i in insts),
                 "bm25_search_s": sum(i.search_seconds[1] for i in insts),
                 "ivf_add_s": sum(i.add_seconds[0] for i in insts),
                 "bm25_add_s": sum(i.add_seconds[1] for i in insts)}

        want_paths = {"/v1/pw_ai_answer", "/v2/answer", "/v1/retrieve", "/v2/list_documents",
                      "/v1/statistics"}
        if set(schema_doc.get("paths", {})) != want_paths:
            raise SystemExit(f"RAG: /_schema documents {sorted(schema_doc.get('paths', {}))}")
        if device is None and launches.get(knn_ivf.SCORE_PAGES, 0) <= 0:
            raise SystemExit("RAG: the path never launched the score_pages kernel")

        # the checks, on the index instances that answered (no request in flight)
        state = server.runner.state_of(store.chunked_docs._node)

        def doc_of(key) -> dict:
            row = state.get_row(pointers_to_keys([key]).tobytes())
            meta = row["metadata"].value if hasattr(row["metadata"], "value") else row["metadata"]
            return {"text": row["text"], "metadata": meta}

        answer_inst = surfaces[answer_at["/v2/answer"]]
        retrieve_inst = surfaces[answer_at["/v1/retrieve"]]
        if len(answer_inst) != 1 or len(retrieve_inst) != 1:
            raise SystemExit("RAG: an index surface made more than one instance")
        answer_inst, retrieve_inst = answer_inst[0], retrieve_inst[0]
        ivf, bm25 = retrieve_inst.instances
        # the served query embeddings: the content cache holds each as served
        vecs = emb.pipeline.embed_query_rows(ret_q)
        asked = max(2 * sz["k"], 10)
        kernel_lists = ivf.search_many(vecs, [asked] * len(ret_q), None)
        bm25_lists = [bm25.search(q, asked) for q in ret_q]
        ivf_store = ivf.store
        qmat = torch.from_numpy(np.stack([np.asarray(v, dtype=np.float32) for v in vecs])).to(
            ivf_store.device)
        ps, pslots = ivf_store._search_device_launch(qmat[: sz["checked"]], asked, impl="plain")
        ps, pslots = ps.cpu().numpy(), pslots.cpu().numpy()
        plain_lists = [[(ivf_store.key_of[int(s)], float(v)) for s, v in zip(pslots[r], ps[r])
                        if np.isfinite(v) and int(s) in ivf_store.key_of]
                       for r in range(len(ps))]
        fused_ok, plain_ok, near_tie = 0, 0, 0
        for j, q in enumerate(ret_q):
            got = [(a["text"], a["dist"]) for a in retrieved[j]]
            want = [(doc_of(key)["text"], -score)
                    for key, score in rrf([kernel_lists[j], bm25_lists[j]], sz["k"],
                                          sz["rrf_k"])]
            if got != want:
                raise SystemExit(f"RAG: /v1/retrieve {j} differs from the fusion of its inner "
                                 f"lists: {got[:3]} vs {want[:3]}")
            fused_ok += 1
            if j < sz["checked"]:
                plain = [(doc_of(key)["text"], -score)
                         for key, score in rrf([plain_lists[j], bm25_lists[j]], sz["k"],
                                               sz["rrf_k"])]
                if plain == got:
                    plain_ok += 1
                    continue
                # only a near tie of the two scorers' f32 sums may reorder
                ka = np.array([s for _k, s in kernel_lists[j]])
                pa = np.array([s for _k, s in plain_lists[j]])
                gap = float(np.abs(ka - pa).max()) if len(ka) == len(pa) else np.inf
                if gap > 1e-5:
                    raise SystemExit(f"RAG: /v1/retrieve {j} differs from the fusion of the "
                                     f"plain scorer's list (score gap {gap:.3g})")
                near_tie += 1
        ov = [len({k for k, _ in a} & {k for k, _ in b}) / max(len(b), 1)
              for a, b in zip(kernel_lists[: sz["checked"]], plain_lists)]
        if float(np.mean(ov)) < 0.99:
            raise SystemExit(f"RAG: kernel vs plain IVF lists overlap {np.mean(ov):.4f}")

        # every /v2/answer against the chat over the documents retrieved for it
        asked_q = list(served)
        t0 = time.perf_counter()
        qvecs = emb.pipeline.embed_query_rows(asked_q)
        lists = answer_inst.search_many(list(zip(qvecs, asked_q)), [sz["k"]] * len(asked_q),
                                        None)
        rounds: dict = {}
        for q, hits in zip(asked_q, lists):
            ctx = [doc_of(key) for key, _s in hits]
            want, n_rounds = adaptive_answer(q, ctx, sz)
            if served[q] != want:
                raise SystemExit(f"RAG: /v2/answer {served[q]!r} != the chat over its "
                                 f"documents {want!r}")
            label = str(n_rounds) if want != NOT_FOUND else "not found"
            rounds[label] = rounds.get(label, 0) + 1
        check_s = time.perf_counter() - t0

        # the page scorer at this path's shape: an 8-question batch
        scorer = None
        if device is None:
            scorer = measure_scorer(torch, knn_ivf, ivf_store, qmat[:8], "RAG 8-question batch",
                                    card)
            scorer.pop("scores", None)
    finally:
        stop.set()
        server.close()

    # operators: the index operator's split between IVF and BM25, the async apply's share
    commits_n = sum(1 for _ in server.runner.commit_log)
    ops = operator_table(None, ops_ingest, ops_after, commits_n, "RAG traffic", card,
                         requests=len(served) + len(ret_q))
    op_total = sum(r["seconds"] for r in ops)
    index_s = sum(r["seconds"] for r in ops if r["kind"] == "external_index")
    async_s = async1.get("eval.async_udf_s", 0.0) - async0.get("eval.async_udf_s", 0.0)
    phase_s = time.perf_counter() - t_phase
    out.update({
        "sequential": seq, "concurrent": conc, "rounds": rounds,
        "retrieve_checked": fused_ok, "plain_checked": plain_ok, "plain_near_ties": near_tie,
        "kernel_vs_plain_overlap": float(np.mean(ov)), "answers_checked": len(served),
        "answer_check_s": check_s, "traffic_s": traffic_s, "launches": launches,
        "operators": {"traffic_s": op_total, "index_s": index_s, "async_apply_s": async_s,
                      "index_split_s": split},
        "scorer": scorer, "phase_s": phase_s,
        "gc_pauses_s": GC_PAUSES.within(t_phase, t_phase + phase_s),
    })
    i_ = out["ingest"]
    log(f"  RAG ingest: {n_docs} chunks in commits of {sz['batch']} through "
        f"HybridIndexFactory([IvfKnnFactory(COS), TantivyBM25Factory()], k={sz['rrf_k']}) "
        f"(3 query surfaces, each its own instance): {i_['docs_per_s']:.0f} docs/s "
        f"({i_['ingest_s']:.1f}s, median commit {i_['commit_median_s'] or 0:.2f}s), "
        f"{gc_line(i_)} [{card}]")
    log(f"  RAG /v2/answer sequential ({len(seq_q)}): first {seq['first_ms']:.1f} ms (trains "
        f"IVF), p50 {seq['p50_ms']:.2f} ms, p99 {seq['p99_ms']:.2f} ms, {gc_line(seq)} [{card}]")
    log(f"  RAG /v2/answer concurrent ({conc['requests']} from {conc['clients']} clients): "
        f"{conc['requests_per_s']:.1f} requests/s, p50 {conc['p50_ms']:.1f} ms, p99 "
        f"{conc['p99_ms']:.1f} ms, shed {conc['shed']}, {gc_line(conc)} [{card}]")
    log("  RAG adaptive rounds (answers by rounds asked): " + ", ".join(
        f"{k}: {rounds[k]}" for k in sorted(rounds)))
    log(f"  RAG checks: {fused_ok} /v1/retrieve rankings equal the fusion of their IVF and BM25 "
        f"lists; {plain_ok} of {sz['checked']} equal the fusion with the plain scorer's IVF "
        f"list ({near_tie} near ties); kernel vs plain IVF overlap "
        f"{out['kernel_vs_plain_overlap']:.4f}; {len(served)} /v2/answer equal the chat over "
        f"their documents ({check_s:.1f}s); /_schema documents the 5 routes")
    log(f"  RAG operators, traffic: index {index_s:.3f} s of {op_total:.3f} s; the hybrid "
        f"instances' searches, IVF {split['ivf_search_s']:.3f} s, BM25 "
        f"{split['bm25_search_s']:.3f} s (adds in ingest: IVF {split['ivf_add_s']:.3f} s, BM25 "
        f"{split['bm25_add_s']:.3f} s, over the 3 surfaces); the async apply {async_s:.3f} s "
        f"({async_s / max(op_total, 1e-9):.1%}) [{card}]")
    log(f"  RAG score_pages launches on this path: {launches.get(knn_ivf.SCORE_PAGES, 0)}; "
        f"phase {gc_line(out)}")

    # the reranker over the retrieved pairs
    out["rerank"] = run_rerank(torch, args, card, ret_q, retrieved, device, encoder_config, sz)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, int(launches.get(knn_ivf.SCORE_PAGES, 0))


def run_rerank(torch, args, card: str, questions: list, retrieved: list, device,
               encoder_config, sz: dict) -> dict:
    """The questions x their retrieved documents, flattened, scored by
    ``EncoderReranker`` through the engine, folded back by
    ``rerank_topk_filter``; held against ``np.dot`` of the encoder's batch
    embeddings."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import _capture_table
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker, rerank_topk_filter

    G.clear()
    rr = EncoderReranker(seed=args.seed, device=device, config=encoder_config)
    pairs = [(j, r, a["text"], q) for j, (q, ans) in enumerate(zip(questions, retrieved))
             for r, a in enumerate(ans)]
    t = pw.debug.table_from_rows(
        pw.schema_builder({"qid": int, "rank": int, "doc": str, "query": str}), pairs)
    scored = t.select(t.qid, t.rank, t.doc, score=rr(t.doc, t.query))
    grouped = scored.groupby(scored.qid).reduce(
        scored.qid, docs=pw.reducers.tuple(scored.doc, sort_by=scored.rank),
        scores=pw.reducers.tuple(scored.score, sort_by=scored.rank))
    top = grouped.select(grouped.qid, grouped.docs, grouped.scores,
                         top=rerank_topk_filter(grouped.docs, grouped.scores, k=sz["rerank_k"]))
    t0 = time.perf_counter()
    rows = _capture_table(top, device=device)
    wall = time.perf_counter() - t0
    texts = list(dict.fromkeys([p[2] for p in pairs] + [p[3] for p in pairs]))
    where = {s: i for i, s in enumerate(texts)}
    emb = rr.encoder.encode(texts)
    max_err, swaps = 0.0, 0
    for row in rows.values():
        q = questions[int(row["qid"])]
        want = np.array([float(np.dot(emb[where[d]], emb[where[q]])) for d in row["docs"]])
        got = np.array(row["scores"], dtype=np.float64)
        max_err = max(max_err, float(np.abs(got - want).max()))
        top_docs = set(row["top"][0])
        order = np.argsort(-want)
        want_top = {row["docs"][i] for i in order[: sz["rerank_k"]]}
        if top_docs != want_top:
            edge = want[order[sz["rerank_k"] - 1]] - want[order[sz["rerank_k"]]]
            if edge > RERANK_TOL:
                raise SystemExit(f"RAG rerank: question {row['qid']}'s top {sz['rerank_k']} "
                                 f"differs from np.dot's (margin {edge:.3g})")
            swaps += 1
    if max_err > RERANK_TOL:
        raise SystemExit(f"RAG rerank: scores differ from np.dot by {max_err:.3g}")
    log(f"  RAG rerank: {len(pairs)} (doc, question) pairs through EncoderReranker on "
        f"{rr.encoder.device.type} and rerank_topk_filter(k={sz['rerank_k']}) in {wall:.2f}s; "
        f"max |score - np.dot| {max_err:.2e} (bar {RERANK_TOL}); top {sz['rerank_k']} equal "
        f"np.dot's for {len(rows) - swaps} of {len(rows)} questions ({swaps} near ties) [{card}]")
    return {"pairs": len(pairs), "wall_s": wall, "max_abs_err": max_err, "near_ties": swaps,
            "questions": len(rows)}


# -- phase 5: the tiered int8 store ---------------------------------------------

TIERED_KNOBS = {
    "PATHWAY_IVF_QUANT": "int8",
    "PATHWAY_IVF_HBM_BUDGET_MB": "128",
    "PATHWAY_IVF_RESCORE_K": "64",
    "PATHWAY_IVF_PREFETCH": "on",
}
H100_INT8_OPS = 1979e12  # dense int8 tensor-core ops, H100 SXM data sheet


# -- phase 9: the engine's remaining operators and the stdlib -----------------

OPS = {
    # Part A: the power-law graph (pagerank, bellman_ford) and the planted
    # partition (louvain); cut from 32,768 vertices / 262,144 edges and a
    # 4,096-vertex partition so that phase 9 stays within 45 s (PERF.md §4)
    "vertices": 8_192, "edges": 65_536, "max_weight": 16, "sources": 16,
    "pagerank_steps": 5,
    "louvain_vertices": 2_048, "communities": 256, "intra_degree": 4.0,
    "inter_degree": 0.3, "levels": 2, "iterations": 4,
    # Part B: the event stream; cut from 32,768 events a commit (PERF.md §4)
    "commits": 16, "per_commit": 4_096, "sensors": 4_096, "none_share": 0.10,
    "interp_sensor": 7, "corrected": 64, "correct_after": 12,
    # Part C: deduplicated ingest into the IVF index
    "chunks": 16_384, "batch": 2_048, "redelivered": 0.25, "queries": 64, "k": 10,
    # Part D: pw.sql picks the rows of an IVF index (f32 vectors, no encoder),
    # a row transformer chases pointers over two commits, an error trace. The
    # exact top-k needs every cluster probed, and the store splits a cluster
    # past 1.5x the mean into one more than n_probe: 2 clusters, a split only
    # past 87% of the rows (16 became 20 on these vectors)
    "sql_docs": 32_768, "sql_dim": 384, "sql_cats": 8, "sql_having": 1_000,
    "sql_clusters": 2, "sql_queries": 64,
    "chain_rows": 4_096, "chain_moves": 64, "chain_steps": 8,
}

#: Part D's query: a JOIN with the metadata table, a JOIN with a GROUP BY /
#: HAVING subquery (the categories with many high-score documents) and a WHERE
SQL_SELECT = (
    "SELECT d.doc, d.vec FROM docs d "
    "JOIN meta m ON d.cat = m.cid "
    "JOIN (SELECT cat, COUNT(*) AS n FROM docs WHERE score >= 500 GROUP BY cat "
    "HAVING COUNT(*) > {having}) busy ON d.cat = busy.cat "
    "WHERE d.score BETWEEN 100 AND 899 AND m.tier <> 2"
)


def _power_law_graph(seed: int, sz: dict):
    import numpy as np

    rng = np.random.default_rng(seed + 21)
    nv, ne = sz["vertices"], sz["edges"]
    p = 1.0 / np.arange(1, nv + 1) ** 0.8
    p /= p.sum()
    perm = rng.permutation(nv)  # the heavy vertices are spread over the ids
    u = perm[rng.choice(nv, ne, p=p)]
    v = perm[rng.choice(nv, ne, p=p)]
    w = rng.integers(1, sz["max_weight"] + 1, ne)
    sources = np.sort(rng.choice(nv, sz["sources"], replace=False))
    return u, v, w, sources


def _vertex_index(nv: int) -> dict:
    """Vertex key (hi, lo) -> vertex number, for keys ``pointer_from(i)``."""
    import numpy as np

    from pathway_tpu_torch.internals.keys import keys_from_values

    keys = keys_from_values([np.arange(nv, dtype=np.int64)])
    return {(int(h), int(l)): i for i, (h, l) in enumerate(zip(keys["hi"].tolist(),
                                                              keys["lo"].tolist()))}


def pagerank_numpy(u, v, nv: int, steps: int) -> dict:
    """The integer formulation of ``stdlib/graphs/pagerank.py`` in numpy:
    ranks 6,000, flow ``(rank*5)//(deg*6)``, base 1,000; vertex -> rank for
    every vertex on an edge."""
    import numpy as np

    deg = np.bincount(u, minlength=nv).astype(np.int64)
    has_in = np.bincount(v, minlength=nv) > 0
    on_edge = (deg > 0) | has_in
    ranks = np.full(nv, 6_000, dtype=np.int64)
    for _ in range(steps):
        flow = np.where(deg == 0, 0, (ranks * 5) // np.maximum(deg * 6, 1))
        inflow = np.zeros(nv, dtype=np.int64)
        np.add.at(inflow, v, flow[u])
        ranks = np.where(has_in, inflow + 1_000, 1_000)
    return {int(i): int(ranks[i]) for i in np.nonzero(on_edge)[0]}


def planted_partition(seed: int, sz: dict):
    """Undirected weighted planted partition, both directions listed:
    ``communities`` groups of equal size, ``intra_degree`` / ``inter_degree``
    expected edges per vertex inside / across groups (parallel edges merge
    into one edge of their summed weight)."""
    import numpy as np

    rng = np.random.default_rng(seed + 23)
    n, k = sz["louvain_vertices"], sz["communities"]
    size = n // k
    comm = np.arange(n) // size
    m_in = int(n * sz["intra_degree"] / 2)
    m_out = int(n * sz["inter_degree"] / 2)
    a = rng.integers(0, n, m_in)
    b = comm[a] * size + rng.integers(0, size, m_in)
    a2 = rng.integers(0, n, m_out)
    b2 = rng.integers(0, n, m_out)
    ea, eb = np.concatenate([a, a2]), np.concatenate([b, b2])
    keep = ea != eb
    lo, hi = np.minimum(ea[keep], eb[keep]), np.maximum(ea[keep], eb[keep])
    pair = lo * n + hi
    uniq, counts = np.unique(pair, return_counts=True)
    x, y = uniq // n, uniq % n
    src = np.concatenate([x, y])
    dst = np.concatenate([y, x])
    wt = np.concatenate([counts, counts]).astype(np.float64)
    return src, dst, wt, comm


def modularity_numpy(src, dst, wt, cluster) -> float:
    """``exact_modularity``'s formula in numpy: per cluster (internal * m -
    degree^2) / m^2 over the directed edge list, summed."""
    import numpy as np

    total = float(wt.sum())
    cu, cv = cluster[src], cluster[dst]
    labels, inv = np.unique(cluster, return_inverse=True)
    degree = np.zeros(len(labels))
    np.add.at(degree, np.searchsorted(labels, cu), wt)
    internal = np.zeros(len(labels))
    same = cu == cv
    np.add.at(internal, np.searchsorted(labels, cu[same]), wt[same])
    return float(((internal * total - degree * degree) / (total * total)).sum())


def _capture(pw, table, cols: tuple) -> dict:
    """(key hi, key lo) -> row tuple of ``table``'s current rows, kept by a
    subscriber that takes each commit's batch at once."""
    got: dict = {}

    def on_batch(keys, diffs, columns, time):
        his, los = keys["hi"].tolist(), keys["lo"].tolist()
        rows = zip(*(list(columns[c]) for c in cols))
        for h, lo, d, row in zip(his, los, diffs.tolist(), rows):
            if d > 0:
                got[(h, lo)] = row
            else:
                got.pop((h, lo), None)

    pw.io.subscribe(table, on_batch=on_batch)
    return got


def ops_operators(label: str, card: str, top: int) -> list:
    """Print and return the operator table of the run since the profiler's
    last reset (node ids restart with every graph)."""
    from pathway_tpu_torch.engine.profile import get_profiler

    rows = operator_table(None, {}, operator_totals(), get_profiler().commits, label, card,
                          top=top)
    return [{k: r[k] for k in ("node", "kind", "calls", "rows", "seconds")} for r in rows[:top]]


def ops_graphs(torch, args, card: str, sz: dict, device=None) -> dict:
    """Part A: pagerank and bellman_ford on a seeded power-law graph, louvain
    on a planted partition, each through ``pw.run`` and held exactly against
    numpy / scipy."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.profile import reset_profile
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals import parse_graph as pg
    from pathway_tpu_torch.internals.parse_graph import G

    graphs = pw.stdlib.graphs
    u, v, w, sources = _power_law_graph(args.seed, sz)
    nv = sz["vertices"]
    index = _vertex_index(nv)
    out: dict = {}

    def vertices(is_source=None):
        if is_source is None:
            schema, rows = {"name": int}, [(i,) for i in range(nv)]
        else:
            schema = {"name": int, "is_source": bool}
            rows = [(i, bool(s)) for i, s in enumerate(is_source.tolist())]
        return pw.debug.table_from_rows(pw.schema_builder(schema), rows
                                        ).with_id_from(pw.this.name)

    def vertex_of(key) -> int:
        return index[key]

    # pagerank
    G.clear()
    reset_profile()
    t0 = time.perf_counter()
    V = vertices()
    E = pw.debug.table_from_rows(pw.schema_builder({"a": int, "b": int}),
                                 list(zip(u.tolist(), v.tolist())))
    E = E.select(u=V.pointer_from(E.a), v=V.pointer_from(E.b))
    ranks = _capture(pw, graphs.pagerank(E, steps=sz["pagerank_steps"]), ("rank",))
    pw.run(device=device)
    pr_s = time.perf_counter() - t0
    pr_ops = ops_operators("phase 9 pagerank", card, 6)
    got = {vertex_of(k): r[0] for k, r in ranks.items()}
    want = pagerank_numpy(u, v, nv, sz["pagerank_steps"])
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))[:4]
        raise SystemExit(f"phase 9 part A: pagerank differs from the numpy replay: {bad}")
    out["pagerank"] = {"seconds": pr_s, "vertices": len(got), "iterate_rounds": None,
                       "rank_sum": int(sum(got.values())), "operators": pr_ops}

    # bellman_ford from the sources
    G.clear()
    reset_profile()
    t0 = time.perf_counter()
    is_source = np.zeros(nv, dtype=bool)
    is_source[sources] = True
    V = vertices(is_source)
    E = pw.debug.table_from_rows(pw.schema_builder({"a": int, "b": int, "d": float}),
                                 list(zip(u.tolist(), v.tolist(), w.astype(float).tolist())))
    E = E.select(u=V.pointer_from(E.a), v=V.pointer_from(E.b), dist=E.d)
    dist = _capture(pw, graphs.bellman_ford(V.select(V.is_source), E), ("dist_from_source",))
    runner = GraphRunner(G)
    runner.run(device=device)
    bf_s = time.perf_counter() - t0
    bf_ops = ops_operators("phase 9 bellman_ford", card, 6)
    rounds = [ev.last_rounds for node_id, ev in runner.evaluators.items()
              if isinstance(G.nodes[node_id], pg.IterateNode)]
    got = np.full(nv, -1.0)
    for k, r in dist.items():
        got[vertex_of(k)] = r[0]
    best: dict = {}
    for a, b, c in zip(u.tolist(), v.tolist(), w.tolist()):
        if c < best.get((a, b), 1 << 30):
            best[(a, b)] = c
    pairs = list(best)
    m = csr_matrix(([float(best[p]) for p in pairs], ([p[0] for p in pairs], [p[1] for p in pairs])),
                   shape=(nv, nv))
    want = dijkstra(m, indices=sources, min_only=True)
    if not np.array_equal(got, want):
        bad = np.nonzero(got != want)[0][:4].tolist()
        raise SystemExit("phase 9 part A: bellman_ford differs from scipy's dijkstra at "
                         f"{[(i, got[i], want[i]) for i in bad]}")
    reach = np.isfinite(want)
    out["bellman_ford"] = {"seconds": bf_s, "iterate_rounds": rounds,
                           "reachable": int(reach.sum()), "max_dist": float(want[reach].max()),
                           "operators": bf_ops}

    # louvain on the planted partition
    src, dst, wt, comm = planted_partition(args.seed, sz)
    n = sz["louvain_vertices"]
    lindex = _vertex_index(n)
    G.clear()
    reset_profile()
    t0 = time.perf_counter()
    LV = pw.debug.table_from_rows(pw.schema_builder({"name": int}), [(i,) for i in range(n)]
                                  ).with_id_from(pw.this.name)
    LE = pw.debug.table_from_rows(pw.schema_builder({"a": int, "b": int, "weight": float}),
                                  list(zip(src.tolist(), dst.tolist(), wt.tolist())))
    WE = LE.select(u=LV.pointer_from(LE.a), v=LV.pointer_from(LE.b), weight=LE.weight)
    g = graphs.WeightedGraph.from_vertices_and_weighted_edges(LV.select(), WE)
    clustering = graphs.louvain_communities(g, levels=sz["levels"],
                                            iterations_per_level=sz["iterations"])
    clusters = _capture(pw, clustering, ("c",))
    modularity = _capture(pw, graphs.exact_modularity(g, clustering), ("modularity",))
    pw.run(device=device)
    lv_s = time.perf_counter() - t0
    lv_ops = ops_operators("phase 9 louvain", card, 6)
    label = np.full(n, -1, dtype=np.int64)
    for k, r in clusters.items():
        c = r[0]
        label[lindex[k]] = lindex[(c.hi, c.lo)]
    if (label < 0).any() or len(modularity) != 1:
        raise SystemExit("phase 9 part A: louvain left vertices without a cluster")
    q_engine = next(iter(modularity.values()))[0]
    q_numpy = modularity_numpy(src, dst, wt, label)
    q_planted = modularity_numpy(src, dst, wt, comm)
    if abs(q_engine - q_numpy) > 1e-12:
        raise SystemExit(f"phase 9 part A: exact_modularity {q_engine!r} != numpy's {q_numpy!r}")
    if q_engine < q_planted - 0.05:
        raise SystemExit(f"phase 9 part A: louvain's modularity {q_engine:.4f} is below the "
                         f"planted partition's {q_planted:.4f} minus 0.05")
    out["louvain"] = {"seconds": lv_s, "iterate_rounds": None, "modularity": q_engine,
                      "modularity_numpy": q_numpy, "planted": q_planted,
                      "clusters": int(len(np.unique(label))), "edges": int(len(src)),
                      "operators": lv_ops}
    log(f"  part A: pagerank(steps={sz['pagerank_steps']}) on {nv} vertices / {len(u)} edges "
        f"equals the numpy replay of the integer formulation exactly ({len(ranks)} "
        f"ranks) in {pr_s:.2f} s (unrolled, no iterate) [{card}]")
    log(f"  part A: bellman_ford from {len(sources)} sources equals scipy's dijkstra exactly "
        f"({out['bellman_ford']['reachable']} reachable) in {bf_s:.2f} s, iterate rounds {rounds} "
        f"[{card}]")
    log(f"  part A: louvain_communities(levels={sz['levels']}, iterations={sz['iterations']}) "
        f"on a {n}-vertex planted partition ({sz['communities']} groups, {len(src)} directed "
        f"edges): {out['louvain']['clusters']} clusters, modularity {q_engine:.6f} (numpy "
        f"{q_numpy:.6f}, planted {q_planted:.6f}) in {lv_s:.2f} s (unrolled, no iterate) "
        f"[{card}]")
    return out


def event_stream(seed: int, sz: dict) -> dict:
    """Part B's events: Zipf-skewed sensor ids, integer timestamps out of
    order within blocks of 64, float32 values with ``none_share`` of them
    None, one commit per ``per_commit`` events."""
    import numpy as np

    rng = np.random.default_rng(seed + 27)
    n = sz["commits"] * sz["per_commit"]
    sensor = (rng.zipf(1.3, n) - 1) % sz["sensors"]
    seq = np.arange(n)
    t = (seq // 64) * 64 + np.concatenate([rng.permutation(64) for _ in range(n // 64)])
    value = (rng.normal(size=n) * 2).astype(np.float32)
    missing = rng.random(n) < sz["none_share"]
    return {"eid": seq, "sensor": sensor.astype(np.int64), "t": t.astype(np.int64),
            "value": value, "missing": missing}


def _pred(value: float, t: int) -> bool:
    if t % 1000 == 7:
        raise ValueError(f"predicate refuses t={t}")
    return value > 0


def _ratio(value: float, t: int) -> float:
    if t % 1000 == 13:
        raise ZeroDivisionError(f"no ratio at t={t}")
    return value / 2.0


def event_replay(ev: dict, sz: dict) -> dict:
    """What Part B's pipeline must hold at the end, from the events alone."""
    import numpy as np

    from pathway_tpu_torch.internals.keys import keys_from_values

    known = ~ev["missing"]
    eid, sensor, t = ev["eid"], ev["sensor"], ev["t"]
    val = ev["value"].astype(np.float64)
    keys = keys_from_values([eid])
    ptr = list(zip(keys["hi"].tolist(), keys["lo"].tolist()))
    dedup: dict = {}
    stats: dict = {}
    for i in np.nonzero(known)[0].tolist():
        s, x = int(sensor[i]), float(val[i])
        cur = dedup.get(s)
        if cur is None or abs(x - cur[1]) > 0.5:
            dedup[s] = (int(eid[i]), x)
        st = stats.setdefault(s, {"vals": [], "top": None, "any": None})
        st["vals"].append(x)
        cand = (x, ptr[i])
        if st["top"] is None or cand > st["top"]:
            st["top"] = cand
        a = str(int(eid[i]) % 1000)
        if st["any"] is None or a < st["any"]:
            st["any"] = a
    diffs: dict = {}
    order = np.lexsort((t, sensor))
    prev: dict = {}
    for i in order.tolist():
        if not known[i]:
            continue
        s = int(sensor[i])
        p = prev.get(s)
        diffs[int(eid[i])] = None if p is None else float(val[i]) - p
        prev[s] = float(val[i])
    sub = np.nonzero(sensor == sz["interp_sensor"])[0]
    sub = sub[np.argsort(t[sub], kind="stable")]
    interp: dict = {}
    kv = [(int(t[i]), float(val[i])) if known[i] else None for i in sub.tolist()]
    for j, i in enumerate(sub.tolist()):
        if kv[j] is not None:
            interp[int(eid[i])] = kv[j][1]
            continue
        p = next((kv[q] for q in range(j - 1, -1, -1) if kv[q] is not None), None)
        nx = next((kv[q] for q in range(j + 1, len(kv)) if kv[q] is not None), None)
        tt = int(t[i])
        if p is not None and nx is not None and nx[0] != p[0]:
            interp[int(eid[i])] = p[1] + (nx[1] - p[1]) * (tt - p[0]) / (nx[0] - p[0])
        else:
            interp[int(eid[i])] = p[1] if p is not None else (nx[1] if nx is not None else None)
    fail7 = known & (t % 1000 == 7)
    fail13 = known & (t % 1000 == 13)
    passed = known & ~fail7 & (val > 0)
    return {"dedup": dedup, "stats": stats, "diffs": diffs, "interp": interp,
            "errors": int(fail7.sum() + fail13.sum()), "filtered": int(passed.sum()),
            "clean": int((known & ~fail13).sum())}


def ops_events(torch, args, card: str, sz: dict, device=None) -> dict:
    """Part B: an event stream through deduplicate, sort + ordered.diff,
    interpolate, a groupby with the new reducers, update_cells and
    remove_errors / the error log, held against a numpy replay."""
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.profile import reset_profile
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import segment

    ev = event_stream(args.seed, sz)
    per, n_commits = sz["per_commit"], sz["commits"]
    n = per * n_commits
    rng = np.random.default_rng(args.seed + 29)
    corrected = np.sort(rng.choice(sz["sensors"], sz["corrected"], replace=False))
    late_go = threading.Event()
    cols = [ev["eid"].tolist(), ev["sensor"].tolist(), ev["t"].tolist(),
            [None if m else float(x) for x, m in zip(ev["value"].tolist(), ev["missing"].tolist())]]
    rows = list(zip(*cols))
    pushed: dict = {}

    class EventFeed(pw.io.python.ConnectorSubject):
        def run(self):
            pushed["t0"] = time.perf_counter()
            for c in range(n_commits):
                for eid, s, t, x in rows[c * per:(c + 1) * per]:
                    self.next(eid=eid, sensor=s, zone=s // 64, t=t, value=x)
                self.commit()
                if c + 1 == sz["correct_after"]:
                    late_go.set()
            late_go.set()

    class CorrectionFeed(pw.io.python.ConnectorSubject):
        def run(self):
            late_go.wait()
            for s in corrected.tolist():
                self.next(sensor=s, zone=-1)
            self.commit()

    G.clear()
    schema = pw.schema_builder({
        "eid": pw.column_definition(dtype=int, primary_key=True),
        "sensor": pw.column_definition(dtype=int), "zone": pw.column_definition(dtype=int),
        "t": pw.column_definition(dtype=int), "value": pw.column_definition(dtype=float | None),
    })
    events = pw.io.python.read(EventFeed(), schema=schema, autocommit_duration_ms=None)
    corr = pw.io.python.read(CorrectionFeed(), schema=pw.schema_builder({
        "sensor": pw.column_definition(dtype=int, primary_key=True),
        "zone": pw.column_definition(dtype=int)}), autocommit_duration_ms=None)
    # a missing value reads as None, or as NaN in a batch the engine typed float
    known = events.filter(events.value.is_not_none() & (events.value == events.value))
    dedup = pw.stateful.deduplicate(known, value=known.value, instance=known.sensor,
                                    acceptor=lambda new, old: abs(new - old) > 0.5)
    diffed = pw.ordered.diff(known, known.t, known.value, instance=known.sensor)
    sub = events.filter(events.sensor == sz["interp_sensor"])
    filled = pw.statistical.interpolate(sub, sub.t, sub.value)
    stats = known.groupby(known.sensor).reduce(
        known.sensor, zone=pw.reducers.unique(known.zone), avg=pw.reducers.avg(known.value),
        top=pw.reducers.argmax(known.value), anyone=pw.reducers.any(known.eid % 1000),
        n=pw.reducers.count(), vals=pw.reducers.ndarray(known.value))
    corrected_stats = stats.update_cells(corr.select(corr.zone))
    passed = known.filter(pw.apply_with_type(_pred, bool, known.value, known.t))
    clean = known.select(known.eid, r=pw.apply_with_type(_ratio, float, known.value, known.t)
                         ).remove_errors()
    err_log = pw.global_error_log()
    got = {
        "dedup": _capture(pw, dedup, ("sensor", "eid", "value")),
        "diff": _capture(pw, diffed, ("eid", "diff_value")),
        "interp": _capture(pw, filled, ("eid", "value")),
        "stats": _capture(pw, corrected_stats,
                          ("sensor", "zone", "avg", "top", "anyone", "n", "vals")),
        "passed": _capture(pw, passed, ("eid",)), "clean": _capture(pw, clean, ("eid",)),
        "errors": _capture(pw, err_log, ("operator_id", "message")),
    }
    segment.reset_device_sums()
    reset_profile()
    t0 = time.perf_counter()
    pw.run(device=device, terminate_on_error=False)
    run_s = time.perf_counter() - t0
    operators = ops_operators("phase 9 part B", card, 10)
    feed_s = time.perf_counter() - pushed["t0"]
    device_sums = segment.DEVICE_SUMS

    want = event_replay(ev, sz)
    dd = {r[0]: (r[1], r[2]) for r in got["dedup"].values()}
    if dd != want["dedup"]:
        bad = sorted(set(dd.items()) ^ set(want["dedup"].items()))[:4]
        raise SystemExit(f"phase 9 part B: deduplicate differs from the replay: {bad}")
    df = {r[0]: (None if r[1] is None or r[1] != r[1] else r[1]) for r in got["diff"].values()}
    if df != want["diffs"]:
        bad = [(k, df.get(k), want["diffs"].get(k)) for k in set(df) | set(want["diffs"])
               if df.get(k) != want["diffs"].get(k)][:4]
        raise SystemExit(f"phase 9 part B: ordered.diff differs from the replay: {bad}")
    ip = {r[0]: r[1] for r in got["interp"].values()}
    if ip != want["interp"]:
        bad = [(k, ip.get(k), want["interp"].get(k)) for k in set(ip) | set(want["interp"])
               if ip.get(k) != want["interp"].get(k)][:4]
        raise SystemExit(f"phase 9 part B: interpolate differs from the replay: {bad}")
    stats_got = {r[0]: r for r in got["stats"].values()}
    if set(stats_got) != set(want["stats"]):
        raise SystemExit("phase 9 part B: the groupby's sensors differ from the replay")
    worst_avg = 0.0
    for s, (_s, zone, avg, top, anyone, cnt, vals) in stats_got.items():
        w_ = want["stats"][s]
        want_zone = -1 if s in set(corrected.tolist()) else s // 64
        if (zone != want_zone or cnt != len(w_["vals"]) or (top.hi, top.lo) != w_["top"][1]
                or str(anyone) != w_["any"]
                or not np.array_equal(np.asarray(vals, dtype=np.float64), np.array(w_["vals"]))):
            raise SystemExit(f"phase 9 part B: sensor {s}'s reduced row differs from the replay")
        exact = float(np.mean(w_["vals"]))
        worst_avg = max(worst_avg, abs(avg - exact) / max(abs(exact), 1e-30))
    if worst_avg > 1e-6:
        raise SystemExit(f"phase 9 part B: avg off by rtol {worst_avg:.3g} > 1e-6")
    if len(got["errors"]) != want["errors"]:
        raise SystemExit(f"phase 9 part B: the error log holds {len(got['errors'])} rows, "
                         f"{want['errors']} failing rows expected")
    if len(got["passed"]) != want["filtered"] or len(got["clean"]) != want["clean"]:
        raise SystemExit("phase 9 part B: the filter / remove_errors row counts differ "
                         f"({len(got['passed'])}/{want['filtered']}, "
                         f"{len(got['clean'])}/{want['clean']})")
    out = {"events": n, "run_s": run_s, "feed_s": feed_s, "events_per_s": n / run_s,
           "device_segment_sums": device_sums, "sensors": len(stats_got),
           "dedup_rows": len(dd), "diff_rows": len(df), "interp_rows": len(ip),
           "error_rows": len(got["errors"]), "avg_worst_rtol": worst_avg,
           "operators": operators}
    log(f"  part B: {n} events in {n_commits} commits through deduplicate, sort + "
        f"ordered.diff, interpolate (sensor {sz['interp_sensor']}, {len(ip)} rows), "
        f"groupby(avg, argmax, unique, any, count, ndarray) of {len(stats_got)} sensors, "
        f"update_cells ({len(corrected)} late corrections), filter / remove_errors: every "
        f"output equals the numpy replay (avg within rtol {worst_avg:.2e}); "
        f"{n / run_s:.0f} events/s through pw.run ({run_s:.2f} s) [{card}]")
    log(f"  part B: error log {len(got['errors'])} rows for {want['errors']} failing rows; "
        f"segment sums on the card: {device_sums}")
    return out


def ops_ingest(torch, args, card: str, docs: list, sz: dict, device=None,
               encoder_config=None) -> dict:
    """Part C: chunks delivered, then a quarter re-delivered under the same
    path (new text and a higher version, the same version again, or an
    older one), through ``pw.stateful.deduplicate`` → the encoder →
    ``KNNIndex(ivf, cosine)``; as-of-now queries with the exact text of
    latest versions."""
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.profile import reset_profile
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.stdlib.ml import KNNIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    rng = np.random.default_rng(args.seed + 31)
    docs = docs[: sz["chunks"]]
    n = len(docs)
    latest = {d["_metadata"]["path"]: (1, d["data"]) for d in docs}
    first = [(d["_metadata"]["path"], 1, d["data"]) for d in docs]
    again_idx = rng.choice(n, int(n * sz["redelivered"]), replace=False)
    later: list = []
    for j, i in enumerate(again_idx.tolist()):
        path, _v, text = first[i]
        kind = j % 4
        if kind <= 1:  # new text, a higher version
            new_text = docs[(i + n // 2) % n]["data"] + f" revision{j}"
            later.append((path, 2, new_text))
            latest[path] = (2, new_text)
        elif kind == 2:  # the same delivery again
            later.append((path, 1, text))
        else:  # a stale copy with an older version
            later.append((path, 0, "stale " + text))
    rng.shuffle(later)
    deliveries = first + later
    total = len(deliveries)
    fresh = [p for p, (ver, _t) in latest.items() if ver == 2]
    q_paths = [fresh[i] for i in rng.choice(len(fresh), sz["queries"] // 2, replace=False)]
    q_paths += [p for p in rng.choice(list(latest), sz["queries"] - len(q_paths),
                                      replace=False).tolist()]
    q_texts = [latest[p][1] for p in q_paths]
    counted_ev, answered_ev, go = threading.Event(), threading.Event(), threading.Event()
    state = {"count_at": None, "answers": {}}
    lock = threading.Lock()
    clock = time.perf_counter

    class Deliveries(pw.io.python.ConnectorSubject):
        def run(self):
            state["t0"] = clock()
            for start in range(0, total, sz["batch"]):
                for path, ver, text in deliveries[start:start + sz["batch"]]:
                    self.next(path=path, version=ver, text=text)
                self.commit()

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self):
            go.wait()
            for qid, text in enumerate(q_texts):
                self.next(qid=qid, text=text)
            self.commit()

    G.clear()
    table = pw.io.python.read(Deliveries(), schema=pw.schema_from_types(
        path=str, version=int, text=str), autocommit_duration_ms=None)
    latest_t = pw.stateful.deduplicate(table, value=table.version, instance=table.path,
                                       acceptor=lambda new, old: new > old)
    emb = SentenceTransformerEmbedder(seed=args.seed, sub_batch=1024, device=device,
                                      encoder_config=encoder_config)
    vecs = latest_t.select(latest_t.path, latest_t.version, latest_t.text,
                           vec=emb(latest_t.text))
    knn = KNNIndex(vecs.vec, vecs, n_dimensions=emb.get_embedding_dimension(),
                   distance_type="cosine", exact=False, approximate="ivf", device=device)
    made: list = []
    inner = knn.index.inner_index
    make = inner._make_index

    def recording(make=make):
        index = make()
        made.append(index)
        return index

    inner._make_index = recording
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, text=str),
                                autocommit_duration_ms=None)
    res = knn.get_nearest_items_asof_now(queries.select(queries.qid, qvec=emb(queries.text)).qvec,
                                         k=sz["k"])
    counted = latest_t.reduce(n=pw.reducers.count())
    current: dict = {}

    def on_count(key, row, time, is_addition):
        if is_addition and row["n"] == len(latest):
            with lock:
                state["count_at"] = clock()
            counted_ev.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            with lock:
                state["answers"][row["qid"]] = (list(row["path"]), list(row["version"]))
                if len(state["answers"]) >= sz["queries"]:
                    answered_ev.set()

    path_by_key: dict = {}

    def on_latest(key, row, time, is_addition):
        if is_addition:
            with lock:
                current[row["path"]] = (row["version"], row["text"])
                path_by_key[key] = row["path"]

    def holds_latest() -> bool:
        # the run's thread adds to ``current`` while this one reads it
        with lock:
            got = {p: v for p, (v, _t) in current.items()}
        return got == want_latest

    want_latest = {p: v for p, (v, _t) in latest.items()}

    pw.io.subscribe(counted, on_count)
    pw.io.subscribe(res, on_answer)
    pw.io.subscribe(latest_t, on_latest)
    from pathway_tpu_torch.engine.runner import GraphRunner

    runner = GraphRunner(G)
    thread = threading.Thread(target=runner.run, kwargs={"device": device}, daemon=True,
                              name="ops-ingest-run")

    def wait_for(event, seconds: float, failure: str) -> None:
        deadline = clock() + seconds
        while not event.wait(0.25):
            if not thread.is_alive() or clock() > deadline:
                raise SystemExit(f"phase 9 part C: {failure}")

    _cuda.reset_launch_counts()
    reset_profile()
    try:
        thread.start()
        wait_for(counted_ev, 600, "the deduplicated rows never reached the count")
        # every delivery is in once the last commit's rows are: wait for the
        # dedup output to settle on the latest versions
        deadline = clock() + 120
        while not holds_latest():
            if clock() > deadline or not thread.is_alive():
                raise SystemExit("phase 9 part C: the deduplicated table never held the latest "
                                 "versions")
            time.sleep(0.05)
        ingest_end = clock()
        # the query path replays the encoder service's graphs: let its
        # pre-warm finish, as the serving phases do
        svc = emb.pipeline.service
        if not svc.wait_warm(600.0) or svc.prewarm_error:
            raise SystemExit(f"phase 9 part C: the encoder's pre-warm failed: "
                             f"{svc.prewarm_error}")
        go.set()
        wait_for(answered_ev, 300, "the queries were not answered")
        if device is None:
            torch.cuda.synchronize()
        launches = dict(_cuda.KERNEL_LAUNCHES)
    finally:
        runner.stop()
        thread.join(60)
    if thread.is_alive():
        raise SystemExit("phase 9 part C: the run did not stop")
    operators = ops_operators("phase 9 part C", card, 10)
    store = made[0].store if made else None
    if store is None or store.device.type != (device or "cuda"):
        raise SystemExit(f"phase 9 part C: the index is not on the card ({made})")
    if len(store.slot_of) != len(latest):
        raise SystemExit(f"phase 9 part C: the index holds {len(store.slot_of)} rows, "
                         f"{len(latest)} latest versions expected")
    if device is None and launches.get(knn_ivf.SCORE_PAGES, 0) <= 0:
        raise SystemExit("phase 9 part C: the query path never launched score_pages")
    for qid, path in enumerate(q_paths):
        paths, versions = state["answers"][qid]
        if not paths or paths[0] != path or versions[0] != latest[path][0]:
            raise SystemExit(f"phase 9 part C: query {qid}'s top hit is {paths[:1]} "
                             f"{versions[:1]}, the latest version of {path} expected")
    # each served list against the plain scorer over the deduplicated rows:
    # position by position the same path, or two rows whose exact cosines
    # tie within 1e-5 (a near-tie swap)
    qe = emb.embed_queries(q_texts)
    _ps, pi = store._search_device_launch(qe, sz["k"], impl="plain")
    if device is None:
        torch.cuda.synchronize()
    path_at = {slot: path_by_key[key] for key, slot in store.slot_of.items()}
    slot_at = {path: slot for slot, path in path_at.items()}
    data = store._data.double()
    q64 = qe.double()

    def cosine(q: int, slot: int) -> float:
        x = data[slot]
        return float((q64[q] @ x) / (torch.linalg.norm(q64[q]) * torch.linalg.norm(x)))

    swaps = 0
    for qid in range(sz["queries"]):
        served = state["answers"][qid][0]
        plain = [path_at[s] for s in pi[qid].tolist()]
        if len(served) != len(plain):
            raise SystemExit(f"phase 9 part C: query {qid} served {len(served)} answers, the "
                             f"plain scorer {len(plain)}")
        for j, (a, b) in enumerate(zip(served, plain)):
            if a != b:
                if abs(cosine(qid, slot_at[a]) - cosine(qid, slot_at[b])) > 1e-5:
                    raise SystemExit(f"phase 9 part C: query {qid} position {j}: served {a}, "
                                     f"the plain scorer {b}")
                swaps += 1
    docs_per_s = total / (state["count_at"] - state["t0"])
    out = {"deliveries": total, "latest": len(latest), "fresh_versions": len(fresh),
           "docs_per_s": docs_per_s, "ingest_s": ingest_end - state["t0"],
           "score_pages_launches": launches.get(knn_ivf.SCORE_PAGES, 0),
           "near_tie_swaps": swaps,
           "n_clusters": store.n_clusters, "n_probe": store.n_probe, "operators": operators}
    log(f"  part C: {total} deliveries ({n} chunks, {len(later)} re-delivered: {len(fresh)} "
        f"newer versions, the rest the same or older) → deduplicate(path, version) → embed → "
        f"KNNIndex(ivf, cosine) on {store.device.type}: {len(latest)} rows indexed, "
        f"{docs_per_s:.0f} deliveries/s; {sz['queries']} as-of-now queries: every top hit is "
        f"the latest version, every list equals the plain scorer's over the deduplicated rows "
        f"({swaps} near-tie swaps); "
        f"score_pages launches on this part: {out['score_pages_launches']} [{card}]")
    return out


def sql_data(seed: int, sz: dict) -> dict:
    """Part D's seeded tables: documents with a Zipf-skewed category, a
    score and a unit-free f32 vector; the categories' metadata; queries."""
    import numpy as np

    rng = np.random.default_rng(seed + 41)
    n, c = sz["sql_docs"], sz["sql_cats"]
    share = 1.0 / np.arange(1, c + 1)
    cat = rng.choice(c, n, p=share / share.sum())
    score = rng.integers(0, 1000, n)
    vecs = rng.standard_normal((n, sz["sql_dim"])).astype(np.float32)
    queries = rng.standard_normal((sz["sql_queries"], sz["sql_dim"])).astype(np.float32)
    tier = np.arange(c) % 3
    return {"cat": cat, "score": score, "vecs": vecs, "queries": queries, "tier": tier}


def sql_replay(data: dict, sz: dict) -> list:
    """The documents ``SQL_SELECT`` picks, computed in numpy."""
    import numpy as np

    cat, score = data["cat"], data["score"]
    high = np.bincount(cat[score >= 500], minlength=sz["sql_cats"])
    busy = high > sz["sql_having"]
    keep = busy[cat] & (score >= 100) & (score <= 899) & (data["tier"][cat] != 2)
    return np.nonzero(keep)[0].tolist()


def ops_sql(torch, args, card: str, sz: dict, device=None) -> dict:
    """Part D, first: ``pw.sql`` selects documents, which an IVF
    ``KNNIndex`` (cosine, every cluster probed) indexes; 64 queries."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.profile import reset_profile
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.stdlib.ml import KNNIndex

    t0 = time.perf_counter()
    data = sql_data(args.seed, sz)
    want = sql_replay(data, sz)
    G.clear()
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(doc=int, cat=int, score=int, vec=np.ndarray),
        list(zip(range(sz["sql_docs"]), data["cat"].tolist(), data["score"].tolist(),
                 list(data["vecs"]))),
    )
    meta = pw.debug.table_from_rows(
        pw.schema_from_types(cid=int, label=str, tier=int),
        [(c, f"cat{c}", int(t)) for c, t in enumerate(data["tier"])],
    )
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(qid=int, qvec=np.ndarray), list(enumerate(data["queries"]))
    )
    picked = pw.sql(SQL_SELECT.format(having=sz["sql_having"]), docs=docs, meta=meta)
    knn = KNNIndex(picked.vec, picked, n_dimensions=sz["sql_dim"], distance_type="cosine",
                   exact=False, approximate="ivf", n_clusters=sz["sql_clusters"],
                   n_probe=sz["sql_clusters"], device=device)
    made: list = []
    inner = knn.index.inner_index
    make = inner._make_index

    def recording(make=make):
        index = make()
        made.append(index)
        return index

    inner._make_index = recording
    res = knn.get_nearest_items(queries.qvec, k=sz["k"], with_distances=True)
    selected = _capture(pw, picked, ("doc",))
    net: dict = {}

    def on_answer(key, row, time, is_addition):
        item = (int(row["qid"]), tuple(int(x) for x in row["doc"]),
                tuple(float(x) for x in row["dist"]))
        net[item] = net.get(item, 0) + (1 if is_addition else -1)

    pw.io.subscribe(res, on_answer)
    build_s = time.perf_counter() - t0
    reset_profile()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    GraphRunner(G).run(device=device)
    if device is None:
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _cuda.KERNEL_LAUNCHES.get(knn_ivf.SCORE_PAGES, 0)
    G.clear()
    operators = ops_operators("phase 9 part D (sql)", card, 8)
    got = sorted(row[0] for row in selected.values())
    if got != want:
        raise SystemExit(f"phase 9 part D: pw.sql selected {len(got)} documents, the replay "
                         f"{len(want)} (first difference at "
                         f"{next(i for i, (a, b) in enumerate(zip(got + [-1], want + [-1])) if a != b)})")
    if len(made) != 1 or made[0].store.device.type != (device or "cuda"):
        raise SystemExit(f"phase 9 part D: the index is not on the card ({made})")
    store = made[0].store
    if store.n_probe != store.n_clusters:
        raise SystemExit(f"phase 9 part D: {store.n_probe} of {store.n_clusters} clusters probed "
                         "(a split): the answers cannot be the exact top-k")
    if device is None and launches <= 0:
        raise SystemExit("phase 9 part D: the query path never launched score_pages")
    answers = {qid: (ids, dist) for (qid, ids, dist), c in net.items() if c > 0}
    if sorted(answers) != list(range(sz["sql_queries"])):
        raise SystemExit(f"phase 9 part D: {len(answers)} of {sz['sql_queries']} queries answered")
    d64 = data["vecs"][want].astype(np.float64)
    q64 = data["queries"].astype(np.float64)
    exact = (q64 @ d64.T) / (np.linalg.norm(q64, axis=1)[:, None] * np.linalg.norm(d64, axis=1)[None, :])
    col = {doc: j for j, doc in enumerate(want)}
    swaps, worst = 0, 0.0
    for qid, (ids, dist) in answers.items():
        order = np.argsort(-exact[qid], kind="stable")[: sz["k"]]
        if len(ids) != sz["k"]:
            raise SystemExit(f"phase 9 part D: query {qid} has {len(ids)} answers")
        for j, (a, b) in enumerate(zip(ids, (want[i] for i in order))):
            if a != b:
                # part C's allowance: two rows whose exact cosines tie within 1e-5
                if a not in col or abs(exact[qid, col[a]] - exact[qid, col[b]]) > 1e-5:
                    raise SystemExit(f"phase 9 part D: query {qid} position {j}: served {a}, the "
                                     f"float64 brute force {b}")
                swaps += 1
        worst = max(worst, max(abs(d - exact[qid, col[a]]) for a, d in zip(ids, dist)))
    out = {"docs": sz["sql_docs"], "selected": len(want), "dim": sz["sql_dim"],
           "n_clusters": store.n_clusters, "n_probe": store.n_probe,
           "build_s": build_s, "run_s": run_s, "score_pages_launches": launches,
           "near_tie_swaps": swaps, "max_abs_err": float(worst), "operators": operators}
    log(f"  part D (sql): {sz['sql_docs']} x {sz['sql_dim']} documents, {sz['sql_cats']} "
        f"categories → pw.sql (JOIN, JOIN a GROUP BY / HAVING subquery, WHERE) selected "
        f"{len(want)} = the numpy replay → KNNIndex(ivf, cosine, {store.n_probe} of "
        f"{store.n_clusters} clusters probed) on {store.device.type}; "
        f"{sz['sql_queries']} queries x k={sz['k']} = float64 brute force ({swaps} near-tie "
        f"swaps, cosine within {worst:.2e}); graph build {build_s:.2f} s, pw.run {run_s:.2f} s; "
        f"score_pages launches: {launches} [{card}]")
    return out


def chain_data(seed: int, sz: dict) -> tuple:
    """Part D's list: ``chain_rows`` nodes (a random successor, a value)
    and as many requests (a start, 0 to ``chain_steps`` steps); the second
    commit re-points ``chain_moves`` nodes."""
    import numpy as np

    rng = np.random.default_rng(seed + 43)
    n = sz["chain_rows"]
    nxt = rng.integers(0, n, n)
    vals = rng.integers(0, 1 << 30, n)
    starts = rng.integers(0, n, n)
    steps = rng.integers(0, sz["chain_steps"] + 1, n)
    moved = rng.choice(n, sz["chain_moves"], replace=False)
    new_nxt = nxt.copy()
    new_nxt[moved] = rng.integers(0, n, len(moved))
    nodes = [(i, int(nxt[i]), int(vals[i]), 0, 1) for i in range(n)]
    for i in moved.tolist():
        nodes += [(i, int(nxt[i]), int(vals[i]), 2, -1), (i, int(new_nxt[i]), int(vals[i]), 2, 1)]
    reqs = [(r, int(starts[r]), int(steps[r]), 0, 1) for r in range(n)]

    def walk(succ) -> dict:
        out = {}
        for r in range(n):
            node = int(starts[r])
            for _ in range(int(steps[r])):
                node = int(succ[node])
            out[r] = int(vals[node])
        return out

    return nodes, reqs, walk(nxt), walk(new_nxt)


def ops_transformer(torch, args, card: str, sz: dict, device=None) -> dict:
    """Part D, second: a ``@pw.transformer`` list traversal over two commits."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G

    nodes, reqs, first, second = chain_data(args.seed, sz)
    evaluated = [0]

    @pw.transformer
    class list_traversal:
        class nodes(pw.ClassArg):
            next = pw.input_attribute()
            val = pw.input_attribute()

        class requests(pw.ClassArg):
            r = pw.input_attribute()
            node = pw.input_attribute()
            steps = pw.input_attribute()

            @pw.output_attribute
            def rid(self) -> int:
                return self.r

            @pw.output_attribute
            def reached_value(self) -> int:
                evaluated[0] += 1
                node = self.transformer.nodes[self.node]
                for _ in range(self.steps):
                    node = self.transformer.nodes[node.next]
                return node.val

    G.clear()
    node_t = pw.debug.table_from_rows(pw.schema_from_types(i=int, nxt=int, val=int), nodes,
                                      is_stream=True)
    req_t = pw.debug.table_from_rows(pw.schema_from_types(r=int, start=int, steps=int), reqs,
                                     is_stream=True)
    keyed = node_t.with_id_from(node_t.i)
    chain = keyed.select(next=keyed.pointer_from(keyed.nxt), val=keyed.val)
    asks = req_t.select(req_t.r, node=chain.pointer_from(req_t.start), steps=req_t.steps)
    out = list_traversal(chain, asks).requests
    updates: list = []
    pw.io.subscribe(out, lambda key, row, time, is_addition: updates.append(
        (time, row["rid"], row["reached_value"], 1 if is_addition else -1)))
    t0 = time.perf_counter()
    GraphRunner(G).run(device=device)
    run_s = time.perf_counter() - t0
    G.clear()
    times = sorted({u[0] for u in updates})
    if len(times) != 2:
        raise SystemExit(f"phase 9 part D: the transformer's output changed at {len(times)} "
                         "times, 2 expected")
    state: dict = {}
    for t, want in zip(times, (first, second)):
        for _t, r, v, d in (u for u in updates if u[0] == t):
            if d > 0:
                state[r] = v
            elif state.pop(r, None) != v:
                raise SystemExit(f"phase 9 part D: request {r} retracted {v}, not its value")
        if state != want:
            bad = sorted(r for r in want if state.get(r) != want[r])
            raise SystemExit(f"phase 9 part D: the transformer disagrees with the replay on "
                             f"{len(bad)} requests (first {bad[:5]})")
    changed = sum(first[r] != second[r] for r in first)
    second_updates = sum(1 for u in updates if u[0] == times[1])
    if second_updates != 2 * changed:
        raise SystemExit(f"phase 9 part D: the second commit emitted {second_updates} updates, "
                         f"{2 * changed} expected (the {changed} requests whose value changed)")
    n = sz["chain_rows"]
    out = {"rows": n, "moved": sz["chain_moves"], "changed": changed,
           "evaluated": evaluated[0], "re_evaluated": evaluated[0] - n, "run_s": run_s}
    log(f"  part D (transformer): {n} nodes, {n} requests of 0-{sz['chain_steps']} steps, then "
        f"{sz['chain_moves']} nodes re-pointed: both commits equal the replay; the second "
        f"re-evaluated {out['re_evaluated']} requests and changed {changed}; pw.run "
        f"{run_s:.2f} s [{card}]")
    return out


def ops_trace(card: str, device=None) -> dict:
    """Part D, last: a failing UDF's error names this file and line."""
    import inspect

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.trace import EngineErrorWithTrace

    def invert(a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("no inverse of 0")
        return 1 // a

    G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,), (0,)])
    line = inspect.currentframe().f_lineno + 1  # the next line builds the failing operator
    bad = t.select(q=pw.apply_with_type(invert, int, t.a))
    try:
        pw.debug.compute_and_print(bad, device=device)
    except EngineErrorWithTrace as exc:
        message = str(exc)
    else:
        raise SystemExit("phase 9 part D: the failing UDF raised nothing")
    finally:
        G.clear()
    where = f"{os.path.basename(__file__)}:{line}"
    if where not in message or "ZeroDivisionError: no inverse of 0" not in message:
        raise SystemExit(f"phase 9 part D: the error trace does not name {where}: {message!r}")
    log(f"  part D (trace): the failing UDF raised EngineErrorWithTrace naming {where} [{card}]")
    return {"trace": message.splitlines()[1]}


def ops_sql_transformer(torch, args, card: str, sz: dict, device=None) -> dict:
    """Part D: ``pw.sql`` into the IVF index, a row transformer, an error trace."""
    t0 = time.perf_counter()
    out = {"sql": ops_sql(torch, args, card, sz, device),
           "transformer": ops_transformer(torch, args, card, sz, device),
           "trace": ops_trace(card, device)}
    out["seconds"] = time.perf_counter() - t0
    return out


#: Part E: the first 16,384 chunks (part C's size) in 16 explicit commits of
#: 1,024 through an AsyncTransformer (instance: the topic) into the encoder
#: and the IVF index; a 17th commit removes 512 rows of the first four.
#: ``sleep_s`` stands in for an API call's round trip; a seeded 1/128 of the
#: rows fail on every attempt, another 1/64 on the first attempt only.
ASYNC = {"chunks": 16_384, "commits": 16, "removed": 512, "removed_from": 4,
         "sleep_s": 0.002, "capacity": 128, "max_retries": 2, "delay_ms": 1,
         "always_fail": 128, "first_fail": 64, "hits": 64, "misses": 16, "k": 10,
         "cosine": 0.999}


def clean_text(text: str) -> str:
    return " ".join(text.split())


def async_data(docs: list, seed: int, sz: dict) -> dict:
    """Part E's rows (cid, text, topic), each row's commit, the removals and
    the seeded failures."""
    import numpy as np

    rng = np.random.default_rng(seed + 53)
    n = sz["chunks"]
    per = n // sz["commits"]
    rows = [(i, docs[i]["data"], docs[i]["_metadata"]["topic"]) for i in range(n)]
    removed = sorted(rng.choice(per * sz["removed_from"], sz["removed"], replace=False).tolist())
    order = rng.permutation(n).tolist()
    n_always, n_first = n // sz["always_fail"], n // sz["first_fail"]
    return {"rows": rows, "per": per, "removed": removed,
            "always": set(order[:n_always]), "first": set(order[n_always:n_always + n_first])}


def async_replay(data: dict) -> tuple:
    """(successful {cid: (text, topic)}, failed cids) after every commit: a
    (topic, commit) group holding an always-failing row fails as a whole,
    and a removed row leaves both tables."""
    per = data["per"]
    poisoned = {(data["rows"][cid][2], cid // per) for cid in data["always"]}
    gone = set(data["removed"])
    ok, failed = {}, set()
    for cid, text, topic in data["rows"]:
        if cid in gone:
            continue
        if (topic, cid // per) in poisoned:
            failed.add(cid)
        else:
            ok[cid] = (clean_text(text), topic)
    return ok, failed


def ops_async(torch, args, card: str, docs: list, sz: dict, device=None,
              encoder_config=None) -> dict:
    """Part E: chunks → python connector (explicit commits) →
    ``AsyncTransformer`` (instance, capacity, retries) → ``.successful`` →
    the encoder → ``KNNIndex(ivf, cosine)`` → as-of-now queries. The run is
    not stopped: it ends by itself once the queries' source closes, the
    transformer's input hears the end and its loop-back source closes."""
    import asyncio
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.profile import reset_profile
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.stdlib.ml import KNNIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    data = async_data(docs, args.seed, sz)
    want_ok, want_failed = async_replay(data)
    rows, per, removed = data["rows"], data["per"], data["removed"]
    rng = np.random.default_rng(args.seed + 59)
    hits = rng.choice(sorted(want_ok), sz["hits"], replace=False).tolist()
    absent = sorted(want_failed)[: sz["misses"] // 2]
    absent += removed[: sz["misses"] - len(absent)]
    q_cids = hits + absent
    q_texts = [clean_text(rows[cid][1]) for cid in q_cids]
    clock = time.perf_counter
    lock = threading.Lock()
    # written by the transformer's invocations, all on its loop's thread
    calls = {"attempts": {}, "in_flight": 0, "peak": 0, "invocations": 0, "last_done": 0.0}
    state = {"cid_of": {}, "ok": {}, "failed": set(), "texts": {}, "answers": {},
             "ok_end_at": None, "ok_rows_at_end": None, "error": None}
    answered, go = threading.Event(), threading.Event()

    class Chunks(pw.io.python.ConnectorSubject):
        def run(self):
            state["t0"] = clock()
            for c in range(sz["commits"]):
                for cid, text, topic in rows[c * per:(c + 1) * per]:
                    self.next(cid=cid, text=text, topic=topic)
                self.commit()
            for cid in removed:
                _cid, text, topic = rows[cid]
                self._remove({"cid": cid, "text": text, "topic": topic})
            self.commit()

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self):
            go.wait()
            for qid, text in enumerate(q_texts):
                self.next(qid=qid, text=text)
            self.commit()

    class Cleaned(pw.Schema):
        text: str
        topic: int

    class Clean(pw.AsyncTransformer, output_schema=Cleaned):
        async def invoke(self, cid: int, text: str, topic: int) -> dict:
            calls["invocations"] += 1
            calls["in_flight"] += 1
            calls["peak"] = max(calls["peak"], calls["in_flight"])
            attempt = calls["attempts"][cid] = calls["attempts"].get(cid, 0) + 1
            try:
                await asyncio.sleep(sz["sleep_s"])  # the API call's round trip
                if cid in data["always"] or (cid in data["first"] and attempt == 1):
                    raise RuntimeError(f"chunk {cid}: the service failed")
                return {"text": clean_text(text), "topic": topic}
            finally:
                calls["in_flight"] -= 1
                calls["last_done"] = clock()

    G.clear()
    schema = pw.schema_builder({
        "cid": pw.column_definition(dtype=int, primary_key=True),
        "text": pw.column_definition(dtype=str),
        "topic": pw.column_definition(dtype=int),
    })
    chunks = pw.io.python.read(Chunks(), schema=schema, autocommit_duration_ms=None)
    transformer = Clean(input_table=chunks, instance=chunks.topic).with_options(
        capacity=sz["capacity"],
        retry_strategy=pw.udfs.FixedDelayRetryStrategy(max_retries=sz["max_retries"],
                                                       delay_ms=sz["delay_ms"]))
    ok = transformer.successful
    emb = SentenceTransformerEmbedder(seed=args.seed, sub_batch=1024, device=device,
                                      encoder_config=encoder_config)
    vecs = ok.select(ok.text, ok.topic, vec=emb(ok.text))
    knn = KNNIndex(vecs.vec, vecs, n_dimensions=emb.get_embedding_dimension(),
                   distance_type="cosine", exact=False, approximate="ivf", device=device)
    made: list = []
    inner = knn.index.inner_index
    make = inner._make_index

    def recording(make=make):
        index = make()
        made.append(index)
        return index

    inner._make_index = recording
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, text=str),
                                autocommit_duration_ms=None)
    res = knn.get_nearest_items_asof_now(queries.select(queries.qid, qvec=emb(queries.text)).qvec,
                                         k=sz["k"])

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            with lock:
                state["cid_of"][key] = row["cid"]

    def on_ok(key, row, time, is_addition):
        with lock:
            if is_addition:
                state["ok"][key] = (row["text"], row["topic"])
            else:
                state["ok"].pop(key, None)

    def on_ok_end():
        with lock:
            state["ok_end_at"] = clock()
            state["ok_rows_at_end"] = len(state["ok"])

    def on_failed(key, row, time, is_addition):
        with lock:
            (state["failed"].add if is_addition else state["failed"].discard)(key)

    def on_vec(key, row, time, is_addition):
        with lock:
            if is_addition:
                state["texts"][key] = row["text"]
            else:
                state["texts"].pop(key, None)

    def on_answer(key, row, time, is_addition):
        if is_addition:
            with lock:
                state["answers"][row["qid"]] = list(row["text"])
                if len(state["answers"]) >= len(q_texts):
                    answered.set()

    pw.io.subscribe(chunks, on_chunk)
    pw.io.subscribe(ok, on_ok, on_end=on_ok_end)
    pw.io.subscribe(transformer.failed, on_failed)
    pw.io.subscribe(vecs, on_vec)
    pw.io.subscribe(res, on_answer)
    runner = GraphRunner(G)

    def run():
        try:
            runner.run(device=device)
        except BaseException as exc:  # noqa: BLE001 - the phase fails with it below
            state["error"] = exc

    thread = threading.Thread(target=run, daemon=True, name="ops-async-run")

    def settled() -> bool:
        with lock:
            cid_of = state["cid_of"]
            got_ok = {cid_of.get(k): v for k, v in state["ok"].items()}
            got_failed = {cid_of.get(k) for k in state["failed"]}
            return (got_ok == want_ok and got_failed == want_failed
                    and len(state["texts"]) == len(want_ok))

    svc = emb.pipeline.service
    _cuda.reset_launch_counts()
    reset_profile()
    t_start = clock()
    thread.start()
    deadline = clock() + 300
    warm_at = None
    while not settled():
        if warm_at is None and svc.wait_warm(0.0):
            warm_at = clock()
        if clock() > deadline or not thread.is_alive():
            raise SystemExit(f"phase 9 part E: successful / failed never equalled the replay "
                             f"({len(state['ok'])} / {len(state['failed'])} rows, "
                             f"{len(want_ok)} / {len(want_failed)} expected; {state['error']!r})")
        time.sleep(0.01)
    settled_at = clock()
    # the query path is not held back for the encoder service's pre-warm: its
    # captures run beside the scorer's work-list captures, as a user's
    # server runs them
    go.set()
    while not answered.wait(0.25):
        if clock() > deadline or not thread.is_alive():
            raise SystemExit(f"phase 9 part E: the queries were not answered ({state['error']!r})")
    thread.join(120)
    if thread.is_alive() or state["error"] is not None:
        raise SystemExit(f"phase 9 part E: the run did not end by itself once every source "
                         f"closed ({state['error']!r})")
    t_end = clock()
    if device is None:
        torch.cuda.synchronize()
    launches = dict(_cuda.KERNEL_LAUNCHES)
    operators = ops_operators("phase 9 part E", card, 10)
    if state["ok_end_at"] is None or state["ok_end_at"] < calls["last_done"]:
        raise SystemExit("phase 9 part E: the subscriber below the transformer heard the end "
                         "before the last invocation finished")
    if state["ok_rows_at_end"] != len(want_ok):
        raise SystemExit(f"phase 9 part E: the end came with {state['ok_rows_at_end']} successful "
                         f"rows delivered, {len(want_ok)} expected")
    if calls["peak"] > sz["capacity"]:
        raise SystemExit(f"phase 9 part E: {calls['peak']} invocations in flight, capacity "
                         f"{sz['capacity']}")
    store = made[0].store if made else None
    if store is None or store.device.type != (device or "cuda"):
        raise SystemExit(f"phase 9 part E: the index is not on the card ({made})")
    if device is None and launches.get(knn_ivf.SCORE_PAGES, 0) <= 0:
        raise SystemExit("phase 9 part E: the query path never launched score_pages")
    qe = emb.embed_queries(q_texts).double()
    data64 = store._data.double()
    key_of_text = {text: key for key, text in state["texts"].items()}
    worst = 1.0
    for qid, cid in enumerate(q_cids):
        answer = state["answers"][qid]
        if qid < len(hits):
            if not answer or answer[0] != q_texts[qid]:
                raise SystemExit(f"phase 9 part E: query {qid}'s top hit is not chunk {cid}")
            x = data64[store.slot_of[key_of_text[answer[0]]]]
            cos = float((qe[qid] @ x) / (torch.linalg.norm(qe[qid]) * torch.linalg.norm(x)))
            worst = min(worst, cos)
            if cos < sz["cosine"]:
                raise SystemExit(f"phase 9 part E: query {qid}'s top hit has cosine {cos:.6f} "
                                 f"< {sz['cosine']}")
        elif q_texts[qid] in answer:
            raise SystemExit(f"phase 9 part E: query {qid} returned chunk {cid}, which failed or "
                             f"was removed")
    n = len(rows)
    out = {"rows": n, "commits": sz["commits"] + 1, "removed": len(removed),
           "successful": len(want_ok), "failed": len(want_failed),
           "invocations": calls["invocations"], "peak_in_flight": calls["peak"],
           "transformer_rows_per_s": n / (calls["last_done"] - state["t0"]),
           "first_push_s": state["t0"] - t_start, "last_invocation_s": calls["last_done"] - t_start,
           "prewarm_s": None if warm_at is None else warm_at - t_start,
           "settled_s": settled_at - t_start, "seconds": t_end - t_start,
           "gc_pauses_s": GC_PAUSES.within(t_start, t_end), "operators": operators,
           "end_after_last_invocation_ms": 1e3 * (state["ok_end_at"] - calls["last_done"]),
           "worst_top1_cosine": worst,
           "score_pages_launches": launches.get(knn_ivf.SCORE_PAGES, 0)}
    warm = "after settling" if warm_at is None else f"done at {out['prewarm_s']:.2f} s"
    log(f"  part E: {n} chunks in {sz['commits']} commits of {per} + a commit removing "
        f"{len(removed)} → AsyncTransformer(instance=topic, capacity={sz['capacity']}, "
        f"{sz['max_retries']} retries; {sz['sleep_s'] * 1e3:.0f} ms a call) → successful → embed "
        f"→ KNNIndex(ivf, cosine) on {store.device.type}: successful {len(want_ok)} / failed "
        f"{len(want_failed)} equal the replay; {calls['invocations']} invocations, "
        f"{out['transformer_rows_per_s']:.0f} rows/s through the transformer, "
        f"{calls['peak']} in flight at peak; the end heard "
        f"{out['end_after_last_invocation_ms']:.1f} ms after the last invocation; "
        f"{len(hits)} top-1 hits (worst cosine {worst:.6f}), {len(absent)} failed or removed "
        f"chunks absent; the last invocation done at {out['last_invocation_s']:.2f} s, the "
        f"encoder's pre-warm {warm}, settled at {out['settled_s']:.2f} s, part E "
        f"{out['seconds']:.2f} s; {gc_line(out)}; "
        f"score_pages launches on this part: {out['score_pages_launches']} [{card}]")
    return out


def run_ops_stdlib(torch, args, card: str, docs: list, device=None, encoder_config=None,
                   sizes: "dict | None" = None) -> tuple:
    """Phase 9 (``device="cpu"``, small ``sizes`` and a tiny
    ``encoder_config`` rehearse it; ``sizes["async"]`` overrides Part E's):
    Part A graphs, Part B the event stream, Part C deduplicated ingest into
    the IVF index, Part D ``pw.sql`` into the IVF index, a row transformer
    and an error trace, Part E an async transformer into the IVF index.
    Returns the report and the page scorer's launches on Part C's, Part D's
    and Part E's paths."""
    sz = {**OPS, **(sizes or {})}
    try:
        import yaml  # noqa: F401

        has_yaml = True
    except ImportError:
        has_yaml = False
    log(f"  PyYAML on this machine: {'yes' if has_yaml else 'no'} (pw.load_yaml "
        f"{'works' if has_yaml else 'raises ImportError'})")
    out: dict = {"card": card, "yaml": has_yaml}
    t0 = time.perf_counter()
    out["graphs"] = ops_graphs(torch, args, card, sz, device)
    out["graphs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["events"] = ops_events(torch, args, card, sz, device)
    out["events_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ingest"] = ops_ingest(torch, args, card, docs, sz, device, encoder_config)
    out["ingest_s"] = time.perf_counter() - t0
    out["sql_transformer"] = ops_sql_transformer(torch, args, card, sz, device)
    out["sql_transformer_s"] = out["sql_transformer"]["seconds"]
    out["async"] = ops_async(torch, args, card, docs, {**ASYNC, **sz.get("async", {})}, device,
                             encoder_config)
    out["async_s"] = out["async"]["seconds"]
    start = t0 - out["graphs_s"] - out["events_s"]
    out["gc_pauses_s"] = GC_PAUSES.within(start, time.perf_counter())
    log(f"  phase 9: graphs {out['graphs_s']:.1f} s, events {out['events_s']:.1f} s, "
        f"ingest {out['ingest_s']:.1f} s, sql / transformer / trace "
        f"{out['sql_transformer_s']:.1f} s, async transformer {out['async_s']:.1f} s; "
        f"{gc_line(out)} [{card}]")
    return out, {"launches_ops": out["ingest"]["score_pages_launches"],
                 "launches_sql": out["sql_transformer"]["sql"]["score_pages_launches"],
                 "launches_async": out["async"]["score_pages_launches"]}


# -- phase 10: persistence, a crash and a resume of the ingest ----------------

PERSIST = {
    # the smoke's first 16,384 chunks as 16 jsonlines files of 1,024 (files 1
    # to 16); files 1-8 are there when the child starts
    "chunks": 16_384, "files": 16, "present": 8,
    # the child is killed once the journal holds this many files
    "journaled": 4,
    # while the pipeline is down: files 9-16 come, file 3 is rewritten (every
    # chunk a new text under a new id), file 5 is deleted
    "rewritten": 3, "deleted": 5,
    # every cluster probed, and 2 clusters: the store cannot split past
    # n_probe, so the answers are exact whatever the commit structure
    "clusters": 2, "queries": 64, "gone_queries": 16, "k": 10,
    "cosine": 0.9999, "tie": 1e-5,
    "child_timeout_s": 300,
}


def persist_files(docs: list, sz: dict) -> dict:
    """File number -> its rows (``cid``, ``text``): files 1..files of
    ``chunks / files`` rows from the corpus in order, and ``"rewritten"``,
    the new version of file ``sz["rewritten"]``: the next chunks of the
    corpus, under new ids."""
    per = sz["chunks"] // sz["files"]
    files = {
        f: [{"cid": c, "text": docs[c]["data"]} for c in range((f - 1) * per, f * per)]
        for f in range(1, sz["files"] + 1)
    }
    base = sz["chunks"]
    files["rewritten"] = [{"cid": base + j, "text": docs[base + j]["data"]} for j in range(per)]
    return files


def persist_write(watch: str, no: int, rows: list) -> str:
    """Write one file atomically (a rename from a sibling temporary)."""
    path = os.path.join(watch, f"part{no:02d}.jsonl")
    tmp = os.path.join(os.path.dirname(watch), f".part{no:02d}.tmp")
    with open(tmp, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    os.replace(tmp, path)
    return path


def persist_pipeline(pw, watch: str, sz: dict, seed: int, device=None, encoder_config=None,
                     params=None, probe: "str | None" = None, go=None, queries=(),
                     counted_hook=None, split: bool = False) -> dict:
    """The phase's program: ``pw.io.jsonlines.read(streaming)`` → the
    encoder → ``KNNIndex(ivf, cosine)``; as-of-now queries from a python
    connector (``probe`` at once, then ``queries`` once ``go`` is set). The
    child, Run 0 and Run 2 build the same graph. ``counted_hook(n)`` hears
    the index's row count. ``split`` (phase 11): a ``TokenCountSplitter``
    and a flatten between the read and the encoder, as on the main path
    (every chunk of the corpus is one piece)."""
    import threading

    from pathway_tpu_torch.stdlib.ml import KNNIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    state = {"docs": {}, "answers": {}, "first_answer_at": None}
    lock = threading.Lock()
    answered = threading.Event()
    clock = time.perf_counter

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self):
            if probe is not None:
                self.next(qid=-1, text=probe)
                self.commit()
            if go is None:
                return
            go.wait()
            for qid, text in enumerate(queries):
                self.next(qid=qid, text=text)
            self.commit()

    schema = pw.schema_from_types(cid=int, text=str)
    docs_t = pw.io.jsonlines.read(watch, schema=schema, mode="streaming",
                                  autocommit_duration_ms=None, object_pattern="*.jsonl")
    emb = SentenceTransformerEmbedder(seed=seed, sub_batch=1024, device=device,
                                      encoder_config=encoder_config, params=params)
    src = docs_t
    if split:
        pieces = docs_t.select(docs_t.cid, _pieces=TokenCountSplitter(
            min_tokens=1, max_tokens=CHUNK_MAX_WORDS)(docs_t.text))
        flat = pieces.flatten(pieces._pieces)
        src = flat.select(flat.cid, text=flat._pieces[0])
    vecs = src.select(src.cid, src.text, vec=emb(src.text))
    knn = KNNIndex(vecs.vec, vecs, n_dimensions=emb.get_embedding_dimension(),
                   distance_type="cosine", exact=False, approximate="ivf",
                   n_clusters=sz["clusters"], n_probe=sz["clusters"], device=device)
    made: list = []
    inner = knn.index.inner_index
    make = inner._make_index

    def recording(make=make):
        index = make()
        made.append(index)
        return index

    inner._make_index = recording  # to read the store after the run
    q = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, text=str),
                          autocommit_duration_ms=None)
    res = knn.get_nearest_items_asof_now(q.select(q.qid, qvec=emb(q.text)).qvec, k=sz["k"])
    counted = vecs.reduce(n=pw.reducers.count())

    def on_vec(key, row, time, is_addition):
        with lock:
            if is_addition:
                state["docs"][key] = (row["cid"], row["text"], row["vec"])
            else:
                state["docs"].pop(key, None)

    def on_count(key, row, time, is_addition):
        if is_addition and counted_hook is not None:
            counted_hook(row["n"])

    def on_answer(key, row, time, is_addition):
        if is_addition:
            with lock:
                if state["first_answer_at"] is None:
                    state["first_answer_at"] = clock()
                if row["qid"] >= 0:
                    state["answers"][row["qid"]] = list(row["cid"])
                    if len(state["answers"]) >= len(queries):
                        answered.set()

    pw.io.subscribe(vecs, on_vec)
    pw.io.subscribe(counted, on_count)
    pw.io.subscribe(res, on_answer)
    return {"state": state, "lock": lock, "answered": answered, "made": made, "emb": emb,
            "docs_t": docs_t}


def persist_child(spec_path: str) -> int:
    """Run 1: the ingest with persistence, in a process of its own, until the
    smoke kills it. Each commit that moves the index's count appends a line
    ``n wall_time record_s frames`` to the progress file."""
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G

    with open(spec_path) as f:
        spec = json.load(f)
    # a child the smoke failed to kill ends by itself
    threading.Timer(spec["timeout_s"], os._exit, (3,)).start()
    encoder_config, params = persist_encoder(spec)
    progress = open(spec["progress"], "a")
    runner: list = []

    def counted(n: int) -> None:
        stats = runner[0].persist_stats
        progress.write(f"{n} {time.time()} {stats.get('record_s', 0.0)} "
                       f"{stats.get('frames', 0)}\n")
        progress.flush()

    G.clear()
    persist_pipeline(pw, spec["watch"], spec["sizes"], spec["seed"], spec["device"],
                     encoder_config, params, counted_hook=counted,
                     split=spec.get("split", False))
    runner.append(GraphRunner(G))
    progress.write(f"0 {time.time()} 0.0 0\n")
    progress.flush()
    runner[0].run(device=spec["device"],
               persistence_config=pw.persistence.Config(pw.persistence.Backend.filesystem(
                   spec["store"])))
    return 0


def persist_encoder(spec: dict) -> tuple:
    """The encoder's config and weights a rehearsal hands the child (None,
    None: full width, seeded weights)."""
    import pickle

    encoder_config = params = None
    if spec.get("encoder_config"):
        import torch

        from pathway_tpu_torch.models.encoder import EncoderConfig

        cfg = dict(spec["encoder_config"])
        cfg["dtype"] = getattr(torch, cfg.get("dtype", "bfloat16"))
        encoder_config = EncoderConfig(**cfg)
    if spec.get("params"):
        from pathway_tpu_torch.models.encoder import params_from_jax

        with open(spec["params"], "rb") as f:  # written by the caller of the phase
            params = params_from_jax(pickle.load(f))
    return encoder_config, params


def journal_frames(store: str) -> list:
    """The journal's whole frames ``(commit id, input deltas, offsets)``, read
    from the store as it stands (a torn tail frame is not counted)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.persistence.engine import PersistenceManager

    path = os.path.join(store, "journal.bin")
    try:
        with open(path, "rb") as f:
            f.readline()
            header = f.readline()
    except OSError:
        return []
    try:
        sig = json.loads(header)["sig"]
    except (ValueError, KeyError):
        return []
    mgr = PersistenceManager(pw.persistence.Config(pw.persistence.Backend.filesystem(store)))
    return mgr.load_journal(sig)


def journaled_files(store: str) -> tuple:
    """(files whose rows the journal holds whole, journaled rows, frames)."""
    frames = journal_frames(store)
    files = set()
    for _cid, _deltas, offs in frames:
        for o in offs.values():
            for d in o.get("state_deltas", []):
                (files.discard if d.get("deleted") else files.add)(d["file"])
    rows = sum(len(d) for _c, deltas, _o in frames for d in deltas.values())
    return files, rows, len(frames)


def persist_answers(torch, h: dict, q_texts: list, sz: dict) -> list:
    """Each query's answer: [(cid, cosine to the query)] in rank order, the
    cosines from the store's rows in float64."""
    store = h["made"][0].store
    key_of_cid = {cid: key for key, (cid, _t, _v) in h["state"]["docs"].items()}
    qe = h["emb"].embed_queries(q_texts).double()
    if hasattr(store, "_data"):
        data64 = store._data.double()
    else:  # the tiered store keeps its fp32 rows on the host, by cluster block
        data64 = {s: torch.from_numpy(store._vector_of(s)).double().to(qe.device)
                  for s in store.key_of}
    out = []
    for qid in range(len(q_texts)):
        ranked = []
        for cid in h["state"]["answers"][qid]:
            x = data64[store.slot_of[key_of_cid[cid]]]
            cos = float((qe[qid] @ x) / (torch.linalg.norm(qe[qid]) * torch.linalg.norm(x)))
            ranked.append((int(cid), cos))
        out.append(ranked)
    return out


def near_tie_equal(a: list, b: list, tie: float) -> bool:
    """Equal top-k id sets, but for swaps whose cosines lie within ``tie`` of
    the k-th in their own list."""
    sa, sb = {c for c, _s in a}, {c for c, _s in b}
    if sa == sb:
        return True
    if len(a) != len(b):
        return False
    ka, kb = a[-1][1], b[-1][1]
    return all(abs(s - ka) <= tie for c, s in a if c not in sb) and all(
        abs(s - kb) <= tie for c, s in b if c not in sa)


def persist_run(torch, pw, watch: str, sz: dict, seed: int, q_texts: list, device,
                encoder_config, params, total: int, persistence=None, probe=None,
                label: str = "", split: bool = False) -> dict:
    """Run 0 (``persistence`` None) or Run 2 in this process: the graph runs
    until the sink holds ``total`` rows, then the queries are answered and
    the run is stopped (a streaming read never ends). ``label`` names the
    phase and the run in failures."""
    import threading

    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import _cuda

    clock = time.perf_counter
    t_build = clock()
    go = threading.Event()
    G.clear()
    h = persist_pipeline(pw, watch, sz, seed, device, encoder_config, params, probe=probe,
                         go=go, queries=q_texts, split=split)
    runner = GraphRunner(G)
    err: dict = {}

    def run():
        try:
            runner.run(device=device, persistence_config=persistence)
        except BaseException as exc:  # noqa: BLE001 - the phase fails with it below
            err["error"] = exc

    thread = threading.Thread(target=run, daemon=True, name=f"persist-{label}")
    _cuda.reset_launch_counts()
    t0 = clock()
    thread.start()
    deadline = t0 + 300
    state, lock = h["state"], h["lock"]
    while True:
        with lock:
            n = len(state["docs"])
        if n >= total:
            break
        if clock() > deadline or not thread.is_alive():
            runner.stop()
            raise SystemExit(f"{label}: the sink holds {n} of {total} rows "
                             f"({err.get('error')!r})")
        time.sleep(0.005)
    ingest_end = clock()
    if probe is not None:
        while state["first_answer_at"] is None:
            if clock() > deadline or not thread.is_alive():
                runner.stop()
                raise SystemExit(f"{label}: the probe query was not answered")
            time.sleep(0.005)
    go.set()
    try:
        while not h["answered"].wait(0.1):
            if clock() > deadline or not thread.is_alive():
                raise SystemExit(f"{label}: the queries were not answered "
                                 f"({err.get('error')!r})")
        if device is None:
            from pathway_tpu_torch.device import GRAPH_CAPTURE_LOCK

            # the new encoder's pre-warm may hold a capture open on its thread,
            # and a device-wide synchronize fails inside one
            with GRAPH_CAPTURE_LOCK:
                torch.cuda.synchronize()
        launches = dict(_cuda.KERNEL_LAUNCHES)
        answers = persist_answers(torch, h, q_texts, sz)
    finally:
        go.set()
        runner.stop()
        thread.join(60)
    if thread.is_alive() or "error" in err:
        raise SystemExit(f"{label}: the run did not stop ({err.get('error')!r})")
    store = h["made"][0].store if h["made"] else None
    if store is None or store.device.type != (device or "cuda"):
        raise SystemExit(f"{label}: the index is not on the card ({h['made']})")
    subject = h["docs_t"]._node.config["source"].subject
    return {"h": h, "runner": runner, "store": store, "answers": answers, "launches": launches,
            "build_s": t0 - t_build, "seconds": clock() - t_build,
            "ingest_s": ingest_end - t0, "rows_read": dict(subject.rows_read),
            "first_answer_s": None if state["first_answer_at"] is None
            else state["first_answer_at"] - t0}


def run_persist(torch, args, card: str, docs: list, device=None, encoder_config=None,
                sizes: "dict | None" = None, params: "str | None" = None) -> tuple:
    """Phase 10 (``persist-resume-16k``; ``device="cpu"``, small ``sizes``, a
    tiny ``encoder_config`` and ``params``, a pickled reference weight tree,
    rehearse it): Run 1 in a child process with persistence, killed with
    SIGKILL while it reads; files change while it is down; Run 0 (no
    persistence) over the final file set; Run 2 resumes on the store. Returns
    the report and ``score_pages``' launches on Run 2's path."""
    import shutil
    import signal
    import tempfile

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import knn_ivf

    sz = {**PERSIST, **(sizes or {})}
    clock = time.perf_counter
    t_phase = clock()
    files = persist_files(docs, sz)
    per = sz["chunks"] // sz["files"]
    tmp = tempfile.mkdtemp(prefix="pw_persist_")
    watch, store = os.path.join(tmp, "watch"), os.path.join(tmp, "store")
    os.makedirs(watch)
    spec_path, progress = os.path.join(tmp, "child.json"), os.path.join(tmp, "progress.txt")
    child_log = os.path.join(tmp, "child.log")
    paths = {f: os.path.join(watch, f"part{f:02d}.jsonl") for f in range(1, sz["files"] + 1)}
    try:
        for f in range(1, sz["present"] + 1):
            persist_write(watch, f, files[f])
        enc_spec = None
        if encoder_config is not None:
            enc_spec = {k: getattr(encoder_config, k) for k in (
                "vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                "max_position", "type_vocab_size", "layer_norm_eps")}
            enc_spec["dtype"] = str(encoder_config.dtype).replace("torch.", "")
        with open(spec_path, "w") as f:
            json.dump({"watch": watch, "store": store, "progress": progress, "seed": args.seed,
                       "sizes": sz, "device": device, "encoder_config": enc_spec,
                       "params": params, "timeout_s": sz["child_timeout_s"]}, f)

        # Run 1: the child, killed once the journal holds ``journaled`` files
        t1 = clock()
        spawned_wall = time.time()
        with open(child_log, "wb") as out:
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--persist-child", spec_path],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out, stderr=out,
            )
        try:
            deadline = t1 + sz["child_timeout_s"]
            while True:
                if child.poll() is not None:
                    with open(child_log, "rb") as f:
                        tail = f.read().decode(errors="replace")[-3000:]
                    raise SystemExit(f"phase 10 run 1: the child ended before it was killed: {tail}")
                if clock() > deadline:
                    raise SystemExit("phase 10 run 1: the journal never held "
                                     f"{sz['journaled']} files")
                got, _rows, _frames = journaled_files(store)
                if len(got) >= sz["journaled"]:
                    break
                time.sleep(0.01)
        finally:
            if child.poll() is None:
                os.kill(child.pid, signal.SIGKILL)
            child.wait(60)
        killed_at = time.time()
        journaled, journal_rows, journal_frames = journaled_files(store)
        if len(journaled) >= sz["present"]:
            raise SystemExit("phase 10 run 1: the child had read every file before the kill")
        journal_bytes = os.path.getsize(os.path.join(store, "journal.bin"))
        with open(progress) as f:
            marks = [line.split() for line in f if line.endswith("\n")]
        start_wall = float(marks[0][1])
        last = marks[-1]
        run1 = {
            "journaled_files": sorted(os.path.basename(p) for p in journaled),
            "journal_rows": journal_rows, "journal_frames": journal_frames,
            "journal_bytes": journal_bytes,
            "bytes_per_chunk": journal_bytes / max(journal_rows, 1),
            "rows_indexed": int(last[0]),
            "docs_per_s": int(last[0]) / max(float(last[1]) - start_wall, 1e-9),
            "record_ms_per_commit": 1e3 * float(last[2]) / max(int(last[3]), 1),
            "child_s": killed_at - start_wall, "child_start_s": start_wall - spawned_wall,
        }

        # while the pipeline is down
        for f in range(sz["present"] + 1, sz["files"] + 1):
            persist_write(watch, f, files[f])
        persist_write(watch, sz["rewritten"], files["rewritten"])
        os.unlink(paths[sz["deleted"]])
        final = [f for f in range(1, sz["files"] + 1) if f != sz["deleted"]]
        final_rows = [r for f in final
                      for r in (files["rewritten"] if f == sz["rewritten"] else files[f])]
        total = len(final_rows)
        rng = np.random.default_rng(args.seed + 71)
        hit_rows = [final_rows[i] for i in rng.choice(total, sz["queries"], replace=False)]
        gone = files[sz["rewritten"]] + files[sz["deleted"]]
        gone_rows = [gone[i] for i in rng.choice(len(gone), sz["gone_queries"], replace=False)]
        q_texts = [r["text"] for r in hit_rows + gone_rows]
        enc = persist_encoder({"encoder_config": enc_spec, "params": params})

        # Run 0: no persistence, over the final file set
        run0 = persist_run(torch, pw, watch, sz, args.seed, q_texts, device, *enc, total,
                           label="phase 10 run 0")
        # Run 2: the resume on Run 1's store
        probe = files[1][0]["text"]
        run2 = persist_run(torch, pw, watch, sz, args.seed, q_texts, device, *enc, total,
                           persistence=pw.persistence.Config(
                               pw.persistence.Backend.filesystem(store)),
                           probe=probe, label="phase 10 run 2")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the index holds exactly the final corpus, none twice
    want_cids = sorted(r["cid"] for r in final_rows)
    for label, run in (("run 0", run0), ("run 2", run2)):
        cids = sorted(cid for cid, _t, _v in run["h"]["state"]["docs"].values())
        if cids != want_cids:
            raise SystemExit(f"phase 10 {label}: the sink holds {len(cids)} rows, not the "
                             f"{len(want_cids)} of the final corpus")
        if len(run["store"].slot_of) != total:
            raise SystemExit(f"phase 10 {label}: the index holds {len(run['store'].slot_of)} "
                             f"rows, not {total}")
    sink0 = {k: (c, t) for k, (c, t, _v) in run0["h"]["state"]["docs"].items()}
    sink2 = {k: (c, t) for k, (c, t, _v) in run2["h"]["state"]["docs"].items()}
    if sink2 != sink0:
        raise SystemExit("phase 10: Run 2's sink differs from Run 0's")
    # Run 2 read from disk exactly the files the journal lacked or that changed
    unread = {os.path.join(watch, name) for name in run1["journaled_files"]}
    want_read = {paths[f]: per for f in final if paths[f] not in unread or f == sz["rewritten"]}
    if run2["rows_read"] != want_read:
        raise SystemExit(f"phase 10 run 2: the scanner read {sorted(run2['rows_read'].items())}, "
                         f"expected {sorted(want_read.items())}")
    # answers: each exact text first, the top-10 sets Run 0's bar near ties,
    # no deleted chunk
    worst = 1.0
    n_hit = len(hit_rows)
    for qid, row in enumerate(hit_rows):
        a2 = run2["answers"][qid]
        if not a2 or a2[0][0] != row["cid"] or a2[0][1] < sz["cosine"]:
            raise SystemExit(f"phase 10 run 2: query {qid}'s top hit is {a2[:1]}, not chunk "
                             f"{row['cid']} at cosine >= {sz['cosine']}")
        worst = min(worst, a2[0][1])
        if not near_tie_equal(a2, run0["answers"][qid], sz["tie"]):
            raise SystemExit(f"phase 10: query {qid}'s top-{sz['k']} differs from Run 0's beyond "
                             f"near ties: {a2} vs {run0['answers'][qid]}")
    gone_cids = {r["cid"] for r in gone}
    for qid in range(n_hit, len(q_texts)):
        if any(c in gone_cids for c, _s in run2["answers"][qid]):
            raise SystemExit(f"phase 10 run 2: query {qid} returned a deleted chunk")
    launches = run2["launches"].get(knn_ivf.SCORE_PAGES, 0)
    if device is None and launches < 1:
        raise SystemExit("phase 10 run 2: the query path never launched score_pages")
    stats = run2["runner"].persist_stats
    vec_cos = min(
        float(np.dot(v, run0["h"]["state"]["docs"][k][2])
              / (np.linalg.norm(v) * np.linalg.norm(run0["h"]["state"]["docs"][k][2])))
        for k, (_c, _t, v) in run2["h"]["state"]["docs"].items()
    )
    out = {
        "card": card, "chunks": sz["chunks"], "files": sz["files"], "final_chunks": total,
        "run1": run1,
        "run0": {"docs_per_s": total / run0["ingest_s"], "ingest_s": run0["ingest_s"],
                 "build_s": run0["build_s"], "seconds": run0["seconds"]},
        "run2": {
            "replay_s": stats["replay_s"], "replay_rows": stats["replay_rows"],
            "replay_frames": stats["replay_frames"], "first_answer_s": run2["first_answer_s"],
            "settled_s": run2["ingest_s"], "rows_read": sum(run2["rows_read"].values()),
            "files_read": sorted(os.path.basename(p) for p in run2["rows_read"]),
            "frames": stats["frames"],
            "record_ms_per_commit": 1e3 * stats["record_s"] / max(stats["frames"], 1),
            "build_s": run2["build_s"], "seconds": run2["seconds"],
        },
        "worst_top1_cosine": worst, "worst_vec_cosine_run2_vs_run0": vec_cos,
        "score_pages_launches": launches, "seconds": clock() - t_phase,
        # Run 2's embeddings and answers, for a rehearsal's comparison
        "rehearsal": {"vecs": {c: v for c, _t, v in run2["h"]["state"]["docs"].values()},
                      "answers": run2["answers"], "queries": q_texts, "hits": n_hit},
    }
    log(f"  run 1 (child, persistence on): started in {run1['child_start_s']:.2f} s, then "
        f"{run1['rows_indexed']} chunks indexed at "
        f"{run1['docs_per_s']:.0f} docs/s, killed with SIGKILL after {run1['child_s']:.2f} s; the "
        f"journal held {len(journaled)} whole files ({journal_rows} rows, {journal_frames} frames, "
        f"{run1['bytes_per_chunk']:.0f} bytes per chunk), record_commit "
        f"{run1['record_ms_per_commit']:.3f} ms per commit [{card}]")
    log(f"  run 0 (persistence off, the final {len(final)} files): {total} chunks at "
        f"{out['run0']['docs_per_s']:.0f} docs/s; the graph built in {run0['build_s']:.2f} s, the "
        f"run {run0['seconds']:.2f} s in all [{card}]")
    r2 = out["run2"]
    log(f"  run 2 (resume): replayed {r2['replay_rows']} rows in {r2['replay_frames']} frames in "
        f"{r2['replay_s']:.3f} s through the encoder and the index; first query answered "
        f"{r2['first_answer_s']:.3f} s after the start; the scanner read {r2['rows_read']} rows "
        f"({', '.join(r2['files_read'])}); settled at {r2['settled_s']:.2f} s; record_commit "
        f"{r2['record_ms_per_commit']:.3f} ms per commit over {r2['frames']} frames; the graph "
        f"built in {r2['build_s']:.2f} s, the run {r2['seconds']:.2f} s in all [{card}]")
    log(f"  checks: {total} chunks, none twice, sink equal to Run 0's; {n_hit} top-1 hits (worst "
        f"cosine {worst:.6f}), top-{sz['k']} sets equal to Run 0's bar near ties; "
        f"{len(q_texts) - n_hit} deleted chunks absent; embeddings of Run 2 against Run 0's: worst "
        f"cosine {vec_cos:.6f}; score_pages launches on this path: {launches}; phase "
        f"{out['seconds']:.1f} s [{card}]")
    return out, launches


# -- phase 11: fault injection (chaos plans) -----------------------------------

CHAOS = {
    # part A: the tiered int8 store under the index faults; the HBM budget is
    # this share of the int8 payload, so about half the clusters stay cold
    "rows": 65_536, "dim": 384, "clusters": 64, "n_probe": 8, "queries": 64, "k": 10,
    "budget_share": 0.5, "rebuild_drift": "0.1",
    # part B: phase 10's ingest with a splitter into the tiered int8 index,
    # 8 files of 512 chunks (cut from 8,192 so that the smoke stays within
    # half of its limit), killed at this commit (commit 0 and the query
    # feed's end are idle commits: the journal then holds 4-5 files)
    "chunks": 4_096, "files": 8, "kill_commit": 6, "resume_queries": 64,
    # part C: the slides store
    "decks": 256, "slides": 8, "slide_queries": 16, "slide_k": 3,
    "cosine": 0.9999, "tie": 1e-5, "child_timeout_s": 300,
}
# the variables phase 11 sets in this process (and puts back after it)
CHAOS_ENV = ("PATHWAY_CHAOS_PLAN", "PATHWAY_CHAOS_SEED", "PATHWAY_RESTART_COUNT",
             "PATHWAY_IVF_QUANT", "PATHWAY_IVF_REBUILD_DRIFT")


def set_chaos_plan(plan: dict, restart_count: int = 0) -> None:
    """Make ``plan`` this process's chaos plan (seed 0)."""
    from pathway_tpu_torch.internals.chaos import reset_chaos

    os.environ["PATHWAY_CHAOS_PLAN"] = json.dumps(plan)
    os.environ["PATHWAY_CHAOS_SEED"] = "0"
    os.environ["PATHWAY_RESTART_COUNT"] = str(restart_count)
    reset_chaos()


def wait_rebuild(store, timeout_s: float = 120.0) -> None:
    """Until the background rebuild's worker finished (its result waits for
    the next search's commit boundary)."""
    deadline = time.perf_counter() + timeout_s
    while store._rebuild_thread is not None:
        if time.perf_counter() > deadline:
            raise SystemExit("phase 11 part A: the background rebuild did not finish")
        time.sleep(0.01)


def chaos_index(torch, args, card: str, sz: dict, device=None) -> dict:
    """Part A: the ``quant`` and ``tier_swap_torn`` plans on a tiered int8
    store, each checked against a float64 brute force over the live rows."""
    import numpy as np

    from pathway_tpu_torch.device import GRAPH_CAPTURE_LOCK
    from pathway_tpu_torch.ops import _cuda, knn_quant, knn_tiers

    clock = time.perf_counter
    t0 = clock()
    rng = np.random.default_rng(args.seed + 113)
    n, d, c, k = sz["rows"], sz["dim"], sz["clusters"], sz["k"]
    centers = rng.normal(scale=4.0, size=(c, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, c, n)] + rng.normal(size=(n, d))).astype(np.float32)
    unit = vecs.astype(np.float64)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    keys = [f"r{i}" for i in range(n)]
    budget = int(n * (d + 12) * sz["budget_share"])
    _cuda.reset_launch_counts()
    store = knn_tiers.TieredIvfKnnStore(d, metric="cos", n_clusters=c, n_probe=sz["n_probe"],
                                        quant="int8", hbm_budget_bytes=budget, device=device)
    dev = store.device
    store.add_many(keys, vecs)
    q_idx = np.sort(rng.choice(np.arange(1, n, 2), sz["queries"], replace=False))
    for _ in range(3):  # trains, then promotes the probed clusters within the budget
        store.search_batch(vecs[q_idx[:8]], k)
    census = store.tiers.counts()
    build_s = clock() - t0
    checks: dict = {}

    def exact(label: str, live: np.ndarray) -> None:
        """The store's top-k of the queries against a float64 brute force
        over ``live`` on the device."""
        live_t = torch.from_numpy(unit[live]).to(dev)
        sims = torch.from_numpy(unit[q_idx]).to(dev) @ live_t.T
        vals, idx = torch.topk(sims, k, dim=1)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        _s, slots, _v = store.search_batch(vecs[q_idx], k)
        worst = 1.0
        for r, qi in enumerate(q_idx):
            got = [int(store.key_of[int(s)][1:]) for s in slots[r] if s >= 0]
            got = sorted(((i, float(unit[i] @ unit[qi])) for i in got), key=lambda x: -x[1])
            want = [(int(live[j]), float(v)) for j, v in zip(idx[r], vals[r])]
            if not near_tie_equal(got, want, sz["tie"]):
                raise SystemExit(f"phase 11 part A ({label}): query {r}'s top-{k} {got} differs "
                                 f"from the float64 brute force {want} beyond near ties")
            worst = min(worst, got[0][1])
        checks[label] = worst

    # the quant plan: every recalibration of rebuild attempt 0 aborts
    set_chaos_plan({"index": [{"op": "quant", "rank": 0, "at": 0}]})
    live = np.arange(1, n, 2)
    for i in range(0, n, 2):
        store.remove(keys[i])
    for cid in range(store.n_clusters):
        store._maintain_cluster(cid)
    aborts = store.stats["quant_chaos_aborts"]
    if aborts < 1 or store.stats["quant_recalibrations"] != 0:
        raise SystemExit(f"phase 11 part A: the quant plan gave {aborts} aborts and "
                         f"{store.stats['quant_recalibrations']} recalibrations")
    exact("quant plan, old scales", live)
    aborts = store.stats["quant_chaos_aborts"]  # the search's maintenance aborts too
    set_chaos_plan({})
    for cid in range(store.n_clusters):
        store._maintain_cluster(cid)
    recal = store.stats["quant_recalibrations"]
    if recal < 1 or store.stats["quant_chaos_aborts"] != aborts:
        raise SystemExit(f"phase 11 part A: with the plan lifted, {recal} recalibrations and "
                         f"{store.stats['quant_chaos_aborts'] - aborts} more aborts")
    exact("quant plan lifted, recalibrated", live)

    # the tier_swap_torn plan: rebuild attempt 0 is torn, the next swaps
    os.environ["PATHWAY_IVF_REBUILD_DRIFT"] = sz["rebuild_drift"]
    set_chaos_plan({"index": [{"op": "tier_swap_torn", "rank": 0, "at": 0}]})
    store.search_batch(vecs[q_idx[:1]], 1)  # the churn is past the drift: attempt 0
    if not store._rebuild_inflight():
        raise SystemExit("phase 11 part A: the churn scheduled no rebuild")
    wait_rebuild(store)
    exact("torn swap, old generation", live)  # its search is the torn boundary
    torn = {"swaps_torn": store.stats["swaps_torn"], "generation": store.generation}
    if torn != {"swaps_torn": 1, "generation": 0}:
        raise SystemExit(f"phase 11 part A: the torn swap left {torn}")
    if not store._rebuild_inflight():
        store.search_batch(vecs[q_idx[:1]], 1)  # attempt 1
    wait_rebuild(store)
    store.search_batch(vecs[q_idx[:1]], 1)  # the swap
    if store.generation != 1 or store.stats["swaps"] != 1:
        raise SystemExit(f"phase 11 part A: the retry left generation {store.generation}, "
                         f"{store.stats['swaps']} swaps")
    exact("swapped, generation 1", live)
    if device is None:
        with GRAPH_CAPTURE_LOCK:
            torch.cuda.synchronize()
    launches = {name: int(_cuda.KERNEL_LAUNCHES.get(name, 0))
                for name in (knn_quant.QUANT_PROBE, "quant_score_blocks", "score_blocks")}
    if device is None and min(launches[knn_quant.QUANT_PROBE],
                              launches["quant_score_blocks"]) < 1:
        raise SystemExit(f"phase 11 part A: the int8 kernels did not run ({launches})")
    out = {"rows": n, "dim": d, "budget_bytes": budget, "census_after_training": census,
           "n_clusters": store.n_clusters, "quant_chaos_aborts": aborts,
           "quant_recalibrations": recal, "swaps_torn": store.stats["swaps_torn"],
           "swaps": store.stats["swaps"], "generation": store.generation,
           "worst_top1_cosine": checks, "launches": launches, "build_s": build_s,
           "seconds": clock() - t0}
    store.close()
    log(f"  part A: tiered int8 store of {n} x {d} rows in {c} clusters ({census['hot']} hot, "
        f"{census['cold']} cold after training, budget {budget / 2**20:.1f} MiB), built in "
        f"{build_s:.2f} s; quant plan: {aborts} recalibrations aborted, none installed, then "
        f"{recal} with the plan lifted; tier_swap_torn: attempt 0 torn at generation 0, the "
        f"retry swapped to generation {store.generation}; top-{k} of {len(q_idx)} queries equal "
        f"to a float64 brute force bar near ties at each of {len(checks)} checks; int8 "
        f"launches {launches}; part A {out['seconds']:.1f} s [{card}]")
    return out


def chaos_kill_start(args, docs: list, sz: dict, tmp: str, device, enc_spec, params) -> dict:
    """Part B, Run 1: write the 8 files, then start the child under the kill
    plan (it runs while part A runs here)."""
    per = sz["chunks"] // sz["files"]
    watch, store = os.path.join(tmp, "watch"), os.path.join(tmp, "store")
    dumps = os.path.join(tmp, "dumps")
    os.makedirs(watch)
    os.makedirs(dumps)
    for f in range(1, sz["files"] + 1):
        persist_write(watch, f, [{"cid": c, "text": docs[c]["data"]}
                                 for c in range((f - 1) * per, f * per)])
    spec_path, log_path = os.path.join(tmp, "child.json"), os.path.join(tmp, "child.log")
    child_sz = {"clusters": 2, "k": PERSIST["k"]}
    with open(spec_path, "w") as f:
        json.dump({"watch": watch, "store": store, "progress": os.path.join(tmp, "progress.txt"),
                   "seed": args.seed, "sizes": child_sz, "device": device,
                   "encoder_config": enc_spec, "params": params,
                   "timeout_s": sz["child_timeout_s"], "split": True}, f)
    plan = {"kill": [{"rank": 0, "commit": sz["kill_commit"], "run": 0}]}
    env = {**os.environ, "PATHWAY_CHAOS_PLAN": json.dumps(plan), "PATHWAY_CHAOS_SEED": "0",
           "PATHWAY_RESTART_COUNT": "0", "PATHWAY_IVF_QUANT": "int8",
           "PATHWAY_FLIGHT_RECORDER_DIR": dumps}
    t0 = time.perf_counter()
    with open(log_path, "wb") as out:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--persist-child", spec_path],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out, stderr=out, env=env,
        )
    return {"child": child, "t0": t0, "watch": watch, "store": store, "dumps": dumps,
            "log": log_path, "plan": plan, "sizes": child_sz}


def chaos_kill_finish(torch, args, card: str, docs: list, sz: dict, b: dict, device,
                      encoder_config, params) -> dict:
    """Part B: the child's death at the named commit, then Run 2 here with
    restart count 1 under the same plan."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.ops import knn_quant, knn_tiers

    child, k_commit = b["child"], sz["kill_commit"]
    try:
        rc = child.wait(sz["child_timeout_s"])
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait(60)
        raise SystemExit(f"phase 11 part B: the child was not killed at commit {k_commit}")
    child_s = time.perf_counter() - b["t0"]
    if rc != -9:
        with open(b["log"], "rb") as f:
            tail = f.read().decode(errors="replace")[-3000:]
        raise SystemExit(f"phase 11 part B: the child returned {rc}, not -9: {tail}")
    try:
        with open(os.path.join(b["dumps"], "flight-rank-0.json")) as f:
            dump = json.load(f)
    except (OSError, ValueError) as exc:
        raise SystemExit(f"phase 11 part B: no flight-recorder dump of the kill ({exc})")
    kills = [e for e in dump["events"] if e.get("kind") == "chaos_kill"]
    if dump.get("reason") != "chaos_kill" or [e.get("commit") for e in kills] != [k_commit]:
        raise SystemExit(f"phase 11 part B: the dump ({dump.get('reason')!r}) records kills "
                         f"{kills}, not one at commit {k_commit}")
    frames = journal_frames(b["store"])
    last = max((cid for cid, _d, _o in frames), default=-1)
    journaled, journal_rows, _n = journaled_files(b["store"])
    if last >= k_commit or not 2 <= len(journaled) < sz["files"]:
        raise SystemExit(f"phase 11 part B: the journal's last commit is {last} and it holds "
                         f"{len(journaled)} files at the kill at commit {k_commit}")

    # Run 2: the restarted incarnation, the same plan
    total = sz["chunks"]
    rng = np.random.default_rng(args.seed + 79)
    hit = sorted(rng.choice(total, sz["resume_queries"], replace=False).tolist())
    q_texts = [docs[c]["data"] for c in hit]
    os.environ["PATHWAY_IVF_QUANT"] = "int8"
    set_chaos_plan(b["plan"], restart_count=1)
    run2 = persist_run(torch, pw, b["watch"], b["sizes"], args.seed, q_texts, device,
                       encoder_config, params, total,
                       persistence=pw.persistence.Config(
                           pw.persistence.Backend.filesystem(b["store"])),
                       probe=docs[0]["data"], label="phase 11 part B run 2", split=True)
    store = run2["store"]
    if not isinstance(store, knn_tiers.TieredIvfKnnStore) or store.quant != "int8":
        raise SystemExit(f"phase 11 part B: the index is {type(store).__name__}, not the int8 "
                         "tiered store")
    cids = sorted(cid for cid, _t, _v in run2["h"]["state"]["docs"].values())
    if cids != list(range(total)) or len(store.slot_of) != total:
        raise SystemExit(f"phase 11 part B: the sink holds {len(cids)} rows "
                         f"({len(set(cids))} distinct), the index {len(store.slot_of)}, not "
                         f"{total}")
    worst = 1.0
    for qid, cid in enumerate(hit):
        a = run2["answers"][qid]
        if not a or a[0][0] != cid or a[0][1] < sz["cosine"]:
            raise SystemExit(f"phase 11 part B: query {qid}'s top hit is {a[:1]}, not chunk "
                             f"{cid} at cosine >= {sz['cosine']}")
        worst = min(worst, a[0][1])
    launches = {name: int(run2["launches"].get(name, 0))
                for name in (knn_quant.QUANT_PROBE, "quant_score_blocks")}
    if device is None and min(launches.values()) < 1:
        raise SystemExit(f"phase 11 part B: Run 2 did not launch the int8 kernels ({launches})")
    stats = run2["runner"].persist_stats
    out = {
        "kill_commit": k_commit, "child_s": child_s, "child_rc": rc,
        "journaled_files": sorted(os.path.basename(p) for p in journaled),
        "journal_rows": journal_rows, "journal_last_commit": last,
        "run2": {"replay_rows": stats["replay_rows"], "replay_frames": stats["replay_frames"],
                 "replay_s": stats["replay_s"], "first_answer_s": run2["first_answer_s"],
                 "settled_s": run2["ingest_s"], "rows_read": sum(run2["rows_read"].values()),
                 "seconds": run2["seconds"]},
        "worst_top1_cosine": worst, "launches": launches,
    }
    r2 = out["run2"]
    log(f"  part B: the child (persistence on, the kill plan at commit {k_commit}) died with "
        f"return code {rc} after {child_s:.2f} s, its dump records chaos_kill at commit "
        f"{k_commit}; the journal held {len(journaled)} whole files ({journal_rows} rows, last "
        f"commit {last}); Run 2 (restart count 1, the same plan) replayed {r2['replay_rows']} "
        f"rows in {r2['replay_frames']} frames in {r2['replay_s']:.3f} s, answered its first "
        f"query {r2['first_answer_s']:.3f} s after the start, read {r2['rows_read']} rows from "
        f"disk, settled at {r2['settled_s']:.2f} s: {total} chunks in the index and the sink, "
        f"none twice; {len(hit)} exact texts first (worst cosine {worst:.6f}); int8 launches "
        f"{launches} [{card}]")
    return out


class SlideStandIn:
    """A rasterized slide for ``SlideParser``: ``size``, ``resize`` and
    ``save`` (the card's machine has no PIL); its saved bytes name it."""

    def __init__(self, deck: int, slide: int, size=(1920, 1080)):
        self.deck, self.slide, self.size = deck, slide, size

    def resize(self, size):
        return SlideStandIn(self.deck, self.slide, tuple(size))

    def save(self, buf, format: str = "PNG") -> None:
        buf.write(f"{self.deck}|{self.slide}|{self.size[0]}x{self.size[1]}|{format}".encode())


def chaos_slides(torch, args, card: str, docs: list, sz: dict, device=None,
                 encoder_config=None) -> dict:
    """Part C: ``SlidesDocumentStore`` over the encoder and an untiered IVF
    index, its decks parsed by ``SlideParser`` with a fake vision LLM (each
    slide's text is a corpus chunk) and a fake rasterizer."""
    import base64
    import threading

    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.device import GRAPH_CAPTURE_LOCK
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnMetricKind, IvfKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import SlidesDocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.parsers import SlideParser

    clock = time.perf_counter
    t0 = clock()
    n_decks, n_slides = sz["decks"], sz["slides"]
    total = n_decks * n_slides
    vision_calls = [0]

    def rasterize(contents) -> list:
        name = contents.decode() if isinstance(contents, bytes) else str(contents)
        deck = int(name[len("deck-"):])
        return [SlideStandIn(deck, s) for s in range(n_slides)]

    def vision(messages) -> str:
        vision_calls[0] += 1
        url = messages[0]["content"][1]["image_url"]["url"]
        deck, slide, size, _fmt = base64.b64decode(url.split(",", 1)[1]).decode().split("|")
        if size != "1280x720":
            raise ValueError(f"slide sent at {size}, not downsized to 1280 wide")
        return docs[int(deck) * n_slides + int(slide)]["data"]

    go, answered = threading.Event(), threading.Event()
    rng = np.random.default_rng(args.seed + 97)
    picks = [(int(i) // n_slides, int(i) % n_slides)
             for i in rng.choice(total, sz["slide_queries"], replace=False)]
    state: dict = {"count": 0, "answers": {}}

    class DeckFeed(pw.io.python.ConnectorSubject):
        def run(self):
            for d in range(n_decks):
                self.next(path=f"/decks/{d:03d}.pdf", data=f"deck-{d:03d}",
                          _metadata=pw.Json({"path": f"/decks/{d:03d}.pdf"}))
            self.commit()

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self):
            go.wait()
            for qid, (d, s) in enumerate(picks):
                self.next(qid=qid, query=docs[d * n_slides + s]["data"], k=sz["slide_k"])
            self.commit()

    G.clear()
    schema = pw.schema_builder({
        "path": pw.column_definition(dtype=str, primary_key=True),
        "data": pw.column_definition(dtype=str),
        "_metadata": pw.column_definition(dtype=pw.Json),
    })
    decks = pw.io.python.read(DeckFeed(), schema=schema, autocommit_duration_ms=None)
    emb = SentenceTransformerEmbedder(seed=args.seed, sub_batch=1024, device=device,
                                      encoder_config=encoder_config)
    dispatches = emb.encoder.dispatches
    factory = IvfKnnFactory(embedder=emb, metric=BruteForceKnnMetricKind.COS, device=device)
    store = SlidesDocumentStore(decks, retriever_factory=factory,
                                parser=SlideParser(llm=vision, _rasterizer=rasterize))
    dim = emb.get_embedding_dimension()
    if emb.encoder.dispatches != dispatches:
        raise SystemExit("phase 11 part C: get_embedding_dimension() ran an encode")
    q = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, query=str, k=int),
                          autocommit_duration_ms=None)
    res = store.retrieve_query(q)
    joined = q.join_left(res, q.id == res.id).select(q.qid, res.result)
    counted = store.chunked_docs.reduce(n=pw.reducers.count())

    def on_count(key, row, time, is_addition):
        if is_addition:
            state["count"] = row["n"]

    def on_answer(key, row, time, is_addition):
        if is_addition and row["result"] is not None:
            state["answers"][row["qid"]] = row["result"].value
            if len(state["answers"]) >= len(picks):
                answered.set()

    pw.io.subscribe(counted, on_count)
    pw.io.subscribe(joined, on_answer)
    runner = GraphRunner(G)
    err: dict = {}

    def run():
        try:
            runner.run(device=device)
        except BaseException as exc:  # noqa: BLE001 - the part fails with it below
            err["error"] = exc

    _cuda.reset_launch_counts()
    thread = threading.Thread(target=run, daemon=True, name="chaos-slides")
    t_run = clock()
    thread.start()
    try:
        deadline = t_run + 300
        while state["count"] < total:
            if clock() > deadline or not thread.is_alive():
                raise SystemExit(f"phase 11 part C: {state['count']} of {total} slides indexed "
                                 f"({err.get('error')!r})")
            time.sleep(0.005)
        ingest_s = clock() - t_run
        go.set()
        while not answered.wait(0.1):
            if clock() > deadline or not thread.is_alive():
                raise SystemExit(f"phase 11 part C: the queries were not answered "
                                 f"({err.get('error')!r})")
        if device is None:
            with GRAPH_CAPTURE_LOCK:
                torch.cuda.synchronize()
        launches = int(_cuda.KERNEL_LAUNCHES.get(knn_ivf.SCORE_PAGES, 0))
    finally:
        go.set()
        runner.stop()
        thread.join(60)
    if thread.is_alive() or "error" in err:
        raise SystemExit(f"phase 11 part C: the run did not end ({err.get('error')!r})")
    for qid, (d, s) in enumerate(picks):
        got = state["answers"][qid]
        top = got[0] if got else {}
        meta = top.get("metadata") or {}
        if (len(got) != sz["slide_k"] or top.get("text") != docs[d * n_slides + s]["data"]
                or meta.get("slide") != s or meta.get("slide_count") != n_slides
                or meta.get("path") != f"/decks/{d:03d}.pdf"):
            raise SystemExit(f"phase 11 part C: query {qid} (deck {d}, slide {s}) got {got[:1]}")
    if vision_calls[0] != total:
        raise SystemExit(f"phase 11 part C: {vision_calls[0]} vision calls for {total} slides")
    if device is None and launches < 1:
        raise SystemExit("phase 11 part C: the query path never launched score_pages")
    out = {"decks": n_decks, "slides": total, "dim": dim, "ingest_s": ingest_s,
           "queries": len(picks), "launches": launches, "seconds": clock() - t0}
    log(f"  part C: SlidesDocumentStore: {n_decks} decks of {n_slides} slides parsed by "
        f"SlideParser ({vision_calls[0]} vision calls) and indexed in {ingest_s:.2f} s; the "
        f"embedder's width ({dim}) read with no encode; {len(picks)} exact slide texts first "
        f"with slide / slide_count / path; score_pages launches {launches}; part C "
        f"{out['seconds']:.1f} s [{card}]")
    return out


def run_chaos(torch, args, card: str, docs: list, device=None, encoder_config=None,
              sizes: "dict | None" = None, params: "str | None" = None) -> tuple:
    """Phase 11 (``chaos-16k``; ``device="cpu"``, small ``sizes``, a tiny
    ``encoder_config`` and ``params``, a pickled reference weight tree,
    rehearse it). Returns the report and the launches of each part's kernels
    (``chaos``: part A, ``resume``: part B's Run 2, ``slides``: part C)."""
    import shutil
    import tempfile

    from pathway_tpu_torch.internals.chaos import reset_chaos

    sz = {**CHAOS, **(sizes or {})}
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in CHAOS_ENV}

    def clear_env() -> None:
        for k in CHAOS_ENV:
            os.environ.pop(k, None)
        reset_chaos()

    clear_env()
    enc_spec = None
    if encoder_config is not None:
        enc_spec = {k: getattr(encoder_config, k) for k in (
            "vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
            "max_position", "type_vocab_size", "layer_norm_eps")}
        enc_spec["dtype"] = str(encoder_config.dtype).replace("torch.", "")
    enc = persist_encoder({"encoder_config": enc_spec, "params": params})
    tmp = tempfile.mkdtemp(prefix="pw_chaos_")
    b = None
    try:
        b = chaos_kill_start(args, docs, sz, tmp, device, enc_spec, params)
        a = chaos_index(torch, args, card, sz, device)
        clear_env()
        resume = chaos_kill_finish(torch, args, card, docs, sz, b, device, *enc)
        clear_env()
        c = chaos_slides(torch, args, card, docs, sz, device, encoder_config)
    finally:
        if b is not None and b["child"].poll() is None:
            b["child"].kill()
            b["child"].wait(60)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_chaos()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"card": card, "index": a, "kill_resume": resume, "slides": c,
           "seconds": time.perf_counter() - t_phase}
    log(f"  phase 11: part A {a['seconds']:.1f} s (beside the child), part B's child "
        f"{resume['child_s']:.1f} s and Run 2 {resume['run2']['seconds']:.1f} s, part C "
        f"{c['seconds']:.1f} s; the phase {out['seconds']:.1f} s [{card}]")
    return out, {"chaos": a["launches"], "resume": resume["launches"], "slides": c["launches"]}


class Recorder:
    """Records the arguments of the next call of ``module.name`` (the call
    itself goes through unchanged), for timing a kernel at the shapes the
    path gave it; with ``size``, of the call whose arguments are the largest
    by it instead."""

    def __init__(self, module, name: str, size=None):
        self.module, self.name, self.size = module, name, size
        self.orig = getattr(module, name)
        self.args = None

    def __enter__(self):
        def wrapper(*args):
            if self.args is None or (self.size and self.size(args) > self.size(self.args)):
                self.args = args
            return self.orig(*args)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def blocks_bound(blocks, groups, d: int, quant: bool, nq: int):
    """The least time the card could take to score a work list: the bytes
    it must move (each probed block's rows, scales, norms and mask once, the
    queries, every score written) over the memory rate, against its
    multiply-adds over the int8 (or f32) peak. Returns (ms, by, bytes, ops)."""
    nbytes = nq * d * (1 if quant else 4) + nq * 8
    ops = 0.0
    for b, payload in enumerate(blocks):
        n = payload[0].shape[0]
        g = int(groups.offsets[b + 1] - groups.offsets[b])
        nbytes += n * d * (1 if quant else 4) + n * (12 if quant else 8) + g * n * 4
        ops += 2.0 * g * n * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / (H100_INT8_OPS if quant else H100_F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops


def measure_blocks(torch, args, quant: bool, label: str, card: str) -> dict:
    """Hold a recorded block-scorer call against its plain version on the
    card (int8 bitwise, fp32 within phase 3's tolerance), time kernel,
    plain version and the dot alone as one ``torch.matmul``, and bound it."""
    from pathway_tpu_torch.ops import score_blocks as sb

    if quant:
        blocks, groups, q, qs, qn, width, metric = args
        kernel = lambda: sb._score_blocks_cuda(1, blocks, groups, q, qs, qn, width, metric)  # noqa: E731
        plain = lambda: sb.quant_score_blocks_plain(blocks, groups, q, qs, qn, width, metric)  # noqa: E731
    else:
        blocks, groups, q, qn, width, metric = args
        kernel = lambda: sb._score_blocks_cuda(0, blocks, groups, q, None, qn, width, metric)  # noqa: E731
        plain = lambda: sb.score_blocks_plain(blocks, groups, q, qn, width, metric)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise SystemExit(f"{label}: kernel and plain version disagree on which scores are finite")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    if quant:
        ok = torch.equal(got, want)
    else:  # 1e-5 of the dot's scale: |q|^2 + |d|^2, or 1 for cos
        tol = torch.full_like(want, 1e-5)
        if metric != "cos":
            for b, payload in enumerate(blocks):
                lo, hi = int(groups.offsets[b]), int(groups.offsets[b + 1])
                for qi, c in zip(groups.queries[lo:hi].tolist(), groups.cols[lo:hi].tolist()):
                    n = payload[0].shape[0]
                    tol[qi, c : c + n] = 1e-5 * (qn[qi] + payload[1])
        ok = bool(((got[fin] - want[fin]).abs() <= tol[fin]).all())
    if not ok:
        raise SystemExit(f"{label}: kernel disagrees with its plain version (max |err| {err:.3g})")
    wrapper_ms = cuda_time_ms(kernel, 20)
    launch, _out = sb.score_blocks_launcher(1 if quant else 0, blocks, groups, q,
                                            qs if quant else None, qn, width, metric)
    ms = cuda_time_ms(launch, 50)
    graph_ms = graph_time_ms(lambda: keeping(sb.score_blocks_launcher(
        1 if quant else 0, blocks, groups, q, qs if quant else None, qn, width, metric)))
    plain_ms = cuda_time_ms(plain, 3, warmup=1)
    rows = torch.cat([p[0] for p in blocks]).float()
    qf = q.float()
    library_ms = cuda_time_ms(lambda: torch.matmul(qf, rows.T), 20)
    d = q.shape[1]
    bound, by, nbytes, ops = blocks_bound(blocks, groups, d, quant, q.shape[0])
    n_rows = sum(p[0].shape[0] for p in blocks)
    split = wrapper_split(torch, sb, quant, args)
    log(f"  {label}: {len(blocks)} blocks, {n_rows} rows, {len(groups.queries)} (block, query) "
        f"entries, q={q.shape[0]} d={d}: kernel {ms:.4f} ms (by graph replay {graph_ms:.4f} "
        f"ms; the wrapper with its checks and "
        f"work-list copy {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, the dot "
        f"alone as torch.matmul {library_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
        f"{bound / ms:.1%} of it), max |err| vs plain {err:.3g} "
        f"({'bitwise' if quant else 'within 1e-5 of the scale'}) [{card}]")
    log("    wrapper host us per call: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f" [{card}]")
    return {"ms": ms, "graph_ms": graph_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "ops": ops, "max_abs_err": err,
            "blocks": len(blocks), "rows": n_rows, "entries": len(groups.queries),
            "q": int(q.shape[0]), "width": int(width), "wrapper_host_us": split}


def wrapper_split(torch, sb, quant: bool, args, reps: int = 100) -> dict:
    """Host microseconds per call of each part of a block-scorer call, each
    part run alone ``reps`` times (median of 3 rounds): ``total`` is the
    whole wrapper; ``prepare`` its checks, work list, copy and output fill;
    ``list``, ``copy`` and ``fill`` those parts alone; ``launch`` the C call;
    ``checks`` what ``prepare`` spends beyond list, copy and fill."""
    import numpy as np

    mode = 1 if quant else 0
    if quant:
        blocks, groups, q, qs, qn, width, metric = args
    else:
        (blocks, groups, q, qn, width, metric), qs = args, None
    dev, nq = q.device, q.shape[0]
    table = sb.work_table(blocks, groups, mode)[0]
    # a wrapper without ``to_card`` pins the table and copies it inline
    to_card = getattr(sb, "to_card", None) or (
        lambda t, d: torch.from_numpy(t).pin_memory().to(d, non_blocking=True))
    launch = sb.score_blocks_launcher(mode, blocks, groups, q, qs, qn, width, metric)[0]
    parts = {
        "total": lambda: sb._score_blocks_cuda(mode, blocks, groups, q, qs, qn, width, metric),
        "prepare": lambda: sb.score_blocks_launcher(mode, blocks, groups, q, qs, qn, width,
                                                    metric),
        "list": lambda: sb.work_table(blocks, groups, mode),
        "copy": lambda: to_card(table, dev),
        "fill": lambda: torch.full((nq, width), -np.inf, dtype=torch.float32, device=dev),
        "launch": launch,
    }
    us = host_us(torch, parts, reps)
    us["checks"] = us["prepare"] - us["list"] - us["copy"] - us["fill"]
    return us


def host_us(torch, parts: dict, reps: int) -> dict:
    """Host microseconds per call of each function, each run alone ``reps``
    times after a warm-up call (median of 3 rounds)."""
    us = {}
    for name, fn in parts.items():
        fn()
        rounds = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            rounds.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
        us[name] = statistics.median(rounds)
    return us


# the block scorers' shapes on the tiered path (1M chunks, d = 384), for
# ``--kernels-only``: blocks, rows in all, (block, query) entries, queries
SYNTHETIC_SHAPES = {
    "8-query batch": (34, 651_076, 64, 8),
    "one request": (8, 112_000, 8, 1),
    "concurrent batch": (60, 880_000, 128, 16),
}


def synthetic_work(torch, seed: int, shape, d: int, quant: bool, device: str = "cuda"):
    """A seeded work list on ``device``, laid out as the tiered store lays
    out a batch: ``n_blocks`` blocks of ragged sizes (10% dead rows), each
    probed by at least one query, ``n_entries`` distinct (block, query)
    entries, each query's blocks side by side in its row of the output.
    Returns the arguments of ``quant_score_blocks`` (or ``score_blocks``)
    for the path's metric, cos."""
    import numpy as np

    from pathway_tpu_torch.ops import score_blocks as sb

    n_blocks, n_rows, n_entries, nq = shape
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 3, size=n_blocks) * rng.integers(6_000, 12_000, size=n_blocks)
    sizes = np.maximum(1, sizes * n_rows // sizes.sum())
    sizes[-1] += n_rows - sizes.sum()
    pairs = {(b, int(rng.integers(nq))) for b in range(n_blocks)}
    while len(pairs) < n_entries:
        pairs.add((int(rng.integers(n_blocks)), int(rng.integers(nq))))
    pairs = sorted(pairs)
    widths = np.zeros(nq, dtype=np.int64)
    cols = []
    for b, qi in pairs:
        cols.append(widths[qi])
        widths[qi] += sizes[b]
    offsets = np.searchsorted([b for b, _ in pairs], np.arange(n_blocks + 1))
    groups = sb.BlockGroups(offsets.astype(np.int64), np.array([qi for _, qi in pairs]),
                            np.array(cols, dtype=np.int64))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*size):
        return torch.rand(*size, generator=gen, device=dev)

    def codes(n):
        return torch.randint(-127, 128, (n, d), generator=gen, device=dev, dtype=torch.int8)

    blocks = []
    for n in sizes.tolist():  # exact norms of the rows the codes stand for
        mask = torch.where(rand(n) < 0.1, -np.inf, 0.0)
        if quant:
            c, s = codes(n), rand(n) * 0.01 + 1e-3
            blocks.append((c, s, ((c.float() * s[:, None]) ** 2).sum(1), mask))
        else:
            v = rand(n, d) * 2 - 1
            blocks.append((v, (v * v).sum(1), mask))
    if quant:
        q, qs = codes(nq), rand(nq) * 0.01 + 1e-3
        qn = ((q.float() * qs[:, None]) ** 2).sum(1)
        return blocks, groups, q, qs, qn, int(widths.max()), "cos"
    q = rand(nq, d) * 2 - 1
    return blocks, groups, q, (q * q).sum(1), int(widths.max()), "cos"


def kernels_only(torch, args, card: str) -> dict:
    """The block scorers and the int8 probe alone at the tiered path's
    shapes, on seeded inputs: each held against its plain version, timed
    (also by graph replay, beside the launch floor), bounded, and the block
    scorers' wrapper and the probe step split by part."""
    floor = launch_floor(torch, card)
    out = {"empty": floor}
    for label, rec in probe_phase(torch, args.seed, card, floor).items():
        out[f"quant_probe, {label}"] = rec
    for i, (label, shape) in enumerate(SYNTHETIC_SHAPES.items()):
        work = synthetic_work(torch, args.seed + i, shape, 384, True)
        out[f"quant_score_blocks, {label}"] = measure_blocks(
            torch, work, True, f"quant_score_blocks, {label}", card)
        del work
    work = synthetic_work(torch, args.seed, SYNTHETIC_SHAPES["one request"], 384, False)
    out["score_blocks (fp32), one request"] = measure_blocks(
        torch, work, False, "score_blocks (fp32), one request", card)
    return out


def probe_bound(c_pad: int, q_pad: int, d: int):
    """The least time the card could take for one probe: the table, the
    query codes, the scales and norms read once and the affinity written
    once, over the memory rate, against its multiply-adds over the int8
    peak. Returns (ms, by)."""
    nbytes = c_pad * d + q_pad * d + 8 * c_pad + 4 * q_pad + 4 * q_pad * c_pad
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * q_pad * c_pad * d / H100_INT8_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measure_probe(torch, args, label: str, card: str, floor: dict) -> dict:
    """Hold the int8 probe against its plain version (bitwise; pad
    centroids -inf) and time it: by graph replay (the device alone), in a
    Python loop of launches, the wrapper with its checks, the plain version
    and the dot as one ``torch.matmul``; beside the launch floor."""
    from pathway_tpu_torch.ops import knn_quant

    qc, cs, cn, q, qs = args
    got = knn_quant.quant_probe_cuda(*args)
    want = knn_quant.quant_probe_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"quant_probe, {label}: the kernel disagrees with its plain version")
    if not bool(torch.isneginf(got[:, ~torch.isfinite(cn)]).all()):
        raise SystemExit(f"quant_probe, {label}: a pad centroid scored above -inf")
    wrapper_ms = cuda_time_ms(lambda: knn_quant.quant_probe_cuda(*args), 50)
    ms = cuda_time_ms(keeping(knn_quant.quant_probe_launcher(*args)), 100)
    graph_ms = graph_time_ms(lambda: keeping(knn_quant.quant_probe_launcher(*args)))
    plain_ms = cuda_time_ms(lambda: knn_quant.quant_probe_plain(*args), 20)
    qf, cf = q.float(), qc.float()
    library_ms = cuda_time_ms(lambda: torch.matmul(qf, cf.T), 50)
    (c_pad, d), q_pad = qc.shape, q.shape[0]
    bound, by = probe_bound(c_pad, q_pad, d)
    log(f"  quant_probe, {label}: C={c_pad} q={q_pad} d={d}: by graph replay {graph_ms:.5f} ms "
        f"per launch ({graph_ms / floor['graph_ms']:.2f}x the launch floor's "
        f"{floor['graph_ms']:.5f}), in a Python loop {ms:.5f} ms (floor {floor['loop_ms']:.5f}), "
        f"the wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
        f"{library_ms:.4f} ms, bound {bound:.6f} ms ({by}; {bound / graph_ms:.2%} of the graph "
        f"time), bitwise equal to plain [{card}]")
    return {"ms": ms, "graph_ms": graph_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
            "c_pad": c_pad, "q_pad": q_pad, "d": d, "floor_graph_ms": floor["graph_ms"],
            "floor_loop_ms": floor["loop_ms"]}


def probe_table(seed: int, n_real: int, d: int):
    """A seeded coarse-probe table as the tiered store builds it from
    ``n_real`` centroids (``_quant_cents``): int8 codes, scales and
    ``|c|^2``, padded to a power of two of at least 8 rows with
    ``cn = +inf``. Host arrays."""
    import numpy as np

    cents = np.random.default_rng(seed).normal(size=(n_real, d)).astype(np.float32)
    c_pad = max(8, 1 << (n_real - 1).bit_length())
    codes = np.zeros((c_pad, d), dtype=np.int8)
    scales = np.ones(c_pad, dtype=np.float32)
    cn = np.full(c_pad, np.inf, dtype=np.float32)
    m = np.max(np.abs(cents), axis=1)
    scales[:n_real] = np.where(m > 0.0, m / 127.0, 1.0)
    codes[:n_real] = np.clip(np.rint(cents / scales[:n_real, None]), -127, 127).astype(np.int8)
    cn[:n_real] = np.sum(cents * cents, axis=1)
    return codes, scales, cn


def probe_args(torch, table, q):
    """The probe's five card tensors for the float queries ``q``, padded
    as the store pads them (``next_pow2(max(8, nq))`` rows)."""
    import numpy as np

    from pathway_tpu_torch.ops import knn_quant

    nq, d = q.shape
    q_pad = max(8, 1 << (nq - 1).bit_length())
    codes, scales = knn_quant.quantize_queries(q)
    pq = np.zeros((q_pad, d), dtype=np.int8)
    pq[:nq] = codes
    ps = np.ones(q_pad, dtype=np.float32)
    ps[:nq] = scales
    return [torch.from_numpy(a).cuda() for a in (*table, pq, ps)]


def probe_step_parts(torch, table, q, n_clusters: int, n_probe: int):
    """The tiered store's int8 probe step (``knn_tiers.search_batch`` from
    the queries to the probed set) cut into its parts, each a function, for
    the float queries ``q`` against the host table ``(codes, scales, cn)``:
    the padded codes, their scales and ``|q|^2`` packed into the store's
    pinned buffer and sent in one copy, the probe on views of it, the
    affinity back through pinned memory, ``np.argpartition``; the block
    scorer then takes views of the same copy. Returns (parts, copies of
    query data to the card per search, counted in ``total``)."""
    import numpy as np

    from pathway_tpu_torch.ops import knn_quant, knn_tiers

    dev = torch.device("cuda")
    ptable = knn_quant.ProbeTable(*(torch.from_numpy(a).to(dev) for a in table))
    stage = knn_tiers._QueryStage(dev)
    c_pad = table[0].shape[0]
    nq, d = q.shape
    q_pad = max(8, 1 << (nq - 1).bit_length())
    q_codes, q_scales = knn_quant.quantize_queries(q)
    qn = np.sum(q * q, axis=1)
    spec = ((q_codes, q_pad, 0), (q_scales, q_pad, 1.0), (qn, nq, 0))
    n, layout = stage.pack(spec)
    pq, ps, _qn = stage.upload(n, layout)
    launch, out = ptable.launcher(pq, ps, stage.stream)
    launch()
    aff = stage.fetch(out[:nq])[:, :n_clusters].copy()

    def total():
        codes, scales = knn_quant.quantize_queries(q)
        norms = np.sum(q * q, axis=1)
        p, s, _n = stage.send(((codes, q_pad, 0), (scales, q_pad, 1.0), (norms, nq, 0)))
        a = stage.fetch(ptable.scores(p, s, stage.stream)[:nq])[:, :n_clusters]
        return np.argpartition(a, -n_probe, axis=1)[:, -n_probe:], p[:nq], s[:nq]

    sends = stage.sends
    total()
    copies = stage.sends - sends
    parts = {
        "total": total,
        "quantize": lambda: knn_quant.quantize_queries(q),
        "pack": lambda: stage.pack(spec),
        "copy": lambda: stage.upload(n, layout),
        "prepare": lambda: ptable.launcher(pq, ps, stage.stream),
        "alloc": lambda: torch.empty((q_pad, c_pad), dtype=torch.float32, device=dev),
        "launch": launch,
        "copy back + sync": lambda: stage.fetch(out[:nq]),
        "argpartition": lambda: np.argpartition(aff, -n_probe, axis=1)[:, -n_probe:],
        "scorer views": lambda: (pq[:nq], ps[:nq]),
    }
    return parts, copies


def probe_step_split(torch, table, q, n_clusters: int, label: str, card: str,
                     n_probe: int = 8, reps: int = 100) -> dict:
    """Host microseconds per search of each part of the probe step
    (:func:`probe_step_parts`); ``checks`` is what the launcher's
    preparation spends beyond the output's allocation."""
    parts, copies = probe_step_parts(torch, table, q, n_clusters, n_probe)
    us = host_us(torch, parts, reps)
    us["checks"] = us["prepare"] - us["alloc"]
    log(f"    probe step, {label} (nq={q.shape[0]}, C={table[0].shape[0]}): host us per search: "
        + ", ".join(f"{k} {v:.1f}" for k, v in us.items())
        + f"; copies of query data to the card per search: {copies} [{card}]")
    return {"host_us": us, "query_copies": copies}


# the probe's shapes: (label, real centroids, queries); one request and the
# 8-query batch both pad to 8 rows, the concurrent phase's largest batch to
# 32; 3,000 centroids stand for a store whose clusters have split many times
PROBE_SHAPES = (
    ("one request", 71, 1),
    ("8-query batch", 71, 8),
    ("largest concurrent batch", 71, 32),
    ("split store, 8-query batch", 3000, 8),
    ("split store, 32 queries", 3000, 32),
)


def probe_phase(torch, seed: int, card: str, floor: dict, table=None, queries=None) -> dict:
    """The probe at every shape of ``PROBE_SHAPES``: the kernel against its
    plain version and timed, and the probe step's host time split by part.
    ``table`` / ``queries``: the served store's table and real queries for
    its 71-centroid rows (else seeded)."""
    import numpy as np

    out = {}
    tables = {}
    for i, (label, n_real, nq) in enumerate(PROBE_SHAPES):
        if n_real not in tables:
            tables[n_real] = probe_table(seed + n_real, n_real, 384)
        tab = table if (table is not None and n_real == 71) else tables[n_real]
        if queries is not None and nq <= len(queries):
            q = queries[:nq]
        else:
            q = np.random.default_rng(seed + i).normal(size=(nq, tab[0].shape[1])).astype(
                np.float32)
        args = probe_args(torch, tab, q)
        rec = measure_probe(torch, args, label, card, floor)
        n_clusters = int(np.isfinite(tab[2]).sum())
        rec.update(probe_step_split(torch, tab, q, n_clusters, label, card))
        out[label] = rec
    return out


def check_invariance(torch, qargs, fargs, pargs) -> None:
    """Every new kernel's scores are the same bits at two block capacities
    (a block and its first half) and two batch positions (its query as row
    0, then as the last row of the batch)."""
    from pathway_tpu_torch.ops import knn_quant
    from pathway_tpu_torch.ops import score_blocks as sb

    import numpy as np

    for quant, args in ((True, qargs), (False, fargs)):
        blocks, groups = args[0], args[1]
        q, qn, metric = args[2], args[-3], args[-1]
        qs = args[3] if quant else None
        b = max(range(len(blocks)), key=lambda i: blocks[i][0].shape[0])
        full = blocks[b]
        n = full[0].shape[0]
        half = tuple(t[: max(1, n // 2)].contiguous() for t in full)
        last = q.shape[0] - 1
        q2, qn2 = q.clone(), qn.clone()
        q2[last], qn2[last] = q[0], qn[0]
        qs2 = None
        if quant:
            qs2 = qs.clone()
            qs2[last] = qs[0]

        def run(payload, qv, qsv, qnv, row):
            g = sb.BlockGroups(np.array([0, 1]), np.array([row]), np.array([0]))
            m = payload[0].shape[0]
            return sb._score_blocks_cuda(1 if quant else 0, [payload], g, qv, qsv, qnv, m,
                                         metric)[row]

        a = run(full, q, qs, qn, 0)
        h = run(half, q, qs, qn, 0)
        z = run(full, q2, qs2, qn2, last)
        if not (torch.equal(a[: h.shape[0]], h) and torch.equal(a, z)):
            raise SystemExit(f"{'quant_score_blocks' if quant else 'score_blocks'}: scores "
                             "change with the block's capacity or the query's batch position")
    qc, cs, cn, q, qs = pargs
    c_now = int(torch.isfinite(cn).sum())
    wide = [torch.cat([t, t[-1:].expand(t.shape[0], *t.shape[1:])]) for t in (qc, cs, cn)]
    q2, qs2 = q.flip(0).contiguous(), qs.flip(0).contiguous()
    a = knn_quant.quant_probe_cuda(qc, cs, cn, q, qs)
    w = knn_quant.quant_probe_cuda(*[t.contiguous() for t in wide], q, qs)
    f = knn_quant.quant_probe_cuda(qc, cs, cn, q2, qs2).flip(0)
    if not (torch.equal(a[:, :c_now], w[:, :c_now]) and torch.equal(a, f)):
        raise SystemExit("quant_probe: scores change with the centroid table's capacity or the "
                         "query's batch position")
    log("  invariance: quant_score_blocks, score_blocks and quant_probe give the same bits at "
        "two block capacities and two batch positions on the card")


# rows of the residency check, spread evenly over the served rows (so that
# the smoke stays within 600 s): their int8 payload exceeds the 128 MiB budget
RESIDENCY_ROWS = 1 << 18


def residency_check(torch, store, queries, card: str) -> dict:
    """Two stores per mode (int8, fp32) on ``RESIDENCY_ROWS`` rows spread evenly
    over the main store's corpus and on its centroids: one all hot, one with the
    128 MiB budget (under the int8 payload of those rows) and a spill
    directory. Settle on a narrow working set (clusters freeze), then search
    ``queries``: ids and scores must be bitwise equal. Returns the census,
    the fp32 path's launches and recorded calls of each block scorer (an
    8-query batch and one request)."""
    import shutil
    import tempfile

    import numpy as np

    from pathway_tpu_torch.ops import _cuda, knn_tiers

    keys, vecs = store.export_rows()
    pick = np.linspace(0, len(keys), min(RESIDENCY_ROWS, len(keys)), endpoint=False).astype(int)
    keys, vecs = [keys[i] for i in pick], vecs[pick]
    cents = np.array(store._cents, dtype=np.float32)
    q = queries.float().cpu().numpy()
    budget = int(TIERED_KNOBS["PATHWAY_IVF_HBM_BUDGET_MB"]) << 20
    out = {}
    for quant in ("int8", "off"):
        spill_dir = tempfile.mkdtemp(prefix="pw-ivf-spill-")
        try:
            t0 = time.perf_counter()
            stores = {
                "hot": knn_tiers.TieredIvfKnnStore(
                    store.dim, metric=store.metric, n_clusters=store._n_clusters_base,
                    n_probe=store.n_probe, quant=quant, hbm_budget_bytes=0),
                "budget": knn_tiers.TieredIvfKnnStore(
                    store.dim, metric=store.metric, n_clusters=store._n_clusters_base,
                    n_probe=store.n_probe, quant=quant, hbm_budget_bytes=budget,
                    spill_store=knn_tiers.DirSpillStore(spill_dir)),
            }
            for s in stores.values():
                s.add_many(keys, vecs)
                s.set_centroids(cents)
            build_s = time.perf_counter() - t0
            _cuda.reset_launch_counts()
            for _ in range(6):  # a narrow working set: unprobed clusters freeze
                for s in stores.values():
                    s.search_batch(q[:4], 10)
            time.sleep(1.0)
            res = {name: s.search_batch(q, 10) for name, s in stores.items()}
            torch.cuda.synchronize()
            launches = dict(_cuda.KERNEL_LAUNCHES)
            name = "quant_score_blocks" if quant == "int8" else "score_blocks"
            with Recorder(knn_tiers, name) as rec:
                stores["budget"].search_batch(q[:8], 10)
            with Recorder(knn_tiers, name) as rec1:
                stores["budget"].search_batch(q[-1:], 10)
            stats = stores["budget"].tier_stats()
            same = (np.array_equal(res["hot"][0], res["budget"][0])
                    and np.array_equal(res["hot"][1], res["budget"][1]))
            log(f"  residency {quant}: {len(keys)} rows, {stats['n_clusters']} clusters (stores "
                f"built in {build_s:.1f}s); budgeted store hot {stats['hot']} / cold "
                f"{stats['cold']} / spilled {stats['spilled']} (spills {stats['spills']}), hot "
                f"bytes {stats['hot_bytes']} of {budget}, {stats['staged_blocks']} blocks staged; "
                f"64 queries: ids and scores {'bitwise equal' if same else 'DIFFER'} to the "
                f"all-hot store; launches {launches.get(name, 0)} [{card}]")
            if not same:
                raise SystemExit(f"residency changed the {quant} store's results")
            if stats["hot_bytes"] > budget:
                raise SystemExit("the budgeted store's hot bytes exceed its budget")
            if launches.get(name, 0) <= 0:
                raise SystemExit(f"the {quant} tiered path never launched {name}")
            out[quant] = {"census": {k: stats[k] for k in (
                "hot", "cold", "spilled", "spills", "hot_bytes", "staged_blocks",
                "probe_hot", "probe_cold", "probe_spilled")}, "launches": launches,
                "build_s": build_s, "recorded": rec.args, "recorded_one": rec1.args}
            for s in stores.values():
                s.close()
        finally:
            shutil.rmtree(spill_dir, ignore_errors=True)
    return out


def run_tiered(torch, args, card: str, docs: list):
    """The tiered int8 store behind ``VectorStoreServer(index_factory="ivf")``
    on the same corpus, its knobs set before the server is built."""
    import numpy as np

    from pathway_tpu_torch.engine import telemetry
    from pathway_tpu_torch.engine.brownout import reset_brownout
    from pathway_tpu_torch.ops import _cuda, knn_quant, knn_tiers
    from pathway_tpu_torch.ops.knn import topk_lowest_first

    saved = {k: os.environ.get(k) for k in list(TIERED_KNOBS) + ["PATHWAY_IVF_TIERED"]}
    os.environ.update(TIERED_KNOBS)
    os.environ.pop("PATHWAY_IVF_TIERED", None)
    sl = Slice(docs, BATCH, args.seed)
    launches, phase = {}, {}

    def read_counts(name: str) -> None:
        torch.cuda.synchronize()
        phase[name] = dict(_cuda.KERNEL_LAUNCHES)
        for k, n in _cuda.KERNEL_LAUNCHES.items():
            launches[k] = launches.get(k, 0) + n

    try:
        if not sl.embedder.encoder.quant_encode:
            raise SystemExit("the encoder is not in lattice mode under PATHWAY_IVF_QUANT=int8")
        svc = sl.embedder.pipeline.service
        if not svc.wait_warm(600.0) or svc.prewarm_error:
            raise SystemExit(f"the encoder service's pre-warm failed: {svc.prewarm_error}")
        from pathway_tpu_torch.engine.profile import get_profiler, reset_profile

        telemetry.stage_reset("index.")
        reset_profile()
        _cuda.reset_launch_counts()
        ingest = sl.ingest()
        metrics = {"scrapes": [], "operators": {}}
        metrics["operators"]["ingest"] = operator_table(
            sl, {}, operator_totals(), get_profiler().commits, "tiered ingest", card)
        metrics["shapes"] = {"ingest commit": ring_shape(min_rows=BATCH // 2)}
        metrics["scrapes"].append(check_scrape(
            sl, "tiered, after ingest", card,
            engine=sl.client.get_vectorstore_statistics()["engine"]))
        asks = sl.asks(args.requests)
        ret = sl.retrieve(asks)
        read_counts("tiered_ingest_and_solo")
        solo_need = SERVING_HISTOGRAMS + TIERED_HISTOGRAMS[1:4]
        metrics["scrapes"].append(check_scrape(
            sl, "tiered, after the solo phase", card, solo_need,
            sl.client.get_vectorstore_statistics()["engine"]))
        beside_s4("tiered", ingest, ret, card)
        store = sl.store
        if not isinstance(store, knn_tiers.TieredIvfKnnStore) or store.quant != "int8":
            raise SystemExit(f"VectorStoreServer built {type(store).__name__}, not the int8 "
                             "tiered store")
        log(f"  tiered ingest: {ingest['docs']} docs in {ingest['ingest_s']:.1f}s = "
            f"{ingest['docs_per_s']:.0f} docs/s through pw.run, median commit "
            f"{ingest['commit_median_s']:.2f}s (first {ingest['commit_log'][0][0]:.2f}s) [{card}]")
        log(f"  tiered first retrieve (trains, places every row in cluster blocks, quantizes): "
            f"{ret['first_retrieve_ms']:.1f} ms; {store.n_clusters} clusters, n_probe "
            f"{store.n_probe} [{card}]")
        log(f"  tiered solo retrieve: {len(ret['lat_ms'])} sequential requests, p50 "
            f"{ret['p50_ms']:.2f} ms, p99 {ret['p99_ms']:.2f} ms [{card}]")
        for name in (knn_quant.QUANT_PROBE, "quant_score_blocks"):
            if phase["tiered_ingest_and_solo"].get(name, 0) <= 0:
                raise SystemExit(f"the tiered retrieve path never launched {name}")
        one = asks[-1][2]
        q1 = sl.embedder.embed_queries([one])
        t = host_times_ms({
            "request": lambda: sl.client.query(f"{one} zt{time.perf_counter_ns()}", k=10),
            "index_search": lambda: store.search_batch(q1, 10),
        })
        log(f"  tiered solo stages (ms, median of 9): request {t['request']:.2f}, "
            f"index_search {t['index_search']:.2f} [{card}]")
        stats = store.tier_stats()
        sends, searches = stats["query_sends"], store._batches
        log(f"  tiered query data to the card: {sends} copies in {searches} searches "
            f"({sends / max(searches, 1):.2f} per search) [{card}]")
        if sends > searches:
            raise SystemExit("a tiered search copied its query data to the card more than once")
        idx = telemetry.stage_snapshot("index.")
        probes = stats["probe_hot"] + stats["probe_cold"] + stats["probe_spilled"]
        census = {k: stats[k] for k in ("hot", "cold", "spilled", "hot_bytes", "budget_bytes",
                                        "staged_blocks", "staged_bytes", "query_sends", "probe_hot",
                                        "probe_cold", "probe_spilled", "prefetch_stall_s")}
        census.update(promotions=idx.get("index.promotions", 0.0),
                      evictions=idx.get("index.demotions", 0.0),
                      prefetch_requests=idx.get("index.prefetch_requests", 0.0),
                      hit_ratio=stats["probe_hot"] / max(probes, 1))
        log(f"  tier census: hot {stats['hot']}, cold {stats['cold']}, spilled "
            f"{stats['spilled']}; hot bytes {stats['hot_bytes']} of {stats['budget_bytes']}; "
            f"promotions {census['promotions']:.0f}, evictions {census['evictions']:.0f}; "
            f"probes {probes}: hot {stats['probe_hot']} (hit ratio {census['hit_ratio']:.3f}), "
            f"cold {stats['probe_cold']}, spilled {stats['probe_spilled']}; "
            f"{stats['staged_blocks']} blocks staged ({stats['staged_bytes']} bytes); prefetch "
            f"stall {stats['prefetch_stall_s']:.4f}s [{card}]")
        if stats["hot_bytes"] > stats["budget_bytes"]:
            raise SystemExit("hot bytes exceed the budget")

        solo_texts = {a[2] for a in asks}
        conc = [a for a in sl.asks(args.requests + args.concurrent + 1024)[N_CHECKED:]
                if a[2] not in solo_texts][: args.concurrent]
        ops0, commits0 = operator_totals(), get_profiler().commits
        _cuda.reset_launch_counts()
        with Recorder(knn_tiers, "quant_score_blocks", size=lambda a: len(a[1].queries)) as rc:
            cc = sl.concurrent(conc, args.clients)
        read_counts("tiered_concurrent")
        record_tables("tiered", sl.server.runner)
        metrics["operators"]["concurrent"] = operator_table(
            sl, ops0, operator_totals(), get_profiler().commits - commits0,
            "tiered concurrent retrieve", card, requests=len(conc))
        metrics["shapes"]["concurrent commit"] = ring_shape(min_rows=1)
        metrics["plane_us_per_commit"] = plane_cost(sl, card, "tiered", metrics["shapes"])
        if cc["shed"] or cc["route_shed_total"]:
            raise SystemExit(f"the tiered concurrent phase shed {cc['shed']} requests")
        if any(len(a) != 10 or not all(np.isfinite(x["dist"]) for x in a) for a in cc["answers"]):
            raise SystemExit("a tiered concurrent answer has fewer than 10 results")
        log(f"  tiered concurrent: {cc['requests']} requests from {cc['clients']} threads, "
            f"{cc['requests_per_s']:.1f} requests/s, p50 {cc['p50_ms']:.2f} ms, p99 "
            f"{cc['p99_ms']:.2f} ms, shed {cc['shed']}, {gc_line(cc)} [{card}]")

        # recall@10 (not counted): the served index against exact cosine over
        # the same lattice-rounded rows the store holds
        qv = torch.cat([sl.embedder.embed_queries([a[2]]) for a in asks])
        keys, vecs = store.export_rows()
        vt = torch.from_numpy(vecs).cuda()
        vt = vt / torch.clamp(torch.linalg.norm(vt, dim=1, keepdim=True), min=1e-30)
        key_pos = {k: i for i, k in enumerate(keys)}
        hits = 0
        for start in range(0, len(asks), N_CHECKED):
            qb = qv[start : start + N_CHECKED]
            _s, slots, _v = store.search_batch(qb, 10)
            qn_ = qb / torch.clamp(torch.linalg.norm(qb, dim=1, keepdim=True), min=1e-30)
            truth = topk_lowest_first(qn_ @ vt.T, 10)[1].cpu().numpy()
            for r in range(qb.shape[0]):
                got = {key_pos[store.key_of[int(s)]] for s in slots[r] if s >= 0}
                hits += len(got & set(truth[r].tolist()))
        recall = hits / (10 * len(asks))
        log(f"  tiered recall@10 vs exact search over the same lattice-rounded rows: "
            f"{recall:.4f} over {len(asks)} queries (n_probe {store.n_probe}, rescore depth "
            f"{knn_quant.rescore_k()}) [{card}]")
        del vt
        # the store's own recall audit (host exact search over its rows; it
        # feeds pathway_ivf_quant_recall_ratio)
        audit = store.quant_recall_audit(qv[:N_CHECKED].float().cpu().numpy(), k=10)
        log(f"  tiered quant_recall_audit over the first {N_CHECKED} queries: {audit:.4f} [{card}]")
        metrics["recall_audit"] = audit
        metrics["scrapes"].append(check_scrape(
            sl, "tiered, after the concurrent phase", card, solo_need + TIERED_HISTOGRAMS[4:],
            sl.client.get_vectorstore_statistics()["engine"]))

        # brownout rung 2, forced: no promotion prefetch
        b_asks = asks[N_CHECKED : N_CHECKED + 16]
        pre0 = telemetry.stage_snapshot("index.").get("index.prefetch_requests", 0.0)
        _cuda.reset_launch_counts()
        bo = sl.brownout(b_asks)
        read_counts("tiered_brownout")
        pre1 = telemetry.stage_snapshot("index.").get("index.prefetch_requests", 0.0)
        metrics["brownout_events"] = len(brownout_events("tiered brownout rung 2"))
        reset_brownout()
        log(f"  tiered brownout rung 2: 16 requests with n_probe {bo['n_probe']} of "
            f"{store.n_probe}; promotion prefetch requests +{pre1 - pre0:.0f}; brownout flight "
            f"events {metrics['brownout_events']} [{card}]")
        if pre1 != pre0 or bo["n_probe"] != max(1, store.n_probe >> 1):
            raise SystemExit("rung 2 on the tiered store made promotion prefetch requests")
        _cuda.reset_launch_counts()
        wave = sl.live_wave()
        read_counts("tiered_live_wave")
        log(f"  tiered live wave: {wave['removed']} removed, {wave['replaced']} replaced, "
            f"{wave['added']} added in one commit ({wave['wave_commit_s']:.2f}s, slowest operator "
            f"node {wave['wave_slowest_operator']['node']} {wave['wave_slowest_operator']['kind']} "
            f"{wave['wave_slowest_operator']['seconds']:.2f}s); freshness "
            f"{wave['freshness_s']:.2f}s; first retrieve after it {wave['first_retrieve_ms']:.1f} "
            f"ms; no removed or replaced text served [{card}]")

        # the kernels alone (not counted), at the shapes the path gives them
        with Recorder(knn_tiers, "quant_score_blocks") as rq:
            store.search_batch(qv[:8], 10)
        q8 = measure_blocks(torch, rq.args, True, "quant_score_blocks, 8-query batch", card)
        with Recorder(knn_tiers, "quant_score_blocks") as rq1:
            store.search_batch(qv[-1:], 10)
        q1rec = measure_blocks(torch, rq1.args, True, "quant_score_blocks, one request", card)
        qcc = measure_blocks(torch, rc.args, True,
                             "quant_score_blocks, largest concurrent batch", card)
        del rc
        # the probe at the path's shapes (the served table, real queries)
        # and a split store's, beside the launch floor
        floor = launch_floor(torch, card)
        table = store._quant_cents()
        qhost = qv[:32].float().cpu().numpy()
        probes = probe_phase(torch, args.seed, card, floor, table=table, queries=qhost)
        probe = probes["8-query batch"]
        pargs = probe_args(torch, table, qhost[:8])

        # residency invariance on the card, int8 and fp32 (its own path)
        res = residency_check(torch, store, qv[:64], card)
        fargs = res["off"]["recorded"]
        f8 = measure_blocks(torch, fargs, False, "score_blocks (fp32), 8-query batch", card)
        f1 = measure_blocks(torch, res["off"]["recorded_one"], False,
                            "score_blocks (fp32), one request", card)
        check_invariance(torch, rq.args, fargs, pargs)
        # the stall histogram observes a spilled cluster's load: the main
        # store has no spill tier, the residency check's budgeted stores do
        spilled = sum(r["census"]["probe_spilled"] for r in res.values())
        if spilled <= 0:  # a small corpus fits the budget: nothing spills
            log(f"  the residency check probed no spilled cluster: "
                f"{TIERED_HISTOGRAMS[0]} has no observation at this size")
        metrics["scrapes"].append(check_scrape(
            sl, "tiered, after the residency check (its spilled stores)", card,
            solo_need + TIERED_HISTOGRAMS[4:] + (TIERED_HISTOGRAMS[:1] if spilled else ())))
        metrics["flight"] = flight_dump("tiered store", card)
    finally:
        sl.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    kernels = [
        {"name": "quant_score_blocks", "route": "cuda",
         "source": "pathway_tpu_torch/csrc/score_blocks.cu",
         "replaces": "pathway_tpu/ops/knn_quant.py:287",
         "launches": int(launches.get("quant_score_blocks", 0)),
         "max_abs_err": max(q8["max_abs_err"], q1rec["max_abs_err"], qcc["max_abs_err"]),
         "ms": q8["ms"], "plain_ms": q8["plain_ms"], "bound_ms": q8["bound_ms"],
         "bound_by": q8["bound_by"], "library_ms": q8["library_ms"],
         "graph_ms": q8["graph_ms"], "wrapper_ms": q8["wrapper_ms"], "served_ms": q1rec["ms"],
         "served_graph_ms": q1rec["graph_ms"], "served_bound_ms": q1rec["bound_ms"],
         "served_wrapper_ms": q1rec["wrapper_ms"],
         "concurrent_ms": qcc["ms"], "concurrent_bound_ms": qcc["bound_ms"]},
        {"name": knn_quant.QUANT_PROBE, "route": "cuda",
         "source": "pathway_tpu_torch/csrc/score_blocks.cu",
         "replaces": "pathway_tpu/ops/knn_quant.py:326",
         "launches": int(launches.get(knn_quant.QUANT_PROBE, 0)),
         "max_abs_err": probe["max_abs_err"], "ms": probe["ms"], "graph_ms": probe["graph_ms"],
         "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
         "bound_by": probe["bound_by"], "library_ms": probe["library_ms"],
         "wrapper_ms": probe["wrapper_ms"],
         "concurrent_graph_ms": probes["largest concurrent batch"]["graph_ms"],
         "concurrent_bound_ms": probes["largest concurrent batch"]["bound_ms"]},
        {"name": "score_blocks", "route": "cuda",
         "source": "pathway_tpu_torch/csrc/score_blocks.cu",
         "replaces": "pathway_tpu/ops/knn_tiers.py:743",
         "launches": int(res["off"]["launches"].get("score_blocks", 0)),
         "max_abs_err": max(f8["max_abs_err"], f1["max_abs_err"]), "ms": f8["ms"],
         "plain_ms": f8["plain_ms"], "bound_ms": f8["bound_ms"], "bound_by": f8["bound_by"],
         "library_ms": f8["library_ms"], "graph_ms": f8["graph_ms"], "served_ms": f1["ms"],
         "served_graph_ms": f1["graph_ms"], "served_bound_ms": f1["bound_ms"]},
    ]
    report = {
        "knobs": TIERED_KNOBS, "ingest": ingest, "retrieve_ms": ret["lat_ms"],
        "retrieve_p50_ms": ret["p50_ms"], "retrieve_p99_ms": ret["p99_ms"],
        "first_retrieve_after_ingest_ms": ret["first_retrieve_ms"], "stages_ms": t,
        "census": census, "n_clusters": store.n_clusters,
        "concurrent": {k: v for k, v in cc.items() if k != "answers"},
        "recall_at_10": recall, "brownout_prefetch_requests": pre1 - pre0,
        "live_wave": wave, "launches": launches, "phase_launches": phase,
        "quant_score_blocks_batch": q8, "quant_score_blocks_request": q1rec,
        "quant_score_blocks_concurrent": qcc, "quant_probe": probes, "launch_floor": floor,
        "score_blocks_fp32_batch": f8, "score_blocks_fp32_request": f1,
        "residency": {m: {k: v for k, v in r.items() if not k.startswith("recorded")}
                      for m, r in res.items()},
        "metrics": metrics,
    }
    return kernels, report, floor


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=3 << 17,
                    help="documents of the corpus (the tiered phase serves all of them; cut to "
                         "3/8 of 1,048,576 so that the smoke stays within half of the 1200 s "
                         "limit)")
    ap.add_argument("--untiered-chunks", type=int, default=3 << 16,
                    help="documents the untiered phase serves (the first of the corpus; cut to "
                         "3/16 of 1,048,576 so that the smoke stays within half of the 1200 s "
                         "limit)")
    ap.add_argument("--requests", type=int, default=256,
                    help=f"timed /v1/retrieve requests; the first {N_CHECKED} are re-scored")
    ap.add_argument("--concurrent", type=int, default=2048,
                    help="distinct /v1/retrieve requests of the concurrent phase")
    ap.add_argument("--clients", type=int, default=32, help="client threads of the concurrent phase")
    ap.add_argument("--report", default=None, help="write the measurements here as JSON")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, then measure the launch floor, the int8 probe and the block "
                         "scorers on seeded inputs of the tiered path's shapes, print them as the "
                         "last line and stop")
    ap.add_argument("--config4-only", action="store_true",
                    help="build, then run phase 7 (BASELINE config 4) alone on its own "
                         "corpus, print its measurements as the last line and stop")
    ap.add_argument("--rag-only", action="store_true",
                    help="build, then run phase 8 (the RAG server) alone on its own corpus, "
                         "print its measurements as the last line and stop")
    ap.add_argument("--ops-only", action="store_true",
                    help="build, then run phase 9 (the engine's remaining operators and the "
                         "stdlib) alone on its own corpus, print its measurements as the last "
                         "line and stop")
    ap.add_argument("--persist-only", action="store_true",
                    help="build, then run phase 10 (a crash and a resume of the ingest under "
                         "persistence) alone on its own corpus, print its measurements as the "
                         "last line and stop")
    ap.add_argument("--chaos-only", action="store_true",
                    help="build, then run phase 11 (fault injection: the index faults, a commit "
                         "kill and its resume, the slides store) alone on its own corpus, print "
                         "its measurements as the last line and stop")
    ap.add_argument("--persist-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.persist_child:
        # phase 10's Run 1, started by the phase itself
        return persist_child(args.persist_child)
    if args.requests < N_CHECKED:
        ap.error(f"--requests must be at least {N_CHECKED}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    gc.callbacks.append(GC_PAUSES)
    from pathway_tpu_torch.device import resolve_device
    from pathway_tpu_torch.ops import _cuda, knn_ivf

    log("phase 1: device")
    resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi()
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind} x{count}")
    log(f"  nvidia-smi: {card}")

    log("phase 2: build")
    from pathway_tpu_torch.ops import knn_quant

    native_info = native_build(card)
    took = _cuda.build_all([knn_ivf.SCORE_PAGES_SOURCE, knn_quant.SCORE_BLOCKS_SOURCE])
    resources = {}
    for src, s in took.items():
        log(f"  {src}: built in {s:.1f}s")
        resources[src] = [
            line.strip() for line in _cuda.BUILD_LOGS.get(src, "").splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]
        for line in resources[src]:
            log(f"    ptxas: {line}")

    if args.kernels_only:
        log("block scorers and the int8 probe on seeded inputs")
        print(json.dumps({"kernels_only": kernels_only(torch, args, card), "card": card,
                          "device": kind}), flush=True)
        return 0

    if args.config4_only:
        docs = make_corpus(CONFIG4_STREAM["chunks"], args.seed)
        log("phase 7 alone: BASELINE config 4")
        t0 = time.perf_counter()
        report, launches = run_config4(torch, args, card, docs)
        log(f"  phase 7 took {time.perf_counter() - t0:.1f}s")
        print(json.dumps({"config4": report, "score_pages_launches": launches, "card": card,
                          "device": kind}), flush=True)
        return 0

    if args.rag_only:
        docs = make_corpus(RAG["chunks"], args.seed)
        log("phase 8 alone: the RAG server")
        t0 = time.perf_counter()
        report, launches = run_rag(torch, args, card, docs)
        log(f"  phase 8 took {time.perf_counter() - t0:.1f}s")
        print(json.dumps({"rag": report, "score_pages_launches": launches, "card": card,
                          "device": kind}, default=str), flush=True)
        return 0

    if args.persist_only:
        docs = make_corpus(PERSIST["chunks"] + PERSIST["chunks"] // PERSIST["files"], args.seed)
        log("phase 10 alone: a crash and a resume of the ingest")
        report, launches = run_persist(torch, args, card, docs)
        report.pop("rehearsal")
        print(json.dumps({"persist": report, "score_pages_launches": launches, "card": card,
                          "device": kind}, default=str), flush=True)
        return 0

    if args.chaos_only:
        docs = make_corpus(CHAOS["chunks"], args.seed)
        log("phase 11 alone: fault injection")
        report, launches = run_chaos(torch, args, card, docs)
        print(json.dumps({"chaos": report, "launches": launches, "card": card,
                          "device": kind}, default=str), flush=True)
        return 0

    if args.ops_only:
        docs = make_corpus(OPS["chunks"], args.seed)
        log("phase 9 alone: the engine's remaining operators and the stdlib")
        t0 = time.perf_counter()
        report, launches = run_ops_stdlib(torch, args, card, docs)
        log(f"  phase 9 took {time.perf_counter() - t0:.1f}s")
        print(json.dumps({"ops": report, "score_pages_launches": launches, "card": card,
                          "device": kind}, default=str), flush=True)
        return 0

    log("phase 3: kernel vs plain version")
    check_kernel_vs_plain(torch, knn_ivf, args.seed)

    t0 = time.perf_counter()
    docs = make_corpus(args.chunks, args.seed)
    log(f"  corpus: {len(docs)} chunks generated in {time.perf_counter() - t0:.1f}s")
    untiered = docs[: min(args.untiered_chunks, args.chunks)]
    log(f"phase 4: the slice ({len(untiered)} chunks)")
    kernel, report = run_slice(torch, args, card, untiered)
    log(f"  phase 4 took {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    log(f"phase 5: the tiered int8 store ({len(docs)} chunks; "
        + ", ".join(f"{k}={v}" for k, v in TIERED_KNOBS.items()) + ")")
    tiered_kernels, report["tiered"], floor = run_tiered(torch, args, card, docs)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    log("phase 6: BASELINE config 1 (KNNIndex over a static CSV of "
        f"{CONFIG1['docs']} x {CONFIG1['dim']} vectors, {CONFIG1['queries']} queries)")
    report["config1"] = run_config1(torch, args, card)
    log(f"  phase 6 took {time.perf_counter() - t0:.1f}s")

    native_info.update(tables=TABLES_SEEN, key_seconds_per_million=report["key_seconds_per_million"])
    report["native"] = native_info
    log("native: " + json.dumps(native_info))

    t0 = time.perf_counter()
    log("phase 7: BASELINE config 4 (a streaming index with a tumbling window: "
        f"{CONFIG4_WINDOW['rows']} rows through windowby; {CONFIG4_STREAM['chunks']} chunks "
        f"in {CONFIG4_STREAM['files']} files through embed → KNN beside a window)")
    report["config4"], kernel["launches_config4"] = run_config4(torch, args, card, docs)
    log(f"  phase 7 took {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    log(f"phase 8: the RAG server (the first {RAG['chunks']} chunks through a hybrid IVF + BM25 "
        f"index, AdaptiveRAGQuestionAnswerer behind QARestServer)")
    report["rag"], kernel["launches_rag"] = run_rag(torch, args, card, docs)
    if report["rag"]["scorer"] is not None:
        kernel["max_abs_err"] = max(kernel["max_abs_err"], report["rag"]["scorer"]["max_abs_err"])
    log(f"  phase 8 took {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    log("phase 9: the engine's remaining operators and the stdlib (graphs, an event stream "
        "through deduplicate / sort / diff / interpolate / the new reducers / update_cells / "
        f"remove_errors, and {OPS['chunks']} chunks deduplicated into the IVF index)")
    report["ops"], ops_launches = run_ops_stdlib(torch, args, card, docs)
    kernel.update(ops_launches)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    log(f"phase 10: persistence, a crash and a resume of the ingest ({PERSIST['chunks']} chunks in "
        f"{PERSIST['files']} files; Run 1 killed with SIGKILL, Run 0 without persistence, Run 2 "
        "the resume)")
    report["persist"], kernel["launches_persist"] = run_persist(torch, args, card, docs)
    report["persist"].pop("rehearsal")
    log(f"  phase 10 took {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    log(f"phase 11: fault injection (the quant and tier_swap_torn plans on a tiered int8 store of "
        f"{CHAOS['rows']} rows; a commit kill at commit {CHAOS['kill_commit']} of a "
        f"{CHAOS['chunks']}-chunk int8 tiered ingest and its resume; a SlidesDocumentStore of "
        f"{CHAOS['decks']} decks)")
    report["chaos"], chaos_launches = run_chaos(torch, args, card, docs)
    kernel["launches_slides"] = chaos_launches["slides"]
    for entry in tiered_kernels:
        entry["launches_chaos"] = chaos_launches["chaos"].get(entry["name"], 0)
        entry["launches_resume"] = chaos_launches["resume"].get(entry["name"], 0)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f}s")

    log("kernels")
    kernels = {"kernels": [kernel] + tiered_kernels, "empty": floor}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({**report, **kernels, "resources": resources, "device": kind}, f, indent=1,
                      default=str)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
