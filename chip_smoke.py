#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--chunks 1048576] [--requests 256] [--report PATH]

Drives ``pathway_tpu_torch`` only (no JAX) through these phases; any failure
exits non-zero and prints no result line.

1. Device: the card's name and ``nvidia-smi`` name / power limit. No CUDA → exit 2.
2. Build: every CUDA kernel of the path, from ``pathway_tpu_torch/csrc``,
   with the registers, shared memory and spills ``ptxas`` reports.
3. Kernel vs plain version: the IVF page scorer against its plain PyTorch
   version for l2sq / cos / ip over f32 and bf16 pages, on random page ids,
   on duplicate-heavy ones (three pages in every slot, one of them the
   all-pad sentinel) and on 64 queries — an integer corpus
   must score identically, a float corpus within 1e-5 of the dot's scale
   |q|^2 + |p|^2 (1 for cos): the same f32 products summed in another order.
4. The slice: ``VectorStoreServer`` (full MiniLM-L6 width, seeded weights,
   ``index_factory="ivf"``) over a seeded topical corpus of ``--chunks``
   chunks of 16-96 words, served on localhost and queried through
   ``VectorStoreClient``: exact copies come back first with dist ≈ -1, the
   kernel's launch count rose, the plain scorer on the card gives the same
   top-10 on the first 16 requests, recall@10 against exact search over
   every request is printed; ingest docs/s and retrieve p50 / p99 latency over all
   ``--requests`` are printed beside the card and its power limit,
   with the host seconds of each ingest stage and one request's time split
   into query embed, index search, the rest of the store and HTTP. The page
   scorer is held against its plain version, within the tolerance of phase
   3, and timed (its work grouping alone beside it) at two shapes of the
   main path, each with its own bound: a batch of 8 real queries, and one
   served request (1 query padded with 7 zero rows); the top-k after it is
   timed on the batch.
5. One JSON line listing every kernel with its launches and times.
6. Last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
        f"(its grouping alone {group_ms:.4f} ms, {group_ms / ms:.1%}), plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms "
        f"({bound_by}; {bound / ms:.1%} of it) [{card}]"
    )
    rec = {
        "q": qn_, "real_queries": len(queries), "n_slots": n_slots, "d": d,
        "real_slots": qn_ * n_slots - sentinel_slots, "sentinel_slots": sentinel_slots,
        "distinct_pages": pages, "distinct_pairs": pairs, "bytes": nbytes, "flops": flops,
        "max_abs_err": max_err, "ms": ms, "group_ms": group_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "scores": got,
    }
    return rec


def run_slice(torch, args, card: str):
    import numpy as np

    from pathway_tpu_torch.ops import _cuda, knn_ivf
    from pathway_tpu_torch.ops.knn import topk_lowest_first
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer

    t0 = time.perf_counter()
    docs = make_corpus(args.chunks, args.seed)
    log(f"  corpus: {len(docs)} chunks generated in {time.perf_counter() - t0:.1f}s")
    embedder = SentenceTransformerEmbedder(seed=args.seed, sub_batch=1024)
    _cuda.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    server = VectorStoreServer(docs, embedder=embedder, index_factory="ivf")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    store = server.index.store
    log(
        f"  ingest: {len(docs)} docs in {ingest_s:.1f}s = {len(docs) / ingest_s:.0f} docs/s "
        f"(embed + IVF train + CSR + pages; {store.n_clusters} clusters, "
        f"max_pages {store._max_pages}, n_probe {store.n_probe}) [{card}]"
    )
    ingest_stages = dict(server.store.ingest_seconds)
    log("  ingest stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in ingest_stages.items()))
    http = server.run_server(host="127.0.0.1", port=0, threaded=True)
    rng = np.random.default_rng(args.seed + 1)
    try:
        client = VectorStoreClient(url=http.url, timeout=120)
        picks = rng.choice(len(docs), size=args.requests, replace=False).tolist()
        # the first N_CHECKED: half exact copies, one filter, one glob, the
        # rest perturbed; after them exact and perturbed take turns
        n_exact = N_CHECKED // 2
        asks = []
        for j, i in enumerate(picks):
            text = docs[i]["data"]
            if j < n_exact or (j >= N_CHECKED and j % 2 == 0):
                asks.append(("exact", i, text, {}))
            elif j == n_exact:
                asks.append(("filter", i, perturb(text, rng),
                             {"metadata_filter": f"topic == {docs[i]['_metadata']['topic']}"}))
            elif j == n_exact + 1:
                glob = docs[i]["_metadata"]["path"].rsplit("/", 1)[0] + "/*"
                asks.append(("glob", i, perturb(text, rng), {"filepath_globpattern": glob}))
            else:
                asks.append(("perturbed", i, perturb(text, rng), {}))
        for kind, i, text, extra in asks[:2]:  # warm-up: first-call allocations
            client.query(text, k=10, **extra)
        lat, answers = [], []
        for kind, i, text, extra in asks:
            t1 = time.perf_counter()
            answers.append(client.query(text, k=10, **extra))
            lat.append((time.perf_counter() - t1) * 1e3)
        stats = client.get_vectorstore_statistics()
        inputs = client.get_input_files()
    finally:
        http.close()
    torch.cuda.synchronize()
    launches = dict(_cuda.KERNEL_LAUNCHES)  # the main path ends here
    p50 = statistics.median(lat)
    p99 = float(np.percentile(lat, 99))
    log(f"  retrieve: {len(lat)} requests, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
        f"max {max(lat):.2f} ms [{card}]")
    if stats.get("file_count") != len(docs) or len(inputs) != len(docs):
        raise SystemExit(f"statistics/inputs wrong: {stats.get('file_count')} / {len(inputs)}")
    if launches.get(knn_ivf.SCORE_PAGES, 0) <= 0:
        raise SystemExit("the retrieve path never launched the score_pages kernel")
    for (kind, i, text, extra), ans in zip(asks, answers):
        # a filter may leave fewer than k of the over-fetched candidates
        want_n = 10 if kind in ("exact", "perturbed") else len(ans)
        if not 1 <= len(ans) == want_n or not all(np.isfinite(a["dist"]) for a in ans):
            raise SystemExit(f"{kind} query {i}: {len(ans)} answers / non-finite dist")
        if kind == "exact":
            if ans[0]["text"] != text or abs(ans[0]["dist"] + 1.0) > 1e-3:
                raise SystemExit(f"exact query {i}: top hit {ans[0]['text'][:40]!r} "
                                 f"dist {ans[0]['dist']}")
        if kind == "filter" and any(
            a["metadata"]["topic"] != docs[i]["_metadata"]["topic"] for a in ans
        ):
            raise SystemExit("metadata_filter leaked other topics")
        if kind == "glob" and any(
            not a["metadata"]["path"].startswith(extra["filepath_globpattern"][:-1]) for a in ans
        ):
            raise SystemExit("filepath_globpattern leaked other paths")
    n_exacts = sum(a[0] == "exact" for a in asks)
    log(f"  exact-copy queries: {n_exacts}/{n_exacts} return their own chunk first, dist ≈ -1")

    # the served queries again, N_CHECKED to a batch: the first batch kernel
    # vs the plain scorer on the card, every batch IVF vs exact search
    qv = torch.cat([embedder.embed_queries([a[2]]) for a in asks])
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
        {server.store.chunk_texts[store.key_of[int(s)]] for s in ki[r].tolist()}
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
    recall = float(np.mean(recalls))
    recall_16 = float(np.mean(recalls[:N_CHECKED]))
    log(f"  recall@10 vs exact search over the same embeddings: {recall:.4f} over "
        f"{len(asks)} queries ({recall_16:.4f} over the first {N_CHECKED}; "
        f"n_probe {store.n_probe} of {store.n_clusters} clusters)")

    # where one request's time goes (outside the counted run): the query
    # embed and the index search each alone, the store's whole retrieve in
    # process, and the same request over HTTP
    one = asks[-1][2]
    q1 = embedder.embed_queries([one])
    http = server.run_server(host="127.0.0.1", port=0, threaded=True)
    try:
        client = VectorStoreClient(url=http.url, timeout=120)
        t = host_times_ms({
            "request": lambda: client.query(one, k=10),
            "in_process": lambda: server.store.retrieve(one, k=10),
            "embed_query": lambda: embedder.embed_queries([one]),
            "index_search": lambda: store.search_batch(q1, 10),
        })
    finally:
        http.close()
    retrieve_stages = {
        "request": t["request"], "embed_query": t["embed_query"],
        "index_search": t["index_search"],
        "store_rest": t["in_process"] - t["embed_query"] - t["index_search"],
        "http": t["request"] - t["in_process"],
    }
    log("  retrieve stages (ms, median of 9, one request): "
        + ", ".join(f"{k} {v:.2f}" for k, v in retrieve_stages.items()) + f" [{card}]")

    # the page scorer alone at two shapes of the main path: a batch of 8 real
    # queries, and one served request (1 query + 7 zero pad rows)
    timed = measure_scorer(torch, knn_ivf, store, qv[:8], "timed batch", card)
    served = measure_scorer(torch, knn_ivf, store, qv[-1:], "served request", card)
    # the stable-sort top-k that follows the scorer on the same scores
    got = timed.pop("scores")
    served.pop("scores")
    topk_ms = cuda_time_ms(lambda: topk_lowest_first(got, 16), 20)
    log(f"  top-16 over the {got.shape[1]} scores per query: {topk_ms:.4f} ms [{card}]")
    kernel = {
        "name": knn_ivf.SCORE_PAGES,
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/score_pages.cu",
        "replaces": "pathway_tpu/ops/knn_ivf.py:200",
        "launches": int(launches.get(knn_ivf.SCORE_PAGES, 0)),
        "max_abs_err": max(timed["max_abs_err"], served["max_abs_err"]),
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": None,  # no single PyTorch call gathers pages and scores them
        "served_ms": served["ms"],
        "served_bound_ms": served["bound_ms"],
    }
    report = {
        "card": card,
        "chunks": len(docs),
        "ingest_s": ingest_s,
        "ingest_docs_per_s": len(docs) / ingest_s,
        "retrieve_ms": lat,
        "retrieve_p50_ms": p50,
        "retrieve_p99_ms": p99,
        "ingest_stages_s": ingest_stages,
        "retrieve_stages_ms": retrieve_stages,
        "topk_ms": topk_ms,
        "recall_at_10": recall,
        "recall_at_10_first_16": recall_16,
        "kernel_vs_plain_overlap": overlap,
        "n_clusters": store.n_clusters,
        "n_probe": store.n_probe,
        "max_pages": store._max_pages,
        "score_pages_timed_batch": timed,
        "score_pages_served_request": served,
        "launches": launches,
    }
    return kernel, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=1 << 20)
    ap.add_argument("--requests", type=int, default=256,
                    help=f"timed /v1/retrieve requests; the first {N_CHECKED} are re-scored")
    ap.add_argument("--report", default=None, help="write the measurements here as JSON")
    args = ap.parse_args()
    if args.requests < N_CHECKED:
        ap.error(f"--requests must be at least {N_CHECKED}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    took = _cuda.build_all([knn_ivf.SCORE_PAGES_SOURCE])
    resources = {}
    for src, s in took.items():
        log(f"  {src}: built in {s:.1f}s")
        resources[src] = [
            line.strip() for line in _cuda.BUILD_LOGS.get(src, "").splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]
        for line in resources[src]:
            log(f"    ptxas: {line}")

    log("phase 3: kernel vs plain version")
    check_kernel_vs_plain(torch, knn_ivf, args.seed)

    log(f"phase 4: the slice ({args.chunks} chunks)")
    kernel, report = run_slice(torch, args, card)

    log("phase 5: kernels")
    kernels = {"kernels": [kernel]}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({**report, **kernels, "resources": resources, "device": kind}, f, indent=1)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
