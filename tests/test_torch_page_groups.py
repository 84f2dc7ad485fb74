"""The page scorer's work list (``pathway_tpu_torch.ops.knn_ivf.group_page_work``)
on the CPU.

The CUDA kernel reads each distinct page once and scores it against every
query that probes it, numbering the (page, query) pairs by the table this
function builds. Here the kernel's walk over that table is replayed in
Python with the plain scorer, one slot per pair, and every slot then takes
its pair's scores; the result must equal the plain scorer over the whole
batch and the reference's Pallas kernel (interpret mode) BITWISE on integer
corpora, where every f32 dot is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn_ivf as ref_ivf
from pathway_tpu_torch.ops import knn_ivf as port_ivf


@pytest.fixture(autouse=True, scope="module")
def _ladders_at_rung_zero():
    """Both packages' brownout ladders start at rung 0: another test file in
    this process may have left one engaged, and rung 2 halves IVF n_probe."""
    from pathway_tpu.engine.brownout import reset_brownout as ref_reset
    from pathway_tpu_torch.engine.brownout import reset_brownout as port_reset

    ref_reset()
    port_reset()
    yield


torch.set_num_threads(1)

PAGE = port_ivf.PAGE
METRICS = ["l2sq", "cos", "ip"]
CASES = ["random", "duplicates", "sentinel", "q64", "probed"]


def _page_ids(case: str) -> np.ndarray:
    """Seeded (q, n_slots) int32 page ids, one shape of work per case."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "random":  # uniform over 32 pages: repeats within and across queries
        return rng.integers(0, 32, size=(8, 20)).astype(np.int32)
    if case == "duplicates":  # 3 pages shared by every query, many times each
        return rng.choice(np.array([4, 9, 30]), size=(8, 40)).astype(np.int32)
    if case == "sentinel":  # one page in >= 1000 slots, as the all-pad sentinel page
        ids = np.full((2, 600), 31, dtype=np.int32)
        ids[:, :50] = rng.integers(0, 16, size=(2, 50))
        return ids
    if case == "q64":  # more pairs per page than one pass of the kernel holds
        ids = rng.integers(0, 6, size=(64, 12)).astype(np.int32)
        ids[:, -3:] = 31
        return ids
    if case == "probed":  # the query path's layout: clusters of pages + sentinel
        first = np.array([0, 5, 9, 20])
        count = np.array([5, 4, 2, 7])
        probe = rng.integers(0, 4, size=(8, 3))
        span = np.arange(8)
        ids = np.where(span < count[probe][..., None], first[probe][..., None] + span, 31)
        return ids.reshape(8, -1).astype(np.int32)
    raise AssertionError(case)


N_PAGES = 32
QT, THREADS = 8, PAGE  # the kernel's pass width and block size


def _kernel_walk(work, q: int, threads: int = THREADS):
    """The scoring kernel's walk over the work list, in Python: the probed
    pages from the highest id down; each page's pairs in passes of up to QT,
    whose queries are found by scanning the page's table row ``threads``
    columns at a time from where the last pass stopped.
    Returns [(page, [(pair number, query), ...]), ...]."""
    rank = work.rank.tolist()
    walk = []
    for page in reversed(work.pages[: int(work.n_probed)].tolist()):
        r = rank[page * q : (page + 1) * q + 1]
        pairs, start = [], 0
        for p0 in range(r[0], r[q], QT):
            nq = min(QT, r[q] - p0)
            qidx = [0] * QT
            j0 = start
            while True:
                for j in range(j0, min(j0 + threads, q)):
                    if r[j + 1] > r[j] and p0 < r[j + 1] <= p0 + nq:
                        qidx[r[j + 1] - p0 - 1] = j
                end = min(j0 + threads, q)
                if end == q or r[end] >= p0 + nq:
                    break
                j0 += threads
            start = qidx[nq - 1] + 1
            pairs += [(p0 + k + 1, qidx[k]) for k in range(nq)]
        walk.append((page, pairs))
    return walk


@pytest.mark.parametrize("case", CASES)
def test_group_page_work_numbers_each_pair_once(case):
    ids = _page_ids(case)
    q, n_slots = ids.shape
    work = port_ivf.group_page_work(torch.from_numpy(ids), N_PAGES)
    rank = work.rank
    assert rank.dtype == torch.int64 and rank.shape == (N_PAGES * q + 1,)
    steps = torch.diff(rank)
    assert int(rank[0]) == 0 and bool(((steps == 0) | (steps == 1)).all())
    # a step at table entry page * q + query exactly where the batch holds the pair
    pairs = {(int(p), i) for i in range(q) for p in ids[i]}
    assert {divmod(k, q) for k in torch.nonzero(steps).flatten().tolist()} == pairs
    assert int(rank[-1]) == len(pairs) <= q * n_slots  # fits the kernel's scratch tiles
    # every (query, slot) names one pair, the one of its page and query
    of_slot = rank[torch.from_numpy(ids).long() * q + torch.arange(q)[:, None] + 1]
    for i in range(q):
        for s in range(n_slots):
            assert int(of_slot[i, s]) == sorted(pairs).index((int(ids[i, s]), i)) + 1
    # the probed pages, listed once each, the rest of the list past them
    probed = sorted({p for p, _ in pairs})
    assert work.n_probed.tolist() == [len(probed)]
    assert work.pages.tolist() == probed + [N_PAGES] * (N_PAGES - len(probed))
    # the kernel's walk scores every pair once, each page's pairs together
    for threads in (THREADS, 16):  # 16: a table row scanned in several steps
        walk = _kernel_walk(work, q, threads)
        numbered = [(n, (page, j)) for page, ps in walk for n, j in ps]
        assert sorted(numbered) == [(k + 1, pair) for k, pair in enumerate(sorted(pairs))]
        assert [page for page, _ in walk] == probed[::-1]
    if case == "sentinel":
        assert int((torch.from_numpy(ids) == N_PAGES - 1).sum()) >= 1000
    if case == "q64":
        assert max(len(ps) for _, ps in walk) > QT  # more than one pass over a page


def _emulate(packed, pn, pm, queries, page_ids, metric):
    """The kernel's two launches in plain torch: the walk scores one tile per
    (page, query) pair, then every (query, slot) copies its pair's tile."""
    q, n_slots = page_ids.shape
    n_pages = pn.shape[0]
    work = port_ivf.group_page_work(page_ids, n_pages)
    tiles = torch.full((q * n_slots, PAGE), float("nan"))
    for page, pairs in _kernel_walk(work, q):
        for number, j in pairs:
            tiles[number - 1] = port_ivf.score_pages_plain(
                packed, pn, pm, queries[j : j + 1],
                torch.tensor([[page]], dtype=torch.int32), metric,
            )[0]
    of_slot = work.rank[page_ids.long() * q + torch.arange(q)[:, None] + 1]
    return tiles[of_slot - 1].reshape(q, n_slots * PAGE)


def _int_pages(rng, n_pages, d, dtype=torch.float32):
    packed = torch.from_numpy(rng.integers(-8, 9, size=(n_pages * PAGE, d)).astype(np.float32))
    packed = packed.to(dtype)
    pn = torch.sum(packed.float() ** 2, dim=1).reshape(n_pages, PAGE)
    pm = torch.from_numpy(np.where(rng.random((n_pages, PAGE)) < 0.1, -np.inf, 0.0)
                          .astype(np.float32))
    pm[-1] = -np.inf  # the last page is all pad, as the sentinel page
    return packed, pn, pm


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", CASES)
def test_emulated_walk_equals_plain_bitwise(case, metric):
    rng = np.random.default_rng(21)
    ids = _page_ids(case)
    packed, pn, pm = _int_pages(rng, N_PAGES, 12, torch.bfloat16 if case == "duplicates" else
                                torch.float32)
    queries = torch.from_numpy(rng.integers(-8, 9, size=(ids.shape[0], 12)).astype(np.float32))
    page_ids = torch.from_numpy(ids)
    got = _emulate(packed, pn, pm, queries, page_ids, metric)
    want = port_ivf.score_pages_plain(packed, pn, pm, queries, page_ids, metric)
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", METRICS)
def test_emulated_walk_equals_pallas_interpret(metric):
    """On the reference's own paged store over an integer corpus (its
    ``_int_store`` trick): repeated pages across queries and the sentinel
    page in many slots."""
    rng = np.random.default_rng(5)
    docs = rng.integers(-8, 9, size=(1500, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(8, 32)).astype(np.float32)
    ref = ref_ivf.IvfKnnStore(32, metric=metric, initial_capacity=3000, n_clusters=8, n_probe=3)
    ref.add_many(list(range(len(docs))), docs)
    ref.search_batch(docs[:1], 1)
    ref._ensure_index()
    ref._ensure_packed()
    packed, pn, pm, _rows, _fp, _np = ref._packed
    n_pages = pn.shape[0]
    page_ids = rng.integers(0, 4, size=(8, 24)).astype(np.int32)
    page_ids[:, 12:] = n_pages - 1  # the sentinel page in half the slots
    want = np.asarray(ref_ivf._score_pages_pallas(
        packed, pn, pm, jnp.asarray(queries), jnp.asarray(page_ids), metric, interpret=True))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = _emulate(t(packed), t(pn), t(pm), t(queries), t(page_ids), metric)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(want).any()


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.float32, 384, True), (torch.float32, 36, True), (torch.float32, 30, False),
    (torch.bfloat16, 40, True), (torch.bfloat16, 36, False),
])
def test_store_on_the_card_refuses_a_width_the_kernel_cannot_stream(dtype, d, ok):
    """The kernel copies page rows in 16-byte pieces. A store bound for the
    card checks its width when it is built, before any ingest, not at its
    first retrieve; on the CPU (the plain scorer) any width builds."""
    if ok:
        port_ivf.check_page_width(d, dtype)
    else:
        with pytest.raises(ValueError, match="multiple of"):
            port_ivf.check_page_width(d, dtype)
        with pytest.raises(ValueError, match="multiple of"):
            port_ivf.IvfKnnStore(d, dtype=dtype, device="cuda")
    store = port_ivf.IvfKnnStore(d, dtype=dtype, device="cpu", initial_capacity=8)
    assert store._data.shape == (8, d)
