"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels
have no CPU mode) and skips without one; this file imports neither JAX nor
the reference package, so it also runs on the GPU machine:

    python -m pytest tests/test_torch_kernels.py -m cuda

Integer-valued inputs make every f32 dot exact in any summation order, so
kernel and plain version must agree bitwise."""

from __future__ import annotations

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [40, 384])  # 40: a ragged last 32-column chunk
def test_score_pages_kernel_matches_plain(card, metric, dtype, d):
    rng = np.random.default_rng(d)
    n_pages = 16
    packed = torch.from_numpy(_int_rows(rng, n_pages * PAGE, d)).to(getattr(torch, dtype))
    packed = packed.to(card)
    pn = torch.sum(packed.float() ** 2, dim=1).reshape(n_pages, PAGE).contiguous()
    mask = rng.random((n_pages, PAGE)) < 0.1
    pm = torch.from_numpy(np.where(mask, -np.inf, 0.0).astype(np.float32)).to(card)
    q = torch.from_numpy(_int_rows(rng, 8, d)).to(card)
    ids = torch.from_numpy(rng.integers(0, n_pages, size=(8, 11)).astype(np.int32)).to(card)
    before = _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES]
    got = knn_ivf.score_pages(packed, pn, pm, q, ids, metric)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[knn_ivf.SCORE_PAGES] == before + 1
    want = knn_ivf.score_pages_plain(packed, pn, pm, q, ids, metric)
    assert torch.equal(got, want)


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
