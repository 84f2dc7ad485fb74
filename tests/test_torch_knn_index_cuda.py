"""BASELINE config 1 on the card: ``KNNIndex`` over a static CSV, through
``io.csv.read`` and ``pw.run``, with the index on ``cuda``. Needs an NVIDIA
GPU and skips without one; this file imports neither JAX nor the reference
package, so it runs on the GPU machine:

    python -m pytest tests/test_torch_knn_index_cuda.py -m cuda

Integer-valued vectors make every euclidean score exact, so the answers must
be the float64 brute force's, distance for distance."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.debug import _capture_update_stream as capture
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.stdlib.ml import KNNIndex


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the index runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", ["exact", "ivf"])
def test_knn_index_over_a_static_csv_on_the_card(card, tmp_path, approximate):
    rng = np.random.default_rng(0)
    docs = rng.integers(-8, 9, size=(2000, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(64, 32)).astype(np.float32)
    for name, rows in (("docs.csv", docs), ("queries.csv", queries)):
        lines = ["doc,vec"] + [
            f"{i}," + " ".join(repr(float(x)) for x in row) for i, row in enumerate(rows)
        ]
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    G.clear()
    to_vec = pw.apply_with_type(
        lambda s: np.array(s.split(), dtype=np.float32), np.ndarray, pw.this.vec
    )
    schema = pw.schema_from_types(doc=int, vec=str)
    data = pw.io.csv.read(str(tmp_path / "docs.csv"), schema=schema, mode="static").select(
        pw.this.doc, vec=to_vec
    )
    q = pw.io.csv.read(str(tmp_path / "queries.csv"), schema=schema, mode="static").select(
        qid=pw.this.doc, qvec=to_vec
    )
    extra = {} if approximate == "exact" else dict(
        exact=False, approximate="ivf", n_clusters=16, n_probe=16
    )
    index = KNNIndex(data.vec, data, n_dimensions=32, **extra)
    res = index.get_nearest_items(q.qvec, k=10, with_distances=True)
    net: dict = {}
    for u in capture(res):
        item = (int(u["qid"]), tuple(int(x) for x in u["doc"]),
                tuple(float(x) for x in u["dist"]))
        net[item] = net.get(item, 0) + u["__diff__"]
    G.clear()
    answers = {qid: (ids, dist) for (qid, ids, dist), c in net.items() if c}
    assert len(answers) == len(queries)
    d2 = ((queries.astype(np.float64)[:, None, :] - docs[None]) ** 2).sum(-1)
    for qid, (ids, dist) in answers.items():
        assert list(dist) == list(-np.sort(d2[qid])[:10])
        assert all(-d2[qid][j] == d for j, d in zip(ids, dist))
