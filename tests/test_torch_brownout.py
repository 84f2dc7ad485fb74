"""Port parity of the brownout ladder (``pathway_tpu_torch/engine/brownout.py``)
against the reference's (``pathway_tpu/engine/brownout.py``), on the CPU.

The same occupancy trace, with ``now`` injected, goes through a ladder of
each package: the level after every sample, the admission / coalesce-window
scales, the ``n_probe`` shift, the engage and release counts and their stage
counters must be equal, decision for decision. ``Retry-After`` formatting
and the quiesce window are compared on the same inputs. Rung 2 halves the
IVF ``n_probe`` in both packages: on an integer corpus, with the reference's
centroids, the port's search gives the reference's slots and scores
exactly."""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from pathway_tpu.engine import brownout as ref_bo
from pathway_tpu.engine import telemetry as ref_tel
from pathway_tpu.ops import knn_ivf as ref_ivf
from pathway_tpu_torch.engine import brownout as port_bo
from pathway_tpu_torch.engine import telemetry as port_tel
from pathway_tpu_torch.ops import knn_ivf as port_ivf

torch.set_num_threads(1)


@pytest.fixture
def fresh_ladders():
    ref_bo.reset_brownout()
    port_bo.reset_brownout()
    yield
    ref_bo.reset_brownout()
    port_bo.reset_brownout()


def _trace(seed: int, n: int = 400):
    """(occupancy, now) samples: plateaus near each rung's engage and release
    thresholds, spikes past 1, quiet stretches longer and shorter than the
    hold time, and repeated timestamps."""
    rng = np.random.default_rng(seed)
    levels = [0.0, 0.3, 0.41, 0.42, 0.59, 0.6, 0.61, 0.84, 0.85, 0.9, 1.3, 0.5, 0.2]
    now = 100.0
    out = []
    for _ in range(n):
        frac = float(rng.choice(levels)) + float(rng.normal(scale=0.01)) * (rng.random() < 0.3)
        now += float(rng.choice([0.0, 0.05, 0.3, 0.7, 1.0, 1.6]))
        out.append((frac, now))
    return out


@pytest.mark.parametrize("hold_s", [0.0, 0.5, 1.0, 2.5])
@pytest.mark.parametrize("seed", range(4))
def test_ladder_decisions_equal_the_reference(hold_s, seed):
    ref = ref_bo.BrownoutState(enabled=True, hold_s=hold_s)
    port = port_bo.BrownoutState(enabled=True, hold_s=hold_s)
    seen = set()
    for frac, now in _trace(seed):
        assert port.observe_occupancy(frac, now) == ref.observe_occupancy(frac, now), (frac, now)
        assert port.level() == ref.level()
        assert port.admission_scale() == ref.admission_scale()
        assert port.coalesce_window_scale() == ref.coalesce_window_scale()
        assert port.nprobe_shift() == ref.nprobe_shift()
        seen.add(port.level())
    assert seen == {0, 1, 2}  # the trace walks every rung
    assert port.snapshot() == ref.snapshot()


def test_engage_and_release_counters_equal_the_reference():
    ref_tel.stage_reset("brownout.")
    port_tel.stage_reset("brownout.")
    ref = ref_bo.BrownoutState(enabled=True, hold_s=1.0)
    port = port_bo.BrownoutState(enabled=True, hold_s=1.0)
    for frac, now in _trace(7):
        ref.observe_occupancy(frac, now)
        port.observe_occupancy(frac, now)
    want = ref_tel.stage_snapshot("brownout.")
    assert want.get("brownout.engage", 0) > 0 and want.get("brownout.release", 0) > 0
    assert port_tel.stage_snapshot("brownout.") == want
    # the counters count transitions, the snapshot counts rungs crossed
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("value", ["off", "0", "false", "no", "on", "OFF", ""])
def test_env_switch_equals_the_reference(monkeypatch, fresh_ladders, value):
    monkeypatch.setenv("PATHWAY_BROWNOUT", value)
    ref, port = ref_bo.get_brownout(), port_bo.get_brownout()
    assert port.enabled == ref.enabled
    for frac, now in ((0.9, 1.0), (0.7, 2.0), (0.0, 9.0)):
        assert port.observe_occupancy(frac, now) == ref.observe_occupancy(frac, now)
        assert port.admission_scale() == ref.admission_scale()
        assert port.nprobe_shift() == ref.nprobe_shift()


def test_singleton_is_rebuilt_by_reset(fresh_ladders):
    a = port_bo.get_brownout()
    assert port_bo.get_brownout() is a
    a.observe_occupancy(0.9)
    assert port_bo.get_brownout().level() == 2
    port_bo.reset_brownout()
    assert port_bo.get_brownout() is not a and port_bo.get_brownout().level() == 0


@pytest.mark.parametrize(
    "seconds",
    [0, 0.0, 0.3, 0.999, 1, 1.0001, 2.5, 7, 59.5, 3599.2, 3600, 3601, 1e9,
     -3, math.nan, math.inf, -math.inf, "x", None, "4.2"],
)
def test_retry_after_int_equals_the_reference(seconds):
    got = port_bo.retry_after_int(seconds)
    assert got == ref_bo.retry_after_int(seconds)
    assert got.isdigit() and 1 <= int(got) <= 3600


@pytest.mark.parametrize("expected_s", [0.01, 0.4, 3.0, 42.7])
def test_quiesce_retry_after_equals_the_reference(expected_s):
    ref = ref_bo.BrownoutState(enabled=False)
    port = port_bo.BrownoutState(enabled=False)
    assert port.quiesce_retry_after() is None and ref.quiesce_retry_after() is None
    ref.enter_quiesce(expected_s)
    port.enter_quiesce(expected_s)
    got, want = port.quiesce_retry_after(), ref.quiesce_retry_after()
    assert abs(got - want) < 0.05
    assert port_bo.retry_after_int(got) == ref_bo.retry_after_int(want)
    assert port.snapshot()["quiesced"] and ref.snapshot()["quiesced"]
    # the quiesce window sheds even with the ladder disabled
    assert port.observe_occupancy(0.99) == 0
    port.exit_quiesce()
    ref.exit_quiesce()
    assert port.quiesce_retry_after() is None and ref.quiesce_retry_after() is None


def _int_corpus(n=1500, dim=32, seed=5):
    rng = np.random.default_rng(seed)
    docs = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(24, dim)).astype(np.float32)
    return docs, queries


@pytest.mark.parametrize("metric", ["l2sq", "cos", "ip"])
def test_rung_two_halves_n_probe_as_the_reference(fresh_ladders, metric):
    docs, queries = _int_corpus()
    n = len(docs)
    ref = ref_ivf.IvfKnnStore(32, metric=metric, initial_capacity=2 * n, n_clusters=8, n_probe=6)
    ref.add_many(list(range(n)), docs)
    ref.search_batch(docs[:1], 1)
    ref._ensure_index()
    port = port_ivf.IvfKnnStore(
        32, metric=metric, initial_capacity=2 * n, n_clusters=8, n_probe=6, device="cpu"
    )
    port.add_many(list(range(n)), docs)
    port._flush()
    port.set_centroids(np.asarray(ref._centroids))
    port._ensure_index()
    answers = {}
    for level, frac in ((0, 0.0), (2, 0.9)):
        assert ref_bo.get_brownout().observe_occupancy(frac, now=1.0) == level
        assert port_bo.get_brownout().observe_occupancy(frac, now=1.0) == level
        assert port._effective_n_probe() == ref._effective_n_probe() == (6 if level == 0 else 3)
        want_s, want_i = ref._search_device(queries, 10, impl="pallas_interpret")
        got_s, got_i = port._search_device(queries, 10)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)
        answers[level] = got_i
    # halving the probes changed some answers: rung 2 really searched less
    assert not np.array_equal(answers[0], answers[2])


def test_deadline_window_shrinks_to_zero_at_rung_two(fresh_ladders):
    """Rung 2 scales the deadline coalescer's window by 0 in both packages: a
    solo request does not wait out a 30 s window."""
    from pathway_tpu.models.embed_pipeline import QueryCoalescer as RefCoalescer
    from pathway_tpu_torch.models.embed_pipeline import QueryCoalescer as PortCoalescer

    ref_bo.get_brownout().observe_occupancy(0.9)
    port_bo.get_brownout().observe_occupancy(0.9)
    for cls in (RefCoalescer, PortCoalescer):
        co = cls(lambda texts: [np.float32(len(t)) for t in texts], max_wait_ms=30_000.0)
        t0 = time.perf_counter()
        assert co.embed(["solo query"]) == [np.float32(10)]
        assert time.perf_counter() - t0 < 10.0, cls
        co.close()
