"""The port's chaos harness (``pathway_tpu_torch/internals/chaos.py``)
against the reference's (``pathway_tpu/internals/chaos.py``) on the CPU.

- Every seeded draw and every gate equals the reference's for the same seed
  and plan: frame actions, backend write errors, load profiles, replica lag,
  and the ``at`` / ``run`` gating of the index, checkpoint and scale faults.
- ``PLAN_OPS`` equals the reference's registry, and CHAOS.md documents each.
- The commit kill: ``maybe_kill`` gated by rank, commit and
  ``PATHWAY_RESTART_COUNT`` (``os.kill`` patched); a persisted ``pw.run``
  killed at commit 3 in a subprocess, whose resume gives the reference's
  uninterrupted output; a kill named at a replayed commit never fires.
- The port of ``tests/test_chaos.py::test_chaos_transient_s3_write_errors_are_retried``.

Plans are set with ``monkeypatch.setenv`` only, and both packages' cached
harnesses are reset in ``finally``: a plan left behind would kill a later
test's process. Every run that really kills runs in a subprocess.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from pathway_tpu.internals import chaos as ref_chaos
from pathway_tpu_torch.internals import chaos as port_chaos

from .mocks import DirS3Client
from .torch_parity import clear_graphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
SEEDS = [0, 7, 11, 123456]


@pytest.fixture(autouse=True)
def _no_plan_left(monkeypatch):
    """No plan from the environment reaches a test, and none outlives it."""
    monkeypatch.delenv("PATHWAY_CHAOS_PLAN", raising=False)
    monkeypatch.delenv("PATHWAY_CHAOS_SEED", raising=False)
    monkeypatch.delenv("PATHWAY_RESTART_COUNT", raising=False)
    ref_chaos.reset_chaos()
    port_chaos.reset_chaos()
    try:
        yield
    finally:
        ref_chaos.reset_chaos()
        port_chaos.reset_chaos()


def _both(seed: int, plan: dict) -> tuple:
    return ref_chaos.Chaos(seed, plan), port_chaos.Chaos(seed, plan)


# -- the seeded draws ---------------------------------------------------------


FRAME_PLANS = [
    {"frames": {"drop_prob": 0.2, "delay_prob": 0.3, "delay_ms": 5}},
    {"frames": {"drop_prob": 0.05, "truncate_prob": 0.1, "delay_prob": 0.5, "delay_ms": 12}},
    {"frames": {"truncate_prob": 1.0}},
    {},
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("plan", FRAME_PLANS)
def test_frame_actions_equal_the_references(seed, plan):
    ref, port = _both(seed, plan)
    links = [(0, 1), (1, 0), (0, 2), (3, 1)]
    for i in range(300):
        rank, peer = links[i % len(links)]
        a, b = ref.frame_action(rank, peer), port.frame_action(rank, peer)
        assert (a.kind, a.delay_s) == (b.kind, b.delay_s), (i, rank, peer)
    assert ref.stats == port.stats


class _DictStore:
    def __init__(self):
        self.objects: dict = {}

    def put(self, key, data):
        self.objects[key] = data

    def get(self, key):
        return self.objects.get(key)

    def list(self, prefix):
        return sorted(k for k in self.objects if k.startswith(prefix))

    def delete(self, key):
        self.objects.pop(key, None)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", [
    {"put_error_prob": 0.6, "max_errors": 5},
    {"put_error_prob": 0.3},
    {"put_error_prob": 1.0, "max_errors": 2},
    {"put_error_prob": 0.0, "max_errors": 9},
])
def test_backend_write_errors_equal_the_references(seed, backend):
    plan = {"backend": backend}
    outcomes = []
    for pkg, chaos in zip((ref_chaos, port_chaos), _both(seed, plan)):
        store = chaos.wrap_object_store(_DictStore())
        seq = []
        for i in range(40):
            try:
                store.put(f"k{i}", b"x")
                seq.append("ok")
            except pkg.ChaosBackendError as exc:
                assert isinstance(exc, ConnectionError)
                seq.append("err")
        assert store.list("k") == sorted(f"k{i}" for i in range(40) if seq[i] == "ok")
        outcomes.append((seq, dict(chaos.stats)))
    assert outcomes[0] == outcomes[1]
    # without a backend entry the store is not wrapped
    inner = _DictStore()
    assert port_chaos.Chaos(seed, {}).wrap_object_store(inner) is inner


LOAD_PLANS = [
    {"op": "load_spike", "low": 50, "high": 400, "at_s": 2.0, "duration_s": 1.5},
    {"op": "oscillating_load", "period_s": 4.0, "low": 50, "high": 400},
    {"op": "oscillating_load"},
    {"op": "noisy_neighbor", "client": "flood", "rps": 250.0, "rows": 8},
    {"op": "noisy_neighbor"},
]


@pytest.mark.parametrize("load", LOAD_PLANS)
def test_load_profiles_equal_the_references(load):
    ref, port = _both(3, {"load": load})
    for i in range(200):
        t = i * 0.0731
        assert ref.load_rate(t) == port.load_rate(t), t
    assert ref.noisy_neighbor() == port.noisy_neighbor()
    assert port_chaos.Chaos(3, {}).load_rate(1.0) is None


@pytest.mark.parametrize("run", [0, 1])
def test_replica_faults_equal_the_references(run, monkeypatch):
    monkeypatch.setenv("PATHWAY_RESTART_COUNT", str(run))
    plan = {"replica": [
        {"op": "replica_lag", "replica": 1, "lag_s": 0.25, "frames": 3},
        {"op": "replica_lag", "replica": 2, "lag_s": 0.5, "run": 1},
        {"op": "replica_torn_bootstrap", "replica": 0, "run": 0},
        {"op": "replica_kill", "replica": 3, "commit": 5},
    ]}
    ref, port = _both(1, plan)
    for chaos in (ref, port):
        chaos.lags = [(r, chaos.replica_lag_s(r)) for _ in range(5) for r in range(4)]
        chaos.torn = [chaos.replica_fault("replica_torn_bootstrap", r) for r in range(4)]
    assert ref.lags == port.lags and ref.torn == port.torn
    killed = []
    monkeypatch.setattr(port_chaos.os, "kill", lambda pid, sig: killed.append((pid, sig)))
    port.maybe_replica_kill(3, 4)
    port.maybe_replica_kill(2, 5)
    assert killed == []
    port.maybe_replica_kill(3, 5)
    assert killed == [(os.getpid(), signal.SIGKILL)]
    ref.stats["kills"] += 1
    ref.stats["replica_faults"] += 1
    assert ref.stats == port.stats


def _gates(chaos, faults: list) -> list:
    """Fire every kind of attempt-gated fault over three attempts of each
    counter, with ``os.kill`` patched by the caller."""
    out = []
    for _attempt in range(3):
        out.append(("ckpt", chaos.begin_checkpoint_attempt()))
        out += [(op, r, chaos.checkpoint_fault(op, r)) for op, r in faults if op in
                ref_chaos.PLAN_OPS["checkpoint"]]
        chaos.maybe_checkpoint_kill(0, 9)
        chaos.maybe_checkpoint_kill(1, 9, op="pre_snapshot_kill")
        out.append(("scale", chaos.begin_scale_attempt()))
        out += [(op, r, chaos.scale_fault(op, r)) for op, r in faults if op in
                ref_chaos.PLAN_OPS["scale"]]
        chaos.maybe_scale_kill(2, "scale_join_kill", joiner=True)
        out.append(("rebuild", chaos.begin_rebuild_attempt()))
        out += [(op, r, chaos.index_fault(op, r)) for op, r in faults if op in
                ref_chaos.PLAN_OPS["index"]]
        chaos.maybe_rebuild_kill(0, generation=1)
    out.append(("rejoin", [chaos.drop_rejoin(r) for r in range(3)]))
    out.append(("sched", chaos.sched_seed()))
    return out


@pytest.mark.parametrize("run", [0, 1, 2])
def test_attempt_gated_faults_equal_the_references(run, monkeypatch):
    """The index, checkpoint and scale faults fire at the same ``at`` /
    ``run`` in both packages (the kill-type ops with ``os.kill`` patched)."""
    monkeypatch.setenv("PATHWAY_RESTART_COUNT", str(run))
    plan = {
        "checkpoint": [
            {"op": "post_snapshot_kill", "rank": 0, "run": 0, "at": 1},
            {"op": "pre_snapshot_kill", "rank": 1, "at": 2},
            {"op": "torn_manifest", "rank": 0},
            {"op": "snapshot_error", "rank": 1, "run": 1, "at": 0},
        ],
        "scale": [
            {"op": "scale_join_kill", "rank": 2, "run": 0, "at": 0},
            {"op": "handoff_torn", "rank": 1, "at": 1},
            {"op": "scale_refused", "rank": 0, "run": 2},
        ],
        "index": [
            {"op": "quant", "rank": 0, "at": 0},
            {"op": "tier_swap_torn", "rank": 0, "at": 1, "run": 1},
            {"op": "rebuild_kill", "rank": 0, "at": 2},
        ],
        "rejoin": [{"rank": 0, "run": 1}, {"rank": 2}],
        "sched": {"seed": 7},
    }
    faults = [(op, r) for ops in ref_chaos.PLAN_OPS.values() for op in ops for r in range(3)]
    results = []
    for pkg, chaos in zip((ref_chaos, port_chaos), _both(5, plan)):
        killed: list = []
        monkeypatch.setattr(pkg.os, "kill", lambda pid, sig, killed=killed: killed.append(sig))
        results.append((_gates(chaos, faults), killed, dict(chaos.stats)))
    assert results[0] == results[1]
    assert any(fired for *_x, fired in results[1][0] if isinstance(fired, bool))


def test_plan_ops_equal_the_references_and_chaos_md_documents_each():
    assert port_chaos.PLAN_OPS == ref_chaos.PLAN_OPS
    with open(os.path.join(REPO, "CHAOS.md")) as f:
        text = f.read()
    documented: dict = {}
    current = None
    for line in text.splitlines():
        m = re.match(r"^### `(\w+)`", line)
        if m:
            current = m.group(1)
            continue
        m = re.match(r"^\| `([a-z0-9_]+)` \|", line)
        if m and current is not None:
            documented.setdefault(current, set()).add(m.group(1))
    for key, ops in port_chaos.PLAN_OPS.items():
        assert set(ops) <= documented.get(key, set()), key


# -- the environment contract -----------------------------------------------------


def test_get_chaos_env_contract(monkeypatch):
    assert port_chaos.get_chaos() is None
    assert ref_chaos.get_chaos() is None  # cached: resetting the port's keeps it
    # a seed alone configures nothing
    monkeypatch.setenv("PATHWAY_CHAOS_SEED", "42")
    port_chaos.reset_chaos()
    assert port_chaos.get_chaos() is None
    # cached until reset
    monkeypatch.setenv("PATHWAY_CHAOS_PLAN", json.dumps({"frames": {"drop_prob": 1.0}}))
    assert port_chaos.get_chaos() is None
    port_chaos.reset_chaos()
    c = port_chaos.get_chaos()
    assert c is not None and c.seed == 42 and port_chaos.get_chaos() is c
    assert c.frame_action(0, 1).kind == "drop"
    # the two packages' caches are separate modules
    assert ref_chaos.get_chaos() is None
    ref_chaos.reset_chaos()
    assert ref_chaos.get_chaos().frame_action(0, 1).kind == "drop"
    monkeypatch.setenv("PATHWAY_CHAOS_PLAN", "{not json")
    port_chaos.reset_chaos()
    with pytest.raises(ValueError, match="PATHWAY_CHAOS_PLAN is not valid JSON"):
        port_chaos.get_chaos()


def test_maybe_kill_gates_on_rank_commit_and_restart_count(monkeypatch):
    killed = []
    monkeypatch.setattr(port_chaos.os, "kill", lambda pid, sig: killed.append((pid, sig)))
    plan = {"kill": [{"rank": 1, "commit": 3, "run": 0}, {"rank": 0, "commit": 5, "epoch": 2}]}
    c = port_chaos.Chaos(0, plan)
    c.maybe_kill(0, 3)  # wrong rank
    c.maybe_kill(1, 2)  # wrong commit
    c.maybe_kill(0, 5)  # wrong epoch
    assert killed == []
    c.maybe_kill(1, 3)
    assert killed == [(os.getpid(), signal.SIGKILL)]
    c.maybe_kill(0, 5, epoch=2)
    assert len(killed) == 2 and c.stats["kills"] == 2
    # a restarted incarnation survives the replayed schedule
    monkeypatch.setenv("PATHWAY_RESTART_COUNT", "1")
    killed.clear()
    port_chaos.Chaos(0, plan).maybe_kill(1, 3)
    assert killed == []


# -- the commit kill through pw.run ---------------------------------------------------

_KILL_PROG = """
import json, os, sys
sys.path.insert(0, sys.argv[1])
import pathway_tpu_torch as pw

watch, store, out_path = sys.argv[2:5]
t = pw.io.csv.read(watch, schema=pw.schema_builder({"word": str}), mode="streaming",
                   autocommit_duration_ms=None)
counts = t.groupby(t.word).reduce(t.word, total=pw.reducers.count())
rows = {}

def on_change(key, row, time, is_addition):
    if is_addition:
        rows[repr(key)] = [row["word"], int(row["total"])]
    else:
        rows.pop(repr(key), None)
    with open(out_path + ".tmp", "w") as f:
        json.dump(sorted(rows.values()), f)
    os.replace(out_path + ".tmp", out_path)

pw.io.subscribe(counts, on_change)
pw.run(persistence_config=pw.persistence.Config(pw.persistence.Backend.filesystem(store)),
       device="cpu")
"""

WORDS = [
    ["cat"] * 5 + ["dog"] * 3,
    ["cat"] * 2 + ["owl"] * 4 + ["emu"],
    ["dog"] * 6 + ["owl"] + ["yak"] * 2,
]


def _reference_counts(watch: str) -> list:
    """The reference's uninterrupted run over the same files (static)."""
    import pathway_tpu as ref_pw
    from pathway_tpu.engine.runner import GraphRunner

    clear_graphs()
    try:
        t = ref_pw.io.csv.read(watch, schema=ref_pw.schema_builder({"word": str}),
                               mode="static")
        counts = t.groupby(t.word).reduce(t.word, total=ref_pw.reducers.count())
        rows: dict = {}

        def on_change(key, row, time, is_addition):
            if is_addition:
                rows[key] = [row["word"], int(row["total"])]
            else:
                rows.pop(key, None)

        ref_pw.io.subscribe(counts, on_change)
        GraphRunner(ref_pw.internals.parse_graph.G._current).run()
        return sorted(rows.values())
    finally:
        clear_graphs()


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def test_commit_kill_then_resume_gives_the_references_output(tmp_path):
    """Run 1 dies with SIGKILL at commit 3 and dumps ``chaos_kill``; Run 2,
    with restart count 1 and the same plan, resumes from the journal and
    ends at the reference's uninterrupted output."""
    watch, store = tmp_path / "in", tmp_path / "store"
    watch.mkdir()
    for i, words in enumerate(WORDS):
        (watch / f"f{i}.csv").write_text("word\n" + "\n".join(words) + "\n")
    script = tmp_path / "prog.py"
    script.write_text(_KILL_PROG)
    out_path, dumps = str(tmp_path / "out.json"), tmp_path / "dumps"
    dumps.mkdir()
    plan = json.dumps({"kill": [{"rank": 0, "commit": 3, "run": 0}]})
    env = {**os.environ, "PATHWAY_CHAOS_PLAN": plan, "PATHWAY_CHAOS_SEED": "0",
           "PATHWAY_FLIGHT_RECORDER_DIR": str(dumps), "PATHWAY_RESTART_COUNT": "0"}
    cmd = [sys.executable, str(script), REPO, str(watch), str(store), out_path]
    run1 = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True,
                          timeout=CHILD_TIMEOUT_S)
    assert run1.returncode == -signal.SIGKILL, run1.stderr.decode()[-2000:]
    with open(dumps / "flight-rank-0.json") as f:
        dump = json.load(f)
    assert dump["reason"] == "chaos_kill"
    kills = [e for e in dump["events"] if e["kind"] == "chaos_kill"]
    assert [(e["rank"], e["commit"]) for e in kills] == [(0, 3)]
    # the journal holds the commits before the kill only
    from pathway_tpu_torch.persistence.engine import PersistenceManager
    import pathway_tpu_torch as pw

    with open(store / "journal.bin", "rb") as f:
        f.readline()
        sig = json.loads(f.readline())["sig"]
    frames = PersistenceManager(pw.persistence.Config(
        pw.persistence.Backend.filesystem(str(store)))).load_journal(sig)
    assert frames and max(cid for cid, _d, _o in frames) < 3

    want = _reference_counts(str(watch))
    run2 = subprocess.Popen(cmd, env={**env, "PATHWAY_RESTART_COUNT": "1"},
                            cwd=str(tmp_path), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while time.monotonic() < deadline and _read_json(out_path) != want:
            assert run2.poll() is None, run2.communicate()[1].decode()[-2000:]
            time.sleep(0.1)
        time.sleep(0.5)  # nothing more may come
        got = _read_json(out_path)
        assert run2.poll() is None, "the resume ended (or was killed) on its own"
    finally:
        if run2.poll() is None:
            run2.kill()
        run2.communicate(timeout=CHILD_TIMEOUT_S)
    assert got == want


def test_a_kill_named_at_a_replayed_commit_never_fires(tmp_path, monkeypatch):
    """Every journaled commit id is named by a kill entry of run 0; the
    resume replays them all and fires none (``os.kill`` patched), while a
    fresh run without persistence fires at the first."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.persistence.engine import PersistenceManager

    watch = tmp_path / "in"
    watch.mkdir()
    for i, words in enumerate(WORDS):
        (watch / f"f{i}.csv").write_text("word\n" + "\n".join(words) + "\n")
    cfg = pw.persistence.Config(pw.persistence.Backend.filesystem(str(tmp_path / "store")))

    def program() -> dict:
        G.clear()
        t = pw.io.csv.read(str(watch), schema=pw.schema_builder({"word": str}), mode="static")
        counts = t.groupby(t.word).reduce(t.word, total=pw.reducers.count())
        rows: dict = {}

        def on_change(key, row, time, is_addition):
            if is_addition:
                rows[key] = [row["word"], int(row["total"])]
            else:
                rows.pop(key, None)

        pw.io.subscribe(counts, on_change)
        return rows

    killed: list = []
    monkeypatch.setattr(port_chaos.os, "kill", lambda pid, sig: killed.append(sig))
    try:
        rows1 = program()
        runner = GraphRunner(G)
        runner.run(device="cpu", persistence_config=cfg)
        frames = PersistenceManager(cfg).load_journal(runner._graph_sig)
        journaled = sorted({cid for cid, _d, _o in frames})
        assert journaled
        plan = {"kill": [{"rank": 0, "commit": c, "run": 0} for c in journaled]}
        monkeypatch.setenv("PATHWAY_CHAOS_PLAN", json.dumps(plan))
        port_chaos.reset_chaos()
        rows2 = program()
        resumed = GraphRunner(G)
        resumed.run(device="cpu", persistence_config=cfg)
        assert resumed.persist_stats["replay_frames"] == len(frames)
        assert killed == []
        assert sorted(rows2.values()) == sorted(rows1.values())
        # the same plan fires on a live commit
        program()
        GraphRunner(G).run(device="cpu")
        assert killed and set(killed) == {signal.SIGKILL}
    finally:
        G.clear()
        port_chaos.reset_chaos()


# -- transient object-store write errors ------------------------------------------------


@pytest.mark.chaos
def test_chaos_transient_s3_write_errors_are_retried(tmp_path, monkeypatch):
    """Injected transient PUT failures on the S3 backend are absorbed by the
    retry layer above them: the run completes, every journal object lands,
    and a resume replays them: outputs equal the reference's."""
    import importlib

    monkeypatch.setenv("PATHWAY_CHAOS_SEED", "11")
    monkeypatch.setenv(
        "PATHWAY_CHAOS_PLAN", json.dumps({"backend": {"put_error_prob": 0.6, "max_errors": 5}})
    )
    results = {}
    for name in ("pathway_tpu", "pathway_tpu_torch"):
        pw = importlib.import_module(name)
        chaos_mod = importlib.import_module(f"{name}.internals.chaos")
        GraphRunner = importlib.import_module(f"{name}.engine.runner").GraphRunner
        G = importlib.import_module(f"{name}.internals.parse_graph").G
        retry = importlib.import_module(f"{name}.internals.udfs").ExponentialBackoffRetryStrategy
        run_kw = {"device": "cpu"} if name == "pathway_tpu_torch" else {}
        client = DirS3Client(str(tmp_path / f"fake-s3-{name}"))
        chaos_mod.reset_chaos()

        def run_once() -> dict:
            clear_graphs()
            t = pw.debug.table_from_markdown(
                """
                word  | n
                cat   | 1
                dog   | 2
                cat   | 3
                """
            )
            counts = t.groupby(t.word).reduce(t.word, total=pw.reducers.sum(t.n))
            rows: dict = {}

            def on_change(key, row, time, is_addition):
                if is_addition:
                    rows[key] = row
                else:
                    rows.pop(key, None)

            pw.io.subscribe(counts, on_change)
            cfg = pw.persistence.Config(
                pw.persistence.Backend.s3(
                    "s3://bucket/chaos", _client_factory=lambda settings: client
                ),
                backend_retry_strategy=retry(
                    max_retries=6, initial_delay=5, backoff_factor=2, jitter_ms=2
                ),
            )
            GraphRunner(G._current if hasattr(G, "_current") else G).run(
                persistence_config=cfg, **run_kw)
            return {r["word"]: r["total"] for r in rows.values()}

        try:
            first = run_once()
            harness = chaos_mod.get_chaos()
            assert harness is not None and harness.stats["backend_errors"] >= 1, name
            second = run_once()  # the resume reads every frame object
            results[name] = (first, second)
        finally:
            clear_graphs()
            chaos_mod.reset_chaos()
    assert results["pathway_tpu_torch"] == results["pathway_tpu"]
    assert results["pathway_tpu"][0] == {"cat": 4, "dog": 2}
