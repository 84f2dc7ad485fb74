"""The port's deterministic scheduler (``pathway_tpu_torch/internals/sched.py``):
the cases of the reference's ``tests/test_sched.py`` run on the port, then
parity with the reference's scheduler: the same seed, or the same
``choices=``, takes the same decisions in both, and the seed falls back to
the port's own chaos plan."""
from __future__ import annotations

import threading

import pytest

from pathway_tpu_torch.internals.sched import (
    DeadlockError,
    DeterministicScheduler,
    InvariantViolation,
    LivelockError,
    SchedulingError,
    default_seed,
    explore,
    run_once,
    sweep_seeds,
)

pytestmark = pytest.mark.modelcheck


def _locked_counter_model(sched):
    """Two workers increment a shared counter under a lock: always 6."""
    state = {"x": 0}
    lock = sched.lock("L")

    def worker():
        for _ in range(3):
            with lock:
                v = state["x"]
                sched.yield_point("compute")
                state["x"] = v + 1

    sched.spawn(worker, name="w1")
    sched.spawn(worker, name="w2")

    def check():
        assert state["x"] == 6, f"locked counter lost updates: {state['x']}"

    return check


def _racy_counter_model(sched):
    """Same, no lock: a classic lost update on the right interleaving."""
    state = {"x": 0}

    def worker():
        for _ in range(2):
            v = state["x"]
            sched.yield_point("compute")
            state["x"] = v + 1

    sched.spawn(worker, name="w1")
    sched.spawn(worker, name="w2")

    def check():
        assert state["x"] == 4, f"lost update: {state['x']}"

    return check


# ---------------------------------------------------------------------------
# replay identity
# ---------------------------------------------------------------------------


def test_seeded_schedules_replay_identically():
    a = run_once(_locked_counter_model, seed=42)
    b = run_once(_locked_counter_model, seed=42)
    assert a.choices_taken == b.choices_taken
    assert a.trace == b.trace


def test_different_seeds_reach_different_schedules():
    schedules = {
        tuple(run_once(_locked_counter_model, seed=s).choices_taken)
        for s in range(10)
    }
    assert len(schedules) > 1


def test_choice_list_replay_is_exact():
    a = run_once(_locked_counter_model, seed=7)
    b = run_once(_locked_counter_model, choices=a.choices_taken)
    assert b.choices_taken == a.choices_taken
    assert b.trace == a.trace


def test_failing_schedule_replays_the_failure():
    result = explore(_racy_counter_model, max_schedules=300, name="racy")
    assert result.failure is not None
    assert isinstance(result.failure, InvariantViolation)
    assert result.failing_schedule == result.failure.schedule
    with pytest.raises(InvariantViolation):
        run_once(_racy_counter_model, choices=result.failing_schedule)


# ---------------------------------------------------------------------------
# failure detection
# ---------------------------------------------------------------------------


def test_lock_inversion_deadlock_detected_with_schedule():
    def inverted(sched):
        a, b = sched.lock("A"), sched.lock("B")

        def t1():
            with a:
                sched.yield_point("gap")
                with b:
                    pass

        def t2():
            with b:
                sched.yield_point("gap")
                with a:
                    pass

        sched.spawn(t1, name="t1")
        sched.spawn(t2, name="t2")
        return None

    result = explore(inverted, max_schedules=200, name="inverted")
    assert isinstance(result.failure, DeadlockError)
    assert result.failing_schedule
    with pytest.raises(DeadlockError) as exc_info:
        run_once(inverted, choices=result.failing_schedule)
    assert exc_info.value.schedule == result.failing_schedule


def test_untimed_wait_deadlocks_timed_wait_survives():
    def waiter(timeout):
        def model(sched):
            cv = sched.condition(name="cv")
            done = {"ok": False}

            def t1():
                with cv:
                    while not done["ok"]:
                        if not cv.wait(timeout=timeout):
                            done["ok"] = True  # deadline abort path

            sched.spawn(t1, name="t1")
            return None

        return model

    # nobody will ever notify: the untimed wait is a guaranteed deadlock —
    # the dynamic proof of the PWA102 rule
    assert isinstance(explore(waiter(None), max_schedules=20).failure, DeadlockError)
    assert explore(waiter(1.0), max_schedules=20).ok


def test_livelock_bound():
    def spinner(sched):
        def t1():
            while True:
                sched.yield_point("spin")

        sched.spawn(t1, name="t1")
        return None

    with pytest.raises(LivelockError):
        run_once(spinner, seed=0, max_steps=50)


def test_model_exception_is_typed_and_replayable():
    def crasher(sched):
        def t1():
            sched.yield_point("pre")
            raise ValueError("boom")

        sched.spawn(t1, name="t1")
        return None

    with pytest.raises(SchedulingError) as exc_info:
        run_once(crasher, seed=0)
    assert "boom" in str(exc_info.value)
    assert exc_info.value.schedule  # replayable


# ---------------------------------------------------------------------------
# exploration
# ---------------------------------------------------------------------------


def test_explore_produces_distinct_schedules():
    result = explore(_locked_counter_model, max_schedules=120, name="distinct")
    assert result.ok
    assert result.schedules_run == 120
    assert result.distinct_schedules == 120  # DFS: every schedule differs


def test_explore_exhausts_tiny_trees():
    def tiny(sched):
        def t1():
            sched.yield_point("only")

        sched.spawn(t1, name="t1")
        return None

    result = explore(tiny, max_schedules=100, name="tiny")
    assert result.ok
    assert result.schedules_run < 100  # exhausted, not capped


def test_sweep_seeds_records_failing_seed():
    result = sweep_seeds(_racy_counter_model, n_seeds=100, base_seed=0)
    assert result.failure is not None
    assert result.failing_seed is not None
    with pytest.raises(InvariantViolation):
        run_once(_racy_counter_model, seed=result.failing_seed)


# ---------------------------------------------------------------------------
# seed resolution + telemetry + hygiene
# ---------------------------------------------------------------------------


def test_default_seed_env_and_chaos_plan(monkeypatch):
    from pathway_tpu_torch.internals import chaos as chaos_mod

    monkeypatch.setenv("PATHWAY_SCHED_SEED", "1234")
    assert default_seed() == 1234
    monkeypatch.delenv("PATHWAY_SCHED_SEED")
    monkeypatch.setenv("PATHWAY_CHAOS_PLAN", '{"sched": {"seed": 77}}')
    chaos_mod.reset_chaos()
    try:
        assert default_seed() == 77
        assert chaos_mod.get_chaos().sched_seed() == 77
    finally:
        monkeypatch.delenv("PATHWAY_CHAOS_PLAN")
        chaos_mod.reset_chaos()


def test_failure_emits_modelcheck_flight_event_and_counters(monkeypatch):
    from pathway_tpu_torch.engine import telemetry
    from pathway_tpu_torch.engine.profile import get_flight_recorder

    recorder = get_flight_recorder()
    monkeypatch.setattr(recorder, "enabled", True)
    telemetry.stage_reset("modelcheck.")
    result = sweep_seeds(_racy_counter_model, n_seeds=100, base_seed=0, name="racy-tel")
    assert result.failure is not None
    counters = telemetry.stage_snapshot("modelcheck.")
    assert counters.get("modelcheck.runs", 0) >= 1, counters
    assert counters.get("modelcheck.failures", 0) >= 1, counters
    events = [
        ev for ev in list(recorder._events) if ev.get("kind") == "modelcheck"
    ]
    assert events, "no modelcheck flight event recorded"
    ev = events[-1]
    assert ev["model"] == "racy-tel"
    assert ev["seed"] == result.failing_seed
    assert ev["schedule"] == result.failing_schedule


def test_scheduler_leaks_no_threads():
    before = {t.ident for t in threading.enumerate()}
    run_once(_locked_counter_model, seed=3)
    result = explore(_racy_counter_model, max_schedules=50)
    assert result.failure is not None  # aborted runs must clean up too
    leaked = [
        t
        for t in threading.enumerate()
        if t.ident not in before and t.name.startswith("pathway:sched")
    ]
    for t in leaked:
        t.join(timeout=5)
    leaked = [
        t
        for t in threading.enumerate()
        if t.ident not in before and t.name.startswith("pathway:sched")
    ]
    assert not leaked, [t.name for t in leaked]


def test_one_scheduler_drives_one_run():
    sched = DeterministicScheduler(seed=0)
    sched.spawn(lambda: None, name="t")
    sched.run()
    with pytest.raises(RuntimeError):
        sched.run()


# ---------------------------------------------------------------------------
# parity with the reference's scheduler
# ---------------------------------------------------------------------------

from pathway_tpu.internals import sched as ref_sched  # noqa: E402
from pathway_tpu_torch.internals import sched as port_sched  # noqa: E402


def _cv_handoff_model(sched):
    """A producer and two consumers on a condition with a timed and an
    untimed wait, and an event: every primitive's decision points (the
    untimed consumer can miss the last wakeup: a deadlock on some
    schedules)."""
    cv = sched.condition(name="cv")
    ev = sched.event("done")
    state = {"items": 0, "taken": 0}

    def producer():
        for _ in range(3):
            with cv:
                state["items"] += 1
                cv.notify_all()
            sched.yield_point("produced")
        ev.set()
        with cv:
            cv.notify_all()

    def consumer(timed):
        while state["taken"] < 3 and not ev.is_set():
            with cv:
                if state["items"]:
                    state["items"] -= 1
                    state["taken"] += 1
                else:
                    cv.wait(timeout=1.0 if timed else None)

    sched.spawn(producer, name="p")
    sched.spawn(consumer, True, name="c1")
    sched.spawn(consumer, False, name="c2")

    def check():
        assert state["items"] + state["taken"] == 3

    return check


PARITY_MODELS = {
    "locked_counter": _locked_counter_model,
    "racy_counter": _racy_counter_model,
    "cv_handoff": _cv_handoff_model,
}


def _outcome(mod, model, **kw):
    """(choices, enabled counts, trace, failure type) of one run."""
    sched = mod.DeterministicScheduler(
        seed=kw.get("seed"), choices=kw.get("choices"),
        policy="first" if "choices" in kw else "rng", name="parity",
    )
    failure = None
    try:
        check = model(sched)
        sched.run(check=check)
    except mod.SchedulingError as exc:
        failure = type(exc).__name__
    return sched.choices_taken, sched.enabled_counts, sched.trace, failure


@pytest.mark.parametrize("name", sorted(PARITY_MODELS))
@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_same_seed_takes_the_same_decisions_as_the_reference(name, seed):
    model = PARITY_MODELS[name]
    want = _outcome(ref_sched, model, seed=seed)
    got = _outcome(port_sched, model, seed=seed)
    assert got == want
    assert got[0], "the run took no decision: the case compares nothing"


@pytest.mark.parametrize("name", sorted(PARITY_MODELS))
def test_same_choices_replay_the_same_schedule_as_the_reference(name):
    model = PARITY_MODELS[name]
    recorded = _outcome(ref_sched, model, seed=99)[0]
    # a recorded schedule, one cut short (the policy takes over), and one
    # whose indices run past the enabled threads (clamped)
    for choices in (recorded, recorded[: len(recorded) // 2], [5] * 8):
        want = _outcome(ref_sched, model, choices=choices)
        got = _outcome(port_sched, model, choices=choices)
        assert got == want


@pytest.mark.parametrize("name", sorted(PARITY_MODELS))
def test_explore_and_sweep_equal_the_reference(name):
    model = PARITY_MODELS[name]
    for run in (
        lambda mod: mod.explore(model, max_schedules=60, name=name),
        lambda mod: mod.sweep_seeds(model, n_seeds=40, base_seed=3, name=name),
    ):
        want, got = run(ref_sched), run(port_sched)
        assert (got.ok, got.schedules_run, got.distinct_schedules, got.failing_seed,
                got.failing_schedule) == (want.ok, want.schedules_run,
                                          want.distinct_schedules, want.failing_seed,
                                          want.failing_schedule)
        assert type(got.failure).__name__ == type(want.failure).__name__


def test_default_seed_reads_the_port_chaos_plan_not_the_reference(monkeypatch):
    from pathway_tpu.internals import chaos as ref_chaos
    from pathway_tpu_torch.internals import chaos as port_chaos

    monkeypatch.delenv("PATHWAY_SCHED_SEED", raising=False)
    monkeypatch.setenv("PATHWAY_CHAOS_PLAN", '{"sched": {"seed": 7}}')
    port_chaos.reset_chaos()
    ref_chaos.reset_chaos()
    try:
        assert port_sched.default_seed() == 7
        assert port_chaos.get_chaos().sched_seed() == 7
        # an unseeded scheduler and sweep start from the plan's seed
        assert port_sched.DeterministicScheduler().seed == 7
        want = _outcome(ref_sched, _locked_counter_model, seed=7)
        sched = port_sched.run_once(_locked_counter_model)
        assert sched.seed == 7 and sched.choices_taken == want[0]
    finally:
        monkeypatch.delenv("PATHWAY_CHAOS_PLAN")
        port_chaos.reset_chaos()
        ref_chaos.reset_chaos()
    assert port_sched.default_seed() == 0
