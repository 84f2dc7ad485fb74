"""Deterministic schedule exploration (port of ``pathway_tpu/internals/sched.py``).

The same decision sequence as the reference's for the same seed or
``choices=``; the counters and the flight event go to the port's own
telemetry plane, and the seed falls back to the port's chaos plan.

The reference's docstring follows.

The fence/quiesce/rejoin dance, the aligned checkpoint sequence, and the
coalescer's admission protocol are hand-written thread protocols whose bugs
live in *interleavings* — and until now the only interleavings ever tested
were whatever the OS scheduler produced (chaos testing). This module is a
loom/shuttle-style deterministic scheduler: protocol *models* (see
``internals/protocol_models.py``) run on real Python threads, but every
synchronization primitive is a controlled handoff point — exactly ONE model
thread runs at a time, and at every decision point the scheduler picks which
runnable thread proceeds. That makes a run a pure function of its decision
sequence, so schedules can be:

- **seeded** (``DeterministicScheduler(seed=N)``) — a random walk whose
  choices replay bit-identically from the same seed;
- **replayed** (``choices=[...]``) — the exact failing interleaving re-runs
  from the recorded choice list (``sched.choices_taken``);
- **explored** (:func:`explore`) — bounded-exhaustive DFS over the decision
  tree (the CHESS/stateless-model-checking shape): every schedule differs in
  at least one decision, so N schedules are N *distinct* interleavings.

Failure modes are typed and all carry the replayable schedule:
:class:`DeadlockError` (no thread can proceed — e.g. a lock-order inversion),
:class:`LivelockError` (step bound exceeded), :class:`InvariantViolation`
(a model assertion failed under this interleaving). Each failure also emits a
``modelcheck`` flight-recorder event naming the model, seed, and failing
choice sequence, and bumps the ``modelcheck.*`` stage counters — the same
telemetry plane the chaos harness feeds.

Timeouts are modeled, not slept: a ``wait(timeout=...)`` is *always*
schedulable — the scheduler may deliver a spurious/timeout wakeup — while an
untimed ``wait()`` is only runnable after a notify. A protocol that deadlocks
under model checking unless its waits are timed is exactly the PWA102
finding, proven dynamically.

Seed resolution when neither ``seed`` nor ``choices`` is given:
``PATHWAY_SCHED_SEED`` env var, else the chaos plan's ``{"sched": {"seed": N}}``
entry (``internals/chaos.py``), else 0.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# one handoff must complete within this wall bound or the HOST (not the model)
# is considered wedged — model-level deadlocks are detected logically and
# never wait on wall time
_WALL_TIMEOUT_S = 20.0


class SchedulingError(RuntimeError):
    """Base of every model-check failure; carries the replayable schedule."""

    def __init__(
        self,
        message: str,
        *,
        schedule: "Sequence[int] | None" = None,
        seed: "int | None" = None,
        trace: "Sequence[str] | None" = None,
    ):
        super().__init__(message)
        self.schedule = list(schedule or [])
        self.seed = seed
        self.trace = list(trace or [])


class DeadlockError(SchedulingError):
    """No runnable thread remains while unfinished threads exist."""


class LivelockError(SchedulingError):
    """The step bound was exceeded (or a model thread stopped yielding)."""


class InvariantViolation(SchedulingError):
    """A model assertion failed under this interleaving."""


class _Killed(BaseException):
    """Internal: unwinds model threads when a run aborts. BaseException so
    model-level ``except Exception`` cannot swallow the teardown."""


def default_seed() -> int:
    """PATHWAY_SCHED_SEED, else the chaos plan's ``sched.seed``, else 0."""
    env = os.environ.get("PATHWAY_SCHED_SEED")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    try:
        from pathway_tpu_torch.internals.chaos import get_chaos

        chaos = get_chaos()
        if chaos is not None:
            seed = chaos.sched_seed()
            if seed is not None:
                return seed
    except Exception:
        pass
    return 0


class _Thread:
    """One model thread under scheduler control."""

    __slots__ = (
        "name", "fn", "args", "go", "done", "started",
        "pred", "timed", "wake_reason", "op", "exception", "real",
    )

    def __init__(self, name: str, fn: Callable[..., Any], args: tuple):
        self.name = name
        self.fn = fn
        self.args = args
        self.go = threading.Event()
        self.done = False
        self.started = False
        self.pred: "Optional[Callable[[], bool]]" = None
        self.timed = False
        self.wake_reason = "signal"
        self.op = "spawn"
        self.exception: "Optional[BaseException]" = None
        self.real: "Optional[threading.Thread]" = None


class DeterministicScheduler:
    """Runs model threads one at a time under a controlled decision sequence.

    Use :meth:`lock`/:meth:`condition`/:meth:`event` to mint primitives,
    :meth:`spawn` to add threads, then :meth:`run` (from the owning thread) to
    drive the model to completion. ``choices`` replays a recorded schedule
    prefix; past its end the policy takes over (``"rng"`` = seeded random
    walk, ``"first"`` = lowest-index — what the DFS explorer uses)."""

    def __init__(
        self,
        *,
        seed: "Optional[int]" = None,
        choices: "Optional[Sequence[int]]" = None,
        policy: str = "rng",
        max_steps: int = 20_000,
        name: str = "model",
    ):
        if seed is None:
            seed = default_seed()
        self.seed = seed
        self.name = name
        self.policy = policy
        self.max_steps = max_steps
        self._rng = random.Random(seed)
        self._preset = list(choices or [])
        #: decision list of this run — replay it via ``choices=`` for an
        #: identical interleaving
        self.choices_taken: List[int] = []
        #: how many threads were enabled at each decision (DFS backtracking)
        self.enabled_counts: List[int] = []
        #: human-readable step log: "step thread op"
        self.trace: List[str] = []
        self._threads: List[_Thread] = []
        self._control = threading.Event()
        self._killed = False
        self._tls = threading.local()
        self._ran = False

    # -- primitives ----------------------------------------------------------

    def lock(self, name: str = "lock") -> "SchedLock":
        return SchedLock(self, name)

    def condition(self, lock: "Optional[SchedLock]" = None, name: str = "cond") -> "SchedCondition":
        return SchedCondition(self, lock, name)

    def event(self, name: str = "event") -> "SchedEvent":
        return SchedEvent(self, name)

    # -- threads -------------------------------------------------------------

    def spawn(self, fn: Callable[..., Any], *args: Any, name: "Optional[str]" = None) -> None:
        """Register (and start, parked) one model thread. Callable both before
        :meth:`run` and from inside a running model thread (a model of a
        supervisor relaunching a rank spawns mid-run)."""
        t = _Thread(name or f"t{len(self._threads)}", fn, args)
        self._threads.append(t)
        real = threading.Thread(
            target=self._wrapper, args=(t,), daemon=True,
            name=f"pathway:sched-{self.name}-{t.name}",
        )
        t.real = real
        real.start()

    def _wrapper(self, t: _Thread) -> None:
        self._tls.current = t
        try:
            # park until first scheduled
            while not t.go.wait(timeout=0.25):
                if self._killed:
                    return
            t.go.clear()
            if self._killed:
                return
            t.fn(*t.args)
        except _Killed:
            pass
        except BaseException as exc:
            t.exception = exc
        finally:
            t.done = True
            self._control.set()

    def current(self) -> _Thread:
        t = getattr(self._tls, "current", None)
        if t is None:
            raise RuntimeError("not inside a scheduler-managed thread")
        return t

    # -- handoff core --------------------------------------------------------

    def yield_point(
        self,
        op: str = "step",
        *,
        pred: "Optional[Callable[[], bool]]" = None,
        timed: bool = False,
    ) -> str:
        """Called from model threads: hand control back to the scheduler.
        With ``pred`` the thread blocks until the predicate holds (or, if
        ``timed``, until the scheduler delivers a timeout wakeup). Returns the
        wake reason: ``"signal"`` or ``"timeout"``."""
        t = self.current()
        t.op = op
        t.pred = pred
        t.timed = timed
        self._control.set()
        while not t.go.wait(timeout=0.25):
            if self._killed:
                raise _Killed()
        t.go.clear()
        if self._killed:
            raise _Killed()
        return t.wake_reason

    def _choose(self, n: int) -> int:
        i = len(self.choices_taken)
        if i < len(self._preset):
            idx = self._preset[i]
            if idx >= n:
                idx = n - 1  # model drifted shorter than the recorded prefix
        elif self.policy == "first":
            idx = 0
        else:
            idx = self._rng.randrange(n)
        self.choices_taken.append(idx)
        self.enabled_counts.append(n)
        return idx

    def _step_thread(self, t: _Thread) -> None:
        self._control.clear()
        t.go.set()
        if not self._control.wait(timeout=_WALL_TIMEOUT_S):
            self._abort()
            raise LivelockError(
                f"model thread {t.name!r} did not yield within "
                f"{_WALL_TIMEOUT_S:.0f}s wall time (op {t.op!r}) — a model "
                "thread used an uninstrumented blocking primitive",
                schedule=self.choices_taken, seed=self.seed, trace=self.trace,
            )

    def _abort(self) -> None:
        self._killed = True
        for t in self._threads:
            t.go.set()
        for t in self._threads:
            if t.real is not None:
                t.real.join(timeout=_WALL_TIMEOUT_S)

    # -- driver --------------------------------------------------------------

    def run(self, check: "Optional[Callable[[], None]]" = None) -> "DeterministicScheduler":
        """Drive the model to completion; raises a typed
        :class:`SchedulingError` carrying the replayable schedule on deadlock,
        livelock, or invariant violation. ``check`` (if given) runs after all
        threads finish — its ``AssertionError`` is an invariant violation
        too."""
        if self._ran:
            raise RuntimeError("a DeterministicScheduler drives one run; build a new one")
        self._ran = True
        try:
            self._loop()
            if check is not None:
                try:
                    check()
                except AssertionError as exc:
                    raise InvariantViolation(
                        f"model {self.name!r} post-condition failed: {exc}",
                        schedule=self.choices_taken, seed=self.seed,
                        trace=self.trace,
                    ) from exc
        except SchedulingError as exc:
            self._report(failed=type(exc).__name__)
            raise
        self._report(failed=None)
        return self

    def _loop(self) -> None:
        steps = 0
        while True:
            alive = [t for t in self._threads if not t.done]
            if not alive:
                break
            enabled: List[_Thread] = []
            for t in alive:
                if t.pred is None or t.timed or t.pred():
                    enabled.append(t)
            if not enabled:
                waiting = ", ".join(f"{t.name}@{t.op}" for t in alive)
                self._abort()
                raise DeadlockError(
                    f"model {self.name!r} deadlocked: no runnable thread "
                    f"(blocked: {waiting})",
                    schedule=self.choices_taken, seed=self.seed, trace=self.trace,
                )
            if steps >= self.max_steps:
                self._abort()
                raise LivelockError(
                    f"model {self.name!r} exceeded {self.max_steps} steps",
                    schedule=self.choices_taken, seed=self.seed, trace=self.trace,
                )
            t = enabled[self._choose(len(enabled))]
            if t.pred is not None:
                t.wake_reason = "signal" if t.pred() else "timeout"
                t.pred = None
                t.timed = False
            self.trace.append(f"{steps}:{t.name}:{t.op}")
            self._step_thread(t)
            steps += 1
            failed = next((x for x in self._threads if x.exception is not None), None)
            if failed is not None:
                exc = failed.exception
                self._abort()
                if isinstance(exc, AssertionError):
                    raise InvariantViolation(
                        f"model {self.name!r} invariant failed in thread "
                        f"{failed.name!r}: {exc}",
                        schedule=self.choices_taken, seed=self.seed,
                        trace=self.trace,
                    ) from exc
                raise SchedulingError(
                    f"model {self.name!r} thread {failed.name!r} crashed: "
                    f"{type(exc).__name__}: {exc}",
                    schedule=self.choices_taken, seed=self.seed, trace=self.trace,
                ) from exc
        for t in self._threads:
            if t.real is not None:
                t.real.join(timeout=_WALL_TIMEOUT_S)

    def _report(self, failed: "Optional[str]") -> None:
        """Model-check results ride the telemetry plane: counters always,
        a ``modelcheck`` flight event naming the failing seed + schedule on
        failure (post-mortems can replay the exact interleaving)."""
        try:
            from pathway_tpu_torch.engine.telemetry import stage_add_many

            updates = {"modelcheck.runs": 1.0, "modelcheck.steps": float(len(self.trace))}
            if failed is not None:
                updates["modelcheck.failures"] = 1.0
            stage_add_many(updates)
            if failed is not None:
                from pathway_tpu_torch.engine.profile import get_flight_recorder

                get_flight_recorder().record_event(
                    "modelcheck",
                    model=self.name,
                    failure=failed,
                    seed=self.seed,
                    schedule=list(self.choices_taken),
                )
        except Exception:
            pass  # telemetry must never mask the model-check result


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------


class SchedLock:
    """Mutex under scheduler control (``with``-able, non-reentrant)."""

    def __init__(self, sched: DeterministicScheduler, name: str):
        self._sched = sched
        self.name = name
        self._owner: "Optional[_Thread]" = None

    def acquire(self) -> None:
        sched = self._sched
        t = sched.current()
        sched.yield_point(f"acquire({self.name})", pred=lambda: self._owner is None)
        self._owner = t

    def release(self) -> None:
        if self._owner is not self._sched.current():
            raise RuntimeError(f"release of {self.name} by non-owner")
        self._owner = None
        # a release is a decision point: who runs next decides who wins the lock
        self._sched.yield_point(f"release({self.name})")

    def held(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *_exc: Any) -> None:
        self.release()


class SchedCondition:
    """Condition variable bound to a :class:`SchedLock` (notify-all model).

    ``wait(timeout=None)`` is only woken by a notify; ``wait(timeout=x)`` is
    additionally always schedulable as a timeout wakeup — the model-level
    meaning of an abortable wait. Returns True for a signal, False for a
    timeout (the stdlib contract)."""

    def __init__(self, sched: DeterministicScheduler, lock: "Optional[SchedLock]", name: str):
        self._sched = sched
        self.name = name
        self.lock = lock if lock is not None else sched.lock(f"{name}.lock")
        self._gen = 0

    def wait(self, timeout: "Optional[float]" = None) -> bool:
        sched = self._sched
        t = sched.current()
        if self.lock._owner is not t:
            raise RuntimeError(f"wait on {self.name} without holding {self.lock.name}")
        my_gen = self._gen
        self.lock._owner = None  # release; the wait itself is the yield
        reason = sched.yield_point(
            f"wait({self.name})",
            pred=lambda: self._gen > my_gen,
            timed=timeout is not None,
        )
        sched.yield_point(
            f"reacquire({self.lock.name})", pred=lambda: self.lock._owner is None
        )
        self.lock._owner = t
        return reason == "signal"

    def notify_all(self) -> None:
        self._gen += 1
        self._sched.yield_point(f"notify_all({self.name})")

    notify = notify_all  # model simplification: wakeups are re-checked anyway

    def __enter__(self) -> "SchedCondition":
        self.lock.acquire()
        return self

    def __exit__(self, *_exc: Any) -> None:
        self.lock.release()


class SchedEvent:
    """One-shot flag with modeled-timeout waits."""

    def __init__(self, sched: DeterministicScheduler, name: str):
        self._sched = sched
        self.name = name
        self._flag = False

    def set(self) -> None:
        self._flag = True
        self._sched.yield_point(f"set({self.name})")

    def clear(self) -> None:
        self._flag = False

    def is_set(self) -> bool:
        return self._flag

    def wait(self, timeout: "Optional[float]" = None) -> bool:
        self._sched.yield_point(
            f"wait({self.name})",
            pred=lambda: self._flag,
            timed=timeout is not None,
        )
        return self._flag


# ---------------------------------------------------------------------------
# exploration drivers
# ---------------------------------------------------------------------------

#: a model: receives a fresh scheduler, spawns its threads against fresh
#: state, and returns an optional post-condition callable
Model = Callable[[DeterministicScheduler], "Optional[Callable[[], None]]"]


@dataclass
class ExploreResult:
    """Outcome of a bounded-exhaustive or seeded sweep."""

    schedules_run: int
    distinct_schedules: int
    failure: "Optional[SchedulingError]" = None
    failing_schedule: "Optional[List[int]]" = None
    failing_seed: "Optional[int]" = None
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.failure is None


def run_once(
    model: Model,
    *,
    seed: "Optional[int]" = None,
    choices: "Optional[Sequence[int]]" = None,
    policy: "Optional[str]" = None,
    max_steps: int = 20_000,
    name: str = "model",
) -> DeterministicScheduler:
    """One schedule: seeded random walk, or exact replay via ``choices``."""
    sched = DeterministicScheduler(
        seed=seed,
        choices=choices,
        policy=policy or ("first" if choices is not None else "rng"),
        max_steps=max_steps,
        name=name,
    )
    check = model(sched)
    sched.run(check=check)
    return sched


def explore(
    model: Model,
    *,
    max_schedules: int = 500,
    max_steps: int = 20_000,
    name: str = "model",
) -> ExploreResult:
    """Bounded-exhaustive DFS over the decision tree (stateless model
    checking): re-run the model with a growing choice prefix, backtracking at
    the deepest decision with an untried branch. Every schedule differs in at
    least one decision. Stops at the first failure (replayable via
    ``failing_schedule``) or after ``max_schedules``."""
    prefix: List[int] = []
    distinct: "set[Tuple[int, ...]]" = set()
    runs = 0
    while runs < max_schedules:
        sched = DeterministicScheduler(
            choices=prefix, policy="first", max_steps=max_steps, name=name
        )
        try:
            check = model(sched)
            sched.run(check=check)
        except SchedulingError as exc:
            distinct.add(tuple(sched.choices_taken))
            return ExploreResult(
                schedules_run=runs + 1,
                distinct_schedules=len(distinct),
                failure=exc,
                failing_schedule=list(exc.schedule),
                failing_seed=sched.seed,
            )
        runs += 1
        distinct.add(tuple(sched.choices_taken))
        taken, counts = sched.choices_taken, sched.enabled_counts
        i = len(taken) - 1
        while i >= 0 and taken[i] + 1 >= counts[i]:
            i -= 1
        if i < 0:
            break  # decision tree exhausted below the bound
        prefix = taken[:i] + [taken[i] + 1]
    return ExploreResult(schedules_run=runs, distinct_schedules=len(distinct))


def sweep_seeds(
    model: Model,
    *,
    seeds: "Optional[Sequence[int]]" = None,
    n_seeds: int = 200,
    base_seed: "Optional[int]" = None,
    max_steps: int = 20_000,
    name: str = "model",
) -> ExploreResult:
    """Seeded random-walk sweep: ``n_seeds`` independent walks (base_seed +
    i). Complements :func:`explore` — DFS is systematic near the root, seeded
    walks spread over the whole depth. Stops at the first failure with its
    seed recorded for replay."""
    if seeds is None:
        base = default_seed() if base_seed is None else base_seed
        seeds = [base + i for i in range(n_seeds)]
    distinct: "set[Tuple[int, ...]]" = set()
    runs = 0
    for seed in seeds:
        sched = DeterministicScheduler(seed=seed, policy="rng", max_steps=max_steps, name=name)
        try:
            check = model(sched)
            sched.run(check=check)
        except SchedulingError as exc:
            distinct.add(tuple(sched.choices_taken))
            return ExploreResult(
                schedules_run=runs + 1,
                distinct_schedules=len(distinct),
                failure=exc,
                failing_schedule=list(exc.schedule),
                failing_seed=seed,
            )
        runs += 1
        distinct.add(tuple(sched.choices_taken))
    return ExploreResult(schedules_run=runs, distinct_schedules=len(distinct))
