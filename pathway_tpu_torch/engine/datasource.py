"""Input sources feeding the commit loop (port of ``pathway_tpu/engine/datasource.py``).

``StaticDataSource`` emits all its rows at the first commit;
``StreamingDataSource`` is fed by a producer thread (a connector subject)
through a queue, drained once per commit. Host-side by design: rows arrive
on the host and batch into columns before any device work.

Under persistence every source reports its resumable position
(``offset_state``), journaled with each commit, and is put back there on
resume (``restore``). A streaming producer brackets each replayable segment
(a file) with ``push_begin(token, fingerprint)`` and ``push_state(delta)``:
after a crash inside a segment, its re-push is skipped event by event when
the fingerprint is unchanged, and its journaled rows are retracted first
when it changed (or when a full scan pass, ``push_barrier``, no longer has
it).
"""

from __future__ import annotations

import queue
import threading
import time as time_mod
from typing import Any, Dict, List

import numpy as np

from pathway_tpu_torch.engine.columnar import Delta
from pathway_tpu_torch.internals.keys import KEY_DTYPE, Pointer, keys_from_rows, sequential_keys


class DataSource:
    """One input's event feed; ``next_batch`` is called once per commit."""

    def next_batch(self, column_names: List[str]) -> Delta:
        raise NotImplementedError

    def is_finished(self) -> bool:
        raise NotImplementedError

    def on_start(self) -> None:
        pass

    def wait_hint(self, now: float) -> float | None:
        """Seconds until this source may release rows without a producer
        push (0: at the next commit), or None when only a push can make it
        release (the push wakes the commit loop)."""
        return None if self.is_finished() else 0.0

    # -- persistence ---------------------------------------------------------

    def offset_state(self) -> dict:
        """The light resumable position, and this commit's segment-state
        deltas, journaled with every commit."""
        return {}

    def checkpoint_state_deltas(self) -> list | None:
        """The drained segment markers, for an operator checkpoint (compaction
        drops the journal frames that carried them)."""
        return None

    def restore(self, offset: dict, state_deltas: list, tail: dict | None) -> None:
        """Reposition so that journaled events are not emitted again after
        the replay. ``state_deltas``: every segment marker journaled so far,
        in order, which the subject folds back into its scan state. ``tail``:
        the segment the crash cut, ``{"token", "fp", "count", "rows",
        "covered", "has_markers"}``, ``rows`` being the journaled ``(key,
        values, diff)`` events no marker covers. When that segment arrives
        again, the source skips its ``count`` re-pushed events (fingerprint
        unchanged) or retracts ``rows`` first (the segment changed)."""


class StaticDataSource(DataSource):
    """All rows present at time 0 (batch mode)."""

    def __init__(
        self,
        rows: List[Any],
        keys: np.ndarray | None = None,
        column_names: List[str] | None = None,
        columns: Dict[str, np.ndarray] | None = None,
    ):
        # rows: list of dicts column->value OR tuples following column_names;
        # columns: pre-columnarized arrays built at graph construction (off the
        # run clock), taking precedence over rows
        self._rows = rows
        self._keys = keys
        self._column_names = column_names
        self._columns = columns
        self._done = False

    def on_start(self) -> None:
        # a fresh GraphRunner re-runs the whole graph (debug captures, repeated
        # pw.run), unless a persistence restore marked the rows as replayed: a
        # one-shot flag, so a later run without persistence emits them again
        if getattr(self, "_restored_done", False):
            self._restored_done = False
        else:
            self._done = False

    def offset_state(self) -> dict:
        return {"done": self._done}

    def restore(self, offset: dict, state_deltas: list, tail: dict | None) -> None:
        # the replayed journal carries the rows: do not emit them again
        if offset.get("done"):
            self._done = True
            self._restored_done = True

    def next_batch(self, column_names: List[str]) -> Delta:
        if self._done:
            return Delta.empty(column_names)
        self._done = True
        n = len(self._rows)
        columns: Dict[str, np.ndarray] = {}
        for name in column_names:
            if self._columns is not None and name in self._columns:
                columns[name] = self._columns[name]
                continue
            col = np.empty(n, dtype=object)
            for i, row in enumerate(self._rows):
                col[i] = row[name] if isinstance(row, dict) else row[self._column_names.index(name)]
            columns[name] = _tidy_col(col)
        keys = sequential_keys(0, n) if self._keys is None else self._keys
        return Delta(keys, np.ones(n, dtype=np.int64), columns)

    def is_finished(self) -> bool:
        return self._done


class PrimaryKey(tuple):
    """A row's primary-key values, hashed into its key when the batch is
    drained (``keys_from_rows``, one numpy pass per batch) instead of one
    hash per pushed row."""


class StreamingDataSource(DataSource):
    """Queue-fed source; a producer thread pushes (key, row, diff) events.

    The commit loop wakes on a per-runner event when any producer pushes (with
    explicit commits: when it commits or closes). ``autocommit_ms`` is the
    commit tick: a source releases its queued events
    at most once per window, so steady streams coalesce into window-sized
    batches. With ``autocommit_ms=None`` rows are released only at the
    producer's ``commit()`` markers (and when it closes), so each batch is
    exactly what the producer committed.
    """

    _MAX_EVENTS_PER_COMMIT = 100_000  # the reference drains <=100k entries/iteration

    # per-runner events: a producer push wakes EVERY registered commit loop
    # (each clears only its own event)
    _RUNNER_EVENTS: "list[threading.Event]" = []
    _REG_LOCK = threading.Lock()

    @classmethod
    def register_runner(cls, event: "threading.Event") -> None:
        with cls._REG_LOCK:
            cls._RUNNER_EVENTS.append(event)

    @classmethod
    def unregister_runner(cls, event: "threading.Event") -> None:
        with cls._REG_LOCK:
            if event in cls._RUNNER_EVENTS:
                cls._RUNNER_EVENTS.remove(event)

    @classmethod
    def _wake_all(cls) -> None:
        for ev in list(cls._RUNNER_EVENTS):
            ev.set()

    def __init__(
        self, subject: Any = None, autocommit_ms: float | None = 10, loopback: bool = False
    ):
        self.events: "queue.Queue[tuple]" = queue.Queue()
        self._finished = threading.Event()
        self._started = False
        self.subject = subject
        # a loop-back source (AsyncTransformer) is fed by results of its own
        # graph: it does not gate the primary end of input (the run loop
        # tells subscribers of the end once the other sources drained), and
        # it is finished only once closed
        self.loopback = loopback
        self._thread: threading.Thread | None = None
        self._autocommit_ms = autocommit_ms
        self._seq = 0
        self._next_commit_at = 0.0
        self._held: List[tuple] = []  # rows drained but not yet committed
        # persistence: events consumed so far (journaled ones count on
        # resume); re-pushed events are skipped by segment-scoped counts
        self._consumed = 0
        self._skip = 0
        # segment bookkeeping; the markers ride the event queue, so each is
        # ordered after exactly the events it accounts for
        self._in_progress: dict | None = None  # {"token", "fp", "emitted"}
        self._frame_state_deltas: List[Any] = []  # drained this commit
        self._drained_state_deltas: List[Any] = []  # every drained marker
        # armed by restore when the crash cut a segment
        self._pending_resume: dict | None = None
        # (consumed, in-progress segment) as of the last release: rows held
        # for an explicit commit are not journaled yet, so they do not count
        self._released: tuple = (0, None)

    # producer API ----------------------------------------------------------

    def push(self, values: dict, key: Pointer | PrimaryKey | None = None, diff: int = 1) -> None:
        self.events.put(("data", key, values, diff))
        if self._autocommit_ms is not None:
            # with explicit commits a row cannot release before its commit
            # marker, whose push wakes the loop: a wake per row would only
            # run an idle commit per row while the producer pushes
            StreamingDataSource._wake_all()

    def commit(self) -> None:
        """End the current batch: the rows pushed so far form one commit."""
        self.events.put(("commit",))
        StreamingDataSource._wake_all()

    def push_begin(self, token: Any, fingerprint: Any) -> None:
        """Start a replayable segment (a file): ``token`` names it, and
        ``fingerprint`` changes if and only if a re-push of the segment would
        give other events."""
        self.events.put(("begin", token, fingerprint))

    def push_state(self, state_delta: Any) -> None:
        """Close the segment just pushed with its state delta, journaled with
        the commit; on resume the deltas are folded back through
        ``subject.restore``. It ends the batch, as ``commit`` does, so
        journal frames align with segment boundaries."""
        self.events.put(("state", state_delta))
        StreamingDataSource._wake_all()

    def push_barrier(self) -> None:
        """One full scan pass is done: a segment the crash cut that has not
        arrived again is gone, and its journaled events are retracted."""
        self.events.put(("barrier",))
        StreamingDataSource._wake_all()

    def close(self) -> None:
        self.events.put(("eof",))
        StreamingDataSource._wake_all()

    # engine API ------------------------------------------------------------

    def on_start(self) -> None:
        if self.subject is not None and not self._started:
            self._started = True

            def runner() -> None:
                # a connector-thread failure surfaces in the engine loop
                try:
                    self.subject.run(self)
                except BaseException as exc:  # noqa: BLE001
                    self.events.put(("error", exc))
                finally:
                    self.close()

            self._thread = threading.Thread(target=runner, daemon=True, name="pathway:connector")
            self._thread.start()

    def _drain(self) -> List[tuple]:
        """Take the rows this commit releases off the queue."""
        explicit = self._autocommit_ms is None
        rows = self._held if explicit else []
        self._held = []
        self._frame_state_deltas = []
        now = time_mod.monotonic()
        if (
            not explicit
            and now < self._next_commit_at
            and not self._finished.is_set()
            and self.events.qsize() < self._MAX_EVENTS_PER_COMMIT
        ):
            # inside the autocommit window: let events coalesce
            return []
        deadline = now + (self._autocommit_ms or 10) / 1000.0
        while explicit or len(rows) < self._MAX_EVENTS_PER_COMMIT:
            try:
                event = self.events.get_nowait()
            except queue.Empty:
                if explicit:
                    self._held = rows  # not committed yet
                    return []
                break
            if event[0] == "eof":
                self._finished.set()
                break
            if event[0] == "error":
                self._finished.set()
                raise event[1]
            if event[0] == "commit":
                break
            if event[0] == "begin":
                self._begin_segment(event[1], event[2], rows)
                continue
            if event[0] == "state":
                self._end_segment(event[1])
                break
            if event[0] == "barrier":
                pending, self._pending_resume = self._pending_resume, None
                if pending is not None:
                    # the segment the crash cut never came back (deleted)
                    rows.extend((key, values, -diff) for key, values, diff in pending["rows"])
                    self._consumed += len(pending["rows"])
                continue
            if self._skip > 0:
                self._skip -= 1
                continue
            _, key, values, diff = event
            self._consumed += 1
            if self._in_progress is not None:
                self._in_progress["emitted"] += 1
            rows.append((key, values, diff))
            if not explicit and rows and time_mod.monotonic() > deadline:
                break
        if rows and not explicit:
            self._next_commit_at = time_mod.monotonic() + (self._autocommit_ms or 10) / 1000.0
        in_progress = self._in_progress
        self._released = (self._consumed, None if in_progress is None else dict(in_progress))
        return rows

    def _begin_segment(self, token: Any, fp: Any, rows: List[tuple]) -> None:
        self._in_progress = {"token": token, "fp": fp, "emitted": 0}
        pending = self._pending_resume
        if pending is None or token != pending["token"]:
            return
        self._pending_resume = None
        if fp == pending["fp"]:
            # unchanged: the re-push repeats the journaled events. ``emitted``
            # goes on from the journaled count, so a second crash before the
            # marker journals the whole skip width
            self._skip += pending["count"]
            self._in_progress["emitted"] = pending["count"]
        else:
            # the segment changed while the pipeline was down: undo its
            # journaled events first
            rows.extend((key, values, -diff) for key, values, diff in pending["rows"])
            self._consumed += len(pending["rows"])

    def _end_segment(self, delta: Any) -> None:
        self._in_progress = None
        self._frame_state_deltas.append(delta)
        self._drained_state_deltas.append(delta)
        if len(self._drained_state_deltas) > 256:
            fold = getattr(self.subject, "fold_state_deltas", None)
            if fold is not None:
                # lossless: memory stays bounded by the live state even when
                # checkpoints are off
                self._drained_state_deltas = list(fold(self._drained_state_deltas))

    def next_batch(self, column_names: List[str]) -> Delta:
        rows = self._drain()
        if not rows:
            return Delta.empty(column_names)
        n = len(rows)
        keys = np.empty(n, dtype=KEY_DTYPE)
        auto = [i for i, r in enumerate(rows) if r[0] is None]
        if auto:
            keys[auto] = sequential_keys(self._seq, len(auto))
            self._seq += len(auto)
        pk = [i for i, r in enumerate(rows) if isinstance(r[0], PrimaryKey)]
        if pk:
            keys[pk] = keys_from_rows([rows[i][0] for i in pk])
        for i, (key, _values, _diff) in enumerate(rows):
            if isinstance(key, Pointer):
                keys[i]["hi"], keys[i]["lo"] = key.hi, key.lo
        diffs = np.array([r[2] for r in rows], dtype=np.int64)
        columns = {}
        for name in column_names:
            col = np.empty(n, dtype=object)
            for i, (_, values, _) in enumerate(rows):
                col[i] = values.get(name)
            columns[name] = _tidy_col(col)
        return Delta(keys, diffs, columns)

    def is_finished(self) -> bool:
        return self._finished.is_set() and self.events.empty() and not self._held

    # -- persistence ---------------------------------------------------------

    def checkpoint_state_deltas(self) -> list | None:
        if not self._drained_state_deltas:
            return None
        fold = getattr(self.subject, "fold_state_deltas", None)
        if fold is None:
            return list(self._drained_state_deltas)
        # lossless: the history is pruned to the live state
        folded = self._drained_state_deltas = list(fold(self._drained_state_deltas))
        # a journal frame's marker is slim (the frame holds the rows); a
        # checkpoint outlives its frames, so its markers carry their rows
        hydrate = getattr(self.subject, "hydrate_state_deltas", None)
        return hydrate(folded) if hydrate is not None else folded

    def offset_state(self) -> dict:
        consumed, in_progress = self._released
        out: dict = {"consumed": consumed, "seq": self._seq}
        if self._frame_state_deltas:
            out["state_deltas"] = list(self._frame_state_deltas)
        if in_progress is not None:
            out["in_progress"] = in_progress
        return out

    def restore(self, offset: dict, state_deltas: list, tail: dict | None) -> None:
        self._seq = offset.get("seq", 0)
        consumed = offset.get("consumed", 0)
        self._consumed = consumed
        self._released = (consumed, None)
        self._drained_state_deltas = list(state_deltas)
        sub_restore = getattr(self.subject, "restore", None)
        if sub_restore is not None and state_deltas:
            sub_restore(state_deltas)
        if tail is None:
            return
        if tail.get("token") is not None:
            # a segment-aware subject: skip or undo when the segment arrives
            # again (or, at a barrier, when it provably does not)
            self._pending_resume = tail
        elif tail.get("has_markers"):
            # no segment in flight at the crash: the finished segments are
            # not pushed again (the folded state skips them)
            self._skip = max(consumed - tail.get("covered", 0), 0)
        else:
            # a subject without markers pushes its whole history again
            self._skip = consumed

    def wait_hint(self, now: float) -> float | None:
        # queued events held back by the autocommit window release when it
        # ends; with explicit commits, held rows wait for the commit's push
        if self._autocommit_ms is None or self.events.empty():
            return None
        return max(0.0, self._next_commit_at - now)


def _tidy_col(col: np.ndarray) -> np.ndarray:
    from pathway_tpu_torch.engine.expression_evaluator import _tidy

    return _tidy(col)
