"""Input sources feeding the commit loop (port of ``pathway_tpu/engine/datasource.py``).

``StaticDataSource`` emits all its rows at the first commit;
``StreamingDataSource`` is fed by a producer thread (a connector subject)
through a queue, drained once per commit. Host-side by design: rows arrive
on the host and batch into columns before any device work.
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
        # a fresh GraphRunner re-runs the whole graph (debug captures, repeated pw.run)
        self._done = False

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
            _, key, values, diff = event
            rows.append((key, values, diff))
            if not explicit and rows and time_mod.monotonic() > deadline:
                break
        if rows and not explicit:
            self._next_commit_at = time_mod.monotonic() + (self._autocommit_ms or 10) / 1000.0
        return rows

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

    def wait_hint(self, now: float) -> float | None:
        # queued events held back by the autocommit window release when it
        # ends; with explicit commits, held rows wait for the commit's push
        if self._autocommit_ms is None or self.events.empty():
            return None
        return max(0.0, self._next_commit_at - now)


def _tidy_col(col: np.ndarray) -> np.ndarray:
    from pathway_tpu_torch.engine.expression_evaluator import _tidy

    return _tidy(col)
