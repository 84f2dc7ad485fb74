"""``pw.AsyncTransformer`` (port of ``pathway_tpu/stdlib/utils/async_transformer.py``).

Each input row is handed to ``async def invoke(self, **row)`` on a worker
event loop of its own thread, so an invocation never blocks the commit that
carried its row. Results come back into the same graph through a loop-back
streaming source (``StreamingDataSource(loopback=True)``) as the
``output_table``, keyed by the input row's key: a new result for a key
upserts the old one, and a removed input row retracts its result.

Statuses: ``successful`` (the rows whose ``invoke`` returned), ``failed``
(the rows that raised, and with ``instance`` every row of an (instance,
time) group in which one row failed), ``finished`` / ``output_table`` (both
with ``_async_status``). An (instance, time) group is released atomically,
in time order per instance, once every invocation of the group completed
and its commit was wholly delivered. ``with_options`` puts capacity,
timeout, retries and a cache around ``invoke`` (``internals/udfs.wrap_async``).

The loop-back source closes once the input's subscriber heard the end and
the last invocation finished; the run loop then tells the subscribers below
it that the stream ended, and a transformer fed by this one closes in turn.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, Optional

from pathway_tpu_torch.engine.datasource import StreamingDataSource
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.keys import keys_to_pointers
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io._utils import columns_to_pylists

_ASYNC_STATUS_COLUMN = "_async_status"
_SUCCESS = "-SUCCESS-"
_FAILURE = "-FAILURE-"
_INSTANCE_NAME = "_pw_instance"


@dataclass(frozen=True)
class _Entry:
    key: Any
    time: int
    seq: int
    is_addition: bool


@dataclass
class _Instance:
    pending: collections.deque = field(default_factory=collections.deque)
    finished: Dict[_Entry, Any] = field(default_factory=dict)
    buffer: list = field(default_factory=list)
    buffer_time: Optional[int] = None
    correct: bool = True


class AsyncTransformer:
    """Subclass with ``output_schema`` (a class keyword or attribute) and
    ``async def invoke(self, **row) -> dict`` returning the output columns."""

    output_schema: ClassVar[Any] = None

    def __init_subclass__(cls, /, output_schema: Any = None, **kwargs: Any):
        super().__init_subclass__(**kwargs)
        if output_schema is not None:
            cls.output_schema = output_schema

    def __init__(
        self,
        input_table: Table,
        *,
        instance: Any = None,
        autocommit_duration_ms: int | None = 100,
        **kwargs: Any,
    ):
        """``instance``: an expression over the input whose value groups rows
        (None: every row is its own group). ``autocommit_duration_ms``: the
        loop-back source's commit tick; with None each released group enters
        the graph as one commit."""
        assert self.output_schema is not None, "define output_schema"
        self._input_table = input_table
        self._instance_expr = instance
        self._autocommit_ms = autocommit_duration_ms
        self._options: Dict[str, Any] = {}
        self._built: Optional[Table] = None

    async def invoke(self, **kwargs: Any) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    def open(self) -> None:
        """Called once when the output table is built, before any invocation."""

    def close(self) -> None:
        """Called once after the last invocation finished."""

    def with_options(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
    ) -> "AsyncTransformer":
        self._options = {
            "capacity": capacity,
            "timeout": timeout,
            "retry_strategy": retry_strategy,
            "cache_strategy": cache_strategy,
        }
        return self

    # -- result tables -------------------------------------------------------

    @property
    def output_table(self) -> Table:
        """Every row whose invocation finished, with ``_async_status``."""
        if self._built is None:
            self._built = self._build()
        return self._built

    @property
    def successful(self) -> Table:
        out = self.output_table
        result = out.filter(out[_ASYNC_STATUS_COLUMN] == _SUCCESS).without(_ASYNC_STATUS_COLUMN)
        result._schema = self.output_schema
        return result

    @property
    def failed(self) -> Table:
        out = self.output_table
        return out.filter(out[_ASYNC_STATUS_COLUMN] == _FAILURE).without(_ASYNC_STATUS_COLUMN)

    @property
    def finished(self) -> Table:
        return self.output_table

    @property
    def result(self) -> Table:
        return self.successful

    # -- machinery -----------------------------------------------------------

    def _apply_options(self, fn: Any) -> Any:
        if not any(v is not None for v in self._options.values()):
            return fn
        from pathway_tpu_torch.internals.udfs import wrap_async

        return wrap_async(fn, name=type(self).__name__, **self._options)

    def _build(self) -> Table:
        input_table = self._input_table
        if self._instance_expr is not None:
            inst_e = self._instance_expr
            if not isinstance(inst_e, expr.ColumnExpression):
                inst_e = expr.ColumnConstExpression(inst_e)
            input_table = input_table.with_columns(**{_INSTANCE_NAME: inst_e})
        names = [n for n in input_table.column_names() if n != _INSTANCE_NAME]
        out_names = list(self.output_schema.column_names())
        self.open()
        invoke = self._apply_options(self.invoke)
        explicit = self._autocommit_ms is None
        source = StreamingDataSource(autocommit_ms=self._autocommit_ms, loopback=True)
        emitted: Dict[Any, dict] = {}  # input key -> the row last pushed for it

        loop = asyncio.new_event_loop()
        threading.Thread(
            target=loop.run_forever, daemon=True, name="pathway:async-transformer"
        ).start()
        seq = itertools.count(1)  # arrival order, numbered on the engine's thread
        # the state below is read and written on the loop's thread only
        instances: Dict[Any, _Instance] = {}
        inflight: set = set()
        ended = [False]
        closed_time = [-1]  # the newest time whose commit was wholly delivered

        def push(key: Any, row: Optional[dict]) -> None:
            old = emitted.pop(key, None)
            if old is not None:
                source.push(old, key=key, diff=-1)
            if row is not None:
                source.push(row, key=key, diff=1)
                emitted[key] = row

        def flush_buffer(inst: _Instance) -> None:
            for key, is_addition, result in inst.buffer:
                if not is_addition:
                    push(key, None)
                elif inst.correct:
                    push(key, {**result, _ASYNC_STATUS_COLUMN: _SUCCESS})
                else:  # one failure poisons the whole (instance, time) group
                    push(key, {**{n: None for n in out_names}, _ASYNC_STATUS_COLUMN: _FAILURE})
            if inst.buffer and explicit:
                source.commit()
            inst.buffer.clear()

        def maybe_produce(instance_key: Any) -> None:
            inst = instances.get(instance_key)
            if inst is None:
                return
            while inst.pending:
                entry = inst.pending[0]
                if entry.time > closed_time[0] or entry not in inst.finished:
                    # its commit is still delivering, or its invocation runs
                    break
                inst.pending.popleft()
                result = inst.finished.pop(entry)
                if inst.buffer_time != entry.time:
                    if inst.buffer:
                        flush_buffer(inst)
                        inst.correct = True
                    inst.buffer_time = entry.time
                if entry.is_addition and result is None:
                    inst.correct = False
                inst.buffer.append((entry.key, entry.is_addition, result))
            if not inst.pending:
                flush_buffer(inst)
                del instances[instance_key]
            elif inst.buffer and inst.pending[0].time != inst.buffer_time:
                # the (instance, time) group completed while later times wait
                flush_buffer(inst)
                inst.correct = True

        def maybe_close() -> None:
            if ended[0] and not inflight and not instances:
                self.close()
                source.close()
                loop.stop()

        def task_done(instance_key: Any, entry: _Entry, result: Any) -> None:
            inflight.discard(entry)
            inst = instances.get(instance_key)
            if inst is not None:
                inst.finished[entry] = result
            maybe_produce(instance_key)
            maybe_close()

        async def run_one(instance_key: Any, entry: _Entry, values: dict) -> None:
            try:
                result = await invoke(**values)
                if set(result.keys()) != set(out_names):
                    raise ValueError("result of async function does not match output_schema")
            except Exception:
                result = None
            task_done(instance_key, entry, result)

        def register(batch: list) -> None:
            for instance_key, entry, values in batch:
                instances.setdefault(instance_key, _Instance()).pending.append(entry)
                inflight.add(entry)
                if values is None:
                    task_done(instance_key, entry, None)
                else:
                    loop.create_task(run_one(instance_key, entry, values))

        def on_batch(keys: Any, diffs: Any, columns: dict, time: int) -> None:
            # one hand-over to the loop per commit; registration and
            # completion both run on the loop's thread, in arrival order, so
            # a fast invocation cannot release its group before a sibling of
            # the same commit registered
            cols = columns_to_pylists(columns, list(columns))
            instance_col = cols[_INSTANCE_NAME] if self._instance_expr is not None else None
            batch = []
            for i, (key, is_addition) in enumerate(
                zip(keys_to_pointers(keys), (diffs > 0).tolist())
            ):
                entry = _Entry(key, time, next(seq), is_addition)
                values = {n: cols[n][i] for n in names} if is_addition else None
                batch.append((key if instance_col is None else instance_col[i], entry, values))
            loop.call_soon_threadsafe(register, batch)

        def on_time_end(time: int) -> None:
            def mark() -> None:
                closed_time[0] = max(closed_time[0], time)
                for instance_key in list(instances):
                    maybe_produce(instance_key)
                maybe_close()

            loop.call_soon_threadsafe(mark)

        def on_end() -> None:
            def finish() -> None:
                ended[0] = True
                maybe_close()

            loop.call_soon_threadsafe(finish)

        subscribe(input_table, on_batch=on_batch, on_end=on_end, on_time_end=on_time_end)

        out_schema = sch.schema_from_columns(
            {
                **{
                    n: sch.ColumnSchema(n, dt.Optional_(c.dtype))
                    for n, c in self.output_schema.columns().items()
                },
                _ASYNC_STATUS_COLUMN: sch.ColumnSchema(_ASYNC_STATUS_COLUMN, dt.STR),
            },
            name="async_transformer",
        )
        node = G.add_node(pg.InputNode(source=source, streaming=True, name="async-transformer"))
        return Table(node, out_schema, name="async_transformer")
