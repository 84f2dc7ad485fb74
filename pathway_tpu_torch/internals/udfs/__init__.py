"""UDF system (port of ``pathway_tpu/internals/udfs/__init__.py``).

``pw.udf`` and the ``UDF`` base class that parsers, splitters, embedders,
chats and rerankers derive from, with the reference's executors, retry
strategies and caches. The engine batches UDF calls column-wise; a UDF whose
``deterministic`` flag is False has its value memoized per row and replayed
on the row's retraction. An async UDF (a coroutine function, or any function
under an async executor) becomes an ``AsyncApplyExpression``: a commit's
rows are awaited together, under the executor's capacity, the retry
strategy and the cache.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import pickle
import random
import threading
import weakref
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr


# -- retries ----------------------------------------------------------------


class AsyncRetryStrategy:
    async def invoke(self, fun: Callable, /, *args: Any, **kwargs: Any) -> Any:
        return await fun(*args, **kwargs)


class NoRetryStrategy(AsyncRetryStrategy):
    pass


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    """Up to ``max_retries`` retries; the n-th waits ``initial_delay`` ms
    times ``backoff_factor ** n`` plus up to ``jitter_ms`` ms."""

    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1000,
        backoff_factor: float = 2,
        jitter_ms: int = 300,
    ):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000

    async def invoke(self, fun: Callable, /, *args: Any, **kwargs: Any) -> Any:
        delay = self.initial_delay
        for attempt in range(self.max_retries + 1):
            try:
                return await fun(*args, **kwargs)
            except Exception:
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(delay + random.random() * self.jitter)
                delay *= self.backoff_factor
        raise RuntimeError("unreachable")


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        super().__init__(
            max_retries=max_retries, initial_delay=delay_ms, backoff_factor=1, jitter_ms=0
        )


# -- caches -----------------------------------------------------------------


class CacheStrategy:
    """``get`` raises ``KeyError`` on a miss."""

    def get(self, key: str) -> Any:
        raise KeyError(key)

    def set(self, key: str, value: Any) -> None:
        pass


class InMemoryCache(CacheStrategy):
    def __init__(self) -> None:
        self._data: dict[str, Any] = {}

    def get(self, key: str) -> Any:
        return self._data[key]

    def set(self, key: str, value: Any) -> None:
        self._data[key] = value


class DiskCache(CacheStrategy):
    """A persistent cache in an SQLite file ``udf-cache-<name>.db`` under
    ``directory`` (default ``PATHWAY_PERSISTENT_STORAGE``, else
    ``/tmp/pathway-cache``), values pickled."""

    def __init__(self, name: str | None = None, directory: str | None = None):
        import os
        import sqlite3

        directory = directory or os.environ.get("PATHWAY_PERSISTENT_STORAGE", "/tmp/pathway-cache")
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, f"udf-cache-{name or 'default'}.db")
        self._conn = sqlite3.connect(self._path, check_same_thread=False)
        self._conn.execute("CREATE TABLE IF NOT EXISTS cache (k TEXT PRIMARY KEY, v BLOB)")
        self._lock = threading.Lock()

    def get(self, key: str) -> Any:
        with self._lock:
            row = self._conn.execute("SELECT v FROM cache WHERE k=?", (key,)).fetchone()
        if row is None:
            raise KeyError(key)
        return pickle.loads(row[0])

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO cache VALUES (?, ?)", (key, pickle.dumps(value))
            )
            self._conn.commit()


DefaultCache = DiskCache


def _cache_key(name: str, args: tuple, kwargs: dict) -> str:
    payload = pickle.dumps((name, args, sorted(kwargs.items())))
    return hashlib.sha256(payload).hexdigest()


def _with_retries(fun: Callable, strategy: AsyncRetryStrategy) -> Callable:
    async def with_retries(*args: Any, **kwargs: Any) -> Any:
        return await strategy.invoke(fun, *args, **kwargs)

    return with_retries


def _with_capacity(fun: Callable, capacity: int) -> Callable:
    """At most ``capacity`` calls in flight. Each commit awaits its rows on
    a loop of its own, and a semaphore that ever waited is bound to its
    loop, so there is one semaphore per running loop (the reference keeps
    one, which raises ``RuntimeError`` in the next commit that waits)."""
    semaphores: "weakref.WeakKeyDictionary[Any, asyncio.Semaphore]" = weakref.WeakKeyDictionary()

    async def with_capacity(*args: Any, **kwargs: Any) -> Any:
        loop = asyncio.get_running_loop()
        semaphore = semaphores.get(loop)
        if semaphore is None:
            semaphore = semaphores[loop] = asyncio.Semaphore(capacity)
        async with semaphore:
            return await fun(*args, **kwargs)

    return with_capacity


def _with_cache(fun: Callable, cache: CacheStrategy, name: str, is_async: bool) -> Callable:
    if is_async:

        async def cached(*args: Any, **kwargs: Any) -> Any:
            key = _cache_key(name, args, kwargs)
            try:
                return cache.get(key)
            except KeyError:
                value = await fun(*args, **kwargs)
                cache.set(key, value)
                return value

        return cached

    def cached_sync(*args: Any, **kwargs: Any) -> Any:
        key = _cache_key(name, args, kwargs)
        try:
            return cache.get(key)
        except KeyError:
            value = fun(*args, **kwargs)
            cache.set(key, value)
            return value

    return cached_sync


def wrap_async(
    fun: Callable,
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: "AsyncRetryStrategy | None" = None,
    cache_strategy: "CacheStrategy | None" = None,
    name: str = "async_fn",
) -> Callable:
    """Timeout, then retries, then capacity, then the cache, around an
    async callable."""
    if timeout is not None:
        inner = fun

        async def with_timeout(*args: Any, **kwargs: Any) -> Any:
            return await asyncio.wait_for(inner(*args, **kwargs), timeout=timeout)

        fun = with_timeout
    if retry_strategy is not None:
        fun = _with_retries(fun, retry_strategy)
    if capacity:
        fun = _with_capacity(fun, capacity)
    if cache_strategy is not None:
        fun = _with_cache(fun, cache_strategy, name, True)
    return fun


# -- executors --------------------------------------------------------------


class Executor:
    pass


class AutoExecutor(Executor):
    pass


class SyncExecutor(Executor):
    pass


class AsyncExecutor(Executor):
    def __init__(self, capacity: int | None = None, timeout: float | None = None):
        self.capacity = capacity
        self.timeout = timeout


class FullyAsyncExecutor(AsyncExecutor):
    def __init__(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        autocommit_duration_ms: int | None = 100,
    ):
        super().__init__(capacity, timeout)
        self.autocommit_duration_ms = autocommit_duration_ms


def auto_executor() -> AutoExecutor:
    return AutoExecutor()


def sync_executor() -> SyncExecutor:
    return SyncExecutor()


def async_executor(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> AsyncExecutor:
    ex = AsyncExecutor(capacity, timeout)
    ex.retry_strategy = retry_strategy  # type: ignore[attr-defined]
    return ex


def fully_async_executor(
    capacity: int | None = None,
    timeout: float | None = None,
    autocommit_duration_ms: int | None = 100,
) -> FullyAsyncExecutor:
    return FullyAsyncExecutor(capacity, timeout, autocommit_duration_ms)


# -- the UDF class ----------------------------------------------------------


class UDF:
    """Base class for user-defined functions; also produced by ``@pw.udf``.

    Subclasses set ``self.func`` (or define ``__wrapped__``), synchronous or
    a coroutine function."""

    def __init__(
        self,
        *,
        return_type: Any = None,
        propagate_none: bool = False,
        deterministic: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        max_batch_size: int | None = None,
    ):
        self.return_type = return_type
        self.propagate_none = propagate_none
        self.deterministic = deterministic
        self.executor = executor or AutoExecutor()
        self.cache_strategy = cache_strategy
        self.retry_strategy = retry_strategy or getattr(executor, "retry_strategy", None)
        self.max_batch_size = max_batch_size
        self.func: Callable | None = getattr(self, "__wrapped__", None)

    def _resolved_return_type(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        fun = self.func
        if fun is not None:
            try:
                import typing

                hints = typing.get_type_hints(fun)
            except Exception:
                hints = getattr(fun, "__annotations__", {})
            if hints and "return" in hints:
                return hints["return"]
        return Any

    def _wrapped_fun(self) -> tuple[Callable, bool]:
        """The function the engine calls and whether it is async: a sync
        function under an async executor is made async; an async one gets
        the retry strategy and the executor's capacity; either gets the
        cache."""
        fun = self.func
        assert fun is not None, "UDF must define __wrapped__"
        is_async = asyncio.iscoroutinefunction(fun)
        if isinstance(self.executor, AsyncExecutor) and not is_async:
            sync_fun = fun

            async def as_async(*args: Any, **kwargs: Any) -> Any:
                return sync_fun(*args, **kwargs)

            fun = as_async
            is_async = True
        if is_async and self.retry_strategy is not None:
            fun = _with_retries(fun, self.retry_strategy)
        if is_async and isinstance(self.executor, AsyncExecutor) and self.executor.capacity:
            fun = _with_capacity(fun, self.executor.capacity)
        if self.cache_strategy is not None:
            name = getattr(self.func, "__name__", "udf")
            fun = _with_cache(fun, self.cache_strategy, name, is_async)
        return fun, is_async

    def __call__(self, *args: Any, **kwargs: Any) -> expr.ColumnExpression:
        fun, is_async = self._wrapped_fun()
        ret = self._resolved_return_type()
        if isinstance(self.executor, FullyAsyncExecutor):
            cls: type = expr.FullyAsyncApplyExpression
        elif is_async:
            cls = expr.AsyncApplyExpression
        else:
            cls = expr.ApplyExpression
        e = cls(fun, ret, self.propagate_none, self.deterministic, args, kwargs, self.max_batch_size)
        # the wrappers hide the user's function; keep it reachable
        e._source_fun = self.func
        return e


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    propagate_none: bool = False,
    deterministic: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    max_batch_size: int | None = None,
) -> Any:
    """Decorator turning a function into a column UDF (``pw.udf``)."""

    def wrapper(f: Callable) -> UDF:
        instance = UDF(
            return_type=return_type,
            propagate_none=propagate_none,
            deterministic=deterministic,
            executor=executor,
            cache_strategy=cache_strategy,
            retry_strategy=retry_strategy,
            max_batch_size=max_batch_size,
        )
        instance.func = f
        functools.update_wrapper(instance, f)  # type: ignore[arg-type]
        return instance

    if fun is not None:
        return wrapper(fun)
    return wrapper


udf_async = functools.partial(udf, executor=AsyncExecutor())
