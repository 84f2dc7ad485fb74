"""Persistence configuration: checkpoint and resume (port of
``pathway_tpu/persistence/__init__.py``), exported as ``pw.persistence``.

``pw.run(persistence_config=pw.persistence.Config(Backend.filesystem(path)))``
journals every commit's input deltas and the sources' offsets; a run over the
same store replays the journal through the graph, then continues from the
restored offsets (``persistence/engine.py``). ``snapshot_interval_ms > 0``
also checkpoints operator state and compacts the journal, where the graph's
operators can be pickled.
"""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.persistence.cached_objects import CachedObjectStorage  # noqa: F401


class Backend:
    kind = "none"

    def __init__(self, root: str | None = None):
        self.root = root

    @classmethod
    def filesystem(cls, path: str | os.PathLike) -> "Backend":
        b = cls(str(path))
        b.kind = "filesystem"
        return b

    @classmethod
    def s3(
        cls,
        root_path: str,
        bucket_settings: Any = None,
        *,
        _client_factory: Any = None,
    ) -> "Backend":
        b = cls(root_path)
        b.kind = "s3"
        b.bucket_settings = bucket_settings
        b._client_factory = _client_factory
        return b

    @classmethod
    def azure(
        cls,
        root_path: str,
        account: Any = None,
        *,
        _client_factory: Any = None,
        **kw: Any,
    ) -> "Backend":
        b = cls(root_path)
        b.kind = "azure"
        b.account = account
        b._client_factory = _client_factory
        b.kwargs = kw
        return b

    def make_object_store(self) -> Any:
        from pathway_tpu_torch.persistence.backends import make_object_store

        return make_object_store(self)

    @classmethod
    def mock(cls, events: Any = None) -> "Backend":
        b = cls(None)
        b.kind = "mock"
        b.events = events
        return b


class Config:
    """Persistence settings.

    ``persistence_mode="silent_replay"`` keeps output callbacks and sinks from
    receiving again, during the journal's replay on resume, the rows they
    were already given (by default they receive them again, and a sink keyed
    by row key deduplicates them).

    ``backend_retry_strategy`` governs transient object-store (s3 / azure)
    failures: by default every journal and checkpoint operation retries with
    exponential backoff (``udfs.ExponentialBackoffRetryStrategy``);
    ``udfs.NoRetryStrategy()`` fails fast.
    """

    def __init__(
        self,
        backend: Backend | None = None,
        *,
        snapshot_interval_ms: int = 0,
        snapshot_access: Any = None,
        persistence_mode: Any = None,
        continue_after_replay: bool = True,
        backend_retry_strategy: Any = None,
    ):
        self.backend = backend
        self.snapshot_interval_ms = snapshot_interval_ms
        self.snapshot_access = snapshot_access
        self.persistence_mode = persistence_mode
        self.continue_after_replay = continue_after_replay
        self.backend_retry_strategy = backend_retry_strategy

    @classmethod
    def simple_config(cls, backend: Backend, **kwargs: Any) -> "Config":
        return cls(backend, **kwargs)
