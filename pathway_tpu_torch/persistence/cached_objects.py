"""Versioned cached-object storage: downloaded connector objects pinned
durably (port of ``pathway_tpu/persistence/cached_objects.py``).

A durable URI -> (blob, metadata) store with a versioned event log: a resumed
pipeline can skip re-downloading unchanged objects, reproduce a deleted or
replaced object's old content for its retractions, and rewind the store to
the version a checkpoint refers to. The fs scanner journals its parsed rows
in-band instead (its ``push_state`` markers); this store serves custom
connectors and raw-bytes pinning, over the filesystem layout (one
``<version>.blob`` / ``<version>.meta`` pair per event under ``objects/``),
an ``ObjectStore`` (S3, Azure) or memory.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterable, Optional

_OBJECTS_DIR = "objects"
_BLOB_EXT = ".blob"
_META_EXT = ".meta"


class CachedObjectStorage:
    """Durable, versioned URI -> (blob, metadata) store.

    Every ``place_object``/``remove_object`` appends an event at the next
    version; lookups answer from the latest state; ``rewind(version)`` undoes
    (and durably deletes) every event newer than ``version``, then prunes
    events shadowed by newer ones. A fresh instance over the same root replays
    the surviving events, so the state survives restarts.
    """

    def __init__(self, root: "str | os.PathLike | None", store: Any = None):
        # root=None, store=None -> in-memory only (mock/memory persistence
        # backends); store=ObjectStore -> durable over S3/Azure-style objects
        self._store = store
        self._dir = (
            None if (root is None or store is not None) else os.path.join(str(root), _OBJECTS_DIR)
        )
        if self._dir is not None:
            os.makedirs(self._dir, exist_ok=True)
        self._events: Dict[int, tuple] = {}  # version -> (uri, meta | None=delete)
        self._blobs: Dict[int, bytes] = {}  # in-memory blobs (root=None)
        self._latest: Dict[str, int] = {}  # uri -> version of its live event
        self._version = 0
        if self._dir is not None or self._store is not None:
            self._reload()

    # -- event persistence ----------------------------------------------------

    def _meta_path(self, version: int) -> str:
        return os.path.join(self._dir, f"{version}{_META_EXT}")

    def _blob_path(self, version: int) -> str:
        return os.path.join(self._dir, f"{version}{_BLOB_EXT}")

    def _meta_key(self, version: int) -> str:
        return f"{_OBJECTS_DIR}/{version}{_META_EXT}"

    def _blob_key(self, version: int) -> str:
        return f"{_OBJECTS_DIR}/{version}{_BLOB_EXT}"

    def _iter_meta_payloads(self) -> "Iterable[bytes]":
        if self._store is not None:
            for key in self._store.list(f"{_OBJECTS_DIR}/"):
                if key.endswith(_META_EXT):
                    blob = self._store.get(key)
                    if blob is not None:
                        yield blob
            return
        for name in os.listdir(self._dir):
            if name.endswith(_META_EXT):
                try:
                    with open(os.path.join(self._dir, name), "rb") as f:
                        yield f.read()
                except OSError:
                    continue

    def _reload(self) -> None:
        for payload in self._iter_meta_payloads():
            try:
                event = json.loads(payload)
                version = int(event["version"])
            except (ValueError, KeyError):
                continue  # torn write: a partial event never becomes state
            self._events[version] = (
                event["uri"],
                event["metadata"] if event["type"] == "update" else None,
            )
        self._rebuild_latest()
        self._version = max(self._events, default=0)

    def _rebuild_latest(self) -> None:
        self._latest = {}
        for version in sorted(self._events):
            uri, meta = self._events[version]
            if meta is None:
                self._latest.pop(uri, None)
            else:
                self._latest[uri] = version

    def _append_event(self, uri: str, meta: Optional[dict], blob: Optional[bytes]) -> int:
        self._version += 1
        version = self._version
        self._events[version] = (uri, meta)
        if self._store is not None:
            if blob is not None:
                self._store.put(self._blob_key(version), blob)
            # metadata written AFTER the blob: an event exists once its meta does
            self._store.put(
                self._meta_key(version),
                json.dumps(
                    {
                        "uri": uri,
                        "version": version,
                        "type": "update" if meta is not None else "delete",
                        "metadata": meta,
                    }
                ).encode(),
            )
        elif self._dir is None:
            if blob is not None:
                self._blobs[version] = blob
        else:
            if blob is not None:
                tmp = self._blob_path(version) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, self._blob_path(version))
            # metadata written AFTER the blob: an event exists once its .meta does
            tmp = self._meta_path(version) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "uri": uri,
                        "version": version,
                        "type": "update" if meta is not None else "delete",
                        "metadata": meta,
                    },
                    f,
                )
            os.replace(tmp, self._meta_path(version))
        return version

    def _drop_event(self, version: int) -> None:
        self._events.pop(version, None)
        self._blobs.pop(version, None)
        if self._store is not None:
            self._store.delete(self._meta_key(version))
            self._store.delete(self._blob_key(version))
        elif self._dir is not None:
            for path in (self._meta_path(version), self._blob_path(version)):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # -- reference interface ---------------------------------------------------

    def place_object(self, uri: str, blob: bytes, metadata: dict | None = None) -> int:
        """Upsert; returns the event's version."""
        version = self._append_event(uri, dict(metadata or {}), bytes(blob))
        self._latest[uri] = version
        return version

    def remove_object(self, uri: str) -> int:
        version = self._append_event(uri, None, None)
        self._latest.pop(uri, None)
        return version

    def contains_object(self, uri: str) -> bool:
        return uri in self._latest

    def get_object(self, uri: str) -> bytes:
        version = self._latest[uri]
        if self._store is not None:
            blob = self._store.get(self._blob_key(version))
            if blob is None:
                raise KeyError(uri)
            return blob
        if self._dir is None:
            return self._blobs[version]
        with open(self._blob_path(version), "rb") as f:
            return f.read()

    def get_metadata(self, uri: str) -> dict:
        return dict(self._events[self._latest[uri]][1])

    def actual_key_set(self) -> set:
        return set(self._latest)

    @property
    def current_version(self) -> int:
        return self._version

    def rewind(self, version: int) -> None:
        """Undo (and durably delete) every event newer than ``version``, then
        prune events shadowed by a newer surviving event of the same URI.
        ``rewind(0)`` clears the store.

        Pruning compacts history exactly as the reference does ("versions that
        are obsolete after the rewind … are also removed"): rewinding is for
        ONE resume point per run — after ``rewind(v)``, a later rewind to an
        older version cannot resurrect content whose events were already
        pruned as shadowed."""
        for v in sorted((v for v in self._events if v > version), reverse=True):
            self._drop_event(v)
        self._rebuild_latest()
        live = set(self._latest.values())
        for v in list(self._events):
            if v not in live:
                # shadowed update, stale delete marker, or pre-rewind garbage:
                # nothing can resolve to it anymore
                self._drop_event(v)
        self._version = version

    def clear(self) -> None:
        self.rewind(0)
        if self._store is not None:
            for key in self._store.list(f"{_OBJECTS_DIR}/"):
                self._store.delete(key)
        elif self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            os.makedirs(self._dir, exist_ok=True)

    def __iter__(self) -> Iterable[tuple]:
        for uri, version in self._latest.items():
            yield uri, self._events[version][1]
