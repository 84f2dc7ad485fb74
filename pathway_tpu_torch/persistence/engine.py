"""Persistence engine: the input journal, segment-state deltas and replay on
resume (port of the single-process part of ``pathway_tpu/persistence/engine.py``).

Every commit's input deltas are appended to one journal as length-prefixed
pickle frames. Everything downstream of the sources is deterministic, so
replaying the journal through the graph rebuilds every operator's state. A
frame is fsynced before the next commit, so a crash loses at most the frame
being written; its torn bytes are found on load and cut off before new frames
are appended. A frame also carries each source's light offsets: consumed
counts, sequence cursors and the segment-state deltas a source pushed in that
commit, which put a scanner back where it was without reading its data again.

A checkpoint (``dump_checkpoint``) pickles operator and source state and then
compacts the journal: the frames it subsumes are dropped. The journal's
header names the graph's signature, the key-derivation version and the
worker count; a store written under another of any of them is refused.

Not ported here: the cluster's coordinated checkpoints, manifests, reshard
fragments and source parks, and the fault-injection wrapper of the object
store.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pathway_tpu_torch.engine.columnar import Delta
from pathway_tpu_torch.internals.keys import KEY_DERIVATION_VERSION, KEY_DTYPE

_FRAME_HEADER = struct.Struct(">Q")
_JOURNAL = "journal.bin"
_CHECKPOINT = "checkpoint.pkl"
_STORE_META = "store.meta"
# v2: the header line is a json object with the graph signature, the
# key-derivation version and the worker count: frames store derived row keys,
# so a journal from a build with another key derivation (or replayed under
# another shard layout) must be refused, not resumed
_HEADER_MAGIC = b"PWTPUJ2\n"
# known incompatible earlier formats: loading one fails loudly (v1 journals
# predate the splitmix integer-key derivation)
_OLD_MAGICS = (b"PWTPUJ1\n",)

_OLD_FORMAT_ERROR = (
    "persisted journal was written by an incompatible earlier build (format v1, "
    "before the splitmix key-derivation change): its stored row keys no longer "
    "match keys this build derives for the same values, so replayed rows would "
    "become unreachable for updates/retractions — clear the persistence "
    "directory to start fresh"
)

Frame = Tuple[int, Dict[int, Delta], Dict[int, dict]]


class MembershipMismatchError(ValueError):
    """A persisted store (journal header, store meta, checkpoint) names
    another worker count than this run's. A ``ValueError``, so callers that
    handle refusals as ``ValueError`` keep working."""

    def __init__(
        self,
        what: str,
        *,
        manifest_n: "int | None",
        current_n: int,
        epoch: int = 0,
    ):
        self.manifest_n = manifest_n
        self.current_n = current_n
        self.epoch = epoch
        super().__init__(
            f"persisted {what} was written by a run with {manifest_n} worker "
            f"process(es) but this run uses {current_n} (store epoch "
            f"{epoch}): the journal and checkpoints are sharded per worker. "
            f"If the cluster was resized with `spawn --scale`, relaunch with "
            f"-n {manifest_n} (the supervisor does this automatically when "
            "adapting after a mid-transition crash); if you never scaled, "
            "the store belongs to a different deployment — clear the "
            "persistence directory to start fresh"
        )


def _delta_to_payload(delta: Delta) -> tuple:
    return (delta.keys.tobytes(), delta.diffs, dict(delta.columns), delta.neu)


def _payload_to_delta(payload: tuple) -> Delta:
    keys_b, diffs, columns, neu = payload
    keys = np.frombuffer(keys_b, dtype=KEY_DTYPE).copy()
    return Delta(keys, diffs, columns, neu=neu)


class PersistenceManager:
    """Owns the journal and the checkpoint of one pipeline under one backend
    root."""

    def __init__(self, config: Any):
        from pathway_tpu_torch.internals.config import get_pathway_config

        backend = config.backend
        if backend is None or backend.kind not in (
            "filesystem", "memory", "mock", "s3", "azure"
        ):
            raise ValueError(
                f"persistence backend {getattr(backend, 'kind', None)!r} not supported; "
                "use pw.persistence.Backend.filesystem/s3/azure(...)"
            )
        self.config = config
        self.root = backend.root
        self._object_store: Any = None
        self._object_prefix = ""
        self._next_seq = 0
        if backend.kind in ("s3", "azure"):
            # object-store mode: journal frames are immutable numbered objects
            # (a PUT per frame: a frame exists whole or not at all)
            from pathway_tpu_torch.internals.chaos import get_chaos
            from pathway_tpu_torch.internals.udfs import NoRetryStrategy
            from pathway_tpu_torch.persistence.backends import RetryingObjectStore

            store = backend.make_object_store()
            chaos = get_chaos()
            if chaos is not None:
                # injected transient write errors sit below the retry layer,
                # which must absorb them as it absorbs real ones
                store = chaos.wrap_object_store(store)
            retry_strategy = getattr(config, "backend_retry_strategy", None)
            if not isinstance(retry_strategy, NoRetryStrategy):
                store = RetryingObjectStore(store, retry_strategy)
            self._object_store = store
            self._memory = False
        else:
            self._memory = backend.kind in ("memory", "mock") or self.root is None
        cfg = get_pathway_config()
        self._workers = max(1, int(getattr(cfg, "processes", 1) or 1))
        # the store-wide meta lives at the unsharded root, so a reopen with
        # another worker count is found although each worker reads its shard
        self._base_root = self.root
        if cfg.processes > 1 and (self._object_store is not None or not self._memory):
            # each worker process owns a journal shard: one shared file would
            # interleave frames of different processes
            if self._object_store is not None:
                self._object_prefix = f"process-{cfg.process_id}/"
            else:
                self.root = os.path.join(str(self.root), f"process-{cfg.process_id}")
        self._mem_journal: io.BytesIO = io.BytesIO()
        self._mem_checkpoint: "bytes | None" = None
        self._journal_file: Any = None
        self._cached_objects: Any = None
        # id of the last frame this process appended (None before the first)
        self.last_commit_id: Optional[int] = None
        # byte offset of the last whole frame, set by load_journal:
        # open_for_append cuts torn tail bytes past it
        self._valid_end: Optional[int] = None
        # frames appended since the last compaction (the journal's tail)
        self.frames_since_compact = 0
        if not self._memory and self._object_store is None:
            os.makedirs(self.root, exist_ok=True)

    def _journal_path(self) -> str:
        return os.path.join(self.root, _JOURNAL)

    def _meta_key(self) -> str:
        return f"{self._object_prefix}meta"

    def _frame_key(self, seq: int) -> str:
        return f"{self._object_prefix}journal/{seq:010d}.frame"

    def _checkpoint_key(self) -> str:
        return f"{self._object_prefix}{_CHECKPOINT}"

    # -- versioned header and store-wide meta ---------------------------------

    def _header_bytes(self, graph_sig: str) -> bytes:
        meta = {
            "sig": graph_sig,
            "key_derivation": KEY_DERIVATION_VERSION,
            "workers": self._workers,
        }
        return _HEADER_MAGIC + json.dumps(meta, sort_keys=True).encode() + b"\n"

    def _check_meta(self, meta: dict, what: str) -> None:
        """Refuse to resume state this build cannot replay correctly."""
        kv = meta.get("key_derivation")
        if kv != KEY_DERIVATION_VERSION:
            raise ValueError(
                f"persisted {what} was written with key-derivation v{kv} but this "
                f"build derives v{KEY_DERIVATION_VERSION} keys; replayed rows would "
                "become unreachable for updates/retractions — clear the persistence "
                "directory to start fresh"
            )
        workers = meta.get("workers")
        if workers != self._workers:
            raise MembershipMismatchError(
                what,
                manifest_n=workers,
                current_n=self._workers,
                epoch=int(meta.get("epoch", 0) or 0),
            )

    def _write_store_meta(self) -> None:
        payload = json.dumps(
            {"workers": self._workers, "key_derivation": KEY_DERIVATION_VERSION},
            sort_keys=True,
        ).encode()
        if self._object_store is not None:
            self._object_store.put(_STORE_META, payload)
            return
        if self._memory or self._base_root is None:
            return
        os.makedirs(str(self._base_root), exist_ok=True)
        path = os.path.join(str(self._base_root), _STORE_META)
        # a temporary file of this process's own: worker processes may write
        # the (identical) meta at once, and either rename may win
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _check_store_meta(self) -> None:
        """The store-wide guard at the unsharded root: a run with another
        worker count reads other ``process-{id}/`` shards (possibly none), so
        the per-shard headers alone cannot find the mismatch."""
        if self._object_store is not None:
            blob = self._object_store.get(_STORE_META)
            if blob is None:
                self._write_store_meta()
                return
            meta = json.loads(blob)
        elif self._memory or self._base_root is None:
            return  # an in-memory store cannot be reopened by another run
        else:
            path = os.path.join(str(self._base_root), _STORE_META)
            if not os.path.exists(path):
                self._write_store_meta()
                return
            with open(path) as f:
                meta = json.load(f)
        self._check_meta(meta, "store")

    def _validate_header_line(
        self, line: bytes, graph_sig: str, prefix_hint: str = "directory"
    ) -> None:
        meta = json.loads(line)
        if meta.get("sig") != graph_sig:
            raise ValueError(
                "persisted journal was written by a different dataflow graph; "
                f"clear the persistence {prefix_hint} or keep the program unchanged"
            )
        self._check_meta(meta, "journal")

    # -- journal write path ---------------------------------------------------

    def open_for_append(self, graph_sig: str) -> None:
        self._check_store_meta()
        header = self._header_bytes(graph_sig)
        if self._object_store is not None:
            if self._object_store.get(self._meta_key()) is None:
                self._object_store.put(self._meta_key(), header)
            existing = self._object_store.list(f"{self._object_prefix}journal/")
            seqs = [
                int(k.rsplit("/", 1)[-1].split(".")[0])
                for k in existing
                if k.endswith(".frame")
            ]
            self._next_seq = max(seqs) + 1 if seqs else 0
            return
        if self._memory:
            if self._valid_end is not None:
                self._mem_journal.truncate(self._valid_end)
                self._mem_journal.seek(self._valid_end)
            if self._mem_journal.getbuffer().nbytes == 0:
                self._mem_journal.write(header)
            return
        path = self._journal_path()
        if not os.path.exists(path):
            self._journal_file = open(path, "ab")
            self._journal_file.write(header)
            self._journal_file.flush()
            os.fsync(self._journal_file.fileno())
            return
        self._journal_file = open(path, "r+b")
        if self._valid_end is not None:
            self._journal_file.truncate(self._valid_end)
        self._journal_file.seek(0, os.SEEK_END)
        if self._journal_file.tell() == 0:
            # a corrupt header was discarded: start a fresh journal
            self._journal_file.write(header)
            self._journal_file.flush()
            os.fsync(self._journal_file.fileno())

    def record_commit(
        self,
        commit_id: int,
        input_deltas: Dict[int, Delta],
        offsets: Dict[int, dict],
    ) -> int:
        """Append one frame: the commit's input deltas and the sources' light
        offsets, fsynced (the crash story depends on a frame surviving a
        power loss). Returns the frame's size in bytes."""
        frame = pickle.dumps(
            (
                commit_id,
                {nid: _delta_to_payload(d) for nid, d in input_deltas.items()},
                offsets,
            ),
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        self.last_commit_id = commit_id
        self.frames_since_compact += 1
        if self._object_store is not None:
            self._object_store.put(self._frame_key(self._next_seq), frame)
            self._next_seq += 1
            return len(frame)
        buf = _FRAME_HEADER.pack(len(frame)) + frame
        if self._memory:
            self._mem_journal.write(buf)
        else:
            self._journal_file.write(buf)
            self._journal_file.flush()
            os.fsync(self._journal_file.fileno())
        return len(buf)

    def close(self) -> None:
        if self._journal_file is not None:
            self._journal_file.close()
            self._journal_file = None

    def reload(self, graph_sig: str) -> List[Frame]:
        """Drop the append handle, read every durable frame again and reopen
        for append."""
        self.close()
        frames = self.load_journal(graph_sig)
        self.open_for_append(graph_sig)
        return frames

    def cached_objects(self) -> Any:
        """The pipeline's durable URI -> (blob, metadata) store, under this
        manager's root (in memory under the mock and memory backends)."""
        from pathway_tpu_torch.persistence.cached_objects import CachedObjectStorage

        if self._cached_objects is None:
            if self._object_store is not None:
                from pathway_tpu_torch.persistence.backends import PrefixedStore

                # the journal's per-process namespace: worker processes must
                # not interleave versions in one objects/ tree
                store = (
                    PrefixedStore(self._object_store, self._object_prefix)
                    if self._object_prefix
                    else self._object_store
                )
                self._cached_objects = CachedObjectStorage(None, store=store)
            else:
                self._cached_objects = CachedObjectStorage(None if self._memory else self.root)
        return self._cached_objects

    # -- operator checkpoints --------------------------------------------------

    def _snapshot_payload(self, graph_sig: str, commit_id: int, blob: dict) -> bytes:
        return pickle.dumps(
            {
                "sig": graph_sig,
                "commit_id": commit_id,
                "state": blob,
                "key_derivation": KEY_DERIVATION_VERSION,
                "workers": self._workers,
            },
            protocol=pickle.HIGHEST_PROTOCOL,
        )

    def dump_checkpoint(self, graph_sig: str, commit_id: int, blob: dict) -> int:
        """Persist a whole engine checkpoint (operator and source state)
        atomically, then compact the journal: the frames up to ``commit_id``
        are subsumed by it. A crash between the two steps is safe: a load
        skips subsumed frames by id. Returns the checkpoint's bytes."""
        payload = self._snapshot_payload(graph_sig, commit_id, blob)
        if self._object_store is not None:
            self._object_store.put(self._checkpoint_key(), payload)
        elif self._memory:
            self._mem_checkpoint = payload
        else:
            tmp = os.path.join(self.root, _CHECKPOINT + ".tmp")
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.root, _CHECKPOINT))
        self.compact_journal(graph_sig)
        return len(payload)

    def load_checkpoint(self, graph_sig: str) -> Optional[Tuple[int, dict]]:
        if self._object_store is not None:
            payload = self._object_store.get(self._checkpoint_key())
        elif self._memory:
            payload = self._mem_checkpoint
        else:
            path = os.path.join(self.root, _CHECKPOINT)
            try:
                with open(path, "rb") as f:
                    payload = f.read()
            except OSError:
                payload = None
        if payload is None:
            return None
        try:
            data = pickle.loads(payload)
        except Exception as exc:
            # the journal was compacted when this checkpoint was written: a
            # corrupt checkpoint read as absent would lose the compacted history
            raise ValueError(
                "persisted checkpoint is unreadable; the journal alone cannot restore "
                "state (it was compacted) — restore checkpoint.pkl from a copy or clear "
                "the persistence directory to start fresh"
            ) from exc
        if data.get("sig") != graph_sig:
            raise ValueError(
                "persisted checkpoint was written by a different dataflow graph; "
                "clear the persistence directory or keep the program unchanged"
            )
        self._check_meta(data, "checkpoint")
        return data["commit_id"], data["state"]

    def compact_journal(self, graph_sig: str) -> int:
        """Drop every journal frame (all are at or before the checkpoint's
        commit when this runs: the commit loop is sequential). Returns the
        number of frames dropped."""
        dropped = self.frames_since_compact
        if self._object_store is not None:
            for key in self._object_store.list(f"{self._object_prefix}journal/"):
                if key.endswith(".frame"):
                    seq = int(key.rsplit("/", 1)[-1].split(".")[0])
                    if seq < self._next_seq:
                        self._object_store.delete(key)
        elif self._memory:
            self._mem_journal = io.BytesIO()
            self._mem_journal.write(self._header_bytes(graph_sig))
        else:
            header = self._header_bytes(graph_sig)
            self._journal_file.truncate(len(header))
            self._journal_file.seek(0, os.SEEK_END)
            self._journal_file.flush()
            os.fsync(self._journal_file.fileno())
        self.frames_since_compact = 0
        return dropped

    # -- journal read path -----------------------------------------------------

    def load_journal(self, graph_sig: str) -> List[Frame]:
        """Every whole frame. A torn tail frame (a crash while it was written)
        is dropped and marked for truncation by ``open_for_append``. Object
        stores have no torn tails: a PUT is atomic, so every listed frame
        object is whole."""
        if self._object_store is not None:
            return self._load_object_journal(graph_sig)
        if self._memory:
            data = self._mem_journal.getvalue()
        else:
            if not os.path.exists(self._journal_path()):
                self._valid_end = None
                return []
            with open(self._journal_path(), "rb") as f:
                data = f.read()
        if any(data.startswith(old) for old in _OLD_MAGICS):
            raise ValueError(_OLD_FORMAT_ERROR)
        if not data.startswith(_HEADER_MAGIC):
            self._valid_end = 0  # a corrupt or foreign header: start fresh
            return []
        try:
            nl = data.index(b"\n", len(_HEADER_MAGIC))
        except ValueError:
            self._valid_end = 0
            return []
        self._validate_header_line(data[len(_HEADER_MAGIC):nl], graph_sig)
        pos = nl + 1
        frames: List[Frame] = []
        while pos + _FRAME_HEADER.size <= len(data):
            (length,) = _FRAME_HEADER.unpack_from(data, pos)
            start = pos + _FRAME_HEADER.size
            if start + length > len(data):
                break  # a torn tail frame
            try:
                commit_id, payloads, offsets = pickle.loads(data[start:start + length])
            except Exception:
                break  # a torn frame body behind a whole length prefix
            frames.append(
                (commit_id, {nid: _payload_to_delta(p) for nid, p in payloads.items()}, offsets)
            )
            pos = start + length
        self._valid_end = pos
        self.frames_since_compact = len(frames)
        return frames

    def _load_object_journal(self, graph_sig: str) -> List[Frame]:
        meta = self._object_store.get(self._meta_key())
        if meta is not None:
            if any(meta.startswith(old) for old in _OLD_MAGICS):
                raise ValueError(_OLD_FORMAT_ERROR)
            if not meta.startswith(_HEADER_MAGIC):
                return []
            self._validate_header_line(
                meta[len(_HEADER_MAGIC):].rstrip(b"\n"), graph_sig, prefix_hint="prefix"
            )
        frames: List[Frame] = []
        # frame keys are zero-padded, so their order is replay order; a
        # custom store may list them unsorted
        for key in sorted(self._object_store.list(f"{self._object_prefix}journal/")):
            if not key.endswith(".frame"):
                continue
            blob = self._object_store.get(key)
            if blob is None:
                continue
            try:
                commit_id, payloads, offsets = pickle.loads(blob)
            except Exception as exc:
                # PUTs are atomic, so an unreadable frame object is corruption
                # in the store: dropping it would lose every later frame
                raise ValueError(
                    f"persisted journal frame {key!r} is unreadable; refusing to "
                    "resume with missing commits — restore the object or clear "
                    "the persistence prefix to start fresh"
                ) from exc
            frames.append(
                (commit_id, {nid: _payload_to_delta(p) for nid, p in payloads.items()}, offsets)
            )
        self.frames_since_compact = len(frames)
        return frames
