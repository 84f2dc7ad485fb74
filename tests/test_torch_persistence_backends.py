"""The port's object-store persistence backends and cached-object storage:
the counterparts of ``tests/test_persistence_s3.py`` and the storage part of
``tests/test_cached_objects.py``, each run under both packages with fake
clients only (a directory-backed S3 client, an in-memory Azure container).
The S3 reader and the postgres sink that ``test_cached_objects.py`` also
covers are connectors the port does not have yet.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from .mocks import DirS3Client
from .torch_parity import clear_graphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
CHILD_TIMEOUT_S = 120


class Pkg:
    def __init__(self, name: str):
        self.name = name
        self.pw = importlib.import_module(name)
        mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
        self.GraphRunner = mod("engine.runner").GraphRunner
        self.G = mod("internals.parse_graph").G
        self.backends = mod("persistence.backends")
        self.CachedObjectStorage = mod("persistence.cached_objects").CachedObjectStorage
        self.PersistenceManager = mod("persistence.engine").PersistenceManager
        self.udfs = mod("internals.udfs")
        self.run_kw = {"device": "cpu"} if name == "pathway_tpu_torch" else {}

    def run(self, **kwargs) -> None:
        self.GraphRunner(self.G._current).run(**kwargs, **self.run_kw)


@pytest.fixture(params=PACKAGES)
def P(request):
    clear_graphs()
    yield Pkg(request.param)
    clear_graphs()


def _wordcount(P: Pkg) -> dict:
    t = P.pw.debug.table_from_markdown(
        """
        word  | n
        cat   | 1
        dog   | 2
        cat   | 3
        """
    )
    counts = t.groupby(t.word).reduce(t.word, total=P.pw.reducers.sum(t.n))
    rows: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            rows[key.as_int()] = (row["word"], int(row["total"]))
        else:
            rows.pop(key.as_int(), None)

    P.pw.io.subscribe(counts, on_change)
    return rows


def _s3_backend(P: Pkg, client):
    return P.pw.persistence.Backend.s3(
        "s3://bucket/pipelines/p1", _client_factory=lambda settings: client
    )


# -- test_persistence_s3.py -------------------------------------------------------


def test_s3_journal_replay_reproduces_state(P, tmp_path):
    client = DirS3Client(str(tmp_path / "fake-s3"))
    rows1 = _wordcount(P)
    P.run(persistence_config=P.pw.persistence.Config(_s3_backend(P, client)))
    assert sorted(rows1.values()) == [("cat", 4), ("dog", 2)]
    frames = client.list_objects_v2(Bucket="bucket", Prefix="pipelines/p1/journal/")["Contents"]
    assert frames, "no journal frame objects written"
    clear_graphs()
    rows2 = _wordcount(P)
    P.run(persistence_config=P.pw.persistence.Config(_s3_backend(P, client)))
    assert rows2 == rows1


def test_s3_checkpoint_compacts_frame_objects(P, tmp_path):
    client = DirS3Client(str(tmp_path / "fake-s3"))
    rows = _wordcount(P)
    P.run(persistence_config=P.pw.persistence.Config(_s3_backend(P, client),
                                                     snapshot_interval_ms=1))
    assert rows
    keys = [c["Key"] for c in client.list_objects_v2(Bucket="bucket", Prefix="pipelines/p1/")
            ["Contents"]]
    assert any(k.endswith("checkpoint.pkl") for k in keys), keys
    assert not any(k.endswith(".frame") for k in keys), keys  # compacted
    clear_graphs()
    rows2 = _wordcount(P)
    P.run(persistence_config=P.pw.persistence.Config(_s3_backend(P, client),
                                                     snapshot_interval_ms=1))
    assert sorted(rows2.values()) == [("cat", 4), ("dog", 2)]


def test_s3_graph_signature_mismatch_raises(P, tmp_path):
    client = DirS3Client(str(tmp_path / "fake-s3"))
    assert _wordcount(P) is not None
    P.run(persistence_config=P.pw.persistence.Config(_s3_backend(P, client)))
    clear_graphs()
    t = P.pw.debug.table_from_markdown(
        """
        city   | pop
        lisbon | 5
        """
    )
    P.pw.io.subscribe(t.select(t.city), lambda key, row, time, is_addition: None)
    with pytest.raises(ValueError, match="different dataflow graph"):
        P.run(persistence_config=P.pw.persistence.Config(_s3_backend(P, client)))


def test_cached_objects_over_s3_store(P, tmp_path):
    client = DirS3Client(str(tmp_path / "fake-s3"))
    store = P.backends.S3ObjectStore(client, "bucket", "cache")
    c1 = P.CachedObjectStorage(None, store=store)
    v1 = c1.place_object("s3://x/a", b"alpha", {"etag": "1"})
    c1.place_object("s3://x/b", b"beta", {"etag": "2"})
    c1.remove_object("s3://x/a")
    assert not c1.contains_object("s3://x/a")
    assert c1.get_object("s3://x/b") == b"beta"
    c2 = P.CachedObjectStorage(None, store=store)
    assert c2.actual_key_set() == {"s3://x/b"}
    assert c2.get_metadata("s3://x/b") == {"etag": "2"}
    c2.rewind(v1)
    c3 = P.CachedObjectStorage(None, store=store)
    assert c3.actual_key_set() == {"s3://x/a"}
    assert c3.get_object("s3://x/a") == b"alpha"


def test_memory_object_store_contract(P):
    s = P.backends.MemoryObjectStore()
    s.put("a/1", b"x")
    s.put("a/2", b"y")
    s.put("b/1", b"z")
    assert s.list("a/") == ["a/1", "a/2"]
    assert s.get("a/1") == b"x"
    assert s.get("missing") is None
    s.delete("a/1")
    assert s.list("a/") == ["a/2"]


_S3_CRASH_SCRIPT = """
import json, os, sys
pkg, repo, input_dir, out_path, s3_dir = sys.argv[1:6]
sys.path.insert(0, repo)
pw = __import__(pkg)
from tests.mocks import DirS3Client

t = pw.io.csv.read(input_dir, schema=pw.schema_builder({"word": str}), mode="streaming",
                   autocommit_duration_ms=20)
counts = t.groupby(t.word).reduce(t.word, total=pw.reducers.count())
rows = {}

def on_change(key, row, time, is_addition):
    if is_addition:
        rows[repr(key)] = {"word": row["word"], "total": int(row["total"])}
    else:
        rows.pop(repr(key), None)
    with open(out_path + ".tmp", "w") as f:
        json.dump(list(rows.values()), f)
    os.replace(out_path + ".tmp", out_path)

pw.io.subscribe(counts, on_change)
client = DirS3Client(s3_dir)
backend = pw.persistence.Backend.s3("s3://bucket/ps", _client_factory=lambda settings: client)
cfg = pw.persistence.Config(backend, snapshot_interval_ms=10)
pw.run(persistence_config=cfg, **({"device": "cpu"} if pkg == "pathway_tpu_torch" else {}))
"""


def _totals(path: str) -> dict:
    try:
        with open(path) as f:
            return {r["word"]: r["total"] for r in json.load(f)}
    except (OSError, ValueError):
        return {}


def _wait_totals(proc, path: str, want: dict) -> dict:
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while time.monotonic() < deadline and _totals(path) != want:
        assert proc.poll() is None, proc.communicate()[1].decode()[-2000:]
        time.sleep(0.1)
    time.sleep(0.5)  # nothing more may come
    return _totals(path)


def _kill(proc) -> str:
    if proc.poll() is None:
        os.kill(proc.pid, signal.SIGKILL)
    _out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    return err.decode(errors="replace")[-2000:]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_s3_crash_kill_and_restart_wordcount(pkg, tmp_path):
    """SIGKILL in the middle of a run over the S3 backend; the restart
    resumes from the frame objects and the checkpoint without counting a row
    twice."""
    input_dir = tmp_path / "in"
    input_dir.mkdir()
    out_path = str(tmp_path / "out.json")
    script = tmp_path / "prog.py"
    script.write_text(_S3_CRASH_SCRIPT)
    (input_dir / "a.csv").write_text("word\n" + "\n".join(["cat"] * 5 + ["dog"] * 3) + "\n")
    cmd = [sys.executable, str(script), pkg, REPO, str(input_dir), out_path,
           str(tmp_path / "fake-s3")]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}

    def spawn():
        return subprocess.Popen(cmd, env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)

    proc = spawn()
    try:
        first = _wait_totals(proc, out_path, {"cat": 5, "dog": 3})
    finally:
        err = _kill(proc)
    assert first == {"cat": 5, "dog": 3}, err
    (input_dir / "b.csv").write_text("word\n" + "\n".join(["cat"] * 2 + ["owl"] * 4) + "\n")
    want = {"cat": 7, "dog": 3, "owl": 4}
    proc = spawn()
    try:
        got = _wait_totals(proc, out_path, want)
    finally:
        err = _kill(proc)
    assert got == want, err


# -- the storage part of test_cached_objects.py ------------------------------------


def test_place_lookup_remove(P, tmp_path):
    cache = P.CachedObjectStorage(tmp_path)
    v1 = cache.place_object("s3://b/a.csv", b"one", {"etag": "e1", "size": 3})
    v2 = cache.place_object("s3://b/b.csv", b"two", {"etag": "e2"})
    assert (v1, v2) == (1, 2)
    assert cache.get_object("s3://b/a.csv") == b"one"
    assert cache.get_metadata("s3://b/a.csv") == {"etag": "e1", "size": 3}
    assert cache.actual_key_set() == {"s3://b/a.csv", "s3://b/b.csv"}
    cache.place_object("s3://b/a.csv", b"one-v2", {"etag": "e3"})
    assert cache.get_object("s3://b/a.csv") == b"one-v2"
    cache.remove_object("s3://b/b.csv")
    assert cache.actual_key_set() == {"s3://b/a.csv"}


def test_state_survives_restart(P, tmp_path):
    cache = P.CachedObjectStorage(tmp_path)
    cache.place_object("u1", b"alpha", {"m": 1})
    cache.place_object("u2", b"beta", {"m": 2})
    cache.remove_object("u1")
    reopened = P.CachedObjectStorage(tmp_path)
    assert reopened.actual_key_set() == {"u2"}
    assert reopened.get_object("u2") == b"beta"
    assert reopened.get_metadata("u2") == {"m": 2}
    assert reopened.place_object("u3", b"gamma") > 3  # appends go on after the max


def test_rewind_drops_newer_events_durably(P, tmp_path):
    cache = P.CachedObjectStorage(tmp_path)
    cache.place_object("u", b"v1", {"rev": 1})
    cache.place_object("u", b"v2", {"rev": 2})
    cache.place_object("w", b"w1", {"rev": 1})
    cache.rewind(2)
    assert cache.get_metadata("u") == {"rev": 2}
    assert not cache.contains_object("w")
    reopened = P.CachedObjectStorage(tmp_path)
    assert reopened.actual_key_set() == {"u"}
    assert reopened.get_object("u") == b"v2"
    reopened.rewind(0)
    assert P.CachedObjectStorage(tmp_path).actual_key_set() == set()


def test_memory_backend_roundtrip(P):
    cache = P.CachedObjectStorage(None)
    cache.place_object("u", b"x", {"a": 1})
    assert cache.get_object("u") == b"x"
    cache.rewind(0)
    assert not cache.contains_object("u")


def test_manager_accessor(P, tmp_path):
    mgr = P.PersistenceManager(
        P.pw.persistence.Config(P.pw.persistence.Backend.filesystem(tmp_path / "store"))
    )
    cache = mgr.cached_objects()
    cache.place_object("u", b"x")
    assert mgr.cached_objects() is cache  # one instance per manager
    assert (tmp_path / "store").exists()


# -- the other backends, with fakes ------------------------------------------------


class ResourceNotFoundError(Exception):
    """The name azure-storage-blob gives a missing blob's error."""


class FakeContainer:
    """The azure-storage-blob ``ContainerClient`` surface over a dict."""

    def __init__(self):
        self.blobs: dict = {}

    def upload_blob(self, name, data, overwrite=False):
        self.blobs[name] = bytes(data)

    def download_blob(self, name):
        if name not in self.blobs:
            raise ResourceNotFoundError(name)
        data = self.blobs[name]

        class Downloader:
            def readall(self):
                return data

        return Downloader()

    def list_blob_names(self, name_starts_with=""):
        return [n for n in self.blobs if n.startswith(name_starts_with)]

    def delete_blob(self, name):
        if name not in self.blobs:
            raise ResourceNotFoundError(name)
        del self.blobs[name]


def test_azure_journal_replay_and_checkpoint(P):
    """Journal frames as blobs, replayed on resume; with snapshots, a
    checkpoint blob and no frames left."""
    for snapshot_ms in (0, 1):
        container = FakeContainer()
        backend = P.pw.persistence.Backend.azure(
            "pipelines/p1", "acct", _client_factory=lambda account: container
        )
        config = P.pw.persistence.Config(backend, snapshot_interval_ms=snapshot_ms)
        clear_graphs()
        rows1 = _wordcount(P)
        P.run(persistence_config=config)
        frames = [n for n in container.blobs if n.endswith(".frame")]
        assert ("pipelines/p1/checkpoint.pkl" in container.blobs) == bool(snapshot_ms)
        assert bool(frames) == (not snapshot_ms), sorted(container.blobs)
        clear_graphs()
        rows2 = _wordcount(P)
        P.run(persistence_config=config)
        assert sorted(rows2.values()) == sorted(rows1.values()) == [("cat", 4), ("dog", 2)]


class FlakyStore:
    """Fails the first ``failures`` calls of every operation with a
    transient error; counts the calls."""

    def __init__(self, inner, failures: int):
        self.inner, self.failures, self.calls = inner, failures, {}

    def _call(self, op, *args):
        n = self.calls[op] = self.calls.get(op, 0) + 1
        if n <= self.failures:
            raise ConnectionError(f"transient {op} failure {n}")
        return getattr(self.inner, op)(*args)

    def put(self, key, data):
        return self._call("put", key, data)

    def get(self, key):
        return self._call("get", key)

    def list(self, prefix):
        return self._call("list", prefix)

    def delete(self, key):
        return self._call("delete", key)


def test_retrying_store_absorbs_transient_errors(P):
    inner = P.backends.MemoryObjectStore()
    flaky = FlakyStore(inner, failures=2)
    store = P.backends.RetryingObjectStore(
        flaky, P.udfs.FixedDelayRetryStrategy(max_retries=3, delay_ms=1)
    )
    store.put("k", b"v")
    assert store.get("k") == b"v"
    assert flaky.calls == {"put": 3, "get": 3}
    broken = P.backends.RetryingObjectStore(
        FlakyStore(inner, failures=5), P.udfs.FixedDelayRetryStrategy(max_retries=3, delay_ms=1)
    )
    with pytest.raises(ConnectionError):
        broken.put("k", b"v")


def test_retrying_store_does_not_retry_not_found(P):
    calls = []

    class Missing(P.backends.MemoryObjectStore):
        def get(self, key):
            calls.append(key)
            raise KeyError(key)

    store = P.backends.RetryingObjectStore(
        Missing(), P.udfs.FixedDelayRetryStrategy(max_retries=3, delay_ms=1)
    )
    with pytest.raises(KeyError):
        store.get("absent")
    assert calls == ["absent"]


def test_prefixed_store_namespaces_keys(P):
    inner = P.backends.MemoryObjectStore()
    view = P.backends.PrefixedStore(inner, "/process-1/")
    view.put("journal/0.frame", b"f")
    assert inner.list("") == ["process-1/journal/0.frame"]
    assert view.list("journal/") == ["journal/0.frame"]
    assert view.get("journal/0.frame") == b"f"
    view.delete("journal/0.frame")
    assert inner.objects == {}


def test_make_object_store_routes_and_refuses(P):
    client = object()
    store = P.backends.make_object_store(
        P.pw.persistence.Backend.s3("s3://bkt/a/b", _client_factory=lambda s: client)
    )
    assert isinstance(store, P.backends.S3ObjectStore)
    assert (store._bucket, store._prefix) == ("bkt", "a/b")
    with pytest.raises(ValueError, match="bucket"):
        P.backends.make_object_store(
            P.pw.persistence.Backend.s3("plain/prefix", _client_factory=lambda s: client)
        )
    with pytest.raises(ValueError, match="no object store"):
        P.backends.make_object_store(P.pw.persistence.Backend.filesystem("x"))
