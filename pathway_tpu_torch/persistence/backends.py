"""Object-store persistence backends: S3 / Azure / memory behind one surface
(port of ``pathway_tpu/persistence/backends.py``).

``ObjectStore`` is the durable key -> bytes contract the persistence engine
needs. Journal frames become immutable numbered objects (object stores have
no append: a PUT per commit gives the same crash guarantee as the filesystem
backend's fsync per frame, a frame either exists whole or not at all),
checkpoints are single-PUT blobs (atomic per key), and compaction deletes the
frame objects a checkpoint subsumes. Clients are injected through
``Backend.s3(..., _client_factory=...)`` / ``Backend.azure(...)``, so tests run
the whole engine against an in-memory or directory-backed fake; boto3 and
azure-storage-blob are imported only when no factory is given.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, List


class ObjectStore:
    """Minimal durable key -> bytes contract the persistence engine needs."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> "bytes | None":
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        """Keys under ``prefix``, sorted: journal replay order rides on it."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


def _is_not_found(exc: Exception) -> bool:
    """Tell 'object does not exist' from a transient store error: a throttle
    or network failure must not read as an absent checkpoint, or the runner
    would start fresh and later overwrite the good checkpoint."""
    if isinstance(exc, (KeyError, FileNotFoundError)):
        return True  # fakes and dict-backed clients
    resp = getattr(exc, "response", None)  # botocore ClientError
    if isinstance(resp, dict):
        code = str(resp.get("Error", {}).get("Code", ""))
        return code in ("NoSuchKey", "NoSuchBucket", "404", "NotFound")
    return type(exc).__name__ in ("ResourceNotFoundError", "BlobNotFound")


class RetryingObjectStore(ObjectStore):
    """Every operation runs through an ``AsyncRetryStrategy`` (by default
    ``ExponentialBackoffRetryStrategy``), so a throttled PUT or a flaky read
    retries with backoff and jitter instead of killing the pipeline in the
    middle of a commit. Not-found is no error at this layer (inner stores
    return None), so retries fire only on real exceptions."""

    def __init__(self, inner: ObjectStore, strategy: Any = None):
        from pathway_tpu_torch.internals.udfs import (
            ExponentialBackoffRetryStrategy,
            FixedDelayRetryStrategy,
        )

        if strategy is None:
            strategy = ExponentialBackoffRetryStrategy(
                max_retries=4, initial_delay=50, backoff_factor=2, jitter_ms=20
            )
        self._inner = inner
        self._strategy = strategy
        # the stock backoff strategies run as a plain sleep loop: one journal
        # PUT per commit must not pay an event loop's setup per call. An exact
        # type check: a subclass may override invoke() and goes through it
        self._sync_schedule = type(strategy) in (
            ExponentialBackoffRetryStrategy,
            FixedDelayRetryStrategy,
        )

    def _retry(self, fun: Callable, *args: Any) -> Any:
        if self._sync_schedule:
            s = self._strategy
            delay = s.initial_delay
            for attempt in range(s.max_retries + 1):
                try:
                    return fun(*args)
                except Exception as exc:
                    # a not-found raised by an inner client is definitive:
                    # retrying it only delays the caller's absent-object path
                    if _is_not_found(exc) or attempt == s.max_retries:
                        raise
                    time.sleep(delay + random.random() * s.jitter)
                    delay *= s.backoff_factor
            raise RuntimeError("unreachable")
        import asyncio

        async def call(*a: Any) -> Any:
            return fun(*a)

        return asyncio.run(self._strategy.invoke(call, *args))

    def put(self, key: str, data: bytes) -> None:
        self._retry(self._inner.put, key, data)

    def get(self, key: str) -> "bytes | None":
        return self._retry(self._inner.get, key)

    def list(self, prefix: str) -> List[str]:
        return self._retry(self._inner.list, prefix)

    def delete(self, key: str) -> None:
        self._retry(self._inner.delete, key)


class PrefixedStore(ObjectStore):
    """A namespaced view of another store: every key gets the prefix on the
    way in and loses it on the way out."""

    def __init__(self, inner: ObjectStore, prefix: str):
        self._inner = inner
        self._prefix = prefix.strip("/") + "/" if prefix.strip("/") else ""

    def put(self, key: str, data: bytes) -> None:
        self._inner.put(self._prefix + key, data)

    def get(self, key: str) -> "bytes | None":
        return self._inner.get(self._prefix + key)

    def list(self, prefix: str) -> List[str]:
        cut = len(self._prefix)
        return [k[cut:] for k in self._inner.list(self._prefix + prefix)]

    def delete(self, key: str) -> None:
        self._inner.delete(self._prefix + key)


class MemoryObjectStore(ObjectStore):
    def __init__(self) -> None:
        self.objects: Dict[str, bytes] = {}

    def put(self, key: str, data: bytes) -> None:
        self.objects[key] = bytes(data)

    def get(self, key: str) -> "bytes | None":
        return self.objects.get(key)

    def list(self, prefix: str) -> List[str]:
        return sorted(k for k in self.objects if k.startswith(prefix))

    def delete(self, key: str) -> None:
        self.objects.pop(key, None)


def _list_s3_objects(client: Any, bucket: str, prefix: str) -> List[dict]:
    """Every object under ``prefix``, following continuation tokens, sorted
    by key."""
    out: List[dict] = []
    token = None
    while True:
        kwargs = {"Bucket": bucket, "Prefix": prefix}
        if token:
            kwargs["ContinuationToken"] = token
        resp = client.list_objects_v2(**kwargs)
        out.extend(resp.get("Contents", []))
        if not resp.get("IsTruncated"):
            break
        token = resp.get("NextContinuationToken")
    return sorted(out, key=lambda o: o["Key"])


def _split_s3_uri(path: str, settings: Any) -> tuple:
    """``s3://bucket/prefix`` -> (bucket, prefix); an empty bucket comes from
    ``settings.bucket_name``."""
    if not path.startswith("s3://"):
        raise ValueError(f"not an s3:// URI: {path!r}")
    bucket, _, prefix = path[len("s3://"):].partition("/")
    if not bucket and settings is not None and getattr(settings, "bucket_name", None):
        bucket = settings.bucket_name
    if not bucket:
        raise ValueError(f"cannot determine bucket from {path!r}")
    return bucket, prefix


def _default_s3_client_factory(settings: Any) -> Any:
    try:
        import boto3  # type: ignore
        from botocore.config import Config  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "no S3 client library (boto3) in this environment; pass "
            "_client_factory=... (any object with the boto3 S3 client "
            "list_objects_v2/get_object/put_object/delete_object surface), or mount "
            "the bucket as a filesystem and use Backend.filesystem"
        ) from exc
    kwargs: dict = {}
    if settings is not None:
        if getattr(settings, "access_key", None):
            kwargs["aws_access_key_id"] = settings.access_key
        if getattr(settings, "secret_access_key", None):
            kwargs["aws_secret_access_key"] = settings.secret_access_key
        if getattr(settings, "region", None):
            kwargs["region_name"] = settings.region
        if getattr(settings, "endpoint", None):
            kwargs["endpoint_url"] = settings.endpoint
        if getattr(settings, "with_path_style", False):
            kwargs["config"] = Config(s3={"addressing_style": "path"})
    return boto3.client("s3", **kwargs)


class S3ObjectStore(ObjectStore):
    """Over the boto3 S3 client surface (``list_objects_v2`` /
    ``get_object`` / ``put_object`` / ``delete_object``)."""

    def __init__(self, client: Any, bucket: str, prefix: str):
        self._client = client
        self._bucket = bucket
        self._prefix = prefix.strip("/")

    def _full(self, key: str) -> str:
        return f"{self._prefix}/{key}" if self._prefix else key

    def put(self, key: str, data: bytes) -> None:
        self._client.put_object(Bucket=self._bucket, Key=self._full(key), Body=bytes(data))

    def get(self, key: str) -> "bytes | None":
        try:
            resp = self._client.get_object(Bucket=self._bucket, Key=self._full(key))
        except Exception as exc:
            if _is_not_found(exc):
                return None
            raise
        return resp["Body"].read()

    def list(self, prefix: str) -> List[str]:
        cut = len(self._prefix) + 1 if self._prefix else 0
        return [
            o["Key"][cut:]
            for o in _list_s3_objects(self._client, self._bucket, self._full(prefix))
        ]

    def delete(self, key: str) -> None:
        try:
            self._client.delete_object(Bucket=self._bucket, Key=self._full(key))
        except Exception as exc:
            # an absent object is fine; a transient failure is not: compaction
            # relies on the object actually going away
            if not _is_not_found(exc):
                raise


class AzureObjectStore(ObjectStore):
    """Over the azure-storage-blob ``ContainerClient`` surface
    (``upload_blob`` / ``download_blob`` / ``list_blob_names`` /
    ``delete_blob``)."""

    def __init__(self, container_client: Any, prefix: str):
        self._client = container_client
        self._prefix = prefix.strip("/")

    def _full(self, key: str) -> str:
        return f"{self._prefix}/{key}" if self._prefix else key

    def put(self, key: str, data: bytes) -> None:
        self._client.upload_blob(self._full(key), bytes(data), overwrite=True)

    def get(self, key: str) -> "bytes | None":
        try:
            return self._client.download_blob(self._full(key)).readall()
        except Exception as exc:
            if _is_not_found(exc):
                return None
            raise

    def list(self, prefix: str) -> List[str]:
        names = self._client.list_blob_names(name_starts_with=self._full(prefix))
        cut = len(self._prefix) + 1 if self._prefix else 0
        return sorted(str(n)[cut:] for n in names)

    def delete(self, key: str) -> None:
        try:
            self._client.delete_blob(self._full(key))
        except Exception as exc:
            if not _is_not_found(exc):
                raise


def _default_azure_factory(account: Any, root_path: str, kw: dict) -> Any:
    try:
        from azure.storage.blob import ContainerClient  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "no Azure client library (azure-storage-blob) in this environment; pass "
            "_client_factory=... (any object with the ContainerClient upload_blob/"
            "download_blob/list_blob_names/delete_blob surface)"
        ) from exc
    container = kw.get("container") or root_path.split("/", 1)[0]
    return ContainerClient(
        account_url=f"https://{account}.blob.core.windows.net",
        container_name=container,
        credential=kw.get("credential"),
    )


def make_object_store(backend: Any) -> ObjectStore:
    """The ObjectStore of a ``persistence.Backend`` of kind s3 or azure."""
    root = str(backend.root or "")
    if backend.kind == "s3":
        factory = getattr(backend, "_client_factory", None) or _default_s3_client_factory
        settings = getattr(backend, "bucket_settings", None)
        client = factory(settings)
        if root.startswith("s3://"):
            bucket, prefix = _split_s3_uri(root, settings)
        else:
            bucket = getattr(settings, "bucket_name", None) or ""
            prefix = root
            if not bucket:
                raise ValueError(
                    "S3 persistence root must be s3://bucket/prefix or "
                    "bucket_settings must carry bucket_name"
                )
        return S3ObjectStore(client, bucket, prefix)
    if backend.kind == "azure":
        factory = getattr(backend, "_client_factory", None)
        account = getattr(backend, "account", None)
        kw = getattr(backend, "kwargs", {})
        if factory is not None:
            client = factory(account)
        else:
            client = _default_azure_factory(account, root, kw)
        # a container given in the keywords (or a factory) makes the whole
        # root the blob prefix; otherwise the root's first segment names the
        # container and the rest is the prefix
        if kw.get("container") or factory is not None:
            prefix = root
        else:
            prefix = root.split("/", 1)[1] if "/" in root else ""
        return AzureObjectStore(client, prefix)
    raise ValueError(f"no object store for backend kind {backend.kind!r}")
