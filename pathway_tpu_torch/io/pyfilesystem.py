"""PyFilesystem connector (port of ``pathway_tpu/io/pyfilesystem.py``): reads any
object with the ``fs.FS`` interface the caller hands in (``walk.files`` and
``readbytes``); the ``fs`` package itself is never imported. Local directories
are served by ``pw.io.fs`` instead.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import schema as sch


def read(
    source: Any,
    *,
    path: str = "/",
    format: str = "binary",
    mode: str = "streaming",
    with_metadata: bool = False,
    refresh_interval: float = 30.0,
    **kwargs: Any,
) -> Any:
    """Read files from a PyFilesystem ``FS`` object (zip, tar, ftp, mem, …)."""
    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    if not hasattr(source, "walk") or not hasattr(source, "readbytes"):
        raise TypeError("pw.io.pyfilesystem.read expects a PyFilesystem FS object")

    import time as _time

    schema = sch.schema_from_types(data=bytes, path=str)

    class _FsSubject(ConnectorSubject):
        def run(self) -> None:
            seen: dict[str, bytes] = {}
            while True:
                for file_path in source.walk.files(path):
                    data = source.readbytes(file_path)
                    if seen.get(file_path) == data:
                        continue
                    if file_path in seen:
                        self._emit({"data": seen[file_path], "path": file_path}, diff=-1)
                    self._emit({"data": data, "path": file_path})
                    seen[file_path] = data
                if mode in ("static", "batch"):
                    break
                _time.sleep(refresh_interval)

    return py_read(_FsSubject(), schema=schema)
