"""Shared helpers of the LLM xpack (port of ``pathway_tpu/xpacks/llm/_utils.py``)."""

from __future__ import annotations

from typing import Any


async def close_async_client(client: Any) -> None:
    """Best-effort close of a loop-bound async API client being replaced.

    The engine runs each commit batch under its own ``asyncio.run()`` loop, so clients
    cache per loop; when the loop changes the stale client's connection pool must be
    released rather than abandoned (it would otherwise leak sockets/fds every batch)."""
    if client is None:
        return
    try:
        await client.close()
    except Exception:
        # the old pool was bound to a dead loop; fall back to closing the raw transport
        inner = getattr(client, "_client", None)
        try:
            if inner is not None and hasattr(inner, "_transport"):
                await inner._transport.aclose()
        except Exception:
            pass


def import_client(package: str, missing: str | None = None) -> Any:
    """Import a client package when a model is built or called, never when
    the xpack is imported (the GPU machine has none of them). ``missing``:
    the ``ImportError`` message when it is absent (else the import's own)."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        if missing is None:
            raise
        raise ImportError(missing) from e
