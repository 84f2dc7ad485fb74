"""Environment-driven runtime configuration (port of ``pathway_tpu/internals/config.py``).

``PATHWAY_THREADS`` / ``PATHWAY_PROCESSES`` / ``PATHWAY_PROCESS_ID`` /
``PATHWAY_FIRST_PORT``, the monitoring port ``PATHWAY_MONITORING_HTTP_PORT``,
and the record/replay contract (``PATHWAY_REPLAY_STORAGE``,
``PATHWAY_SNAPSHOT_ACCESS``, ``PATHWAY_PERSISTENCE_MODE``,
``PATHWAY_CONTINUE_AFTER_REPLAY``), read as the reference reads them. The
port's engine runs one process today: the monitoring endpoint reads
``monitoring_http_port`` and ``process_id``; the rest waits for persistence
and the cluster.
"""

from __future__ import annotations

import os
import threading as _threading
from dataclasses import dataclass


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    """Float knob from the env; blank or malformed values fall back to the
    default (an optional tuning knob must never kill the pipeline). One home
    for the parse so the mesh (cluster.py) and the supervisor read the shared
    PATHWAY_* knobs identically."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass
class PathwayConfig:
    threads: int = 1
    processes: int = 1
    process_id: int = 0
    first_port: int = 10000
    run_id: str | None = None
    monitoring_http_port: int | None = None
    replay_storage: str | None = None
    snapshot_access: str | None = None  # "record" | "replay" | None
    persistence_mode: str | None = None  # "batch" | "speedrun" | None
    continue_after_replay: bool = True

    @classmethod
    def from_env(cls) -> "PathwayConfig":
        port_env = os.environ.get("PATHWAY_MONITORING_HTTP_PORT")
        try:
            port = int(port_env) if port_env else None
        except ValueError:
            port = None  # malformed optional knob must not kill the pipeline
        cont_env = os.environ.get("PATHWAY_CONTINUE_AFTER_REPLAY")
        if cont_env is not None:
            cont = cont_env.lower() in ("true", "1", "yes")
        else:
            # like the reference: `pathway replay` stops after the recording unless
            # --continue; normal and record runs keep consuming realtime data
            cont = os.environ.get("PATHWAY_SNAPSHOT_ACCESS") != "replay"
        return cls(
            threads=max(_int_env("PATHWAY_THREADS", 1), 1),
            processes=max(_int_env("PATHWAY_PROCESSES", 1), 1),
            process_id=_int_env("PATHWAY_PROCESS_ID", 0),
            first_port=_int_env("PATHWAY_FIRST_PORT", 10000),
            run_id=os.environ.get("PATHWAY_RUN_ID"),
            monitoring_http_port=port,
            replay_storage=os.environ.get("PATHWAY_REPLAY_STORAGE"),
            snapshot_access=os.environ.get("PATHWAY_SNAPSHOT_ACCESS"),
            persistence_mode=os.environ.get("PATHWAY_PERSISTENCE_MODE") or None,
            continue_after_replay=cont,
        )


_tls = _threading.local()


def set_thread_config(config: "PathwayConfig | None") -> None:
    """Install (or clear, with None) a per-thread config override. Thread
    workers (``parallel.threads.run_threads``) use this to present themselves
    as rank ``process_id`` of a ``processes``-worker cluster — all the
    process-keyed machinery (cluster policies, key bases, persistence shards,
    parallel-reader partitioning) follows without knowing about threads."""
    _tls.override = config


def current_thread_config_override() -> "PathwayConfig | None":
    """The override active on THIS thread, if any — threads spawned on behalf
    of a worker (connector reader threads) must re-install it, since
    threading.local state does not inherit."""
    return getattr(_tls, "override", None)


def get_pathway_config() -> PathwayConfig:
    override = getattr(_tls, "override", None)
    if override is not None:
        return override
    return PathwayConfig.from_env()
