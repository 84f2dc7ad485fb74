"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``pathway_tpu_torch/csrc/`` has a plain C interface.
On first use it is compiled with ``nvcc`` for ``sm_90a`` into
``pathway_tpu_torch/_build/``, keyed by a hash of the source and the flags,
and loaded with ``ctypes``. Nothing is compiled at import time: the CPU test
machines have no ``nvcc``. A build or load error raises; there is no fallback.

``KERNEL_LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

KERNEL_LAUNCHES: Dict[str, int] = {}
# nvcc's output of the builds made by this process (``-Xptxas -v``: registers,
# shared memory and spills of every kernel), by source
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    KERNEL_LAUNCHES[name] = KERNEL_LAUNCHES.get(name, 0) + 1


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU machine")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def _compile_cmd(source: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, source)]


def build_all(sources: Sequence[str]) -> Dict[str, float]:
    """Compile every source that is not built yet, one ``nvcc`` each, all
    started together. Returns seconds per source (0.0 when cached)."""
    import time

    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = _lib_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[src] = (
            subprocess.Popen(
                _compile_cmd(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
            tmp,
            out,
        )
    took = {src: 0.0 for src in sources}
    errors = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        BUILD_LOGS[src] = log.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {src}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build_all([source])
            lib = ctypes.CDLL(_lib_path(source))
            _LIBS[source] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")
