"""The native host module (port of ``pathway_tpu/native/__init__.py``).

``pathway_tpu_torch/csrc/pathway_native.cc`` holds the engine's host-side hot
loops in C++: typed key hashing with the module's own XXH3-128, the
``KeyIndex`` / ``MultiMap`` tables, the fused join-side passes and the DSV
parser. On first use it is compiled with ``g++`` into
``pathway_tpu_torch/_build/``, keyed by a hash of the source, the flags, the
Python ABI and the host CPU (``-march=native`` ties the library to the CPU it
was built on), and loaded with ``ctypes.PyDLL``: every call holds the GIL,
which the pyobject column kind needs.

Without a compiler, or with ``PATHWAY_TPU_DISABLE_NATIVE`` set, ``get_lib()``
returns None and the engine runs its Python versions of the same functions.
A failed build is never silent: ``BUILD_ERROR`` holds the compiler's message
and ``require_lib()`` raises it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
import time
from typing import Any, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pathway_native.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")

# what the last build or load of this process did: the library's path, the
# seconds its compile took (0.0 when it was built already), the compiler's
# version line, and the compiler's message when the build failed
BUILD_INFO: dict = {}
BUILD_ERROR: Optional[str] = None

# pointer types of the C interface's arrays
U64P = ctypes.POINTER(ctypes.c_uint64)
I64P = ctypes.POINTER(ctypes.c_int64)
U8P = ctypes.POINTER(ctypes.c_uint8)

_lib: Optional[ctypes.PyDLL] = None
_tried = False
_LOCK = threading.Lock()


def disabled() -> bool:
    return bool(os.environ.get("PATHWAY_TPU_DISABLE_NATIVE"))


def _python_include() -> str:
    return sysconfig.get_paths()["include"]


def _host_cpu() -> bytes:
    """The CPU's model and feature flags (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [
                ln for ln in f.read().splitlines()
                if ln.startswith((b"model name", b"flags", b"Features"))
            ]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return os.uname().machine.encode()


def lib_path() -> str:
    """Where this source, these flags, this Python and this CPU build to."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(str(sysconfig.get_config_var("SOABI") or sys.version).encode())
    h.update(_host_cpu())
    return os.path.join(BUILD_DIR, f"libpathway_native_{h.hexdigest()[:16]}.so")


def compile_cmd(out: str) -> List[str]:
    return [CXX, *CXX_FLAGS, f"-I{_python_include()}", SOURCE, "-o", out]


def _compiler_version() -> str:
    try:
        out = subprocess.run([CXX, "--version"], capture_output=True, text=True, timeout=30)
        return out.stdout.splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _build() -> Optional[str]:
    """The library's path, compiling it when it is not built yet; None, with
    ``BUILD_ERROR`` set, when the compiler is missing or fails."""
    global BUILD_ERROR
    out = lib_path()
    python_h = os.path.join(_python_include(), "Python.h")
    BUILD_INFO.update(
        path=out, build_s=0.0, python_h=python_h if os.path.exists(python_h) else None,
        compiler=_compiler_version(),
    )
    if os.path.exists(out):
        return out
    if BUILD_INFO["python_h"] is None:
        BUILD_ERROR = f"{python_h} not found: the pyobject column kind needs it"
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # per process: test workers build side by side
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(compile_cmd(tmp), capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        BUILD_ERROR = f"{CXX} could not run: {exc}"
        return None
    if proc.returncode != 0:
        BUILD_ERROR = f"{CXX} failed ({proc.returncode}):\n{proc.stderr}"
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    # the path names the content, so a rebuilt source never reuses a path that
    # glibc's dlopen may have cached
    os.replace(tmp, out)
    BUILD_INFO["build_s"] = time.perf_counter() - t0
    return out


def get_lib() -> Optional[ctypes.PyDLL]:
    """The native library, built on first use; None when it is disabled or
    cannot be built (``BUILD_ERROR`` says why)."""
    global _lib, _tried, BUILD_ERROR
    if disabled():
        return None
    if _tried:
        return _lib
    with _LOCK:
        if _tried:
            return _lib
        path = _build()
        if path is not None:
            try:
                _lib = _bind(ctypes.PyDLL(path))
            except OSError as exc:
                BUILD_ERROR = f"loading {path} failed: {exc}"
        _tried = True
    return _lib


def require_lib() -> ctypes.PyDLL:
    """The native library, or an error carrying the compiler's message."""
    if disabled():
        raise RuntimeError("the native module is disabled by PATHWAY_TPU_DISABLE_NATIVE")
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native module did not build: {BUILD_ERROR}")
    return lib


def _bind(lib: ctypes.PyDLL) -> ctypes.PyDLL:
    vp = ctypes.c_void_p
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    u64p, i64p, u8p = U64P, I64P, U8P
    pyo = ctypes.py_object
    sigs = {
        "pwtpu_hash_typed": ([vp, i32, u64, ctypes.c_char_p, u64, pyo, pyo, u64p, u64p], i64),
        "pwtpu_hash_upsert": (
            [vp, i32, u64, ctypes.c_char_p, u64, pyo, pyo, vp, u64p, u64p, i64p, u8p], i64,
        ),
        "pwtpu_hash_serialized": ([ctypes.c_char_p, u64p, u64, u64p, u64p], None),
        "pwtpu_sequential_keys": ([ctypes.c_char_p, u64, i64, u64, u64p, u64p], None),
        "pwtpu_split_dsv": (
            [ctypes.c_char_p, u64, ctypes.c_char, ctypes.c_char_p, u64p, u64p, u8p, u64p, u64p],
            u64,
        ),
        "pwtpu_parse_dsv_rows": (
            [ctypes.c_char_p, u64, ctypes.c_char, pyo, ctypes.POINTER(i32), i32, pyo], pyo,
        ),
        "pwtpu_combine_keys": ([u64p, u64p, u8p, u8p, i64, u64, u64p], None),
        "pwtpu_idx_new": ([u64], vp),
        "pwtpu_idx_free": ([vp], None),
        "pwtpu_idx_len": ([vp], i64),
        "pwtpu_idx_slot_bound": ([vp], i64),
        "pwtpu_idx_upsert": ([vp, u64p, i64, i64p, u8p], None),
        "pwtpu_idx_lookup": ([vp, u64p, i64, i64p], None),
        "pwtpu_idx_remove": ([vp, u64p, i64, i64p], None),
        "pwtpu_idx_items": ([vp, u64p, i64p], None),
        "pwtpu_idx_restore": ([vp, u64p, i64p, i64, i64], None),
        "pwtpu_mm_new": ([], vp),
        "pwtpu_mm_free": ([vp], None),
        "pwtpu_mm_total": ([vp], i64),
        "pwtpu_mm_insert": ([vp, u64p, i64p, i64], None),
        "pwtpu_mm_remove": ([vp, u64p, i64p, i64, u8p], None),
        "pwtpu_mm_count": ([vp, u64p, i64, i64p], i64),
        "pwtpu_mm_fill": ([vp, u64p, i64, i64p], None),
        "pwtpu_mm_items": ([vp, u64p, i64p], None),
        "pwtpu_side_insert": ([vp, vp, u64p, u64p, i64, u64p, u64p, i64p], None),
        "pwtpu_side_remove": ([vp, vp, u64p, i64, u64p, i64p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


class PwCol(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("data", ctypes.c_void_p),
        ("offsets", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
    ]


def split_dsv(data: bytes, delimiter: str = ",") -> "list[list[str]] | None":
    """DSV content split into rows of string fields natively; None when the
    library is unavailable. Double-quote quoting with "" escapes, CRLF and
    bare CR line ends, as the csv module reads them."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    n = len(data)
    needed_bytes = ctypes.c_uint64()
    needed_fields = ctypes.c_uint64()
    delim = delimiter.encode()[:1]
    nrows = lib.pwtpu_split_dsv(
        data, n, delim, None, None, None, None,
        ctypes.byref(needed_bytes), ctypes.byref(needed_fields),
    )
    if nrows == 0:
        return []
    field_buf = ctypes.create_string_buffer(max(needed_bytes.value, 1))
    offsets = np.zeros(needed_fields.value + 1, dtype=np.uint64)
    counts = np.zeros(nrows, dtype=np.uint64)
    lib.pwtpu_split_dsv(
        data, n, delim, field_buf,
        offsets.ctypes.data_as(U64P), counts.ctypes.data_as(U64P),
        None, None, None,
    )
    raw = field_buf.raw
    off = offsets.tolist()
    rows: list[list[str]] = []
    f = 0
    for k in counts.tolist():
        rows.append([raw[off[f + j] : off[f + j + 1]].decode("utf-8", "replace") for j in range(k)])
        f += k
    return rows


def parse_dsv_rows(
    data: bytes, selected: "list[tuple[str, int]]", delimiter: str, error_obj: Any
) -> "list[dict] | None":
    """The fused native DSV parse: a list of row dicts; None when the library
    is unavailable or the delimiter is not one byte.

    ``selected``: (column name, tag) pairs, tag 0=str 1=int 2=float 3=bool.
    Names resolve against the file's split header row; a wanted column absent
    from it is left out of the rows, as ``csv.DictReader``'s are. A malformed
    typed field is ``error_obj``."""
    lib = get_lib()
    if lib is None or len(delimiter.encode()) != 1:
        return None
    tags = (ctypes.c_int32 * len(selected))(*[tag for _name, tag in selected])
    names = tuple(name for name, _tag in selected)
    return lib.pwtpu_parse_dsv_rows(
        data, len(data), delimiter.encode(), names, tags, len(selected), error_obj
    )
