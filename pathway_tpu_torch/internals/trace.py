"""User-frame trace capture for operator errors (port of ``pathway_tpu/internals/trace.py``).

Every operator remembers the user code line that built it, so an engine
error during a run points at the user's pipeline code
(``EngineErrorWithTrace``), not at framework internals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class Frame:
    filename: str
    line_number: int | None
    line: str | None
    function: str


_FRAMEWORK_DIRS = tuple(
    f"pathway_tpu_torch/{d}"
    for d in ("internals", "io", "stdlib", "debug", "engine", "xpacks")
)


def _is_external_path(filename: str) -> bool:
    normalized = filename.replace("\\", "/")
    if "tests/test_" in normalized:
        return True
    return all(pattern not in normalized for pattern in _FRAMEWORK_DIRS)


def capture_user_frame() -> Optional[Frame]:
    """The innermost stack frame of user code (not the framework's).

    Walks raw frames and reads the source of the one matched frame only:
    this runs on every operator creation."""
    import linecache
    import sys

    frame = sys._getframe(1)
    while frame is not None:
        filename = frame.f_code.co_filename
        if _is_external_path(filename):
            lineno = frame.f_lineno
            return Frame(
                filename=filename,
                line_number=lineno,
                line=linecache.getline(filename, lineno).rstrip() or None,
                function=frame.f_code.co_name,
            )
        frame = frame.f_back
    return None


class EngineErrorWithTrace(Exception):
    """An operator's failure, annotated with the user line that built the operator."""

    def __init__(self, cause: BaseException, operator: str, frame: Optional[Frame]):
        self.cause = cause
        self.operator = operator
        self.user_frame = frame
        if frame is not None:
            location = (
                f"\noccurred in operator {operator!r} defined at "
                f"{frame.filename}:{frame.line_number}"
            )
            if frame.line:
                location += f"\n    {frame.line.strip()}"
        else:
            location = f"\noccurred in operator {operator!r}"
        super().__init__(f"{type(cause).__name__}: {cause}{location}")


def add_error_context(exc: BaseException, node: Any) -> BaseException:
    """Wrap ``exc`` with the node's creation trace (no-op if already wrapped)."""
    if isinstance(exc, EngineErrorWithTrace):
        return exc
    return EngineErrorWithTrace(exc, getattr(node, "name", node.kind), getattr(node, "user_frame", None))
