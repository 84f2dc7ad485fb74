"""Document parsers (port of ``pathway_tpu/xpacks/llm/parsers.py``, UTF-8 only).

A parser is a plain callable object whose ``.func`` maps one document's
``data`` to a list of ``(text, metadata)`` pairs.
"""

from __future__ import annotations

from typing import Any


class ParseUtf8:
    """bytes/str → [(text, {})]."""

    def __init__(self) -> None:
        def parse(contents: Any) -> list:
            if isinstance(contents, bytes):
                text = contents.decode("utf-8", errors="replace")
            else:
                text = str(contents)
            return [(text, {})]

        self.func = parse

    def __call__(self, contents: Any) -> list:
        return self.func(contents)

