"""Document parsers (port of ``pathway_tpu/xpacks/llm/parsers.py``, UTF-8 only).

A parser is a UDF: ``parser(column)`` is the column expression mapping each
document's ``data`` to a list of ``(text, metadata)`` pairs.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.udfs import UDF


class ParseUtf8(UDF):
    """bytes/str → [(text, {})]."""

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)

        def parse(contents: Any) -> list:
            if isinstance(contents, bytes):
                text = contents.decode("utf-8", errors="replace")
            else:
                text = str(contents)
            return [(text, {})]

        self.func = parse


Utf8Parser = ParseUtf8
