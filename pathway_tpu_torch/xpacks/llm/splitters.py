"""Text splitters (port of ``pathway_tpu/xpacks/llm/splitters.py``).

A splitter is a UDF: ``splitter(text, metadata)`` is the column expression
mapping each text to a list of ``(chunk, metadata)`` pairs. Tokens are whitespace words: the
reference uses tiktoken only when its BPE files are already on disk and falls
back to the same whitespace codec otherwise; the port never fetches them.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.udfs import UDF


def _encode(text: str) -> list:
    return text.split()


def _decode(tokens: list) -> str:
    return " ".join(tokens)


class TokenCountSplitter(UDF):
    """Split text into chunks of [min_tokens, max_tokens] tokens, preferring
    sentence boundaries."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        # kept for the reference's API; the codec is whitespace words
        # whatever the name (see the module docstring)
        self.encoding_name = encoding_name

        def split(txt: str, metadata: Any = None) -> list:
            tokens = _encode(str(txt))
            meta = metadata if metadata is not None else {}
            output: list = []
            i = 0
            while i < len(tokens):
                window = tokens[i : i + self.max_tokens]
                chunk = _decode(window)
                cut_chars = len(chunk)
                n_consumed = len(window)
                if i + self.max_tokens < len(tokens):
                    min_chars = len(_decode(window[: self.min_tokens]))
                    for punct in (". ", "\n\n", "\n", "; ", ", ", " "):
                        pos = chunk.rfind(punct)
                        if pos > min_chars:
                            cut_chars = pos + len(punct)
                            n_consumed = max(1, len(_encode(chunk[:cut_chars])))
                            break
                piece = chunk[:cut_chars].strip()
                if piece:
                    output.append((piece, meta))
                i += n_consumed
            return output or [("", meta)]

        self.func = split


class NullSplitter(UDF):
    """Pass the document through as a single chunk."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)

        def split(txt: str, metadata: Any = None) -> list:
            return [(str(txt), metadata if metadata is not None else {})]

        self.func = split
