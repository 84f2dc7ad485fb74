"""Metadata filtering for index queries.

A copy of ``pathway_tpu/stdlib/indexing/filters.py``: the jmespath subset the
xpack templates use — ``field == 'value'``, ``contains(field, 'x')``,
``globmatch('pat', path)``, boolean &&/||/!, parenthesization — over Json
metadata.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any

from pathway_tpu_torch.internals.json import Json


def _resolve(data: Any, path: str) -> Any:
    if isinstance(data, Json):
        data = data.value
    if data is None:
        return None
    cur = data
    for part in path.split("."):
        part = part.strip().strip("`")
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur


_TOKENIZER = re.compile(
    r"\s*(?:(?P<lp>\()|(?P<rp>\))|(?P<comma>,)|(?P<and>&&)|(?P<or>\|\|)|(?P<not>!)"
    r"|(?P<op>==|!=|>=|<=|>|<)|(?P<str>'(?:\\'|[^'])*'|`[^`]*`)|(?P<num>-?\d+(?:\.\d+)?)"
    r"|(?P<fn>[a-zA-Z_][\w]*\s*\()|(?P<id>[a-zA-Z_][\w.]*))"
)


class _FilterParser:
    def __init__(self, text: str):
        self.tokens: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKENIZER.match(text, pos)
            if m is None:
                if text[pos:].strip() == "":
                    break
                raise ValueError(f"bad filter near {text[pos:]!r}")
            kind = m.lastgroup
            self.tokens.append((kind, m.group().strip()))
            pos = m.end()
        self.pos = 0

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def parse(self) -> Any:
        return self.parse_or()

    def parse_or(self) -> Any:
        left = self.parse_and()
        while self.peek() and self.peek()[0] == "or":
            self.next()
            right = self.parse_and()
            left = ("or", left, right)
        return left

    def parse_and(self) -> Any:
        left = self.parse_not()
        while self.peek() and self.peek()[0] == "and":
            self.next()
            right = self.parse_not()
            left = ("and", left, right)
        return left

    def parse_not(self) -> Any:
        if self.peek() and self.peek()[0] == "not":
            self.next()
            return ("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self) -> Any:
        left = self.parse_atom()
        if self.peek() and self.peek()[0] == "op":
            op = self.next()[1]
            right = self.parse_atom()
            return ("cmp", op, left, right)
        return left

    def parse_atom(self) -> Any:
        kind, text = self.next()
        if kind == "lp":
            inner = self.parse()
            self.next()  # rp
            return inner
        if kind == "str":
            return ("lit", text[1:-1].replace("\\'", "'"))
        if kind == "num":
            return ("lit", float(text) if "." in text else int(text))
        if kind == "fn":
            name = text[:-1].strip()
            args = []
            while True:
                nxt = self.peek()
                if nxt is None or nxt[0] == "rp":
                    if nxt:
                        self.next()
                    break
                args.append(self.parse())
                if self.peek() and self.peek()[0] == "comma":
                    self.next()
            return ("fn", name, args)
        if kind == "id":
            return ("path", text)
        raise ValueError(f"unexpected token {text!r}")


def _eval(node: Any, data: Any) -> Any:
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "path":
        return _resolve(data, node[1])
    if kind == "cmp":
        _, op, l, r = node
        lv, rv = _eval(l, data), _eval(r, data)
        try:
            return {
                "==": lv == rv,
                "!=": lv != rv,
                ">": lv > rv,
                ">=": lv >= rv,
                "<": lv < rv,
                "<=": lv <= rv,
            }[op]
        except TypeError:
            return False
    if kind == "and":
        return bool(_eval(node[1], data)) and bool(_eval(node[2], data))
    if kind == "or":
        return bool(_eval(node[1], data)) or bool(_eval(node[2], data))
    if kind == "not":
        return not bool(_eval(node[1], data))
    if kind == "fn":
        _, name, args = node
        vals = [_eval(a, data) for a in args]
        if name == "contains":
            hay, needle = vals[0], vals[1]
            try:
                return needle in hay
            except TypeError:
                return False
        if name == "globmatch":
            pattern, value = vals[0], vals[1]
            return fnmatch.fnmatch(str(value or ""), str(pattern))
        if name == "starts_with":
            return str(vals[1] or "").startswith(str(vals[0]))
        raise ValueError(f"unsupported filter function {name!r}")
    raise ValueError(f"bad filter node {node!r}")


def matches_filter(metadata: Any, filter_expr: Any) -> bool:
    """True when metadata passes the filter; filters on absent metadata fail closed."""
    if filter_expr is None:
        return True
    if callable(filter_expr):
        return bool(filter_expr(metadata))
    tree = _FilterParser(str(filter_expr)).parse()
    return bool(_eval(tree, metadata))
