"""Fuzzy joins over token features (port of
``pathway_tpu/stdlib/ml/smart_table_ops/_fuzzy_join.py``).

Rows tokenize into (node, token) feature edges (``flatten``); a token weighs
by its corpus count (the normalization); a candidate pair scores the summed
weight of the tokens it shares, through a token equijoin and a groupby; and
the matching keeps the mutual-best pairs: a pair survives when it is the
heaviest candidate of both its left and its right node. Host relational
operators of the engine only.
"""

from __future__ import annotations

import math
import re
from enum import IntEnum
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.expression import apply_with_type
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = 0
    WORDS = 1
    LETTERS = 2
    TRIGRAMS = 3

    @property
    def generate(self) -> Callable[[Any], list]:
        return {
            FuzzyJoinFeatureGeneration.AUTO: _tokenize_words,
            FuzzyJoinFeatureGeneration.WORDS: _tokenize_words,
            FuzzyJoinFeatureGeneration.LETTERS: _tokenize_letters,
            FuzzyJoinFeatureGeneration.TRIGRAMS: _tokenize_trigrams,
        }[self]


class FuzzyJoinNormalization(IntEnum):
    NONE = 0
    INVERSE_COUNT = 1
    LOG_INVERSE = 2

    def weight(self, cnt: float) -> float:
        if self is FuzzyJoinNormalization.NONE:
            return 1.0
        if self is FuzzyJoinNormalization.INVERSE_COUNT:
            return 1.0 / max(cnt, 1.0)
        return 1.0 / max(math.log2(max(cnt, 1.0)) + 1.0, 1.0)


def _tokenize_words(obj: Any) -> list:
    return [w.lower() for w in re.findall(r"\w+", str(obj))]


def _tokenize_letters(obj: Any) -> list:
    return [c.lower() for c in str(obj) if not c.isspace()]


def _tokenize_trigrams(obj: Any) -> list:
    s = str(obj).lower()
    return [s[i : i + 3] for i in range(max(1, len(s) - 2))]


def _token_edges(col: expr.ColumnReference, generation: FuzzyJoinFeatureGeneration) -> Table:
    """The (node, token) edges of one side."""
    tokenize = generation.generate
    base = col.table.select(_fz_text=col)
    with_tokens = base.select(
        _fz_tokens=apply_with_type(lambda t: tuple(tokenize(t)), tuple, base._fz_text),
    )
    return with_tokens.flatten(this._fz_tokens, origin_id="node").select(
        token=this._fz_tokens, node=this.node
    )


def fuzzy_match(
    left_col: expr.ColumnReference,
    right_col: expr.ColumnReference,
    *,
    generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.AUTO,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.INVERSE_COUNT,
    _exclude_same_node: bool = False,
) -> Table:
    """Best-pair matching between two text columns: a table of ``left`` (a
    pointer into the left table), ``right`` (into the right table) and
    ``weight``, one row per mutual-best pair."""
    left_edges = _token_edges(left_col, generation)
    right_edges = _token_edges(right_col, generation)

    all_edges = left_edges.concat_reindex(right_edges)
    token_cnt = all_edges.groupby(this.token).reduce(this.token, cnt=reducers.count())
    norm = normalization
    token_weight = token_cnt.select(
        this.token, w=apply_with_type(lambda c: norm.weight(float(c)), float, this.cnt)
    )

    weighted_left = left_edges.join(
        token_weight, left_edges.token == token_weight.token
    ).select(left_edges.node, left_edges.token, token_weight.w)

    pair_scores = (
        weighted_left.join(right_edges, weighted_left.token == right_edges.token)
        .select(left=weighted_left.node, right=right_edges.node, w=weighted_left.w)
        .groupby(this.left, this.right)
        .reduce(this.left, this.right, weight=reducers.sum(this.w))
    )
    if _exclude_same_node:
        # self-matching: a row's heaviest candidate is itself, so identity
        # pairs go before the best pairs are chosen
        pair_scores = pair_scores.filter(
            apply_with_type(lambda l, r: l != r, bool, this.left, this.right)
        )

    best_left = pair_scores.groupby(this.left).reduce(this.left, best=reducers.max(this.weight))
    best_right = pair_scores.groupby(this.right).reduce(this.right, best=reducers.max(this.weight))
    with_left = pair_scores.join(best_left, pair_scores.left == best_left.left).select(
        pair_scores.left, pair_scores.right, pair_scores.weight, lbest=best_left.best
    )
    with_both = with_left.join(best_right, with_left.right == best_right.right).select(
        with_left.left, with_left.right, with_left.weight, with_left.lbest, rbest=best_right.best
    )
    return with_both.filter(
        (this.weight == this.lbest) & (this.weight == this.rbest)
    ).select(this.left, this.right, this.weight)


def fuzzy_self_match(
    col: expr.ColumnReference,
    *,
    generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.AUTO,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.INVERSE_COUNT,
) -> Table:
    """Mutual-best pairs within one column: each unordered pair once
    (left < right), no self-pairs."""
    matches = fuzzy_match(
        col, col, generation=generation, normalization=normalization, _exclude_same_node=True
    )
    return matches.filter(apply_with_type(lambda l, r: l < r, bool, this.left, this.right))


def _concat_row_text(table: Table) -> Table:
    cols = [table[c] for c in table.column_names()]
    return table.select(
        _fz_all=apply_with_type(lambda *vals: " ".join(str(v) for v in vals), str, *cols)
    )


def fuzzy_match_tables(
    left_table: Table,
    right_table: Table,
    *,
    left_projection: dict | None = None,
    right_projection: dict | None = None,
    generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.AUTO,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.INVERSE_COUNT,
) -> Table:
    """Match whole rows of two tables by the text of their columns joined;
    a projection ({column name: anything}) picks the columns of its side."""
    lt = left_table
    rt = right_table
    if left_projection:
        lt = left_table.select(*[left_table[c] for c in left_projection])
    if right_projection:
        rt = right_table.select(*[right_table[c] for c in right_projection])
    left_text = _concat_row_text(lt)
    right_text = _concat_row_text(rt)
    return fuzzy_match(
        left_text._fz_all, right_text._fz_all, generation=generation, normalization=normalization
    )


def smart_fuzzy_match(
    left_col: expr.ColumnReference,
    right_col: expr.ColumnReference,
    **kwargs: Any,
) -> Table:
    """The mutual-best matching of :func:`fuzzy_match`, as in the reference."""
    return fuzzy_match(left_col, right_col, **kwargs)
