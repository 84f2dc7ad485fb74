"""Rerankers (port of ``pathway_tpu/xpacks/llm/rerankers.py``).

``EncoderReranker`` scores a (doc, query) pair by the dot product of their
embeddings from the port's ``TorchSentenceEncoder`` (unit rows, so the
cosine), on the card unless ``device="cpu"``; a commit's pairs are embedded
in one encoder call. ``LLMReranker`` asks a chat model for a 1-5 rating;
``rerank_topk_filter`` keeps the top k of a (docs, scores) pair of tuples.
``CrossEncoderReranker`` imports ``sentence_transformers`` when it is built,
as the reference's does (the GPU machine has no such package).
"""

from __future__ import annotations

import re
from typing import Any, List

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.xpacks.llm import prompts
from pathway_tpu_torch.xpacks.llm._utils import import_client
from pathway_tpu_torch.xpacks.llm.llms import BaseChat


class LLMReranker(UDF):
    """Query / doc relevance 1-5 from a chat model; a reply without a digit
    1-5 scores 1."""

    def __init__(
        self,
        llm: BaseChat,
        *,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
        use_logit_bias: bool | None = None,
    ):
        super().__init__(cache_strategy=cache_strategy)
        self.llm = llm

        def rerank(doc: str, query: str) -> float:
            raise RuntimeError("LLMReranker is applied via __call__, not func")

        self.func = rerank

    def __call__(self, doc: Any, query: Any, **kwargs: Any) -> expr.ColumnExpression:
        prompt = expr.apply_with_type(
            lambda d, q: Json([{"role": "user", "content": prompts.rerank_prompt(d, q)}]),
            dt.JSON,
            doc,
            query,
        )
        raw = self.llm(prompt)

        def parse_score(response: Any) -> float:
            m = re.search(r"[1-5]", str(response))
            return float(m.group()) if m else 1.0

        return expr.apply_with_type(parse_score, float, raw)


class CrossEncoderReranker(UDF):
    """A ``sentence_transformers`` CrossEncoder, imported when built."""

    def __init__(self, model_name: str, *, cache_strategy: Any = None, **init_kwargs: Any):
        super().__init__(cache_strategy=cache_strategy)
        import os

        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        cross_encoder = import_client("sentence_transformers").CrossEncoder
        self.model = cross_encoder(model_name, **init_kwargs)

        def rerank(doc: str, query: str) -> float:
            return float(self.model.predict((query, doc)))

        self.func = rerank


class EncoderReranker(UDF):
    """Bi-encoder scoring on the port's encoder. ``init_kwargs`` go to
    ``TorchSentenceEncoder`` (``config``, ``params``, ``seed``, ``device``,
    ...): without ``params`` the weights are a seeded random init."""

    def __init__(
        self,
        model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
        *,
        cache_strategy: Any = None,
        **init_kwargs: Any,
    ):
        super().__init__(cache_strategy=cache_strategy)
        from pathway_tpu_torch.models.encoder import TorchSentenceEncoder

        self.encoder = TorchSentenceEncoder(model_name, **init_kwargs)

        def rerank(doc: str, query: str) -> float:
            vectors = self.encoder.encode([str(doc), str(query)])
            return float(np.dot(vectors[0], vectors[1]))

        self.func = rerank

    def score_batch(self, docs: List[Any], queries: List[Any]) -> List[float]:
        """One encoder call for the distinct texts of the batch, then each
        pair's dot product on the encoder's device."""
        texts = list(dict.fromkeys(str(t) for t in [*docs, *queries]))
        where = {t: i for i, t in enumerate(texts)}
        vecs = self.encoder.encode_device(texts).float()
        d = vecs[[where[str(t)] for t in docs]]
        q = vecs[[where[str(t)] for t in queries]]
        return [float(x) for x in (d * q).sum(dim=1).cpu().numpy()]

    def __call__(self, doc: Any, query: Any, **kwargs: Any) -> expr.ColumnExpression:
        if self.cache_strategy is not None:  # the cache is per pair
            return super().__call__(doc, query, **kwargs)
        return expr.BatchApplyExpression(self.score_batch, float, False, True, (doc, query), {})


def rerank_topk_filter(
    doc: expr.ColumnExpression, score: expr.ColumnExpression, k: int = 5
) -> expr.ColumnExpression:
    """The top k of (docs, scores) tuple columns, by score descending."""

    def topk(docs: tuple, scores: tuple) -> tuple:
        order = np.argsort(-np.asarray(scores, dtype=np.float64))[:k]
        return (
            tuple(docs[i] for i in order),
            tuple(float(scores[i]) for i in order),
        )

    return expr.apply_with_type(topk, tuple, doc, score)
