"""Embedders (port of ``pathway_tpu/xpacks/llm/embedders.py``: the local encoder).

``SentenceTransformerEmbedder`` is a UDF: ``embedder(column)`` is a
``BatchApplyExpression`` over ``EmbedPipeline.encode_batch``, so a commit's
whole batch of texts crosses to the card in one pipeline call (at most
``batch_size`` rows per call). ``device_expression(column)`` is the query
path: its cells are rows of one device tensor, so the index search chains on
without a host round trip.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.models.embed_pipeline import EmbedPipeline
from pathway_tpu_torch.models.encoder import EncoderConfig, TorchSentenceEncoder


class SentenceTransformerEmbedder(UDF):
    """Local sentence encoder on the card (``device="cpu"`` for tests).

    Weights come from ``params`` (a ``state_dict``, e.g. from
    ``models.encoder.params_from_jax``) or, without one, from a seeded random
    init; nothing is downloaded. ``sub_batch``: rows per length-sorted ingest
    sub-batch; ``embed_cache_size``: content-hash LRU entries (0 disables)."""

    def __init__(
        self,
        model: str = "sentence-transformers/all-MiniLM-L6-v2",
        *,
        device: Any = None,
        batch_size: int = 1024,
        sub_batch: int = 128,
        embed_cache_size: int = 50_000,
        encoder_config: EncoderConfig | None = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        weights_dtype: str = "bfloat16",
        transfer_dtype: str = "float16",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.encoder = TorchSentenceEncoder(
            model,
            config=encoder_config,
            seed=seed,
            device=device,
            params=params,
            weights_dtype=weights_dtype,
            transfer_dtype=transfer_dtype,
        )
        self.device = self.encoder.device
        self.batch_size = batch_size
        self.pipeline = EmbedPipeline(
            self.encoder, model=model, sub_batch=sub_batch, cache_size=embed_cache_size
        )

        def embed_one(text: str) -> np.ndarray:
            return self.pipeline.encode_batch([str(text)])[0]

        self.func = embed_one

    def __call__(self, *args: Any, **kwargs: Any) -> expr.ColumnExpression:
        pipeline = self.pipeline

        def embed_batch(texts: List[str]) -> List[np.ndarray]:
            vectors = pipeline.encode_batch([str(t) for t in texts])
            return [vectors[i] for i in range(len(texts))]

        return expr.BatchApplyExpression(
            embed_batch, np.ndarray, False, True, args, kwargs, max_batch_size=self.batch_size
        )

    def device_expression(self, *args: Any, **kwargs: Any) -> expr.ColumnExpression:
        """Query-path variant: embedding cells are rows of a device tensor.
        Declared non-deterministic, so the engine memoizes each query row's
        embedding and replays it when the row retracts (the REST connector's
        completed-query cleanup) instead of running the encoder again."""

        def embed_batch(texts: List[str]) -> List[torch.Tensor]:
            return list(self.embed_queries(texts))

        return expr.BatchApplyExpression(
            embed_batch, np.ndarray, False, False, args, kwargs, max_batch_size=self.batch_size
        )

    def embed_queries(self, texts: List[str]) -> torch.Tensor:
        """(n, dim) float32 query embeddings left on the device."""
        return self.encoder.encode_device([str(t) for t in texts]).float()

    def pipeline_stats(self) -> dict:
        return self.pipeline.stats()

    def get_embedding_dimension(self, **kwargs: Any) -> int:
        return self.encoder.dim
