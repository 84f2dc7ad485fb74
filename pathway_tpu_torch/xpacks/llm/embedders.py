"""Embedders (port of ``pathway_tpu/xpacks/llm/embedders.py``: the local encoder)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pathway_tpu_torch.models.embed_pipeline import EmbedPipeline
from pathway_tpu_torch.models.encoder import EncoderConfig, TorchSentenceEncoder


class SentenceTransformerEmbedder:
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
    ):
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

    def __call__(self, texts: List[str]) -> np.ndarray:
        """Ingest path: (n, dim) float32 host embeddings, ``batch_size`` rows
        per pipeline call."""
        parts = [
            self.pipeline.encode_batch([str(t) for t in texts[i : i + self.batch_size]])
            for i in range(0, len(texts), self.batch_size)
        ]
        if not parts:
            return np.zeros((0, self.encoder.dim), dtype=np.float32)
        return np.concatenate(parts)

    def embed_queries(self, texts: List[str]) -> torch.Tensor:
        """Query path: (n, dim) float32 embeddings left on the device, so the
        index search chains on without a host round trip."""
        return self.encoder.encode_device([str(t) for t in texts]).float()

    def pipeline_stats(self) -> dict:
        return self.pipeline.stats()

    def get_embedding_dimension(self, **kwargs: Any) -> int:
        return self.encoder.dim
