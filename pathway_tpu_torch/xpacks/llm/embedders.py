"""Embedders (port of ``pathway_tpu/xpacks/llm/embedders.py``).

``BaseEmbedder`` is a UDF that knows its output width: an embedder with a
known width (``_dimension``) answers ``get_embedding_dimension`` without an
encode; the others embed ``"."`` once. ``SentenceTransformerEmbedder`` is
the local encoder: ``embedder(column)`` is a
``BatchApplyExpression`` over ``EmbedPipeline.encode_batch``, so a commit's
whole batch of texts crosses to the card in one pipeline call (at most
``batch_size`` rows per call). ``device_expression(column)`` is the query
path: ``EmbedPipeline.embed_query_rows`` (content cache, semantic cache,
then the coalescer shim in front of the encoder service), whose misses are
rows of a device tensor, so the index search chains on without a host
round trip. ``OpenAIEmbedder``, ``LiteLLMEmbedder`` and ``GeminiEmbedder``
are async UDFs (capacity, retries, cache) that import their client package
when they are called (``_utils.import_client``): the GPU machine has none.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.udfs import (
    AsyncRetryStrategy,
    CacheStrategy,
    UDF,
    async_executor,
)
from pathway_tpu_torch.models.embed_pipeline import EmbedPipeline
from pathway_tpu_torch.models.encoder import EncoderConfig, TorchSentenceEncoder
from pathway_tpu_torch.xpacks.llm._utils import close_async_client, import_client


class BaseEmbedder(UDF):
    # an embedder that knows its output width sets this, so that building a
    # graph never pays an encode of "." (for the API embedders a network
    # call per index)
    _dimension: int | None = None

    def get_embedding_dimension(self, **kwargs: Any) -> int:
        if self._dimension is not None and not kwargs:
            return int(self._dimension)
        result = self.func(".", **kwargs)  # type: ignore[misc]
        import asyncio

        if asyncio.iscoroutine(result):
            result = asyncio.run(result)
        return len(result)


# output widths of the fixed-width API models, read when a graph is built
_KNOWN_EMBED_DIMS = {
    "text-embedding-3-small": 1536,
    "text-embedding-3-large": 3072,
    "text-embedding-ada-002": 1536,
    "models/embedding-001": 768,
    "models/text-embedding-004": 768,
}


def _known_dim(model: str | None) -> int | None:
    if model is None:
        return None
    # litellm routes as "provider/model": the tail matches too
    return _KNOWN_EMBED_DIMS.get(model) or _KNOWN_EMBED_DIMS.get(model.rsplit("/", 1)[-1])


class SentenceTransformerEmbedder(BaseEmbedder):
    """Local sentence encoder on the card (``device="cpu"`` for tests).

    Weights come from ``params`` (a ``state_dict``, e.g. from
    ``models.encoder.params_from_jax``) or, without one, from a seeded random
    init; nothing is downloaded. ``sub_batch``: rows per length-sorted ingest
    sub-batch; ``embed_cache_size``: content-hash LRU entries (0 disables);
    ``max_wait_ms`` / ``max_coalesce_batch``: the deadline coalescer's window
    (used with the encoder service off); ``encoder_service``: the
    continuously-batched encoder worker on the query path (None =
    ``PATHWAY_ENCSVC``, on); ``semantic_cache``: ``exact`` / ``cosine`` /
    ``off`` (None = ``PATHWAY_ENCSVC_SEMANTIC``, exact) with
    ``semantic_cache_size`` / ``semantic_threshold``; ``encsvc_tick_ms`` /
    ``encsvc_max_in_flight`` / ``encsvc_prewarm``: the service's idle poll
    bound, rows per tick and bucket pre-warm (None =
    ``PATHWAY_ENCSVC_TICK_MS`` / ``_MAX_INFLIGHT`` / ``_PREWARM``)."""

    def __init__(
        self,
        model: str = "sentence-transformers/all-MiniLM-L6-v2",
        *,
        device: Any = None,
        batch_size: int = 1024,
        max_wait_ms: float = 2.0,
        max_coalesce_batch: int = 256,
        sub_batch: int = 128,
        embed_cache_size: int = 50_000,
        encoder_config: EncoderConfig | None = None,
        encoder_service: "bool | None" = None,
        semantic_cache: "str | None" = None,
        semantic_cache_size: "int | None" = None,
        semantic_threshold: "float | None" = None,
        encsvc_tick_ms: "float | None" = None,
        encsvc_max_in_flight: "int | None" = None,
        encsvc_prewarm: "bool | None" = None,
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
            self.encoder,
            model=model,
            max_wait_ms=max_wait_ms,
            max_batch=max_coalesce_batch,
            sub_batch=sub_batch,
            cache_size=embed_cache_size,
            service_mode=encoder_service,
            semantic_mode=semantic_cache,
            semantic_size=semantic_cache_size,
            semantic_threshold=semantic_threshold,
            tick_ms=encsvc_tick_ms,
            max_in_flight=encsvc_max_in_flight,
            prewarm=encsvc_prewarm,
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
        """Query-path variant through ``EmbedPipeline.embed_query_rows``: the
        content and semantic caches, then the coalescer shim and the encoder
        service, whose rows stay on the device. Declared non-deterministic,
        so the engine memoizes each query row's embedding and replays it when
        the row retracts (the REST connector's completed-query cleanup): a
        retraction never reaches the caches or the encoder."""
        pipeline = self.pipeline

        def embed_batch(texts: List[str]) -> List[Any]:
            return pipeline.embed_query_rows([str(t) for t in texts])

        return expr.BatchApplyExpression(
            embed_batch, np.ndarray, False, False, args, kwargs, max_batch_size=self.batch_size
        )

    def embed_queries(self, texts: List[str]) -> torch.Tensor:
        """(n, dim) float32 query embeddings left on the device, straight
        from the encoder (no cache, no service)."""
        return self.encoder.encode_device([str(t) for t in texts]).float()

    def pipeline_stats(self) -> dict:
        """Cache, coalescer, semantic-cache, service and pad-waste counters
        (``/v1/statistics`` carries them)."""
        return self.pipeline.stats()

    def get_embedding_dimension(self, **kwargs: Any) -> int:
        return self.encoder.dim


class OpenAIEmbedder(BaseEmbedder):
    """The OpenAI embeddings API; ``openai`` is imported when called."""

    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = "text-embedding-3-small",
        retry_strategy: AsyncRetryStrategy | None = None,
        cache_strategy: CacheStrategy | None = None,
        api_key: str | None = None,
        **openai_kwargs: Any,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity),
            retry_strategy=retry_strategy,
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(openai_kwargs)
        # an explicit ``dimensions=`` (v3 models) wins, else the model table
        if "dimensions" in self.kwargs:
            self._dimension = int(self.kwargs["dimensions"])
        else:
            self._dimension = _known_dim(model)
        self.api_key = api_key
        self._client: Any = None
        self._client_loop: Any = None

        async def embed(input: str, **kwargs: Any) -> list:
            import asyncio

            # a client's connection pool is bound to its loop, and each
            # commit's batch runs on a loop of its own: one client per loop
            loop = asyncio.get_running_loop()
            if self._client is None or self._client_loop is not loop:
                openai = import_client("openai", "openai client library is not installed")
                await close_async_client(self._client)
                self._client = openai.AsyncOpenAI(api_key=self.api_key)
                self._client_loop = loop
            response = await self._client.embeddings.create(
                input=[input or "."], model=kwargs.get("model", self.model), **self.kwargs
            )
            return response.data[0].embedding

        self.func = embed


class LiteLLMEmbedder(BaseEmbedder):
    """LiteLLM's multi-provider embeddings; ``litellm`` is imported when called."""

    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        cache_strategy: CacheStrategy | None = None,
        **litellm_kwargs: Any,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity),
            retry_strategy=retry_strategy,
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(litellm_kwargs)
        if "dimensions" in self.kwargs:
            self._dimension = int(self.kwargs["dimensions"])
        else:
            self._dimension = _known_dim(model)

        async def embed(input: str, **kwargs: Any) -> list:
            litellm = import_client("litellm", "litellm is not installed")
            response = await litellm.aembedding(
                input=[input or "."], model=kwargs.get("model", self.model), **self.kwargs
            )
            return response.data[0]["embedding"]

        self.func = embed


class GeminiEmbedder(BaseEmbedder):
    """Google Gemini embeddings; ``google.generativeai`` is imported when called."""

    def __init__(
        self,
        model: str | None = "models/embedding-001",
        capacity: int | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        cache_strategy: CacheStrategy | None = None,
        **genai_kwargs: Any,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity),
            retry_strategy=retry_strategy,
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(genai_kwargs)
        if "output_dimensionality" in self.kwargs:
            self._dimension = int(self.kwargs["output_dimensionality"])
        else:
            self._dimension = _known_dim(model)

        async def embed(input: str, **kwargs: Any) -> list:
            genai = import_client("google.generativeai", "google-generativeai is not installed")
            response = genai.embed_content(
                content=input or ".", model=kwargs.get("model", self.model), **self.kwargs
            )
            return response["embedding"]

        self.func = embed
