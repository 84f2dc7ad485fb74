"""Chat models (port of ``pathway_tpu/xpacks/llm/llms.py``).

``BaseChat`` is a UDF called on a messages column (a list of ``{role,
content}`` dicts, ``Json`` or a plain string). ``OpenAIChat``,
``LiteLLMChat``, ``CohereChat`` (async UDFs with capacity, retries and a
cache) and ``HFPipelineChat`` import their client package when they are
called (``HFPipelineChat``: built), as the reference's do; none is
installed on the GPU machine, and nothing here calls an API by itself.
"""

from __future__ import annotations

from typing import Any, List

from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.udfs import (
    AsyncRetryStrategy,
    CacheStrategy,
    UDF,
    async_executor,
)
from pathway_tpu_torch.xpacks.llm._utils import close_async_client, import_client


class BaseChat(UDF):
    """Common surface: call on a messages column (list of {role, content} dicts)."""

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return True


def _coerce_messages(messages: Any) -> List[dict]:
    if isinstance(messages, Json):
        messages = messages.value
    if isinstance(messages, str):
        return [{"role": "user", "content": messages}]
    out = []
    for m in messages:
        if isinstance(m, Json):
            m = m.value
        out.append(dict(m))
    return out


class OpenAIChat(BaseChat):
    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = "gpt-4o-mini",
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
        self.api_key = api_key
        self._client: Any = None
        self._client_loop: Any = None

        async def chat(messages: Any, **kwargs: Any) -> str | None:
            import asyncio

            # the engine runs each commit batch under its own asyncio.run() loop — a
            # client's connection pool is loop-bound, so cache per loop, reuse per batch
            loop = asyncio.get_running_loop()
            if self._client is None or self._client_loop is not loop:
                openai = import_client("openai", "openai client library is not installed")

                await close_async_client(self._client)
                self._client = openai.AsyncOpenAI(api_key=self.api_key)
                self._client_loop = loop
            merged = {k: v for k, v in {**self.kwargs, **kwargs}.items() if v is not None}
            merged.setdefault("model", self.model)
            response = await self._client.chat.completions.create(
                messages=_coerce_messages(messages), **merged
            )
            return response.choices[0].message.content

        self.func = chat


class LiteLLMChat(BaseChat):
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

        async def chat(messages: Any, **kwargs: Any) -> str | None:
            litellm = import_client("litellm", "litellm is not installed")
            merged = {k: v for k, v in {**self.kwargs, **kwargs}.items() if v is not None}
            merged.setdefault("model", self.model)
            response = await litellm.acompletion(messages=_coerce_messages(messages), **merged)
            return response.choices[0].message.content

        self.func = chat


class HFPipelineChat(BaseChat):
    """Local HuggingFace text-generation pipeline (CPU; reference ``:441``)."""

    def __init__(
        self,
        model: str | None = None,
        call_kwargs: "dict | None" = None,
        device: str = "cpu",
        cache_strategy: CacheStrategy | None = None,
        **pipeline_kwargs: Any,
    ):
        super().__init__(cache_strategy=cache_strategy)
        import os

        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
        pipeline = import_client("transformers").pipeline

        self.pipeline = pipeline("text-generation", model=model, device=device, **pipeline_kwargs)
        self.call_kwargs = dict(call_kwargs or {})

        def chat(messages: Any, **kwargs: Any) -> str | None:
            coerced = _coerce_messages(messages)
            merged = {k: v for k, v in {**self.call_kwargs, **kwargs}.items() if v is not None}
            output = self.pipeline(coerced, **merged)
            result = output[0]["generated_text"]
            if isinstance(result, list):
                return result[-1]["content"]
            return result

        self.func = chat

    def crop_to_max_length(self, input_string: str, max_prompt_length: int = 500) -> str:
        tokens = self.pipeline.tokenizer.tokenize(input_string)
        if len(tokens) > max_prompt_length:
            tokens = tokens[-max_prompt_length:]
        return self.pipeline.tokenizer.convert_tokens_to_string(tokens)


class CohereChat(BaseChat):
    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = "command",
        retry_strategy: AsyncRetryStrategy | None = None,
        cache_strategy: CacheStrategy | None = None,
        **cohere_kwargs: Any,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity),
            retry_strategy=retry_strategy,
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(cohere_kwargs)

        async def chat(messages: Any, **kwargs: Any) -> tuple:
            cohere = import_client("cohere", "cohere client library is not installed")
            merged = {k: v for k, v in {**self.kwargs, **kwargs}.items() if v is not None}
            merged.setdefault("model", self.model)
            coerced = _coerce_messages(messages)
            client = cohere.AsyncClient()
            response = await client.chat(
                message=coerced[-1]["content"],
                chat_history=coerced[:-1],
                **merged,
            )
            cited_documents = [dict(d) for d in (response.documents or [])]
            return response.text, cited_documents

        self.func = chat


def prompt_chat_single_qa(question: str) -> Json:
    """Wrap a question into a single-message chat prompt (reference helper)."""
    return Json([{"role": "user", "content": str(question)}])
