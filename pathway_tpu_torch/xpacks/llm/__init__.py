"""LLM xpack: the RAG pipeline's parts (port of ``pathway_tpu/xpacks/llm``).

The light modules import eagerly; ``vector_store``, ``document_store``,
``question_answering`` and ``servers`` (which build engine graphs) on first
use, as in the reference."""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    rerankers,
    splitters,
)

__all__ = ["embedders", "llms", "parsers", "prompts", "rerankers", "splitters"]


def __getattr__(name: str):
    if name in ("vector_store", "document_store", "question_answering", "servers"):
        import importlib

        return importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{name}")
    raise AttributeError(name)
