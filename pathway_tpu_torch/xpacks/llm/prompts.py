"""RAG prompt templates (port of ``pathway_tpu/xpacks/llm/prompts.py``), string for
string."""

from __future__ import annotations

from typing import Any


def prompt_qa(
    query: str,
    docs: tuple,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
) -> str:
    context = "\n\n".join(_doc_text(d) for d in docs)
    return (
        "Please provide an answer based solely on the provided sources. "
        "Keep your answer concise and accurate. "
        f"If the sources do not contain the answer, say: {information_not_found_response}\n"
        f"{additional_rules}\n"
        f"Sources:\n{context}\n\n"
        f"Question: {query}\n"
        "Answer:"
    )


def prompt_short_qa(query: str, docs: tuple, additional_rules: str = "") -> str:
    return prompt_qa(
        query, docs, additional_rules=additional_rules + "\nAnswer with as few words as possible."
    )


def prompt_citing_qa(query: str, docs: tuple, additional_rules: str = "") -> str:
    context = "\n\n".join(f"[{i}] {_doc_text(d)}" for i, d in enumerate(docs))
    return (
        "Answer the question based on the numbered sources, citing them like [0].\n"
        f"{additional_rules}\n"
        f"Sources:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_summarize(text_list: tuple) -> str:
    text = "\n".join(str(t) for t in text_list)
    return f"Summarize the following text concisely:\n\n{text}\n\nSummary:"


def prompt_query_rewrite(query: str) -> str:
    return (
        "Rewrite the following search query to be clearer and more specific, "
        f"keeping its meaning:\n{query}\nRewritten query:"
    )


def rerank_prompt(doc: str, query: str) -> str:
    return (
        "Rate the relevance of the document to the query on a scale from 1 to 5, "
        "where 5 means highly relevant. Respond with a single digit.\n"
        f"Query: {query}\nDocument: {doc}\nRating:"
    )


def _doc_text(d: Any) -> str:
    from pathway_tpu_torch.internals.json import Json

    if isinstance(d, Json):
        d = d.value
    if isinstance(d, dict):
        return str(d.get("text", d))
    return str(d)
