"""RAG question answering (port of ``pathway_tpu/xpacks/llm/question_answering.py``).

``BaseRAGQuestionAnswerer``: answer / summarize / retrieve / statistics /
list_documents over a ``DocumentStore`` and a chat model, with the
per-query model override and ``return_context_docs``;
``AdaptiveRAGQuestionAnswerer`` retrieves ``n_starting_documents *
factor ** (max_iterations - 1)`` documents once and asks the chat with the
first n of them, n growing by ``factor`` until the answer is not the
not-found reply (an async UDF: a commit's questions are asked together).
"""

from __future__ import annotations

from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm import prompts
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.llms import BaseChat, prompt_chat_single_qa


class BaseQuestionAnswerer:
    """Abstract query surfaces used by the REST servers (reference ``:288``)."""

    AnswerQuerySchema: type = pw.Schema
    RetrieveQuerySchema: type = pw.Schema
    StatisticsQuerySchema: type = pw.Schema
    InputsQuerySchema: type = pw.Schema

    def answer_query(self, queries: Table) -> Table:
        raise NotImplementedError

    def retrieve(self, queries: Table) -> Table:
        raise NotImplementedError

    def statistics(self, queries: Table) -> Table:
        raise NotImplementedError

    def list_documents(self, queries: Table) -> Table:
        raise NotImplementedError


class SummaryQuestionAnswerer(BaseQuestionAnswerer):
    SummarizeQuerySchema: type = pw.Schema

    def summarize_query(self, queries: Table) -> Table:
        raise NotImplementedError


class BaseRAGQuestionAnswerer(SummaryQuestionAnswerer):
    """Standard RAG: retrieve k docs, build prompt, ask the chat model (reference ``:314``)."""

    class AnswerQuerySchema(pw.Schema):
        prompt: str
        filters: str | None = pw.column_definition(default_value=None)
        model: str | None = pw.column_definition(default_value=None)
        return_context_docs: bool = pw.column_definition(default_value=False, dtype=bool)

    class SummarizeQuerySchema(pw.Schema):
        text_list: pw.Json

    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    def __init__(
        self,
        llm: BaseChat,
        indexer: DocumentStore | Any,
        *,
        default_llm_name: str | None = None,
        short_prompt_template: Callable = prompts.prompt_short_qa,
        long_prompt_template: Callable = prompts.prompt_qa,
        summarize_template: Callable = prompts.prompt_summarize,
        search_topk: int = 6,
        prompt_template: Callable | None = None,
    ):
        self.llm = llm
        self.indexer = indexer.store if hasattr(indexer, "store") else indexer
        self.search_topk = search_topk
        self.prompt_template = prompt_template or long_prompt_template
        self.short_prompt_template = short_prompt_template
        self.summarize_template = summarize_template
        self.default_llm_name = default_llm_name
        self._server_thread = None

    def _model_expr(self, queries: Table) -> Any:
        """Per-query model override, falling back to ``default_llm_name`` (the chat UDF
        drops a None model and uses its own default)."""
        default = self.default_llm_name
        if "model" in queries.column_names():
            return expr.apply_with_type(
                lambda m: m if m is not None else default,
                dt.Optional_(dt.STR),
                queries.model,
            )
        return default

    # -- query surfaces -----------------------------------------------------

    def answer_query(self, queries: Table) -> Table:
        names = queries.column_names()
        retrieval_queries = queries.select(
            query=queries.prompt,
            k=self.search_topk,
            metadata_filter=queries.filters if "filters" in names else None,
            filepath_globpattern=None,
        )
        retrieved = self.indexer.retrieve_query(retrieval_queries)
        # retrieved shares the queries' key set (DataIndex joins back on the query id)
        with_docs = queries.with_columns(_pw_docs=retrieved.result)
        template = self.prompt_template
        prompt_col = expr.apply_with_type(
            lambda q, docs: prompt_chat_single_qa(
                template(q, tuple(docs.value if isinstance(docs, Json) else docs))
            ),
            dt.JSON,
            queries.prompt,
            with_docs._pw_docs,
        )
        raw_answer = self.llm(prompt_col, model=self._model_expr(queries))
        result = with_docs.select(
            response=expr.apply_with_type(
                _format_answer,
                dt.JSON,
                raw_answer,
                with_docs._pw_docs,
                queries.return_context_docs if "return_context_docs" in names else False,
            ),
        )
        return result.with_columns(result=result.response)

    # reference naming
    answer = answer_query

    def summarize_query(self, queries: Table) -> Table:
        template = self.summarize_template
        prompt_col = expr.apply_with_type(
            lambda tl: prompt_chat_single_qa(
                template(tuple(tl.value if isinstance(tl, Json) else tl))
            ),
            dt.JSON,
            queries.text_list,
        )
        raw = self.llm(prompt_col)
        return queries.select(result=raw)

    def retrieve(self, queries: Table) -> Table:
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries: Table) -> Table:
        return self.indexer.statistics_query(queries)

    def list_documents(self, queries: Table) -> Table:
        return self.indexer.inputs_query(queries)

    # -- serving ------------------------------------------------------------

    def build_server(self, host: str, port: int, **kwargs: Any) -> None:
        from pathway_tpu_torch.xpacks.llm.servers import QASummaryRestServer

        self.server = QASummaryRestServer(host, port, self, **kwargs)

    def run_server(self, *args: Any, **kwargs: Any) -> Any:
        if not hasattr(self, "server"):
            raise ValueError("run build_server first")
        return self.server.run(*args, **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Geometric context growth (reference ``:620``): try n_starting_documents, re-ask with
    factor× more docs until the model finds an answer or max_iterations is hit."""

    def __init__(
        self,
        llm: BaseChat,
        indexer: Any,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        not_found_response: str = "No information",
        **kwargs: Any,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        # strict_prompt forces the terse template (fewer tokens per adaptive round,
        # reference ``question_answering.py:620`` behavior switch)
        if strict_prompt and kwargs.get("prompt_template") is None:
            self.prompt_template = self.short_prompt_template
        # the adaptive loop grows context while answers contain this marker; keep it in
        # sync with the prompt's information_not_found_response
        self.not_found_response = not_found_response

    def answer_query(self, queries: Table) -> Table:
        names = queries.column_names()
        max_k = self.n_starting_documents * (self.factor ** (self.max_iterations - 1))
        retrieval_queries = queries.select(
            query=queries.prompt,
            k=max_k,
            metadata_filter=queries.filters if "filters" in names else None,
            filepath_globpattern=None,
        )
        retrieved = self.indexer.retrieve_query(retrieval_queries)
        with_docs = queries.with_columns(_pw_docs=retrieved.result)

        # wrapped fn keeps the UDF's capacity/retry/cache behavior
        llm_fun, _llm_is_async = self.llm._wrapped_fun()
        template = self.prompt_template
        not_found = self.not_found_response
        n0, factor, max_iter = self.n_starting_documents, self.factor, self.max_iterations

        @pw.udf
        async def adaptive_answer(q: str, docs: Any) -> str:
            import asyncio

            doc_list = list(docs.value if isinstance(docs, Json) else docs)
            n = n0
            answer = None
            for _ in range(max_iter):
                subset = tuple(doc_list[:n])
                prompt = prompt_chat_single_qa(template(q, subset))
                result = llm_fun(prompt)
                if asyncio.iscoroutine(result):
                    result = await result
                answer = result
                if answer and not_found not in str(answer):
                    return str(answer)
                if n >= len(doc_list):
                    break
                n *= factor
            return str(answer)

        result = with_docs.select(result=adaptive_answer(queries.prompt, with_docs._pw_docs))
        return result


class DeckRetriever(BaseQuestionAnswerer):
    """Slide-deck retrieval preset (reference ``:736``)."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "DeckRetriever depends on SlideParser (licensed in the reference)"
        )


def _format_answer(answer: Any, docs: Any, return_context: Any) -> Json:
    payload: dict = {"response": answer}
    if return_context:
        payload["context_docs"] = docs.value if isinstance(docs, Json) else list(docs)
    return Json(payload)
