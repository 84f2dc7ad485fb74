"""pathway_tpu_torch — the PyTorch / CUDA port of ``pathway_tpu``.

Import as ``import pathway_tpu_torch as pw``: declarative ``Table`` programs
over update streams, run incrementally by the port's own dataflow engine
(``engine/``), with ``pw.run`` driving the commits. The retrieval path
(documents → parse → split → sentence encoder → IVF index → ``/v1/retrieve``)
runs on one NVIDIA H100; the IVF candidate-page scorer is a hand-written CUDA
kernel for ``sm_90a`` (``csrc/score_pages.cu``).

The package imports ``torch`` and ``numpy`` only. It never imports ``jax`` or
anything from ``pathway_tpu``: it keeps its own copies of the host code it
needs. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from pathway_tpu_torch import debug, demo, io, ops, persistence
from pathway_tpu_torch.engine.runner import run, run_all
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_with_type,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from pathway_tpu_torch.internals import dtype as _dtype_mod
from pathway_tpu_torch.internals.dtype import DType
from pathway_tpu_torch.internals.groupbys import GroupedTable
from pathway_tpu_torch.internals.interactive import LiveTable, enable_interactive_mode
from pathway_tpu_torch.internals.joins import JoinKind, JoinMode, JoinResult
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.internals.monitoring import MonitoringLevel
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.custom_reducers import BaseCustomAccumulator
from pathway_tpu_torch.internals.errors import global_error_log, local_error_log
from pathway_tpu_torch.internals.iterate import iterate, iteration_limit
from pathway_tpu_torch.internals.yaml_loader import load_yaml
from pathway_tpu_torch.internals.parse_graph import G as parse_graph_G
from pathway_tpu_torch.internals.row_transformer import (
    ClassArg,
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from pathway_tpu_torch.internals.sql import sql
from pathway_tpu_torch.internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import Joinable, Table, TableSlice
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.udfs import (
    UDF,
    AsyncRetryStrategy,
    CacheStrategy,
    DiskCache,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    FullyAsyncExecutor,
    InMemoryCache,
    NoRetryStrategy,
    async_executor,
    auto_executor,
    fully_async_executor,
    sync_executor,
    udf,
)
from pathway_tpu_torch import stdlib
from pathway_tpu_torch.stdlib import (
    graphs,
    indexing,
    ml,
    ordered,
    statistical,
    stateful,
    temporal,
    viz,
)
from pathway_tpu_torch.stdlib import utils as _stdlib_utils  # noqa: F401
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

Date = _dtype_mod.DATE_TIME_NAIVE
DateTimeNaive = _dtype_mod.DATE_TIME_NAIVE
DateTimeUtc = _dtype_mod.DATE_TIME_UTC
Duration = _dtype_mod.DURATION

__version__ = "0.1.0"


def __getattr__(name: str):
    if name == "xpacks":
        import pathway_tpu_torch.xpacks as xpacks

        return xpacks
    raise AttributeError(name)


__all__ = [
    "apply",
    "apply_async",
    "apply_with_type",
    "async_executor",
    "AsyncTransformer",
    "AsyncRetryStrategy",
    "attribute",
    "auto_executor",
    "BaseCustomAccumulator",
    "CacheStrategy",
    "cast",
    "ClassArg",
    "coalesce",
    "column_definition",
    "ColumnDefinition",
    "ColumnExpression",
    "ColumnReference",
    "Date",
    "DateTimeNaive",
    "DateTimeUtc",
    "debug",
    "declare_type",
    "demo",
    "DiskCache",
    "DType",
    "Duration",
    "enable_interactive_mode",
    "ExponentialBackoffRetryStrategy",
    "fill_error",
    "FixedDelayRetryStrategy",
    "fully_async_executor",
    "FullyAsyncExecutor",
    "global_error_log",
    "graphs",
    "GroupedTable",
    "if_else",
    "indexing",
    "InMemoryCache",
    "input_attribute",
    "input_method",
    "io",
    "iterate",
    "iteration_limit",
    "Joinable",
    "JoinKind",
    "JoinMode",
    "JoinResult",
    "Json",
    "left",
    "LiveTable",
    "load_yaml",
    "local_error_log",
    "make_tuple",
    "method",
    "ml",
    "MonitoringLevel",
    "NoRetryStrategy",
    "ops",
    "ordered",
    "output_attribute",
    "pandas_transformer",
    "parse_graph_G",
    "persistence",
    "Pointer",
    "reducers",
    "require",
    "right",
    "run",
    "run_all",
    "Schema",
    "schema_builder",
    "schema_from_csv",
    "schema_from_dict",
    "schema_from_pandas",
    "schema_from_types",
    "sql",
    "stateful",
    "statistical",
    "stdlib",
    "sync_executor",
    "Table",
    "TableSlice",
    "temporal",
    "this",
    "transformer",
    "UDF",
    "udf",
    "udfs",
    "unwrap",
    "viz",
]
