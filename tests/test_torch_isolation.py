"""The port stands alone: ``pathway_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package (``pathway_tpu.native`` included) nor
any package the GPU machine lacks (``xxhash`` and ``pyarrow`` among them: the
port hashes its keys itself), its native module builds from its own source
into its own build directory, and every entry point runs on the card unless
the caller names the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, DenseKNNStore, IvfKnnIndex
from pathway_tpu_torch.ops.knn_ivf import IvfKnnStore
from pathway_tpu_torch.ops.knn_tiers import TieredIvfKnnStore
from pathway_tpu_torch.ops.segment import segment_sum
from pathway_tpu_torch.stdlib.indexing import HybridIndexFactory, TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnnFactory,
    IvfKnnFactory,
    USearchKnnFactory,
)
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pathway_tpu_torch")
FORBIDDEN = {
    "jax", "jaxlib", "flax", "pathway_tpu", "ml_dtypes",
    "xxhash", "aiohttp", "requests", "transformers", "pyarrow",
}


def _port_sources() -> list:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _imported_roots(path: str) -> set:
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "__import__"
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources())
def test_source_imports_nothing_forbidden(path):
    assert not _imported_roots(path) & FORBIDDEN, path


SERVING_MODULES = [
    "pathway_tpu_torch/ops/knn_quant.py",
    "pathway_tpu_torch/ops/knn_tiers.py",
    "pathway_tpu_torch/ops/score_blocks.py",
    "pathway_tpu_torch/engine/telemetry.py",
    "pathway_tpu_torch/engine/profile.py",
    "pathway_tpu_torch/engine/http_server.py",
    "pathway_tpu_torch/internals/config.py",
    "pathway_tpu_torch/internals/monitoring.py",
    "pathway_tpu_torch/engine/brownout.py",
    "pathway_tpu_torch/models/encoder_service.py",
    "pathway_tpu_torch/models/embed_pipeline.py",
    "pathway_tpu_torch/io/http/_server.py",
    "pathway_tpu_torch/io/http/_json_server.py",
    "pathway_tpu_torch/xpacks/llm/embedders.py",
    "pathway_tpu_torch/xpacks/llm/vector_store.py",
]


@pytest.mark.parametrize("path", SERVING_MODULES)
def test_serving_modules_are_checked_and_import_nothing_forbidden(path):
    """The query-serving path (the encoder service, its semantic cache's
    XXH32 proxy, the coalescer, the brownout ladder, REST admission) keeps
    its own copies: no ``xxhash``, ``aiohttp``, ``requests`` or JAX."""
    assert path in _port_sources()
    assert not _imported_roots(path) & FORBIDDEN, path


# the index family and the RAG top: no client package of a chat, a reranker
# or a config loader at import (the GPU machine has none of them); the chat
# and reranker classes import theirs when built or called (``import_client``)
RAG_MODULES = [
    "pathway_tpu_torch/engine/evaluators.py",
    "pathway_tpu_torch/engine/expression_evaluator.py",
    "pathway_tpu_torch/internals/expression.py",
    "pathway_tpu_torch/internals/udfs/__init__.py",
    "pathway_tpu_torch/io/http/_server.py",
    "pathway_tpu_torch/stdlib/indexing/__init__.py",
    "pathway_tpu_torch/stdlib/indexing/bm25.py",
    "pathway_tpu_torch/stdlib/indexing/full_text_document_index.py",
    "pathway_tpu_torch/stdlib/indexing/hybrid_index.py",
    "pathway_tpu_torch/stdlib/indexing/nearest_neighbors.py",
    "pathway_tpu_torch/stdlib/indexing/vector_document_index.py",
    "pathway_tpu_torch/xpacks/llm/__init__.py",
    "pathway_tpu_torch/xpacks/llm/_utils.py",
    "pathway_tpu_torch/xpacks/llm/llms.py",
    "pathway_tpu_torch/xpacks/llm/prompts.py",
    "pathway_tpu_torch/xpacks/llm/question_answering.py",
    "pathway_tpu_torch/xpacks/llm/rerankers.py",
    "pathway_tpu_torch/xpacks/llm/servers.py",
]
CLIENT_PACKAGES = {"yaml", "openai", "litellm", "cohere", "transformers", "sentence_transformers"}


@pytest.mark.parametrize("path", RAG_MODULES)
def test_rag_modules_are_checked_and_import_nothing_forbidden(path):
    assert path in _port_sources()
    assert not _imported_roots(path) & (FORBIDDEN | CLIENT_PACKAGES), path


def test_importing_the_rag_modules_leaves_client_packages_out():
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__") for p in RAG_MODULES]
    banned = sorted(FORBIDDEN | CLIENT_PACKAGES)
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "print(','.join(sorted(n for n in sys.modules if n.split('.')[0] in %r)))\n" % (banned,)
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


# the engine's remaining operators, the reducers, iterate and the stdlib on
# them (A4a): no client package at import either; ``pw.load_yaml`` imports
# PyYAML when it is called
A4A_MODULES = [
    "pathway_tpu_torch/__init__.py",
    "pathway_tpu_torch/internals/custom_reducers.py",
    "pathway_tpu_torch/internals/errors.py",
    "pathway_tpu_torch/internals/iterate.py",
    "pathway_tpu_torch/internals/parse_graph.py",
    "pathway_tpu_torch/internals/reducers.py",
    "pathway_tpu_torch/internals/table.py",
    "pathway_tpu_torch/internals/yaml_loader.py",
    "pathway_tpu_torch/stdlib/graphs/__init__.py",
    "pathway_tpu_torch/stdlib/graphs/bellman_ford.py",
    "pathway_tpu_torch/stdlib/graphs/common.py",
    "pathway_tpu_torch/stdlib/graphs/louvain_communities.py",
    "pathway_tpu_torch/stdlib/graphs/pagerank.py",
    "pathway_tpu_torch/stdlib/indexing/sorting.py",
    "pathway_tpu_torch/stdlib/ml/hmm.py",
    "pathway_tpu_torch/stdlib/ordered/__init__.py",
    "pathway_tpu_torch/stdlib/stateful/__init__.py",
    "pathway_tpu_torch/stdlib/statistical/__init__.py",
    "pathway_tpu_torch/stdlib/utils/__init__.py",
    "pathway_tpu_torch/stdlib/utils/bucketing.py",
    "pathway_tpu_torch/stdlib/utils/col.py",
    "pathway_tpu_torch/stdlib/utils/filtering.py",
    "pathway_tpu_torch/ops/segment.py",
]


@pytest.mark.parametrize("path", A4A_MODULES)
def test_a4a_modules_are_checked_and_import_nothing_forbidden(path):
    """Statically: no forbidden or client import anywhere in the module, but
    the loader's own ``import yaml`` inside ``load_yaml`` (that it stays out
    of ``import pathway_tpu_torch`` is checked by running it, below)."""
    assert path in _port_sources()
    lazy = {"yaml"} if path.endswith("yaml_loader.py") else set()
    assert not _imported_roots(path) & ((FORBIDDEN | CLIENT_PACKAGES) - lazy), path


_NO_YAML = (
    "import sys\n"
    "sys.modules['yaml'] = None  # any import of yaml raises ImportError\n"
    "import pathway_tpu_torch as pw\n"
    "assert pw.iterate and pw.stdlib.graphs.pagerank and pw.statistical.interpolate\n"
    "try:\n"
    "    pw.load_yaml('a: 1')\n"
    "except ImportError as exc:\n"
    "    print('ImportError:', exc)\n"
)


def test_the_package_imports_without_yaml_and_load_yaml_then_raises():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_YAML], capture_output=True, text=True, cwd=REPO, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ImportError:") and "PyYAML" in proc.stdout


# row transformers, pw.sql, the error traces and the pandas bridge (A4b-1):
# pandas only inside the functions that use it (the GPU machine has none)
A4B1_MODULES = [
    "pathway_tpu_torch/debug/__init__.py",
    "pathway_tpu_torch/internals/row_transformer.py",
    "pathway_tpu_torch/internals/schema.py",
    "pathway_tpu_torch/internals/sql.py",
    "pathway_tpu_torch/internals/trace.py",
    "pathway_tpu_torch/stdlib/utils/pandas_transformer.py",
]


def _module_level_roots(path: str) -> set:
    """Imports outside any function body: what importing the module runs."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    roots: set = set()

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                roots.update(a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                roots.add(child.module.split(".")[0])
            visit(child)

    visit(tree)
    return roots


@pytest.mark.parametrize("path", A4B1_MODULES)
def test_a4b1_modules_are_checked_and_import_nothing_forbidden(path):
    assert path in _port_sources()
    assert not _imported_roots(path) & (FORBIDDEN | CLIENT_PACKAGES), path
    assert "pandas" not in _module_level_roots(path), path


_NO_PANDAS = (
    "import sys\n"
    "sys.modules['pandas'] = None  # any import of pandas raises ImportError\n"
    "import pathway_tpu_torch as pw\n"
    "assert pw.sql and pw.transformer and pw.schema_from_csv and pw.debug.StreamGenerator\n"
    "for call in (\n"
    "    lambda: pw.debug.table_from_pandas(object()),\n"
    "    lambda: pw.schema_from_pandas(object()),\n"
    "    lambda: pw.pandas_transformer(pw.schema_from_types(a=int))(lambda t: t)(\n"
    "        pw.debug.table_from_markdown('a\\n1')),\n"
    "):\n"
    "    try:\n"
    "        call()\n"
    "    except ImportError as exc:\n"
    "        print('ImportError:', exc)\n"
)


def test_the_package_imports_without_pandas_and_table_from_pandas_then_raises():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PANDAS], capture_output=True, text=True, cwd=REPO, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 3 and all(l.startswith("ImportError:") and "pandas" in l for l in lines)


# the async transformer, interactive mode, viz, the fuzzy joins, the datasets
# and pw.demo (A4b-2): bokeh, panel, pandas and scikit-learn only inside the
# functions that use them (the GPU machine has none of them)
A4B2_MODULES = [
    "pathway_tpu_torch/demo/__init__.py",
    "pathway_tpu_torch/engine/datasource.py",
    "pathway_tpu_torch/engine/runner.py",
    "pathway_tpu_torch/internals/interactive.py",
    "pathway_tpu_torch/stdlib/ml/__init__.py",
    "pathway_tpu_torch/stdlib/ml/datasets/__init__.py",
    "pathway_tpu_torch/stdlib/ml/datasets/classification/__init__.py",
    "pathway_tpu_torch/stdlib/ml/smart_table_ops/__init__.py",
    "pathway_tpu_torch/stdlib/ml/smart_table_ops/_fuzzy_join.py",
    "pathway_tpu_torch/stdlib/utils/async_transformer.py",
    "pathway_tpu_torch/stdlib/viz/__init__.py",
]
LAZY_PACKAGES = {"bokeh", "panel", "pandas", "sklearn"}


@pytest.mark.parametrize("path", A4B2_MODULES)
def test_a4b2_modules_are_checked_and_import_nothing_forbidden(path):
    assert path in _port_sources()
    assert not _imported_roots(path) & (FORBIDDEN | CLIENT_PACKAGES), path
    assert not _module_level_roots(path) & LAZY_PACKAGES, path


_NO_VIZ = (
    "import sys\n"
    "for name in ('bokeh', 'panel', 'pandas', 'sklearn'):\n"
    "    sys.modules[name] = None  # any import of it raises ImportError\n"
    "import pathway_tpu_torch as pw\n"
    "assert pw.AsyncTransformer and pw.LiveTable and pw.demo.range_stream\n"
    "assert pw.ml.fuzzy_match and pw.ml.datasets.load_synthetic_classification\n"
    "t = pw.debug.table_from_markdown('a\\n1')\n"
    "assert pw.viz.table_snapshot(t).snapshot() == []\n"
    "for call in (\n"
    "    lambda: pw.viz.plot(t, lambda source: None),\n"
    "    lambda: pw.viz.show(t),\n"
    "    lambda: pw.ml.datasets.load_mnist_sample(),\n"
    "    lambda: pw.ml.datasets.load_synthetic_classification(n_train=4, n_test=2),\n"
    "):\n"
    "    try:\n"
    "        call()\n"
    "    except ImportError as exc:\n"
    "        print('ImportError:', exc)\n"
    "print(','.join(sorted(n for n in sys.modules if n.split('.')[0] in %r and sys.modules[n])))\n"
)


def test_the_package_imports_without_bokeh_panel_pandas_and_viz_plot_then_raises():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_VIZ % (sorted(LAZY_PACKAGES | FORBIDDEN),)],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    *raised, leaked = proc.stdout.splitlines()
    assert len(raised) == 4 and all(line.startswith("ImportError:") for line in raised), raised
    assert "bokeh/panel" in raised[0] and "bokeh/panel" in raised[1]
    assert "scikit-learn" in raised[2] and "pandas" in raised[3]
    assert leaked == ""


def test_importing_the_serving_path_leaves_forbidden_packages_out():
    mods = [p[:-3].replace("/", ".") for p in SERVING_MODULES]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "print(','.join(sorted(n for n in sys.modules if n.split('.')[0] in %r)))\n"
        % (sorted(FORBIDDEN),)
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_importing_every_module_leaves_jax_and_reference_out():
    code = (
        "import pkgutil, sys, pathway_tpu_torch\n"
        "for m in pkgutil.walk_packages(pathway_tpu_torch.__path__, 'pathway_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)\n"
        "print(len([n for n in sys.modules if n.startswith('pathway_tpu_torch.')]))\n"
        "print(','.join(bad))\n" % (sorted(FORBIDDEN),)
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.splitlines()
    assert int(n_modules) >= 40  # every submodule was imported
    assert bad == "", bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_TINY = dict(vocab_size=4096, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)


@pytest.mark.parametrize(
    "entry",
    [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: DenseKNNStore(8),
        lambda: IvfKnnStore(8),
        lambda: BruteForceKnnIndex(8),
        lambda: IvfKnnIndex(8),
        lambda: IvfKnnIndex(16, tiered=True),
        lambda: TieredIvfKnnStore(16, quant="int8"),
        lambda: IvfKnnFactory(dimensions=8).build_inner_index(None).make_instance_factory()(),
        lambda: SentenceTransformerEmbedder(encoder_config=EncoderConfig(**_TINY)),
        lambda: BruteForceKnnFactory(dimensions=8).build_inner_index(None).make_instance_factory()(),
        lambda: segment_sum(np.ones(1 << 15, np.float32), np.zeros(1 << 15, np.int64), 1),
        lambda: HybridIndexFactory([IvfKnnFactory(dimensions=8), TantivyBM25Factory()])
        .build_inner_index(None).make_instance_factory()(),
        lambda: USearchKnnFactory(dimensions=8).build_inner_index(None).make_instance_factory()(),
        lambda: EncoderReranker(config=EncoderConfig(**_TINY)),
    ],
    ids=["resolve_none", "resolve_cuda", "dense_store", "ivf_store", "bf_index",
         "ivf_index", "tiered_index", "tiered_store", "ivf_factory", "embedder", "bf_factory",
         "engine_device_sum", "hybrid_factory", "usearch_factory", "encoder_reranker"],
)
def test_entry_points_without_a_device_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


_MONITORED_RUN = (
    "import os, sys, urllib.request\n"
    "import pathway_tpu_torch as pw\n"
    "from pathway_tpu_torch.engine.http_server import MonitoringServer, ProberStats\n"
    "server = MonitoringServer(ProberStats(), 0)\n"
    "body = urllib.request.urlopen(f'http://127.0.0.1:{server.port}/metrics').read().decode()\n"
    "server.close()\n"
    "assert body.endswith('# EOF\\n'), body\n"
    "port = int(os.environ['PATHWAY_MONITORING_HTTP_PORT'])\n"
    "seen = []\n"
    "t = pw.debug.table_from_markdown('a\\n1\\n2')\n"
    "pw.io.subscribe(t, lambda *a, **k: seen.append(urllib.request.urlopen(\n"
    "    f'http://127.0.0.1:{port}/metrics').read().decode()))\n"
    "pw.run(with_http_server=True)\n"
    "assert seen and all(b.endswith('# EOF\\n') for b in seen)\n"
    "print(','.join(sorted(n for n in sys.modules if n.split('.')[0] in %r)))\n"
)


def test_monitoring_runs_without_a_card_and_imports_nothing_forbidden():
    """``MonitoringServer`` and ``pw.run(with_http_server=True)`` (the card
    by default) serve ``/metrics`` on a machine without a card and pull in
    neither JAX, the reference nor a package the GPU machine lacks."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PATHWAY_MONITORING_HTTP_PORT": str(port)}
    env.pop("PATHWAY_PROCESS_ID", None)
    proc = subprocess.run(
        [sys.executable, "-c", _MONITORED_RUN % (sorted(FORBIDDEN),)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_entry_points_run_on_the_cpu_when_asked(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    assert IvfKnnStore(8, device="cpu")._data.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:  # the script alone, without the package beside it
            with open(os.path.join(REPO, script)) as src:
                (tmp_path / script).write_text(src.read())
        proc = subprocess.run(
            [sys.executable, script], capture_output=True, text=True, cwd=cwd, env=env,
            timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


_FAKE_GXX = """#!/bin/sh
printf '%s\\n' "$@" > "$GXX_ARGS"
exit 1
"""


def test_native_build_reads_only_the_ports_source_and_writes_its_build_dir(tmp_path):
    """The native module compiles ``pathway_tpu_torch/csrc/pathway_native.cc``
    (never the reference's ``csrc/pathway_native.cc``), includes no
    ``xxhash.h`` and nothing of pyarrow, and writes under
    ``pathway_tpu_torch/_build/``: a stand-in ``g++`` on the PATH records the
    command the build runs, and its failure must surface as the build error."""
    from pathway_tpu_torch import native

    assert native.SOURCE == os.path.join(PKG, "csrc", "pathway_native.cc")
    assert native.BUILD_DIR == os.path.join(PKG, "_build")
    assert os.path.dirname(native.lib_path()) == native.BUILD_DIR
    with open(native.SOURCE) as f:
        includes = [ln for ln in f if ln.lstrip().startswith("#include")]
    assert includes and not any("xxhash" in ln or "arrow" in ln for ln in includes)

    (tmp_path / "g++").write_text(_FAKE_GXX)
    (tmp_path / "g++").chmod(0o755)
    args_file = tmp_path / "args.txt"
    code = (
        "import os, pathway_tpu_torch.native as n\n"
        "n.lib_path = lambda: os.path.join(n.BUILD_DIR, 'libpathway_native_isolation.so')\n"
        "assert n.get_lib() is None\n"
        "print(n.BUILD_ERROR)\n"
    )
    env = {**os.environ, "PATH": f"{tmp_path}:{os.environ['PATH']}", "GXX_ARGS": str(args_file)}
    env.pop("PATHWAY_TPU_DISABLE_NATIVE", None)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "g++ failed" in proc.stdout  # the build error is kept, not swallowed
    argv = args_file.read_text().splitlines()
    sources = [a for a in argv if a.endswith(".cc")]
    assert sources == [native.SOURCE]
    assert os.path.join(REPO, "csrc") not in {os.path.dirname(a) for a in argv}
    assert not any("arrow" in a or "xxhash" in a for a in argv)
    out = argv[argv.index("-o") + 1]
    assert os.path.dirname(out) == native.BUILD_DIR
