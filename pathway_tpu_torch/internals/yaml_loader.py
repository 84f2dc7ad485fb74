"""YAML app templates: ``pw.load_yaml`` (port of ``pathway_tpu/internals/yaml_loader.py``).

``!pw.<dotted.path>`` tags instantiate objects (a mapping node gives keyword
arguments, a sequence node positional ones) and ``$<name>`` strings refer to
the template's top-level variables. PyYAML is imported when ``load_yaml``
is called, not when the package is: without it ``load_yaml`` raises
``ImportError`` and the rest of the package works.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict


def _resolve_path(path: str) -> Any:
    if path.startswith("pw."):
        import pathway_tpu_torch as pw

        obj: Any = pw
        parts = path.split(".")[1:]
    else:
        module_path, _, attr = path.rpartition(".")
        try:
            return getattr(importlib.import_module(module_path), attr)
        except (ImportError, AttributeError):
            parts = path.split(".")
            obj = importlib.import_module(parts[0])
            parts = parts[1:]
    for part in parts:
        if hasattr(obj, part):
            obj = getattr(obj, part)
        else:
            obj = importlib.import_module(f"{obj.__name__}.{part}")
    return obj


class _Instantiate:
    def __init__(self, target: Any, kwargs: Dict | None, args: list | None = None):
        self.target = target
        self.kwargs = kwargs
        self.args = args

    def build(self, variables: Dict[str, Any]) -> Any:
        args = [_materialize(a, variables) for a in (self.args or [])]
        kwargs = {k: _materialize(v, variables) for k, v in (self.kwargs or {}).items()}
        if callable(self.target):
            return self.target(*args, **kwargs)
        return self.target


def _materialize(value: Any, variables: Dict[str, Any]) -> Any:
    if isinstance(value, _Instantiate):
        return value.build(variables)
    if isinstance(value, str) and value.startswith("$") and value[1:] in variables:
        return _materialize(variables[value[1:]], variables)
    if isinstance(value, dict):
        return {k: _materialize(v, variables) for k, v in value.items()}
    if isinstance(value, list):
        return [_materialize(v, variables) for v in value]
    return value


_LOADER: Any = None


def _loader() -> Any:
    """The ``!pw.`` tag loader, made on first use (it subclasses PyYAML's)."""
    global _LOADER
    if _LOADER is not None:
        return _LOADER
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            "pw.load_yaml needs the PyYAML package (import name 'yaml'), "
            "which is not installed"
        ) from exc

    class _PwLoader(yaml.SafeLoader):
        pass

    def _pw_constructor(loader: Any, tag_suffix: str, node: Any) -> Any:
        target = _resolve_path(
            "pw." + tag_suffix if not tag_suffix.startswith("pw.") else tag_suffix
        )
        if isinstance(node, yaml.MappingNode):
            return _Instantiate(target, loader.construct_mapping(node, deep=True))
        if isinstance(node, yaml.SequenceNode):
            return _Instantiate(target, None, loader.construct_sequence(node, deep=True))
        value = loader.construct_scalar(node)
        if value in (None, ""):
            return _Instantiate(target, {})
        return _Instantiate(target, None, [value])

    _PwLoader.add_multi_constructor("!pw.", _pw_constructor)
    _PwLoader.add_multi_constructor("!", lambda l, s, n: _pw_constructor(l, s, n))
    _LOADER = (yaml, _PwLoader)
    return _LOADER


def load_yaml(stream: Any) -> Any:
    """Parse a YAML app template, instantiating ``!pw.*`` tags and ``$variables``."""
    yaml, loader = _loader()
    raw = yaml.load(stream if hasattr(stream, "read") else str(stream), Loader=loader)
    if isinstance(raw, dict):
        variables = {k.lstrip("$"): v for k, v in raw.items()}
        return {k.lstrip("$"): _materialize(v, variables) for k, v in raw.items()}
    return _materialize(raw, {})
