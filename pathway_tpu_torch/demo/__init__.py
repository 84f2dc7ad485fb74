"""Synthetic demo streams (port of ``pathway_tpu/demo``), on the python
connector: ``generate_custom_stream``, ``noisy_linear_stream``,
``range_stream`` and ``replay_csv``. Run them with ``pw.run``."""

from __future__ import annotations

import csv
import random
import time
from typing import Any, Callable, Dict

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.io.python import ConnectorSubject, read


def generate_custom_stream(
    value_generators: Dict[str, Callable[[int], Any]],
    *,
    schema: sch.SchemaMetaclass,
    nb_rows: int | None = None,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 100,
    name: str = "demo",
) -> Any:
    """A stream whose row ``i`` holds ``gen(i)`` in each generator's column."""

    class _Subject(ConnectorSubject):
        def run(self) -> None:
            i = 0
            while nb_rows is None or i < nb_rows:
                self.next(**{name_: gen(i) for name_, gen in value_generators.items()})
                i += 1
                if input_rate and nb_rows is None or (nb_rows and nb_rows > 100):
                    time.sleep(1.0 / input_rate if input_rate else 0)

    return read(_Subject(), schema=schema, autocommit_duration_ms=autocommit_duration_ms, name=name)


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0) -> Any:
    """Rows (x, y) with x = i and y = i plus noise in [-0.1, 0.1)."""
    schema = sch.schema_from_types(x=float, y=float)
    rng = random.Random(0)
    return generate_custom_stream(
        {
            "x": lambda i: float(i),
            "y": lambda i: float(i) + (2 * rng.random() - 1) / 10,
        },
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


def range_stream(
    nb_rows: int = 30, offset: int = 0, input_rate: float = 1.0, autocommit_duration_ms: int = 100
) -> Any:
    """Rows with ``value`` = offset, offset + 1, ..."""
    schema = sch.schema_from_types(value=int)
    return generate_custom_stream(
        {"value": lambda i: i + offset},
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def replay_csv(path: str, *, schema: Any, input_rate: float = 1.0) -> Any:
    """The rows of a CSV file, typed by ``schema``, at ``input_rate`` rows
    per second (0: as fast as they are read)."""

    class _Subject(ConnectorSubject):
        def run(self) -> None:
            dtypes = schema.dtypes()
            with open(path, newline="") as f:
                for rec in csv.DictReader(f):
                    row = {}
                    for k, v in rec.items():
                        if k not in dtypes:
                            continue
                        base = dtypes[k].strip_optional()
                        if base == dt.INT:
                            row[k] = int(v)
                        elif base == dt.FLOAT:
                            row[k] = float(v)
                        else:
                            row[k] = v
                    self.next(**row)
                    if input_rate:
                        time.sleep(1.0 / input_rate)

    return read(_Subject(), schema=schema)
