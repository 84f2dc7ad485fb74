"""``pw.pandas_transformer`` (port of ``pathway_tpu/stdlib/utils/pandas_transformer.py``).

pandas is imported when a wrapped function is applied to tables: the GPU
machine has none, and the package imports without it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import Pointer, pointer_from
from pathway_tpu_torch.internals.reducers import reducers
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.utils.col import unpack_col


def _argument_index(fun: Callable, arg: Any) -> int | None:
    if arg is None or isinstance(arg, int):
        return arg
    import inspect

    names = list(inspect.signature(fun).parameters)
    try:
        return names.index(arg)
    except ValueError as exc:
        raise ValueError(f"wrong output universe. No argument of name: {arg}") from exc


def pandas_transformer(
    output_schema: sch.SchemaMetaclass, output_universe: Any = None
) -> Callable:
    """Wrap a pandas-DataFrame function as a Table→Table transformer.

    Each input table is materialized into a ``pd.DataFrame`` (index = row keys) once per
    commit; the function's resulting DataFrame is exploded back into an incremental table.
    Batch semantics — meant for small tables / infrequent updates, like the reference.
    """

    def decorator(fun: Callable) -> Callable:
        out_names = output_schema.column_names()
        universe_idx = _argument_index(fun, output_universe)

        @functools.wraps(fun)
        def wrapper(*tables: Table) -> Table:
            pd = sch.import_pandas("pandas_transformer")
            if not tables:
                raise ValueError("pandas_transformer needs at least one input table")

            # Fold every input table into a single row keyed by the empty group key so
            # one apply sees all materialized inputs.
            reduced: list[Table] = []
            for table in tables:
                cols = [table[n] for n in table.column_names()]
                zipped = table.select(
                    _pw_row=expr.apply(lambda *parts: tuple(parts), table.id, *cols)
                )
                reduced.append(zipped.reduce(_pw_rows=reducers.sorted_tuple(zipped._pw_row)))

            first = reduced[0]
            col_names = [t.column_names() for t in tables]

            def run_pandas(*rowsets: tuple) -> tuple:
                frames = []
                for rows, names in zip(rowsets, col_names):
                    ids = [r[0] for r in rows]
                    data = {
                        name: [r[i + 1] for r in rows] for i, name in enumerate(names)
                    }
                    frames.append(pd.DataFrame(data, index=ids))
                result = fun(*frames)
                if isinstance(result, pd.Series):
                    result = pd.DataFrame(result)
                result.columns = out_names
                if universe_idx is not None and set(result.index) != set(
                    frames[universe_idx].index
                ):
                    # universe equality is a key-set property; row order may differ
                    raise ValueError(
                        "resulting universe does not match the universe of the indicated argument"
                    )
                if not result.index.is_unique:
                    raise ValueError("index of resulting DataFrame must be unique")
                out_rows = []
                for idx, row in zip(result.index, result.itertuples(index=False)):
                    key = idx if isinstance(idx, Pointer) else pointer_from(idx)
                    out_rows.append((key, *row))
                return tuple(out_rows)

            applied = first.select(
                _pw_out=expr.apply(run_pandas, *[t._pw_rows for t in reduced])
            )
            flattened = applied.flatten(applied._pw_out)
            unpacked = unpack_col(flattened._pw_out, "_pw_id", *out_names)
            output = unpacked.with_id(unpacked._pw_id).without("_pw_id")
            if universe_idx is not None:
                output.promise_universe_is_equal_to(tables[universe_idx])
                output = output.with_universe_of(tables[universe_idx])
            return output.update_types(**output_schema.typehints())

        return wrapper

    return decorator
