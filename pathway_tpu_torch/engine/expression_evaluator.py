"""Row-wise expression evaluation (port of ``pathway_tpu/engine/expression_evaluator.py``).

The host interpreter: vectorized numpy over whole column batches, ``apply``
UDFs batched at the column level rather than row at a time. The reference's
fusion compiler (whole select/filter chains lowered to device programs) is
not ported; every expression runs here.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict

import numpy as np

from pathway_tpu_torch.engine.columnar import ERROR, Error
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import keys_from_values, keys_to_pointers, pointer_from


class EvalContext:
    """Resolves column references to materialized numpy columns for one batch.

    ``diffs`` + ``memo`` enable non-deterministic-apply replay: a UDF flagged
    ``deterministic=False`` must emit the SAME value when a row retracts as it did
    when the row was inserted (reference UDF ``deterministic`` contract,
    ``internals/udfs/__init__.py``) — so insert-row results are memoized by row key
    and retraction rows replay them instead of re-invoking the UDF. This is both a
    correctness obligation (a re-invocation could differ, leaving a dangling
    retraction) and the serving-path fast path (a query's delete-completed
    retraction must not re-run the embedder)."""

    def __init__(
        self,
        n_rows: int,
        resolver: Callable[[expr.ColumnReference], np.ndarray],
        keys: np.ndarray | None = None,
        diffs: np.ndarray | None = None,
        memo: Dict[Any, dict] | None = None,
        memo_tokens: Dict[int, str] | None = None,
    ):
        self.n_rows = n_rows
        self.resolver = resolver
        self.keys = keys
        self.diffs = diffs
        self.memo = memo
        # id(expr) -> stable snapshot-safe token (see Evaluator._memo_tokens)
        self.memo_tokens = memo_tokens or {}


# Run-scoped settings, set per thread by the GraphRunner: the UDF error policy
# (when not terminating, a raising UDF poisons its cell with Error and reports
# to the error log instead of failing the run), the device the run offloads
# to, the error log of operators without a local one, and the operator being
# evaluated.
import threading as _threading

_runtime_tls = _threading.local()


def get_runtime() -> Dict[str, Any]:
    rt = getattr(_runtime_tls, "rt", None)
    if rt is None:
        rt = _runtime_tls.rt = {
            "terminate_on_error": True,
            "device": None,
            # set by the outermost run; nested iterate runners inherit it
            "global_source": None,
            "node": None,
        }
    return rt


def report_udf_error(message: str) -> None:
    """Append a row to the error log of the operator being evaluated."""
    rt = get_runtime()
    node = rt["node"]
    source = getattr(node, "error_log_source", None) or rt["global_source"]
    if source is not None:
        frame = getattr(node, "user_frame", None)
        trace = None
        if frame is not None:
            trace = {
                "file": frame.filename,
                "line": frame.line_number,
                "function": frame.function,
            }
        source.push(node.id if node is not None else -1, message, trace)


def _call_udf(fun: Callable, args: list, kwargs: dict) -> Any:
    if get_runtime()["terminate_on_error"]:
        return fun(*args, **kwargs)
    try:
        return fun(*args, **kwargs)
    except Exception as exc:
        report_udf_error(f"{type(exc).__name__}: {exc}")
        return ERROR


def _broadcast_const(value: Any, n: int) -> np.ndarray:
    if isinstance(value, (bool, np.bool_)):
        return np.full(n, value, dtype=np.bool_)
    if isinstance(value, (int, np.integer)):
        return np.full(n, value, dtype=np.int64)
    if isinstance(value, (float, np.floating)):
        return np.full(n, value, dtype=np.float64)
    out = np.empty(n, dtype=object)
    out[:] = [value] * n
    return out


_NUMERIC_KINDS = frozenset("bif")


def _is_numeric(arr: np.ndarray) -> bool:
    return arr.dtype != object and arr.dtype.kind in _NUMERIC_KINDS


def _checked_div(op: Callable, left: np.ndarray, right: np.ndarray) -> np.ndarray:
    bad = right == 0
    if np.any(bad):
        safe = np.where(bad, 1, right)
        result = op(left, safe).astype(object)
        result[np.asarray(bad)] = ERROR
        return result
    return op(left, right)


def _object_binary(op: Callable, left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Python-semantics elementwise op with Error poisoning."""

    def wrapped(a: Any, b: Any) -> Any:
        if isinstance(a, Error) or isinstance(b, Error):
            return ERROR
        try:
            return op(a, b)
        except Exception:
            return ERROR

    return np.frompyfunc(wrapped, 2, 1)(left, right)


def _tidy(arr: np.ndarray) -> np.ndarray:
    """Collapse object arrays of uniform numeric values back to typed arrays."""
    if arr.dtype != object or len(arr) == 0:
        return arr
    first = arr[0]
    if isinstance(first, (bool, np.bool_)):
        try:
            return arr.astype(np.bool_)
        except (ValueError, TypeError):
            return arr
    if isinstance(first, (int, np.integer)) and not isinstance(first, bool):
        try:
            return arr.astype(np.int64)
        except (ValueError, TypeError, OverflowError):
            return arr
    if isinstance(first, (float, np.floating)):
        try:
            return arr.astype(np.float64)
        except (ValueError, TypeError):
            return arr
    return arr


class ExpressionEvaluator:
    """Evaluates an expression AST over a batch of rows."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx

    def eval(self, e: expr.ColumnExpression) -> np.ndarray:
        result = self._eval(e)
        if np.isscalar(result) or (isinstance(result, np.ndarray) and result.ndim == 0):
            return _broadcast_const(result.item() if hasattr(result, "item") else result, self.ctx.n_rows)
        return result

    # -- dispatch -----------------------------------------------------------

    def _eval(self, e: expr.ColumnExpression) -> np.ndarray:
        method = getattr(self, "_eval_" + type(e).__name__, None)
        if method is None:
            raise NotImplementedError(f"cannot evaluate {type(e).__name__}")
        return method(e)

    def _eval_ColumnConstExpression(self, e: expr.ColumnConstExpression) -> np.ndarray:
        return _broadcast_const(e._value, self.ctx.n_rows)

    def _eval_ColumnReference(self, e: expr.ColumnReference) -> np.ndarray:
        return self.ctx.resolver(e)

    def _eval_ColumnBinaryOpExpression(self, e: expr.ColumnBinaryOpExpression) -> np.ndarray:
        left = self._eval(e._left)
        right = self._eval(e._right)
        op = e._operator
        if _is_numeric(left) and _is_numeric(right):
            if op in (operator.truediv, operator.floordiv, operator.mod):
                return _checked_div(op, left, right)
            if op is operator.pow and left.dtype.kind == "i" and np.any(right < 0):
                return op(left.astype(np.float64), right)
            if op in (operator.and_, operator.or_, operator.xor) and (
                left.dtype == np.bool_ or right.dtype == np.bool_
            ):
                return op(left.astype(np.bool_), right.astype(np.bool_))
            return op(left, right)
        # datetime arithmetic stays in numpy datetime64/timedelta64
        if left.dtype != object and right.dtype != object:
            try:
                return op(left, right)
            except TypeError:
                pass
        return _tidy(_object_binary(op, left, right))

    def _eval_ColumnUnaryOpExpression(self, e: expr.ColumnUnaryOpExpression) -> np.ndarray:
        val = self._eval(e._expr)
        op = e._operator
        if _is_numeric(val):
            if op is operator.not_:
                return ~val.astype(np.bool_)
            return op(val)
        def wrapped(a: Any) -> Any:
            if isinstance(a, Error):
                return ERROR
            try:
                return op(a)
            except Exception:
                return ERROR
        return _tidy(np.frompyfunc(wrapped, 1, 1)(val))

    def _eval_IfElseExpression(self, e: expr.IfElseExpression) -> np.ndarray:
        cond = self._eval(e._if)
        then = self._eval(e._then)
        otherwise = self._eval(e._else)
        if cond.dtype == object:
            err = np.frompyfunc(lambda v: isinstance(v, Error), 1, 1)(cond).astype(bool)
            safe = np.where(err, False, cond)
            cond = safe.astype(np.bool_)
            if err.any():
                # poisoned condition poisons the output cell (Value::Error contract)
                out = np.empty(self.ctx.n_rows, dtype=object)
                out[cond] = then[cond]
                out[~cond] = otherwise[~cond]
                out[err] = ERROR
                return out
        if then.dtype == object or otherwise.dtype == object:
            out = np.empty(self.ctx.n_rows, dtype=object)
            out[cond] = then[cond]
            out[~cond] = otherwise[~cond]
            return _tidy(out)
        if then.dtype != otherwise.dtype:
            common = np.promote_types(then.dtype, otherwise.dtype)
            then = then.astype(common)
            otherwise = otherwise.astype(common)
        return np.where(cond, then, otherwise)

    def _eval_CoalesceExpression(self, e: expr.CoalesceExpression) -> np.ndarray:
        args = [self._eval(a) for a in e._args]
        out = np.empty(self.ctx.n_rows, dtype=object)
        out[:] = None
        filled = np.zeros(self.ctx.n_rows, dtype=bool)
        for arr in args:
            if arr.dtype == object:
                present = np.frompyfunc(lambda v: v is not None, 1, 1)(arr).astype(bool)
            else:
                present = np.ones(self.ctx.n_rows, dtype=bool)
            take = present & ~filled
            out[take] = arr[take]
            filled |= present
            if filled.all():
                break
        return _tidy(out)

    def _eval_RequireExpression(self, e: expr.RequireExpression) -> np.ndarray:
        val = self._eval(e._val)
        out = val.astype(object) if val.dtype != object else val.copy()
        for arg in e._args:
            arr = self._eval(arg)
            if arr.dtype == object:
                missing = np.frompyfunc(lambda v: v is None, 1, 1)(arr).astype(bool)
                out[missing] = None
        return _tidy(out)

    def _eval_IsNoneExpression(self, e: expr.IsNoneExpression) -> np.ndarray:
        val = self._eval(e._expr)
        if val.dtype != object:
            return np.zeros(self.ctx.n_rows, dtype=np.bool_)
        return np.frompyfunc(lambda v: v is None, 1, 1)(val).astype(np.bool_)

    def _eval_IsNotNoneExpression(self, e: expr.IsNotNoneExpression) -> np.ndarray:
        return ~self._eval_IsNoneExpression(expr.IsNoneExpression(e._expr))

    def _eval_CastExpression(self, e: expr.CastExpression) -> np.ndarray:
        return self._convert(self._eval(e._expr), e._target, strict=False)

    def _eval_ConvertExpression(self, e: expr.ConvertExpression) -> np.ndarray:
        val = self._eval(e._expr)
        default = self._eval(e._default)
        out = self._convert(val, e._target, strict=False, default=default)
        return out

    def _eval_DeclareTypeExpression(self, e: expr.DeclareTypeExpression) -> np.ndarray:
        return self._eval(e._expr)

    def _eval_UnwrapExpression(self, e: expr.UnwrapExpression) -> np.ndarray:
        val = self._eval(e._expr)
        if val.dtype == object:
            has_none = np.frompyfunc(lambda v: v is None, 1, 1)(val).astype(bool)
            if np.any(has_none):
                raise ValueError("unwrap() applied to a None value")
            return _tidy(val)
        return val

    def _eval_FillErrorExpression(self, e: expr.FillErrorExpression) -> np.ndarray:
        val = self._eval(e._expr)
        repl = self._eval(e._replacement)
        if val.dtype != object:
            return val
        is_err = np.frompyfunc(lambda v: isinstance(v, Error), 1, 1)(val).astype(bool)
        if not np.any(is_err):
            return val
        out = val.copy()
        out[is_err] = repl[is_err]
        return _tidy(out)

    def _convert(
        self,
        val: np.ndarray,
        target: dt.DType,
        strict: bool,
        default: np.ndarray | None = None,
    ) -> np.ndarray:
        def conv(v: Any, d: Any = None) -> Any:
            if isinstance(v, Error):
                return ERROR
            if v is None:
                return d
            try:
                if isinstance(v, Json):
                    v = v.value
                    if v is None:
                        return d
                if target == dt.INT:
                    return int(v)
                if target == dt.FLOAT:
                    return float(v)
                if target == dt.BOOL:
                    if isinstance(v, (bool, np.bool_)):
                        return bool(v)
                    raise ValueError(f"cannot convert {v!r} to bool")
                if target == dt.STR:
                    return str(v)
                return v
            except (ValueError, TypeError):
                return ERROR

        if default is not None:
            out = np.frompyfunc(conv, 2, 1)(val, default)
        else:
            out = np.frompyfunc(lambda v: conv(v, None), 1, 1)(val)
        return _tidy(out)

    _MEMO_MISS = object()

    def _memo_store(self, e: expr.ApplyExpression) -> "dict | None":
        """The per-expression replay store for a non-deterministic apply, when the
        calling evaluator supplied keys/diffs/memo (see EvalContext docstring)."""
        ctx = self.ctx
        if (
            getattr(e, "_deterministic", True)
            or ctx.keys is None
            or ctx.diffs is None
            or ctx.memo is None
        ):
            return None
        return ctx.memo.setdefault(ctx.memo_tokens.get(id(e), id(e)), {})

    def _memo_replay(self, store: "dict | None", out: np.ndarray) -> np.ndarray:
        """Fill retraction rows from the store; returns the replayed-row mask."""
        replayed = np.zeros(self.ctx.n_rows, dtype=bool)
        if store:
            from pathway_tpu_torch.internals.keys import key_bytes

            neg = np.nonzero(self.ctx.diffs < 0)[0]
            if len(neg):
                for i, kb in zip(neg, key_bytes(self.ctx.keys[neg])):
                    v = store.pop(kb, self._MEMO_MISS)
                    if v is not self._MEMO_MISS:
                        out[i] = v
                        replayed[i] = True
        return replayed

    def _memo_record(self, store: "dict | None", out: np.ndarray) -> None:
        if store is None:
            return
        from pathway_tpu_torch.internals.keys import key_bytes

        pos = np.nonzero(self.ctx.diffs > 0)[0]
        if len(pos):
            for i, kb in zip(pos, key_bytes(self.ctx.keys[pos])):
                store[kb] = out[i]

    def _eval_ApplyExpression(self, e: expr.ApplyExpression) -> np.ndarray:
        args = [self._eval(a) for a in e._args]
        kwargs = {k: self._eval(v) for k, v in e._kwargs.items()}
        out = np.empty(self.ctx.n_rows, dtype=object)
        store = self._memo_store(e)
        replayed = self._memo_replay(store, out)
        for i in range(self.ctx.n_rows):
            if replayed[i]:
                continue
            row_args = [a[i] for a in args]
            row_kwargs = {k: v[i] for k, v in kwargs.items()}
            if e._propagate_none and (
                any(a is None for a in row_args) or any(v is None for v in row_kwargs.values())
            ):
                out[i] = None
                continue
            if any(isinstance(a, Error) for a in row_args) or any(
                isinstance(v, Error) for v in row_kwargs.values()
            ):
                out[i] = ERROR
                continue
            out[i] = _call_udf(e._fun, row_args, row_kwargs)
        self._memo_record(store, out)
        return _tidy(out) if e._return_type != dt.ANY else out

    def _eval_BatchApplyExpression(self, e: expr.ApplyExpression) -> np.ndarray:
        args = [self._eval(a) for a in e._args]
        kwargs = {k: self._eval(v) for k, v in e._kwargs.items()}
        max_bs = e._max_batch_size or self.ctx.n_rows or 1
        out = np.empty(self.ctx.n_rows, dtype=object)
        store = self._memo_store(e)
        replayed = self._memo_replay(store, out)
        # poisoned rows never reach the UDF; their outputs stay ERROR
        poisoned = np.zeros(self.ctx.n_rows, dtype=bool)
        for col in args + list(kwargs.values()):
            if col.dtype == object:
                poisoned |= np.frompyfunc(lambda v: isinstance(v, Error), 1, 1)(col).astype(
                    bool
                )
        poisoned &= ~replayed
        clean_idx = np.nonzero(~poisoned & ~replayed)[0]
        out[poisoned] = ERROR
        for start in range(0, len(clean_idx), max_bs):
            idx = clean_idx[start : start + max_bs]
            batch_args = [list(a[idx]) for a in args]
            batch_kwargs = {k: list(v[idx]) for k, v in kwargs.items()}
            results = _call_udf(e._fun, batch_args, batch_kwargs)
            if isinstance(results, Error):
                for i in idx:
                    out[i] = ERROR
                continue
            results = list(results)
            if len(results) != len(idx):
                raise ValueError(
                    f"batch UDF returned {len(results)} results for a batch of {len(idx)} rows"
                )
            for i, r in zip(idx, results):
                out[i] = r
        self._memo_record(store, out)
        return out

    def _eval_AsyncApplyExpression(self, e: expr.AsyncApplyExpression) -> np.ndarray:
        """One commit's rows awaited together (``asyncio.gather``); a row
        whose coroutine raises fails the run under ``terminate_on_error``,
        else its cell is ``Error``. The batch's seconds and rows go to the
        ``eval.async_udf_s`` / ``eval.async_udf_rows`` stage counters."""
        import asyncio
        import time

        args = [self._eval(a) for a in e._args]
        kwargs = {k: self._eval(v) for k, v in e._kwargs.items()}
        out = np.empty(self.ctx.n_rows, dtype=object)
        store = self._memo_store(e)
        replayed = self._memo_replay(store, out)
        run_rows = np.nonzero(~replayed)[0]

        async def run_all() -> list:
            tasks = [
                e._fun(*[a[i] for a in args], **{k: v[i] for k, v in kwargs.items()})
                for i in run_rows
            ]
            return await asyncio.gather(*tasks, return_exceptions=True)

        t0 = time.perf_counter()
        results = _run_coro(run_all())
        if len(run_rows):
            from pathway_tpu_torch.engine import telemetry

            telemetry.stage_add_many({
                "eval.async_udf_s": time.perf_counter() - t0,
                "eval.async_udf_rows": float(len(run_rows)),
            })
        terminate = get_runtime()["terminate_on_error"]
        for i, r in zip(run_rows, results):
            if isinstance(r, Exception):
                if terminate:
                    raise r
                report_udf_error(f"{type(r).__name__}: {r}")
                out[i] = ERROR
            else:
                out[i] = r
        self._memo_record(store, out)
        return _tidy(out)

    _eval_FullyAsyncApplyExpression = _eval_AsyncApplyExpression

    def _eval_PointerExpression(self, e: expr.PointerExpression) -> np.ndarray:
        args = [self._eval(a) for a in e._args]
        if e._instance is not None:
            args.append(self._eval(e._instance))
        out = np.empty(self.ctx.n_rows, dtype=object)
        if args and self.ctx.n_rows:
            # one batch hash: keys_from_values(cols)[i] == pointer_from(*row i)
            out[:] = keys_to_pointers(keys_from_values([np.asarray(a) for a in args]))
            return out
        for i in range(self.ctx.n_rows):
            out[i] = pointer_from(*[a[i] for a in args])
        return out

    def _eval_MakeTupleExpression(self, e: expr.MakeTupleExpression) -> np.ndarray:
        args = [self._eval(a) for a in e._args]
        out = np.empty(self.ctx.n_rows, dtype=object)
        for i in range(self.ctx.n_rows):
            out[i] = tuple(a[i] for a in args)
        return out

    def _eval_GetExpression(self, e: expr.GetExpression) -> np.ndarray:
        obj = self._eval(e._object)
        index = self._eval(e._index)
        default = self._eval(e._default)
        out = np.empty(self.ctx.n_rows, dtype=object)
        for i in range(self.ctx.n_rows):
            o, idx = obj[i], index[i]
            try:
                if isinstance(o, Json):
                    v = o.value[idx]
                    out[i] = Json(v) if isinstance(v, (dict, list)) else v
                else:
                    out[i] = o[idx]
            except (KeyError, IndexError, TypeError) as exc:
                if e._check_if_exists:
                    out[i] = default[i]
                elif get_runtime()["terminate_on_error"]:
                    # checked [] access: a missing index fails the run unless
                    # error poisoning was opted into (reference get_checked).
                    # Keep the original exception type — a KeyError on a Json
                    # dict must not read as a sequence-bounds problem
                    raise type(exc)(
                        f"cannot index {o!r} with {idx!r}"
                    ) from exc
                else:
                    out[i] = ERROR
        return _tidy(out)

    def _eval_MethodCallExpression(self, e: expr.MethodCallExpression) -> np.ndarray:
        args = [self._eval(a) for a in e._args]
        return e._fun(*args)


def _run_coro(coro: Any) -> Any:
    """Run ``coro`` to its end on a loop of its own, closed after: on this
    thread, or on a one-off worker thread when this thread already runs a
    loop (``asyncio.run`` refuses to nest)."""
    import asyncio

    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        return pool.submit(asyncio.run, coro).result()


def evaluate(
    e: expr.ColumnExpression,
    n_rows: int,
    resolver: Callable[[expr.ColumnReference], np.ndarray],
    keys: np.ndarray | None = None,
    diffs: np.ndarray | None = None,
    memo: "Dict[Any, dict] | None" = None,
    memo_tokens: "Dict[int, str] | None" = None,
) -> np.ndarray:
    return ExpressionEvaluator(
        EvalContext(n_rows, resolver, keys, diffs, memo, memo_tokens)
    ).eval(e)
