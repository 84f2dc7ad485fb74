"""Custom and stateful reducers (port of ``pathway_tpu/internals/custom_reducers.py``):
``BaseCustomAccumulator`` subclasses through ``pw.reducers.udf_reducer``, and
``pw.reducers.stateful_many`` / ``stateful_single``."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals.reducers import Accumulator, Reducer


class BaseCustomAccumulator:
    """User-defined accumulator: implement from_row, update, compute_result, optionally
    retract."""

    @classmethod
    def from_row(cls, row: list) -> "BaseCustomAccumulator":
        raise NotImplementedError

    def update(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError

    def retract(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError("this accumulator does not support retractions")

    def compute_result(self) -> Any:
        raise NotImplementedError


class _CustomAcc(Accumulator):
    def __init__(self, acc_cls: type[BaseCustomAccumulator]):
        self.acc_cls = acc_cls
        self.state: BaseCustomAccumulator | None = None
        self.rows: list[tuple] = []  # fallback for non-retractable accumulators

    def insert(self, values: tuple) -> None:
        incoming = self.acc_cls.from_row(list(values))
        self.rows.append(values)
        if self.state is None:
            self.state = incoming
        else:
            self.state.update(incoming)

    def retract(self, values: tuple) -> None:
        self.rows.remove(values)
        incoming = self.acc_cls.from_row(list(values))
        try:
            assert self.state is not None
            self.state.retract(incoming)
        except NotImplementedError:
            # rebuild from scratch
            self.state = None
            for row in self.rows:
                incoming = self.acc_cls.from_row(list(row))
                if self.state is None:
                    self.state = incoming
                else:
                    self.state.update(incoming)

    def value(self) -> Any:
        return self.state.compute_result() if self.state is not None else None


class CustomReducer(Reducer):
    def __init__(self, acc_cls: type[BaseCustomAccumulator], n_args: int = 1):
        self.acc_cls = acc_cls
        self.name = f"custom:{acc_cls.__name__}"
        self.n_args = n_args

    def make(self) -> Accumulator:
        return _CustomAcc(self.acc_cls)


def make_custom_reducer(acc_cls: type[BaseCustomAccumulator]) -> Callable:
    def reducer_call(*args: Any) -> expr.ReducerExpression:
        return expr.ReducerExpression(CustomReducer(acc_cls, n_args=len(args)), *args)

    return reducer_call


class _StatefulManyAcc(Accumulator):
    """``stateful_many``: state = combine(state, rows)."""

    def __init__(self, combine: Callable):
        self.combine = combine
        self.rows: list[tuple] = []

    def insert(self, values: tuple) -> None:
        self.rows.append(values)

    def retract(self, values: tuple) -> None:
        self.rows.remove(values)

    def value(self) -> Any:
        state = None
        state = self.combine(state, [(row, 1) for row in self.rows])
        return state


def stateful_many(combine_many: Callable) -> Callable:
    def reducer_call(*args: Any) -> expr.ReducerExpression:
        class _R(Reducer):
            name = f"stateful_many:{getattr(combine_many, '__name__', 'fn')}"
            n_args = len(args)

            def make(self) -> Accumulator:
                return _StatefulManyAcc(combine_many)

        return expr.ReducerExpression(_R(), *args)

    return reducer_call


def stateful_single(combine_single: Callable) -> Callable:
    def combine_many(state: Any, rows: list) -> Any:
        for row, diff in rows:
            if diff < 0:
                raise ValueError("stateful_single does not support retractions")
            state = combine_single(state, *row)
        return state

    return stateful_many(combine_many)
