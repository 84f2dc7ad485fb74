"""Incremental operator evaluators (port of ``pathway_tpu/engine/evaluators.py``).

Each parse-graph node kind gets an evaluator that consumes input ``Delta``
batches and emits an output ``Delta`` per commit, keeping whatever keyed
state incrementality requires (differential dataflow's operators, at batch
granularity), on one process: every operator of the reference but the row
transformers. ``pw.iterate``'s evaluators live in ``internals/iterate.py``.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from typing import Any, Callable, Dict, List, Set, Tuple

import numpy as np

from pathway_tpu_torch.engine import expression_evaluator as ee
from pathway_tpu_torch.engine.columnar import ERROR, Delta, Error, StateTable, objarray
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals.keys import (
    KEY_DTYPE,
    Pointer,
    broadcast_key,
    combine_keys,
    derived_keys,
    hash_upsert,
    key_bytes,
    keys_from_values,
    keys_to_pointers,
    pointer_column_keys,
    pointer_from,
    pointers_to_keys,
    reindexed_keys,
)
from pathway_tpu_torch.internals.reducers import _IdMarker, _SeqMarker
from pathway_tpu_torch.native import I64P as _I64P
from pathway_tpu_torch.native import U64P as _U64P


class UnpicklableStateError(Exception):
    """An operator's state cannot be checkpointed: the journal keeps the
    whole history."""


def _to_host(v: Any) -> Any:
    """A memoized UDF value as a checkpoint holds it: a card tensor becomes
    a CPU tensor (the query path keeps embeddings on the card)."""
    if type(v).__module__.startswith("torch") and getattr(v, "is_cuda", False):
        return v.detach().cpu()
    return v


def _collect_nondet_exprs(value: Any, found: List[Any], seen: set) -> None:
    """Deterministic walk over a node config collecting non-deterministic apply
    expressions (dicts by sorted key, sequences in order, expression trees by
    ``_deps`` order): the walk order gives each expression its memo token."""
    if isinstance(value, expr.ColumnExpression):
        if id(value) in seen:
            return
        seen.add(id(value))
        if isinstance(value, expr.ApplyExpression) and not value._deterministic:
            found.append(value)
        for dep in value._deps():
            _collect_nondet_exprs(dep, found, seen)
    elif isinstance(value, dict):
        for k in sorted(value, key=repr):
            _collect_nondet_exprs(value[k], found, seen)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _collect_nondet_exprs(v, found, seen)


def filter_mask_to_bool(mask: np.ndarray) -> np.ndarray:
    """Filter predicate column → boolean row mask: poisoned (Error) cells drop
    the row."""
    if mask.dtype == object:
        mask = np.frompyfunc(
            lambda v: bool(v) if not isinstance(v, Error) else False, 1, 1
        )(mask).astype(bool)
    return mask.astype(bool)


def id_pointer_column(keys: np.ndarray) -> np.ndarray:
    """The materialized ``id`` pseudo-column: row-key Pointers boxed in an
    object array."""
    out = np.empty(len(keys), dtype=object)
    out[:] = keys_to_pointers(keys)
    return out


class Evaluator:
    def __init__(self, node: pg.Node, runner: Any):
        self.node = node
        self.runner = runner
        self.output_columns: List[str] = (
            node.output.column_names() if node.output is not None else []
        )
        found: List[Any] = []
        _collect_nondet_exprs(node.config, found, set())
        # id(expr) -> stable token keying the replay memo (_udf_memo)
        self._memo_tokens: Dict[int, str] = {
            id(e): f"nd{i}" for i, e in enumerate(found)
        }

    # False where a pre-commit state_dict() / load_state_dict() round trip
    # does not restore the operator (its state is huge or mutated in place);
    # the undo ring that reads it is not ported yet
    REWIND_SAFE = True
    # False where the operator's state lies outside the snapshot protocol
    # (an index on the card): a graph holding one is never checkpointed and
    # resumes by replaying the whole journal
    SNAPSHOT_CAPTURE = True

    def process(self, input_deltas: List[Delta]) -> Delta:
        raise NotImplementedError

    def has_pending(self) -> bool:
        """Whether rows are held for a later commit."""
        return False

    # -- operator snapshots ----------------------------------------------------

    _NON_STATE_ATTRS = ("node", "runner", "output_columns", "_memo_tokens")

    def state_dict(self) -> Dict[str, bytes]:
        """A picklable snapshot of this operator's incremental state, per
        attribute. Graph configuration (expressions, callbacks) is left out by
        name (``_NON_STATE_ATTRS``): the signature-checked graph rebuilds it.
        A state attribute that does not pickle aborts the checkpoint
        (``UnpicklableStateError``): dropping it would compact away journal
        history that a restore then cannot rebuild."""
        import pickle

        out: Dict[str, bytes] = {}
        for name, value in self.__dict__.items():
            if name in self._NON_STATE_ATTRS:
                continue
            if name == "_udf_memo":
                # replay values may live on the card: keep their host copy
                value = {
                    tok: {kb: _to_host(v) for kb, v in store.items()}
                    for tok, store in value.items()
                }
            try:
                out[name] = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
            except Exception as exc:
                raise UnpicklableStateError(
                    f"{type(self).__name__}.{name} is not picklable ({exc}); "
                    "operator checkpointing is unavailable for this pipeline"
                ) from exc
        return out

    def load_state_dict(self, state: Dict[str, bytes]) -> None:
        import pickle

        for name, blob in state.items():
            self.__dict__[name] = pickle.loads(blob)

    def neu_pending(self) -> bool:
        """Whether forgetting retractions wait for this commit's neu phase."""
        return False

    # -- helpers ------------------------------------------------------------

    def _resolver_for(self, table: Any, delta: Delta) -> Callable[[expr.ColumnReference], np.ndarray]:
        """Resolve column refs against a delta of ``table``; cross-table refs hit state.

        Retraction rows resolve cross-table refs against the *retracted* values: when the
        referenced table replaced a key this commit (a -1/+1 pair on the same key), the
        materialized state already holds the new value, but a retraction must carry what
        was originally emitted (differential dataflow matches on values, not on
        current state)."""

        def resolver(ref: expr.ColumnReference) -> np.ndarray:
            if ref.table is table:
                if ref.name == "id":
                    return id_pointer_column(delta.keys)
                return delta.columns[ref.name]
            # cross-table reference: same-universe lookup by key in materialized state
            state = self.runner.state_of(ref.table._node)
            if ref.name == "id":
                return id_pointer_column(delta.keys)
            slots = state.lookup(delta.keys)
            hit = slots >= 0
            if hit.all() and len(state):
                out = state.gather(ref.name, slots)  # fancy indexing already copied
            else:
                # a same-universe reference must hit: a miss means the tables' key sets
                # genuinely differ (e.g. select over a reindexed table referencing the
                # pre-reindex table) — poison instead of silently yielding None
                out = np.empty(len(delta), dtype=object)
                out[:] = ERROR
                if hit.any():
                    out[hit] = state.gather(ref.name, slots[hit])
            if np.any(delta.diffs < 0):
                # retraction rows resolve against the *retracted* upstream values when
                # the referenced table replaced the key this commit (see docstring)
                ref_delta = self.runner.current_delta_of(ref.table._node)
                if ref_delta is not None and len(ref_delta):
                    neg = np.nonzero(ref_delta.diffs < 0)[0]
                    ref_col = ref_delta.columns.get(ref.name)
                    if len(neg) and ref_col is not None:
                        from pathway_tpu_torch.engine.index import KeyIndex

                        ret_idx = KeyIndex(len(neg))
                        ret_slots, _ = ret_idx.upsert(ref_delta.keys[neg])
                        slot_values = np.empty(ret_idx.slot_bound(), dtype=ref_col.dtype)
                        slot_values[ret_slots] = ref_col[neg]
                        mine = np.nonzero(delta.diffs < 0)[0]
                        found = ret_idx.lookup(delta.keys[mine])
                        use = found >= 0
                        if use.any():
                            if out.dtype != object and out.dtype != slot_values.dtype:
                                out = out.astype(object)
                            out[mine[use]] = slot_values[found[use]]
            return ee._tidy(out) if out.dtype == object else out

        return resolver

    def _eval_expr(
        self, e: expr.ColumnExpression, delta: Delta, resolver: Callable
    ) -> np.ndarray:
        """Evaluate with non-deterministic-apply replay wired in: retraction rows
        reuse the value computed at insert time (see EvalContext docstring)."""
        return ee.evaluate(
            e,
            len(delta),
            resolver,
            keys=delta.keys,
            diffs=delta.diffs,
            memo=self.__dict__.setdefault("_udf_memo", {}),
            memo_tokens=self._memo_tokens,
        )

    def _eval_exprs(
        self, exprs: Dict[str, expr.ColumnExpression], table: Any, delta: Delta
    ) -> Dict[str, np.ndarray]:
        resolver = self._resolver_for(table, delta)
        return {name: self._eval_expr(e, delta, resolver) for name, e in exprs.items()}


class InputEvaluator(Evaluator):
    """Source node: pulls batches from its DataSource each commit."""

    def process(self, input_deltas: List[Delta]) -> Delta:
        source = self.node.config["source"]
        delta = source.next_batch(self.output_columns)
        if len(delta) == 0:
            return delta
        # a keyed upsert stream (e.g. Debezium CDC) can retract and re-add the same key
        # within one commit; net the multiplicities so state application is order-free
        return delta.consolidated()


class RowwiseEvaluator(Evaluator):
    """select/with_columns. Cross-table column references are LIVE dependencies
    (a read of another same-universe table is a dataflow edge): when a
    referenced table emits a delta this commit, the affected rows of THIS table
    re-evaluate and re-emit even though the primary input saw no delta."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        own = node.inputs[0]
        cross: Dict[int, Any] = {}
        for e in node.config["exprs"].values():
            for ref in e._column_refs:
                if ref.table is not own:
                    cross[ref.table._node.id] = ref.table._node
        self._cross_nodes = list(cross.values())

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        table = self.node.inputs[0]
        parts: List[Delta] = []
        if len(delta):
            columns = self._eval_exprs(self.node.config["exprs"], table, delta)
            parts.append(Delta(delta.keys, delta.diffs, columns))
        if self._cross_nodes:
            refreshed = self._cross_refresh(delta)
            if refreshed is not None:
                parts.append(refreshed)
        if not parts:
            return Delta.empty(self.output_columns)
        if len(parts) == 1:
            return parts[0]
        return Delta.concat(parts, self.output_columns)

    def _cross_refresh(self, own_delta: Delta) -> Delta | None:
        """Retract+reinsert rows whose cross-referenced values changed this
        commit (keys from the referenced tables' deltas, restricted to this
        table's universe, minus rows the primary delta already covers)."""
        runner = self.runner
        key_parts = []
        for ref_node in self._cross_nodes:
            d = runner.current_delta_of(ref_node)
            if d is not None and len(d):
                key_parts.append(d.keys)
        if not key_parts:
            return None
        seen: set = set()
        own_keys = set(key_bytes(own_delta.keys)) if len(own_delta) else set()
        kept: List[np.void] = []
        for arr in key_parts:
            for i, kb in enumerate(key_bytes(arr)):
                if kb in seen or kb in own_keys:
                    continue
                seen.add(kb)
                kept.append(arr[i])
        if not kept:
            return None
        keys = np.array(kept, dtype=KEY_DTYPE)
        in_state = runner.state_of(self.node.inputs[0]._node)
        slots = in_state.lookup(keys)
        present = slots >= 0
        if not present.any():
            return None
        keys = keys[present]
        slots = slots[present]
        in_cols = self.node.inputs[0].column_names()
        synth = Delta(
            keys,
            np.ones(len(keys), dtype=np.int64),
            {c: in_state.gather(c, slots) for c in in_cols},
        )
        new_cols = self._eval_exprs(self.node.config["exprs"], self.node.inputs[0], synth)
        out_state = runner.state_of(self.node)
        oslots = out_state.lookup(keys)
        had = oslots >= 0
        # suppress no-op rows: only emit where some output value actually moved
        changed = ~had  # rows never emitted always emit
        if had.any():
            idx = np.nonzero(had)[0]
            neq = np.zeros(len(idx), dtype=bool)
            for name in self.output_columns:
                old = out_state.gather(name, oslots[idx])
                neq |= _col_neq(old, new_cols[name][idx])
            changed[idx] |= neq
        if not changed.any():
            return None
        ch = np.nonzero(changed)[0]
        # batch-gather old values once per column, then assemble rows
        ret_idx = ch[had[ch]]
        old_cols = {
            c: out_state.gather(c, oslots[ret_idx]) for c in self.output_columns
        }
        old_pos = {int(i): p for p, i in enumerate(ret_idx.tolist())}
        out_keys: List[np.void] = []
        out_diffs: List[int] = []
        rows: List[dict] = []
        for i in ch.tolist():
            if had[i]:
                p = old_pos[i]
                rows.append({c: old_cols[c][p] for c in self.output_columns})
                out_keys.append(keys[i])
                out_diffs.append(-1)
            rows.append({c: new_cols[c][i] for c in self.output_columns})
            out_keys.append(keys[i])
            out_diffs.append(1)
        return _delta_from_rows(out_keys, out_diffs, rows, self.output_columns)


class FilterEvaluator(Evaluator):
    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        table = self.node.inputs[0]
        resolver = self._resolver_for(table, delta)
        mask = ee.evaluate(self.node.config["expression"], len(delta), resolver)
        return delta.select(filter_mask_to_bool(mask))


class ReindexEvaluator(Evaluator):
    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        table = self.node.inputs[0]
        resolver = self._resolver_for(table, delta)
        new_ids = ee.evaluate(self.node.config["expression"], len(delta), resolver)
        keys = pointers_to_keys(
            [p if isinstance(p, Pointer) else pointer_from(p) for p in new_ids]
        )
        return Delta(keys, delta.diffs, dict(delta.columns))


class ConcatEvaluator(Evaluator):
    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        # net live multiplicity per key: concat is a DISJOINT union, so a key
        # reaching multiplicity 2 is a collision and fails the run (reference
        # raises on duplicate keys; reindex mode cannot collide)
        self.live: Dict[bytes, int] = {}

    def process(self, input_deltas: List[Delta]) -> Delta:
        reindex = self.node.config.get("reindex", False)
        parts = []
        net: Dict[bytes, tuple] = {}  # kb -> (net diff this commit, sample key)
        for i, delta in enumerate(input_deltas):
            if len(delta) == 0:
                continue
            if reindex:
                # pointer_from(row key, input index), hashed in one pass
                delta = Delta(reindexed_keys(delta.keys, i), delta.diffs, delta.columns)
            else:
                for j in range(len(delta)):
                    kb = delta.keys[j].tobytes()
                    prev = net.get(kb)
                    net[kb] = (
                        (prev[0] if prev else 0) + int(delta.diffs[j]),
                        delta.keys[j],
                    )
            parts.append(delta)
        # collision check on the NET per-commit count: a same-commit key handoff
        # between inputs (one retracts, another inserts, any row order) is legal
        for kb, (d, key) in net.items():
            cnt = self.live.get(kb, 0) + d
            if cnt > 1:
                raise ValueError(
                    "concat: duplicate key "
                    f"{keys_to_pointers(np.array([key], dtype=KEY_DTYPE))[0]!r} — "
                    "input universes must be disjoint (use concat_reindex for "
                    "overlapping tables)"
                )
            if cnt:
                self.live[kb] = cnt
            else:
                self.live.pop(kb, None)
        return Delta.concat(parts, self.output_columns)

def _col_neq(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Elementwise inequality tolerant of object cells (ndarray values, exceptions).

    NaN compares unequal to itself, matching the previous per-row tuple compare —
    a group whose aggregate stays NaN re-emits, which is harmless."""
    try:
        res = np.asarray(old != new)
        if res.dtype == np.bool_ and res.shape == old.shape:
            return res
        # object != produced non-scalar cells (ndarray values): per-cell fallback
    except (TypeError, ValueError):
        pass

    def cell_neq(a: Any, b: Any) -> bool:
        if a is b:
            return False
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return not (
                isinstance(a, np.ndarray)
                and isinstance(b, np.ndarray)
                and np.array_equal(a, b)
            )
        try:
            return not (a == b)
        except Exception:
            return True

    return np.frompyfunc(cell_neq, 2, 1)(old, new).astype(bool)


def _group_stable(e: expr.ColumnExpression) -> bool:
    """True when the expression is a deterministic function of grouping values
    only — no reducer leaves, no non-deterministic applies anywhere in the tree."""
    if isinstance(e, expr.ReducerExpression):
        return False
    if isinstance(e, expr.ApplyExpression) and not e._deterministic:
        return False
    return all(_group_stable(d) for d in e._deps())


class GroupbyEvaluator(Evaluator):
    """Incremental groupby-reduce, fully columnar.

    Group state is struct-of-arrays indexed by dense slots from a ``KeyIndex``
    (group key -> slot): signed row counts, grouping values, one ``ColumnarState`` per
    reducer leaf (``internals/reducers.py``), and the last-emitted output row per group
    for change detection. A commit is a handful of vectorized passes — hash, upsert,
    segment-reduce, gather — with per-group Python only inside non-semigroup reducer
    fallbacks (the reference's recompute-style reducers)."""

    # the reducer expressions are graph configuration, found by id()
    _NON_STATE_ATTRS = Evaluator._NON_STATE_ATTRS + ("reducer_leaves",)

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        from pathway_tpu_torch.engine.index import KeyIndex

        self.gindex = KeyIndex()
        self._capacity = 0
        self.gkeys = np.zeros(0, dtype=KEY_DTYPE)
        self.counts = np.zeros(0, dtype=np.int64)
        self.last_valid = np.zeros(0, dtype=bool)
        self.gvals: Dict[str, np.ndarray] = {
            name: np.empty(0, dtype=object) for name in node.config["grouping_names"]
        }
        self.last_cols: Dict[str, np.ndarray] = {
            name: np.empty(0, dtype=object) for name in self.output_columns
        }
        self.reducer_leaves: List[expr.ReducerExpression] = []
        self._collect_reducers(node.config["out_exprs"])
        self.leaf_states = [leaf._reducer.make_state() for leaf in self.reducer_leaves]
        self.seq = 0
        # output columns that are pure functions of the grouping values (no
        # reducer, no non-deterministic apply) CANNOT change while a group is
        # alive — change detection skips comparing them (group keys fingerprint
        # the grouping values, so equal key implies equal value)
        self._stable_cols = {
            name
            for name, e in node.config["out_exprs"].items()
            if _group_stable(e)
        }

    def load_state_dict(self, state: Dict[str, bytes]) -> None:
        super().load_state_dict(state)
        if "groups" in self.__dict__:
            # a dict-of-groups checkpoint predates the columnar state: an empty
            # restore would corrupt the aggregates
            raise RuntimeError(
                "checkpoint was written by an incompatible (pre-columnar) build; "
                "clear the persistence directory and re-run"
            )

    def _collect_reducers(self, out_exprs: Dict[str, expr.ColumnExpression]) -> None:
        seen: set[int] = set()

        def walk(e: expr.ColumnExpression) -> None:
            if isinstance(e, expr.ReducerExpression):
                if id(e) not in seen:
                    seen.add(id(e))
                    self.reducer_leaves.append(e)
                return
            for d in e._deps():
                walk(d)

        for e in out_exprs.values():
            walk(e)

    def _ensure_capacity(self) -> None:
        bound = self.gindex.slot_bound()
        if bound <= self._capacity:
            return
        cap = max(16, 2 * self._capacity, bound)
        gkeys = np.zeros(cap, dtype=KEY_DTYPE)
        gkeys[: self._capacity] = self.gkeys
        self.gkeys = gkeys
        self.counts = np.concatenate(
            [self.counts, np.zeros(cap - len(self.counts), dtype=np.int64)]
        )
        valid = np.zeros(cap, dtype=bool)
        valid[: self._capacity] = self.last_valid
        self.last_valid = valid
        from pathway_tpu_torch.engine.columnar import grow_column

        for name in self.gvals:
            self.gvals[name] = grow_column(self.gvals[name], cap)
        for name in self.last_cols:
            self.last_cols[name] = grow_column(self.last_cols[name], cap)
        for st in self.leaf_states:
            st.ensure(cap)
        self._capacity = cap

    def _eval_out(self, slots: np.ndarray) -> Dict[str, np.ndarray]:
        """Output expressions over the given group slots, vectorized, with reducer
        leaves bound to their columnar aggregates."""
        leaf_value_arrays = {
            id(leaf): st.values(slots)
            for leaf, st in zip(self.reducer_leaves, self.leaf_states)
        }
        gval_arrays = {name: self.gvals[name][slots] for name in self.gvals}

        class _GroupEval(ee.ExpressionEvaluator):
            def _eval_ReducerExpression(self, re: expr.ReducerExpression) -> np.ndarray:
                return leaf_value_arrays[id(re)]

            def _eval_ColumnReference(self, ref: expr.ColumnReference) -> np.ndarray:
                return gval_arrays[ref.name]

        evaluator = _GroupEval(ee.EvalContext(len(slots), lambda ref: None))
        out_exprs = self.node.config["out_exprs"]
        return {name: evaluator.eval(out_exprs[name]) for name in self.output_columns}

    def _group_keys(self, grouping_vals: List[np.ndarray], n: int, set_id: bool) -> np.ndarray:
        if not grouping_vals:
            # global reduce: every row lands in the single salt-only group
            return broadcast_key(pointer_from(), n)
        if not set_id:
            return keys_from_values(grouping_vals)
        col = grouping_vals[0]
        as_keys = pointer_column_keys(np.asarray(col))
        if as_keys is not None:
            return as_keys
        out = np.empty(n, dtype=KEY_DTYPE)
        for i in range(n):
            p = col[i]
            if not isinstance(p, Pointer):
                p = pointer_from(*(g[i] for g in grouping_vals))
            out[i]["hi"], out[i]["lo"] = p.hi, p.lo
        return out

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        set_id = self.node.config.get("set_id", False)
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        table = self.node.inputs[0]
        resolver = self._resolver_for(table, delta)
        n = len(delta)
        diffs = delta.diffs

        grouping_vals = [
            ee.evaluate(g, n, resolver) for g in self.node.config["grouping"]
        ]

        # reducer argument values per leaf (vectorized)
        leaf_args: List[List[np.ndarray]] = []
        for leaf in self.reducer_leaves:
            arrays = []
            for a in leaf._args:
                if isinstance(a, _IdMarker):
                    ids = np.empty(n, dtype=object)
                    ids[:] = keys_to_pointers(delta.keys)
                    arrays.append(ids)
                elif isinstance(a, _SeqMarker):
                    seqs = np.arange(self.seq, self.seq + n, dtype=np.int64)
                    arrays.append(seqs.astype(object))
                else:
                    arrays.append(self._eval_expr(a, delta, resolver))
            leaf_args.append(arrays)
        self.seq += n

        if grouping_vals and not set_id:
            gkeys, slots, is_new = hash_upsert(self.gindex, grouping_vals)
        else:
            gkeys = self._group_keys(grouping_vals, n, set_id)
            slots, is_new = self.gindex.upsert(gkeys)
        self._ensure_capacity()
        new_slots = slots[is_new]
        if len(new_slots):
            # recycled slots start pristine
            self.counts[new_slots] = 0
            self.last_valid[new_slots] = False
            self.gkeys[new_slots] = gkeys[is_new]
            for st in self.leaf_states:
                st.reset(new_slots)
            from pathway_tpu_torch.engine.columnar import set_cells

            for gi, name in enumerate(self.gvals):
                self.gvals[name] = set_cells(
                    self.gvals[name], new_slots, np.asarray(grouping_vals[gi])[is_new]
                )

        from pathway_tpu_torch.ops.segment import segment_count

        # dense batch segmentation: an O(n + slot_bound) bitmap pass when the batch
        # is comparable to the live slot space; an O(n log n) sort when a small
        # commit touches a huge accumulated group space (bitmap would scan it all)
        bound = self.gindex.slot_bound()
        if bound <= 4 * n + 1024:
            seen = np.zeros(bound, dtype=bool)
            seen[slots] = True
            uniq_slots = np.nonzero(seen)[0]
            pos_of_slot = np.empty(bound, dtype=np.int64)
            pos_of_slot[uniq_slots] = np.arange(len(uniq_slots), dtype=np.int64)
            inverse = pos_of_slot[slots]
        else:
            uniq_slots, inverse = np.unique(slots, return_inverse=True)
        m = len(uniq_slots)
        cnt_delta = segment_count(inverse, m, weights=diffs)
        counts_after = self.counts[uniq_slots] + cnt_delta

        for st, arrays in zip(self.leaf_states, leaf_args):
            st.update(
                slots, uniq_slots, inverse, arrays, diffs, cnt_delta, counts_after,
                key_lo=gkeys["lo"],
            )
        self.counts[uniq_slots] = counts_after

        # -- emission: retract old rows, insert new rows, per changed group ----
        alive_mask = counts_after > 0
        alive_slots = uniq_slots[alive_mask]
        dead_slots = uniq_slots[~alive_mask]

        new_cols = self._eval_out(alive_slots) if len(alive_slots) else {}
        had_row_alive = self.last_valid[alive_slots]
        changed = ~had_row_alive  # groups without a cached row always emit
        if had_row_alive.any():
            idx = np.nonzero(had_row_alive)[0]
            neq = np.zeros(len(idx), dtype=bool)
            for name in self.output_columns:
                if name in self._stable_cols:
                    continue  # pure grouping function: equal by construction
                old = self.last_cols[name][alive_slots[idx]]
                neq |= _col_neq(old, new_cols[name][idx])
            changed[idx] |= neq

        # retracts: dead groups with a cached row + changed alive groups with one
        r_uniq = np.zeros(m, dtype=bool)
        r_uniq[~alive_mask] = self.last_valid[dead_slots]
        alive_pos = np.nonzero(alive_mask)[0]
        r_uniq[alive_pos] = had_row_alive & changed
        i_uniq = np.zeros(m, dtype=bool)
        i_uniq[alive_pos] = changed

        if not r_uniq.any() and not i_uniq.any():
            if len(dead_slots):
                self._bury(dead_slots)
            return Delta.empty(self.output_columns)

        # interleave so each group's retract immediately precedes its insert
        r_idx = np.nonzero(r_uniq)[0]
        i_idx = np.nonzero(i_uniq)[0]
        seqd = np.sort(np.concatenate([r_idx * 2, i_idx * 2 + 1]))
        is_ins = (seqd % 2) == 1
        group_pos = seqd // 2
        ev_slots = uniq_slots[group_pos]
        out_keys = self.gkeys[ev_slots]
        out_diffs = np.where(is_ins, 1, -1).astype(np.int64)

        # map uniq position -> position in alive_slots (for gathering new values)
        alive_rel = np.full(m, -1, dtype=np.int64)
        alive_rel[alive_pos] = np.arange(len(alive_slots))
        ins_rel = alive_rel[group_pos[is_ins]]

        from pathway_tpu_torch.engine.columnar import set_cells

        columns: Dict[str, np.ndarray] = {}
        for name in self.output_columns:
            old_part = self.last_cols[name][ev_slots[~is_ins]]
            new_part = new_cols[name][ins_rel] if len(ins_rel) else np.empty(0, dtype=object)
            if not is_ins.any():
                columns[name] = old_part
            elif not (~is_ins).any():
                columns[name] = new_part
            else:
                out = None
                if old_part.dtype == new_part.dtype and old_part.dtype != object:
                    out = np.empty(len(is_ins), dtype=old_part.dtype)
                else:
                    out = np.empty(len(is_ins), dtype=object)
                try:
                    out[~is_ins] = old_part
                    out[is_ins] = new_part
                except (TypeError, ValueError):
                    out = np.empty(len(is_ins), dtype=object)
                    out[~is_ins] = old_part
                    out[is_ins] = new_part
                columns[name] = out

        # update the last-emitted cache
        changed_slots = alive_slots[changed]
        if len(changed_slots):
            for name in self.output_columns:
                self.last_cols[name] = set_cells(
                    self.last_cols[name], changed_slots, new_cols[name][changed]
                )
            self.last_valid[changed_slots] = True
        if len(dead_slots):
            self._bury(dead_slots)

        return Delta(out_keys, out_diffs, columns)

    def _bury(self, dead_slots: np.ndarray) -> None:
        """A group's multiset emptied: drop it from the index (slot recycles) and
        release cached object references."""
        self.last_valid[dead_slots] = False
        self.gindex.remove(self.gkeys[dead_slots])
        for name in self.last_cols:
            col = self.last_cols[name]
            if col.dtype == object:
                col[dead_slots] = None
        for name in self.gvals:
            col = self.gvals[name]
            if col.dtype == object:
                col[dead_slots] = None


class _JoinSide:
    """Columnar arrangement for one join side: a ``KeyIndex`` (row key -> slot),
    a ``MultiMap`` (join key -> row slots), and slot-indexed value arrays — the
    DD-arrangement stand-in for the join's build state. On the native tables
    an insert or a removal batch is one native pass over both."""

    def __init__(self, names: Iterable[str]):
        from pathway_tpu_torch.engine.index import KeyIndex, MultiMap

        self.names = list(names)
        self.row_index = KeyIndex()
        self.jkmap = MultiMap()
        self._capacity = 0
        self.keys = np.zeros(0, dtype=KEY_DTYPE)
        self.jk = np.zeros(0, dtype=KEY_DTYPE)
        self.cols: Dict[str, np.ndarray] = {c: np.empty(0, dtype=object) for c in self.names}

    def _native(self) -> bool:
        from pathway_tpu_torch.engine.index import _NativeKeyIndex, _NativeMultiMap

        return isinstance(self.row_index, _NativeKeyIndex) and isinstance(
            self.jkmap, _NativeMultiMap
        )

    def _ensure_capacity(self, bound: int | None = None) -> None:
        if bound is None:
            bound = self.row_index.slot_bound()
        if bound <= self._capacity:
            return
        from pathway_tpu_torch.engine.columnar import grow_column

        cap = max(16, 2 * self._capacity, bound)
        keys = np.empty(cap, dtype=KEY_DTYPE)
        keys[: self._capacity] = self.keys
        self.keys = keys
        jk = np.empty(cap, dtype=KEY_DTYPE)
        jk[: self._capacity] = self.jk
        self.jk = jk
        for c in self.names:
            self.cols[c] = grow_column(self.cols[c], cap)
        self._capacity = cap

    def insert_batch(
        self, row_keys: np.ndarray, jkeys: np.ndarray, values: Dict[str, np.ndarray]
    ) -> np.ndarray:
        from pathway_tpu_torch.engine.columnar import set_cells

        n = len(row_keys)
        if self._capacity == 0:
            # first allocation: value-column dtypes come from the first batch
            # through (StateTable does the same) — downstream gathers then stay
            # typed int64/float64 instead of object, which keeps the groupby
            # reducers fed by this join on their vectorized segment kernels
            # (an object `net` column was a per-row Python sum, ~40x slower);
            # set_cells/adopt_dtype still demote to object on any conflict
            for c in self.names:
                self.cols[c] = np.empty(0, dtype=np.asarray(values[c]).dtype)
        self._ensure_capacity(self.row_index.slot_bound() + n)
        slots = np.empty(n, dtype=np.int64)
        if self._native():
            # one native pass: upsert, duplicate replace, slot writes, jk map
            rk = np.ascontiguousarray(row_keys)
            jkc = np.ascontiguousarray(jkeys)
            self.row_index._lib.pwtpu_side_insert(
                self.row_index._h, self.jkmap._h,
                rk.ctypes.data_as(_U64P), jkc.ctypes.data_as(_U64P), n,
                self.keys.ctypes.data_as(_U64P), self.jk.ctypes.data_as(_U64P),
                slots.ctypes.data_as(_I64P),
            )
        else:
            # the same pass, sequential: a row key repeated within the batch
            # replaces the earlier row, its join-key bucket entry included
            one = np.empty(1, dtype=np.int64)
            for i in range(n):
                s_arr, new_arr = self.row_index.upsert(row_keys[i : i + 1])
                s = int(s_arr[0])
                if not new_arr[0]:
                    one[0] = s
                    self.jkmap.remove(self.jk[s : s + 1], one)
                self.keys[s] = row_keys[i]
                self.jk[s] = jkeys[i]
                one[0] = s
                self.jkmap.insert(jkeys[i : i + 1], one)
                slots[i] = s
        for c in self.names:
            self.cols[c] = set_cells(self.cols[c], slots, values[c])
        return slots

    def remove_batch(self, row_keys: np.ndarray) -> np.ndarray:
        """Slots removed per key (-1 when the key was absent)."""
        if self._native():
            slots = np.empty(len(row_keys), dtype=np.int64)
            rk = np.ascontiguousarray(row_keys)
            self.row_index._lib.pwtpu_side_remove(
                self.row_index._h, self.jkmap._h, rk.ctypes.data_as(_U64P), len(row_keys),
                self.jk.ctypes.data_as(_U64P), slots.ctypes.data_as(_I64P),
            )
        else:
            slots = self.row_index.remove(row_keys)
            present = np.nonzero(slots >= 0)[0]
            if len(present):
                self.jkmap.remove(self.jk[slots[present]], slots[present])
        present = np.nonzero(slots >= 0)[0]
        if len(present):
            live = slots[present]
            for c in self.names:
                col = self.cols[c]
                if col.dtype == object:
                    col[live] = None
        return slots


class JoinEvaluator(Evaluator):
    """Symmetric incremental hash join (reference DD join replacement).

    Hot path is columnar: per commit, each side's join keys hash in one pass, the
    other side's matches come back as one CSR probe from the multimap, and
    emission gathers own-side values straight from the delta
    (retraction rows carry their retracted values) and other-side values from slot
    arrays. Outer-join null-row bookkeeping runs per distinct join key, not per row.
    """

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        from pathway_tpu_torch.internals.joins import JoinKind

        self.kind = node.config["kind"]
        self.JoinKind = JoinKind
        self.left = _JoinSide(node.inputs[0].column_names())
        self.right = _JoinSide(node.inputs[1].column_names())

    def load_state_dict(self, state: Dict[str, bytes]) -> None:
        super().load_state_dict(state)
        if "left_map" in self.__dict__ or "right_map" in self.__dict__:
            raise RuntimeError(
                "checkpoint was written by an incompatible (pre-columnar) build; "
                "clear the persistence directory and re-run"
            )

    def _join_keys(self, side: str, delta: Delta) -> np.ndarray:
        table = self.node.inputs[0 if side == "left" else 1]
        exprs = self.node.config["left_on" if side == "left" else "right_on"]
        if not exprs:
            # no on-condition: every row shares the salt-only bucket (cross join)
            return broadcast_key(pointer_from(), len(delta))
        resolver = self._resolver_for(table, delta)
        arrays = [self._eval_expr(e, delta, resolver) for e in exprs]
        return keys_from_values(arrays)

    def process(self, input_deltas: List[Delta]) -> Delta:
        left_delta, right_delta = input_deltas
        parts: List[Delta] = []
        JK = self.JoinKind
        for delta, side_name in ((left_delta, "left"), (right_delta, "right")):
            if len(delta) == 0:
                continue
            # Frontier optimization: own-side rows are arranged only so FUTURE
            # other-side deltas can probe them (and, for outer kinds, so null-row
            # bookkeeping can see past own-side counts). When the other side's
            # subtree is closed — no delta this commit and none ever again — and
            # the other side never emits null rows, arranging this side buys
            # nothing: skip it. This is the static-build-side join fast path.
            is_left = side_name == "left"
            other_delta = right_delta if is_left else left_delta
            other_null = self.kind in ((JK.RIGHT, JK.OUTER) if is_left else (JK.LEFT, JK.OUTER))
            other_table = self.node.inputs[1 if is_left else 0]
            skip_arrange = (
                not other_null
                and len(other_delta) == 0
                and self.runner.subtree_closed(other_table._node)
            )
            part = self._run_side(delta, side_name, skip_arrange=skip_arrange)
            if part is not None and len(part):
                parts.append(part)
        if not parts:
            out = Delta.empty(self.output_columns)
        else:
            out = Delta.concat(parts, self.output_columns).consolidated()
        return out

    def _run_side(
        self, delta: Delta, side_name: str, *, skip_arrange: bool = False
    ) -> Delta | None:
        JK = self.JoinKind
        is_left = side_name == "left"
        own = self.left if is_left else self.right
        other = self.right if is_left else self.left
        own_null = self.kind in ((JK.LEFT, JK.OUTER) if is_left else (JK.RIGHT, JK.OUTER))
        other_null = self.kind in ((JK.RIGHT, JK.OUTER) if is_left else (JK.LEFT, JK.OUTER))

        if len(delta) == 0:
            return None

        n = len(delta)
        diffs = delta.diffs
        jkeys = self._join_keys(side_name, delta)

        # one CSR probe against the other side (static during this side's pass)
        offsets, match_slots = other.jkmap.probe(jkeys)
        counts = np.diff(offsets)

        # matched events: row i of the delta x each matching other-side slot.
        # Unique-key build sides (the common case) probe to exactly one match
        # per row — the repeats collapse to identity/copy, skip them.
        own_identity = False
        if len(match_slots) == n and counts[-1] == 1 and (counts == 1).all():
            ev_row = np.arange(n, dtype=np.int64)
            ev_d = diffs
            own_identity = True
        else:
            ev_row = np.repeat(np.arange(n, dtype=np.int64), counts)
            ev_d = np.repeat(diffs, counts)
        ev_other = match_slots

        null_rows = np.zeros(0, dtype=np.int64)
        null_d = np.zeros(0, dtype=np.int64)
        flip_slots = np.zeros(0, dtype=np.int64)
        flip_d = np.zeros(0, dtype=np.int64)
        if own_null:
            # unmatched rows of a LEFT/OUTER side emit with the other side null
            unmatched = np.nonzero(counts == 0)[0]
            null_rows = unmatched
            null_d = diffs[unmatched]
        if other_null and len(match_slots):
            # other-side rows flip between "null row" and "matched": when this side's
            # distinct join key goes 0 -> >0 rows, retract the other side's null rows;
            # on >0 -> 0, re-emit them. Tracked per distinct join key.
            from pathway_tpu_torch.engine.index import KeyIndex

            uidx = KeyIndex(n)
            uslot, first = uidx.upsert(jkeys)
            n_keys = uidx.slot_bound()
            base = np.zeros(n_keys, dtype=np.int64)
            own_counts, _ = own.jkmap.counts(jkeys[first])
            base[uslot[first]] = own_counts
            net = np.zeros(n_keys, dtype=np.int64)
            np.add.at(net, uslot, diffs)
            flips: List[tuple] = []
            went_up = np.nonzero((base == 0) & (net > 0))[0]
            went_down = np.nonzero((base > 0) & (base + net == 0))[0]
            if len(went_up) or len(went_down):
                first_rows = np.nonzero(first)[0]
                row_of_uslot = np.zeros(n_keys, dtype=np.int64)
                row_of_uslot[uslot[first_rows]] = first_rows
                for uj, d in [(j, -1) for j in went_up] + [(j, 1) for j in went_down]:
                    r = int(row_of_uslot[uj])
                    s, e = offsets[r], offsets[r + 1]
                    flips.append((match_slots[s:e], d))
            if flips:
                flip_slots = np.concatenate([f[0] for f in flips])
                flip_d = np.concatenate(
                    [np.full(len(f[0]), f[1], dtype=np.int64) for f in flips]
                )

        # mutate own-side state AFTER all probes/gathers that read it.
        # Retractions ALWAYS apply (rows arranged before the other side closed
        # must still evict, or they leak for the run's lifetime); only new
        # inserts are skipped under the frontier fast path.
        ret_rows = np.nonzero(diffs < 0)[0]
        if len(ret_rows):
            own.remove_batch(delta.keys[ret_rows])
        if not skip_arrange:
            ins_rows = np.nonzero(diffs > 0)[0]
            if len(ins_rows):
                own.insert_batch(
                    delta.keys[ins_rows],
                    jkeys[ins_rows],
                    {c: delta.columns[c][ins_rows] for c in own.names},
                )

        total = len(ev_row) + len(null_rows) + len(flip_slots)
        if total == 0:
            return None
        return self._emit_side(
            delta, side_name, other,
            ev_d, ev_row, ev_other,
            null_d, null_rows,
            flip_d, flip_slots,
            own_identity=own_identity
            and len(null_rows) == 0
            and len(flip_slots) == 0,
        )

    def _emit_side(
        self,
        delta: Delta,
        side_name: str,
        other: _JoinSide,
        ev_d: np.ndarray,
        ev_row: np.ndarray,
        ev_other: np.ndarray,
        null_d: np.ndarray,
        null_rows: np.ndarray,
        flip_d: np.ndarray,
        flip_slots: np.ndarray,
        own_identity: bool = False,
    ) -> Delta:
        """Assemble one side-pass's output: matched events, own-null rows, and
        other-side null-row flips, in that order. ``own_identity`` marks the
        unique-match inner pass where ``ev_row`` is the identity permutation:
        own-side gathers collapse to the delta's own arrays (no copy — delta
        columns are immutable once emitted, like every evaluator treats them)."""
        is_left = side_name == "left"
        left_table, right_table = self.node.inputs
        n_ev = len(ev_d) + len(null_d) + len(flip_d)
        n_m, n_nu = len(ev_d), len(null_d)

        # per-event row index into the delta (own side) / slot into other side; -1 null
        if n_nu == 0 and len(flip_d) == 0:
            # inner-match-only pass (the common case): no null segments to
            # splice — reuse the event arrays and a shared all-true mask
            own_rows = ev_row
            other_slots = ev_other
            out_d = ev_d
            own_mask = other_mask = np.ones(n_ev, dtype=bool)
        else:
            own_rows = np.concatenate(
                [ev_row, null_rows, np.full(len(flip_d), -1, dtype=np.int64)]
            )
            other_slots = np.concatenate(
                [ev_other, np.full(len(null_d), -1, dtype=np.int64), flip_slots]
            )
            out_d = np.concatenate([ev_d, null_d, flip_d])
            own_mask = own_rows >= 0
            other_mask = other_slots >= 0

        cache: Dict[str, np.ndarray] = {}

        def own_col(name: str) -> np.ndarray:
            key = "own:" + name
            if key not in cache:
                src = delta.columns[name]
                if own_identity:
                    out = src  # identity permutation: the delta's array as-is
                elif own_mask.all():
                    out = src[own_rows]
                else:
                    out = np.empty(n_ev, dtype=object)
                    out[own_mask] = src[own_rows[own_mask]]
                    out[~own_mask] = None
                cache[key] = out
            return cache[key]

        def other_col(name: str) -> np.ndarray:
            key = "other:" + name
            if key not in cache:
                src = other.cols[name]
                if other_mask.all():
                    out = src[other_slots]
                else:
                    out = np.empty(n_ev, dtype=object)
                    out[other_mask] = src[other_slots[other_mask]]
                    out[~other_mask] = None
                cache[key] = out
            return cache[key]

        def own_ids() -> np.ndarray:
            key = "own:id"
            if key not in cache:
                out = np.empty(n_ev, dtype=object)
                rows = np.nonzero(own_mask)[0]
                ptrs = keys_to_pointers(delta.keys[own_rows[rows]])
                for a, p in zip(rows, ptrs):
                    out[a] = p
                out[~own_mask] = None
                cache[key] = out
            return cache[key]

        def other_ids() -> np.ndarray:
            key = "other:id"
            if key not in cache:
                out = np.empty(n_ev, dtype=object)
                rows = np.nonzero(other_mask)[0]
                ptrs = keys_to_pointers(other.keys[other_slots[rows]])
                for a, p in zip(rows, ptrs):
                    out[a] = p
                out[~other_mask] = None
                cache[key] = out
            return cache[key]

        def resolver(ref: expr.ColumnReference) -> np.ndarray:
            own_side = (ref.table is left_table) == is_left
            if ref.table is not left_table and ref.table is not right_table:
                raise ValueError(f"join select references foreign table: {ref!r}")
            if ref.name == "id":
                return own_ids() if own_side else other_ids()
            return own_col(ref.name) if own_side else other_col(ref.name)

        exprs = self.node.config["exprs"]
        columns = {name: ee.evaluate(e, n_ev, resolver) for name, e in exprs.items()}

        # output keys: hash (left_key, right_key, "join"); id_expr overrides where
        # the left side is present
        if own_identity:
            own_keys = delta.keys
        else:
            own_keys = np.zeros(n_ev, dtype=KEY_DTYPE)
            own_keys[own_mask] = delta.keys[own_rows[own_mask]]
        oth_keys = np.zeros(n_ev, dtype=KEY_DTYPE)
        oth_keys[other_mask] = other.keys[other_slots[other_mask]]
        lkeys, lmask = (own_keys, own_mask) if is_left else (oth_keys, other_mask)
        rkeys, rmask = (oth_keys, other_mask) if is_left else (own_keys, own_mask)
        keys = combine_keys(lkeys, rkeys, lmask, rmask)
        id_expr = self.node.config.get("id_expr")
        if id_expr is not None and lmask.any():
            id_vals = ee.evaluate(id_expr, n_ev, resolver)
            for i in np.nonzero(lmask)[0]:
                p = id_vals[i]
                if isinstance(p, Pointer):
                    keys[i]["hi"], keys[i]["lo"] = p.hi, p.lo
        return Delta(keys, out_d, columns)


class FlattenEvaluator(Evaluator):
    """One output row per item of the flattened column, keyed
    ``pointer_from(row key, item index, "flatten")``; the other columns repeat.
    Rows and keys come out in the reference's order (row by row, items in
    order), built column at a time with the keys hashed in one pass."""

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        flat_name = self.node.config["flat_name"]
        origin_id = self.node.config.get("origin_id")
        lists = [_iter_flatten(v) for v in delta.columns[flat_name]]
        counts = np.fromiter((len(items) for items in lists), dtype=np.int64, count=len(lists))
        total = int(counts.sum())
        if total == 0:
            return Delta.empty(self.output_columns)
        rows = np.repeat(np.arange(len(delta), dtype=np.int64), counts)
        item_idx = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
        keys = derived_keys(delta.keys[rows], item_idx, "flatten")
        columns: Dict[str, np.ndarray] = {}
        for name in self.output_columns:
            if name == flat_name:
                col = objarray([item for items in lists for item in items])
            elif name == origin_id:
                col = objarray(keys_to_pointers(delta.keys[rows]))
            else:
                col = delta.columns[name][rows]
            columns[name] = ee._tidy(col)
        return Delta(keys, np.repeat(delta.diffs, counts), columns)


def _iter_flatten(value: Any) -> list:
    from pathway_tpu_torch.internals.json import Json

    if isinstance(value, Json):
        return [Json(v) if isinstance(v, (dict, list)) else v for v in value.value]
    if isinstance(value, (list, tuple)):
        return list(value)
    if isinstance(value, np.ndarray):
        return list(value)
    if isinstance(value, str):
        return list(value)
    raise TypeError(f"cannot flatten value of type {type(value).__name__}")


class IxEvaluator(Evaluator):
    """Source-keyed lookup into target (``Table.ix``): one output row per
    source row, the target row at its pointer; target changes re-emit the
    affected source rows."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.src_keys: Dict[bytes, bytes] = {}  # source key -> target key
        self.reverse: Dict[bytes, set[bytes]] = defaultdict(set)
        self.src_rows: Dict[bytes, np.void] = {}
        self.emitted: Dict[bytes, dict] = {}  # source key -> last emitted output row

    def process(self, input_deltas: List[Delta]) -> Delta:
        source_delta, target_delta = input_deltas
        source_table, target_table = self.node.inputs
        optional = self.node.config.get("optional", False)
        target_state = self.runner.state_of(target_table._node)
        names = self.output_columns
        out_keys: List[Any] = []
        out_diffs: List[int] = []
        out_rows: List[dict] = []
        src_keys, src_rows, reverse, emitted = self.src_keys, self.src_rows, self.reverse, self.emitted

        handled_sources: set = set()
        if len(source_delta):
            resolver = self._resolver_for(source_table, source_delta)
            ixptrs = ee.evaluate(
                self.node.config["key_expression"], len(source_delta), resolver
            )
            n = len(source_delta)
            skbs = key_bytes(source_delta.keys)
            handled_sources = set(skbs)
            tkeys = pointer_column_keys(np.asarray(ixptrs))
            has = None  # rows whose pointer is not a Pointer (None) hit nothing
            if tkeys is not None:
                tkbs: List[Any] = key_bytes(tkeys)
            else:
                tkbs = [
                    pointers_to_keys([p]).tobytes() if isinstance(p, Pointer) else None
                    for p in ixptrs
                ]
                has = np.array([t is not None for t in tkbs], dtype=bool)
                tkeys = np.zeros(n, dtype=KEY_DTYPE)
                if has.any():
                    tkeys[has] = pointers_to_keys([ixptrs[i] for i in np.nonzero(has)[0]])
            # the target rows of the insertions, gathered in one batch (the
            # target's state already holds this commit's delta)
            diffs = source_delta.diffs.tolist()
            ins = np.nonzero(source_delta.diffs > 0)[0]
            found: Dict[int, dict] = {}
            if len(ins) and len(target_state):
                slots = target_state.lookup(tkeys[ins])
                hit = slots >= 0
                if has is not None:
                    hit &= has[ins]
                rows_at = ins[hit].tolist()
                cols = [list(target_state.gather(c, slots[hit])) for c in names]
                if cols:
                    found = {i: dict(zip(names, vals)) for i, vals in zip(rows_at, zip(*cols))}
                else:
                    found = {i: {} for i in rows_at}
            keys_list = list(source_delta.keys)
            for i in range(n):
                skb = skbs[i]
                tkb = tkbs[i]
                if diffs[i] > 0:
                    src_keys[skb] = tkb
                    src_rows[skb] = keys_list[i]
                    if tkb is not None:
                        reverse[tkb].add(skb)
                    row = found.get(i)
                    if row is None:
                        if not optional and tkb is not None:
                            raise KeyError(f"ix: missing key {ixptrs[i]!r} in target table")
                        row = {c: None for c in names}
                    emitted[skb] = row
                else:
                    src_keys.pop(skb, None)
                    src_rows.pop(skb, None)
                    if tkb is not None:
                        reverse[tkb].discard(skb)
                    # retraction replays what was last emitted, regardless of target state
                    row = emitted.pop(skb, None)
                    if row is None:
                        row = {c: None for c in names}
                out_rows.append(row)
            out_keys.extend(keys_list)
            out_diffs.extend(diffs)

        # target-side changes re-emit affected source rows, preserving row-per-key:
        # optional sources flip between the real row and an all-None row
        if len(target_delta) and reverse:
            none_row = {c: None for c in names}
            tdiffs = target_delta.diffs.tolist()
            tcols = [list(target_delta.columns[c]) for c in names]
            for i, tkb in enumerate(key_bytes(target_delta.keys)):
                affected = reverse.get(tkb)
                if not affected:
                    continue
                d = tdiffs[i]
                row = {c: col[i] for c, col in zip(names, tcols)}
                for skb in affected:
                    if skb in handled_sources:
                        continue
                    prev = emitted.get(skb)
                    if d > 0:
                        if prev is not None:
                            out_keys.append(src_rows[skb])
                            out_diffs.append(-1)
                            out_rows.append(prev)
                        out_keys.append(src_rows[skb])
                        out_diffs.append(1)
                        out_rows.append(row)
                        emitted[skb] = row
                    else:
                        out_keys.append(src_rows[skb])
                        out_diffs.append(-1)
                        out_rows.append(prev if prev is not None else row)
                        if optional:
                            out_keys.append(src_rows[skb])
                            out_diffs.append(1)
                            out_rows.append(none_row)
                            emitted[skb] = none_row
                        else:
                            emitted.pop(skb, None)
        return _delta_from_rows(out_keys, out_diffs, out_rows, names).consolidated()


class ExternalIndexEvaluator(Evaluator):
    """External index operator: a pluggable index answering a query table.

    In as-of-now mode (the default) a query is answered once against the index
    state at arrival and never revisited. With ``asof_now=False`` live queries
    are *re-answered* whenever the index changes: the old reply is retracted
    and the fresh one emitted. A commit's index rows apply first (a pure-insert
    commit in bulk through ``add_many``, a mixed one row by row in the delta's
    order), then its queries are answered with one ``search_many``. An index
    instance without ``add_many`` / ``search_many`` (BM25, a user's own) is
    fed row by row and asked query by query, as in the reference."""

    # the index mutates in place, on the card: an undo record per commit
    # would cost more than the replay it saves, and a checkpoint cannot
    # capture it, so a graph holding one resumes by replaying the journal
    REWIND_SAFE = False
    SNAPSHOT_CAPTURE = False

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.index = node.config["index_factory"].make_instance()
        self.replies = StateTable(["_pw_index_reply"])
        self.asof_now: bool = bool(self.node.config.get("asof_now", True))
        # kb -> (key, qvec, limit, filter) for re-answering mode
        self.live_queries: Dict[bytes, tuple] = {}

    def _search_batch(
        self, vecs: List[Any], limits: List[int], filters: List[Any]
    ) -> List[List[tuple]]:
        if not vecs:
            return []
        if hasattr(self.index, "search_many"):
            return self.index.search_many(vecs, limits, filters)
        return [self.index.search(v, n, f) for v, n, f in zip(vecs, limits, filters)]

    def _apply_index_delta(self, index_delta: Delta) -> None:
        resolver = self._resolver_for(self.node.inputs[0], index_delta)
        vectors = self._eval_expr(self.node.config["index_column"], index_delta, resolver)
        filter_col = self.node.config.get("index_filter_data_column")
        filters = (
            self._eval_expr(filter_col, index_delta, resolver)
            if filter_col is not None
            else None
        )
        ptrs = keys_to_pointers(index_delta.keys)
        add_mask = index_delta.diffs > 0
        if add_mask.all() and hasattr(self.index, "add_many"):
            # pure-insert commit: one staged batch + one capacity jump
            self.index.add_many(
                ptrs, list(vectors), list(filters) if filters is not None else None
            )
            return
        # a mixed commit applies row by row, in the delta's order (slot reuse,
        # and so the top-k tie order, follows the reference's)
        for i in range(len(index_delta)):
            if add_mask[i]:
                self.index.add(ptrs[i], vectors[i], filters[i] if filters is not None else None)
            else:
                self.index.remove(ptrs[i])

    def process(self, input_deltas: List[Delta]) -> Delta:
        index_delta, query_delta = input_deltas
        query_table = self.node.inputs[1]
        index_changed = len(index_delta) > 0
        if index_changed:
            self._apply_index_delta(index_delta)

        out_keys, out_diffs, out_rows = [], [], []
        if len(query_delta):
            resolver = self._resolver_for(query_table, query_delta)
            qvecs = self._eval_expr(
                self.node.config["query_column"], query_delta, resolver
            )
            limit_col = self.node.config.get("query_responses_limit_column")
            limits = (
                self._eval_expr(limit_col, query_delta, resolver)
                if limit_col is not None
                else None
            )
            qfilter_col = self.node.config.get("query_filter_column")
            qfilters = (
                self._eval_expr(qfilter_col, query_delta, resolver)
                if qfilter_col is not None
                else None
            )
            q_kbs = key_bytes(query_delta.keys)
            ins = [i for i in range(len(query_delta)) if query_delta.diffs[i] > 0]
            ins_replies = self._search_batch(
                [qvecs[i] for i in ins],
                [int(limits[i]) if limits is not None else 1 for i in ins],
                [qfilters[i] if qfilters is not None else None for i in ins],
            )
            reply_of = dict(zip(ins, ins_replies))
            for i in range(len(query_delta)):
                kb = q_kbs[i]
                if query_delta.diffs[i] > 0:
                    limit = int(limits[i]) if limits is not None else 1
                    flt = qfilters[i] if qfilters is not None else None
                    reply = tuple(reply_of[i])
                    out_keys.append(query_delta.keys[i])
                    out_diffs.append(1)
                    out_rows.append({"_pw_index_reply": reply})
                    if not self.asof_now:
                        self.live_queries[kb] = (
                            query_delta.keys[i],
                            qvecs[i],
                            limit,
                            flt,
                        )
                else:
                    self.live_queries.pop(kb, None)
                    stored = self.replies.get_row(kb)
                    if stored is not None:
                        out_keys.append(query_delta.keys[i])
                        out_diffs.append(-1)
                        out_rows.append(stored)

        if not self.asof_now and index_changed and self.live_queries:
            answered = set(key_bytes(query_delta.keys))
            live = [
                (kb, entry)
                for kb, entry in self.live_queries.items()
                if kb not in answered
            ]
            live_replies = self._search_batch(
                [entry[1] for _, entry in live],
                [entry[2] for _, entry in live],
                [entry[3] for _, entry in live],
            )
            for (kb, (key, qvec, limit, flt)), matches in zip(live, live_replies):
                reply = tuple(matches)
                stored = self.replies.get_row(kb)
                if stored is not None and stored["_pw_index_reply"] == reply:
                    continue
                if stored is not None:
                    out_keys.append(key)
                    out_diffs.append(-1)
                    out_rows.append(stored)
                out_keys.append(key)
                out_diffs.append(1)
                out_rows.append({"_pw_index_reply": reply})
        delta = _delta_from_rows(out_keys, out_diffs, out_rows, ["_pw_index_reply"])
        self.replies.apply(delta)
        return delta


class OutputEvaluator(Evaluator):
    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.callback = node.config.get("callback")
        self.batch_callback = node.config.get("batch_callback")
        self.on_end = node.config.get("on_end")
        self.on_time_end = node.config.get("on_time_end")
        self.on_error = node.config.get("on_error")
        self.input_columns = node.inputs[0].column_names()

    def notify_failure(self, exc: BaseException) -> None:
        """The run is failing: sinks distinguishing failure from a clean end
        (ExportedTable) hear about it before finish() fires their on_end."""
        if self.on_error is not None and not getattr(self, "_on_error_fired", False):
            self._on_error_fired = True
            self.on_error(exc)

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if self.runner._inject is not None and not self.runner.replay_outputs:
            return Delta.empty([])  # the journal's replay, with silent sinks
        if self.batch_callback is not None and len(delta):
            # vectorized delivery: one call per commit, raw columnar arrays
            self.batch_callback(
                delta.keys,
                delta.diffs,
                {c: delta.columns[c] for c in self.input_columns},
                self.runner.current_time,
            )
        if self.callback is not None and len(delta):
            ptrs = keys_to_pointers(delta.keys)
            time = self.runner.current_time
            names = self.input_columns
            from pathway_tpu_torch.io._utils import columns_to_pylists

            col_map = columns_to_pylists(delta.columns, names)
            cols = [col_map[c] for c in names]
            additions = (delta.diffs > 0).tolist()
            callback = self.callback
            for ptr, is_add, *vals in zip(ptrs, additions, *cols):
                callback(
                    key=ptr, row=dict(zip(names, vals)), time=time, is_addition=is_add
                )
        if self.on_time_end is not None and len(delta):
            # the commit's batch is fully delivered: its time is closed
            self.on_time_end(self.runner.current_time)
        return Delta.empty([])

    def notify_stream_end(self) -> None:
        if self.on_end is not None and not getattr(self, "_on_end_fired", False):
            self._on_end_fired = True
            self.on_end()

    def finish(self) -> None:
        self.notify_stream_end()


def _rows_of(delta: Delta, names: List[str]) -> List[dict]:
    """One ``{column: value}`` dict per row of ``delta`` (values as indexing
    the columns gives them)."""
    cols = [delta.columns[c] for c in names]
    return [dict(zip(names, vals)) for vals in zip(*cols)] if cols else [{} for _ in range(len(delta))]


class UpdateRowsEvaluator(Evaluator):
    """``update_rows``: the union of both inputs' rows, the patch's row winning
    a key that both hold (reference ``UpdateRowsEvaluator``)."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.base = StateTable(self.output_columns)
        self.patch = StateTable(self.output_columns)

    def process(self, input_deltas: List[Delta]) -> Delta:
        base_delta, patch_delta = input_deltas
        out_keys, out_diffs, out_rows = [], [], []

        if len(base_delta):
            in_patch = self.patch.lookup(base_delta.keys) >= 0
            rows = _rows_of(base_delta, self.output_columns)
            for i in np.nonzero(~in_patch)[0].tolist():
                out_keys.append(base_delta.keys[i])
                out_diffs.append(int(base_delta.diffs[i]))
                out_rows.append(rows[i])
        self.base.apply(base_delta)

        rows = _rows_of(patch_delta, self.output_columns)
        for i in range(len(patch_delta)):
            kb = patch_delta.keys[i].tobytes()
            d = int(patch_delta.diffs[i])
            base_row = self.base.get_row(kb)
            if d > 0:
                if base_row is not None and self.patch.get_row(kb) is None:
                    out_keys.append(patch_delta.keys[i])
                    out_diffs.append(-1)
                    out_rows.append(base_row)
                out_keys.append(patch_delta.keys[i])
                out_diffs.append(1)
                out_rows.append(rows[i])
            else:
                out_keys.append(patch_delta.keys[i])
                out_diffs.append(-1)
                out_rows.append(rows[i])
                if base_row is not None:
                    out_keys.append(patch_delta.keys[i])
                    out_diffs.append(1)
                    out_rows.append(base_row)
        self.patch.apply(patch_delta)

        return _delta_from_rows(
            out_keys, out_diffs, out_rows, self.output_columns
        ).consolidated()


class _KeyPresenceMixin(Evaluator):
    """Shared machinery for intersect / difference / restrict: a base row is
    emitted while the condition on its key's presence in the other inputs
    holds, and flips when that presence changes."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.base = StateTable(self.output_columns)
        self.presence: List[set] = [set() for _ in node.inputs[1:]]

    def _condition(self, kb: bytes) -> bool:
        raise NotImplementedError

    def process(self, input_deltas: List[Delta]) -> Delta:
        base_delta = input_deltas[0]
        out: List[tuple] = []

        # update presence sets, recording transitions
        transitions: Dict[bytes, Any] = {}
        for idx, delta in enumerate(input_deltas[1:]):
            kbs = key_bytes(delta.keys)
            for i, kb in enumerate(kbs):
                before = self._condition(kb)
                if delta.diffs[i] > 0:
                    self.presence[idx].add(kb)
                else:
                    self.presence[idx].discard(kb)
                if before != self._condition(kb):
                    transitions[kb] = delta.keys[i]

        base_kbs = key_bytes(base_delta.keys)
        for kb in base_kbs:
            transitions.pop(kb, None)
        # base rows: emit while the condition holds
        rows = None
        for i, kb in enumerate(base_kbs):
            if self._condition(kb):
                if rows is None:
                    rows = _rows_of(base_delta, self.output_columns)
                out.append((base_delta.keys[i], int(base_delta.diffs[i]), rows[i]))
        self.base.apply(base_delta)

        for kb, key in transitions.items():
            row = self.base.get_row(kb)
            if row is None:
                continue
            out.append((key, 1 if self._condition(kb) else -1, row))
        return _delta_from_rows(
            [o[0] for o in out], [o[1] for o in out], [o[2] for o in out], self.output_columns
        )


class IntersectEvaluator(_KeyPresenceMixin):
    def _condition(self, kb: bytes) -> bool:
        return all(kb in p for p in self.presence)


class DifferenceEvaluator(_KeyPresenceMixin):
    def _condition(self, kb: bytes) -> bool:
        return kb not in self.presence[0]


class RestrictEvaluator(_KeyPresenceMixin):
    def _condition(self, kb: bytes) -> bool:
        return kb in self.presence[0]


class HavingEvaluator(Evaluator):
    """Keep base rows whose key appears among the indexer pointer columns'
    values (reference ``HavingEvaluator``)."""

    _NON_STATE_ATTRS = Evaluator._NON_STATE_ATTRS + ("indexers",)

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.base = StateTable(self.output_columns)
        self.indexers: List[expr.ColumnReference] = node.config["indexers"]
        self.counts: List[Dict[bytes, int]] = [defaultdict(int) for _ in self.indexers]

    def _condition(self, kb: bytes) -> bool:
        return all(c.get(kb, 0) > 0 for c in self.counts)

    def process(self, input_deltas: List[Delta]) -> Delta:
        base_delta = input_deltas[0]
        out: List[tuple] = []
        transitions: Dict[bytes, Any] = {}
        for idx, delta in enumerate(input_deltas[1:]):
            if len(delta) == 0:
                continue
            vals = delta.columns[self.indexers[idx].name]
            for i in range(len(delta)):
                p = vals[i]
                if not isinstance(p, Pointer):
                    continue
                key = pointers_to_keys([p])
                kb = key.tobytes()
                before = self._condition(kb)
                self.counts[idx][kb] += int(delta.diffs[i])
                if before != self._condition(kb):
                    transitions[kb] = key[0]

        rows = None
        for i, kb in enumerate(key_bytes(base_delta.keys)):
            transitions.pop(kb, None)
            if self._condition(kb):
                if rows is None:
                    rows = _rows_of(base_delta, self.output_columns)
                out.append((base_delta.keys[i], int(base_delta.diffs[i]), rows[i]))
        self.base.apply(base_delta)

        for kb, key in transitions.items():
            row = self.base.get_row(kb)
            if row is None:
                continue
            out.append((key, 1 if self._condition(kb) else -1, row))
        return _delta_from_rows(
            [o[0] for o in out], [o[1] for o in out], [o[2] for o in out], self.output_columns
        )


# -- the time-threshold operators (pw.temporal's behaviors) ------------------
#
# The runner asks an evaluator's ``has_pending()`` after each of its turns,
# runs it in a commit with no input while it holds rows, and asks
# ``neu_pending()`` (forgetting retractions to drain in the commit's neu
# phase) of those that hold rows only.


class AsofNowEvaluator(Evaluator):
    """``_forget_immediately`` / ``_filter_out_results_of_forgetting``.

    Forget mode passes each commit's rows through and schedules a retraction
    of every insert, which the runner drains in the same commit's neu phase:
    downstream state shrinks, but the forgetting filter drops neu deltas so
    delivered results stay. An upstream retraction of a still-scheduled key
    cancels the schedule (no double retraction)."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.pending: Dict[bytes, tuple] = {}  # kb -> (key, row)

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if self.node.config["mode"] == "filter_forgotten":
            if delta.neu:
                return Delta.empty(self.output_columns)
            return delta
        rows = _rows_of(delta, delta.column_names)
        for i, kb in enumerate(key_bytes(delta.keys)):
            if delta.diffs[i] > 0:
                self.pending[kb] = (delta.keys[i], rows[i])
            else:
                # a genuine upstream retraction passes; cancel the scheduled one
                self.pending.pop(kb, None)
        return delta

    def neu_pending(self) -> bool:
        return self.node.config["mode"] == "forget" and bool(self.pending)

    def drain_neu(self, input_deltas: List[Delta]) -> Delta:
        parts = []
        if self.pending:
            keys = [p[0] for p in self.pending.values()]
            rows = [p[1] for p in self.pending.values()]
            self.pending = {}
            parts.append(_delta_from_rows(keys, [-1] * len(keys), rows, self.output_columns))
        if any(len(d) for d in input_deltas):
            parts.append(self.process(input_deltas))
        return Delta.concat(parts, self.output_columns)

    def has_pending(self) -> bool:
        return bool(self.pending)


class _TimeThresholdEvaluator(Evaluator):
    """Shared machinery for buffer / freeze / forget (reference
    ``_TimeThresholdEvaluator``).

    ``now`` is the largest value of the time column seen so far; a row is
    ripe once its threshold is ≤ ``now``. Ripeness pops a min-heap on the
    threshold, so a commit visits only the ripe prefix of what is held."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.now: Any = None
        self._heap: List[tuple] = []  # (threshold, seq, kb)
        self._heap_seq = 0

    def _thresholds_times(self, delta: Delta) -> tuple:
        resolver = self._resolver_for(self.node.inputs[0], delta)
        n = len(delta)
        thr = ee.evaluate(self.node.config["threshold"], n, resolver)
        tim = ee.evaluate(self.node.config["time"], n, resolver)
        return thr, tim

    def _advance_now(self, tim: np.ndarray, diffs: np.ndarray) -> None:
        inserted = tim[diffs > 0]
        if inserted.dtype == object:
            inserted = [v for v in inserted if v is not None]
        if len(inserted):
            top = max(inserted)
            if self.now is None or top > self.now:
                self.now = top

    def _ripe_mask(self, thr: np.ndarray) -> np.ndarray:
        if self.now is None:
            return np.zeros(len(thr), dtype=bool)
        if thr.dtype != object:
            return thr <= self.now
        return np.fromiter((t <= self.now for t in thr), dtype=bool, count=len(thr))

    def _heap_push(self, threshold: Any, kb: bytes) -> None:
        heapq.heappush(self._heap, (threshold, self._heap_seq, kb))
        self._heap_seq += 1

    def _heap_pop_ripe(self, *, all_: bool = False):
        """Yield (threshold, kb) for entries whose threshold ``now`` passed (or
        all, when draining). The caller drops stale entries."""
        while self._heap and (
            all_ or (self.now is not None and self._heap[0][0] <= self.now)
        ):
            threshold, _, kb = heapq.heappop(self._heap)
            yield threshold, kb


class BufferEvaluator(_TimeThresholdEvaluator):
    """Postpone rows until the stream's time passes each row's threshold
    (reference ``BufferEvaluator``). At stream close (the runner's
    ``draining``) every buffered row flushes."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        # kb -> [key, row, threshold, accumulated diff]
        self.pending: Dict[bytes, list] = {}
        self.emitted: set = set()

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        out_keys: List[Any] = []
        out_diffs: List[int] = []
        out_rows: List[dict] = []
        if len(delta):
            thr, tim = self._thresholds_times(delta)
            self._advance_now(tim, delta.diffs)
            rows = _rows_of(delta, delta.column_names)
            for i, kb in enumerate(key_bytes(delta.keys)):
                d = int(delta.diffs[i])
                if d < 0 and kb in self.emitted:
                    # retraction of an emitted row passes straight through
                    out_keys.append(delta.keys[i])
                    out_diffs.append(-1)
                    out_rows.append(rows[i])
                    self.emitted.discard(kb)
                    continue
                cur = self.pending.get(kb)
                if cur is None:
                    self.pending[kb] = [delta.keys[i], rows[i], thr[i], d]
                    self._heap_push(thr[i], kb)
                else:
                    cur[3] += d
                    if d > 0:
                        cur[1] = rows[i]
                        if cur[2] != thr[i]:
                            cur[2] = thr[i]
                            self._heap_push(thr[i], kb)
                    if cur[3] == 0:
                        del self.pending[kb]
        for threshold, kb in self._heap_pop_ripe(all_=self.runner.draining):
            cur = self.pending.get(kb)
            if cur is None or cur[2] != threshold:
                continue  # stale heap entry (row cancelled or rescheduled)
            del self.pending[kb]
            key, row, _, acc = cur
            if acc == 0:
                continue
            out_keys.append(key)
            out_diffs.append(acc)
            out_rows.append(row)
            if acc > 0:
                self.emitted.add(kb)
        return _delta_from_rows(out_keys, out_diffs, out_rows, self.output_columns).consolidated()

    def has_pending(self) -> bool:
        return bool(self.pending)


class FreezeEvaluator(_TimeThresholdEvaluator):
    """Drop late rows: updates that arrive after the stream's time passed
    their threshold (reference ``FreezeEvaluator``). Ripeness is checked
    against ``now`` before this commit's rows advance it."""

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        thr, tim = self._thresholds_times(delta)
        mask = ~self._ripe_mask(thr)
        self._advance_now(tim, delta.diffs)
        return delta if mask.all() else delta.select(mask)


class ForgetEvaluator(_TimeThresholdEvaluator):
    """Retract rows once the stream's time passes their threshold (reference
    ``ForgetEvaluator``). The retractions drain in the same commit's neu
    phase; with keep_results=True a downstream forgetting filter drops them,
    so state is bounded but delivered results stay."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.live: Dict[bytes, tuple] = {}  # kb -> (key, row, threshold)
        self.pending_forget: Dict[bytes, tuple] = {}  # kb -> (key, row)

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        thr, tim = self._thresholds_times(delta)
        self._advance_now(tim, delta.diffs)
        rows = _rows_of(delta, delta.column_names)
        for i, kb in enumerate(key_bytes(delta.keys)):
            if delta.diffs[i] > 0:
                self.live[kb] = (delta.keys[i], rows[i], thr[i])
                self._heap_push(thr[i], kb)
            else:
                # a genuine upstream retraction cancels any scheduled forgetting
                self.live.pop(kb, None)
                self.pending_forget.pop(kb, None)
        for threshold, kb in self._heap_pop_ripe():
            cur = self.live.get(kb)
            if cur is None or cur[2] != threshold:
                continue  # stale heap entry
            del self.live[kb]
            self.pending_forget[kb] = (cur[0], cur[1])
        return delta

    def neu_pending(self) -> bool:
        return bool(self.pending_forget)

    def drain_neu(self, input_deltas: List[Delta]) -> Delta:
        parts = []
        if self.pending_forget:
            keys = [p[0] for p in self.pending_forget.values()]
            rows = [p[1] for p in self.pending_forget.values()]
            self.pending_forget = {}
            parts.append(_delta_from_rows(keys, [-1] * len(keys), rows, self.output_columns))
        if any(len(d) for d in input_deltas):
            parts.append(self.process(input_deltas))
        return Delta.concat(parts, self.output_columns)

    def has_pending(self) -> bool:
        return bool(self.pending_forget)


class DeduplicateEvaluator(Evaluator):
    """One row per instance, advancing when ``acceptor(new, old)`` accepts
    (``Table.deduplicate``). Append-only: retractions are ignored, as in the
    reference. The output row of an instance is keyed
    ``pointer_from(instance, "dedup")``."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        # instance repr -> (row key, row, value)
        self.current: Dict[bytes, tuple] = {}

    @staticmethod
    def _instance_out_key(inst: Any) -> Pointer:
        return pointer_from(
            inst if not isinstance(inst, np.void) else int(inst["lo"]), "dedup"
        )

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        table = self.node.inputs[0]
        resolver = self._resolver_for(table, delta)
        n = len(delta)
        value_e = self.node.config.get("value")
        instance_e = self.node.config.get("instance")
        acceptor = self.node.config.get("acceptor")
        values = ee.evaluate(value_e, n, resolver) if value_e is not None else delta.keys
        instances = (
            ee.evaluate(instance_e, n, resolver)
            if instance_e is not None
            else np.zeros(n, dtype=object)
        )
        # one retraction of the instance's row before this delta (if any) and
        # one insertion of its final winner: several accepted rows of one
        # instance in a delta must not chain retract / insert pairs on one key
        pre: Dict[bytes, tuple] = {}  # instance repr -> (out key, entry before)
        winner: Dict[bytes, int] = {}  # instance repr -> row index accepted last
        names = delta.column_names
        for i in np.nonzero(delta.diffs > 0)[0].tolist():
            inst = instances[i]
            ib = repr(inst).encode()
            val = values[i]
            cur = self.current.get(ib)
            if cur is not None and acceptor is not None and not bool(acceptor(val, cur[2])):
                continue
            if ib not in pre:
                pre[ib] = (self._instance_out_key(inst), cur)
            row = {c: delta.columns[c][i] for c in names}
            self.current[ib] = (delta.keys[i], row, val)
            winner[ib] = i
        if not pre:
            return Delta.empty(self.output_columns)
        out_keys, out_diffs, out_rows = [], [], []
        for ib, (ikey, cur) in pre.items():
            if cur is not None:
                out_keys.append(ikey)
                out_diffs.append(-1)
                out_rows.append(cur[1])
            out_keys.append(ikey)
            out_diffs.append(1)
            out_rows.append(self.current[ib][1])
        return _delta_from_rows(out_keys, out_diffs, out_rows, self.output_columns)


class UpdateCellsEvaluator(Evaluator):
    """``update_cells`` / ``<<``: the base rows with the patch's cells on the
    keys the patch holds."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        base_cols = node.inputs[0].column_names()
        self.patch_cols = [c for c in node.inputs[1].column_names() if c in base_cols]
        self.base = StateTable(self.output_columns)
        self.patch = StateTable(self.patch_cols)

    def _merged(self, kb: bytes, base_row: dict) -> dict:
        patch_row = self.patch.get_row(kb)
        if patch_row is None:
            return base_row
        merged = dict(base_row)
        merged.update(patch_row)
        return merged

    def process(self, input_deltas: List[Delta]) -> Delta:
        base_delta, patch_delta = input_deltas
        out_keys, out_diffs, out_rows = [], [], []

        # the patch first, so base rows of the same commit see it
        self.patch.apply(
            Delta(
                patch_delta.keys,
                patch_delta.diffs,
                {c: patch_delta.columns[c] for c in self.patch_cols},
            )
        )
        base_rows = _rows_of(base_delta, self.output_columns)
        if len(base_delta) and len(self.patch):
            # the patch's cells of the base delta's keys, in one lookup
            slots = self.patch.lookup(base_delta.keys)
            hit = np.nonzero(slots >= 0)[0]
            if len(hit):
                cells = [self.patch.gather(c, slots[hit]) for c in self.patch_cols]
                for j, i in enumerate(hit.tolist()):
                    merged = dict(base_rows[i])
                    merged.update(zip(self.patch_cols, (col[j] for col in cells)))
                    base_rows[i] = merged
        out_keys.extend(base_delta.keys)
        out_diffs.extend(base_delta.diffs.tolist())
        out_rows.extend(base_rows)
        self.base.apply(base_delta)

        # patch changes on keys this commit's base delta did not carry; the
        # cells before the patch delta are its last retraction on the key
        seen = set(key_bytes(base_delta.keys))
        patch_kbs = key_bytes(patch_delta.keys)
        old_patch: Dict[bytes, dict] = {}
        for j in np.nonzero(patch_delta.diffs < 0)[0].tolist():
            old_patch[patch_kbs[j]] = {c: patch_delta.columns[c][j] for c in self.patch_cols}
        handled: set = set()
        for i, kb in enumerate(patch_kbs):
            if kb in seen or kb in handled:
                continue
            handled.add(kb)
            base_row = self.base.get_row(kb)
            if base_row is None:
                continue
            old_row = dict(base_row)
            if kb in old_patch:
                old_row.update(old_patch[kb])
            new_row = self._merged(kb, base_row)
            if old_row != new_row:
                out_keys.append(patch_delta.keys[i])
                out_diffs.append(-1)
                out_rows.append(old_row)
                out_keys.append(patch_delta.keys[i])
                out_diffs.append(1)
                out_rows.append(new_row)
        return _delta_from_rows(out_keys, out_diffs, out_rows, self.output_columns).consolidated()


class WithUniverseOfEvaluator(Evaluator):
    """Passes its rows through and checks the promised key-set equality with
    the other table once the stream is final (``GraphRunner.finish``)."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        from pathway_tpu_torch.engine.index import KeyIndex

        self.self_keys = KeyIndex()
        self.other_keys = KeyIndex()

    def process(self, input_deltas: List[Delta]) -> Delta:
        self_delta, other_delta = input_deltas
        for delta, idx in ((self_delta, self.self_keys), (other_delta, self.other_keys)):
            if not len(delta):
                continue
            # removals first: an in-place update (-1 old, +1 new on one key)
            # leaves the key present whatever the row order
            ins = delta.diffs > 0
            if (~ins).any():
                idx.remove(delta.keys[~ins])
            if ins.any():
                idx.upsert(delta.keys[ins])
        return self_delta

    def verify_universes(self) -> None:
        a_keys, _ = self.self_keys.items()
        b_keys, _ = self.other_keys.items()
        only_a = self.other_keys.lookup(a_keys) < 0 if len(a_keys) else np.zeros(0, bool)
        only_b = self.self_keys.lookup(b_keys) < 0 if len(b_keys) else np.zeros(0, bool)
        if only_a.any() or only_b.any():
            sample_a = keys_to_pointers(a_keys[only_a][:3]) if only_a.any() else []
            sample_b = keys_to_pointers(b_keys[only_b][:3]) if only_b.any() else []
            raise RuntimeError(
                "with_universe_of: promised universe equality violated at runtime — "
                f"{int(only_a.sum())} key(s) only in the table (e.g. {sample_a}), "
                f"{int(only_b.sum())} only in the other (e.g. {sample_b})"
            )


def _hashable_scalar(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return (v.tobytes(), v.shape)
    return v


class SortEvaluator(Evaluator):
    """prev / next pointers per instance, in (key, row id) order.

    Each instance keeps its rows in a sorted list of ``(key, id hi, id lo,
    row key bytes)``; an insertion or removal changes the links of its
    neighbours only, so a commit re-reads the links of the rows next to its
    changes (the reference re-sorts every touched instance)."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.rows: Dict[bytes, tuple] = {}  # kb -> (entry tuple, instance)
        self.members: Dict[Any, list] = defaultdict(list)
        self.emitted: Dict[bytes, tuple] = {}  # kb -> (prev, next)
        self.ptrs: Dict[bytes, tuple] = {}  # kb -> (Pointer, key)

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        table = self.node.inputs[0]
        resolver = self._resolver_for(table, delta)
        n = len(delta)
        keys_vals = ee.evaluate(self.node.config["key"], n, resolver)
        instance_e = self.node.config.get("instance")
        instances = (
            ee.evaluate(instance_e, n, resolver) if instance_e is not None else np.zeros(n, dtype=object)
        )
        ptrs = keys_to_pointers(delta.keys)
        kbs = key_bytes(delta.keys)
        keys_vals = keys_vals.tolist() if keys_vals.dtype != object else list(keys_vals)
        if instances.dtype != object:
            instances = instances.tolist()
        else:
            instances = [_hashable_scalar(x) for x in instances]
        diffs = delta.diffs.tolist()
        keys_list = list(delta.keys)
        rows, members, ptr_of = self.rows, self.members, self.ptrs
        bisect_left = bisect.bisect_left
        affected: Dict[bytes, Any] = {}  # kb -> instance

        for i in range(n):
            kb = kbs[i]
            old = rows.pop(kb, None)
            if old is not None:
                entry, inst = old
                lst = members[inst]
                pos = bisect_left(lst, entry)
                del lst[pos]
                for j in range(max(pos - 1, 0), min(pos + 1, len(lst))):
                    affected[lst[j][3]] = inst
            if diffs[i] > 0:
                inst = instances[i]
                ptr = ptrs[i]
                entry = (keys_vals[i], ptr.hi, ptr.lo, kb)
                lst = members[inst]
                pos = bisect_left(lst, entry)
                lst.insert(pos, entry)
                rows[kb] = (entry, inst)
                ptr_of[kb] = (ptr, keys_list[i])
                for j in range(max(pos - 1, 0), min(pos + 2, len(lst))):
                    affected[lst[j][3]] = inst

        out_keys, out_diffs, out_rows = [], [], []
        emitted = self.emitted
        for i in range(n):
            kb = kbs[i]
            if kb in rows:
                continue
            old_links = emitted.pop(kb, None)
            ptr_of.pop(kb, None)
            if old_links is not None:
                out_keys.append(keys_list[i])
                out_diffs.append(-1)
                out_rows.append({"prev": old_links[0], "next": old_links[1]})
                affected.pop(kb, None)
        for kb, inst in affected.items():
            got = rows.get(kb)
            if got is None:
                continue
            lst = members[inst]
            pos = bisect_left(lst, got[0])
            links = (
                ptr_of[lst[pos - 1][3]][0] if pos > 0 else None,
                ptr_of[lst[pos + 1][3]][0] if pos + 1 < len(lst) else None,
            )
            old_links = emitted.get(kb)
            if old_links == links:
                continue
            key = ptr_of[kb][1]
            if old_links is not None:
                out_keys.append(key)
                out_diffs.append(-1)
                out_rows.append({"prev": old_links[0], "next": old_links[1]})
            out_keys.append(key)
            out_diffs.append(1)
            out_rows.append({"prev": links[0], "next": links[1]})
            emitted[kb] = links
        return _delta_from_rows(out_keys, out_diffs, out_rows, self.output_columns)


class SortedIndexEvaluator(Evaluator):
    """A sorted binary tree per instance (``build_sorted_index``): each commit
    rebuilds the touched instances' trees as cartesian trees (one O(n) stack
    pass): in-order = key order, heap order = the rows' key fingerprints (the
    low word of the row key), so the shape does not depend on arrival order."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.rows: Dict[bytes, tuple] = {}  # kb -> (sort value, instance, ptr, key)
        self.emitted: Dict[bytes, dict] = {}  # kb -> emitted row
        # per-instance membership: a commit reads only its instances' rows
        self.members: Dict[Any, Dict[bytes, tuple]] = defaultdict(dict)

    @staticmethod
    def _tree_links(ordered: List[tuple]) -> List[tuple]:
        """(left, right, parent) per position of the cartesian tree of
        ``ordered`` = [(priority, ptr), ...] in key order; min-priority root."""
        n = len(ordered)
        left: List[Any] = [None] * n
        right: List[Any] = [None] * n
        parent: List[Any] = [None] * n
        stack: List[int] = []
        for i in range(n):
            dethroned = None
            while stack and ordered[stack[-1]][0] > ordered[i][0]:
                dethroned = stack.pop()
            if dethroned is not None:
                left[i] = ordered[dethroned][1]
                parent[dethroned] = ordered[i][1]
            if stack:
                right[stack[-1]] = ordered[i][1]
                parent[i] = ordered[stack[-1]][1]
            stack.append(i)
        return list(zip(left, right, parent))

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return Delta.empty(self.output_columns)
        table = self.node.inputs[0]
        resolver = self._resolver_for(table, delta)
        n = len(delta)
        keys_vals = ee.evaluate(self.node.config["key"], n, resolver)
        instance_e = self.node.config.get("instance")
        instances = (
            ee.evaluate(instance_e, n, resolver)
            if instance_e is not None
            else np.zeros(n, dtype=object)
        )
        ptrs = keys_to_pointers(delta.keys)
        kbs = key_bytes(delta.keys)
        touched = set()
        for i in range(n):
            kb = kbs[i]
            old = self.rows.get(kb)
            if old is not None:
                self.members[_hashable_scalar(old[1])].pop(kb, None)
                touched.add(_hashable_scalar(old[1]))
            if delta.diffs[i] > 0:
                entry = (keys_vals[i], instances[i], ptrs[i], delta.keys[i])
                self.rows[kb] = entry
                self.members[_hashable_scalar(instances[i])][kb] = entry
            else:
                self.rows.pop(kb, None)
            touched.add(_hashable_scalar(instances[i]))

        fresh: Dict[bytes, tuple] = {}
        for hi in touched:
            members = [
                (sv, ptr, kb, key, inst)
                for kb, (sv, inst, ptr, key) in self.members.get(hi, {}).items()
            ]
            members.sort(key=lambda r: (r[0], r[1]))
            links = self._tree_links([(r[3]["lo"].item(), r[1]) for r in members])
            for (sv, ptr, kb, key, inst), (lf, rt, par) in zip(members, links):
                fresh[kb] = (
                    key,
                    {"key": sv, "left": lf, "right": rt, "parent": par, "instance": inst},
                )

        out_keys, out_diffs, out_rows = [], [], []
        # removals come from the delta's retractions, not a scan of all rows
        for i in range(n):
            if delta.diffs[i] >= 0:
                continue
            kb = kbs[i]
            if kb in self.rows:
                continue  # replaced within this commit, not removed
            old_row = self.emitted.pop(kb, None)
            if old_row is not None:
                out_keys.append(delta.keys[i])
                out_diffs.append(-1)
                out_rows.append(old_row)
        for kb, (key, row) in fresh.items():
            old = self.emitted.get(kb)
            if old == row:
                continue
            if old is not None:
                out_keys.append(key)
                out_diffs.append(-1)
                out_rows.append(old)
            out_keys.append(key)
            out_diffs.append(1)
            out_rows.append(row)
            self.emitted[kb] = row
        return _delta_from_rows(out_keys, out_diffs, out_rows, self.output_columns)


class RemoveErrorsEvaluator(Evaluator):
    """Drops the rows holding an ``Error`` cell."""

    def process(self, input_deltas: List[Delta]) -> Delta:
        (delta,) = input_deltas
        if len(delta) == 0:
            return delta
        mask = np.ones(len(delta), dtype=bool)
        for col in delta.columns.values():
            if col.dtype == object:
                mask &= ~np.frompyfunc(lambda v: isinstance(v, Error), 1, 1)(col).astype(bool)
        return delta.select(mask)


class GradualBroadcastEvaluator(Evaluator):
    """Broadcasts a (lower, value, upper) threshold to every row with a per-key
    stagger and hysteresis: a row's ``apx_value`` sits at its own point of the
    band, ``lower + (upper - lower) * frac(key)`` with ``frac`` the key's low
    word over 2**64, and re-emits only when a threshold update moves the band
    past its stored value, so a drifting threshold moves rows a few at a
    time instead of retracting the whole table."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.rows = StateTable(node.inputs[0].column_names())
        self.apx: Dict[bytes, Any] = {}
        self.threshold: tuple | None = None

    @staticmethod
    def _frac(keys: np.ndarray) -> np.ndarray:
        return keys["lo"].astype(np.float64) / float(2**64)

    def _candidate(self, keys: np.ndarray) -> np.ndarray:
        lower, _value, upper = self.threshold
        return lower + (upper - lower) * self._frac(keys)

    def process(self, input_deltas: List[Delta]) -> Delta:
        rows_delta, thr_delta = input_deltas
        out_parts: List[Delta] = []

        new_threshold = self.threshold
        if len(thr_delta):
            ins = np.nonzero(thr_delta.diffs > 0)[0]
            if len(ins):
                i = int(ins[-1])
                cfg = self.node.config
                new_threshold = (
                    thr_delta.columns[cfg["lower"]][i],
                    thr_delta.columns[cfg["value"]][i],
                    thr_delta.columns[cfg["upper"]][i],
                )

        def emit(delta: Delta, apx_vals: np.ndarray, sign: int) -> None:
            cols = {c: delta.columns[c] for c in self.rows.column_names}
            cols["apx_value"] = apx_vals
            out_parts.append(
                Delta(delta.keys, np.full(len(delta), sign, dtype=np.int64), cols)
            )

        if len(rows_delta):
            ret = rows_delta.select(rows_delta.diffs < 0)
            if len(ret):
                olds = np.array([self.apx.pop(kb, None) for kb in key_bytes(ret.keys)], dtype=object)
                emit(ret, olds, -1)
            self.rows.apply(rows_delta)
            ins = rows_delta.select(rows_delta.diffs > 0)
            if len(ins):
                if self.threshold is None and new_threshold is None:
                    apx = np.zeros(len(ins), dtype=np.float64)
                else:
                    save, self.threshold = self.threshold, (new_threshold or self.threshold)
                    apx = self._candidate(ins.keys)
                    self.threshold = save
                for kb, a in zip(key_bytes(ins.keys), apx):
                    self.apx[kb] = a
                emit(ins, np.asarray(apx, dtype=np.float64), 1)

        if new_threshold is not None and new_threshold != self.threshold:
            self.threshold = new_threshold
            lower, _value, upper = new_threshold
            snap = self.rows.snapshot()
            if len(snap):
                kbs = key_bytes(snap.keys)
                stored = np.array([self.apx.get(kb) for kb in kbs], dtype=np.float64)
                cand = self._candidate(snap.keys)
                # hysteresis: a row whose stored value still sits inside the
                # new band keeps it; only rows the band moved past re-emit
                move = (stored < lower) | (stored > upper)
                move &= stored != cand
                idx = np.nonzero(move)[0]
                if len(idx):
                    moving = snap.select(idx)
                    emit(moving, stored[idx], -1)
                    emit(moving, cand[idx], 1)
                    for i in idx.tolist():
                        self.apx[kbs[i]] = cand[i]

        if not out_parts:
            return Delta.empty(self.output_columns)
        return Delta.concat(out_parts, self.output_columns)


def _delta_from_rows(
    keys: Any, diffs: List[int], rows: List[dict], column_names: List[str]
) -> Delta:
    if len(rows) == 0:
        return Delta.empty(column_names)
    if isinstance(keys, list):
        if keys and isinstance(keys[0], Pointer):
            keys = pointers_to_keys(keys)
        else:
            arr = np.empty(len(keys), dtype=KEY_DTYPE)
            for i, k in enumerate(keys):
                arr[i] = k
            keys = arr
    columns = {
        name: ee._tidy(objarray([r[name] for r in rows]))
        for name in column_names
    }
    return Delta(keys, np.array(diffs, dtype=np.int64), columns)


class RowTransformerEvaluator(Evaluator):
    """``@pw.transformer`` (``internals/row_transformer.py``): keeps every
    input row and, per output row, the input rows its computation read; a
    commit re-evaluates the rows it changed and their readers, and emits the
    difference against what was emitted before."""

    def __init__(self, node: pg.Node, runner: Any):
        super().__init__(node, runner)
        self.transformer = node.config["transformer"]
        self.arg_names: List[str] = node.config["arg_names"]
        self.out_names = {n: self.transformer._output_schema(n).column_names() for n in self.arg_names}
        #: the inputs' rows, per class argument
        self.rows: Dict[str, Dict[Pointer, dict]] = {n: {} for n in self.arg_names}
        #: the output rows emitted so far
        self.emitted: Dict[str, Dict[Pointer, dict]] = {n: {} for n in self.arg_names}
        #: output row -> the input rows it read, and the reverse
        self.reads: Dict[Tuple[str, Pointer], Set[Tuple[str, Pointer]]] = {}
        self.readers: Dict[Tuple[str, Pointer], Set[Tuple[str, Pointer]]] = {}
        self.pending: Dict[str, Delta] = {}

    def process(self, input_deltas: List[Delta]) -> Delta:
        changed: Set[Tuple[str, Pointer]] = set()
        for arg_name, delta in zip(self.arg_names, input_deltas):
            if len(delta):
                changed |= self._apply(arg_name, delta)
        if not changed:
            return Delta.empty(self.output_columns)
        affected = set(changed)
        for row_id in changed:
            affected |= self.readers.get(row_id, set())

        from pathway_tpu_torch.internals.iterate import _rows_equal
        from pathway_tpu_torch.internals.row_transformer import _TransformerRun

        run = _TransformerRun(self.transformer, self.rows)
        for arg_name in self.arg_names:
            keys: List[Pointer] = []
            diffs: List[int] = []
            out_rows: List[dict] = []
            emitted = self.emitted[arg_name]
            for row_id in affected:
                if row_id[0] != arg_name:
                    continue
                ptr = row_id[1]
                old = emitted.get(ptr)
                new = None
                if ptr in self.rows[arg_name]:
                    new, reads = run.output_row(arg_name, ptr)
                    self._set_reads(row_id, reads)
                else:
                    self._set_reads(row_id, set())
                if old is not None and new is not None and _rows_equal(new, old):
                    continue
                if old is not None:
                    keys.append(ptr)
                    diffs.append(-1)
                    out_rows.append(old)
                    del emitted[ptr]
                if new is not None:
                    keys.append(ptr)
                    diffs.append(1)
                    out_rows.append(new)
                    emitted[ptr] = new
            self.pending[arg_name] = _delta_from_rows(keys, diffs, out_rows, self.out_names[arg_name])
        return self.pending.pop(self.arg_names[0])

    def _apply(self, arg_name: str, delta: Delta) -> Set[Tuple[str, Pointer]]:
        rows = self.rows[arg_name]
        names = list(delta.columns)
        pointers = keys_to_pointers(delta.keys)
        retract = delta.diffs < 0
        # retractions first: a replaced row is a -1 / +1 pair on one key
        for phase in (True, False):
            for i in (retract == phase).nonzero()[0].tolist():
                if phase:
                    rows.pop(pointers[i], None)
                else:
                    rows[pointers[i]] = {n: delta.columns[n][i] for n in names}
        return {(arg_name, p) for p in pointers}

    def _set_reads(self, row_id: Tuple[str, Pointer], reads: Set[Tuple[str, Pointer]]) -> None:
        for dep in self.reads.pop(row_id, ()):
            readers = self.readers.get(dep)
            if readers is not None:
                readers.discard(row_id)
                if not readers:
                    del self.readers[dep]
        if reads:
            self.reads[row_id] = reads
            for dep in reads:
                self.readers.setdefault(dep, set()).add(row_id)

    def take_output(self, name: str) -> Delta:
        return self.pending.pop(name, None) or Delta.empty(self.out_names[name])


class RowTransformerResultEvaluator(Evaluator):
    """Hands on the parent's output for one further class argument."""

    def process(self, input_deltas: List[Delta]) -> Delta:
        parent = self.runner.evaluators[self.node.config["parent"].id]
        return parent.take_output(self.node.config["result_name"])


EVALUATORS: Dict[type, type] = {
    pg.InputNode: InputEvaluator,
    pg.RowwiseNode: RowwiseEvaluator,
    pg.FilterNode: FilterEvaluator,
    pg.ReindexNode: ReindexEvaluator,
    pg.ConcatNode: ConcatEvaluator,
    pg.GroupbyNode: GroupbyEvaluator,
    pg.JoinNode: JoinEvaluator,
    pg.FlattenNode: FlattenEvaluator,
    pg.IxNode: IxEvaluator,
    pg.ExternalIndexNode: ExternalIndexEvaluator,
    pg.OutputNode: OutputEvaluator,
    pg.UpdateRowsNode: UpdateRowsEvaluator,
    pg.IntersectNode: IntersectEvaluator,
    pg.DifferenceNode: DifferenceEvaluator,
    pg.RestrictNode: RestrictEvaluator,
    pg.HavingNode: HavingEvaluator,
    pg.AsofNowUpdateNode: AsofNowEvaluator,
    pg.BufferNode: BufferEvaluator,
    pg.FreezeNode: FreezeEvaluator,
    pg.ForgetNode: ForgetEvaluator,
    pg.DeduplicateNode: DeduplicateEvaluator,
    pg.UpdateCellsNode: UpdateCellsEvaluator,
    pg.WithUniverseOfNode: WithUniverseOfEvaluator,
    pg.SortNode: SortEvaluator,
    pg.SortedIndexNode: SortedIndexEvaluator,
    pg.RemoveErrorsNode: RemoveErrorsEvaluator,
    pg.GradualBroadcastNode: GradualBroadcastEvaluator,
    pg.RowTransformerNode: RowTransformerEvaluator,
    pg.RowTransformerResultNode: RowTransformerResultEvaluator,
}


def _register_iterate() -> None:
    from pathway_tpu_torch.internals.iterate import IterateEvaluator, IterateResultEvaluator

    EVALUATORS[pg.IterateNode] = IterateEvaluator
    EVALUATORS[pg.IterateResultNode] = IterateResultEvaluator


_register_iterate()
