"""Sorted-index subsystem: sorted binary trees over table rows, prev/next
retrieval, and nearest-non-None lookups along a sort order.

Port of ``pathway_tpu/stdlib/indexing/sorting.py``. The tree is built inside the engine
(``SortedIndexEvaluator``: one O(n) cartesian-tree pass per touched instance,
incremental diffs per commit), and only the genuinely relational pieces —
tree-order traversal of a user-supplied tree, chained value lookup — run as
pointer-doubling ``pw.iterate`` graphs.
"""

from __future__ import annotations

from typing import Any, Dict

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr
from pathway_tpu_torch.internals import parse_graph as pg
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table

__all__ = [
    "SortedIndex",
    "build_sorted_index",
    "sort_from_index",
    "retrieve_prev_next_values",
]


# {"index": Table, "oracle": Table}
SortedIndex = Dict[str, Table]


def build_sorted_index(nodes: Table, key: Any = None, instance: Any = None) -> SortedIndex:
    """Sorted binary tree (treap with key-hash priorities) over ``nodes``.

    Returns ``{"index": ..., "oracle": ...}``: ``index`` shares ``nodes``'
    universe and carries ``key``/``left``/``right``/``parent``/``instance``
    columns (tree pointers, in-order = key order); ``oracle`` holds one row per
    instance, keyed by instance, with the tree root in ``root``.
    """
    key_e = nodes._resolve(key if key is not None else nodes.key)
    if instance is None and "instance" in nodes.column_names():
        instance = nodes.instance
    instance_e = nodes._resolve(instance) if instance is not None else None
    node = G.add_node(
        pg.SortedIndexNode(inputs=[nodes], key=key_e, instance=instance_e)
    )
    columns = {
        "key": sch.ColumnSchema("key", dt.ANY),
        "left": sch.ColumnSchema("left", dt.Optional_(dt.POINTER)),
        "right": sch.ColumnSchema("right", dt.Optional_(dt.POINTER)),
        "parent": sch.ColumnSchema("parent", dt.Optional_(dt.POINTER)),
        "instance": sch.ColumnSchema("instance", dt.ANY),
    }
    schema = sch.schema_from_columns(columns, "sorted_index")
    index = Table(node, schema, universe=nodes._universe, name="sorted_index")
    roots = index.filter(index.parent.is_none())
    oracle = roots.select(roots.instance, root=roots.id).with_id_from(roots.instance)
    return {"index": index, "oracle": oracle}


def sort_from_index(index: Table, oracle: Table | None = None) -> Table:
    """In-order prev/next pointers for a binary tree given as
    ``left``/``right``/``parent`` columns (any tree, not only ours).

    The successor of a node is the leftmost node of its right subtree, else the
    nearest ancestor holding it in a left subtree (symmetrically for the
    predecessor). Subtree-extreme and ancestor chains close by pointer doubling
    inside ``pw.iterate`` — O(log depth) rounds.
    """
    import pathway_tpu_torch as pw

    def _up_if_child(parent_child: Any, me: Any, parent: Any) -> Any:
        # the ancestor chain hop: step to the parent while we are its
        # right (resp. left) child, else stay put (chain end)
        return parent if parent_child == me and parent is not None else me

    par = index.ix(index.parent, optional=True)
    state0 = index.select(
        left=index.left,
        right=index.right,
        parent=index.parent,
        lm=expr.coalesce(index.left, index.id),
        rm=expr.coalesce(index.right, index.id),
        up_r=expr.apply_with_type(_up_if_child, dt.POINTER, par.right, index.id, index.parent),
        up_l=expr.apply_with_type(_up_if_child, dt.POINTER, par.left, index.id, index.parent),
    )

    def close(t: Table) -> Table:
        return t.select(
            left=t.left,
            right=t.right,
            parent=t.parent,
            lm=t.ix(t.lm).lm,
            rm=t.ix(t.rm).rm,
            up_r=t.ix(t.up_r).up_r,
            up_l=t.ix(t.up_l).up_l,
        )

    closed = pw.iterate(lambda t: dict(t=close(t)), t=state0).t
    closed.promise_universe_is_equal_to(index)
    closed = closed.with_universe_of(index)
    return closed.select(
        prev=expr.coalesce(
            closed.ix(closed.left, optional=True).rm,
            closed.ix(closed.up_l).parent,
        ),
        next=expr.coalesce(
            closed.ix(closed.right, optional=True).lm,
            closed.ix(closed.up_r).parent,
        ),
    )


def retrieve_prev_next_values(ordered_table: Table, value: Any = None) -> Table:
    """For each row of a prev/next-chained table: pointers to the nearest rows
    (including the row itself) whose ``value`` is present, looking backwards
    (``prev_value``) and forwards (``next_value``).

    Missing means None — or NaN, since this engine materializes absent float
    cells as NaN. Chains over missing runs close by pointer doubling.
    """
    import pathway_tpu_torch as pw

    value_ref = ordered_table.value if value is None else ordered_table[
        value.name if hasattr(value, "name") else str(value)
    ]

    def _self_if_known(v: Any, me: Any) -> Any:
        return me if v is not None and v == v else None

    state0 = ordered_table.select(
        prev=ordered_table.prev,
        next=ordered_table.next,
        prev_value=expr.apply_with_type(
            _self_if_known, dt.Optional_(dt.POINTER), value_ref, ordered_table.id
        ),
        next_value=expr.apply_with_type(
            _self_if_known, dt.Optional_(dt.POINTER), value_ref, ordered_table.id
        ),
    )

    def step(t: Table) -> Table:
        back = t.ix(t.prev, optional=True)
        fwd = t.ix(t.next, optional=True)
        return t.select(
            # unresolved rows skip over unresolved neighbors (doubling)
            prev=expr.if_else(
                t.prev_value.is_none() & back.prev_value.is_none(), back.prev, t.prev
            ),
            next=expr.if_else(
                t.next_value.is_none() & fwd.next_value.is_none(), fwd.next, t.next
            ),
            prev_value=expr.coalesce(t.prev_value, back.prev_value),
            next_value=expr.coalesce(t.next_value, fwd.next_value),
        )

    closed = pw.iterate(lambda t: dict(t=step(t)), t=state0).t
    closed.promise_universe_is_equal_to(ordered_table)
    closed = closed.with_universe_of(ordered_table)
    return closed.select(closed.prev_value, closed.next_value)
