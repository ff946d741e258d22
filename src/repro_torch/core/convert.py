"""Table ↔ graph conversions (Ringo §2.4, Table 5) in PyTorch.

Counterpart of ``repro/core/convert.py``.  ``to_graph`` is the paper's
**sort-first** algorithm: copy the source and destination columns, sort
them, count each node's neighbours explicitly, bulk-copy the adjacency
(:meth:`Graph.from_edges`), on the table's device.  ``graph_to_edge_table``
and ``graph_to_node_table`` are the reverse conversion; their tables live
on the graph's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .graph import Graph
from .provenance import track
from .table import INT, FLOAT, STR, Schema, Table, _remap_codes

__all__ = [
    "to_graph",
    "graph_to_edge_table",
    "graph_to_node_table",
    "table_from_map",
]


@track("convert.to_graph", "C.to_graph")
def to_graph(t: Table, src_col: str, dst_col: str, dedupe: bool = True,
             drop_self_loops: bool = False) -> Graph:
    """Paper's ``ToGraph(T, S, D)``: nodes = unique values of S ∪ D, one edge
    per row.  STR key columns are joined through their dictionaries first."""
    styp, dtyp = t.schema.type_of(src_col), t.schema.type_of(dst_col)
    if (styp == STR) != (dtyp == STR):
        raise TypeError("src/dst columns must both be ids or both strings")
    src, dst = t.column(src_col), t.column(dst_col)
    if styp == STR:
        # unify the two dictionaries into one id space: the source's codes
        # stay, the destination's map into the merged dictionary
        index = {s: i for i, s in enumerate(t.dicts[src_col])}
        remap = []
        for s in t.dicts[dst_col]:
            index.setdefault(s, len(index))
            remap.append(index[s])
        dst = _remap_codes(dst, remap) if t.n_valid > 0 else dst
    return Graph.from_edges(src, dst, dedupe=dedupe,
                            drop_self_loops=drop_self_loops, device=t.device)


@track("convert.graph_to_edge_table", "C.graph_to_edge_table")
def graph_to_edge_table(g: Graph, src_name: str = "src",
                        dst_name: str = "dst") -> Table:
    """Edge table with original node ids (paper Table 5: graph -> table)."""
    s, d = g.out_edges()
    return Table.from_columns(
        Schema.of([(src_name, INT), (dst_name, INT)]),
        {src_name: g.original_of(s), dst_name: g.original_of(d)},
        device=g.device)


@track("convert.graph_to_node_table", "C.graph_to_node_table")
def graph_to_node_table(g: Graph,
                        values: Optional[Dict[str, torch.Tensor]] = None,
                        id_name: str = "node") -> Table:
    """Node table: original ids plus optional per-node value columns
    (e.g. PageRank scores) indexed by dense id."""
    fields = [(id_name, INT)]
    data: Dict[str, torch.Tensor] = {id_name: g.node_ids[: g.n_nodes]}
    for name, v in (values or {}).items():
        v = torch.as_tensor(v, device=g.device)
        fields.append((name, FLOAT if v.is_floating_point() else INT))
        data[name] = v[: g.n_nodes]
    return Table.from_columns(Schema.of(fields), data, device=g.device)


@track("convert.table_from_map", "C.table_from_map")
def table_from_map(g: Graph, scores: torch.Tensor, key_name: str = "node",
                   value_name: str = "score") -> Table:
    """Paper's ``TableFromHashMap(PR, 'User', 'Scr')`` analogue: per-node
    result map -> two-column table, sorted by score descending (ties keep
    ascending node order)."""
    t = graph_to_node_table(g, {value_name: scores}, id_name=key_name)
    order_ = torch.argsort(-t.column(value_name), stable=True)
    return t.gathered(order_, t.n_valid)
