"""Quickstart: the Ringo loop — tables -> graph -> analytics -> tables.

The reference's ``examples/quickstart.py``, step for step, on the port.  It
runs on the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import algorithms as A
from repro_torch.core import relational as R
from repro_torch.core.convert import graph_to_edge_table, table_from_map, to_graph
from repro_torch.core.table import INT, Table
from repro_torch.device import DeviceLike


def run(device: DeviceLike = None) -> dict:
    """The six steps, printed; returns the tables, the graph and the
    results."""
    # 1. load an edge table (any relational source; here synthetic follows)
    rng = np.random.default_rng(0)
    t = Table.from_columns(
        {"src": INT, "dst": INT, "weight": INT},
        {"src": rng.integers(0, 200, 2000),
         "dst": rng.integers(0, 200, 2000),
         "weight": rng.integers(1, 10, 2000)}, device=device)
    print("edge table:", t)

    # 2. relational preprocessing: keep strong edges only
    strong = R.select(t, "weight", ">=", 5)
    print("after select:", strong)

    # 3. sort-first conversion to the graph object (paper §2.4)
    g = to_graph(strong, "src", "dst", drop_self_loops=True)
    print("graph:", g)

    # 4. graph analytics (paper Table 3/6 algorithms)
    pr = A.pagerank(g, n_iter=10)
    tri = A.triangle_count(g.to_undirected())
    components = len(set(A.connected_components(g).tolist()))
    print(f"triangles={tri}  components={components}")

    # 5. results back to a table, top-ranked first (paper §4.1)
    ranked = table_from_map(g, pr, "node", "pagerank")
    top = ranked.to_pydict()
    top5 = list(zip(top["node"][:5], top["pagerank"][:5]))
    print("top-5 nodes:", [(n, round(s, 5)) for n, s in top5])

    # 6. and graphs convert back to edge tables (paper Table 5)
    edges = graph_to_edge_table(g)
    print("round trip:", edges)
    return {"table": t, "strong": strong, "graph": g, "pagerank": pr,
            "triangles": tri, "components": components, "ranked": ranked,
            "top5": top5, "edges": edges}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
