"""Shared helpers for the port's parity tests: NumPy oracles and the corpus.

A copy of ``tests/test_oracle.py``'s pure-NumPy references and six-graph
corpus, kept apart so that file stays as it is.  The corpus is given as edge
arrays with a builder, so the same inputs build both the reference's
``repro.core.graph.Graph`` and the port's ``repro_torch.core.graph.Graph``.
"""

import collections

import numpy as np

from repro_torch.data.rmat import rmat_edges


# ---------------------------------------------------------------------------
# the corpus — (name, kind, src, dst, n): kind "edges" renumbers original
# ids (Graph.from_edges), kind "dense" takes dense ids as given
# ---------------------------------------------------------------------------


def corpus():
    out = []
    s, d = rmat_edges(6, edge_factor=4, seed=5)
    out.append(("rmat", "edges", s, d, None))
    n = 33
    out.append(("star", "edges", np.zeros(n - 1, np.int32),
                np.arange(1, n, dtype=np.int32), None))
    out.append(("path", "edges", np.arange(0, 40, dtype=np.int32),
                np.arange(1, 41, dtype=np.int32), None))
    # two components + isolated vertices (ids 20..23 have no edges at all)
    ds, dd = rmat_edges(4, edge_factor=3, seed=9)
    src = np.concatenate([ds % 8, ds % 6 + 10]).astype(np.int32)
    dst = np.concatenate([dd % 8, dd % 6 + 10]).astype(np.int32)
    out.append(("disconnected", "dense", src, dst, 24))
    out.append(("self_loop", "edges", np.asarray([0, 1, 2, 2, 3], np.int32),
                np.asarray([0, 2, 2, 3, 1], np.int32), None))
    e = np.zeros((0,), np.int32)
    out.append(("zero_edge", "dense", e, e, 8))
    return out


def build(graph_cls, entry, **kw):
    """Build ``entry`` (a corpus tuple) with either package's Graph class."""
    _, kind, src, dst, n = entry
    if kind == "dense":
        return graph_cls.from_dense_edges(src, dst, n, **kw)
    return graph_cls.from_edges(src, dst, **kw)


def edge_list(src, dst):
    return list(zip(np.asarray(src).tolist(), np.asarray(dst).tolist()))


def undirected_simple(edges):
    """Symmetrized, deduped, self-loop-free adjacency (to_undirected dual)."""
    adj = collections.defaultdict(set)
    for a, b in edges:
        if a != b:
            adj[a].add(b)
            adj[b].add(a)
    return adj


# ---------------------------------------------------------------------------
# pure-NumPy references
# ---------------------------------------------------------------------------


def np_pagerank(edges, n, n_iter=10, damping=0.85):
    pr = np.full(n, 1.0 / n, np.float64)
    outdeg = np.zeros(n)
    for s, _ in edges:
        outdeg[s] += 1
    for _ in range(n_iter):
        new = np.full(n, (1.0 - damping) / n)
        new += damping * pr[outdeg == 0].sum() / n
        for s, t in edges:
            new[t] += damping * pr[s] / outdeg[s]
        pr = new
    return pr


def np_bfs(edges, n, source):
    adj = collections.defaultdict(list)
    for s, t in edges:
        adj[s].append(t)
    level = np.full(n, -1, np.int64)
    level[source] = 0
    q = collections.deque([source])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if level[v] < 0:
                level[v] = level[u] + 1
                q.append(v)
    return level


def np_sssp(edges, n, source, w=None):
    """Bellman-Ford over the edge list (matches the engine's relaxation)."""
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    w = np.ones(len(edges)) if w is None else np.asarray(w, np.float64)
    for _ in range(max(n, 1)):
        changed = False
        for (s, t), wv in zip(edges, w):
            if dist[s] + wv < dist[t]:
                dist[t] = dist[s] + wv
                changed = True
        if not changed:
            break
    return dist


def np_connected_components(edges, n):
    """Min dense id per weakly-connected component (isolated = own id)."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.asarray([find(i) for i in range(n)])


def np_k_core(edges, n, k):
    """Iterative peeling on the undirected simple view (alive mask)."""
    adj = undirected_simple(edges)
    alive = np.ones(n, bool)
    while True:
        deg = np.asarray([sum(alive[v] for v in adj[u]) if alive[u] else 0
                          for u in range(n)])
        new = alive & (deg >= k)
        if (new == alive).all():
            return new
        alive = new


def np_triangle_count(edges, n):
    adj = undirected_simple(edges)
    total = 0
    for u in range(n):
        for v in adj[u]:
            if v > u:
                total += len(adj[u] & adj[v] - {u, v})
    return total // 3


# ---------------------------------------------------------------------------
# dense LM parameters shared by the reference and the port
# ---------------------------------------------------------------------------


def lm_arrays(ref_cfg, seed=0):
    """The reference's ``init_params(PRNGKey(seed))`` as numpy arrays, with
    every bias and norm parameter (zeros and ones at init) replaced by
    seeded numpy values, so the parity tests exercise them."""
    import jax
    from repro.models.transformer import init_params

    params = jax.tree.map(np.array, init_params(ref_cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1000)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "scale":
                tree[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)
            elif k in ("b", "bias"):
                tree[k] = (0.2 * rng.normal(size=v.shape)).astype(v.dtype)

    perturb(params)
    return params


# ---------------------------------------------------------------------------
# tables: the reference's and the port's, element for element
# ---------------------------------------------------------------------------

FLOAT_TOL = 1e-5   # the reference's kernel tolerance


def assert_tables_equal(ref, port):
    """A reference ``Table`` and a port ``Table`` hold the same table:
    schema, ``n_valid``, capacity, ``next_row_id`` and dictionaries equal;
    ``row_ids`` equal over the whole capacity; every column's valid prefix
    equal in value (floats within ``FLOAT_TOL``) and in dtype."""
    assert port.schema.fields == ref.schema.fields
    assert (port.n_valid, port.capacity, port.next_row_id) == \
        (ref.n_valid, ref.capacity, ref.next_row_id)
    assert port.dicts == ref.dicts
    np.testing.assert_array_equal(port.row_ids.cpu().numpy(),
                                  np.asarray(ref.row_ids))
    for name, typ in ref.schema.fields:
        want, got = np.asarray(ref.column(name)), port.column_np(name)
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        if typ == "float":
            np.testing.assert_allclose(got, want, rtol=FLOAT_TOL,
                                       atol=FLOAT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
