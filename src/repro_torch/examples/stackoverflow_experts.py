"""Paper §4.1 demo: find the top Java experts on StackOverflow — now run the
way the paper runs it: through the *interactive service* (§2.1), with every
derived object carrying provenance, and the finished analysis exported as a
standalone script (§4).

Mirrors the paper's Ringo commands on a synthetic StackOverflow (the real
dump isn't shipped in this container):

    P  = ringo.LoadTableTSV(schema, 'posts.tsv')
    JP = ringo.Select(P, 'Tag=Java')
    Q  = ringo.Select(JP, 'Type=question')
    A  = ringo.Select(JP, 'Type=answer')
    QA = ringo.Join(Q, A, 'AnswerId', 'PostId')
    G  = ringo.ToGraph(QA, 'UserId-1', 'UserId-2')
    PR = ringo.GetPageRank(G)
    S  = ringo.TableFromHashMap(PR, 'User', 'Scr')

Each command becomes a declarative request to :class:`GraphService`; repeated
queries hit the versioned result cache, concurrent single-source traversals
fuse into one batched engine call, and the final table's provenance chain is
exported with ``export_script`` and re-executed to verify identical scores.

The workload body (:func:`run_workload`) is transport-agnostic: it takes any
object mirroring the service surface (``.workspace``, ``.session``,
``.stats``, ``.device``), so the same code runs against the in-process
:class:`GraphService` (this file's ``main``) or a
:class:`repro_torch.serve.client.RemoteService` speaking the wire protocol
to a separate server process (``remote_analytics.py``) — the acceptance
bar for the cross-process subsystem is that both produce identical scores
and provenance.

The reference's ``examples/stackoverflow_experts.py`` on the port; it runs
on the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.stackoverflow_experts \
        [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import algorithms as A
from repro_torch.core import provenance
from repro_torch.core.graph import EdgeDelta
from repro_torch.core.table import Table, INT, STR
from repro_torch.serve.graph_service import GraphService


def _host(x) -> np.ndarray:
    """A result as a host array, whichever transport returned it."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def synthetic_stackoverflow(n_users=500, n_questions=3000, seed=0,
                            device=None):
    """Questions + accepted answers; a few 'expert' users answer often."""
    rng = np.random.default_rng(seed)
    experts = rng.choice(n_users, 12, replace=False)
    post_id, ptype, tag, user, answer_id = [], [], [], [], []
    pid = 0
    for q in range(n_questions):
        qtag = rng.choice(["Java", "Python", "C++"], p=[0.5, 0.3, 0.2])
        asker = int(rng.integers(0, n_users))
        q_pid = pid
        post_id.append(q_pid); ptype.append("question"); tag.append(qtag)
        user.append(asker)
        # answer posts; the accepted one is linked from the question
        if rng.random() < 0.6:
            answerer = int(rng.choice(experts)) if rng.random() < 0.7 \
                else int(rng.integers(0, n_users))
            pid += 1
            post_id.append(pid); ptype.append("answer"); tag.append(qtag)
            user.append(answerer)
            answer_id.append(pid)       # question's accepted answer
        else:
            answer_id.append(-1)
        answer_id.extend([-1] * (pid - q_pid))  # answers have no AnswerId
        pid += 1
    return Table.from_columns(
        {"PostId": INT, "Type": STR, "Tag": STR, "UserId": INT,
         "AnswerId": INT},
        {"PostId": post_id, "Type": ptype, "Tag": tag, "UserId": user,
         "AnswerId": answer_id}, device=device)


def run_workload(service, *, n_questions=3000, export_path=None):
    """The paper's §4.1 command sequence against any service transport.

    Returns the final experts table; asserts the exported provenance script
    re-executes to identical scores along the way.  The posts table is
    built on ``service.device``; the script goes to ``export_path``
    (default: ``stackoverflow_experts_export.py`` in the temp directory).
    """
    if export_path is None:
        export_path = os.path.join(tempfile.gettempdir(),
                                   "stackoverflow_experts_export.py")
    service.workspace.put("posts",                             # LoadTableTSV
                          synthetic_stackoverflow(n_questions=n_questions,
                                                  device=service.device))
    sess = service.session("analyst")
    print("posts:", sess.get("posts"))

    sess.execute({"op": "select", "table": "posts",                # Tag=Java
                  "params": {"col": "Tag", "op": "==", "value": "Java"},
                  "as": "jp"})
    sess.execute({"op": "select", "table": "jp",                  # questions
                  "params": {"col": "Type", "op": "==", "value": "question"},
                  "as": "q"})
    sess.execute({"op": "select", "table": "jp",                  # answers
                  "params": {"col": "Type", "op": "==", "value": "answer"},
                  "as": "a"})
    sess.execute({"op": "join", "left": "q", "right": "a",        # accepted
                  "params": {"lcol": "AnswerId", "rcol": "PostId"},
                  "as": "qa"})
    print("QA pairs:", sess.get("qa"))
    # edge: asker -> accepted answerer
    sess.execute({"op": "to_graph", "table": "qa",                # ToGraph
                  "params": {"src_col": "UserId_1", "dst_col": "UserId_2"},
                  "as": "g"})
    sess.execute({"op": "pagerank", "graph": "g",                 # GetPageRank
                  "params": {"n_iter": 20}, "as": "pr"})
    S = sess.execute({"op": "table_from_map",            # TableFromHashMap
                      "graph": "g", "scores": "pr",
                      "params": {"key_name": "User", "value_name": "Scr"},
                      "as": "experts"})
    top = S.to_pydict()
    print("top Java experts (user, score):")
    for u, s in list(zip(top["User"], top["Scr"]))[:10]:
        print(f"  user {u:4d}  {s:.5f}")

    # trial-and-error is free: the re-issued query hits the result cache
    sess.execute({"op": "pagerank", "graph": "g", "params": {"n_iter": 20}})
    print("service stats after repeat query:", service.stats)

    # the paper's alternative metric: HITS authorities
    sess.execute({"op": "hits", "graph": "g", "params": {"n_iter": 20},
                  "as": "hits"})
    _, auth = sess.get("hits")
    sess.put("auth", auth)
    S2 = sess.execute({"op": "table_from_map", "graph": "g", "scores": "auth",
                       "params": {"key_name": "User",
                                  "value_name": "Authority"}})
    print("top by HITS authority:", S2.to_pydict()["User"][:10])

    # §4: export the whole analysis as a standalone runnable script, then
    # re-execute it and verify the PageRank scores are identical.  This
    # works even when S was computed in another process: results adopt
    # their provenance chains across the wire, and the posts root the
    # client put() is bound to its server-assigned version token.
    script = provenance.export_script(S)
    with open(export_path, "w") as f:
        f.write(script)
    print(f"exported provenance script ({len(script.splitlines())} lines) "
          f"-> {export_path}")
    ns = {}
    exec(compile(script, export_path, "exec"), ns)
    S_rebuilt = ns["rebuild"]()
    np.testing.assert_array_equal(S_rebuilt.column_np("Scr"),
                                  S.column_np("Scr"))
    np.testing.assert_array_equal(S_rebuilt.column_np("User"),
                                  S.column_np("User"))
    print("re-executed export: PageRank scores identical ✓")

    # §2.3 dynamism: a fresh batch of accepted answers lands while the
    # analyst is still looking at the ranking.  ``apply_delta`` is the one
    # functional update with a wire form, so this epilogue runs unchanged
    # over the remote transport: the service patches the CSR instead of
    # rebuilding, and the re-issued ranking warm-starts from the previous
    # vector instead of solving from scratch.
    sess.execute({"op": "pagerank", "graph": "g",       # converged baseline
                  "params": {"tol": 1e-6}, "as": "pr_live"})
    sess.publish("g")                  # updates are workspace-level
    g_now = service.workspace.get("g")
    ids = g_now.node_ids[:g_now.n_nodes].cpu().numpy()
    rng = np.random.default_rng(1)
    new_edges = EdgeDelta.inserts(ids[rng.integers(0, len(ids), 16)],
                                  ids[rng.integers(0, len(ids), 16)])
    service.workspace.apply_delta("g", new_edges)
    refreshed = sess.execute({"op": "pagerank", "graph": "g",
                              "params": {"tol": 1e-6}})
    assert service.stats["warm_starts"] >= 1, \
        "refresh did not warm-start from the parent vector"
    cold = A.pagerank(service.workspace.get("g"), tol=1e-6)
    np.testing.assert_allclose(_host(refreshed), _host(cold), atol=1e-5)
    print(f"live update: +{new_edges.n_adds} answer edges, ranking "
          f"refreshed warm (warm_starts="
          f"{service.stats['warm_starts']}) == cold recompute ✓")
    return S


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    run_workload(GraphService(device=args.device))


if __name__ == "__main__":
    main()
