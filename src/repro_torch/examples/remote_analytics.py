"""Cross-process serving demo: the §4.1 expert-finding analysis, run by a
*client process* against a Ringo server it spawned.

Ringo's premise (§2.1) is many analysts sharing one big-memory machine.
``stackoverflow_experts.py`` runs that workload in-process; this example
runs the *identical* workload body through the wire protocol:

    server process   python -m repro_torch.serve.server   (spawned here)
        one GraphService: shared Workspace, admission control, fair-share
        scheduler, fusion + result cache
    this process     RemoteService -> RemoteSession      (serve/client.py)
        declarative requests as binary frames; results stream back with
        their provenance chains, so even `export_script` of a remotely
        computed table works locally

It finishes by asserting the remote run's expert scores match an in-process
run bit-for-bit, then asks the server to drain and exit.  The reference's
``examples/remote_analytics.py`` on the port; server and client run on the
card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.remote_analytics \\
        [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.examples.stackoverflow_experts import run_workload
from repro_torch.serve.client import RemoteService
from repro_torch.serve.graph_service import GraphService
from repro_torch.serve.server import spawn_server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    extra = ("--workers", "2")
    if args.device is not None:
        extra += ("--device", args.device)
    proc, port = spawn_server(extra)
    print(f"spawned server pid={proc.pid} on port {port}")
    try:
        client = RemoteService(port=port, device=args.device)
        print(f"connected: conn={client.conn_id} "
              f"server_pid={client.server_pid} "
              f"(client pid={os.getpid()})")
        assert client.server_pid != os.getpid(), "not actually remote?!"

        # smaller dataset than the in-process demo: this example runs the
        # workload twice (wire + in-process) to prove equality
        S_remote = run_workload(
            client, n_questions=800,
            export_path=os.path.join(tempfile.gettempdir(),
                                     "remote_analytics_export.py"))

        # same workload, in-process: scores must be identical
        S_local = run_workload(GraphService(device=args.device),
                               n_questions=800)
        np.testing.assert_array_equal(S_remote.column_np("Scr"),
                                      S_local.column_np("Scr"))
        np.testing.assert_array_equal(S_remote.column_np("User"),
                                      S_local.column_np("User"))
        print("remote scores == in-process scores ✓")

        client.shutdown_server()
        client.close()
        rc = proc.wait(timeout=120)
        print(f"server exited rc={rc}")
        assert rc == 0, "server did not shut down cleanly"
    finally:
        if proc.poll() is None:      # failure path: don't leak the server
            proc.kill()


if __name__ == "__main__":
    main()
