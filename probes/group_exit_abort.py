"""How often a gloo world's rank aborts at exit when a process group
outlives ``destroy_process_group``, on the CPU.

    PYTHONPATH=src python probes/group_exit_abort.py [--worlds 40]
        [--ranks 3] [--load 6]

Runs ``--worlds`` gloo worlds of ``--ranks`` spawned ranks, one after
another, with ``--load`` busy processes beside them.  Every rank joins a
``FileStore`` world, takes the port's ``graph_group(d)``, broadcasts 50
small messages through it (what ``serve_follower`` does), then
``barrier`` and ``destroy_process_group`` and exits, as
``tests/_torch_worlds.py`` runs a rank.  Two modes, one line each:

* ``held``: the rank also keeps the default group in a module-level list
  (what ``launch/mesh.py``'s caches did before they held it weakly), so
  the group is freed only during interpreter shutdown;
* ``port``: nothing but the port holds it.

Prints, per mode, the worlds whose ranks did not all exit with 0 and
their exit codes (-6: "terminate called without an active exception").
"""

import argparse
import datetime
import multiprocessing as mp
import tempfile
import time

HELD = []


def _rank(rank: int, d: int, workdir: str, held: bool) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import graph_group
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=60))
    if held:
        HELD.append(dist.group.WORLD)
    group = graph_group(d)
    for i in range(50):
        group.broadcast({"i": i}, [torch.arange(64)] if rank == 0 else ())
    dist.barrier()
    dist.destroy_process_group()


def _busy(seconds: float) -> None:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass


def _world(d: int, held: bool) -> list:
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, d, tmp, held))
                 for r in range(d)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        return [p.exitcode for p in procs]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=int, default=40)
    ap.add_argument("--ranks", type=int, default=3)
    ap.add_argument("--load", type=int, default=6)
    args = ap.parse_args()
    ctx = mp.get_context("spawn")
    for mode in ("held", "port"):
        hogs = [ctx.Process(target=_busy, args=(3600.0,), daemon=True)
                for _ in range(args.load)]
        for h in hogs:
            h.start()
        try:
            bad = []
            for _ in range(args.worlds):
                codes = _world(args.ranks, mode == "held")
                if any(c != 0 for c in codes):
                    bad.append(codes)
        finally:
            for h in hogs:
                h.kill()
        print(f"{mode}: {len(bad)} of {args.worlds} worlds of {args.ranks} "
              f"ranks failed {bad}", flush=True)


if __name__ == "__main__":
    main()
