"""How long one ``ModelGroup.psum`` takes when n gloo ranks share one card,
with each rank's CUDA waits spinning (the default) or blocking.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/rank_sync_latency.py

For n in (8, 16) and each wait mode, spawns a world of n ranks; each
rank runs 60 rounds of a small kernel and a ``psum`` of a (2, 64, 768)
bf16 tensor (whisper's decoder rows, the size phase 4l's whisper ranks sum
most), the first 10 rounds a warm-up.  "blocking" sets the primary
context's ``CU_CTX_SCHED_BLOCKING_SYNC`` through libcuda's API before
torch touches the card (:func:`blocking_cuda_waits`).  Prints one
JSON line per world: the median and mean ms a round on rank 0, and the
host CPU time the ranks used.
"""
import datetime
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402

ROUNDS, WARMUP = 60, 10


def blocking_cuda_waits() -> None:
    """Make this process's waits on the card block in libcuda rather
    than spin (``CU_CTX_SCHED_BLOCKING_SYNC`` on device 0's primary
    context, through libcuda's API, before torch touches the card).  By
    default a process with fewer contexts than CPU cores spins while it
    waits, taking a core that another rank on the host could use."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    dev = ctypes.c_int()
    for call in (cuda.cuInit(0), cuda.cuDeviceGet(ctypes.byref(dev), 0),
                 cuda.cuDevicePrimaryCtxSetFlags_v2(dev, 0x4)):
        cs.check(call == 0, f"libcuda call returned {call}")


def rank_main(rank: int, n: int, workdir: str, blocking: bool) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import ModelGroup
    torch.set_num_threads(1)
    if blocking:
        blocking_cuda_waits()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    try:
        group = ModelGroup(n, rank, dist.new_group(list(range(n))))
        x = torch.randn((2, 64, 768), device="cuda").to(torch.bfloat16)
        times = []
        for i in range(ROUNDS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = group.psum(x * 2)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        del y
        use = resource.getrusage(resource.RUSAGE_SELF)
        rec = {"ms": [1e3 * t for t in times[WARMUP:]],
               "cpu_seconds": use.ru_utime + use.ru_stime}
        Path(workdir, f"rank{rank}.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda,
          os.cpu_count(), flush=True)
    for n in (8, 16):
        for blocking in (False, True):
            with tempfile.TemporaryDirectory() as work:
                t0 = time.perf_counter()
                cs.run_ranks(rank_main, n, 300.0, f"{n} ranks", work,
                             blocking)
                recs = [json.loads(Path(work, f"rank{r}.json").read_text())
                        for r in range(n)]
            ms = recs[0]["ms"]
            cs.emit({"ranks": n, "waits": "blocking" if blocking else
                     "spinning", "median_ms": statistics.median(ms),
                     "mean_ms": statistics.mean(ms),
                     "cpu_seconds": sum(r["cpu_seconds"] for r in recs),
                     "world_seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
