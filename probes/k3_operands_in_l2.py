"""How much of K3's time on the card is operand traffic from device memory.

Times the "bsr" triangle kernel (K3, ``bsr_tricount``) at RMAT scale 14 on
its own triples, then on the same runs with every A_IK and A_KJ index
folded into the first 64 tiles (2 MB of fp16, which stay in the 50 MB L2),
alternating the two orders in one process.  The gap is what reading the
315 MB of operands from device memory costs; what is left with the
operands in L2 is the L2-to-SM stream plus the tensor-core work.  The
folded count is not a triangle count and is not checked.

    python3 probes/k3_operands_in_l2.py      # from the repo root, one card

Prints the ``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FOLD = 64        # tiles the folded operands come from
REPS = 5


def cuda_ms(fn, reps: int) -> list:
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.graph import Graph
    from repro_torch.data.rmat import rmat_edges
    from repro_torch.kernels.bsr_tricount import bsr_tricount

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src, dst = rmat_edges(14, 16, seed=0)
    plan = Graph.from_edges(src, dst, device="cuda").to_undirected().plan()
    tiles, _, _, _ = plan.bsr()
    tiles = torch.clamp(tiles, max=1.0)
    t_ij, t_ik, t_kj = plan.tri_triples()
    folded = ((t_ik % FOLD).contiguous(), (t_kj % FOLD).contiguous())
    times = {"operands_from_memory": [], "operands_in_l2": []}
    for order in range(2):   # path, folded, folded, path
        pair = [("operands_from_memory", (t_ik, t_kj)),
                ("operands_in_l2", folded)]
        for name, (ik, kj) in (pair if order == 0 else pair[::-1]):
            times[name] += cuda_ms(lambda: bsr_tricount(tiles, t_ij, ik, kj),
                                   REPS)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({
        "nvidia_smi": smi, "triples": int(t_ij.shape[0]),
        "tiles": list(tiles.shape), "fold_tiles": FOLD, "ms": times,
        "median_ms": med,
        "memory_share": 1.0 - med["operands_in_l2"]
        / med["operands_from_memory"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
