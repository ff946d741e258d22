"""Whether a segment's float sum on the card depends on where it starts.

The "sharded" backend reduces each shard's edge slots with the same
``torch.segment_reduce(..., lengths=)`` as "xla", and promises the same
bits.  A shard's buffer holds only its own edges, so a segment that starts
at offset ``o`` of the global buffer starts at ``o - lo`` in the shard's.
If the CUDA reduction picks its loads (and so its order of additions) by
the alignment of a segment's first value, the two sums can differ; the
engine's ``ShardedExec`` therefore starts each shard buffer with
``lo % _ALIGN`` padding slots.  This probe measures the effect it guards
against:

1. for segments of several lengths it puts ``k`` values of another segment
   in front (k = 0..8, and 128) and compares the segment's sum bit for bit
   with the sum at offset 0, in float32 and in bfloat16;
2. on an R-MAT scale-18 graph it computes each shard's local sum pull at
   d = 2, 3 and 8 (every rank's halo assembled in this one process) with
   the engine's ``_ALIGN`` and with ``_ALIGN = 1`` (no padding), and lists
   the shards whose sums differ from the "xla" pull over their range.

    python3 probes/segment_reduce_alignment.py   # from the repo root

Prints the ``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (1, 31, 100, 1000, 4096, 10_000, 100_000, 1_000_000)
OFFSETS = tuple(range(9)) + (128,)
SHARDS = (2, 3, 8)


def segment_sum_at(vals: torch.Tensor, k: int) -> torch.Tensor:
    """The sum of ``vals`` as the second segment of a buffer whose first
    segment holds ``k`` other values."""
    buf = torch.cat([torch.ones((k,), dtype=vals.dtype, device=vals.device),
                     vals])
    lengths = torch.tensor([k, vals.shape[0]], device=vals.device)
    return torch.segment_reduce(buf, "sum", lengths=lengths, axis=0,
                                unsafe=True)[1]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def shards_differing(g, d: int) -> list:
    """Shards whose local sum pull differs from "xla"'s over their range."""
    from repro_torch.core import engine
    plan = g.plan()
    sp = plan.sharded(d)
    ns, n = sp.ns, g.n_nodes
    x = torch.rand((n,), generator=torch.Generator(device="cuda")
                   .manual_seed(1), device="cuda")
    want = engine.get_exec(plan, "xla").pull(x)
    xp = torch.cat([x, x.new_zeros((d * ns - n,))])
    wpad = torch.cat([want, want.new_zeros((d * ns - n,))])
    blocks = [engine._shard_block(sp.pull, k, ns) for k in range(d)]
    halo = torch.cat([xp[o * ns:(o + 1) * ns].index_select(0, b.bnd)
                      for o, b in enumerate(blocks)])
    out = []
    for k, b in enumerate(blocks):
        ev = torch.cat([xp[k * ns:(k + 1) * ns], halo]).index_select(
            0, b.gidx)
        got = engine._segment_reduce(ev, b.seg, b.lengths, ns + 2,
                                     "sum")[1: ns + 1]
        if not same_bits(got, wpad[k * ns:(k + 1) * ns]):
            out.append(k)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("segment_reduce_alignment: needs a CUDA device",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = {}
        for n in LENGTHS:
            vals = torch.rand((n,), generator=gen, device="cuda").to(dtype)
            base = segment_sum_at(vals, 0)
            differ = [k for k in OFFSETS[1:]
                      if not same_bits(segment_sum_at(vals, k), base)]
            again = same_bits(segment_sum_at(vals, 0), base)
            rows[str(n)] = {"offsets_differing": differ,
                            "same_bits_twice": again}
        out[str(dtype).replace("torch.", "")] = rows

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import engine
    from repro_torch.core.graph import Graph
    from repro_torch.data.rmat import rmat_edges
    g = Graph.from_edges(*rmat_edges(18, 16, seed=0), device="cuda")
    align = engine._ALIGN
    shards = {}
    try:
        for a in (align, 1):
            engine._ALIGN = a
            shards[f"align_{a}"] = {d: shards_differing(g, d)
                                    for d in SHARDS}
    finally:
        engine._ALIGN = align
    print(json.dumps({
        "probe": "segment_reduce_alignment",
        "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "offsets": list(OFFSETS), "segments": out,
        "graph": {"scale": 18, "nodes": g.n_nodes, "edges": g.n_edges,
                  "max_in_degree": int(g.in_degrees().max())},
        "shards_differing_from_xla": shards}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
