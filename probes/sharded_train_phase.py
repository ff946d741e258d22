"""Phase 4h alone: the sharded train step of ``chip_smoke.py``, without
phases 2-4b before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/sharded_train_phase.py

Prints the card's name and power limit, the Python / torch / CUDA
versions, then builds phase 4b's batches (2 x 1024 random walks over an
R-MAT graph, seed 0), takes phase 4b's first three steps of qwen2.5-3b at
full width cut to ``TRAIN_LAYERS`` on one rank as run (a)'s yardstick,
and runs ``phase_sharded_train``: (a) that model over (1, 2), (b) cut to 12
layers over (2, 2), (c) qwen3-moe cut to 2 layers over (1, 2), gloo
ranks sharing the card.  Then K4's backward at a rank's heads, (2, 1024,
8, 128) bf16, against the plain version and SDPA's backward.
"""
import json
import subprocess
import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402
from repro_torch.core.graph import Graph                  # noqa: E402
from repro_torch.data.graph_corpus import RandomWalkCorpus  # noqa: E402
from repro_torch.data.rmat import rmat_edges              # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.kernels.bsr_spmv import bsr_spmv         # noqa: E402
from repro_torch.kernels.bsr_tricount import bsr_tricount  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_chunked  # noqa: E402


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda")
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    s, d = rmat_edges(scale=cs.TRAIN_RMAT[0], edge_factor=cs.TRAIN_RMAT[1],
                      seed=0)
    keep = s != d
    g = Graph.from_edges(s[keep], d[keep], dedupe=True, device=dev)
    corpus = RandomWalkCorpus(g, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in corpus.batch_at(i).items()}
               for i in range(3)]
    del g, corpus
    steps = cs.train_one_rank(dev, cs.train_config(), batches, 3)
    print(json.dumps({"one_rank_steps": steps}), flush=True)
    cs.phase_sharded_train(dev, kernels, {"steps": steps,
                                          "batches": batches})
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    cs.emit({"k4_backward_rank_heads": cs.kernel_k4_backward(qkv, heads=8)})


if __name__ == "__main__":
    main()
