"""Phase 4i alone: the giant models with their weights 2-D (every
weight's d_model dim split over "data") over four gloo ranks sharing the
card, as ``chip_smoke.py`` runs it, without phases 2-4h before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/two_d_phase.py

Prints the card's name and power limit, the Python / torch / CUDA
versions, then builds phase 4b's first two batches (2 x 1024 random
walks over an R-MAT graph, seed 0), takes phase 4h (c)'s one-rank run of
qwen3-moe cut to 2 layers (``expert_tp``, capacity factor 1.25, two
Adafactor steps) and runs ``phase_two_d``: (a) that model over (2, 2)
serving 4 new tokens and training 2 steps, (b) grok-1 cut to 1 layer
serving 2.
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
               for i in range(2)]
    del g, corpus
    run, arch, n_layers, _, steps, over = cs.SHARDED_TRAIN_RUNS[2]
    one_rank = cs.train_one_rank(
        dev, cs.sharded_train_config(arch, n_layers, over), batches, steps)
    print(json.dumps({"phase4h_c_one_rank_steps": one_rank}), flush=True)
    cs.phase_two_d(dev, kernels, one_rank, batches)


if __name__ == "__main__":
    main()
