"""Phase 4g alone: what ``chip_smoke.py`` measures of the dry run, without
phases 2-4e before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/dryrun_phase.py

Prints the card's name and power limit, the Python / torch / CUDA
versions and ``phase_dryrun``'s line: the dry run's single- and two-pod
sweeps on the meta device, rank 0 of qwen2.5-3b x prefill_32k x single
at full width and depth on the card (its counted flops against the meta
count, the prefill's seconds and ``max_memory_allocated`` without the
earlier phases' graphs on the card), K4 on its layer-0 q, k, v at (2,
32768, 1, 128), and rank 0's PageRank step of two ringo cells against
the CPU.
"""
import subprocess
import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402
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
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    cs.phase_dryrun(torch.device("cuda"), kernels)


if __name__ == "__main__":
    main()
