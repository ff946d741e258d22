"""Phase 4k alone: the ssm and hybrid families over model ranks, as
``chip_smoke.py`` runs it, without phases 2-4j before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/recurrent_phase.py

Prints the card's name and power limit, the Python / torch / CUDA
versions, then runs ``phase_recurrent``: the d = 1 runs of (a)
xlstm-350m at full width and depth and (b) jamba-1.5-large at full width
in phase 4e's period, then (a) over (1, 8) and (b) over (1, 2) gloo ranks
sharing the card, each held to its d = 1 run.
"""
import subprocess
import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.kernels.bsr_spmv import bsr_spmv         # noqa: E402
from repro_torch.kernels.bsr_tricount import bsr_tricount  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa
from repro_torch.kernels.segment_sum import segment_sum_chunked  # noqa: E402


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    t0 = time.perf_counter()
    launches, rows = cs.phase_recurrent(
        torch.device("cuda"), (bsr_spmv, segment_sum_chunked, bsr_tricount,
                               flash_attention_fwd))
    print({"launches": launches, "k4_rows": len(rows),
           "seconds": time.perf_counter() - t0}, flush=True)


if __name__ == "__main__":
    main()
