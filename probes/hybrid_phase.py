"""Phase 4e alone: what ``chip_smoke.py`` measures for jamba's hybrid
period, without phases 2-4d before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/hybrid_phase.py [--profile]

Prints the card's name and power limit, the Python / torch / CUDA
versions and ``phase_hybrid``'s line: jamba-1.5-large at full width, one
``attn_every = 4`` period (3 Mamba mixers, then attention; MoE on two
sub-layers), bf16, behind ``Engine``; the full-width float32 Mamba's
train scan against its decode steps and a plain recurrence; decode
against forward; K4 held to its plain version on the attention layer's
own q, k, v (peak memory without the earlier phases' graphs on the card;
with ``--profile`` the device-busy share of one prefill and one decode
step).
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
    cs.phase_hybrid(torch.device("cuda"), kernels,
                    "--profile" in sys.argv[1:])


if __name__ == "__main__":
    main()
