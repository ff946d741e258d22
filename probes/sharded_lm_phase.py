"""Phase 4f with the phases that write its yardstick: what ``chip_smoke.py``
measures for the LM served over two ranks, without phases 2-3 before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/sharded_lm_phase.py

Prints the card's name and power limit, the Python / torch / CUDA
versions and the lines of phase 4 (qwen2.5-3b at d = 1), phase 4c
(qwen3-moe and grok-1; qwen3-moe's yardstick with ``expert_tp`` over one
rank) and phase 4f (both models over two gloo ranks sharing the card, held
to the yardsticks; peak memory without the earlier phases' graphs on the
card).
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
    dev = torch.device("cuda")
    _, _, yard = cs.phase_serve(dev, kernels, False)
    torch.cuda.empty_cache()
    _, _, yards = cs.phase_moe_serve(dev, kernels, False,
                                     cs.sharded_lm_baselines())
    torch.cuda.empty_cache()
    cs.phase_sharded_lm(dev, {cs.SHARDED_LM_MODELS[0][0]: yard, **yards})


if __name__ == "__main__":
    main()
