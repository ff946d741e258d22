"""Phase 4m alone: mistral-nemo-12b and starcoder2-15b served at full
width and depth, as ``chip_smoke.py`` runs it, without phases 2-4e before
it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/dense_configs_phase.py [--profile]

Prints the card's name and power limit, the Python / torch / CUDA
versions and ``phase_dense_configs``' line: each config at its published
40 layers and width, bf16 weights from seed 0 (24.49 and 31.91 GB), one
on the card at a time, behind ``Engine`` with phase 4's batch and prompts;
phase 4's checks (K4 once a layer a ``generate``, all ``"sm90_wgmma"``;
a second ``generate`` gives the same tokens; decode against ``forward``);
then K4 held to its plain version on each model's layer-0 q, k, v and
timed beside SDPA and its bound (peak memory without the earlier phases'
graphs on the card; with ``--profile`` the device-busy share of one
prefill and one decode step of each).
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
    cs.phase_dense_configs(torch.device("cuda"), kernels,
                           "--profile" in sys.argv[1:])


if __name__ == "__main__":
    main()
