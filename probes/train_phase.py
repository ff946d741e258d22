"""Phase 4b alone, and K4's backward row: what ``chip_smoke.py`` measures
for training, without phases 2-4 before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/train_phase.py [--profile]

Prints ``df`` and ``free`` (the checkpoint writes ~41 GB under
``build/phase4b/`` and removes it), the Python / torch / CUDA versions,
``kernel_k4_backward``'s row at (2, 1024, 16, 128) bf16 and
``phase_train``'s line (peak memory without earlier phases' graphs on
the card; with ``--profile`` the step's device-busy share).
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
    for cmd in (["df", "-h", ".", "/tmp"], ["free", "-g"]):
        print(subprocess.run(cmd, capture_output=True, text=True).stdout)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    kernels = (bsr_spmv, segment_sum_chunked, bsr_tricount,
               flash_attention_fwd)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(3)]
    cs.emit({"k4_backward": cs.kernel_k4_backward(qkv)})
    torch.cuda.empty_cache()
    cs.emit({"train_launches": cs.phase_train(
        torch.device("cuda"), kernels, "--profile" in sys.argv)})


if __name__ == "__main__":
    main()
