"""Phase 4l alone: the xLSTM, whisper, VLM and hybrid families trained over
model ranks, as ``chip_smoke.py`` runs it, without phases 2-4k before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/family_train_phase.py [--runs e,f]

Prints the card's name and power limit, the Python / torch / CUDA
versions, then runs ``phase_family_train``: the d = 1 runs of (a)
xlstm-350m, (b) whisper-small, (c) internvl2-26b cut to 4 layers, (d)
jamba-1.5-large in one period of ``attn_every = 2`` with 4 experts, (e)
starcoder2-15b and (f) mistral-nemo-12b cut to 2 layers, then all in one
world of 16 gloo ranks sharing the card, each over (1, m) and held to its
d = 1 run (``--runs``: only the runs named).  Then K4's backward at
whisper's three attention shapes of a rank, against the plain version and
SDPA's backward (K4's row ``backward_whisper`` in the smoke).

On a machine without a card, ``tests/test_torch_family_train.py``
rehearses the phase's rank function at reduced widths on the CPU.
"""
import json
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
    cs.expandable_segments()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    if "--runs" in sys.argv[1:]:
        keep = sys.argv[sys.argv.index("--runs") + 1].split(",")
        cs.FAMILY_TRAIN_RUNS = tuple(r for r in cs.FAMILY_TRAIN_RUNS
                                     if r[0] in keep)
    t0 = time.perf_counter()
    launches, rows = cs.phase_family_train(
        torch.device("cuda"), (bsr_spmv, segment_sum_chunked, bsr_tricount,
                               flash_attention_fwd))
    print(json.dumps({"launches": launches, "k4_rows": rows,
                      "seconds": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(3)]

    cs.emit({"k4_backward_whisper": [
        cs.kernel_k4_backward(qkv, shape=q, sk=sk, causal=c)
        for q, sk, c in cs.WHISPER_K4_BACKWARD]})


if __name__ == "__main__":
    main()
