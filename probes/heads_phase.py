"""Phase 4j alone: attention's heads over model ranks that do not split
them evenly (whole heads a rank), and the audio and vlm families sharded,
as ``chip_smoke.py`` runs it, without phases 2-4i before it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/heads_phase.py

Prints the card's name and power limit, the Python / torch / CUDA
versions, then makes the d = 1 yardsticks phase 4d makes on its models
(whisper-small at full width and depth, internvl2-26b cut to 24 layers;
the same seed-0 weights) and runs ``phase_heads``: (a) qwen1.5-4b cut to
8 layers and (b) whisper-small over (1, 8) gloo ranks sharing the card,
(c) internvl2-26b over (1, 2).
"""
import subprocess
import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.models.transformer import Transformer    # noqa: E402


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda")
    yards = {}
    for arch in ("whisper-small", "internvl2-26b"):
        cfg = cs.heads_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = Transformer.init_params(cfg, gen, device=dev)
        yards[arch] = cs.heads_yardstick(model, cs.heads_inputs(cfg), dev)[0]
        del model
        torch.cuda.empty_cache()
    cs.phase_heads(dev, (), yards)


if __name__ == "__main__":
    main()
