"""Phase 3g at R-MAT scale 20, then where a training step's device time
goes.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/train_step_profile.py

First ``chip_smoke.phase_sharded_service`` on an R-MAT scale-20 graph
(the 2-rank "sharded" service against "xla" results computed here);
then qwen2.5-3b at full width trains two steps on phase 4b's corpus and a
third runs under ``torch.profiler`` (``chip_smoke.device_busy``): its
busy share, K4's part and the 16 kernels with the most device time.
"""
import sys

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402
from repro_torch.configs.base import get_config           # noqa: E402
from repro_torch.core import algorithms as A              # noqa: E402
from repro_torch.core.graph import Graph                  # noqa: E402
from repro_torch.data.graph_corpus import RandomWalkCorpus  # noqa: E402
from repro_torch.data.rmat import rmat_edges              # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.train.optimizer import OptHyper          # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda")
    g = Graph.from_edges(*rmat_edges(20, 16), device=dev)
    src = int(torch.argmax(g.plan().out_deg))
    ref = {"pagerank_n10": A.pagerank(g, n_iter=10, backend="xla"),
           "pagerank_tol": A.pagerank(g, tol=1e-6, backend="xla"),
           "bfs": A.bfs(g, src, backend="xla"),
           "connected_components": A.connected_components(g, backend="xla"),
           "source": src}
    cs.phase_sharded_service(dev, g, ref)
    del g, ref
    torch.cuda.empty_cache()

    cfg = get_config("qwen2.5-3b")
    s, d = rmat_edges(17, 16, seed=0)
    keep = s != d
    g = Graph.from_edges(s[keep], d[keep], dedupe=True, device=dev)
    corpus = RandomWalkCorpus(g, 2, 1024, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in corpus.batch_at(i).items()} for i in range(4)]
    model, st = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = make_train_step(cfg, OptHyper(), attn_chunk=1024)
    for i in range(2):
        step(model, st, batches[i], i)
    torch.cuda.synchronize()
    cs.emit({"profile_step": cs.device_busy(
        lambda: step(model, st, batches[2], 2), {"k4": ("flash_fwd",)},
        top=16)})


if __name__ == "__main__":
    main()
