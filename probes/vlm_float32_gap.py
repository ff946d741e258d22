"""Phase 4j (c) in float32 compute: internvl2-26b at full width cut to 24
of 48 layers over (1, 2) gloo ranks sharing the card, against d = 1.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/vlm_float32_gap.py

Phase 4j holds internvl2's two ranks to the d = 1 run in bf16 compute,
where the largest gap read 3.08% of the largest logit (its limit is 5%).
This probe asks whether that gap is bf16 rounding: the same weights (seed
0), prompts and patches (``heads_inputs``) and the same ``heads_yardstick``
(a prefill of 2 prompts of 128 ids behind 256 patches, then 4
teacher-forced decode steps), with ``compute_dtype="float32"``.  K4 then
takes its CUDA-core variant (float32).  Prints, as one JSON line, the
largest |d = 2 − d = 1| over the largest d = 1 logit, by row and
position, and whether both ranks hold the same bits.
"""
import dataclasses
import datetime
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402

ARCH = "internvl2-26b"
RANKS = 2
WORK = Path(__file__).resolve().parents[1] / "build" / "vlm_float32_gap"


def config():
    return dataclasses.replace(cs.heads_config(ARCH),
                               compute_dtype="float32")


def rank_main(rank: int, d: int, inputs) -> None:
    """One rank: draw seed-0 weights keeping this rank's blocks (the ranks
    in turn), run the yardstick over (1, 2), save the logits."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{WORK / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=300))
    try:
        grid = model_grid(1, d)
        for turn in range(d):
            if turn == rank:
                gen = torch.Generator(device="cuda").manual_seed(0)
                model = Transformer.init_params(config(), gen,
                                                device="cuda", group=grid)
                torch.cuda.empty_cache()
            dist.barrier()
        logits, rec = cs.heads_yardstick(model, inputs, "cuda", grid.model)
        torch.save(logits, WORK / f"rank{rank}.pt")
        (WORK / f"rank{rank}.json").write_text(json.dumps(rec))
        del model
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Transformer
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    t0 = time.perf_counter()
    cfg = config()
    inputs = cs.heads_inputs(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = Transformer.init_params(cfg, gen, device="cuda")
    want, rec_one = cs.heads_yardstick(one, inputs, "cuda")
    del one
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        cs.run_ranks(rank_main, RANKS, 900.0, "vlm float32", inputs)
        got = [torch.load(WORK / f"rank{r}.pt") for r in range(RANKS)]
        recs = [json.loads((WORK / f"rank{r}.json").read_text())
                for r in range(RANKS)]
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    scale = float(want.abs().max())
    err = (got[0].double() - want.double()).abs().amax(-1)   # (B, 1 + n)
    cs.emit({"probe": "vlm_float32_gap", "arch": cfg.name,
             "n_layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
             "grid": [1, RANKS], "max_abs_logit": scale,
             "gap_by_row_and_position": err.tolist(),
             "max_gap_over_max_logit": float(err.max()) / scale,
             "ranks_same_bits": cs.same_bits(got[0], got[1]),
             "finite": bool(all(torch.isfinite(g).all() for g in got)),
             "one_rank": rec_one, "ranks": recs,
             "seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
