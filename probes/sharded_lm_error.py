"""Where phase 4f's qwen3-moe logits part from d = 1, and whether the way
the ranks' parts are summed moves them.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 probes/sharded_lm_error.py

qwen3-moe at phase 4c's 6 layers, ``moe_impl="expert_tp"``: the d = 1
yardstick of ``chip_smoke.py``'s phase 4f (one rank, the last prompt
position's prefill logits and 4 teacher-forced decode steps) at capacity
factor 1.25 (phase 4f's) and 16 (no drops), then two gloo ranks sharing
the card, each variant's largest |logit difference| per position:

* ``cast``: the port's sums (each rank's part cast to bf16, then added in
  float32 in rank order and cast);
* ``f32_moe``: the MoE's float32 combine parts summed before the cast;
* ``f32_wo``: attention's ``wo`` products as float32 partials
  (``torch.mm(..., out_dtype=torch.float32)``), summed before the cast.

Prints the card's name and power limit and one JSON line per variant.
"""
import dataclasses
import datetime
import json
import multiprocessing as mp
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import numpy as np                                        # noqa: E402
import torch                                              # noqa: E402

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402

ARCH, LAYERS = cs.SHARDED_LM_MODELS[1][:2]
VARIANTS = [("cast", 1.25), ("cast", 16.0), ("f32_moe", 1.25),
            ("f32_wo", 1.25), ("f32_wo", 16.0)]
WORK = Path("build/sharded_lm_error").resolve()


def rank_main(rank, d, prompts, teacher):
    import torch.distributed as dist
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{WORK / 'store'}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=300))
    try:
        grid = model_grid(1, d)
        cfg = cs.sharded_lm_config(ARCH, LAYERS, "expert_tp")
        model = Transformer.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), device="cuda",
            group=grid)
        toks = torch.from_numpy(cs.left_padded(prompts)).cuda()
        real_tp, real_out = moe.moe_apply_expert_tp, attn._out

        def f32_moe(p, x, c):
            sh = p.shard
            b, s, dd = x.shape
            t, k = b * s, c.experts_per_token
            r = moe.route(p, x, c, moe.tp_capacity(t, c))
            ye = moe._expert_outputs(p, x.reshape(t, dd), r, sh.lo)
            part = moe._combine(ye.float(), r, sh.lo, t, k)   # float32
            out = sh.grid.model.psum(part).to(x.dtype)
            return out.reshape(b, s, dd), sh.grid.model.pmean(r.aux)

        def f32_wo(p, o, dt):
            b, s = o.shape[:2]
            y = torch.mm(o.reshape(b * s, -1).to(dt), p.wo.w.to(dt),
                         out_dtype=torch.float32)
            return p.group.psum(y).to(dt).reshape(b, s, -1)

        for name, cf in VARIANTS:
            moe.moe_apply_expert_tp = f32_moe if name == "f32_moe" \
                else real_tp
            attn._out = f32_wo if name == "f32_wo" else real_out
            model.cfg = dataclasses.replace(cfg, capacity_factor=cf)
            logits, _ = cs.yardstick(model, toks, teacher.cuda(), 2080,
                                     grid.model)
            torch.save(logits, WORK / f"rank{rank}_{name}_{cf}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    from repro_torch.launch.mesh import model_grid
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, ServeConfig
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        cfg = cs.sharded_lm_config(ARCH, LAYERS, "expert_tp")
        model = Transformer.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), device="cuda",
            group=model_grid(1, 1))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in cs.SERVE_PROMPTS]
        out = Engine(cfg, model, ServeConfig(batch=4, max_seq=2080)
                     ).generate(prompts, cs.SERVE_NEW)
        toks, teacher = cs.yardstick_inputs(prompts, out, "cuda")
        want = {}
        for cf in (1.25, 16.0):
            model.cfg = dataclasses.replace(cfg, capacity_factor=cf)
            want[cf] = cs.yardstick(model, toks, teacher, 2080)[0]
        del model
        torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, 2, prompts, teacher.cpu()))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        codes = [p.exitcode for p in procs]
        cs.check(codes == [0, 0], f"the ranks exited with {codes}")
        for name, cf in VARIANTS:
            got = torch.load(WORK / f"rank0_{name}_{cf}.pt")
            print(json.dumps({
                "variant": name, "capacity_factor": cf,
                "max_abs_logit": float(want[cf].abs().max()),
                "max_abs_diff_per_position": [
                    cs.max_abs(got[:, j], want[cf][:, j])
                    for j in range(got.shape[1])],
                "rank1_same_bits": torch.equal(got, torch.load(
                    WORK / f"rank1_{name}_{cf}.pt"))}), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
