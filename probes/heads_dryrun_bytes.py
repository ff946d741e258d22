"""Rank 0's parameter bytes in the dry run's prefill cells with whole heads
(the port's blocks) against the reference's spec split evenly over the
flat head columns (what GSPMD holds), on the meta device, no card.

    PYTHONPATH=src python probes/heads_dryrun_bytes.py

Prints, for each attention arch whose heads or KV heads do not split into
whole heads over the 16 model ranks of the single-pod mesh, rank 0's
bytes of all parameters and of attention's, both ways.
"""
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import sharding, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import param_blocks


def main() -> None:
    mesh = make_production_mesh()
    coords = {ax: (0, n) for ax, n in mesh.shape.items()}
    for arch in ("qwen1.5-4b", "whisper-small", "internvl2-26b"):
        cfg = get_config(arch)
        rules = specs.rules_for(cfg, mesh, "prefill", SHAPES["prefill_32k"])
        held = {"all": [0, 0], "attention": [0, 0]}
        for name, (full, spec, keep) in param_blocks(cfg, coords,
                                                      rules).items():
            port = keep(full).numel() * full.element_size()
            even = sharding.local_block(full, spec, coords).numel() * \
                full.element_size()
            for part in ("all", "attention") if ".attn." in name \
                    else ("all",):
                held[part][0] += port
                held[part][1] += even
        print(f"{arch}: heads {cfg.n_heads}/{cfg.n_kv_heads} over "
              f"{mesh.shape['model']}; rank 0 parameters "
              f"{held['all'][0]:,} B whole heads, {held['all'][1]:,} B "
              f"even ({held['all'][0] / held['all'][1]:.4f}x); attention "
              f"{held['attention'][0]:,} / {held['attention'][1]:,} B")


if __name__ == "__main__":
    main()
