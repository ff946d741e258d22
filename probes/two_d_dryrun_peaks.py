"""The dry run's peak bytes of the giant models with 2-D weights, beside
the same cell with each weight whole over "data" (meta device, no card).

    PYTHONPATH=src python probes/two_d_dryrun_peaks.py [--moe-impl expert_tp]

For grok-1-314b and qwen3-moe-235b-a22b × train_4k and prefill_32k on the
16 × 16 mesh: rank 0's argument bytes and the temporaries' peak
(``launch/dryrun.run_cell``) with ``rules_for``'s 2-D rules and with
``w_embed`` unmapped, and one layer's weights gathered whole (the bytes a
rank holds for layer 0's 2-D leaves, times 16).  The growth of the peak
should be about one layer's gathered weights (autograd keeps none: the
backward gathers again), not the model block's.  One JSON line a cell.
"""
import argparse
import json
import sys

sys.path.insert(0, "src")

from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import counting_grid, make_production_mesh  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--moe-impl", default=None)
    args = ap.parse_args()
    real = specs.rules_for
    mesh = make_production_mesh()
    for arch in ("grok-1-314b", "qwen3-moe-235b-a22b"):
        cfg = get_config(arch)
        model = Transformer(cfg, device="meta", group=counting_grid(mesh),
                            rules=real(cfg, mesh, "train"))
        layer = 16 * sum(p.numel() * p.element_size()
                         for k, p in model.named_parameters()
                         if k.startswith("layers.0.") and
                         hasattr(p, "data_dim"))
        for shape in ("train_4k", "prefill_32k"):
            row = {"arch": arch, "shape": shape, "moe_impl": args.moe_impl,
                   "layer_gathered": layer}
            for name in ("two_d", "whole"):
                def rules_for(c, m, kind, s=None, name=name):
                    rules = real(c, m, kind, s)
                    if name == "whole":
                        rules.mapping["w_embed"] = None
                    return rules
                specs.rules_for = rules_for
                dryrun.specs_mod.rules_for = rules_for
                try:
                    r = dryrun.run_cell(arch, shape, False,
                                        moe_impl=args.moe_impl)
                finally:
                    specs.rules_for = real
                    dryrun.specs_mod.rules_for = real
                row[name] = {"argument_bytes":
                             r["memory"]["argument_bytes"],
                             "temp_bytes": r["memory"]["temp_bytes"],
                             "compile_s": r["compile_s"]}
            row["temp_growth"] = row["two_d"]["temp_bytes"] - \
                row["whole"]["temp_bytes"]
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
