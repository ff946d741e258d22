"""Multi-pod dry run: every (architecture × input shape × mesh) cell counted
on the meta device (counterpart of ``repro/launch/dryrun.py``).

For each cell, rank 0 of the production mesh:

    rules, structs = launch.specs.input_specs(cfg, shape, mesh)  # meta
    model  = Transformer(cfg, device="meta", group=counting_grid(mesh))
    with CostCounter(ledger):  step_fn(model, *inputs)

The reference lowers and compiles one SPMD program over 512 host devices;
the port runs rank 0's step on meta tensors (shapes, no memory) over
counting groups that describe the mesh and move nothing
(``launch/mesh.counting_grid``), and counts flops, bytes and collectives
as it goes (``launch/hlo_cost.py``).  Meshes: single-pod 16×16
("data", "model") and two-pod 2×16×16 ("pod", "data", "model"), pod ×
data folded into the grid's data axis.  Kinds per shape: train_4k ->
train_step (the sharded step of ``train/zero.py``: forward, backward with
the recompute of ``remat="full"``, the gradients' reduce-scatter over
"data", ZeRO-1 AdamW or Adafactor, the all-gather of the updated blocks;
its arguments the parameters' blocks, their ZeRO state blocks and the
batch), prefill_32k -> prefill, decode_32k / long_500k -> serve (decode)
step.

A cell's result keeps the reference's keys, with these changes: no
``xla_flops_per_device`` / ``xla_bytes_per_device`` (there is no
compiled executable to ask), and ``wire_bytes_per_device`` (by
collective kind, the bytes the port's collectives make rank 0 receive;
``collective_bytes_per_device`` is the reference's output-bytes
accounting).  The reference's ``options`` key is gone too:
``--attn-chunk`` and ``--no-triangle-skip`` are kept for its command
line, but the port's K4 has fixed tiles and no triangle skip, so both
take their defaults only and refuse any other value.  ``memory`` holds the meta inputs' bytes
(``argument_bytes``, parameters included), the step's outputs'
(``output_bytes``), the most bytes its temporaries held at once
(``temp_bytes``) and their sum with the arguments (``peak_bytes``, an
estimate from the live tensors: no allocator runs).  ``compile_s`` is the
wall time of the count.  The decode cells' cache is the port's
(``launch/specs.py``: a rank's KV heads and the whole sequence), not the
reference's ``kv_seq`` split.

The giant models (grok-1-314b, qwen3-moe-235b-a22b) hold their weights
2-D, each weight's d_model dim split over "data" as the reference's
``rules_for`` decides (``two_d_weights``): rank 0 holds its block of both
axes (``argument_bytes``), gathers each layer's weights over the 16 data
ranks of its pod where they are used, in the forward, the recompute and
the backward (the ``all-gather`` bytes), and reduce-scatters their
gradients back (``reduce-scatter``), on two pods then sums them over
"pod" (``launch/mesh.ModelGrid``).

Attention's heads stay whole over the 16 model ranks: where they do not
split evenly (qwen1.5-4b's 20, whisper-small's 12, xlstm-350m's 4 mLSTM
heads) rank 0 holds the most (2, 1 and 1 heads), so its counts are the
largest rank's (``models/attention.head_range``).  The ssm and hybrid
families (xlstm-350m, jamba-1.5-large-398b, whose weights are 2-D too)
run every shape, long_500k included.  Their recurrences are host loops of
the same trip (the sLSTM one token a step: 393,216 steps in a 32k-token
cell; the mLSTM's and the Mamba's chunks): a counted cell runs the first
and last trip and one middle trip counted for all, forward and backward,
as the reference multiplies a ``while`` body by its trip count
(``launch/hlo_cost.loop``), which gives a literal run's counts.  A cell
that raises is recorded as the reference records a failing cell
(``status: "error"`` with the message); none does.

Results are cached as JSON under ``--out`` (default
``build/dryrun_results``), so a sweep resumes; the cells are counted in
as many spawned processes as the machine has cores (at most one a cell;
each cell counted alone in one of them, the results in the same order).
On the CPU, no card needed:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen2.5-3b --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import time
import traceback
from typing import Dict

import torch

from ..configs import base as cfgbase
from ..launch import specs as specs_mod
from ..launch.hlo_cost import CostCounter, tree_bytes
from ..launch.mesh import CollectiveLedger, counting_grid, make_production_mesh
from ..models.transformer import Transformer
from ..train.optimizer import OptHyper
from ..train.step import make_train_step

__all__ = ["step_fn_for", "build_cell", "run_cell", "main"]

META = torch.device("meta")


def step_fn_for(cfg, kind: str, *, attn_chunk: int = 1024,
                skip_upper_triangle: bool = True):
    """The cell's step as ``fn(model, *inputs)``, the inputs those of
    ``launch.specs.input_specs`` after the parameters."""
    if kind == "train":
        return make_train_step(cfg, OptHyper(), attn_chunk=attn_chunk,
                               skip_upper_triangle=skip_upper_triangle)
    if kind == "prefill":
        def prefill_step(model, batch):
            max_seq = batch["tokens"].shape[1] + (cfg.n_patches or 0)
            return model.prefill(batch, max_seq=max_seq, chunk=attn_chunk)
        return prefill_step
    if kind == "decode":
        if cfg.is_encoder_decoder:
            def serve_step(model, cache, tokens, pos, enc_out):
                return model.decode_step(cache, tokens, pos, enc_out=enc_out)
        else:
            def serve_step(model, cache, tokens, pos):
                return model.decode_step(cache, tokens, pos)
        return serve_step
    raise ValueError(kind)


def build_cell(cfg, shape, mesh, kind: str, grid=None):
    """(model, inputs, argument bytes) of rank 0 of the cell on the meta
    device: the model over ``grid`` (default: a counting grid of ``mesh``)
    with the rules of ``input_specs``, its inputs ``input_specs``' meta
    tensors.  The model's parameters are ``input_specs``' parameter
    structs (checked here)."""
    grid = grid or counting_grid(mesh)
    # the model first: a cell it cannot run raises naming its item
    model = Transformer(cfg, device=META, group=grid,
                        rules=specs_mod.rules_for(cfg, mesh, kind, shape))
    _, structs, _ = specs_mod.input_specs(cfg, shape, mesh, kind)
    held = {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()}
    want = {k: (tuple(t.shape), t.dtype) for k, t in structs[0].items()}
    if held != want:
        raise AssertionError(f"{cfg.name}: the model's parameters are not "
                             f"input_specs' structs")
    return model, structs[1:], tree_bytes(structs)


def _inert_options(attn_chunk: int, skip_upper_triangle: bool) -> None:
    """The reference's attention options, which shape its counted chunk
    loop; the port's K4 has fixed tiles and no triangle skip, so a value
    other than the default would change no cell's count."""
    if attn_chunk != 1024 or not skip_upper_triangle:
        raise ValueError(
            "the port's K4 has no chunk loop or triangle skip to steer: "
            "--attn-chunk and --no-triangle-skip change no count, so only "
            "their defaults are taken")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             attn_chunk: int = 1024, skip_upper_triangle: bool = True,
             moe_impl: str = None, overrides: Dict = None) -> Dict:
    _inert_options(attn_chunk, skip_upper_triangle)
    cfg = cfgbase.get_config(arch)
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.family == "graph":
        from .ringo_cells import run_ringo_cell
        return run_ringo_cell(shape_name, multi_pod)
    shape = cfgbase.runnable_shapes(cfg).get(shape_name)
    if shape is None:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention "
                          "(DESIGN.md §Arch-applicability)"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = shape.kind
    t0 = time.time()
    ledger = CollectiveLedger()
    model, inputs, arg_bytes = build_cell(cfg, shape, mesh, kind,
                                          grid=counting_grid(mesh, ledger))
    fn = step_fn_for(cfg, kind)
    with CostCounter(ledger) as c:
        out = fn(model, *inputs)
    t1 = time.time()
    return {
        "arch": arch, "shape": shape_name, "kind": kind,
        "multi_pod": multi_pod, "status": "ok",
        "n_chips": int(mesh.size),
        "compile_s": round(t1 - t0, 1),
        **c.per_device(arg_bytes, out),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="build/dryrun_results")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--no-triangle-skip", action="store_true",
                    help="baseline attention: full rectangular chunk loop")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "sorted", "expert_tp"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    try:
        _inert_options(args.attn_chunk, not args.no_triangle_skip)
    except ValueError as e:
        ap.error(str(e))

    archs = ([args.arch] if args.arch else
             [a for a in cfgbase.list_archs() if a != "ringo-graph"])
    shapes = [args.shape] if args.shape else list(cfgbase.SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.list:
        for a in archs:
            cfg = cfgbase.get_config(a)
            runnable = list(cfgbase.runnable_shapes(cfg)) \
                if a != "ringo-graph" else ["pagerank_twitter",
                                            "pagerank_livejournal"]
            skipped = [s for s in cfgbase.SHAPES if s not in runnable]
            print(f"{a:26s} runs={runnable} skips={skipped}")
        return 0

    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                fname = os.path.join(
                    args.out,
                    f"{args.tag}.{arch}.{shape}.{mesh_name}.json")
                if os.path.exists(fname) and not args.force:
                    print(f"[dryrun] cached {fname}")
                    continue
                todo.append((fname, mesh_name, (
                    arch, shape, mp, args.attn_chunk,
                    not args.no_triangle_skip, args.moe_impl)))
    results = []
    if todo:
        cores = len(os.sched_getaffinity(0))
        with multiprocessing.get_context("spawn").Pool(
                min(cores, len(todo))) as pool:
            results = pool.map(_cell_result, [t[2] for t in todo],
                               chunksize=1)
    failures = 0
    for (fname, mesh_name, (arch, shape, *_)), res in zip(todo, results):
        with open(fname, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        extra = ""
        if status == "ok":
            extra = (f" flops/dev={res['flops_per_device']:.3e}"
                     f" peak={res['memory']['peak_bytes']/2**30:.2f}GiB"
                     f" compile={res['compile_s']}s")
        print(f"[dryrun] {arch} × {shape} × {mesh_name}: {status}{extra}")
        if status == "error":
            print(res["error"])
            failures += 1
    return 1 if failures else 0


def _cell_result(cell) -> Dict:
    """:func:`run_cell` of ``cell`` (its positional arguments), a failure
    recorded as the reference records it (and the sweep goes on)."""
    arch, shape, mp, attn_chunk, skip, moe_impl = cell
    try:
        return run_cell(arch, shape, mp, attn_chunk=attn_chunk,
                        skip_upper_triangle=skip, moe_impl=moe_impl)
    except Exception as e:  # record failures, keep sweeping
        return {"arch": arch, "shape": shape, "multi_pod": mp,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()}


if __name__ == "__main__":
    sys.exit(main())
