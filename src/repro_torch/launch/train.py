"""Training driver: state, checkpoint/restart loop (see
``repro.launch.train``).

Usage (a CPU-sized config of the same family; without ``--device`` it
trains on the card):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu

The data-parallel degree is the size of the initialized default process
group (one rank per card; launch with ``torchrun`` or
``torch.multiprocessing.spawn``), 1 without one: at more than one rank each
step is :func:`~repro_torch.train.step.make_ddp_step` on the rank's rows of
the global batch.

``--data D --model M`` with ``M > 1`` needs a process group of D·M ranks
and trains over ``launch.mesh.model_grid(D, M)`` (the reference's
``build_sharded_state`` and one jitted step with parameter and state
shardings, ``repro/launch/train.py:39-54``, ``:84-88``): each rank draws
the one-rank model's weights and keeps its blocks, takes its data
shard's rows of each global batch (the reference's ``P(("data",))``), and
runs the sharded step with ZeRO-1 state (``train/zero.py``).  On the CPU:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
        --data 2 --model 2 --steps 6 --batch 4 --seq 32 --device cpu

(under ``torchrun``, when its caller has made no process group, ``main``
joins a gloo one over torchrun's rendezvous; a caller that wants another
backend, NCCL across cards, initializes the group before calling
``main``).  The rules are ``launch.specs.rules_for``'s for the config
(train): a giant model's weights are 2-D, each one's d_model dim split
over "data" too, whenever ``is_giant(cfg, M)`` holds, and then the
sharded step runs also at ``--model 1`` (never the replicating DDP step).

Checkpoints are a one-rank run's tree at any grid: rank 0 writes every
leaf whole, gathered leaf by leaf (``train/zero.full_tree``), and a rank
loads its pieces of each (``train/zero.block_sinks``), so ``--resume``
works at any (D, M) and a one-rank run loads a sharded run's checkpoint.

Fault tolerance: resumes from the newest complete checkpoint; the
``ElasticCoordinator`` gets a heartbeat per step.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from ..checkpoint.store import (config_hash, gather_leaves, latest_step,
                                load_checkpoint, read_manifest,
                                save_checkpoint)
from ..configs import base as cfgbase
from ..data.pipeline import Prefetcher, SyntheticLM
from ..device import resolve
from ..launch.elastic import ElasticCoordinator
from ..launch.mesh import graph_group, model_grid
from ..launch.specs import is_giant, rules_for
from ..train import zero
from ..train.optimizer import OptHyper, stack_key
from ..train.step import init_train_state, make_ddp_step, make_train_step

__all__ = ["main", "train_state_tree", "save_train_state",
           "load_train_state"]

def _world() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _sharded(model) -> bool:
    return model.grid is not None and model.grid.size > 1


def train_state_tree(model, opt_state) -> dict:
    """The checkpointed tree: ``{"params": {name: tensor}, "opt": state}``;
    over ranks, each leaf a function that gathers it whole (every rank
    calls them: :func:`save_train_state`)."""
    if _sharded(model):
        return zero.full_tree(model, opt_state)
    return {"params": {k: p.detach() for k, p in model.named_parameters()},
            "opt": opt_state}


def save_train_state(ckpt_dir: str, step: int, model, opt_state,
                     cfg) -> None:
    """Checkpoint at ``step``: the one-rank tree, written by rank 0 of the
    grid while the other ranks gather with it (collective over ranks)."""
    tree = train_state_tree(model, opt_state)
    grid = model.grid
    if _sharded(model) and (grid.data.rank or grid.model.rank):
        gather_leaves(tree)
        return
    save_checkpoint(ckpt_dir, step, tree, meta={"config": config_hash(cfg)})


@torch.no_grad()
def load_train_state(ckpt_dir: str, model, opt_state, cfg,
                     step: Optional[int] = None) -> int:
    """Restore ``model``'s parameters and ``opt_state`` in place from the
    newest checkpoint (or ``step``); returns its step.  Over ranks each
    rank keeps its pieces of each leaf.  Raises ``ValueError`` when the
    checkpoint was written for another config, or holds Adafactor state
    per layer (the layout before the state was the stacked
    parameters')."""
    step, info = read_manifest(ckpt_dir, step)
    if info["meta"].get("config") != config_hash(cfg):
        raise ValueError(f"checkpoint config mismatch: step {step} in "
                         f"{ckpt_dir}")
    per_layer = [k for k in info["leaves"] if k.startswith("opt/f/") and
                 stack_key(k.split("/")[2])[1]]
    if per_layer:
        raise ValueError(
            f"step {step} in {ckpt_dir} holds Adafactor state per layer "
            f"({per_layer[0]}, ...): it was written before the optimizer "
            f"factored the reference's stacked layers, and its factors are "
            f"not the stacked parameters' (a norm's (layers, d) factors, "
            f"one update RMS over every layer), so it cannot be loaded")
    like = zero.block_sinks(model, opt_state) if _sharded(model) else \
        train_state_tree(model, opt_state)
    start, _, _ = load_checkpoint(ckpt_dir, like, step, inplace=True)
    return start


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel degree (default: the process "
                         "group's size)")
    ap.add_argument("--model", type=int, default=1, help="model-mesh degree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to train on the CPU")
    args = ap.parse_args(argv)

    own_group = int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
        not torch.distributed.is_initialized()
    if own_group:       # torchrun's rendezvous (env://)
        torch.distributed.init_process_group("gloo")
    try:
        _train(args)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(args) -> None:
    world = _world()
    cfg = cfgbase.get_config(args.arch)
    if args.reduced:
        cfg = cfgbase.reduced(cfg)
    # rules_for's weights are 2-D for a giant model: the grid's step holds
    # them so at any model degree
    grid_step = args.model > 1 or (world > 1 and is_giant(cfg, args.model))
    if grid_step:
        data = args.data or max(world // args.model, 1)
        if data * args.model != world:
            raise ValueError(f"--data {data} --model {args.model} needs "
                             f"{data * args.model} ranks, the process group "
                             f"has {world}")
    elif args.data and args.data != world:
        raise ValueError(f"--data {args.data} but the process group has "
                         f"{world} rank(s): the data-parallel degree is the "
                         f"group's size")
    dev = resolve(args.device)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    hyper = OptHyper(lr=args.lr)
    chunk = min(1024, args.seq)
    rows = (0, 1)
    if grid_step:
        grid = model_grid(data, args.model)
        model, opt_state = init_train_state(
            cfg, gen, device=dev, grid=grid,
            rules=rules_for(cfg, grid, "train"))
        step_fn = make_train_step(cfg, hyper, attn_chunk=chunk)
        rank = grid.data.rank * grid.model.d + grid.model.rank
        rows = (grid.data.rank, grid.data.d)
        if rank == 0:
            two_d = any(hasattr(p, "data_dim") for p in model.parameters())
            print(f"[train] grid data={data} model={args.model}, weights "
                  f"{'2-D' if two_d else '1-D'}")
    elif world > 1:
        model, opt_state = init_train_state(cfg, gen, device=dev)
        group = graph_group(world)
        ddp = make_ddp_step(cfg, group, hyper, attn_chunk=chunk)

        def step_fn(model, opt_state, batch, i):
            model, opt_state, loss, _ = ddp(model, opt_state, batch, i, None)
            return model, opt_state, {"loss": loss}
        rank = group.rank
    else:
        model, opt_state = init_train_state(cfg, gen, device=dev)
        step_fn = make_train_step(cfg, hyper, attn_chunk=chunk)
        rank = 0

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = load_train_state(args.ckpt_dir, model, opt_state, cfg)
        print(f"[train] resumed from step {start}")

    coord = ElasticCoordinator(n_workers=world, hosts_per_tp_group=1)
    src = SyntheticLM(cfg.vocab_size, args.batch, args.seq, args.seed)
    pre = Prefetcher(src, depth=2, device=dev, start_step=start, rows=rows)
    try:
        t_last = time.perf_counter()
        for i in range(start, args.steps):
            step_idx, batch = pre.next()
            assert step_idx == i
            t_step = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, batch, i)
            if (i + 1) % 5 == 0 or i == args.steps - 1:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                if rank == 0:
                    print(f"[train] step {i+1:5d} loss {loss:.4f} "
                          f"({dt:.2f}s/5)")
            coord.heartbeat(rank, time.perf_counter() - t_step)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0 and \
                    (rank == 0 or grid_step):
                save_train_state(args.ckpt_dir, i + 1, model, opt_state, cfg)
        if args.ckpt_dir and (rank == 0 or grid_step):
            save_train_state(args.ckpt_dir, args.steps, model, opt_state,
                             cfg)
    finally:
        pre.stop()


if __name__ == "__main__":
    main()
