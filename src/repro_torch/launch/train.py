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
the global batch.  Model parallelism (``--model > 1``) is not ported yet.

Fault tolerance: resumes from the newest complete checkpoint; the
``ElasticCoordinator`` gets a heartbeat per step.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint.store import (config_hash, latest_step, load_checkpoint,
                                read_manifest, save_checkpoint)
from ..configs import base as cfgbase
from ..data.pipeline import Prefetcher, SyntheticLM
from ..device import resolve
from ..launch.elastic import ElasticCoordinator
from ..launch.mesh import graph_group
from ..train.optimizer import OptHyper
from ..train.step import init_train_state, make_ddp_step, make_train_step

__all__ = ["main", "train_state_tree", "load_train_state"]

_SHARDING = ("model parallelism (--model > 1) is not ported yet: ROADMAP.md "
             "Queue 1 item 15 (launch/sharding)")


def _world() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def train_state_tree(model, opt_state) -> dict:
    """The checkpointed tree: ``{"params": {name: tensor}, "opt": state}``."""
    return {"params": {k: p.detach() for k, p in model.named_parameters()},
            "opt": opt_state}


@torch.no_grad()
def load_train_state(ckpt_dir: str, model, opt_state, cfg,
                     step: Optional[int] = None) -> int:
    """Restore ``model``'s parameters and ``opt_state`` in place from the
    newest checkpoint (or ``step``); returns its step.  Raises
    ``ValueError`` when the checkpoint was written for another config."""
    step, info = read_manifest(ckpt_dir, step)
    if info["meta"].get("config") != config_hash(cfg):
        raise ValueError(f"checkpoint config mismatch: step {step} in "
                         f"{ckpt_dir}")
    start, _, _ = load_checkpoint(ckpt_dir, train_state_tree(model, opt_state),
                                  step, inplace=True)
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

    if args.model > 1:
        raise ValueError(_SHARDING)
    world = _world()
    if args.data and args.data != world:
        raise ValueError(f"--data {args.data} but the process group has "
                         f"{world} rank(s): the data-parallel degree is the "
                         f"group's size")
    dev = resolve(args.device)
    cfg = cfgbase.get_config(args.arch)
    if args.reduced:
        cfg = cfgbase.reduced(cfg)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model, opt_state = init_train_state(cfg, gen, device=dev)
    hyper = OptHyper(lr=args.lr)
    chunk = min(1024, args.seq)
    if world > 1:
        group = graph_group(world)
        ddp = make_ddp_step(cfg, group, hyper, attn_chunk=chunk)

        def step_fn(model, opt_state, batch, i):
            model, opt_state, loss, _ = ddp(model, opt_state, batch, i, None)
            return model, opt_state, {"loss": loss}
        rank = group.rank
    else:
        step_fn = make_train_step(cfg, hyper, attn_chunk=chunk)
        rank = 0

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = load_train_state(args.ckpt_dir, model, opt_state, cfg)
        print(f"[train] resumed from step {start}")

    coord = ElasticCoordinator(n_workers=world, hosts_per_tp_group=1)
    src = SyntheticLM(cfg.vocab_size, args.batch, args.seq, args.seed)
    pre = Prefetcher(src, depth=2, device=dev, start_step=start)
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
            if args.ckpt_dir and rank == 0 and (i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, i + 1,
                                train_state_tree(model, opt_state),
                                meta={"config": config_hash(cfg)})
        if args.ckpt_dir and rank == 0:
            save_checkpoint(args.ckpt_dir, args.steps,
                            train_state_tree(model, opt_state),
                            meta={"config": config_hash(cfg)})
    finally:
        pre.stop()


if __name__ == "__main__":
    main()
