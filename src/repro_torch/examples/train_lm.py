"""Train a dense LM on a graph-derived corpus, with checkpointing and
restart (the port's counterpart of ``examples/train_lm.py``).

The corpus is DeepWalk-style random walks over an R-MAT graph built by
the graph engine: the paper's tables -> graph -> results loop feeding the
LM.  The model is the qwen2.5-3b family: a reduced config by default, a
~100M-parameter one with ``--full``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full --steps 300
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..checkpoint.store import config_hash, latest_step, save_checkpoint
from ..configs.base import get_config, reduced
from ..core.graph import Graph
from ..data.graph_corpus import RandomWalkCorpus
from ..data.rmat import rmat_edges
from ..device import resolve
from ..launch.train import load_train_state, train_state_tree
from ..train.optimizer import OptHyper
from ..train.step import init_train_state, make_train_step


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="~100M params (slow on the CPU)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to train on the CPU")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # graph-derived corpus: random walks over an R-MAT graph
    s, d = rmat_edges(scale=12, edge_factor=8, seed=7)
    keep = s != d
    g = Graph.from_edges(s[keep], d[keep], dedupe=True, device=dev)
    print(f"[corpus] walking a graph of {g.n_nodes} nodes, "
          f"{g.n_edges} edges")
    vocab = g.n_nodes

    base = get_config("qwen2.5-3b")
    if args.full:
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_ff=2048, vocab_size=vocab, head_dim=64, remat="none",
            param_dtype="float32", compute_dtype="float32")
    else:
        cfg = reduced(base, vocab_size=vocab)
    print(f"[model] {cfg.name}-family, ~{cfg.param_count()/1e6:.1f}M params")

    corpus = RandomWalkCorpus(g, batch=args.batch, seq_len=args.seq, seed=0)
    model, opt_state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step_fn = make_train_step(cfg, OptHyper(lr=1e-3), attn_chunk=args.seq)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_lm")
    start = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        start = load_train_state(ckpt_dir, model, opt_state, cfg)
        print(f"[ckpt] resumed from step {start}")

    metrics = {}
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in corpus.batch_at(i).items()}
        model, opt_state, metrics = step_fn(model, opt_state, batch, i)
        if (i + 1) % 10 == 0 or i == start:
            print(f"[train] step {i+1:4d}  loss {float(metrics['loss']):.4f}"
                  f"  |grad| {float(metrics['grad_norm']):.3f}")
        if (i + 1) % 50 == 0:
            save_checkpoint(ckpt_dir, i + 1,
                            train_state_tree(model, opt_state),
                            meta={"config": config_hash(cfg)})
            print(f"[ckpt] saved step {i+1} -> {ckpt_dir}")
    if metrics and not bool(torch.isfinite(metrics["loss"])):
        raise RuntimeError("the loss is not finite")
    print("[done] final loss should be well below ln(vocab) =",
          f"{np.log(vocab):.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
