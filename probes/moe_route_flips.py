"""How often reduced qwen3-moe's routing flips over two model ranks, in
the reference and in the port, each against its own one-rank run.

Run from the root of a checkout, on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python probes/moe_route_flips.py \
        [--seeds 6] [--batch 8] [--seq 128] [--layers 4] [--cf 1.25]

Both packages run ``reduced(qwen3-moe-235b-a22b)`` with ``layers``
layers, bf16 parameters and compute and ``moe_impl="expert_tp"``, on the
same weights (the reference's ``init_params(PRNGKey(seed))``, loaded into
the port by ``Transformer.from_arrays``) and the same seeded tokens, one
full-sequence ``forward`` per seed:

* the reference in a subprocess that sets ``XLA_FLAGS`` before jax loads:
  unsharded (no mesh: ``moe_apply_sorted``), then jitted on a (1, 2) host
  mesh with its parameters placed by ``param_specs`` (``expert_tp`` in a
  ``shard_map``); the routing is read from ``jax.lax.top_k`` through a
  host callback (model rank 0's);
* the port unsharded in this process, then on a (1, 2) ``model_grid`` in
  a two-rank gloo world; the routing is read from ``models.moe.route``
  (rank 0's).

A (token, layer) routing flips when its set of experts differs from the
same package's one-rank run.  Prints each package's flips per layer, its
rate and standard error, the difference of the rates in standard errors
of the difference, and one JSON line.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen3-moe-235b-a22b"

REF = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import get_config, reduced
    from repro.launch.sharding import param_specs, rules_ctx
    from repro.launch.specs import rules_for
    from repro.models import transformer as T

    with open(sys.argv[1], "rb") as f:
        over, seeds, batch, seq = pickle.load(f)
    cfg = reduced(get_config("qwen3-moe-235b-a22b"), **over)
    seen, on_mesh = [], [False]
    top_k = jax.lax.top_k

    def spy(x, k):
        vals, idx = top_k(x, k)
        if on_mesh[0]:
            rank = jax.lax.axis_index("model")
            jax.debug.callback(
                lambda i, r: seen.append(np.asarray(i)) if int(r) == 0
                else None, idx, rank)
        else:
            jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx)
        return vals, idx

    jax.lax.top_k = spy
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                             ("data", "model"))
    rules = rules_for(cfg, mesh, "train")
    fwd = jax.jit(lambda p, t: T.forward(p, cfg, {"tokens": t})[0])
    out = []
    for seed in seeds:
        params = T.init_params(cfg, jax.random.PRNGKey(seed))
        tokens = jnp.asarray(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, seq)), jnp.int32)
        seen.clear()
        on_mesh[0] = False
        fwd(params, tokens).block_until_ready()
        jax.effects_barrier()
        route1 = list(seen)
        seen.clear()
        on_mesh[0] = True
        specs = param_specs(params, rules)
        placed = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, specs)
        with mesh, rules_ctx(rules):
            jax.jit(lambda p, t: T.forward(p, cfg, {"tokens": t})[0])(
                placed, tokens).block_until_ready()
        jax.effects_barrier()
        route2 = list(seen)
        arrays = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                              params)
        out.append(dict(seed=seed, arrays=arrays, tokens=np.asarray(tokens),
                        route1=route1, route2=route2))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')


def reference(over, seeds, batch, seq, work: Path):
    """The reference's per-seed arrays, tokens and routings."""
    with open(work / "ref_in.pkl", "wb") as f:
        pickle.dump((over, seeds, batch, seq), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", REF, str(work / "ref_in.pkl"),
         str(work / "ref_out.pkl")], capture_output=True, text=True,
        timeout=1800, env=env, cwd=ROOT)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    with open(work / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


def _config(over):
    from repro_torch.configs.base import get_config, reduced
    return reduced(get_config(ARCH), **over)


def port_routes(over, arrays, tokens, grid=None):
    """The port's routing of one forward (a (T, k) array a layer)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer
    seen, route = [], moe.route

    def spy(*args, **kwargs):
        r = route(*args, **kwargs)
        seen.append(r.gate_idx.numpy().copy())
        return r

    moe.route = spy
    try:
        m = Transformer.from_arrays(_config(over), arrays, device="cpu",
                                    group=grid)
        m({"tokens": torch.from_numpy(tokens)})
    finally:
        moe.route = route
    return seen


def _rank(rank, d, work, over, cases):
    import torch.distributed as dist
    from repro_torch.launch.mesh import model_grid
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=600))
    try:
        grid = model_grid(1, d)
        out = [port_routes(over, arrays, tokens, grid)
               for arrays, tokens in cases]
        if rank == 0:
            with open(f"{work}/port2.pkl", "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def port_two_ranks(over, cases, work: Path):
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(2, str(work), over, cases), nprocs=2, join=True)
    with open(work / "port2.pkl", "rb") as f:
        return pickle.load(f)


def flips(one, two):
    """Per layer: (routings whose expert set differs, routings)."""
    if len(one) != len(two):
        raise AssertionError(f"{len(one)} layers at d = 1, {len(two)} at 2")
    out = []
    for a, b in zip(one, two):
        a, b = np.sort(a, axis=-1), np.sort(b, axis=-1)
        out.append((int((a != b).any(-1).sum()), int(a.shape[0])))
    return out


def rate(per_seed):
    n = sum(c for layers in per_seed for _, c in layers)
    f = sum(x for layers in per_seed for x, _ in layers)
    p = f / n
    return f, n, p, (p * (1 - p) / n) ** 0.5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--cf", type=float, default=1.25)
    args = ap.parse_args(argv)
    over = dict(n_layers=args.layers, param_dtype="bfloat16",
                compute_dtype="bfloat16", moe_impl="expert_tp",
                capacity_factor=args.cf)
    seeds = list(range(args.seeds))
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        ref = reference(over, seeds, args.batch, args.seq, work)
        one = [port_routes(over, r["arrays"], r["tokens"]) for r in ref]
        two = port_two_ranks(over, [(r["arrays"], r["tokens"]) for r in ref],
                             work)
    ref_f = [flips(r["route1"], r["route2"]) for r in ref]
    port_f = [flips(o, t) for o, t in zip(one, two)]
    # the two packages' d = 1 routings on the same weights and tokens
    same1 = [flips(r["route1"], o) for r, o in zip(ref, one)]
    res = {}
    for name, per in (("reference", ref_f), ("port", port_f),
                      ("d1_ref_vs_port", same1)):
        f, n, p, se = rate(per)
        by_layer = [sum(s[i][0] for s in per) for i in range(args.layers)]
        res[name] = dict(flips=f, routings=n, rate=p, se=se,
                         by_layer=by_layer)
        print(f"{name:15s} {f:6d} of {n:6d} flipped ({p:.4%} ± {se:.4%}); "
              f"by layer {by_layer}")
    a, b = res["reference"], res["port"]
    z = (b["rate"] - a["rate"]) / max((a["se"] ** 2 + b["se"] ** 2) ** 0.5,
                                      1e-12)
    res["z_port_minus_reference"] = z
    res["config"] = dict(over, seeds=args.seeds, batch=args.batch,
                         seq=args.seq)
    print(f"port − reference = {b['rate'] - a['rate']:+.4%}, {z:+.2f} "
          f"standard errors of the difference")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
