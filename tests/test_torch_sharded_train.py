"""The sharded train step (``train/zero.py`` over ``launch/mesh.model_grid``)
against the reference's unsharded step, on the CPU.

Reduced qwen2.5-3b (AdamW) and qwen3-moe (Adafactor, 4 experts, top 2,
capacity factor E/k: no assignment drops), the reference's ``init_params``
weights (``_torch_oracles.lm_arrays``), three batches of 4 × 16 numpy
tokens.  Grids, in two spawned gloo worlds (``_torch_worlds.run_world``):

* dense at (1, 2), (2, 1), (2, 2) and (1, 4) (each KV head shared by two
  ranks at (1, 4)), and at (1, 2) with ``remat="full"`` and ``"dots"``;
* MoE ``"expert_tp"`` at (1, 2) and (2, 2), ``"sorted"`` at (2, 1).

Each rank takes its data shard's rows.  Held against the reference's
``make_train_step`` on the whole batch (the tolerances of
``tests/test_torch_train.py``): step 0's loss to 1e-5 relative and gradient
norm to 1e-4, three steps' losses to 1e-5; and, as that file holds the
optimizer, every parameter after one sharded update of the reference's
gradients (gathered whole) to 1e-6 of the reference's own clipping and
update of them over its stacked tree (a whole step's parameters differ
from the reference's by up to 6.6e-6 with AdamW at one rank already, an
update of a near-zero gradient turning on its rounding; Adafactor factors
each stacked norm and takes one RMS over every layer, as the port's
``train/optimizer.py`` does).  ``expert_tp`` over two data shards routes
each shard on its own and averages the shards' aux losses (the reference's
``moe_apply_expert_tp`` under a mesh), so its reference is the mean over
the two shards of the reference's loss and gradient, then the reference's
clipping and update.  Also held: every rank holds equal bits in what it
shares (norms, routers, the KV columns of a shared head, and every block
across data replicas); each rank's ZeRO state is its block's data shard;
a checkpoint saved at (2, 2) resumes at (2, 2) and at one rank within 1e-6
of continuing; ``launch/train.py --data 2 --model 2`` runs in a world of
4 and its checkpoint equals a one-rank run's within 1e-5; and
``launch/specs.opt_structs`` gives, for every train cell of both
production meshes, the ZeRO split of each parameter's block.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from _torch_worlds import launch_train_job, run_world, sharded_train_job
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as RT
from repro.train import optimizer as r_opt
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.checkpoint import store
from repro_torch.configs.base import SHAPES, get_config, list_archs, reduced
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import Transformer
from repro_torch.train.optimizer import OptHyper, _factored, stack_groups
from repro_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(2)

B, S, STEPS = 4, 16, 3
DENSE, MOE = "qwen2.5-3b", "qwen3-moe-235b-a22b"
# (tag, arch, moe_impl, remat, grid)
CASES = [(f"dense-{d}x{m}", DENSE, "sorted", "none", (d, m))
         for d, m in [(1, 2), (2, 1), (2, 2), (1, 4)]] + \
    [(f"dense-{r}-1x2", DENSE, "sorted", r, (1, 2))
     for r in ("full", "dots")] + \
    [(f"moe-tp-{d}x{m}", MOE, "expert_tp", "none", (d, m))
     for d, m in [(1, 2), (2, 2)]] + \
    [("moe-sorted-2x1", MOE, "sorted", "none", (2, 1))]
IDS = [c[0] for c in CASES]
CKPT = ("dense-2x2", 2)        # save after 2 steps, then take step 2 again


def _over(arch, impl, remat):
    cfg = reduced(get_config(arch))
    cf = cfg.n_experts / cfg.experts_per_token if cfg.n_experts else 1.25
    return {"capacity_factor": cf, "moe_impl": impl, "remat": remat}


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _clip_update(r_cfg):
    """The reference's clipping and update, jitted: (params, grads,
    state, step) -> (params, state, the gradient norm)."""
    opt = r_opt.get_optimizer(r_cfg.optimizer)

    def f(params, grads, state, i):
        grads, gnorm = r_opt.clip_by_global_norm(grads, 1.0)
        params, state = opt.update(params, grads, state, i, r_opt.OptHyper())
        return params, state, gnorm
    return jax.jit(f)


def _shard_mean(r_cfg):
    """The reference's step where each data shard routes on its own and
    the aux losses average: the mean over the two shards of its loss and
    gradient, then its clipping and update."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, r_cfg, b, chunk=S), has_aux=True))
    update = _clip_update(r_cfg)

    def step(params, state, batch, i):
        halves = [{k: v[h * 2:(h + 1) * 2] for k, v in batch.items()}
                  for h in range(2)]
        outs = [vg(params, h) for h in halves]
        loss = (outs[0][0][0] + outs[1][0][0]) / 2
        grads = jax.tree.map(lambda a, b: (a + b) / 2, outs[0][1],
                             outs[1][1])
        params, state, gnorm = update(params, grads, state, i)
        return params, state, {"loss": loss, "grad_norm": gnorm}
    return step


def _given_update(r_cfg, cfg, arrays, batch):
    """The reference's gradients of the whole batch and its parameters
    after clipping them and one update of its own stacked tree (its
    Adafactor factors a norm's (layers, d) and takes the update's RMS over
    every layer), both under the port's per-layer names."""
    params = jax.tree.map(jnp.asarray, arrays)
    grads = jax.jit(jax.grad(lambda p, b: RT.loss_fn(p, r_cfg, b,
                                                      chunk=S)[0]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    def named(tree):
        return {k: p.detach().numpy().copy() for k, p in
                Transformer.from_arrays(cfg, jax.tree.map(np.asarray, tree),
                                        device="cpu").named_parameters()}
    after, _, _ = _clip_update(r_cfg)(
        params, grads, r_opt.get_optimizer(r_cfg.optimizer).init(params),
        jnp.int32(0))
    return named(grads), named(after)


@pytest.fixture(scope="module")
def ref():
    """Per case: its overrides, arrays and batches; the reference's
    losses and gradient norms over three steps; its gradients of batch 0
    and its parameters after one update with them."""
    out, cache = {}, {}
    for tag, arch, impl, remat, (data, _) in CASES:
        mean = impl == "expert_tp" and data > 1
        key = (arch, mean)      # unsharded, "expert_tp" routes as "sorted"
        over = _over(arch, impl, "none")
        if key not in cache:
            r_cfg = r_reduced(r_get_config(arch), **over)
            arrays = lm_arrays(r_cfg)
            batches = _batches(r_cfg.vocab_size)
            step = _shard_mean(r_cfg) if mean else jax.jit(
                r_make_train_step(r_cfg, r_opt.OptHyper(), attn_chunk=S))
            params = jax.tree.map(jnp.asarray, arrays)
            state = r_opt.get_optimizer(r_cfg.optimizer).init(params)
            metrics = []
            for i, b in enumerate(batches):
                params, state, m = step(
                    params, state, {k: jnp.asarray(v) for k, v in b.items()},
                    jnp.int32(i))
                metrics.append({k: float(m[k]) for k in ("loss",
                                                         "grad_norm")})
            if arch not in cache:
                cache[arch] = _given_update(
                    r_cfg, reduced(get_config(arch), **over), arrays,
                    batches[0])
            cache[key] = (arrays, batches, metrics) + cache[arch]
        arrays, batches, metrics, grads, after = cache[key]
        out[tag] = {"over": dict(arch=arch, **_over(arch, impl, remat)),
                    "arrays": arrays, "batches": batches,
                    "metrics": metrics, "grads": grads, "params_1": after}
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """{tag: [each rank's result]} from one world of 2 and one of 4 ranks;
    the checkpoint directory of ``CKPT``."""
    ck = tmp_path_factory.mktemp("ckpt")
    out = {}
    for size in (2, 4):
        cases = [(tag, d, m, ref[tag]["over"], ref[tag]["arrays"],
                  ref[tag]["batches"], ref[tag]["grads"])
                 for tag, _, _, _, (d, m) in CASES if d * m == size]
        res = run_world(sharded_train_job, size,
                        tmp_path_factory.mktemp(f"train{size}"), cases,
                        (CKPT[0], str(ck), CKPT[1]) if size == 4 else None)
        for tag, *_ in cases:
            out[tag] = [r[tag] for r in res]
    return out, str(ck)


def _case(tag):
    return next(c for c in CASES if c[0] == tag)


@pytest.mark.parametrize("tag", IDS)
def test_loss_and_grad_norm_match_reference(worlds, ref, tag):
    res, _ = worlds
    want = ref[tag]["metrics"][0]
    for rank, r in enumerate(res[tag]):
        got = r["metrics"][0]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4, err_msg=f"rank {rank}")


@pytest.mark.parametrize("tag", IDS)
def test_params_after_one_update_match_reference(worlds, ref, tag):
    """The sharded update (the gradient reductions, clipping, ZeRO-1
    AdamW or Adafactor, the all-gather) of the reference's gradients,
    gathered whole, against the reference's clipping and update of them
    (``tests/test_torch_train.py``'s optimizer tolerance)."""
    res, _ = worlds
    want = ref[tag]["params_1"]
    got = res[tag][0]["params_1"]          # gathered whole: every rank's
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    for r in res[tag][1:]:
        assert all(np.array_equal(r["params_1"][k], got[k]) for k in got)


@pytest.mark.parametrize("tag", IDS)
def test_three_steps_match_reference(worlds, ref, tag):
    res, _ = worlds
    want = [m["loss"] for m in ref[tag]["metrics"]]
    for r in res[tag]:
        got = [m["loss"] for m in r["metrics"]]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert all(np.isfinite(m["grad_norm"]) for m in r["metrics"])


@pytest.mark.parametrize("tag", IDS)
def test_ranks_hold_equal_bits_in_what_they_share(worlds, tag):
    """After three steps: norms and routers on every rank, a KV leaf on
    the ranks that hold the same heads, every such block across data
    replicas; at (1, 4) each KV head is held by two ranks."""
    res, _ = worlds
    ranks = res[tag]
    m = _case(tag)[4][1]
    checked = 0
    for k in ranks[0]["shared"]:
        for a in ranks:
            for b in ranks:
                ma, mb = a["coords"]["model"][0], b["coords"]["model"][0]
                same_block = a["holders"][k] == b["holders"][k] or ma == mb
                if same_block:
                    assert a["shared"][k].tobytes() == \
                        b["shared"][k].tobytes(), (k, a["coords"],
                                                   b["coords"])
                    checked += 1
    assert checked
    if m == 4:
        kv = [k for k in ranks[0]["holders"] if ".attn.wk.w" in k]
        assert kv and all(len(ranks[0]["holders"][k]) == 2 for k in kv)
    if _case(tag)[1] == MOE and m > 1:
        assert any(k.endswith("router.w") for k in ranks[0]["shared"])


@pytest.mark.parametrize("tag", [t for t in IDS if _case(t)[4][0] > 1])
def test_zero_state_is_the_blocks_data_shard(worlds, tag):
    """Each state leaf is its parameter's ZeRO block (AdamW's m and v) or
    the factors of its stacked group's blocks (Adafactor: the layers'
    ZeRO blocks on a leading stack axis); a block split over "data" holds
    half of its model block's elements."""
    res, _ = worlds
    for r in res[tag]:
        split = 0
        groups = stack_groups(r["block_shapes"])
        for path, shape in r["state_shapes"].items():
            if path[0] == "f":
                stack, members = groups[path[1]]
                block = stack + r["block_shapes"][members[0][1]]
            else:
                block = r["block_shapes"][path[1]]
            want = {"vr": block[:-1], "vc": block[:-2] + block[-1:]}.get(
                path[-1], block)
            assert shape == want, (path, shape, want)
        for k, block in r["block_shapes"].items():
            held = r["model_shapes"][k]
            if block != held:
                assert 2 * math.prod(block) == math.prod(held), k
                split += 1
            else:
                assert len(held) == 1, k   # only a vector may stay whole
        assert split


def test_checkpoint_resumes_at_one_rank_and_at_2x2(worlds, ref):
    """Saved at (2, 2) after two steps (rank 0 writes the one-rank tree);
    step 2 from it at (2, 2) and at one rank gives the loss of continuing
    within 1e-6."""
    res, ck = worlds
    tag, at = CKPT
    cont = res[tag][0]["metrics"][at]["loss"]
    for r in res[tag]:
        assert abs(r["resumed"]["loss"] - cont) <= 1e-6, r["resumed"]
    cfg = reduced(get_config(DENSE), **{k: v for k, v in
                                        ref[tag]["over"].items()
                                        if k != "arch"})
    model, state = init_train_state(cfg, torch.Generator().manual_seed(1),
                                    "cpu")
    assert launch_train.load_train_state(ck, model, state, cfg) == at
    step = make_train_step(cfg, OptHyper(), attn_chunk=S)
    b = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in ref[tag]["batches"][at].items()}
    _, _, m = step(model, state, b, at)
    assert abs(float(m["loss"]) - cont) <= 1e-6


def test_launch_train_data2_model2_runs_in_a_world_of_4(tmp_path):
    """``--data 2 --model 2`` trains over the grid and checkpoints the
    one-rank tree, equal within 1e-5 to a one-rank run's."""
    common = ["--reduced", "--device", "cpu", "--steps", "4", "--batch",
              "4", "--seq", "16", "--ckpt-every", "2"]
    ck4 = str(tmp_path / "ck4")
    outs = run_world(launch_train_job, 4, tmp_path / "w4",
                     common + ["--data", "2", "--model", "2", "--ckpt-dir",
                               ck4])
    assert "[train] step     4" in outs[0]
    assert not any(outs[1:])               # rank 0 prints
    assert store.latest_step(ck4) == 4
    ck1 = str(tmp_path / "ck1")
    launch_train.main(common + ["--ckpt-dir", ck1])
    with np.load(f"{ck1}/step_00000004/shard_0.npz") as one, \
            np.load(f"{ck4}/step_00000004/shard_0.npz") as four:
        assert sorted(one.files) == sorted(four.files)
        for k in one.files:
            np.testing.assert_allclose(four[k], one[k], atol=1e-5, rtol=0,
                                       err_msg=k)


def _zero_split(block, spec, dsize):
    """The reference's ZeRO rule on a block: the first dim the spec leaves
    unsplit that divides by the data size; none where the spec already
    splits a dim over "data" (``two_d_weights``)."""
    if any("data" in (ax if isinstance(ax, tuple) else (ax,))
           for ax in spec):
        return block
    for i, (n, ax) in enumerate(zip(block, spec)):
        if ax is None and n % dsize == 0 and n >= dsize:
            return block[:i] + (n // dsize,) + block[i + 1:]
    return block


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if a != "ringo-graph"])
def test_opt_structs_are_the_zero_split_of_each_block(arch, multi_pod):
    """rank 0's optimizer state of every parameter is the ZeRO split of
    the block it holds (not the spec's block of the whole state: for
    qwen2.5-3b's ``wk`` over 16 ranks, (128, 128), not (128, 16)); an
    Adafactor state is per stacked group, the factors of its layers'
    ZeRO blocks stacked, of the whole stacked parameter's factoring, and
    its specs are the reference's over that stacked state."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    dsize = math.prod(n for ax, n in mesh.shape.items() if ax != "model")
    _, structs, spec_tree = specs.input_specs(cfg, SHAPES["train_4k"], mesh)
    params, state = structs[0], structs[1]
    full = {k: tuple(p.shape) for k, p in
            Transformer(cfg, device="meta").named_parameters()}
    for k, p in params.items():
        if cfg.optimizer != "adamw":
            break
        z = _zero_split(tuple(p.shape), spec_tree[0][k], dsize)
        assert tuple(state["m"][k].shape) == z, (k, z)
        assert tuple(state["v"][k].shape) == z, (k, z)
    if cfg.optimizer == "adafactor":
        groups = stack_groups(params)
        assert sorted(state["f"]) == sorted(groups)
        assert sorted(spec_tree[1]["f"]) == sorted(groups)
        for key, (stack, members) in groups.items():
            k = members[0][1]
            z = stack + _zero_split(tuple(params[k].shape),
                                    spec_tree[0][k], dsize)
            if _factored(stack + full[k]):
                assert tuple(state["f"][key]["vr"].shape) == z[:-1], key
                assert tuple(state["f"][key]["vc"].shape) == \
                    z[:-2] + z[-1:], key
            else:
                assert tuple(state["f"][key]["v"].shape) == z, key
            for leaf, t in state["f"][key].items():
                assert len(spec_tree[1]["f"][key][leaf]) == t.dim(), key
    if arch == DENSE and not multi_pod:
        assert tuple(state["m"]["layers.0.attn.wk.w"].shape) == (128, 128)
        assert spec_tree[1]["m"]["layers.0.attn.wk.w"] == ("data", "model")
