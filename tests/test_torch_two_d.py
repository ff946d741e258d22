"""Weights split over the data axis (``two_d_weights``) against the
reference's unsharded model, on the CPU.

The reference splits every weight's d_model dim over "data" for the giant
models (``repro/launch/specs.py:40``, ``sharding.py:87``); the port holds
the block of both axes on each rank and gathers each weight whole over the
data ranks where it is used, its gradient reduce-scattered back
(``launch/mesh.ModelGrid.weight``).  The reduced configs are not giant, so
the rules are ``default_rules(two_d_weights=True)``.  Cases, in two
spawned gloo worlds (``_torch_worlds.two_d_job``), on the reference's
``init_params`` weights (``_torch_oracles.lm_arrays``) and numpy tokens:

* reduced qwen3-moe (Adafactor, 4 experts, top 2, capacity factor E/k: no
  drops): ``"expert_tp"`` at (2, 1) and (2, 2), ``"sorted"`` at (2, 1);
* reduced grok-1 with ``expert_axis_parallel=False`` at (2, 2), which
  puts ``expert_ff`` on "model";
* reduced qwen2.5-3b (AdamW) at (2, 2), and at (2, 1) with ``remat``
  "full" and "dots" (the gathers run again in the recompute).

Held, on every rank: ``forward``, ``prefill`` and 4 decode steps' logits
within 1e-5 of the largest logit of the reference's; ``Engine.generate``'s
greedy tokens equal to the unsharded port's; each parameter is
its spec's block; step 0's loss to 1e-5 relative and gradient norm to
1e-4, three steps' losses to 1e-5 (``expert_tp`` over two data shards:
the mean over the shards of the reference's, as
``tests/test_torch_sharded_train.py``); three sharded updates of the
reference's gradients equal the reference's own clipping and update of
its stacked tree (``adafactor_update`` factoring each stacked norm, one
RMS over every layer) within 1e-6, the Adafactor state too; every rank
holds equal bits in what it shares; a (2, 2) checkpoint resumes at (2, 2)
and at one rank within 1e-6 of continuing; and with ``remat="none"`` at
(2, 1) the peak live bytes grow by about one layer's gathered weights,
not the model's.  Also the stacked Adafactor at one rank (the fault the
port had: a per-layer optimizer), and the grouping of every family's
leaves against the reference's pytree.

Phase 4i's per-leaf yardstick (``chip_smoke.py``): in a world of 4 ranks
as (2, 2) (``_torch_worlds.two_d_grads_job``), reduced qwen3-moe with the
phase's ``TWO_D_OVER`` records each 2-D block's step-0 gradient and its
routings as the phase's ranks do, held to the average of one rank's
gradients on the two data halves, each routed as its data shard's ranks
routed it (``two_d_halves_grad``, ``moe_choices``), by
``leaf_grad_gaps``; the same run with one leaf's 2-D gradient left
undivided by d passes the phase's norm check and is refused by the
per-leaf one.  Replaying a run's own routings changes no bit of its
gradient.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from _torch_worlds import run_world, two_d_grads_job, two_d_job
from repro.configs.base import get_config as r_get_config
from repro.configs.base import list_archs as r_list_archs
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as RT
from repro.train import optimizer as r_opt
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

B, S, STEPS = 4, 12, 3
TOL = 1e-5
DENSE, MOE, GROK = "qwen2.5-3b", "qwen3-moe-235b-a22b", "grok-1-314b"
# (tag, arch, moe_impl, remat, (data, model), expert axis parallel)
CASES = [("moe-tp-2x1", MOE, "expert_tp", "none", (2, 1), True),
         ("moe-tp-2x2", MOE, "expert_tp", "none", (2, 2), True),
         ("moe-sorted-2x1", MOE, "sorted", "none", (2, 1), True),
         ("grok-ff-2x2", GROK, "sorted", "none", (2, 2), False),
         ("dense-2x2", DENSE, "sorted", "none", (2, 2), True),
         ("dense-full-2x1", DENSE, "sorted", "full", (2, 1), True),
         ("dense-dots-2x1", DENSE, "sorted", "dots", (2, 1), True)]
IDS = [c[0] for c in CASES]
CKPT = ("dense-2x2", 2)        # save after 2 steps, then take step 2 again
# equal lengths in each data shard's pair: the sorted MoE gathers the
# shards' batches, and every data rank runs as many steps
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [2, 4, 6, 8]]
MEMORY_LAYERS = 4


def _case(tag):
    return next(c for c in CASES if c[0] == tag)


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


def _named(cfg, tree):
    """The reference's pytree as the port's {name: numpy} leaves."""
    return {k: p.detach().numpy().copy() for k, p in
            Transformer.from_arrays(cfg, jax.tree.map(np.asarray, tree),
                                    device="cpu").named_parameters()}


def _stacked_state(state, cfg):
    """The reference's optimizer state as ``{(part, key, leaf): numpy}``:
    an Adafactor group's under its stacked path, AdamW's m and v under the
    port's parameter names (elementwise: one per parameter)."""
    out = {}
    if "f" in state:
        for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
            keys = [p.key for p in path]
            out[("f", ".".join(keys[1:-1]), keys[-1])] = np.asarray(leaf)
        return out
    for part in ("m", "v"):
        for k, v in _named(cfg, state[part]).items():
            out[(part, k, None)] = v
    return out


def _reference(r_cfg, cfg, arrays, tokens, batches, mean):
    """The reference's unsharded logits (forward, prefill, 4 decode
    steps), three train steps' metrics (``mean``: the mean over two data
    shards of its loss and gradient, as ``expert_tp`` routes each shard
    alone), its gradients of batch 0, and three clip-and-updates of them
    over its own stacked tree, with the state after the third."""
    params = jax.tree.map(jnp.asarray, arrays)
    logits, _ = RT.forward(params, r_cfg, {"tokens": jnp.asarray(tokens)})
    pre, cache = RT.prefill(params, r_cfg,
                            {"tokens": jnp.asarray(tokens[:, :-4])}, S + 4)
    steps = []
    for i in range(S - 4, S):
        d, cache = RT.decode_step(params, r_cfg, cache,
                                  jnp.asarray(tokens[:, i:i + 1]),
                                  jnp.int32(i))
        steps.append(np.asarray(d)[:, 0])
    o = r_opt.get_optimizer(r_cfg.optimizer)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, r_cfg, b, chunk=S)[0]))

    def clip_update(p, g, st, i):
        g, gnorm = r_opt.clip_by_global_norm(g, 1.0)
        p, st = o.update(p, g, st, i, r_opt.OptHyper())
        return p, st, gnorm
    clip_update = jax.jit(clip_update)

    def loss_grad(p, b):
        if not mean:
            return vg(p, b)
        outs = [vg(p, {k: v[h * 2:(h + 1) * 2] for k, v in b.items()})
                for h in range(2)]
        return ((outs[0][0] + outs[1][0]) / 2,
                jax.tree.map(lambda a, c: (a + c) / 2, outs[0][1],
                             outs[1][1]))
    p, st, metrics = params, o.init(params), []
    for i, b in enumerate(batches):
        loss, g = loss_grad(p, {k: jnp.asarray(v) for k, v in b.items()})
        p, st, gnorm = clip_update(p, g, st, jnp.int32(i))
        metrics.append({"loss": float(loss), "grad_norm": float(gnorm)})
    _, grads = vg(params, {k: jnp.asarray(v) for k, v in batches[0].items()})
    p, st, after = params, o.init(params), []
    for i in range(3):
        p, st, _ = clip_update(p, grads, st, jnp.int32(i))
        after.append(_named(cfg, p))
    return {"forward": np.asarray(logits), "prefill": np.asarray(pre),
            "decode": np.stack(steps, 1), "metrics": metrics,
            "grads": _named(cfg, grads), "after": after,
            "state_3": _stacked_state(st, cfg),
            "generate": Engine(cfg, Transformer.from_arrays(
                cfg, arrays, device="cpu"), ServeConfig(batch=B, max_seq=32),
                device="cpu").generate(PROMPTS, 4)}


@pytest.fixture(scope="module")
def ref():
    out, cache = {}, {}
    rng = np.random.default_rng(0)
    for tag, arch, impl, remat, (data, _), _ in CASES:
        over = _over(arch, impl, remat)
        mean = impl == "expert_tp" and data > 1
        key = (arch, mean)
        if key not in cache:
            r_over = dict(over, remat="none")
            r_cfg = r_reduced(r_get_config(arch), **r_over)
            cfg = reduced(get_config(arch), **r_over)
            arrays = lm_arrays(r_cfg)
            tokens = rng.integers(0, r_cfg.vocab_size, (B, S)).astype(
                np.int32)
            batches = _batches(r_cfg.vocab_size)
            cache[key] = dict(arrays=arrays, tokens=tokens, batches=batches,
                              **_reference(r_cfg, cfg, arrays, tokens,
                                           batches, mean))
        out[tag] = dict(cache[key], over=dict(arch=arch, **over))
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """{tag: [each rank's result]}, the memory peaks of the world of 2,
    and the checkpoint directory of ``CKPT``."""
    ck = tmp_path_factory.mktemp("ckpt")
    r_cfg = r_reduced(r_get_config(DENSE), n_layers=MEMORY_LAYERS)
    memory = ({"arch": DENSE, "n_layers": MEMORY_LAYERS, "remat": "none"},
              lm_arrays(r_cfg), _batches(r_cfg.vocab_size)[0])
    out, peaks = {}, None
    for size in (2, 4):
        cases = [(tag, d, m, ref[tag]["over"], eap, ref[tag]["arrays"],
                  ref[tag]["tokens"], ref[tag]["batches"], ref[tag]["grads"])
                 for tag, _, _, _, (d, m), eap in CASES if d * m == size]
        res = run_world(two_d_job, size, tmp_path_factory.mktemp(f"w{size}"),
                        cases, (CKPT[0], str(ck), CKPT[1]) if size == 4
                        else None, memory if size == 2 else None, PROMPTS)
        for tag, *_ in cases:
            out[tag] = [r["cases"][tag] for r in res]
        if size == 2:
            peaks = [r["memory"] for r in res]
    return out, peaks, str(ck)


@pytest.mark.parametrize("tag", IDS)
def test_two_d_serving_matches_reference(worlds, ref, tag):
    res, _, _ = worlds
    data = _case(tag)[4][0]
    for r in res[tag]:
        di = r["coords"]["data"][0]
        n = B // data
        for what in ("forward", "prefill", "decode"):
            want = ref[tag][what][di * n:(di + 1) * n]
            np.testing.assert_allclose(
                r[what], want, rtol=0, atol=TOL * float(np.abs(want).max()),
                err_msg=f"{what} rank {r['coords']}")


@pytest.mark.parametrize("tag", IDS)
def test_two_d_engine_generates_the_unsharded_tokens(worlds, ref, tag):
    """``Engine.generate`` over the grid: each data shard's greedy tokens
    equal the unsharded port's for its prompts, on each of its ranks."""
    res, _, _ = worlds
    data = _case(tag)[4][0]
    n = len(PROMPTS) // data
    for r in res[tag]:
        di = r["coords"]["data"][0]
        assert r["generate"] == ref[tag]["generate"][di * n:(di + 1) * n]


@pytest.mark.parametrize("tag", IDS)
def test_two_d_blocks_are_the_specs(worlds, tag):
    """Each parameter is its spec's block of both axes; the weights whose
    spec names "data" carry the dim to gather, the norms none."""
    res, _, _ = worlds
    for r in res[tag]:
        split = 0
        for k, (held, want, ddim) in r["blocks"].items():
            assert held == want, k
            if ddim is not None:
                split += 1
            if k.endswith(("ln1.scale", "ln2.scale", "norm_f.scale")):
                assert ddim is None, k
        assert split, "no weight split over data"
        assert r["blocks"]["layers.0.attn.wq.w"][2] == 0


@pytest.mark.parametrize("tag", IDS)
def test_two_d_step_matches_reference(worlds, ref, tag):
    res, _, _ = worlds
    want = ref[tag]["metrics"]
    for r in res[tag]:
        got = r["metrics"]
        np.testing.assert_allclose(got[0]["loss"], want[0]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got[0]["grad_norm"],
                                   want[0]["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose([g["loss"] for g in got],
                                   [w["loss"] for w in want], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("tag", IDS)
def test_two_d_updates_equal_the_references_stacked_update(worlds, ref,
                                                            tag):
    """Three sharded updates of the reference's gradients equal the
    reference's clipping and update of its own stacked tree (Adafactor:
    each stacked norm factored, one RMS over every layer) within 1e-6,
    and so does the optimizer state after them."""
    res, _, _ = worlds
    for i in (1, 3):
        want = ref[tag]["after"][i - 1]
        got = res[tag][0][f"params_{i}"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                       err_msg=f"{k} after {i}")
    state = res[tag][0]["state_3"]
    want = ref[tag]["state_3"]
    assert sorted(state) == sorted(want)
    for k in want:
        np.testing.assert_allclose(state[k], want[k], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want[k]).max()),
                                   err_msg=str(k))
    first = res[tag][0]["params_3"]
    for r in res[tag][1:]:
        assert all(np.array_equal(r["params_3"][k], first[k]) for k in first)


@pytest.mark.parametrize("tag", IDS)
def test_two_d_ranks_hold_equal_bits_in_what_they_share(worlds, tag):
    """After three steps: the norms on every rank, the router and a KV
    block on the ranks holding the same block."""
    res, _, _ = worlds
    ranks = res[tag]
    checked = 0
    for k in ranks[0]["shared"]:
        norm = k.endswith(("scale", "bias")) and "attn" not in k
        for a in ranks:
            for b in ranks:
                same_block = a["coords"]["data"] == b["coords"]["data"] and (
                    a["coords"]["model"] == b["coords"]["model"] or
                    a["holders"][k] == b["holders"][k])
                if norm or same_block:
                    assert a["shared"][k].tobytes() == \
                        b["shared"][k].tobytes(), (k, a["coords"],
                                                   b["coords"])
                    checked += 1
    assert checked


def test_two_d_checkpoint_resumes_at_one_rank_and_at_2x2(worlds, ref):
    """Saved at (2, 2) with 2-D weights after two steps (rank 0 writes the
    one-rank tree); step 2 from it at (2, 2) and at one rank gives the loss
    of continuing within 1e-6."""
    res, _, ck = worlds
    tag, at = CKPT
    cont = res[tag][0]["metrics"][at]["loss"]
    for r in res[tag]:
        assert abs(r["resumed"]["loss"] - cont) <= 1e-6, r["resumed"]
    over = {k: v for k, v in ref[tag]["over"].items() if k != "arch"}
    cfg = reduced(get_config(DENSE), **over)
    model, state = init_train_state(cfg, torch.Generator().manual_seed(1),
                                    "cpu")
    assert launch_train.load_train_state(ck, model, state, cfg) == at
    step = make_train_step(cfg, opt.OptHyper(), attn_chunk=16)
    b = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in ref[tag]["batches"][at].items()}
    _, _, m = step(model, state, b, at)
    assert abs(float(m["loss"]) - cont) <= 1e-6


def test_two_d_peak_memory_holds_one_layer(worlds):
    """``remat="none"`` at (2, 1): the forward's peak live bytes with 2-D
    weights exceed the replicated model's by about one layer's gathered
    weights, not the model's (autograd keeps no gathered weight: the
    backward gathers again); kept for the backward, they grow by every
    layer's."""
    _, peaks, _ = worlds
    cfg = reduced(get_config(DENSE), n_layers=MEMORY_LAYERS)
    layer = sum(p.numel() * 4 for k, p in
                Transformer(cfg, device="meta").named_parameters()
                if k.startswith("layers.0.") and p.dim() == 2)
    table = cfg.vocab_size * cfg.d_model * 4
    for p in peaks:
        grow = p["two_d"][0] - p["replicated"][0]
        kept = p["two_d_kept"][0] - p["replicated"][0]
        assert 0 < grow <= layer + table, (grow, layer, table)
        assert kept >= (MEMORY_LAYERS - 1) * layer, (kept, layer)
        # the backward: its float32 reduced gradients (the replicated
        # model's accumulate in place, uncounted) and a gathered weight
        assert p["two_d"][2] > 0 and p["replicated"][2] == 0, p
        assert p["two_d"][1] <= p["two_d"][2] + p["replicated"][1] + \
            layer + table, p


# ---------------------------------------------------------------------------
# Adafactor over the reference's stacked layers, at one rank
# ---------------------------------------------------------------------------


def test_adafactor_one_rank_equals_the_references_stacked_update():
    """Reduced qwen3-moe at one rank: one update and three of the
    reference's gradients equal the reference's ``adafactor_update`` over
    its stacked tree within 1e-6 (a norm's (layers, d) scale factored,
    each matrix's RMS over every layer), and the state is the reference's,
    keyed by the stacked path.  A per-layer optimizer is 1.2e-4 off."""
    r_cfg = r_reduced(r_get_config(MOE))
    cfg = reduced(get_config(MOE))
    arrays = lm_arrays(r_cfg)
    batch = _batches(r_cfg.vocab_size)[0]
    params = jax.tree.map(jnp.asarray, arrays)
    grads = jax.grad(lambda p: RT.loss_fn(
        p, r_cfg, {k: jnp.asarray(v) for k, v in batch.items()})[0])(params)
    state = r_opt.adafactor_init(params)
    model = Transformer.from_arrays(cfg, arrays, device="cpu")
    got = {k: p.detach().clone() for k, p in model.named_parameters()}
    named_g = {k: torch.from_numpy(v) for k, v in _named(cfg, grads).items()}
    got_state = opt.adafactor_init(got)
    for i in range(3):
        params, state = r_opt.adafactor_update(params, grads, state,
                                               jnp.int32(i), r_opt.OptHyper())
        opt.adafactor_update(got, named_g, got_state, i, opt.OptHyper())
        if i in (0, 2):
            want = _named(cfg, params)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           atol=1e-6, rtol=0,
                                           err_msg=f"{k} after {i + 1}")
    want = _stacked_state({"f": state["f"]}, cfg)
    assert sorted(want) == sorted(("f", k, leaf) for k, sub in
                                  got_state["f"].items() for leaf in sub)
    assert want[("f", "layers.ln1.scale", "vr")].shape == (2,)
    for (_, k, leaf), w in want.items():
        np.testing.assert_allclose(got_state["f"][k][leaf].numpy(), w,
                                   rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("arch", [a for a in r_list_archs()
                                  if a != "ringo-graph"])
def test_stack_groups_are_the_references_pytree(arch):
    """Every family's per-layer leaves group into the reference's stacked
    leaves: the same paths, the same stacked shapes."""
    r_cfg = r_reduced(r_get_config(arch))
    shapes = jax.eval_shape(lambda: RT.init_params(r_cfg,
                                                   jax.random.PRNGKey(0)))
    want = {".".join(p.key for p in path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    full = {k: p for k, p in Transformer(reduced(get_config(arch)),
                                         device="meta").named_parameters()}
    got = {k: stack + tuple(full[members[0][1]].shape) for k, (stack, members)
           in opt.stack_groups(full).items()}
    assert got == want
    assert math.prod(got["layers.ln1.scale" if "layers.ln1.scale" in got
                         else next(iter(got))]) > 0


def test_a_per_layer_adafactor_checkpoint_is_refused(tmp_path):
    """A checkpoint whose Adafactor state is per layer (the layout before
    the state was the stacked parameters') is refused, never loaded."""
    from repro_torch.checkpoint import store
    cfg = reduced(get_config(MOE))
    model, state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    old = {"f": {k: {"v": torch.zeros(p.shape)} for k, p in params.items()}}
    store.save_checkpoint(str(tmp_path), 1, {"params": params, "opt": old},
                          meta={"config": store.config_hash(cfg)})
    with pytest.raises(ValueError, match="Adafactor state per layer"):
        launch_train.load_train_state(str(tmp_path), model, state, cfg)


def test_launch_train_two_d_runs_in_a_world_of_4(tmp_path):
    """``--data 2 --model 2`` trains reduced qwen2.5-3b with the 2-D
    weights ``rules_for`` gives a giant model (every config giant: a
    ``GIANT_PARAM_BYTES`` of 0 in the ranks) and checkpoints the one-rank
    tree, equal within 1e-5 to a one-rank run's."""
    from _torch_worlds import launch_train_job
    common = ["--reduced", "--device", "cpu", "--steps", "2", "--batch",
              "4", "--seq", "16"]
    ck4 = str(tmp_path / "ck4")
    outs = run_world(launch_train_job, 4, tmp_path / "w4",
                     common + ["--data", "2", "--model", "2", "--ckpt-dir",
                               ck4], 0)
    assert "[train] grid data=2 model=2, weights 2-D" in outs[0]
    assert "[train] step     2" in outs[0]
    ck1 = str(tmp_path / "ck1")
    launch_train.main(common + ["--ckpt-dir", ck1])
    with np.load(f"{ck1}/step_00000002/shard_0.npz") as one, \
            np.load(f"{ck4}/step_00000002/shard_0.npz") as four:
        assert sorted(one.files) == sorted(four.files)
        for k in one.files:
            np.testing.assert_allclose(four[k], one[k], atol=1e-5, rtol=0,
                                       err_msg=k)


# phase 4i's run (a) at reduced width, and the leaf whose 2-D gradient the
# planted fault leaves undivided by d
HALVES_OVER = dict(arch=MOE, **cs.TWO_D_OVER)
PLANTED = "layers.0.attn.wk.w"


@pytest.fixture(scope="module")
def halves(tmp_path_factory):
    """The world's records (each rank: the honest run, then the planted
    one), the averaged halves' gradient of every leaf and the one-rank
    run's step-0 gradient norm on the whole batch (the phase's
    ``train_d1``)."""
    over = {k: v for k, v in HALVES_OVER.items() if k != "arch"}
    cfg = reduced(get_config(MOE), **over)
    rng = np.random.default_rng(0)
    t = rng.integers(0, cfg.vocab_size, (2, S + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "targets": torch.from_numpy(t[:, 1:])}
    res = run_world(two_d_grads_job, 4, tmp_path_factory.mktemp("halves"),
                    HALVES_OVER, batch, PLANTED)
    shards = [{k: v[h:h + 1] for k, v in batch.items()} for h in range(2)]
    want, differed = cs.two_d_halves_grad(
        "cpu", cfg, shards, lambda k: True,
        [res[2 * h][0]["routes"] for h in range(2)])
    assert differed == [0, 0]   # float32: the ranks' routings are its own
    own, none = cs.two_d_halves_grad("cpu", cfg, shards, lambda k: True)
    assert none == [0, 0] and all(torch.equal(own[k], want[k]) for k in own)
    d1 = cs.train_one_rank("cpu", cfg, [batch], 1)[0]["grad_norm"]
    return res, want, d1


def test_replaying_a_runs_own_routings_changes_no_bit(halves):
    """``moe_choices``: a d = 1 step's routings recorded, then replayed
    through ``moe.assign``, give the same gradients bit for bit, and a
    replay of other choices moves the experts' gradients."""
    res, _, _ = halves
    over = {k: v for k, v in HALVES_OVER.items() if k != "arch"}
    cfg = reduced(get_config(MOE), **over)
    rng = np.random.default_rng(1)
    t = rng.integers(0, cfg.vocab_size, (1, S + 1)).astype(np.int32)
    rows = {"tokens": torch.from_numpy(t[:, :-1]),
            "targets": torch.from_numpy(t[:, 1:])}

    def grads(replay):
        model = Transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
        with cs.moe_choices(replay) as seen:
            loss, _ = model.loss_fn(rows)
            loss.backward()
        return {k: p.grad for k, p in model.named_parameters()}, seen

    base, chosen = grads(None)
    again, differed = grads(chosen)
    assert sum(differed) == 0 and all(torch.equal(base[k], again[k])
                                      for k in base)
    other = [(c + 1) % cfg.n_experts for c in chosen]   # the next expert
    moved, differed = grads(other)
    assert differed[0] == chosen[0].numel()     # layer 0's every choice
    assert not torch.equal(moved["layers.0.moe.wi"], base["layers.0.moe.wi"])


def test_two_d_blocks_match_the_averaged_halves_per_leaf(halves):
    res, want, d1 = halves
    gaps = [cs.leaf_grad_gaps(r[0]["grads"], want) for r in res]
    assert all(PLANTED in g and len(g) > 10 for g in gaps)
    assert max(max(g.values()) for g in gaps) <= 1e-2, gaps   # bf16 copies
    cs.leaf_grad_check("honest", gaps, cs.TWO_D_NORM_TOL)
    for r in res:
        norm = r[0]["metrics"]["grad_norm"]
        assert abs(norm - d1) <= cs.TWO_D_NORM_TOL * d1


def test_the_per_leaf_check_refuses_a_2d_gradient_left_undivided(halves):
    """The planted leaf reads a gap of 1 (its gradient doubled at d = 2)
    on every rank, every other leaf as before; the phase's norm check on
    step 0 passes it, the per-leaf check refuses it."""
    res, want, d1 = halves
    gaps = [cs.leaf_grad_gaps(r[1]["grads"], want) for r in res]
    for g in gaps:
        assert abs(g.pop(PLANTED) - 1.0) <= 1e-2, g
        assert max(g.values()) <= 1e-2
    gaps = [cs.leaf_grad_gaps(r[1]["grads"], want) for r in res]
    for r in res:
        norm = r[1]["metrics"]["grad_norm"]
        assert abs(norm - d1) <= cs.TWO_D_NORM_TOL * d1, (norm, d1)
    with pytest.raises(RuntimeError, match="gradient per leaf"):
        cs.leaf_grad_check("planted", gaps, cs.TWO_D_NORM_TOL)
