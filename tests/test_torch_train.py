"""The port's training slice against the reference, on the CPU.

Reduced configs (``reduced``: 2 layers, d_model 64, vocab 256, float32,
``remat="none"``) of qwen2.5-3b and starcoder2-15b, and of the MoE models
qwen3-moe and grok-1 (4 experts, top 2; their loss adds 0.01 x the
routers' aux loss, and they train with Adafactor), with the reference's
``init_params`` weights (biases and norms perturbed,
``_torch_oracles.lm_arrays``) carried across by ``Transformer.from_arrays``
and the same numpy tokens through both packages.  Tolerances: the loss to
1e-5 relative; every parameter's gradient to ``atol 1e-5 + rtol 1e-4`` of
``jax.grad``'s (two layers of float32 products summed in other orders);
one AdamW or Adafactor update to 1e-6 of the reference's over its stacked
tree; three train steps' losses to 1e-5;
clipping with exactly representable sums, int8 quantization and the data
streams bit for bit.  The data-parallel step runs in a spawned gloo world
of two ranks (``_torch_worlds.run_world``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from _torch_worlds import ddp_job, launch_train_job, run_world
from repro.checkpoint import store as r_store
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.core.graph import Graph as RGraph
from repro.data.graph_corpus import RandomWalkCorpus as RCorpus
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.data.rmat import rmat_edges
from repro.models import transformer as RT
from repro.train import compress as r_compress
from repro.train import optimizer as r_opt
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config, list_archs, reduced
from repro_torch.core.graph import Graph
from repro_torch.data.graph_corpus import RandomWalkCorpus
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.launch.elastic import ElasticCoordinator
from repro_torch.launch.mesh import ShardGroup
from repro_torch.models.transformer import Transformer
from repro_torch.train import compress, optimizer as opt
from repro_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = ["qwen2.5-3b", "starcoder2-15b", "qwen3-moe-235b-a22b", "grok-1-314b"]
B, S = 2, 16
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _batch(cfg, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


class Case:
    """One reduced config in both packages, its weights, a batch, and the
    reference's loss and gradients."""

    def __init__(self, arch):
        self.arch = arch
        self.r_cfg = r_reduced(r_get_config(arch))
        self.cfg = reduced(get_config(arch))
        self.arrays = lm_arrays(self.r_cfg)
        self.r_params = jax.tree.map(jnp.asarray, self.arrays)
        self.batch = _batch(self.cfg)
        rb = {k: jnp.asarray(v) for k, v in self.batch.items()}
        (loss, aux), grads = jax.value_and_grad(
            lambda p: RT.loss_fn(p, self.r_cfg, rb), has_aux=True)(
                self.r_params)
        self.r_loss = float(loss)
        self.r_ce = float(aux["ce"])
        self.r_aux = float(aux["aux"])
        # the reference's gradient pytree under the port's parameter names
        self.r_grads = dict(Transformer.from_arrays(
            self.cfg, jax.tree.map(np.asarray, grads),
            device=CPU).named_parameters())

    def model(self, **overrides):
        cfg = dataclasses.replace(self.cfg, **overrides)
        return Transformer.from_arrays(cfg, self.arrays, device=CPU)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def test_loss_matches_reference(case):
    model = case.model()
    loss, aux = model.loss_fn(_torch_batch(case.batch))
    assert loss.dtype == torch.float32 and loss.requires_grad
    np.testing.assert_allclose(float(loss), case.r_loss, rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), case.r_ce, rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"]), case.r_aux, rtol=1e-5)
    assert (float(aux["aux"]) > 0.0) == (case.cfg.n_experts > 0)


def test_loss_mask_weights_the_mean(case):
    model = case.model()
    batch = dict(case.batch)
    mask = np.ones((B, S), np.float32)
    mask[:, S // 2:] = 0.0
    batch["loss_mask"] = mask
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = RT.loss_fn(case.r_params, case.r_cfg, rb)
    got, _ = model.loss_fn(_torch_batch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_gradients_match_jax_grad(case):
    model = case.model()
    loss, _ = model.loss_fn(_torch_batch(case.batch))
    loss.backward()
    params = dict(model.named_parameters())
    assert set(params) == set(case.r_grads)
    for name, p in params.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(),
                                   case.r_grads[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat(case, remat):
    grads = {}
    for policy in ("none", remat):
        model = case.model(remat=policy)
        loss, _ = model.loss_fn(_torch_batch(case.batch))
        loss.backward()
        grads[policy] = {k: p.grad for k, p in model.named_parameters()}
    for name, g in grads["none"].items():
        torch.testing.assert_close(grads[remat][name], g, atol=1e-6,
                                   rtol=1e-6, msg=name)


def test_serving_forward_keeps_its_bits(case):
    model = case.model()
    tokens = torch.from_numpy(case.batch["tokens"])
    served, _ = model({"tokens": tokens})
    trained, _ = model.forward_train({"tokens": tokens})
    assert not served.requires_grad and trained.requires_grad
    assert torch.equal(served, trained.detach())


def test_unknown_remat_raises(case):
    model = case.model(remat="everything")
    with pytest.raises(ValueError, match="remat"):
        model.loss_fn(_torch_batch(case.batch))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _opt_inputs(case, seed=1):
    """Parameters and gradients from numpy seeds, as named dicts."""
    rng = np.random.default_rng(seed)
    params = {k: p.detach().clone()
              for k, p in case.model().named_parameters()}
    grads = {k: torch.from_numpy(rng.normal(size=tuple(p.shape))
                                 .astype(np.float32) * 0.1)
             for k, p in params.items()}
    return params, grads


def _stacked(case, named):
    """Named per-layer tensors as the reference's stacked pytree (jnp)."""
    model = case.model()
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(named[k])
    return jax.tree.map(jnp.asarray, model.to_arrays())


def _unstacked(case, tree):
    """The reference's stacked pytree as the port's {name: numpy}."""
    return {k: p.detach().numpy().copy() for k, p in Transformer.from_arrays(
        case.cfg, jax.tree.map(np.asarray, tree),
        device=CPU).named_parameters()}


def _ref_update(case, name, params, grads, step, hyper, state=None):
    """The reference's update of its own stacked tree; ``params`` the
    stacked tree, ``grads`` the port's named gradients."""
    r = r_opt.get_optimizer(name)
    rs = r.init(params) if state is None else state
    return r.update(params, _stacked(case, grads), rs, jnp.int32(step),
                    hyper)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_step_matches_reference(case, name):
    """Two updates over the port's per-layer parameters against the
    reference's over its stacked tree (its Adafactor factors each stacked
    norm and takes one RMS over every layer); the state against the
    reference's, an Adafactor group's under its stacked path."""
    hyper = opt.OptHyper(lr=1e-2)
    r_hyper = r_opt.OptHyper(lr=1e-2)
    params, grads = _opt_inputs(case)
    o = opt.get_optimizer(name)
    state = o.init(params)
    r_params, r_state = _ref_update(case, name, _stacked(case, params),
                                    grads, 0, r_hyper)
    rp2, rs2 = _ref_update(case, name, r_params, grads, 1, r_hyper, r_state)
    got_p = {k: v.clone() for k, v in params.items()}
    o.update(got_p, grads, state, 0, hyper)
    want = _unstacked(case, r_params)
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), want[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    o.update(got_p, grads, state, 1, hyper)          # a second step
    want = _unstacked(case, rp2)
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), want[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    if name == "adamw":
        for part in ("m", "v"):
            for k, leaf in _unstacked(case, rs2[part]).items():
                np.testing.assert_allclose(state[part][k].numpy(), leaf,
                                           atol=1e-6, rtol=1e-6, err_msg=k)
        return
    flat_r = jax.tree_util.tree_flatten_with_path(rs2["f"])[0]
    assert len(flat_r) == sum(len(v) for v in state["f"].values())
    for path, leaf in flat_r:
        key = ".".join(p.key for p in path[:-1])
        np.testing.assert_allclose(state["f"][key][path[-1].key].numpy(),
                                   np.asarray(leaf), atol=1e-6, rtol=1e-6,
                                   err_msg=str(path))


def test_get_optimizer_rejects_unknown():
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.get_optimizer("sgd")


def test_clip_by_global_norm_bit_equal():
    # multiples of 1/8: every square and partial sum is exact in float32,
    # so the norm (one correctly rounded sqrt) is the same whatever order
    # each package sums in
    rng = np.random.default_rng(4)
    for max_norm in (0.5, 1.0, 1e6):
        tree = {f"x{i}": (rng.integers(-40, 40, size=shape) / 8.0
                          ).astype(np.float32)
                for i, shape in enumerate([(7, 3), (5,), (2, 2, 4)])}
        want, want_norm = r_opt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        got, norm = opt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
        assert np.asarray(want_norm).tobytes() == norm.numpy().tobytes()
        for k in tree:
            assert np.asarray(want[k]).tobytes() == got[k].numpy().tobytes()
        inplace = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        same, _ = opt.clip_by_global_norm(inplace, max_norm, inplace=True)
        for k in tree:
            assert same[k] is inplace[k] and torch.equal(same[k], got[k])


def test_clip_by_global_norm_random_close():
    rng = np.random.default_rng(5)
    tree = {f"x{i}": rng.normal(size=(64, 33)).astype(np.float32)
            for i in range(3)}
    want, want_norm = r_opt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    got, norm = opt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def test_three_train_steps_match_reference(case):
    r_step = jax.jit(r_make_train_step(case.r_cfg, r_opt.OptHyper(),
                                       attn_chunk=S))
    r_params = case.r_params
    r_state = r_opt.get_optimizer(case.r_cfg.optimizer).init(r_params)
    model = case.model()
    state = opt.get_optimizer(case.cfg.optimizer).init(
        dict(model.named_parameters()))
    step = make_train_step(case.cfg, opt.OptHyper(), attn_chunk=S)
    for i in range(3):
        batch = _batch(case.cfg, seed=10 + i)
        r_params, r_state, rm = r_step(
            r_params, r_state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.int32(i))
        model, state, m = step(model, state, _torch_batch(batch), i)
        assert set(m) == {"loss", "ce", "aux", "grad_norm"}
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        assert all(p.grad is None for p in model.parameters())


def test_init_train_state_is_seeded():
    cfg = reduced(get_config("qwen2.5-3b"))
    a, sa = init_train_state(cfg, torch.Generator().manual_seed(3), "cpu")
    b, _ = init_train_state(cfg, torch.Generator().manual_seed(3), "cpu")
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k
    assert set(sa) == {"m", "v"}
    assert all(float(t.abs().sum()) == 0 for t in sa["m"].values())


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_int8_bit_equal(scale):
    x = (np.random.default_rng(6).normal(size=(37, 11)) * scale
         ).astype(np.float32)
    q_r, s_r = r_compress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(q_r))
    assert s.numpy().tobytes() == np.asarray(s_r).tobytes()
    assert compress.dequantize_int8(q, s).numpy().tobytes() == \
        np.asarray(r_compress.dequantize_int8(q_r, s_r)).tobytes()


def test_compressed_psum_one_rank_matches_reference():
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=64).astype(np.float32),
         "b": rng.normal(size=(4, 3)).astype(np.float32)}
    r = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
         for k, v in g.items()}
    mesh = jax.make_mesh((1,), ("data",))
    fn = shard_map(lambda a, b: r_compress.compressed_psum(a, b, "data"),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                   check_rep=False)
    want, want_r = fn({k: jnp.asarray(v) for k, v in g.items()},
                      {k: jnp.asarray(v) for k, v in r.items()})
    got, got_r = compress.compressed_psum(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()}, ShardGroup(1, 0))
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(got_r[k].numpy(), np.asarray(want_r[k]),
                                   rtol=0, atol=1e-7)
    assert all(float(t.abs().sum()) == 0 for t in
               compress.init_error_feedback(got).values())


def _ref_ddp_update(case, per_rank, residuals, compress_it):
    """The reference's DDP formula over explicit ranks: the mean of the
    ranks' gradients (or the common-scale int8 sum with error feedback),
    clipping, one AdamW step from fresh state."""
    n = len(per_rank)
    names = list(per_rank[0])
    if compress_it:
        mean, new_res = {}, []
        for r in range(n):
            new_res.append({})
        for k in names:
            gf = [jnp.asarray(per_rank[r][k]) + jnp.asarray(residuals[r][k])
                  for r in range(n)]
            amax = jnp.max(jnp.stack([jnp.max(jnp.abs(x)) for x in gf]))
            scale = jnp.maximum(amax, 1e-12) / 127.0
            qs = [jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
                  for x in gf]
            for r in range(n):
                new_res[r][k] = np.asarray(gf[r] - qs[r].astype(jnp.float32)
                                           * scale)
            summed = sum(q.astype(jnp.int32) for q in qs)
            mean[k] = summed.astype(jnp.float32) * scale / n
    else:
        mean = {k: sum(jnp.asarray(per_rank[r][k]) for r in range(n)) / n
                for k in names}
        new_res = None
    clipped, _ = r_opt.clip_by_global_norm(mean, r_opt.OptHyper().clip_norm)
    params = {k: jnp.asarray(p.detach().numpy())
              for k, p in case.model().named_parameters()}
    o = r_opt.get_optimizer("adamw")
    new, _ = o.update(params, clipped, o.init(params), jnp.int32(0),
                      r_opt.OptHyper())
    return {k: np.asarray(v) for k, v in new.items()}, new_res


@pytest.fixture(scope="module")
def ddp_world(tmp_path_factory):
    c = Case("qwen2.5-3b")
    batch = _batch(c.cfg, seed=21, b=4)
    res = run_world(ddp_job, 2, tmp_path_factory.mktemp("ddp"), c.arrays,
                    batch)
    return c, batch, res


@pytest.mark.parametrize("compress_it", [False, True])
def test_ddp_step_two_ranks_equals_reference_formula(ddp_world, compress_it):
    c, batch, res = ddp_world
    tag = "compressed" if compress_it else "plain"
    for r in (0, 1):                          # every rank holds the same bits
        for k, v in res[0][tag]["params"].items():
            assert v.tobytes() == res[r][tag]["params"][k].tobytes(), k
    if compress_it:       # the formula on the port's own per-rank gradients
        per_rank = [res[r]["grads"] for r in (0, 1)]
    else:                 # the reference's gradients of each rank's rows
        per_rank = []
        for r in (0, 1):
            rb = {k: jnp.asarray(v[2 * r: 2 * r + 2])
                  for k, v in batch.items()}
            g = jax.grad(lambda p: RT.loss_fn(p, c.r_cfg, rb)[0])(c.r_params)
            per_rank.append({k: p.detach().numpy()
                             for k, p in Transformer.from_arrays(
                c.cfg, jax.tree.map(np.asarray, g),
                device=CPU).named_parameters()})
    zeros = [{k: np.zeros_like(v) for k, v in per_rank[0].items()}
             for _ in (0, 1)]
    want, want_res = _ref_ddp_update(c, per_rank, zeros, compress_it)
    atol = 1e-6 if compress_it else 1e-5
    for k, v in want.items():
        np.testing.assert_allclose(res[0][tag]["params"][k], v, atol=atol,
                                   rtol=0, err_msg=k)
    if compress_it:
        for r in (0, 1):
            for k, v in want_res[r].items():
                np.testing.assert_allclose(res[r][tag]["residuals"][k], v,
                                           atol=1e-7, rtol=0, err_msg=k)
    np.testing.assert_allclose(res[0][tag]["loss"], res[1][tag]["loss"],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seed", [(100, 3), (151936, 0)])
def test_synthetic_lm_batches_equal_reference(vocab, seed):
    ref = RSyntheticLM(vocab, batch=4, seq_len=33, seed=seed)
    port = SyntheticLM(vocab, batch=4, seq_len=33, seed=seed)
    for step in (0, 1, 17):
        a, b = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_random_walk_corpus_equals_reference():
    s, d = rmat_edges(scale=9, edge_factor=8, seed=7)
    keep = s != d
    rg = RGraph.from_edges(s[keep], d[keep], dedupe=True)
    g = Graph.from_edges(s[keep], d[keep], dedupe=True, device="cpu")
    ref = RCorpus(rg, batch=3, seq_len=40, seed=2)
    port = RandomWalkCorpus(g, batch=3, seq_len=40, seed=2)
    assert port.n == ref.n
    for step in (0, 5):
        a, b = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_prefetcher_yields_the_source_in_step_order():
    src = SyntheticLM(50, batch=2, seq_len=8, seed=1)
    pre = Prefetcher(src, depth=2, device="cpu", start_step=4)
    try:
        for want in (4, 5, 6):
            step, batch = pre.next()
            assert step == want
            assert np.array_equal(batch["tokens"].numpy(),
                                  src.batch_at(want)["tokens"])
    finally:
        pre.stop()
    assert not pre.thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_config_hash_equals_reference(arch):
    assert store.config_hash(get_config(arch)) == \
        r_store.config_hash(r_get_config(arch))
    assert store.config_hash(reduced(get_config(arch))) == \
        r_store.config_hash(r_reduced(r_get_config(arch)))


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"a.w": torch.randn((3, 4), generator=g),
                       "b": torch.randn((5,), generator=g).to(torch.bfloat16)},
            "opt": {"m": {"a.w": torch.zeros((3, 4))},
                    "step": np.asarray([7], np.int64)}}


def test_checkpoint_round_trip(tmp_path):
    tree = _tree()
    path = store.save_checkpoint(str(tmp_path), 3, tree, meta={"config": "x"})
    assert path.endswith("step_00000003")
    like = {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "opt": {"m": {"a.w": torch.ones((3, 4))},
                    "step": np.zeros(1, np.int64)}}
    step, got, meta = store.load_checkpoint(str(tmp_path), like)
    assert step == 3 and meta == {"config": "x"}
    for k, v in tree["params"].items():
        assert got["params"][k].dtype == v.dtype and torch.equal(
            got["params"][k], v)
    assert np.array_equal(got["opt"]["step"], [7])
    # in place: into the given tensors
    store.load_checkpoint(str(tmp_path), like, inplace=True)
    assert torch.equal(like["params"]["b"], tree["params"]["b"])
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["params/b"]["dtype"] == "bfloat16"


def test_latest_step_ignores_partial_directories(tmp_path):
    tree = _tree()
    store.save_checkpoint(str(tmp_path), 2, tree)
    store.save_checkpoint(str(tmp_path), 5, tree)
    os.makedirs(tmp_path / "tmp.9.0")                 # a save cut short
    os.makedirs(tmp_path / "step_00000009")           # no manifest
    assert store.latest_step(str(tmp_path)) == 5
    assert store.latest_step(str(tmp_path / "nothing")) is None
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path / "nothing"), tree)


def test_checkpoint_checksum_detects_corruption(tmp_path):
    tree = {"w": torch.ones(4)}
    path = store.save_checkpoint(str(tmp_path), 3, tree)
    np.savez(os.path.join(path, "shard_0.npz"),
             w=np.zeros(4, np.float32))          # corrupt payload
    with pytest.raises(IOError):
        store.load_checkpoint(str(tmp_path), tree)


def test_load_train_state_restores_in_place_and_checks_config(tmp_path):
    cfg = reduced(get_config("qwen2.5-3b"))
    model, state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    store.save_checkpoint(str(tmp_path), 4,
                          launch_train.train_state_tree(model, state),
                          meta={"config": store.config_hash(cfg)})
    other, other_state = init_train_state(
        cfg, torch.Generator().manual_seed(1), "cpu")
    assert launch_train.load_train_state(str(tmp_path), other, other_state,
                                         cfg) == 4
    for (k, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(p, q), k
    wider = dataclasses.replace(cfg, d_ff=256)
    with pytest.raises(ValueError, match="config mismatch"):
        launch_train.load_train_state(str(tmp_path), other, other_state,
                                      wider)


def test_moe_train_state_round_trips_through_a_checkpoint(tmp_path):
    """An MoE model's parameters (float32 routers, (E, d, f) experts) and
    its Adafactor state after one step save and load back in place."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    assert cfg.optimizer == "adafactor"
    model, state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    step = make_train_step(cfg, opt.OptHyper(), attn_chunk=S)
    model, state, _ = step(model, state, _torch_batch(_batch(cfg)), 0)
    store.save_checkpoint(str(tmp_path), 1,
                          launch_train.train_state_tree(model, state),
                          meta={"config": store.config_hash(cfg)})
    other, other_state = init_train_state(
        cfg, torch.Generator().manual_seed(1), "cpu")
    assert launch_train.load_train_state(str(tmp_path), other, other_state,
                                         cfg) == 1
    for (k, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(p, q), k
    want = jax.tree_util.tree_leaves_with_path(state)
    got = dict(jax.tree_util.tree_leaves_with_path(other_state))
    assert len(want) == len(got)
    for path, leaf in want:
        assert torch.equal(torch.as_tensor(got[path]),
                           torch.as_tensor(leaf)), path


# ---------------------------------------------------------------------------
# elastic coordination (the reference's cases, tests/test_train.py)
# ---------------------------------------------------------------------------


def test_elastic_straggler_detection():
    c = ElasticCoordinator(n_workers=8, hosts_per_tp_group=2,
                           straggler_factor=1.5, evict_after_flags=2)
    for step in range(25):
        for w in range(8):
            t = 1.0 if w != 3 else 2.5   # worker 3 lags
            c.heartbeat(w, t, now=float(step))
    assert c.stragglers() == [3]


def test_elastic_remesh_on_death():
    c = ElasticCoordinator(n_workers=8, hosts_per_tp_group=2, dead_after=10.0)
    for w in range(8):
        c.heartbeat(w, 1.0, now=0.0)
    for w in range(7):                    # worker 7 goes silent
        c.heartbeat(w, 1.0, now=100.0)
    plan = c.plan(now=106.0)
    assert plan.restart_required
    assert 7 in plan.dropped_workers
    # 3 surviving TP groups -> dp rounds down to 2
    assert plan.mesh_shape == (2, 2)


def test_elastic_healthy_noop():
    c = ElasticCoordinator(n_workers=4, hosts_per_tp_group=2)
    for w in range(4):
        c.heartbeat(w, 1.0, now=1.0)
    plan = c.plan(now=2.0)
    assert not plan.restart_required
    assert plan.mesh_shape == (2, 2)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=tmp_path)


def test_train_lm_example_runs_on_the_cpu(tmp_path):
    out = _run(["repro_torch.examples.train_lm", "--device", "cpu",
                "--steps", "3", "--ckpt-dir", str(tmp_path / "ck")], tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] step    1" in out.stdout


def test_launch_train_resumes_and_refuses_model_parallelism(tmp_path):
    """Resume at one rank; ``--model 2`` trains over two ranks of a world
    (it was refused before the sharded train step) and resumes there."""
    ck = str(tmp_path / "ck")
    common = ["repro_torch.launch.train", "--reduced", "--device", "cpu",
              "--batch", "2", "--seq", "16", "--ckpt-dir", ck]
    out = _run(common + ["--steps", "4", "--ckpt-every", "2"], tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert store.latest_step(ck) == 4
    out = _run(common + ["--steps", "6", "--resume"], tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "resumed from step 4" in out.stdout
    assert store.latest_step(ck) == 6
    ck2 = str(tmp_path / "ck2")
    model2 = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--model", "2", "--ckpt-dir", ck2]
    outs = run_world(launch_train_job, 2, tmp_path / "w2",
                     model2 + ["--steps", "2"])
    assert "[train] step     2" in outs[0] and store.latest_step(ck2) == 2
    outs = run_world(launch_train_job, 2, tmp_path / "w2b",
                     model2 + ["--steps", "3", "--resume"])
    assert "resumed from step 2" in outs[0] and store.latest_step(ck2) == 3


def test_training_entry_points_without_device_need_the_card(monkeypatch):
    from repro_torch.examples import train_lm
    from repro_torch.serve.graph_service import serve_follower
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Prefetcher(SyntheticLM(10, 1, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_follower(ShardGroup(2, 1))
