"""The port's LM sharded over the ranks of a gloo world (tensor parallel,
expert parallel) against the reference's unsharded model, on the CPU.

One world per (data, model) grid in {(1, 2), (1, 4), (2, 2)}, spawned once
per module (``_torch_worlds.sharded_lm_job``), serves reduced qwen2.5-3b,
qwen3-moe and grok-1 from the reference's parameters
(``_torch_oracles.lm_arrays``), the MoE configs with ``moe_impl="sorted"``
and ``"expert_tp"``, at capacity factor E/k (no assignment drops).  Each
rank gets its data shard's rows of a batch of 4.  Held, on every rank:

* ``forward``'s logits, ``prefill``'s and 4 teacher-forced
  ``decode_step``s' within 1e-5 of the largest logit of the reference's
  unsharded ``forward`` / ``prefill`` / ``decode_step``; the aux loss
  within 1e-5 of the reference's (``expert_tp`` at data 2: the mean of its
  two data shards', the reference's pmean over "data");
* ``Engine.generate``'s greedy tokens equal on every rank of a data shard
  and to the unsharded port's (d = 1) for those prompts;
* the meta shapes ``launch.specs.input_specs`` gives for the grid equal
  the parameters and cache the rank holds (2 KV heads over 4 model ranks:
  one each);
* ``expert_tp`` at capacity factor 0.5 (drops) within 1e-5 of the
  reference's ``moe_apply_expert_tp`` on host meshes of the same shapes,
  aux included (the reference in a subprocess that sets ``XLA_FLAGS``
  before jax loads, as ``tests/test_distributed.py`` does).

A sharded ``loss_fn`` of qwen2.5-3b and its gradient of the final norm
agree with the unsharded port's on the rank's rows within 1e-5 (the
collectives carry gradients; ``tests/test_torch_sharded_train.py`` holds
the sharded train step).  The families with no sharded forward (ssm,
hybrid) raise over more than one rank, the audio and vlm families build
(``tests/test_torch_sharded_heads.py`` holds them); weights split over a
data axis of two are their spec's blocks (``tests/test_torch_two_d.py``
holds their numbers).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from _torch_worlds import run_world, sharded_lm_job
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as RT
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import sharding, specs
from repro_torch.launch.mesh import ModelGrid, ModelGroup, counting_grid
from repro_torch.models.transformer import Transformer, param_blocks
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(2)

GRIDS = [(1, 2), (1, 4), (2, 2)]
B, S, NEW = 4, 12, 4
TOL = 1e-5     # of the largest |logit|
MOE = ["qwen3-moe-235b-a22b", "grok-1-314b"]
CASES = [("qwen2.5-3b", "sorted")] + [(a, impl) for a in MOE
                                      for impl in ("sorted", "expert_tp")]
CASE_IDS = [f"{a}-{i}" for a, i in CASES]
# equal lengths in each data shard's pair: the shards' batches route as
# one (the sorted MoE gathers them)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 9], [8, 9, 10, 11, 12], [10, 11]]
LAYER_CF = 0.5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _over(arch, impl, cf=None):
    cfg = reduced(get_config(arch))
    if cf is None:
        cf = cfg.n_experts / cfg.experts_per_token if cfg.n_experts else 1.25
    return {"capacity_factor": cf, "moe_impl": impl}


def _tag(arch, impl):
    return f"{arch}-{impl}"


@pytest.fixture(scope="module")
def ref():
    """Per case: the arrays, tokens, and the reference's unsharded logits
    (forward, prefill, 4 decode steps) and aux; the unsharded port's
    greedy tokens for ``PROMPTS``."""
    out = {}
    rng = np.random.default_rng(0)
    for arch, impl in CASES:
        over = _over(arch, impl)
        r_cfg = r_reduced(r_get_config(arch), **over)
        arrays = lm_arrays(r_cfg)
        params = jax.tree.map(jnp.asarray, arrays)
        toks = rng.integers(0, r_cfg.vocab_size, (B, S)).astype(np.int32)
        fwd = jax.jit(lambda p, t: RT.forward(p, r_cfg, {"tokens": t}))
        logits, aux = fwd(params, jnp.asarray(toks))
        halves = [float(fwd(params, jnp.asarray(h))[1])
                  for h in np.split(toks, 2)]
        pre, cache = jax.jit(lambda p, t: RT.prefill(
            p, r_cfg, {"tokens": t}, S + 4))(params, jnp.asarray(toks[:, :-4]))
        dec = jax.jit(lambda p, c, t, pos: RT.decode_step(p, r_cfg, c, t,
                                                           pos))
        steps = []
        for i in range(S - 4, S):
            d, cache = dec(params, cache, jnp.asarray(toks[:, i:i + 1]),
                           jnp.int32(i))
            steps.append(np.asarray(d)[:, 0])
        cfg = reduced(get_config(arch), **over)
        eng = Engine(cfg, Transformer.from_arrays(cfg, arrays, device="cpu"),
                     ServeConfig(batch=B, max_seq=64), device="cpu")
        out[_tag(arch, impl)] = {
            "over": dict(arch=arch, **over), "arrays": arrays, "tokens": toks,
            "forward": np.asarray(logits), "aux": float(aux),
            "aux_halves": halves, "prefill": np.asarray(pre),
            "decode": np.stack(steps, 1),
            "generate": eng.generate(PROMPTS, NEW)}
    return out


@pytest.fixture(scope="module")
def layer_inputs():
    """(tag, overrides, arrays, x) of the ``expert_tp`` layer cases, at
    capacity factor ``LAYER_CF``."""
    out = []
    for i, arch in enumerate(MOE):
        over = _over(arch, "expert_tp", LAYER_CF)
        arrays = lm_arrays(r_reduced(r_get_config(arch), **over))
        x = np.random.default_rng(10 + i).normal(
            size=(B, 16, 64)).astype(np.float32)
        out.append((arch, dict(arch=arch, **over), arrays, x))
    return out


REF_TP = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs.base import get_config, reduced
    from repro.launch.sharding import default_rules, rules_ctx
    from repro.models.moe import moe_apply_expert_tp
    with open(sys.argv[1], "rb") as f:
        grids, layers = pickle.load(f)
    out = {}
    for tag, over, arrays, x in layers:
        over = {k: v for k, v in over.items() if k != "arch"}
        cfg = reduced(get_config(tag), **over)
        p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         arrays["layers"]["moe"])
        for data, model in grids:
            mesh = jax.make_mesh((data, model), ("data", "model"),
                                 devices=jax.devices()[:data * model])
            with rules_ctx(default_rules(mesh, expert_axis_parallel=True)):
                y, aux = moe_apply_expert_tp(p, jnp.asarray(x), cfg)
            out[(tag, data, model)] = (np.asarray(y), float(aux))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')


@pytest.fixture(scope="module")
def ref_tp(layer_inputs, tmp_path_factory):
    """The reference's ``moe_apply_expert_tp`` on each grid's host mesh."""
    tmp = tmp_path_factory.mktemp("ref_tp")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((GRIDS, layer_inputs), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", REF_TP, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def world(request, ref, layer_inputs, tmp_path_factory):
    data, model = request.param
    cases = [(tag, r["over"], r["arrays"], r["tokens"])
             for tag, r in ref.items()]
    res = run_world(sharded_lm_job, data * model,
                    tmp_path_factory.mktemp(f"lm{data}x{model}"), data, model,
                    cases, layer_inputs, PROMPTS, NEW)
    return data, model, res


def _rows(a, data, di):
    n = a.shape[0] // data
    return a[di * n:(di + 1) * n]


def _close(got, want, what):
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_forward_matches_reference(world, ref, case):
    data, _, res = world
    r = ref[_tag(*case)]
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        got = out["lm"][_tag(*case)]
        _close(got["forward"], _rows(r["forward"], data, di),
               f"rank {rank} forward")
        want = r["aux"] if case[1] == "sorted" or data == 1 \
            else float(np.mean(r["aux_halves"]))
        assert abs(got["aux"] - want) <= TOL * max(1.0, abs(want)), \
            (rank, got["aux"], want)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_prefill_and_decode_match_reference(world, ref, case):
    data, _, res = world
    r = ref[_tag(*case)]
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        got = out["lm"][_tag(*case)]
        _close(got["prefill"], _rows(r["prefill"], data, di),
               f"rank {rank} prefill")
        _close(got["decode"], _rows(r["decode"], data, di),
               f"rank {rank} decode")


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_generate_same_tokens_on_every_rank_and_at_d1(world, ref, case):
    data, _, res = world
    want = ref[_tag(*case)]["generate"]
    n = len(PROMPTS) // data
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        assert out["lm"][_tag(*case)]["generate"] == \
            want[di * n:(di + 1) * n], rank


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_input_specs_meta_shapes_are_the_ranks(world, case):
    """The parameters and the decode cache a rank holds have the shapes
    ``input_specs`` gives for its grid; the cache holds whole KV heads."""
    _, model, res = world
    cfg = reduced(get_config(case[0]))
    for out in res:
        got = out["lm"][_tag(*case)]
        assert got["params_match_meta"]
        assert got["cache_shapes"] == got["cache_meta"]
        assert got["kv_heads"] == max(1, cfg.n_kv_heads // model)
        assert got["cache_shapes"]["k"][3] == got["kv_heads"]


@pytest.mark.parametrize("arch", MOE)
def test_expert_tp_with_drops_matches_reference(world, ref_tp, layer_inputs,
                                                arch):
    data, model, res = world
    y, aux = ref_tp[(arch, data, model)]
    x = next(x for tag, _, _, x in layer_inputs if tag == arch)
    cfg = reduced(get_config(arch), capacity_factor=LAYER_CF)
    t = x.shape[0] // data * x.shape[1]
    assert t * cfg.experts_per_token / cfg.n_experts * LAYER_CF < \
        t * cfg.experts_per_token / cfg.n_experts   # capacity below the mean
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        got = out["layers"][arch]
        _close(got["out"], _rows(y, data, di), f"rank {rank} expert_tp")
        assert abs(got["aux"] - aux) <= TOL * max(1.0, abs(aux)), \
            (rank, got["aux"], aux)


def _abstract(data, model):
    """A grid with no process group: enough to build a model, no
    collective runs."""
    return ModelGrid(ModelGroup(data, 0), ModelGroup(model, 0))


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-small",
                                  "internvl2-26b", "jamba-1.5-large-398b"])
def test_unported_families_raise_over_model_ranks(arch):
    """Every family builds over model ranks now (the name is kept from when
    the ssm and hybrid families raised): over (1, 2) each rank holds its
    query heads and the KV heads they read, an xLSTM rank its mLSTM heads
    and half of the sLSTM's channels, a jamba rank half of each Mamba's,
    in its model, its ``init_cache`` and ``cache_structs``
    (``tests/test_torch_sharded_heads.py`` and
    ``tests/test_torch_sharded_ssm.py`` hold their numbers)."""
    cfg = reduced(get_config(arch))
    mesh = _abstract(1, 2)
    from repro_torch.configs.base import ShapeSpec
    shape = ShapeSpec("d", 8, 2, "decode")
    cache, _ = specs.cache_structs(cfg, shape, mesh,
                                   specs.rules_for(cfg, mesh, "decode"))
    inner = cfg.d_model * cfg.ssm_expand
    for r in range(2):
        grid = ModelGrid(ModelGroup(1, 0), ModelGroup(2, r))
        m = Transformer(cfg, device="cpu", group=grid)
        held = m.init_cache(2, 8)
        if cfg.family == "ssm":
            period = m.layers[0]
            assert period.mixer(0).n_heads == cfg.n_heads // 2
            assert period.mixer(1).r_h.w.shape == (inner, inner // 2)
            assert held["b0"]["c"].shape[2] == cfg.n_heads // 2
            assert held["b1"]["h"].shape[-1] == inner // 2
        else:
            layers = list(m.layers) + (list(m.enc["layers"]) if m.enc
                                       else [])
            assert all(blk.attn.n_heads == cfg.n_heads // 2 for blk in
                       layers)
            assert m.kv_heads == cfg.n_kv_heads // 2 == \
                held["attn"]["k"].shape[3]
        if cfg.family == "hybrid":
            assert m.layers[0].mamba[0].a_log.shape == \
                (inner // 2, cfg.ssm_state_dim)
            assert held["mamba"]["h"].shape[3] == inner // 2
        assert {(g, k): t.shape for g, leaves in held.items()
                for k, t in leaves.items()} == \
            {(g, k): t.shape for g, leaves in cache.items()
             for k, t in leaves.items()}
    # one rank: the unsharded model, through the grid
    Transformer(cfg, device="cpu", group=_abstract(1, 1))


def test_sharded_training_raises(world, ref):
    """The collectives carry gradients now (the sharded train step, ROADMAP
    item 15 (b)): a sharded ``loss_fn`` of qwen2.5-3b runs and agrees with
    the unsharded port's on the rank's rows, loss and the final norm's
    gradient (whole on every rank) within 1e-5."""
    data, _, res = world
    tag = _tag("qwen2.5-3b", "sorted")
    cfg = reduced(get_config("qwen2.5-3b"))
    one = Transformer.from_arrays(cfg, ref[tag]["arrays"], device="cpu")
    for rank, out in enumerate(res):
        toks = torch.from_numpy(_rows(ref[tag]["tokens"], data,
                                      out["coords"]["data"][0]))
        loss, _ = one.loss_fn({"tokens": toks[:, :-1],
                               "targets": toks[:, 1:]})
        loss.backward()
        got = out["lm"][tag]["train"]
        assert abs(got["loss"] - float(loss)) <= TOL * abs(float(loss)), rank
        want = one.norm_f.scale.grad.numpy()
        np.testing.assert_allclose(got["norm_f_grad"], want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=f"rank {rank}")
        one.zero_grad(set_to_none=True)


def test_weights_split_over_data_raise():
    """Weights split over a data axis of two (``two_d_weights``) are held
    as the spec's block of both axes, and the (2, 2) model runs (over
    counting groups: rank 0's shapes, ``tests/test_torch_two_d.py`` holds
    the numbers); over a grid with no process group a gather raises
    rather than reading a block as the whole weight."""
    cfg = reduced(get_config("qwen2.5-3b"))
    rules = sharding.default_rules(two_d_weights=True)
    m = Transformer.init_params(cfg, device="cpu", group=_abstract(2, 2),
                                rules=rules)
    blocks = param_blocks(cfg, _abstract(2, 2).coords, rules)
    for k, p in m.named_parameters():
        full, spec, keep = blocks[k]
        assert tuple(p.shape) == tuple(keep(full).shape), k
        assert (getattr(p, "data_dim", None) is not None) == \
            any("data" in sharding._axes(e) for e in spec), k
    assert m.layers[0].mlp.wi.w.shape == (32, 64)
    assert m.layers[0].ln1.scale.shape == (64,)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no process group"):
        m({"tokens": toks})
    counted = Transformer.init_params(
        cfg, device="cpu", group=counting_grid(_abstract(2, 2)), rules=rules)
    logits, _ = counted({"tokens": toks})
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    # at data = 1 the data axis splits nothing
    m = Transformer(cfg, device="cpu", group=_abstract(1, 2), rules=rules)
    assert m.layers[0].mlp.wi.w.shape == (64, 64)
    assert not any(hasattr(p, "data_dim") for p in m.parameters())
