"""The port's sharding rules and per-rank shapes (``repro_torch/launch/
{sharding,specs,mesh}.py``, ``train/optimizer.py``'s spec functions) against
the reference's, on the CPU.

* ``param_specs``: for each of the ten registered archs at the production
  (16, 16) rules, with and without ``two_d_weights`` and
  ``expert_axis_parallel``, the port's spec of every parameter equals the
  reference's spec of the stacked leaf it loads from (names mapped as
  ``from_arrays`` maps them; the stacked leading dims unsplit).  Where the
  rules are the production policy's (experts on "model" only when 16
  divides them), every split dim divides, as ``tests/test_sharding.py``
  checks; and no spec names an axis twice.
* ``rules_for``: the same mapping as the reference's for every (arch,
  shape) of ``runnable_shapes`` and every kind, on the production, the
  two-pod and small meshes (``AbstractMesh`` stands in for the
  reference's: it reads only ``shape`` and ``axis_names``).
* ``local_block``: the blocks of every rank tile the tensor at (data,
  model) in {(1, 2), (1, 4), (2, 2)}; ``param_blocks`` of reduced
  qwen3-moe and grok-1 tile each parameter, but for the KV heads, which a
  rank takes whole.
* the decode cache's specs: the reference's (sequence on ``kv_seq``) and
  the port's (its KV heads), both pinned.
* ``zero1_extend_spec`` and ``opt_state_specs`` against the reference's.
"""

import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as r_get_config
from repro.configs.base import runnable_shapes as r_runnable_shapes
from repro.launch import sharding as r_sharding
from repro.launch import specs as r_specs
from repro.models import transformer as RT
from repro.train import optimizer as r_opt
from repro_torch.configs.base import SHAPES, get_config, list_archs, reduced
from repro_torch.launch import sharding, specs
from repro_torch.launch.mesh import (MeshShape, ModelGrid, ModelGroup,
                                     make_production_mesh)
from repro_torch.models import attention as attn
from repro_torch.models.transformer import Transformer, param_blocks
from repro_torch.train import optimizer as opt

META = torch.device("meta")
ARCHS = [a for a in list_archs() if a != "ringo-graph"]   # no model
PROD = {"data": 16, "model": 16, "pod": 2}
# (two_d_weights, expert_axis_parallel): None is the production policy,
# experts on "model" when 16 divides them
RULES = {"policy": (False, None), "policy-2d": (True, None),
         "ep": (False, True), "no-ep": (False, False), "2d-ep": (True, True)}
GRIDS = [(1, 2), (1, 4), (2, 2)]


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = r_get_config(arch)
    return jax.eval_shape(lambda: RT.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dict(Transformer(get_config(arch), device=META).named_parameters())


def _full(spec, ndim):
    """A reference spec (a ``PartitionSpec``) as a tuple of ``ndim``."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _flat(spec):
    return [a for ax in spec if ax is not None
            for a in (ax if isinstance(ax, tuple) else (ax,))]


@pytest.mark.parametrize("variant", list(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, variant):
    two_d, eap = RULES[variant]
    cfg = get_config(arch)
    if eap is None:
        eap = cfg.n_experts > 0 and cfg.n_experts % 16 == 0
    r_rules = r_sharding.default_rules(None, two_d_weights=two_d,
                                       expert_axis_parallel=eap)
    rules = sharding.default_rules(None, two_d_weights=two_d,
                                   expert_axis_parallel=eap)
    shapes = _ref_shapes(arch)
    r_specs_tree = r_sharding.param_specs(shapes, r_rules)
    ref = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(shapes),
            jax.tree_util.tree_leaves(
                r_specs_tree, is_leaf=lambda x: isinstance(x, P))):
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        ref[key] = (leaf.shape, _full(spec, leaf.ndim))
    params = _port_params(arch)
    got = sharding.param_specs(params, rules)
    seen = set()
    for name, p in params.items():
        path = sharding.param_path(name)
        r_shape, r_spec = ref[path]
        seen.add(path)
        lead = len(r_shape) - p.dim()
        assert r_shape[lead:] == tuple(p.shape), name
        assert r_spec[:lead] == (None,) * lead, (name, r_spec)
        assert got[name] == r_spec[lead:], (name, got[name], r_spec)
        flat = _flat(got[name])
        assert len(flat) == len(set(flat)), (name, got[name])
        if variant.startswith("policy"):
            for dim, ax in zip(p.shape, got[name]):
                n = int(np.prod([PROD[a] for a in _flat((ax,))]))
                assert dim % n == 0, (name, tuple(p.shape), got[name])
    assert seen == set(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_matches_reference(arch):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    meshes = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
              ((4, 4), ("data", "model"))]
    for (sizes, names), (sname, shape) in itertools.product(
            meshes, r_runnable_shapes(r_cfg).items()):
        r_mesh = AbstractMesh(sizes, names)
        mesh = MeshShape(names, sizes)
        for kind in ("train", "prefill", "decode"):
            for s in (shape, None):
                want = r_specs.rules_for(r_cfg, r_mesh, kind, s).mapping
                got = specs.rules_for(cfg, mesh, kind, s).mapping
                assert got == want, (sizes, sname, kind)
        assert specs.is_giant(cfg, sizes[-1]) == \
            r_specs.is_giant(r_cfg, sizes[-1])


def _coords(data, model):
    for d, m in itertools.product(range(data), range(model)):
        yield {"data": (d, data), "model": (m, model)}


def _offsets(t_shape, spec, coords):
    """The slices of the full tensor a block covers."""
    out = []
    for dim, entry in enumerate(spec):
        index, count = 0, 1
        for ax in _flat((entry,)):
            i, n = coords[ax]
            index, count = index * n + i, count * n
        size = t_shape[dim] // count
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_local_blocks_tile_the_tensor(grid):
    data, model = grid
    t = torch.arange(8 * 12 * 16, dtype=torch.float32).reshape(8, 12, 16)
    for spec in [(None, "model", None), ("data", None, "model"),
                 (("data", "model"), None, None), (None, None, None),
                 ("model",), (None, ("data", "model"))]:
        full = (None,) * (3 - len(spec)) + spec
        back = torch.full_like(t, -1.0)
        covered = torch.zeros_like(t)
        for c in _coords(data, model):
            blk = sharding.local_block(t, spec, c)
            sl = _offsets(t.shape, full, c)
            assert torch.equal(blk, t[sl]), (spec, c)
            back[sl] = blk
            covered[sl] += 1
        n_copies = data * model // int(np.prod(
            [grid[("data", "model").index(a)] for a in _flat(full)] or [1]))
        assert torch.equal(back, t) and bool((covered == n_copies).all()), \
            spec
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_block(torch.zeros(3, 4), ("model", None),
                             {"model": (0, 2)})


# reduced configs whose heads would split evenly get counts that do not
UNEVEN_HEADS = {"qwen1.5-4b": {"n_heads": 6, "n_kv_heads": 6},
                "whisper-small": {"n_heads": 3, "n_kv_heads": 3},
                "internvl2-26b": {"n_heads": 6, "n_kv_heads": 2}}


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b",
                                  "qwen1.5-4b", "whisper-small",
                                  "internvl2-26b"])
def test_param_blocks_tile_each_parameter(arch, grid):
    """Every rank's blocks of every parameter of reduced ``arch``, by its
    spec: they tile the tensor.  Attention: each rank holds whole heads,
    its ``head_range``'s query heads (``wq``'s columns and bias, ``wo``'s
    rows; the spec's block where the heads split evenly) and the KV heads
    they read; every head is held by someone, a query head by one rank."""
    data, model = grid
    cfg = reduced(get_config(arch), **UNEVEN_HEADS.get(arch, {}))
    full = dict(Transformer.init_params(cfg, device="cpu").named_parameters())
    rules = specs.rules_for(cfg, MeshShape(("data", "model"), grid),
                            "prefill")
    hd, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    heads_held, q_held = set(), []
    for c in _coords(data, model):
        blocks = param_blocks(cfg, c, rules)
        r = c["model"][0]
        lo, hi = attn.head_range(h, model, r)
        if c["data"][0] == 0:
            q_held.extend(range(lo, hi))
        for name, p in full.items():
            meta, spec, keep = blocks[name]
            assert meta.shape == p.shape and meta.device.type == "meta"
            blk = keep(p.detach())
            if name.endswith(("attn.wk.w", "attn.wv.w", "attn.wk.b",
                              "attn.wv.b")):
                klo, khi = attn.kv_head_range(h, hkv, model, r)
                assert torch.equal(blk, p[..., klo * hd:khi * hd]), name
                heads_held.update(range(klo, khi))
                continue
            if name.endswith(("attn.wq.w", "attn.wq.b", "attn.wo.w")):
                cols = slice(lo * hd, hi * hd)
                want = p[cols] if name.endswith(("wq.b", "wo.w")) \
                    else p[:, cols]
                assert torch.equal(blk, want), name
                if h % model:
                    continue
            assert torch.equal(blk, p[_offsets(p.shape, spec, c)]), name
    assert heads_held == set(range(hkv))
    assert sorted(q_held) == list(range(h))


def test_decode_cache_specs_pin_both_layouts():
    """The reference's decode cache puts the sequence on ``kv_seq``
    ("model") and no heads; the port's puts its KV heads on "model" and
    keeps the sequence whole."""
    r_cfg = r_get_config("qwen2.5-3b")
    s = r_runnable_shapes(r_cfg)["decode_32k"]
    r_mesh = jax.make_mesh((1, 1), ("data", "model"))
    r_rules = r_specs.rules_for(r_cfg, r_mesh, "decode", s)
    _, r_cache = r_specs.cache_structs(r_cfg, s, r_mesh, r_rules)
    # a PartitionSpec reads ("data",) back as "data"
    assert tuple(r_cache["attn"]["k"]) == (None, "data", "model", None, None)
    cfg = get_config("qwen2.5-3b")
    mesh = make_production_mesh()
    rules = specs.rules_for(cfg, mesh, "decode", s)
    cache, c_specs = specs.cache_structs(cfg, s, mesh, rules)
    assert c_specs["attn"]["k"] == (None, ("data",), None, "model", None)
    # 2 KV heads over 16 model ranks: each rank holds the one it reads
    assert tuple(cache["attn"]["k"].shape) == (cfg.n_layers, 128 // 16,
                                               s.seq_len, 1, 128)
    assert cache["attn"]["k"].device.type == "meta"


def test_zero1_and_opt_state_specs_match_reference():
    mesh = make_production_mesh()
    r_mesh = AbstractMesh((16, 16), ("data", "model"))
    rng = np.random.default_rng(0)
    axes = [None, "model", "data", ("data", "model")]
    for _ in range(200):
        nd = int(rng.integers(0, 4))
        shape = tuple(int(rng.choice([1, 8, 16, 32, 48, 4096]))
                      for _ in range(nd))
        spec = tuple(axes[int(i)] for i in rng.integers(0, 4, nd))
        if len(_flat(spec)) != len(set(_flat(spec))):
            continue
        want = r_opt.zero1_extend_spec(P(*spec), shape, r_mesh)
        assert opt.zero1_extend_spec(spec, shape, mesh) == \
            _full(want, nd), (spec, shape)
    cfg = reduced(get_config("qwen2.5-3b"))
    params = dict(Transformer(cfg, device=META).named_parameters())
    p_specs = sharding.param_specs(params, sharding.default_rules())
    for name in ("adamw", "adafactor"):
        state = opt.get_optimizer(name).init(params)
        got = opt.opt_state_specs(name, p_specs, state, mesh)
        leaves = (((part, k), t) for part in ("m", "v")
                  for k, t in state[part].items()) if name == "adamw" \
            else (((k, n), t) for k, f in state["f"].items()
                  for n, t in f.items())
        for (a, b), t in leaves:
            spec = p_specs[b] if name == "adamw" else ()
            want = _full(r_opt.zero1_extend_spec(P(*spec), t.shape, r_mesh),
                         t.dim())
            have = got[a][b] if name == "adamw" else got["f"][a][b]
            assert have == want, (name, a, b)


def test_input_specs_cover_each_kind():
    """Every kind's structs are meta tensors with a spec of their rank
    each; the train kind's optimizer state is cut by its ZeRO-1 specs."""
    cfg = get_config("qwen2.5-3b")
    mesh = make_production_mesh()
    for kind in ("train", "prefill", "decode"):
        shape = {"train": "train_4k", "prefill": "prefill_32k",
                 "decode": "decode_32k"}[kind]
        rules, structs, spec_trees = specs.input_specs(cfg, SHAPES[shape],
                                                       mesh)

        def walk(a, b):
            if isinstance(a, dict):
                assert set(a) == set(b)
                for k in a:
                    walk(a[k], b[k])
            else:
                assert a.device.type == "meta" and len(b) == a.dim(), (a, b)

        for a, b in zip(structs, spec_trees):
            walk(a, b)
    p, o, batch, _ = specs.input_specs(cfg, SHAPES["train_4k"], mesh)[1]
    w = "layers.0.mlp.wi.w"
    assert tuple(p[w].shape) == (2048, 11008 // 16)
    # m: ("data" over d_model by ZeRO-1, "model" over ff)
    assert tuple(o["m"][w].shape) == (2048 // 16, 11008 // 16)
    assert tuple(batch["tokens"].shape) == (256 // 16, 4096)


def test_grid_and_mesh_shapes():
    grid = ModelGrid(ModelGroup(2, 1), ModelGroup(4, 3))
    assert grid.shape == {"data": 2, "model": 4} and grid.size == 8
    assert grid.coords == {"data": (1, 2), "model": (3, 4)}
    assert make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="no process group"):
        grid.model.psum(torch.ones(2))
    one = ModelGrid(ModelGroup(1, 0), ModelGroup(1, 0))
    x = torch.ones(3)
    assert one.model.psum(x) is x and one.data.all_gather_dim(x, 0) is x


def _one(spec):
    """A spec with each one-axis tuple as its axis (the same split)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def test_rules_ctx_sets_logical_specs_and_not_a_models_rules():
    logicals = [("batch", "seq", "heads", None), ("embed", "ff"),
                ("experts", "embed", "ff"), ("batch", "kv_seq", "kv_heads")]
    variants = [dict(), dict(multi_pod=True, kv_seq_axis="model"),
                dict(two_d_weights=True, expert_axis_parallel=False)]
    assert sharding.logical_to_spec(("batch",)) is None
    assert r_sharding.logical_to_spec(("batch",)) is None
    for kw in variants:
        rules, r_rules = (sharding.default_rules(None, **kw),
                          r_sharding.default_rules(None, **kw))
        with sharding.rules_ctx(rules), r_sharding.rules_ctx(r_rules):
            assert sharding.current_rules() is rules
            for lg in logicals:
                assert _one(sharding.logical_to_spec(lg)) == \
                    _one(_full(r_sharding.logical_to_spec(lg), len(lg))), \
                    (kw, lg)
    assert sharding.current_rules() is None
    # a model takes its rules from Transformer(rules=) or rules_for only
    cfg = reduced(get_config("qwen2.5-3b"))
    one = ModelGrid(ModelGroup(1, 0), ModelGroup(1, 0))
    other = sharding.default_rules(None, kv_seq_axis="model")
    with sharding.rules_ctx(other):
        model = Transformer(cfg, device=META, group=one)
    assert model.rules.mapping == \
        specs.rules_for(cfg, one, "prefill").mapping != other.mapping
    assert Transformer(cfg, device=META, group=one, rules=other).rules \
        is other
