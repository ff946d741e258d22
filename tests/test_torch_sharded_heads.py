"""Attention over model ranks whose heads do not split evenly, and the
audio and vlm families sharded, against the reference's unsharded model on
the CPU.

Rank r of m holds a contiguous range of whole query heads, the first H % m
ranks one more (``models/attention.head_range``), and the KV heads those
read; a rank with no head launches no K4 and adds zeros to ``wo``'s sum.
Reduced configs whose heads would divide get head counts that do not
(``dataclasses.replace`` through ``reduced``'s overrides; vocab 256 and
d_ff 128 still split):

* qwen1.5-4b with 6 heads (MHA, QKV bias): 2, 2, 1, 1 over 4 ranks;
* qwen1.5-4b with 10 query and 2 KV heads: 3, 3, 2, 2, rank 1's heads
  reading KV heads 0, 0, 1 (a range that straddles a KV head, read
  through ``kv_index``);
* whisper-small with 3 heads: 1, 1, 1 and none on rank 3 (encoder,
  decoder self- and cross-attention);
* internvl2-26b with 6 query and 2 KV heads behind its patch prefix.

Two spawned gloo worlds of 4 ranks (``_torch_worlds.heads_job``), grids
(1, 4) and (2, 2); each rank takes its data shard's rows of 4.  Held, on
every rank, within 1e-5 of the largest value of the reference's
(float32): ``forward``'s logits; ``prefill``'s last logits and 3
teacher-forced ``decode_step``s; ``loss_fn``'s loss (the mean over data
shards) and every parameter's whole gradient, gathered after the train
step's model-axis sums and data reduction; and, as
``tests/test_torch_sharded_train.py`` holds the optimizer, the gradient
norm and every parameter after one sharded AdamW update of the
reference's gradients within 1e-6 of the reference's clipping and update.
Also held: the head ranges tile the query heads and each rank's KV heads
are the ones it reads, at the production splits; the headless branch runs
on the rank with no head only; rank 0's parameters and cache have the
shapes ``launch.specs.input_specs`` gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from _torch_worlds import heads_job, run_world
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as RT
from repro.train import optimizer as r_opt
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import attention as attn
from repro_torch.models.transformer import Transformer

torch.set_num_threads(2)

B, S, N_DEC = 4, 12, 3
TOL = 1e-5          # of the largest |value| of the reference's
UPDATE_TOL = 1e-6   # parameters after one update of the same gradients
# (tag, arch, overrides)
CASES = [("qwen1.5-4b", "qwen1.5-4b", {"n_heads": 6, "n_kv_heads": 6}),
         ("qwen1.5-4b-gqa", "qwen1.5-4b", {"n_heads": 10, "n_kv_heads": 2}),
         ("whisper-small", "whisper-small", {"n_heads": 3, "n_kv_heads": 3}),
         ("internvl2-26b", "internvl2-26b", {"n_heads": 6, "n_kv_heads": 2})]
IDS = [c[0] for c in CASES]
GRIDS = [(1, 4), (2, 2)]
# (H, Hkv, m): the production splits, and GQA ranges that straddle a KV head
SPLITS = [(20, 20, 16), (20, 20, 8), (12, 12, 16), (12, 12, 8), (48, 8, 16),
          (10, 2, 4), (16, 4, 5)]


@pytest.mark.parametrize("h,hkv,m", SPLITS,
                         ids=[f"{h}-{k}-over-{m}" for h, k, m in SPLITS])
def test_head_ranges_tile_and_read_their_kv_heads(h, hkv, m):
    group = h // hkv
    ranges = [attn.head_range(h, m, r) for r in range(m)]
    assert ranges[0][0] == 0 and ranges[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert sizes == sorted(sizes, reverse=True) and \
        max(sizes) - min(sizes) <= 1
    straddles = 0
    held = set()
    for r, (lo, hi) in enumerate(ranges):
        klo, khi = attn.kv_head_range(h, hkv, m, r)
        assert set(range(klo, khi)) == {i // group for i in range(lo, hi)}
        held.update(range(klo, khi))
        idx = attn.kv_index(h, hkv, m, r)
        n = hi - lo
        local = idx if idx is not None else \
            tuple(j // (n // (khi - klo)) for j in range(n)) if n else ()
        assert tuple(klo + j for j in local) == \
            tuple(i // group for i in range(lo, hi)), r
        straddles += idx is not None
    assert held == set(range(hkv))
    # the splits whose ranges straddle a KV head unevenly, mapped head by
    # head
    assert (straddles > 0) == ((h, hkv, m) in ((10, 2, 4), (16, 4, 5)))


def _configs(arch, over):
    return r_reduced(r_get_config(arch), **over), \
        reduced(get_config(arch), **over)


def _batch(cfg, rng, s):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.normal(size=(B, cfg.enc_seq_len, cfg.d_model)
                                       ).astype(np.float32)
    if cfg.n_patches:
        out["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)
                                         ).astype(np.float32)
    return out


def _named(cfg, tree):
    """A reference pytree as the port's ``{parameter name: array}``."""
    return {k: p.detach().numpy().copy() for k, p in Transformer.from_arrays(
        cfg, jax.tree.map(np.asarray, tree), device="cpu").named_parameters()}


@pytest.fixture(scope="module")
def ref():
    """Per case: the arrays and inputs; the reference's forward logits,
    loss and gradients, prefill and decode logits, and its gradient norm
    and parameters after clipping and one AdamW update of its
    gradients."""
    out = {}
    for i, (tag, arch, over) in enumerate(CASES):
        r_cfg, cfg = _configs(arch, over)
        arrays = lm_arrays(r_cfg)
        params = jax.tree.map(jnp.asarray, arrays)
        rng = np.random.default_rng(i)
        batch = _batch(cfg, rng, S)
        batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        prompt = _batch(cfg, rng, S)
        teacher = rng.integers(0, cfg.vocab_size, (B, N_DEC)).astype(np.int32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, _ = jax.jit(lambda p, b: RT.forward(p, r_cfg, b))(
            params, {k: v for k, v in jb.items() if k != "targets"})
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: RT.loss_fn(p, r_cfg, b), has_aux=True))(params, jb)
        n_prompt = S + cfg.n_patches
        max_seq = n_prompt + N_DEC + 2
        pre, cache = jax.jit(lambda p, b: RT.prefill(p, r_cfg, b, max_seq))(
            params, {k: jnp.asarray(v) for k, v in prompt.items()})
        enc = RT._encoder_forward(params, r_cfg,
                                  jnp.asarray(prompt["enc_embeds"])) \
            if cfg.is_encoder_decoder else None
        dec = jax.jit(lambda p, c, t, pos, e: RT.decode_step(
            p, r_cfg, c, t, pos, enc_out=e))
        steps = [np.asarray(pre)[:, -1]]
        for j in range(N_DEC):
            d, cache = dec(params, cache, jnp.asarray(teacher[:, j:j + 1]),
                           jnp.int32(n_prompt + j), enc)
            steps.append(np.asarray(d)[:, 0])

        def update(p, g):
            g, norm = r_opt.clip_by_global_norm(g, 1.0)
            opt = r_opt.get_optimizer(r_cfg.optimizer)
            p, _ = opt.update(p, g, opt.init(p), jnp.int32(0),
                              r_opt.OptHyper())
            return p, norm
        after, norm = jax.jit(update)(params, grads)
        out[tag] = {"over": dict(arch=arch, **over), "arrays": arrays,
                    "batch": batch, "prompt": prompt, "teacher": teacher,
                    "forward": np.asarray(logits), "loss": float(loss),
                    "grads": _named(cfg, grads), "steps": np.stack(steps, 1),
                    "grad_norm": float(norm), "params_1": _named(cfg, after)}
    return out


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def world(request, ref, tmp_path_factory):
    data, model = request.param
    cases = [(tag, r["over"], r["arrays"], r["batch"], r["prompt"],
              r["teacher"], r["grads"]) for tag, r in ref.items()]
    res = run_world(heads_job, data * model,
                    tmp_path_factory.mktemp(f"heads{data}x{model}"), data,
                    model, cases)
    return data, model, res


def _rows(a, data, di):
    n = a.shape[0] // data
    return a[di * n:(di + 1) * n]


def _close(got, want, what, tol=TOL):
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("case", IDS)
def test_forward_matches_reference(world, ref, case):
    data, _, res = world
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        _close(out[case]["forward"], _rows(ref[case]["forward"], data, di),
               f"rank {rank} forward")


@pytest.mark.parametrize("case", IDS)
def test_prefill_and_decode_match_reference(world, ref, case):
    data, _, res = world
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        _close(out[case]["steps"], _rows(ref[case]["steps"], data, di),
               f"rank {rank} prefill and decode")


@pytest.mark.parametrize("case", IDS)
def test_loss_and_gradients_match_reference(world, ref, case):
    """The loss averaged over the data shards and every whole gradient,
    as the train step reduces it (each KV head summed over the ranks that
    hold it), equal the reference's of the whole batch."""
    _, _, res = world
    want = ref[case]
    for rank, out in enumerate(res):
        got = out[case]
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"]), \
            rank
        assert set(got["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            assert got["grads"][k].shape == g.shape, (rank, k)
            _close(got["grads"][k], g, f"rank {rank} gradient {k}")


@pytest.mark.parametrize("case", IDS)
def test_update_of_given_gradients_matches_reference(world, ref, case):
    """The global norm counts each position once (a shared KV head by its
    first holder) and the checkpoint gather puts each rank's heads back in
    place: the norm and every parameter after one update."""
    _, _, res = world
    want = ref[case]
    for rank, out in enumerate(res):
        got = out[case]
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            TOL * want["grad_norm"], rank
        for k, p in want["params_1"].items():
            np.testing.assert_allclose(got["params_1"][k], p, rtol=0,
                                       atol=UPDATE_TOL,
                                       err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", IDS)
def test_heads_held_and_meta_shapes(world, ref, case):
    """Each rank holds its ``head_range``'s query heads and the KV heads
    they read; only a rank with no head takes the headless branch; rank
    0's parameters and cache are ``input_specs``' meta shapes."""
    _, model, res = world
    cfg = reduced(get_config(ref[case]["over"]["arch"]),
                  **{k: v for k, v in ref[case]["over"].items()
                     if k != "arch"})
    for out in res:
        got = out[case]
        r = out["coords"]["model"][0]
        lo, hi = attn.head_range(cfg.n_heads, model, r)
        klo, khi = attn.kv_head_range(cfg.n_heads, cfg.n_kv_heads, model, r)
        assert (got["heads"], got["kv_heads"]) == (hi - lo, khi - klo)
        assert (got["no_head_calls"] > 0) == (hi == lo), (r, got)
        assert got["cache_shapes"]["k"][3] == khi - klo
        if r == 0:
            assert got["param_shapes"] == got["param_meta"]
            assert got["cache_shapes"] == got["cache_meta"]
    if case == "whisper-small" and model == 4:
        assert res[3]["coords"]["model"][0] == 3 and \
            res[3][case]["heads"] == 0
