"""Phase 4l of ``chip_smoke.py`` rehearsed on the CPU: the xLSTM, whisper,
VLM and hybrid families trained over model ranks, headless ranks included,
under ``remat="full"`` (the card's setting; the other multi-rank tests
train with ``reduced``'s ``remat="none"``).

One spawned gloo world of 4 ranks (``_torch_worlds.family_train_job``)
runs the phase's own rank function (``family_train_world``) on four
reduced configs, two train steps each, each over (1, m) on ranks 0..m-1:

* whisper-small with 3 heads over (1, 4): rank 3 holds no head, so its
  attention takes ``attention._no_head`` in every encoder, self- and
  cross-attention call, in the forward and in the recompute;
* xlstm-350m with 2 mLSTM heads over (1, 3): rank 2 takes the mLSTM's
  ``_no_head``; the sLSTM's channels split three ways, its ``h`` gathered
  each step;
* internvl2-26b with 6 query and 2 KV heads over (1, 2), 4 patches;
* jamba-1.5-large-398b in one period of ``attn_every = 2`` (a Mamba with
  its MLP, then attention with an ``expert_tp`` MoE of 4 experts),
  Adafactor, over (1, 2): a period no other test trains;
* starcoder2-15b with 4 query heads and 1 KV head over (1, 4): the one KV
  head held by all four ranks, its gradient (``wk``, ``wv`` and their
  biases) summed over them (``train/zero._reduce``, ``_sum_ranges``);
* mistral-nemo-12b with 4 query heads, 2 KV heads and ``head_dim=32``
  over (1, 4): each KV head held by a pair of ranks, and a query width
  (128) unlike d_model (64).

Held, in float32: each rank's loss at each step within 1e-5 (relative)
of the phase's one-rank run (``family_train_one_rank``) on the same
seed-0 weights and batches, and that run's within 1e-5 of the
reference's ``loss_fn`` on the same weights (step 1: the one-rank run's
weights after step 0); step 0's gradient norm within 1e-4; each step's
collectives by phase against ``family_train_collectives``; the headless
calls and K4's calls by shape against the phase's predictions; the
reckoning's parameter, gradient and state bytes against what rank 0 (the
most heads) holds; and the phase's own checks (``family_train_check``),
which must also refuse a record with one collective too few.  Where KV
heads are shared, the phase's per-leaf check (``leaf_grad_gaps``): each
rank's step-0 gradient of every KV leaf and of layer 0's ``wq``, after
the model-axis sums and before clipping, within 1e-5 (relative L2) of
the reference's ``jax.grad`` cut to the rank's block, and the one-rank
run's recorded gradients within 1e-5 of it too; after each step the
holders of a KV head hold the same bits of it and of its AdamW state.
A second world plants the fault the per-leaf check is for (the shared
leaves' model-axis sum skipped, ``_torch_worlds.family_train_unsummed_
job``): the check refuses it.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_worlds import (family_train_job, family_train_unsummed_job,
                           run_world)
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as RT
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import ModelGrid, ModelGroup
from repro_torch.models import attention as attn
from repro_torch.models.transformer import Transformer
from repro_torch.train import zero

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

B, S, STEPS = 2, 8, 2
TOL = 1e-5          # losses, relative
NORM_TOL = 1e-4     # step 0's gradient norm, relative
RANKS = 4
WORLD_SECONDS = 240.0
# (label, arch, model ranks m, overrides)
CASES = [
    ("whisper", "whisper-small", 4, {"n_heads": 3, "n_kv_heads": 3}),
    ("xlstm", "xlstm-350m", 3,
     {"d_model": 48, "n_heads": 2, "n_kv_heads": 2, "vocab_size": 384}),
    ("vlm", "internvl2-26b", 2, {"n_heads": 6, "n_kv_heads": 2}),
    ("jamba", "jamba-1.5-large-398b", 2,
     {"d_model": 48, "n_heads": 6, "n_kv_heads": 2, "d_ff": 96,
      "vocab_size": 384, "attn_every": 2, "n_layers": 2,
      "moe_impl": "expert_tp", "capacity_factor": 1.25}),
    ("starcoder", "starcoder2-15b", 4, {"n_heads": 4, "n_kv_heads": 1}),
    ("mistral", "mistral-nemo-12b", 4,
     {"n_heads": 4, "n_kv_heads": 2, "head_dim": 32}),
]
SHARED = ["starcoder", "mistral"]     # KV heads held by several ranks
IDS = [c[0] for c in CASES]
SPEC = {c[0]: c for c in CASES}


def _cfg(label):
    _, arch, _, over = SPEC[label]
    return reduced(get_config(arch), remat="full", **over)


def _r_cfg(label):
    _, arch, _, over = SPEC[label]
    return r_reduced(r_get_config(arch), remat="full", **over)


def _records(job, labels, batches, work):
    """The ranks' records of the cases ``labels`` from one world of
    ``job``, by label (ranks 0..m-1), each with its recorded gradients
    (``grads``) where the rank wrote them."""
    jobs = [(label, _cfg(label), SPEC[label][2], batches[label])
            for label in labels]
    res = run_world(job, RANKS, work, str(work), jobs, timeout=WORLD_SECONDS)
    per = {label: [next(i for i in res[r] if i["label"] == label)
                   for r in range(SPEC[label][2])] for label in labels}
    for label, infos in per.items():
        for info in infos:
            f = work / f"rank{info['rank']}_{label}_grads.pt"
            if f.exists():
                info["grads"] = torch.load(f)
    return per


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' records by label (ranks 0..m-1), the batches and the
    one-rank run of each case (with its weights before each step, and
    where KV heads are shared its step-0 gradients)."""
    batches = {label: cs.family_train_batches(_cfg(label), B, S, STEPS)
               for label in IDS}
    per = _records(family_train_job, IDS, batches,
                   tmp_path_factory.mktemp("family_train"))
    one = {label: cs.family_train_one_rank("cpu", _cfg(label),
                                           batches[label], arrays=True,
                                           grads=label in SHARED)
           for label in IDS}
    return per, batches, one


@pytest.fixture(scope="module")
def unsummed(world, tmp_path_factory):
    """The shared-KV cases' records from a world whose sharded step skips
    the model-axis sum of the shared KV leaves."""
    _, batches, _ = world
    return _records(family_train_unsummed_job, SHARED, batches,
                    tmp_path_factory.mktemp("family_train_unsummed"))


def _reference_grads(label, one, batches):
    """The reference's ``jax.grad`` of ``loss_fn`` at step 0 (the one-rank
    run's weights before it, batch 0), as the port's named leaves."""
    r_cfg = _r_cfg(label)
    grad = jax.jit(jax.grad(lambda p, b: RT.loss_fn(p, r_cfg, b)[0]))
    g = grad(jax.tree.map(jnp.asarray, one[label]["arrays"][0]),
             {k: jnp.asarray(v.numpy())
              for k, v in batches[label][0].items()})
    model = Transformer.from_arrays(_cfg(label), jax.tree.map(np.asarray, g),
                                    device="cpu")
    return {k: p.detach() for k, p in model.named_parameters()}


@pytest.mark.parametrize("label", IDS)
def test_losses_match_one_rank_and_reference(world, label):
    per, batches, one = world
    r_cfg = _r_cfg(label)
    loss = jax.jit(lambda p, b: RT.loss_fn(p, r_cfg, b)[0])
    for i, batch in enumerate(batches[label]):
        want = float(loss(jax.tree.map(jnp.asarray,
                                       one[label]["arrays"][i]),
                          {k: jnp.asarray(v.numpy())
                           for k, v in batch.items()}))
        got = one[label]["steps"][i]["loss"]
        assert abs(got - want) <= TOL * abs(want), (i, got, want)
        for info in per[label]:
            g = info["steps"][i]["loss"]
            assert abs(g - got) <= TOL * abs(got), (info["rank"], i, g, got)


@pytest.mark.parametrize("label", IDS)
def test_gradient_norms_match_one_rank(world, label):
    per, _, one = world
    want = one[label]["steps"][0]["grad_norm"]
    for info in per[label]:
        got = info["steps"][0]["grad_norm"]
        assert np.isfinite(got) and abs(got - want) <= NORM_TOL * want, (
            info["rank"], got, want)


@pytest.mark.parametrize("label", IDS)
def test_collectives_by_phase_match_the_formula(world, label):
    per, _, _ = world
    cfg, m = _cfg(label), SPEC[label][2]
    meta = Transformer(cfg, device="meta", group=ModelGrid(
        ModelGroup(1, 0), ModelGroup(m, 0)))
    want = {ph: n for ph, n in cs.family_train_collectives(
        cfg, S, zero.layout(meta)).items() if n}
    assert want["forward"] and want["recompute"] and want["backward"]
    for info in per[label]:
        for i, step in enumerate(info["steps"]):
            got = {ph: c["calls"] for ph, c in step["collectives"].items()}
            assert got == want, (info["rank"], i, got, want)


@pytest.mark.parametrize("label", IDS)
def test_headless_and_k4_calls_match_the_prediction(world, label):
    per, _, _ = world
    cfg, m = _cfg(label), SPEC[label][2]
    headless = 0
    for info in per[label]:
        lo, hi = attn.head_range(cfg.n_heads, m, info["rank"])
        assert info["heads"] == hi - lo
        headless += hi == lo
        want_k4 = cs.family_train_want_k4(cfg, hi - lo, B, S)
        for step in info["steps"]:
            assert step["no_head_calls"] == cs.family_train_no_head(
                cfg, hi - lo), (info["rank"], step["no_head_calls"])
            got = {(tuple(c[0]), tuple(c[1]), c[2], c[3]): c[4]
                   for c in step["k4_calls"]}
            assert got == want_k4, (info["rank"], got, want_k4)
            assert step["k4_launches"] == 0     # the CPU runs the plain K4
    # whisper's rank 3 and xlstm's rank 2 hold no head
    assert headless == {"whisper": 1, "xlstm": 1}.get(label, 0)


@pytest.mark.parametrize("label", IDS)
def test_reckoning_parts_match_what_a_rank_holds(world, label):
    per, _, _ = world
    cfg, m = _cfg(label), SPEC[label][2]
    reck = cs.family_train_reckoning(cfg, m, B, S)
    got = per[label][0]
    assert (reck["params"], reck["grads"], reck["state"]) == (
        got["param_bytes_held"], got["grad_bytes"], got["state_bytes"])
    assert reck["rank"] >= reck["params"] + reck["grads"] + reck["state"] \
        + reck["logits"] + reck["activations"]


@pytest.mark.parametrize("label", IDS)
def test_the_phase_checks_pass_and_refuse_a_missing_collective(world,
                                                               label):
    per, _, one = world
    cfg, m = _cfg(label), SPEC[label][2]
    out = cs.family_train_check(label, cfg, m, B, S, per[label],
                                one[label]["steps"], TOL, NORM_TOL, False)
    assert out["loss_gap_over_one_rank"] <= TOL
    bad = copy.deepcopy(per[label])
    bad[-1]["steps"][1]["collectives"]["backward"]["calls"] -= 1
    with pytest.raises(RuntimeError, match="collectives"):
        cs.family_train_check(label, cfg, m, B, S, bad, one[label]["steps"],
                              TOL, NORM_TOL, False)


@pytest.mark.parametrize("label", IDS)
def test_reckoning_counts_the_runs_rows_and_a_vlms_patches(label):
    """The logits' bytes follow the run's batch and tokens, the head's
    compute-dtype rows behind a VLM's patches too; the defaults are phase
    4b's batch, so phases 4h and 4i reckon as before."""
    cfg, m = _cfg(label), SPEC[label][2]
    item = 2 if cfg.compute_dtype == "bfloat16" else 4
    got = cs.sharded_train_reckoning(cfg, 1, m, batch=B, seq=S)["logits"]
    assert got == B * cfg.vocab_size * ((S + cfg.n_patches) * item + S * 8)
    assert cfg.n_patches == (4 if label == "vlm" else 0)
    default = cs.sharded_train_reckoning(cfg, 1, m)["logits"]
    assert default == cs.TRAIN_BATCH * cfg.vocab_size * (
        (cs.TRAIN_SEQ + cfg.n_patches) * item + cs.TRAIN_SEQ * 8)


@pytest.mark.parametrize("label", SHARED)
def test_shared_kv_gradients_per_leaf_match_the_reference(world, label):
    """Every rank records step 0's gradient of each KV leaf (summed over
    the ranks that share its head) and of layer 0's wq, each within 1e-5
    of the reference's ``jax.grad`` cut to the rank's block; the one-rank
    run's within 1e-5 of it whole; and the phase's own check against the
    one-rank run holds."""
    per, batches, one = world
    cfg, m = _cfg(label), SPEC[label][2]
    want = _reference_grads(label, one, batches)
    names = sorted(k for k in want if cs.family_train_grad_leaf(k))
    assert any(".wk.b" in k for k in names) == cfg.qkv_bias
    assert sorted(one[label]["grads"]) == names
    whole = {k: {"grad": g, "block": []}
             for k, g in one[label]["grads"].items()}
    assert max(cs.leaf_grad_gaps(whole, want).values()) <= TOL
    meta = Transformer(cfg, device="meta", group=ModelGrid(
        ModelGroup(1, 0), ModelGroup(m, 0)))
    assert cs.shares_kv(zero.layout(meta))
    gaps = []
    for info in per[label]:
        assert info["shares_kv"] and sorted(info["grads"]) == names
        gaps.append(cs.leaf_grad_gaps(info["grads"], want))
        assert max(gaps[-1].values()) <= TOL, (info["rank"], gaps[-1])
    cs.leaf_grad_check(label, [cs.leaf_grad_gaps(
        info["grads"], one[label]["grads"]) for info in per[label]],
        cs.FAMILY_TRAIN_GRAD_TOL)


def test_only_the_shared_kv_cases_record_gradients(world):
    per, _, _ = world
    for label in IDS:
        for info in per[label]:
            assert info["shares_kv"] == (label in SHARED), label
            assert ("grads" in info) == (label in SHARED), label


@pytest.mark.parametrize("label", SHARED)
def test_kv_holders_hold_equal_bits_of_the_block_and_its_adamw_state(
        world, label):
    """The holders of a KV head: all four ranks for starcoder2's one head,
    pairs for mistral-nemo's two; after each step they report the same
    checksums of the block and of its m and v, and the phase's check
    refuses a record where one holder's v differs."""
    per, _, one = world
    cfg, m = _cfg(label), SPEC[label][2]
    want = [(0, 1, 2, 3)] * 4 if label == "starcoder" else \
        [(0, 1), (0, 1), (2, 3), (2, 3)]
    key = "layers.0.attn.wk.w"
    for info in per[label]:
        assert tuple(info["holders"][key]) == want[info["rank"]]
        assert tuple(info["holders"][key + ":v"]) == want[info["rank"]]
        assert len(info["step_checksums"]) == STEPS
        for sums in info["step_checksums"]:
            assert sums[key] == sums[key] and key + ":m" in sums
    for i in range(STEPS):
        got = [info["step_checksums"][i][key + ":v"] for info in per[label]]
        assert all(got[r] == got[want[r][0]] for r in range(m))
    bad = copy.deepcopy(per[label])
    bad[1]["step_checksums"][1][key + ":v"][0] += 1
    with pytest.raises(RuntimeError, match="step 1: ranks differ"):
        cs.family_train_check(label, cfg, m, B, S, bad, one[label]["steps"],
                              TOL, NORM_TOL, False)


@pytest.mark.parametrize("label", SHARED)
def test_the_per_leaf_check_refuses_an_unsummed_kv_gradient(world,
                                                            unsummed,
                                                            label):
    """The fault planted: each rank keeps its own part of a shared KV
    head's gradient.  The KV leaves' gaps read ~0.7 (2 holders) and ~0.87
    (4), layer 0's wq (no rank shares it) is untouched, and the per-leaf
    check refuses the run."""
    per, _, one = world
    got = unsummed[label]
    gaps = [cs.leaf_grad_gaps(info["grads"], one[label]["grads"])
            for info in got]
    kv = [v for g in gaps for k, v in g.items() if ".attn.wq." not in k]
    wq = [v for g in gaps for k, v in g.items() if ".attn.wq." in k]
    assert min(kv) > 0.3 and max(wq) <= TOL, gaps
    with pytest.raises(RuntimeError, match="gradient per leaf"):
        cs.leaf_grad_check(label, gaps, cs.FAMILY_TRAIN_GRAD_TOL)
    # the loss and the norm alone would have passed it at the card's bf16
    # limits (phase 4l's (e) and (f)): step 0's loss is the same, step 1's
    # moved ~7e-5 and step 0's norm ~5e-3 here; only the float32 limits
    # of this file see it
    run = "e" if label == "starcoder" else "f"
    for info in got:
        loss = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
                for g, w in zip(info["steps"], one[label]["steps"])]
        want = one[label]["steps"][0]["grad_norm"]
        norm = abs(info["steps"][0]["grad_norm"] - want) / want
        assert max(loss) <= cs.FAMILY_TRAIN_LOSS_TOL[run] and \
            norm <= cs.FAMILY_TRAIN_NORM_TOL[run], (loss, norm)
        assert loss[0] <= TOL < loss[1] and norm > NORM_TOL, (loss, norm)
    # the honest run's records pass the same check
    cs.leaf_grad_check(label, [cs.leaf_grad_gaps(
        info["grads"], one[label]["grads"]) for info in per[label]],
        cs.FAMILY_TRAIN_GRAD_TOL)


def test_each_rank_frees_its_model_before_the_next_run(world):
    """A process's first train step under ``remat="full"`` leaves its model
    in a reference cycle (``torch.utils.checkpoint``'s first call); phase
    4l's ranks collect it before the next run draws its weights, which on
    the card ran out of memory when starcoder2-15b's 16 blocks outlived
    their run.  Every record says its model was freed, and the phase's
    check refuses one that was not."""
    per, _, one = world
    assert all(info["model_freed"] for infos in per.values()
               for info in infos)
    label = "mistral"
    bad = copy.deepcopy(per[label])
    bad[2]["model_freed"] = False
    with pytest.raises(RuntimeError, match="outlived"):
        cs.family_train_check(label, _cfg(label), SPEC[label][2], B, S, bad,
                              one[label]["steps"], TOL, NORM_TOL, False)


def test_reckoning_counts_the_draw_of_the_largest_leaf():
    """A rank's peak is the larger of its step's and of its weights' draw:
    its blocks beside one whole leaf in float32 (``layers.fill_normal_``).
    At mistral-nemo-12b's full width cut to 2 layers over (1, 16), phase
    4l's run (f), the draw of its 131,072 x 5,120 table is the larger: an
    H100 read each rank's peak 168 MB over a reckoning without it."""
    run = next(r for r in cs.FAMILY_TRAIN_RUNS if r[1] == "mistral-nemo-12b")
    _, arch, m, b, s, n_layers, over = run
    cfg = cs.sharded_train_config(arch, n_layers, over)
    reck = cs.family_train_reckoning(cfg, m, b, s)
    draw = 4 * 131072 * 5120
    assert reck["init_draw"] == draw
    assert reck["rank"] >= reck["params"] + draw + cs.WORKSPACE_BYTES
    assert reck["rank"] > 3228667904      # the peak read on the card
