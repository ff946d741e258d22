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
  Adafactor, over (1, 2): a period no other test trains.

Held, in float32: each rank's loss at each step within 1e-5 (relative)
of the phase's one-rank run (``family_train_one_rank``) on the same
seed-0 weights and batches, and that run's within 1e-5 of the
reference's ``loss_fn`` on the same weights (step 1: the one-rank run's
weights after step 0); step 0's gradient norm within 1e-4; each step's
collectives by phase against ``family_train_collectives``; the headless
calls and K4's calls by shape against the phase's predictions; the
reckoning's parameter, gradient and state bytes against what rank 0 (the
most heads) holds; and the phase's own checks (``family_train_check``),
which must also refuse a record with one collective too few.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_worlds import family_train_job, run_world
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
]
IDS = [c[0] for c in CASES]
SPEC = {c[0]: c for c in CASES}


def _cfg(label):
    _, arch, _, over = SPEC[label]
    return reduced(get_config(arch), remat="full", **over)


def _r_cfg(label):
    _, arch, _, over = SPEC[label]
    return r_reduced(r_get_config(arch), remat="full", **over)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' records by label (ranks 0..m-1), the batches and the
    one-rank run of each case (with its weights before each step)."""
    batches = {label: cs.family_train_batches(_cfg(label), B, S, STEPS)
               for label in IDS}
    jobs = [(label, _cfg(label), m, batches[label])
            for label, _, m, _ in CASES]
    work = tmp_path_factory.mktemp("family_train")
    res = run_world(family_train_job, RANKS, work, str(work), jobs,
                    timeout=WORLD_SECONDS)
    per = {label: [next(i for i in res[r] if i["label"] == label)
                   for r in range(m)] for label, _, m, _ in CASES}
    one = {label: cs.family_train_one_rank("cpu", _cfg(label),
                                           batches[label], arrays=True)
           for label in IDS}
    return per, batches, one


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
