"""The ssm and hybrid families over model ranks against the reference's
unsharded model on the CPU, and the dry run's count of the sLSTM's loop.

Reduced configs (``reduced`` with overrides) at widths that split over 2
and 3 ranks (vocab 384, d_model 48: an inner width of 96):

* xlstm-350m with 2 mLSTM heads: 1 and 1 over 2 ranks, 1, 1 and none over
  3 (rank 2 takes the headless branch); the sLSTM's 96 channels as 48 or
  32 a rank, its ``h`` gathered each step;
* jamba-1.5-large-398b with 6 query and 2 KV heads and d_ff 96: over 3
  ranks each holds 2 query heads and rank 1's read KV heads 0 and 1, a
  range that straddles a KV head, so Adafactor's sums count a position
  by its first holder (``train/zero.BlockMeans``, which raised there
  before); the Mamba's channels as 48 or 32 a rank, its B, C and dt
  summed once a call; the MoE's experts over "model" at 2 ranks, whole
  with their FFN split at 3.

Three spawned gloo worlds (``_torch_worlds.recurrent_job``), grids (1,
2), (1, 3) and (2, 2); each rank takes its data shard's rows of 4.  Held,
on every rank, in float32, as ``tests/test_torch_sharded_heads.py`` and
``tests/test_torch_sharded_train.py`` hold the other families: within
1e-5 of the largest value of the reference's, ``forward``'s logits and
``prefill``'s last logits and 3 teacher-forced ``decode_step``s;
``loss_fn``'s loss within 1e-5 relative and every whole gradient, after
the train step's model-axis sums and data reduction, to
``tests/test_torch_train.py``'s gradient tolerance (atol 1e-5, rtol 1e-4:
float32 products summed in other orders; the largest gap is 3.4e-6 at a
gradient scale of 0.47); the gradient norm (1e-5 relative) and every
parameter after one update of the reference's gradients within 1e-6 of
the reference's clipping and update (AdamW for xlstm, Adafactor for
jamba); and one ``make_train_step`` on the batch: its loss (1e-5) and
gradient norm (1e-4) against the reference's, its parameters within 1e-5
of the largest parameter against the port's one-rank step, and for
Adafactor against the reference's (an AdamW step's update of a near-zero
gradient turns on its rounding: the one-rank step is 1.7e-5 from the
reference's already, as ``tests/test_torch_sharded_train.py`` notes).
The port's one-rank model is held to the reference the same way.  Also
held: the collective calls of a prefill and of a decode step against
their formula; the headless branch on the rank with no head only; rank
0's parameters and cache have ``input_specs``' shapes; ``init_params``
over ranks draws the one-rank model's numbers; and with the weights 2-D
(``two_d_weights``: jamba's rule at the production mesh) the serving,
loss and gradients hold as above.

The loop's count: ``slstm_train`` under ``launch/hlo_cost.CostCounter``
on the meta device runs its first trip, one middle trip counted for all,
and its last; on CPU tensors it runs every trip.  Both counts agree in
flops, bytes, collective bytes, wire bytes and calls, at S = 64, served
and trained, alone and over a counting group of 2 model ranks (the
Mamba's and the mLSTM's chunk loops too), and for reduced xlstm's and
jamba's whole loss and backward under ``remat="full"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from _torch_worlds import recurrent_job, run_world
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as RT
from repro.train import optimizer as r_opt
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.hlo_cost import CostCounter
from repro_torch.launch.mesh import (CollectiveLedger, MeshShape,
                                     counting_grid)
from repro_torch.models import attention as attn
from repro_torch.models import ssm, xlstm
from repro_torch.models.transformer import Transformer
from repro_torch.train.optimizer import OptHyper, get_optimizer
from repro_torch.train.step import make_train_step

torch.set_num_threads(2)

B, S, N_DEC = 4, 12, 3
TOL = 1e-5          # of the largest |value| of the reference's
UPDATE_TOL = 1e-6   # parameters after one update of the same gradients
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)   # tests/test_torch_train.py's
NORM_TOL = 1e-4     # a train step's gradient norm, relative (the same)
WORLD_SECONDS = 120.0
# (tag, arch, overrides)
CASES = [("xlstm-350m", "xlstm-350m",
          {"d_model": 48, "n_heads": 2, "n_kv_heads": 2, "vocab_size": 384}),
         ("jamba-1.5-large-398b", "jamba-1.5-large-398b",
          {"d_model": 48, "n_heads": 6, "n_kv_heads": 2, "d_ff": 96,
           "vocab_size": 384})]
IDS = [c[0] for c in CASES]
GRIDS = [(1, 2), (1, 3), (2, 2)]


def _configs(arch, over):
    return r_reduced(r_get_config(arch), **over), \
        reduced(get_config(arch), **over)


def _named(cfg, tree):
    """A reference pytree as the port's ``{parameter name: array}``."""
    return {k: p.detach().numpy().copy() for k, p in Transformer.from_arrays(
        cfg, jax.tree.map(np.asarray, tree), device="cpu").named_parameters()}


def _one_rank(cfg, arrays, batch, prompt, teacher):
    """The port's unsharded model on the same inputs: forward logits,
    prefill and decode logits, and the parameters after one train
    step."""
    m = Transformer.from_arrays(cfg, arrays, device="cpu")
    logits, _ = m({"tokens": torch.from_numpy(batch["tokens"])})
    pre, cache = m.prefill({"tokens": torch.from_numpy(prompt)},
                           S + N_DEC + 2)
    steps = [pre.numpy()[:, -1]]
    for j in range(N_DEC):
        d, cache = m.decode_step(cache, torch.from_numpy(teacher[:, j:j + 1]),
                                 S + j)
        steps.append(d.numpy()[:, 0])
    loss, _ = m.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in m.named_parameters()}
    stepped = Transformer.from_arrays(cfg, arrays, device="cpu")
    state = get_optimizer(cfg.optimizer).init(
        dict(stepped.named_parameters()))
    make_train_step(cfg, OptHyper(), attn_chunk=16)(
        stepped, state, {k: torch.from_numpy(v) for k, v in batch.items()},
        0)
    return {"forward": logits.numpy(), "steps": np.stack(steps, 1),
            "loss": float(loss.detach()), "grads": grads,
            "params_step": {k: p.detach().numpy().copy()
                            for k, p in stepped.named_parameters()}}


@pytest.fixture(scope="module")
def ref():
    """Per case: the arrays and inputs; the reference's forward logits,
    loss and gradients, prefill and decode logits, its gradient norm and
    parameters after clipping and one update of its gradients, and the
    port's one-rank values."""
    out = {}
    for i, (tag, arch, over) in enumerate(CASES):
        r_cfg, cfg = _configs(arch, over)
        arrays = lm_arrays(r_cfg)
        params = jax.tree.map(jnp.asarray, arrays)
        rng = np.random.default_rng(i)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}
        prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        teacher = rng.integers(0, cfg.vocab_size, (B, N_DEC)).astype(np.int32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, _ = jax.jit(lambda p, t: RT.forward(p, r_cfg, {"tokens": t}))(
            params, jb["tokens"])
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: RT.loss_fn(p, r_cfg, b), has_aux=True))(params, jb)
        max_seq = S + N_DEC + 2
        pre, cache = jax.jit(lambda p, t: RT.prefill(
            p, r_cfg, {"tokens": t}, max_seq))(params, jnp.asarray(prompt))
        dec = jax.jit(lambda p, c, t, pos: RT.decode_step(p, r_cfg, c, t,
                                                          pos))
        steps = [np.asarray(pre)[:, -1]]
        for j in range(N_DEC):
            d, cache = dec(params, cache, jnp.asarray(teacher[:, j:j + 1]),
                           jnp.int32(S + j))
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
                    "grad_norm": float(norm), "params_1": _named(cfg, after),
                    "one_rank": _one_rank(cfg, arrays, batch, prompt,
                                          teacher)}
    return out


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def world(request, ref, tmp_path_factory):
    data, model = request.param
    cases = [(tag, r["over"], r["arrays"], r["batch"], r["prompt"],
              r["teacher"], r["grads"]) for tag, r in ref.items()]
    res = run_world(recurrent_job, data * model,
                    tmp_path_factory.mktemp(f"recurrent{data}x{model}"),
                    data, model, cases, timeout=WORLD_SECONDS)
    return data, model, res


def _rows(a, data, di):
    n = a.shape[0] // data
    return a[di * n:(di + 1) * n]


def _close(got, want, what, tol=TOL):
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _cfg(ref, case):
    over = ref[case]["over"]
    return reduced(get_config(over["arch"]),
                   **{k: v for k, v in over.items() if k != "arch"})


@pytest.mark.parametrize("case", IDS)
def test_forward_matches_reference(world, ref, case):
    data, _, res = world
    _close(ref[case]["one_rank"]["forward"], ref[case]["forward"],
           "one rank forward")
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        _close(out[case]["forward"], _rows(ref[case]["forward"], data, di),
               f"rank {rank} forward")


@pytest.mark.parametrize("case", IDS)
def test_prefill_and_decode_match_reference(world, ref, case):
    data, _, res = world
    _close(ref[case]["one_rank"]["steps"], ref[case]["steps"],
           "one rank prefill and decode")
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        _close(out[case]["steps"], _rows(ref[case]["steps"], data, di),
               f"rank {rank} prefill and decode")


@pytest.mark.parametrize("case", IDS)
def test_loss_and_gradients_match_reference(world, ref, case):
    """The loss averaged over the data shards and every whole gradient,
    as the train step reduces it, equal the reference's of the whole
    batch, and the port's one rank's."""
    _, _, res = world
    want, one = ref[case], ref[case]["one_rank"]
    for k, g in want["grads"].items():
        np.testing.assert_allclose(one["grads"][k], g, err_msg=k, **GRAD_TOL)
    for rank, out in enumerate(res):
        got = out[case]
        for loss in (want["loss"], one["loss"]):
            assert abs(got["loss"] - loss) <= TOL * abs(loss), rank
        assert set(got["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            assert got["grads"][k].shape == g.shape, (rank, k)
            for w in (g, one["grads"][k]):
                np.testing.assert_allclose(got["grads"][k], w,
                                           err_msg=f"rank {rank} {k}",
                                           **GRAD_TOL)


@pytest.mark.parametrize("case", IDS)
def test_update_of_given_gradients_matches_reference(world, ref, case):
    """The global norm and every parameter after one update of the
    reference's gradients: AdamW for xlstm, Adafactor for jamba, whose
    sums over a KV block that ranks hold in part count each position
    once (at 3 ranks)."""
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
def test_train_step_matches_reference_and_one_rank(world, ref, case):
    """One ``make_train_step`` on the batch: its loss and gradient norm
    against the reference's, and every parameter after it within 1e-5 of
    the largest parameter against the port's one-rank step and, for
    Adafactor, against the reference's clipping and update of its own
    gradients (module docstring)."""
    _, _, res = world
    want, one = ref[case], ref[case]["one_rank"]
    scale = max(float(np.abs(p).max()) for p in want["params_1"].values())
    adafactor = _cfg(ref, case).optimizer == "adafactor"
    if adafactor:
        for k, p in want["params_1"].items():
            np.testing.assert_allclose(one["params_step"][k], p, rtol=0,
                                       atol=TOL * scale, err_msg=k)
    for rank, out in enumerate(res):
        got = out[case]
        assert abs(got["step_metrics"]["loss"] - want["loss"]) <= \
            TOL * abs(want["loss"]), rank
        assert abs(got["step_metrics"]["grad_norm"] - want["grad_norm"]) \
            <= NORM_TOL * want["grad_norm"], rank
        for k, p in want["params_1"].items():
            np.testing.assert_allclose(
                got["params_step"][k], one["params_step"][k], rtol=0,
                atol=TOL * scale, err_msg=f"rank {rank} {k} vs one rank")
            if adafactor:
                np.testing.assert_allclose(got["params_step"][k], p, rtol=0,
                                           atol=TOL * scale,
                                           err_msg=f"rank {rank} {k}")


def _collectives(cfg, s: int) -> int:
    """The model group's calls in a prefill of ``s`` tokens (a decode
    step: ``s = 1``): the embedding's psum and the logits' gather; an
    xLSTM period's sLSTM gathers ``h`` at each of the ``s`` steps, and each
    block sums ``proj_out``; a hybrid period's Mamba sums its B, C, dt and
    its ``out_proj``, its attention ``wo``, each MLP ``wo`` and each MoE
    layer its combine (its data-axis gather is the data group's)."""
    n = 2
    periods = cfg.n_layers // (len(cfg.block_pattern) if cfg.block_pattern
                               else cfg.attn_every)
    if cfg.family == "ssm":
        per = sum(s + 1 if k == "slstm" else 1 for k in cfg.block_pattern)
    else:
        per = 2 * (cfg.attn_every - 1) + 1 + cfg.attn_every
    return n + periods * per


@pytest.mark.parametrize("case", IDS)
def test_collectives_of_a_prefill_and_a_step(world, ref, case):
    """Over model ranks every rank makes the same collective calls: a
    prefill of S tokens and a decode step as :func:`_collectives`
    counts them (xlstm: 2 sLSTM blocks × S gathers of ``h`` and a
    ``proj_out`` sum a block)."""
    _, model, res = world
    cfg = _cfg(ref, case)
    for rank, out in enumerate(res):
        got = out[case]
        if model == 1:
            continue
        assert got["prefill_calls"] == _collectives(cfg, S), rank
        assert got["decode_calls"] == [_collectives(cfg, 1)] * N_DEC, rank


@pytest.mark.parametrize("case", IDS)
def test_two_d_weights_match_reference(world, ref, case):
    """With every weight's d_model dim split over "data" too (the giant
    models' rule, jamba's at the production mesh), each use gathers the
    weight over the data ranks: forward, prefill and decode, the loss
    and every whole gradient as above (over one data rank the rule
    splits nothing)."""
    data, _, res = world
    want = ref[case]
    for rank, out in enumerate(res):
        di = out["coords"]["data"][0]
        got = out[case]["two_d"]
        for what in ("forward", "steps"):
            _close(got[what], _rows(want[what], data, di),
                   f"rank {rank} {what}")
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g,
                                       err_msg=f"rank {rank} {k}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("case", IDS)
def test_init_params_draws_the_unsharded_numbers(world, ref, case):
    """``init_params`` over ranks draws every full tensor as the one-rank
    model draws it and keeps the rank's block (a Mamba's conv taps
    included): gathered whole, the same bits as one rank's from the same
    seed."""
    _, _, res = world
    cfg = _cfg(ref, case)
    want = {k: p.detach().numpy() for k, p in Transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
        .named_parameters()}
    for rank, out in enumerate(res):
        got = out[case]["init_params"]
        assert set(got) == set(want)
        for k, p in want.items():
            assert np.array_equal(got[k], p), (rank, k)


@pytest.mark.parametrize("case", IDS)
def test_heads_channels_and_meta_shapes(world, ref, case):
    """Each rank holds its ``head_range``'s mLSTM heads and its share of
    the channels; only a rank with no head takes the headless branch;
    rank 0's parameters and cache are ``input_specs``' meta shapes."""
    _, model, res = world
    cfg = _cfg(ref, case)
    inner = cfg.d_model * cfg.ssm_expand
    for out in res:
        got = out[case]
        r = out["coords"]["model"][0]
        lo, hi = attn.head_range(cfg.n_heads, model, r)
        if cfg.family == "ssm":
            assert got["param_shapes"]["layers.0.b0_mlstm.wq.w"] == \
                (cfg.d_model, (hi - lo) * inner // cfg.n_heads)
            assert got["cache_shapes"][("b0", "c")][2] == hi - lo
            assert got["cache_shapes"][("b1", "h")][-1] == inner // model
            assert (got["no_head_calls"] > 0) == (hi == lo), (r, got)
        else:
            assert got["param_shapes"]["layers.0.mamba.0.in_proj.w"] == \
                (cfg.d_model, inner // model)
            assert got["cache_shapes"][("mamba", "h")][3] == inner // model
            assert got["no_head_calls"] == 0
        if r == 0:
            assert got["param_shapes"] == got["param_meta"]
            assert got["cache_shapes"] == got["cache_meta"]
    if case == "xlstm-350m" and model == 3:
        assert res[2][case]["no_head_calls"] > 0


# ---------------------------------------------------------------------------
# the sLSTM's loop counted one middle trip for all
# ---------------------------------------------------------------------------

LOOP_S = 64        # the sLSTM's steps, 8 chunks of 8 for the others
# a whole loss: the sLSTM's steps; the Mamba's 4 chunks of 256
LOSS_S = {"xlstm-350m": 128, "jamba-1.5-large-398b": 1024}


def _loop_counts(device, m: int, what: str, train: bool,
                 one_trip: bool = True):
    """The :class:`CostCounter` of one of a reduced model's recurrences at
    S = ``LOOP_S`` (``what``: "slstm", "mlstm" or "mamba") or of its whole
    loss (an arch, at its ``LOSS_S``, ``remat="full"``) on ``device``,
    over a counting group of ``m`` model ranks: served (no gradient), or
    with the backward too; ``one_trip``: the counter's."""
    arch = "jamba-1.5-large-398b" if what in ("mamba",
                                              "jamba-1.5-large-398b") \
        else "xlstm-350m"
    over = dict(CASES[IDS.index(arch)][2])
    cfg = dataclasses.replace(reduced(get_config(arch), **over),
                              remat="full")
    ledger = CollectiveLedger()
    grid = counting_grid(MeshShape(("data", "model"), (1, m)), ledger)
    model = Transformer(cfg, device=device, group=grid)
    gen = np.random.default_rng(0)
    if device == "cpu":
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(gen.normal(
                    size=tuple(p.shape)).astype(np.float32) * 0.1))
    s = LOSS_S.get(what, LOOP_S)
    tokens = torch.from_numpy(gen.integers(0, cfg.vocab_size, (2, s))
                              .astype(np.int64)).to(device)
    x = torch.zeros((2, s, cfg.d_model), device=device)
    if device == "cpu":
        x.normal_()
    x.requires_grad_(train)
    period = model.layers[0]
    run = {"slstm": lambda: xlstm.slstm_train(period.mixer(1), x, cfg),
           "mlstm": lambda: xlstm.mlstm_train(period.mixer(0), x, cfg,
                                              chunk=8),
           "mamba": lambda: ssm.mamba_train(period.mamba[0], x, cfg,
                                            chunk=8)}.get(what)
    with CostCounter(ledger, one_trip=one_trip) as c:
        if run is None:
            loss, _ = model.loss_fn({"tokens": tokens, "targets": tokens})
            loss.backward()
        elif train:
            run().sum().backward()
        else:
            with torch.no_grad():
                run()
    return c


LOOPS = [(w, t) for w in ("slstm", "mlstm", "mamba") for t in (False, True)] \
    + [(a, True) for a in LOSS_S]


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("what,train", LOOPS,
                         ids=[f"{w}-{'trained' if t else 'served'}"
                              for w, t in LOOPS])
def test_loop_multiplier_counts_as_a_literal_loop(what, train, m):
    """The meta count (first trip, one middle trip for all, last) equals
    the count of every trip in flops, bytes, collective bytes, wire bytes
    and calls: a CPU run's for a recurrence alone, a meta run's with
    ``one_trip`` off for a whole loss (K4 counts by its formula on meta,
    its plain version's products on the CPU)."""
    literal = _loop_counts("meta" if what in LOSS_S else "cpu", m, what,
                           train, one_trip=False)
    counted = _loop_counts("meta", m, what, train)
    assert counted.cost.flops == literal.cost.flops > 0
    assert counted.cost.bytes == literal.cost.bytes > 0
    assert counted.cost.collective_bytes == literal.cost.collective_bytes
    assert counted.wire_bytes == literal.wire_bytes
    assert counted.collective_calls == literal.collective_calls
    if m > 1 and what == "slstm":
        # one gather of h a step, and a reduce-scatter of its gradient a
        # step past the first
        assert counted.collective_calls["all-gather"] == LOOP_S
        assert counted.collective_calls.get("reduce-scatter", 0) == \
            (LOOP_S - 1 if train else 0)
