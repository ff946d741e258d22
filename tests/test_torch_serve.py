"""The port's serving engine against the reference's, on the CPU.

``reduced`` qwen2.5-3b in float32, the same weights in both packages
(``_torch_oracles.lm_arrays``): greedy generation gives the reference's
tokens exactly, as long as no step's top two logits lie within 1e-3 of
each other (where float32 summation order could swap them); if one does,
the logits are compared instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as RT
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(2)

CPU = torch.device("cpu")
PROMPTS = [[1, 2, 3], [4, 5]]
NEW = 5


@pytest.fixture(scope="module")
def pair():
    r_cfg = r_reduced(r_get_config("qwen2.5-3b"))
    cfg = reduced(get_config("qwen2.5-3b"))
    arrays = lm_arrays(r_cfg)
    model = Transformer.from_arrays(cfg, arrays, device=CPU)
    return r_cfg, cfg, jax.tree.map(jnp.asarray, arrays), model


def _padded(seqs, width):
    toks = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        toks[i, width - len(s):] = s
    return toks


def test_greedy_generate_matches_reference(pair):
    r_cfg, cfg, r_params, model = pair
    want = REngine(r_cfg, r_params, RServeConfig(batch=2, max_seq=48)
                   ).generate(PROMPTS, max_new_tokens=NEW)
    eng = Engine(cfg, model, ServeConfig(batch=2, max_seq=48), device=CPU)
    got = eng.generate(PROMPTS, max_new_tokens=NEW)
    assert [len(o) for o in got] == [len(p) + NEW for p in PROMPTS]
    assert all(0 <= t < cfg.vocab_size for o in got for t in o)
    assert eng.stats["decode_steps"] == NEW and eng.stats["prompt_len"] == 3
    assert torch.isfinite(eng.last_logits).all()

    # the logits behind each reference token: a teacher-forced forward of
    # the left-padded sequences (decode equals forward, test_torch_models)
    plen = max(len(p) for p in PROMPTS)
    toks = _padded(want, plen + NEW)
    ref_logits = np.asarray(RT.forward(r_params, r_cfg,
                                       {"tokens": jnp.asarray(toks)})[0])
    steps = ref_logits[:, plen - 1:plen - 1 + NEW]
    top2 = np.sort(steps, axis=-1)[..., -2:]
    if np.all(top2[..., 1] - top2[..., 0] > 1e-3):
        assert got == want
    else:   # a near tie: hold the logits, not the argmax
        port_logits, _ = model({"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(port_logits.numpy(), ref_logits,
                                   atol=1e-4, rtol=1e-4)


def test_batch_larger_than_prompts_and_max_seq_stop(pair):
    _, cfg, _, model = pair
    eng = Engine(cfg, model, ServeConfig(batch=3, max_seq=6), device=CPU)
    out = eng.generate(PROMPTS, max_new_tokens=10)
    # positions 3, 4, 5 decode; the budget of 6 stops the loop after them
    assert [len(o) for o in out] == [6, 5]
    assert eng.stats["decode_steps"] == 3 and eng.stats["batch"] == 3
    with pytest.raises(ValueError):
        eng.generate([[1]] * 4)


def test_sampling_is_reproducible(pair):
    _, cfg, _, model = pair
    eng = Engine(cfg, model, ServeConfig(batch=2, max_seq=48,
                                         temperature=1.0), device=CPU)
    a = eng.generate(PROMPTS, NEW, generator=torch.Generator().manual_seed(5))
    b = eng.generate(PROMPTS, NEW, generator=torch.Generator().manual_seed(5))
    assert a == b
    assert eng.generate(PROMPTS, NEW) == eng.generate(PROMPTS, NEW)
    assert all(0 <= t < cfg.vocab_size for o in a for t in o)
    greedy = Engine(cfg, model, ServeConfig(batch=2, max_seq=48),
                    device=CPU).generate(PROMPTS, NEW)
    draws = {tuple(map(tuple, eng.generate(
        PROMPTS, NEW, generator=torch.Generator().manual_seed(s))))
        for s in range(4)}
    assert len(draws | {tuple(map(tuple, greedy))}) > 1   # it does sample


def test_engine_keeps_one_compute_dtype_copy():
    cfg = reduced(get_config("qwen2.5-3b"), compute_dtype="bfloat16")
    model = Transformer.init_params(cfg, device=CPU)
    eng = Engine(cfg, model, ServeConfig(batch=2, max_seq=16), device=CPU)
    assert model.param_dtype == torch.float32
    assert eng.model.param_dtype == torch.bfloat16
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              eng.model.state_dict().items()):
        # norms are read in float32 by their apply, so the copy keeps them
        norm = k.split(".")[-2] in ("ln1", "ln2", "norm_f")
        assert b.dtype == (torch.float32 if norm else torch.bfloat16), k
        assert torch.equal(a.to(b.dtype), b), k
    # the copy gives the numbers each apply's own cast gives
    toks = torch.from_numpy(_padded(PROMPTS, 3))
    assert torch.equal(model({"tokens": toks})[0], eng.model({"tokens": toks})[0])
