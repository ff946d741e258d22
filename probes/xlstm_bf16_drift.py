"""xLSTM decode against forward over many steps, in the reference and in
the port, on the CPU: how far bf16 compute lets the step-by-step decode
drift from the chunked forward.

Run from the root of a checkout on a machine with both packages' needs
(jax and torch; no card):

    PYTHONPATH=src JAX_PLATFORMS=cpu python probes/xlstm_bf16_drift.py [--full]

A reduced xlstm-350m (d_model 256, 8 blocks, vocab 1024) with the
reference's ``init_params`` weights (biases and norms perturbed, as the
parity tests), or with ``--full`` xlstm-350m as published (24 blocks,
d_model 1024, vocab 50304; 1.8 GB of float32 weights a package) with the
reference's ``init_params`` weights as they are, drawn from the
distributions the card's model is drawn from.  2 x 256 numpy tokens:
``prefill`` of the first 128, then 128 teacher-forced ``decode_step``s,
each step's logits against ``forward``'s at that position (the shapes of
``chip_smoke.py``'s 128-step xLSTM check).  Prints, for float32 and
bfloat16 compute and for each package, the largest |difference| and the
largest |logit|.
"""
import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

from _torch_oracles import lm_arrays                         # noqa: E402
from repro.configs.base import get_config as r_get_config    # noqa: E402
from repro.configs.base import reduced as r_reduced          # noqa: E402
from repro.models import transformer as RT                   # noqa: E402
from repro_torch.configs.base import get_config, reduced     # noqa: E402
from repro_torch.models.transformer import Transformer       # noqa: E402

S, PROMPT = 256, 128


def reference(r_cfg, params, toks):
    full = np.asarray(RT.forward(params, r_cfg, {"tokens": jnp.asarray(toks)}
                                 )[0].astype(jnp.float32))
    _, cache = RT.prefill(params, r_cfg,
                          {"tokens": jnp.asarray(toks[:, :PROMPT])}, S)
    step = jax.jit(lambda p, c, t, pos: RT.decode_step(p, r_cfg, c, t, pos))
    err = 0.0
    for t in range(PROMPT, S):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        got = np.asarray(logits[:, 0].astype(jnp.float32))
        err = max(err, float(np.abs(got - full[:, t]).max()))
    return err, float(np.abs(full[:, PROMPT:]).max())


@torch.no_grad()
def port(model, toks):
    tt = torch.from_numpy(toks)
    full = model({"tokens": tt})[0].float()
    _, cache = model.prefill({"tokens": tt[:, :PROMPT]}, S)
    err = 0.0
    for t in range(PROMPT, S):
        logits, cache = model.decode_step(cache, tt[:, t:t + 1], t)
        err = max(err, float((logits[:, 0].float() - full[:, t]).abs().max()))
    return err, float(full[:, PROMPT:].abs().max())


def main() -> None:
    full = "--full" in sys.argv[1:]
    vocab = r_get_config("xlstm-350m").vocab_size if full else 1024
    toks = np.random.default_rng(0).integers(0, vocab, (2, S)).astype(np.int32)
    arrays = None
    for dtype in ("float32", "bfloat16"):
        if full:
            r_cfg = dataclasses.replace(r_get_config("xlstm-350m"),
                                        compute_dtype=dtype)
            cfg = dataclasses.replace(get_config("xlstm-350m"),
                                      compute_dtype=dtype)
        else:
            kw = dict(d_model=256, n_layers=8, vocab_size=1024,
                      compute_dtype=dtype)
            r_cfg = r_reduced(r_get_config("xlstm-350m"), **kw)
            cfg = reduced(get_config("xlstm-350m"), **kw)
        if arrays is None:      # the weights do not depend on the compute
            arrays = (jax.tree.map(np.array, RT.init_params(
                r_cfg, jax.random.PRNGKey(0))) if full else lm_arrays(r_cfg))
            print(f"blocks {r_cfg.n_layers} d_model {r_cfg.d_model} vocab "
                  f"{r_cfg.vocab_size} params "
                  f"{sum(a.size for a in jax.tree.leaves(arrays))}",
                  flush=True)
        for name, run in (
                ("reference", lambda: reference(
                    r_cfg, jax.tree.map(jnp.asarray, arrays), toks)),
                ("port", lambda: port(Transformer.from_arrays(
                    cfg, arrays, device="cpu"), toks))):
            t0 = time.perf_counter()
            err, scale = run()
            print(f"{dtype:9s} {name:9s} max|d| {err:.6g}  max|logit| "
                  f"{scale:.6g}  ratio {err / scale:.4g}  "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
