"""Batched serving loop: prefill + decode with a static KV budget (see
``repro.serve.engine``).

Prompts are left-padded with token 0 into a fixed (batch, max_seq) budget,
as in the reference: the pad tokens are attended to and take positions from
0.  Prefill runs the padded batch once (kernel K4 in every layer); the
decode loop then takes one greedy or sampled token per step, with one host
sync per token, until ``max_new_tokens`` or the ``max_seq`` budget.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..models.layers import dtype_of

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    batch: int = 8
    max_seq: int = 256
    temperature: float = 0.0
    eos_token: int = -1         # -1: run to max_new_tokens


class Engine:
    """Serves ``model`` (a :class:`~repro_torch.models.transformer.
    Transformer` on ``device``).

    The engine keeps one copy of the weights in the compute dtype, made
    once here: every apply casts its weights to that dtype, so the copy
    gives the same numbers without a cast per step.  After each
    :meth:`generate`, ``stats`` holds its host-clock seconds (each read
    after a device sync) and ``last_logits`` the last step's logits.

    A model over a grid serves this rank's data shard's prompts; every
    rank of the grid calls :meth:`generate` with the same budget, since a
    prefill and each decode step run the model's collectives (with 2-D
    weights, the gathers of every layer's weights over "data": every
    data rank runs as many steps).
    """

    def __init__(self, cfg, model, scfg: ServeConfig,
                 device: DeviceLike = None):
        dev = resolve(device)
        if model.device.type != dev.type or \
                dev.index not in (None, model.device.index):
            raise ValueError(f"model is on {model.device}, engine on {dev}")
        self.device = model.device
        self.cfg = cfg
        self.scfg = scfg
        compute = dtype_of(cfg.compute_dtype)
        self.model = model if model.param_dtype == compute \
            else model.astype(compute)
        self.stats = {}
        self.last_logits: Optional[torch.Tensor] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 generator: Optional[torch.Generator] = None
                 ) -> List[List[int]]:
        """Greedy (or, with ``temperature > 0``, sampled) continuation for a
        batch of prompts.  Sampling draws from ``generator`` (default: a
        new one seeded 0, so each call repeats the same draws, as the
        reference's ``PRNGKey(0)`` does)."""
        scfg = self.scfg
        b = len(prompts)
        if not 0 < b <= scfg.batch:
            raise ValueError(f"{b} prompts for a batch of {scfg.batch}")
        plen = max(len(p) for p in prompts)
        toks = np.zeros((scfg.batch, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p     # left-pad
        if scfg.temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        t0 = time.perf_counter()
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = self.model.prefill(batch, scfg.max_seq)
        out = [list(p) for p in prompts]
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos = plen
        t_first = None
        steps = 0
        for _ in range(max_new_tokens):
            host = cur[:b, 0].tolist()        # the one host sync per token
            if t_first is None:
                t_first = time.perf_counter()
            for i in range(b):
                out[i].append(int(host[i]))
            logits, cache = self.model.decode_step(cache, cur, pos)
            steps += 1
            if scfg.temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / scfg.temperature,
                                      dim=-1)
                cur = torch.multinomial(probs, 1, generator=generator)
            else:
                cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            pos += 1
            if pos >= scfg.max_seq:
                break
        self._sync()
        t_end = time.perf_counter()
        if t_first is None:
            t_first = t_end
        self.last_logits = logits
        self.stats = {"prefill_seconds": t_first - t0,
                      "decode_seconds": t_end - t_first,
                      "decode_steps": steps, "batch": scfg.batch,
                      "prompt_len": plen}
        return out
