"""Data pipeline: deterministic synthetic token streams and host-side
prefetch onto the card (see ``repro.data.pipeline``).

Determinism contract (fault tolerance): batch ``i`` is a pure function of
``(seed, i)``, so after a restart from a checkpoint the stream resumes
mid-way exactly, with nothing to save beyond the step counter.

The reference's ``make_batch_specs`` (``jax.ShapeDtypeStruct``s for
lowering a sharded step) has no counterpart here: the port lowers nothing
ahead of time, and a rank's batch shapes and specs are
``launch/specs.batch_structs``'s meta tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import DeviceLike, resolve

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    """Zipf-ish synthetic LM stream (B, S) int32 tokens + next-token targets."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # zipf-like marginal over the vocab (realistic embedding traffic)
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens = (z % self.vocab).astype(np.int32)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """A thread that makes the next ``depth`` batches of ``source`` (any
    object with ``batch_at(step)``) and moves them to ``device``.

    On the card each batch is copied into pinned host memory and sent with
    a non-blocking copy on a stream of the thread's own; :meth:`next` makes
    the caller's stream wait for that copy.  ``next()`` returns
    ``(step, {name: tensor})`` in step order from ``start_step``.
    ``rows=(i, n)`` keeps shard ``i`` of ``n`` of each batch's rows, a
    data-parallel rank's (the reference's ``P(("data",))``).
    """

    def __init__(self, source, depth: int = 2, device: DeviceLike = None,
                 start_step: int = 0, rows: tuple = (0, 1)):
        self.source = source
        self.rows = rows
        self.device = resolve(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.thread = threading.Thread(target=self._work, daemon=True,
                                       name="prefetcher")
        self.thread.start()

    def _to_device(self, host: Dict[str, np.ndarray]):
        i, n = self.rows
        cpu = {k: torch.from_numpy(np.ascontiguousarray(
            v[i * (len(v) // n):(i + 1) * (len(v) // n)]))
            for k, v in host.items()}
        if self._stream is None:
            return cpu, None
        with torch.cuda.stream(self._stream):
            dev = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in cpu.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch, done = self._to_device(self.source.batch_at(step))
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch, done), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        step, batch, done = self.q.get()
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in batch.values():
                t.record_stream(cur)
        return step, batch

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=5.0)
