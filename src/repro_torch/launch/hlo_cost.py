"""Per-rank cost of running a function: flops, bytes, collective bytes
(counterpart of ``repro/launch/hlo_cost.py``).

The reference parses the post-SPMD HLO of a compiled step and multiplies
each ``while`` body by its trip count, because ``cost_analysis()`` counts
a scanned layer once.  The port has no HLO: it runs the function, on the
meta device (``launch/dryrun.py``) or on a card, and counts what runs.  A
Python loop runs its body once per trip, so trip counts come for free.
A loop whose middle trips all run the same ops on the same shapes may
count one of them for all instead, as the reference multiplies a
``while`` body by its trip count (:func:`loop`, :class:`Trips`):
the sLSTM's host loop of one step a token (``models/xlstm.slstm_train``),
which a literal count of a 32k-token cell would step 393,216 times, and
the mLSTM's and the Mamba's chunk loops.
The result keeps the reference's type and meaning, per rank:

  flops            — ``torch.utils.flop_counter.FlopCounterMode``: 2·m·n·k
                     a matrix product (batch dims included), and K4 by its
                     own formula (``kernels/flash_attention.attention_flops``:
                     4·D·B·H × the scored pairs), registered on its custom
                     op, so a meta call and a launch on the card count
                     alike.  The reference counts ``dot`` ops only, so both
                     leave elementwise work out.
  bytes            — Σ (input + output bytes) of every aten op under a
                     ``TorchDispatchMode``; views (outputs that alias an
                     input and write nothing) and ops with no tensor output
                     are skipped, as the reference skips ``bitcast``,
                     ``tuple`` and the like, and so are allocations
                     (``empty*``), which move nothing.  A collective of a
                     counting group (``launch/mesh.py``) is charged its
                     input and output bytes, as the reference charges a
                     collective op's operand and output.  The port fuses
                     nothing, so every op's operands count where the
                     reference skips a fusion's insides.
  collective bytes — output bytes of every all-gather / all-reduce /
                     all-to-all / collective-permute, from the counting
                     groups' :class:`~repro_torch.launch.mesh.CollectiveLedger`.

:class:`CostCounter` also keeps what the reference reads from
``memory_analysis()`` and XLA does not expose here: the bytes of this
run's live tensors at their peak (outputs of counted ops, freed when their
last Python reference goes), and the wire bytes the ledger adds.

``xla_cost_dict`` has no counterpart: there is no compiled executable to
ask.  Nor has ``HloCost.transcendentals``, which the reference's walker
never adds to.

``peak_live_bytes`` does not multiply: a trip counted for many holds its
tensors once.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .mesh import CollectiveLedger, _nbytes, _quiet

__all__ = ["HloCost", "CostCounter", "Trips", "loop", "tree_bytes"]

_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}
# views whose schema declares no alias (a reshape's copy is the clone)
_UNANNOTATED_VIEWS = {"_unsafe_view"}
_ACTIVE: List["CostCounter"] = []      # the counters entered, innermost last


@dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a pytree (meta tensors included)."""
    return sum(_nbytes(t) for t in _tensors(tree))


def _op_name(func) -> str:
    return func._schema.name.split("::")[-1]


def _is_view(func) -> bool:
    """Every output aliases an input and none is written: a view."""
    rets = func._schema.returns
    return _op_name(func) in _UNANNOTATED_VIEWS or bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


class _BytesMode(TorchDispatchMode):
    """Bytes in and out of each counted op, and the live bytes of the
    tensors the ops make."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.live = 0
        self.peak = 0

    def _track(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def collective(self, kind: str, out: torch.Tensor, in_bytes: float):
        """A counting group's collective (``CollectiveLedger`` listener)."""
        self.bytes += in_bytes + _nbytes(out)
        self._track(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs or _is_view(func):
            return out
        ins = _tensors((args, kwargs))
        fresh = [o for o in outs if not any(o is i for i in ins)]
        for o in fresh:
            self._track(o)
        if _op_name(func) not in _ALLOCATIONS:
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(o) for o in outs)
        return out


class CostCounter:
    """Counts what runs inside ``with CostCounter(ledger) as c:``.

    ``ledger``: the counting groups' (``launch/mesh.py``); collectives are
    read from it as the difference over the block.  ``one_trip``: a
    :func:`loop` on the meta device runs one middle trip for all (False:
    every trip).  After the block:
    ``cost`` (:class:`HloCost`), ``wire_bytes`` and ``collective_calls``
    (by kind), ``peak_live_bytes`` (the most bytes the counted ops' outputs
    held at once, arguments not included).
    """

    def __init__(self, ledger: Optional[CollectiveLedger] = None,
                 one_trip: bool = True):
        self.ledger, self.one_trip = ledger, one_trip
        self.cost = HloCost()
        self.wire_bytes: Dict[str, float] = {}
        self.collective_calls: Dict[str, int] = {}
        self.peak_live_bytes = 0
        self._more_flops = 0.0      # the flops of trips counted for others

    def __enter__(self) -> "CostCounter":
        self._before = self.ledger.snapshot() if self.ledger else None
        self._flops = FlopCounterMode(display=False)
        self._bytes = _BytesMode()
        if self.ledger is not None:
            self.ledger.listeners.append(self._bytes.collective)
        self._flops.__enter__()
        self._bytes.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.cost = HloCost(flops=float(self._flops.get_total_flops()
                                        + self._more_flops),
                            bytes=float(self._bytes.bytes))
        self.peak_live_bytes = int(self._bytes.peak)
        if self.ledger is not None:
            self.ledger.listeners.remove(self._bytes.collective)
            after = self.ledger.snapshot()

            def diff(key):
                return {k: v - self._before[key].get(k, 0)
                        for k, v in after[key].items()
                        if v != self._before[key].get(k, 0)}

            self.cost.collective_bytes = diff("bytes")
            self.wire_bytes = diff("wire_bytes")
            self.collective_calls = diff("calls")

    def _totals(self) -> tuple:
        return (self._flops.get_total_flops() + self._more_flops,
                self._bytes.bytes,
                self.ledger.snapshot() if self.ledger else None)

    def _repeat(self, before: tuple, times: int) -> None:
        """Add ``times`` more of what was counted since ``before``."""
        flops, nbytes, ledger = self._totals()
        self._more_flops += times * (flops - before[0])
        self._bytes.bytes += times * (nbytes - before[1])
        if ledger is not None:
            self.ledger.repeat_since(before[2], times)

    def per_device(self, argument_bytes: int, output) -> Dict:
        """A dry-run cell's counts, under the reference's result keys (less
        its ``xla_*`` keys, plus ``wire_bytes_per_device``): the block's
        cost and ``memory`` from ``argument_bytes`` and the ``output``
        tree's bytes, peak = arguments + the temporaries' peak."""
        return {
            "flops_per_device": self.cost.flops,
            "bytes_per_device": self.cost.bytes,
            "collective_bytes_per_device": self.cost.collective_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "memory": {
                "argument_bytes": argument_bytes,
                "output_bytes": tree_bytes(output),
                "temp_bytes": self.peak_live_bytes,
                "peak_bytes": argument_bytes + self.peak_live_bytes,
            },
        }


def _loop_counter(t: torch.Tensor) -> Optional[CostCounter]:
    """The innermost :class:`CostCounter` entered, where ``t`` lies on the
    meta device (a count with no numbers: a loop may run one middle trip
    for all) and the counter's ``one_trip`` holds; else None, and the loop
    runs every trip."""
    if not _ACTIVE or t.device.type != "meta" or not _ACTIVE[-1].one_trip:
        return None
    return _ACTIVE[-1]


class Trips:
    """One trip of a loop counted for ``n``: what runs inside ``with
    Trips(counter, n):`` is counted ``n`` times.  Its backward is too when
    the trip's inputs pass :meth:`enter` and its outputs :meth:`exit`:
    autograd runs the nodes made between the two after ``exit``'s
    backward and before ``enter``'s (it runs ready nodes latest made
    first, and a gradient flows only from a later node to an earlier
    one), and those two mark the span.  Gradients that several trips add
    into one tensor are added outside the span, once each, as a literal
    run adds them, and :meth:`fan_out` gives the counted trip's output for
    every trip it stands for."""

    def __init__(self, counter: CostCounter, n: int):
        self.counter, self.n = counter, int(n)
        self._backward: List[tuple] = []

    def __enter__(self) -> "Trips":
        self._forward = self.counter._totals()
        return self

    def __exit__(self, kind, *_) -> None:
        if kind is None:
            self.counter._repeat(self._forward, self.n - 1)

    def enter(self, *ts: torch.Tensor) -> tuple:
        """The trip's inputs: where its backward's span ends."""
        return _TripEnter.apply(self, *ts)

    def exit(self, *ts: torch.Tensor) -> tuple:
        """The trip's outputs: where its backward's span starts."""
        return _TripExit.apply(self, *ts)

    @staticmethod
    def fan_out(t: torch.Tensor, n: int) -> tuple:
        """``n`` views of ``t``, a trip's output standing for ``n`` trips'
        outputs, each of which a literal loop's consumer takes once: their
        ``n`` gradients are added uncounted (a literal loop adds none),
        into a tensor with the strides of each (a slice of a ``cat``'s
        gradient, which the trip's backward copies as a literal one's
        does)."""
        return _FanOut.apply(n, t)


def loop(t: torch.Tensor, n: int, body, state: tuple):
    """``state, out = body(state, i)`` for ``i`` in ``range(n)`` ->
    (the last state, the ``n`` outs).  Where :func:`_loop_counter` of
    ``t`` finds a counter (the meta device), trips 1 to n - 2, which run
    the same ops on the same shapes, run once and count ``n - 2`` times
    (:class:`Trips`), forward and backward: trip 0 (its state carries no
    gradient) and trip n - 1 (its state goes nowhere) run as they are.
    Elsewhere every trip runs."""
    counter = _loop_counter(t)
    if counter is None or n < 4:
        outs = []
        for i in range(n):
            state, out = body(state, i)
            outs.append(out)
        return state, outs
    state, out = body(state, 0)
    outs = [out]
    with Trips(counter, n - 2) as trips:
        state, out = body(trips.enter(*state), 1)
        *state, out = trips.exit(*state, out)
    outs += Trips.fan_out(out, n - 2)
    state, out = body(tuple(state), n - 1)
    outs.append(out)
    return state, outs


class _TripExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, trips, *ts):
        ctx.trips = trips
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        trips = ctx.trips
        trips._backward.append(trips.counter._totals())
        return (None, *gs)


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, t):
        ctx.set_materialize_grads(False)
        with _quiet():
            return tuple(t.view_as(t) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        gs = [g for g in gs if g is not None]
        if not gs:
            return None, None
        with _quiet():     # laid out as each trip's own gradient
            total = torch.empty_strided(gs[0].shape, gs[0].stride(),
                                        dtype=gs[0].dtype,
                                        device=gs[0].device)
            total.copy_(gs[0])
            for g in gs[1:]:
                total.add_(g)
        return None, total


class _TripEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, trips, *ts):
        ctx.trips = trips
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        trips = ctx.trips
        trips.counter._repeat(trips._backward.pop(), trips.n - 1)
        return (None, *gs)
