"""Shard groups over ``torch.distributed``: the graph engine's, and the
LM's (data, model) grid.

Counterpart of ``repro/launch/mesh.py:26-49`` (``graph_mesh``).  The
reference shards over the devices of a 1-D JAX mesh inside one process; the
port runs one process per shard:

    shard i  ==  rank i of the default process group (world size d)

``graph_group(d)`` is the port's ``graph_mesh(d)``.  At ``d == 1`` it needs
no process group and its collectives are the identity, so a single process
(one card, or the CPU) runs the ``"sharded"`` backend as it is.  At
``d > 1`` the caller launches ``d`` ranks (``torch.multiprocessing.spawn``
or ``torchrun``) and each calls ``torch.distributed.init_process_group``
with its rank and the world size ``d``; the backend of that group (NCCL
across cards, gloo across CPU processes or several ranks sharing a card) is
the launcher's choice, never this module's.

There are no placement specs (the reference's ``launch/sharding.py:41-50``):
each rank holds its own block of a per-shard array, and replicated data is
simply held by every rank.

The collectives move ``bool`` and the 16-bit floats as their bytes (a
``uint8`` view, not a conversion): gloo carries neither bfloat16 nor
int16, and every backend carries bytes, so a bfloat16 payload crosses as it
is.

The LM side (counterpart of ``make_host_mesh`` / ``make_production_mesh``,
``repro/launch/mesh.py:52-64``): ``model_grid(data, model)`` lays a world of
``data · model`` ranks out as the reference's ("data", "model") mesh,

    rank  ==  data_i · model + model_i,

and gives each rank its :class:`ModelGroup` along each axis: the ranks
that share its ``data_i`` (tensor and expert parallelism) and those that
share its ``model_i``.  A :class:`ModelGroup` adds the float collectives
tensor parallelism needs (:meth:`ModelGroup.psum`, :meth:`ModelGroup.pmean`,
:meth:`ModelGroup.all_gather_dim`), which the graph engine's
``ShardGroup.all_reduce_sum`` refuses on purpose, with the gradients a
sharded train step needs (Megatron's exit sum and entry copy, and a
gather's backward by whether the members compute one loss or their own;
:class:`ModelGroup`).
``make_production_mesh`` is a :class:`MeshShape`: axis names and sizes with
no ranks behind them, which ``launch/specs.py`` reads.

Counting groups (``counting_group``, ``counting_graph_grid``,
``counting_grid``) describe ``d`` ranks and move nothing: rank 0's place
in the layout, no process group.  Each collective returns what keeps one
rank's shapes and sequence of ops and its values finite (a sum returns its
input, a gather ``d`` copies of it, an exchange its input, a
reduce-scatter its first block) and notes the
call in a :class:`CollectiveLedger`: its kind (the reference's HLO names),
its output bytes (what ``hlo_cost`` sums for a collective) and the bytes
the port's implementation makes the rank receive (``wire_bytes``).
``launch/dryrun.py`` and ``launch/ringo_cells.py`` run a production-mesh
cell over them, on the meta device or on one card.
"""

from __future__ import annotations

import math
import pickle
import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import InitVar, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["GRAPH_AXIS", "ShardGroup", "GridGroups", "graph_group",
           "graph_grid", "MeshShape", "make_production_mesh", "ModelGroup",
           "PHASES", "collective_phase", "regather_saved",
           "ModelGrid", "model_grid", "CollectiveLedger", "counting_group",
           "counting_graph_grid", "counting_grid"]

#: the reference's name for the graph engine's 1-D partition axis
GRAPH_AXIS = "gp"

_AS_BYTES = (torch.bool, torch.bfloat16, torch.float16)


def _wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype in _AS_BYTES else t


@dataclass(frozen=True, eq=False)
class ShardGroup:
    """``d`` shards, this process's ``rank`` among them, and their process
    group ``pg`` (``None`` at ``d == 1``).  Every collective is called by
    every member in the same order, or the members deadlock.

    The group is held by a weak reference, so ``destroy_process_group``
    frees it while the program runs.  A gloo group that a cache still held
    was freed during interpreter shutdown instead, and that aborted the
    process now and then ("terminate called without an active
    exception"; ``probes/group_exit_abort.py``).
    """

    d: int
    rank: int
    pg: InitVar[Optional[object]] = None
    _ref: Optional[weakref.ref] = field(init=False, default=None,
                                        repr=False)

    def __post_init__(self, pg) -> None:
        object.__setattr__(self, "_ref",
                           None if pg is None else weakref.ref(pg))

    @property
    def group(self) -> Optional[object]:
        """The process group (``None``: none, or the default one); raises
        once it has been destroyed."""
        if self._ref is None:
            return None
        pg = self._ref()
        if pg is None:
            raise RuntimeError(f"the process group of this {self.d}-rank "
                               f"ShardGroup was destroyed")
        return pg

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate the members' equal-shaped blocks in rank order."""
        if self.d == 1:
            return t
        w = _wire(t)
        parts = [torch.empty_like(w) for _ in range(self.d)]
        dist.all_gather(parts, w, group=self.group)
        return torch.cat(parts).view(t.dtype)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the members; integer tensors only, so the result is
        exact whatever order the backend adds in."""
        if t.is_floating_point() or t.is_complex():
            raise TypeError(f"all_reduce_sum is exact for integers only, "
                            f"got {t.dtype}; gather float partials with "
                            f"all_gather_cat and add them in rank order")
        if self.d == 1:
            return t
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the members (exact in any order)."""
        if self.d == 1:
            return t
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def broadcast(self, header: Any = None,
                  tensors: Sequence[torch.Tensor] = (), src: int = 0,
                  device=None) -> Tuple[Any, List[torch.Tensor]]:
        """Member ``src`` sends one picklable ``header`` and ``tensors``;
        every member returns ``(header, tensors)``.

        The others pass nothing and receive the tensors on ``device``
        (default: the CPU) with the sender's shapes and dtypes.  The header
        and the tensors' shapes cross as pickled bytes, the tensors as
        themselves (16-bit floats and bool as bytes, as the other
        collectives send them).
        """
        if self.d == 1:
            return header, list(tensors)
        g = self.group
        if self.rank == src:
            tensors = [t.contiguous() for t in tensors]
            blob = pickle.dumps((header, [(tuple(t.shape), t.dtype)
                                          for t in tensors]))
            size = torch.tensor([len(blob)], dtype=torch.int64)
            dist.broadcast(size, src, group=g)
            dist.broadcast(torch.frombuffer(bytearray(blob), dtype=torch.uint8),
                           src, group=g)
            for t in tensors:
                dist.broadcast(_wire(t), src, group=g)
            return header, tensors
        size = torch.empty((1,), dtype=torch.int64)
        dist.broadcast(size, src, group=g)
        buf = torch.empty((int(size),), dtype=torch.uint8)
        dist.broadcast(buf, src, group=g)
        header, specs = pickle.loads(buf.numpy().tobytes())
        out = []
        for shape, dtype in specs:
            t = torch.empty(shape, dtype=dtype, device=device)
            dist.broadcast(_wire(t), src, group=g)
            out.append(t)
        return header, out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block ``j`` of dim 0 goes to member ``j``; returns the blocks
        received, member order (dim 0 must split into ``d`` equal blocks)."""
        if self.d == 1:
            return t
        w = _wire(t)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group)
        return out.view(t.dtype)


_GROUPS: Dict[int, ShardGroup] = {}


def _launch_hint(d: int) -> str:
    return (f"launch {d} processes (torch.multiprocessing.spawn, or torchrun "
            f"--nproc-per-node {d}) that each call "
            f"torch.distributed.init_process_group(backend, "
            f"world_size={d}, rank=<its rank>, ...) first")


def _world() -> Optional[object]:
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def graph_group(n_shards: int) -> ShardGroup:
    """The cached :class:`ShardGroup` of ``n_shards`` ranks.

    ``d == 1`` needs no process group.  ``d > 1`` needs an initialized
    default process group of exactly ``d`` ranks; any other count raises
    ``ValueError``, as the reference raises for more shards than devices.
    """
    d = int(n_shards)
    if d < 1:
        raise ValueError(f"graph_group needs >= 1 shard, got {d}")
    if d == 1:
        return _GROUPS.setdefault(1, ShardGroup(1, 0))
    world = _world()
    if world is None:
        raise ValueError(f"graph_group({d}) needs a process group of {d} "
                         f"ranks and none is initialized; {_launch_hint(d)}")
    cached = _GROUPS.get(d)
    if cached is not None and cached._ref() is world:
        return cached
    size = dist.get_world_size()
    if size != d:
        raise ValueError(f"graph_group({d}) but the process group has "
                         f"{size} rank(s); {_launch_hint(d)}")
    _GROUPS[d] = ShardGroup(d, dist.get_rank(), world)
    return _GROUPS[d]


@dataclass(frozen=True, eq=False)
class GridGroups:
    """A ``side x side`` world as a grid: global rank ``r * side + c`` is
    grid cell ``(r, c)``.

    ``row`` holds the ranks of grid row ``r`` (group rank = ``c``);
    ``col`` those of grid column ``c`` (group rank = ``r``); ``world`` all
    of them.  In the reference's mesh axes, a collective over ``row_axis``
    runs over ``col`` and one over ``col_axis`` over ``row``.
    """

    side: int
    r: int
    c: int
    row: ShardGroup
    col: ShardGroup
    world: ShardGroup

    def transpose(self, t: torch.Tensor) -> torch.Tensor:
        """The grid transpose: cell ``(r, c)`` sends ``t`` to ``(c, r)`` and
        returns what ``(c, r)`` sent (a paired exchange of equal shapes)."""
        if self.r == self.c:
            return t
        peer = self.c * self.side + self.r
        w = _wire(t)
        out = torch.empty_like(w)
        sent = dist.isend(w, peer)
        dist.irecv(out, peer).wait()
        sent.wait()
        return out.view(t.dtype)


_GRIDS: Dict[int, Tuple[weakref.ref, GridGroups]] = {}


def graph_grid(side: int) -> GridGroups:
    """The cached ``side x side`` grid of the default process group.

    Needs a world of exactly ``side ** 2`` ranks (``side == 1``: none).
    Every rank builds every row group, then every column group, in the
    same order (``dist.new_group`` is collective over the whole world).
    """
    side = int(side)
    if side < 1:
        raise ValueError(f"graph_grid needs side >= 1, got {side}")
    if side == 1:
        one = ShardGroup(1, 0)
        return GridGroups(1, 0, 0, one, one, one)
    world = _world()
    cached = _GRIDS.get(side)
    if world is not None and cached is not None and cached[0]() is world:
        return cached[1]
    everyone = graph_group(side * side)
    rank = everyone.rank
    r, c = divmod(rank, side)
    rows = [tuple(i * side + j for j in range(side)) for i in range(side)]
    cols = [tuple(i * side + j for i in range(side)) for j in range(side)]
    row_pgs = [dist.new_group(list(m)) for m in rows]
    col_pgs = [dist.new_group(list(m)) for m in cols]
    grid = GridGroups(side, r, c, row=ShardGroup(side, c, row_pgs[r]),
                      col=ShardGroup(side, r, col_pgs[c]), world=everyone)
    _GRIDS[side] = (weakref.ref(world), grid)
    return grid


# ---------------------------------------------------------------------------
# the LM's (data, model) grid
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no ranks behind them: what the
    reference's ``rules_for`` reads of a ``Mesh`` (``shape``,
    ``axis_names``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 single-pod mesh, or 2×16×16 across two pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


_PHASE = threading.local()
PHASES = ("forward", "backward", "recompute", "gradients", "optimizer")


def _phase() -> str:
    """The step phase a collective is counted under: "backward" inside an
    autograd Function's backward, "recompute" for a forward the backward
    runs again (``torch.utils.checkpoint``), else the innermost
    :func:`collective_phase` ("forward" by default)."""
    return getattr(_PHASE, "name", None) or (
        "recompute" if torch._C._current_graph_task_id() != -1
        else "forward")


@contextmanager
def collective_phase(name: str):
    """Count the collectives called inside under ``name`` (one of
    ``PHASES``) in ``ModelGroup.phase_stats``."""
    prev = getattr(_PHASE, "name", None)
    _PHASE.name = name
    try:
        yield
    finally:
        _PHASE.name = prev


def _fresh_stats() -> Dict[str, float]:
    return {"calls": 0, "bytes": 0, "received": 0, "seconds": 0.0}


class _Exit(torch.autograd.Function):
    """A tensor-parallel region's exit: the members' sum; the members then
    compute one loss from it, so each one's input gradient is the output
    gradient itself."""

    @staticmethod
    def forward(ctx, t, group):
        return group._sum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """A tensor-parallel region's entry: the identity; each member's part
    of the input gradient is summed over the members."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with collective_phase("backward"):
            return ctx.group._sum(g.contiguous()), None


class _Gather(torch.autograd.Function):
    """The members' blocks along ``dim``.  Backward: this member's slice
    of the output gradient where the members compute one loss from the
    gathered tensor (``own_loss`` false), else the members' gradients
    summed and this member's slice kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, group, dim, own_loss):
        ctx.group, ctx.dim, ctx.own_loss = group, dim, own_loss
        ctx.size = t.shape[dim]
        return group._gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        if ctx.own_loss:
            with collective_phase("backward"):
                return group._reduce_scatter(g, dim), None, None, None
        return g.narrow(dim, group.rank * ctx.size, ctx.size), None, None, \
            None


class _WeightGather(torch.autograd.Function):
    """A weight block gathered whole on ``dim`` over the grid's weights'
    data group, cast to ``dtype`` first.  Backward: the data ranks'
    gradients reduce-scattered back to the block in float32 in rank
    order, summed over the pods in order, divided by the folded data
    size, and added to the block's ``reduced_grad`` (float32); the block
    gets no ``grad``.  Saves nothing gathered."""

    @staticmethod
    def forward(ctx, block, grid, dim, dtype):
        ctx.grid, ctx.dim, ctx.block = grid, dim, block
        return grid.weight_data._gather(block.detach().to(dtype), dim)

    @staticmethod
    def backward(ctx, g):
        with collective_phase("backward"):
            gf = ctx.grid._weight_grad(g.contiguous(), ctx.dim)
        p = ctx.block
        old = getattr(p, "reduced_grad", None)
        p.reduced_grad = gf if old is None else old + gf
        return None, None, None, None


class _Regather:
    """A saved tensor that was a gathered weight, or a view of one:
    gathered again when the backward unpacks it."""

    def __init__(self, how: tuple, t: torch.Tensor, whole: bool):
        self.how, self.whole = how, whole
        self.geometry = (tuple(t.shape), t.stride(), t.storage_offset())

    def gather(self) -> torch.Tensor:
        grid, block, dim, dtype = self.how
        with collective_phase("backward"):
            full = grid.weight_data._gather(block.detach().to(dtype), dim)
        return full if self.whole else full.as_strided(*self.geometry)


def _pack(t: torch.Tensor):
    """A gathered weight (it carries ``regather``: grid, block, dim,
    dtype), or a view of one, saved as a note."""
    for cand in (t, t._base):
        how = getattr(cand, "regather", None)
        if how is not None:
            return _Regather(how, t, cand is t)
    return t


def _unpack(x):
    return x.gather() if isinstance(x, _Regather) else x


def regather_saved():
    """A context in which autograd saves no gathered weight: a product
    that keeps its weight operand for the backward keeps a note instead,
    and the backward gathers the weight again (FSDP's way), so a rank
    holds about one layer's gathered weights at a time, not its model
    block's, whatever ``remat``.  Each data rank's backward gathers in
    the same order, as its forward did."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


class _Mean(torch.autograd.Function):
    """The members' mean.  Backward: a ``d``-th of the output gradient
    where the members compute one loss from it, else the mean of the
    members' output gradients."""

    @staticmethod
    def forward(ctx, t, group, own_loss):
        ctx.group, ctx.own_loss = group, own_loss
        return group._sum(t) / group.d

    @staticmethod
    def backward(ctx, g):
        if ctx.own_loss:
            with collective_phase("backward"):
                return ctx.group._sum(g.contiguous()) / ctx.group.d, None, \
                    None
        return g / ctx.group.d, None, None


class _Same(torch.autograd.Function):
    """The identity on a tensor every member computes alike; a ``d``-th of
    its gradient goes back, so the members' summed gradients count it
    once."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.d = group.d
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.d, None


def pad_to(t: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """``t`` with zeros after it on ``dim`` up to ``width``."""
    if t.shape[dim] == width:
        return t
    shape = list(t.shape)
    shape[dim] = width - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim)


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


@dataclass(frozen=True, eq=False)
class ModelGroup(ShardGroup):
    """One axis of a :class:`ModelGrid`: a :class:`ShardGroup` with the float
    collectives of tensor parallelism.

    ``stats`` counts this member's calls, the bytes it sends and receives
    and the host seconds spent in them (a collective on card tensors waits
    for the work queued before it, and that wait is counted too);
    ``phase_stats`` splits the same counts by :func:`_phase`.  At ``d ==
    1`` every collective returns its input and counts nothing.  A group
    built without a process group at ``d > 1`` (a description, as
    ``launch/specs.py`` uses) raises on any collective; the groups of
    ``counting_grid`` count them instead.

    Gradients (Megatron's pair of operators, and the gather's two
    backwards).  On the model axis the members compute one loss; on the
    data axis each member computes its own, and the train step sums them
    (``train/zero.py``):

    * :meth:`psum`, a region's exit: the sum; backward the identity;
    * :meth:`enter`, a region's entry: the identity; backward :meth:`psum`
      of the input gradient;
    * :meth:`all_gather_dim`: backward this member's slice (one loss), or
      with ``own_loss`` a reduce-scatter in member order;
    * :meth:`pmean`: backward ``g / d`` (one loss), or with ``own_loss``
      the mean of the members' ``g``;
    * :meth:`same`: the identity on a value every member computes alike;
      backward ``g / d``.

    Every backward sum adds the parts in member order, as :meth:`psum`
    does, so the members hold the same bits.  The raw collectives
    (``_sum``, ``_gather``, ``_reduce_scatter``, ``_sum_over``,
    ``_all_to_all``) carry no gradient; the counting groups override them,
    so a backward's collectives, and a recompute's forward ones, are
    counted as they run.
    """

    stats: Dict[str, float] = field(default_factory=_fresh_stats,
                                    compare=False)
    phase_stats: Dict[str, Dict[str, float]] = field(default_factory=dict,
                                                      compare=False)

    def _count(self, sent: float, received: float, t0: float) -> None:
        dt = time.perf_counter() - t0
        for st in (self.stats, self.phase_stats.setdefault(
                _phase(), _fresh_stats())):
            st["calls"] += 1
            st["bytes"] += sent
            st["received"] += received
            st["seconds"] += dt

    def _check_group(self) -> None:
        if self._ref is None:
            raise RuntimeError(f"this {self.d}-rank ModelGroup has no "
                               f"process group; it only describes a layout")

    def _parts(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``t`` (equal shapes), in member order."""
        self._check_group()
        t0 = time.perf_counter()
        w = _wire(t)
        parts = [torch.empty_like(w) for _ in range(self.d)]
        dist.all_gather(parts, w, group=self.group)
        b = w.numel() * w.element_size()
        self._count(b, (self.d - 1) * b, t0)
        return [p.view(t.dtype) for p in parts]

    def _all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block ``j`` of dim 0 to member ``j``; the blocks received, in
        member order (no gradient)."""
        self._check_group()
        t0 = time.perf_counter()
        out = ShardGroup.all_to_all(self, t.contiguous())
        b = _nbytes(t)
        self._count(b, (self.d - 1) / self.d * b, t0)
        return out

    # -- raw collectives (no gradient) ------------------------------------

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """The members' ``t`` added in float32 in member order, cast back
        to ``t``'s dtype."""
        return self._sum_over(t, range(self.d))

    def _sum_over(self, t: torch.Tensor, members) -> torch.Tensor:
        """:meth:`_sum` of ``members``' parts only (every member calls
        it)."""
        parts = self._parts(t.contiguous())
        members = list(members)
        out = parts[members[0]].float()
        for i in members[1:]:
            out = out + parts[i].float()
        return out.to(t.dtype)

    def _sum_ranges(self, t: torch.Tensor, dim: Optional[int],
                    ranges) -> torch.Tensor:
        """Member ``i`` holds positions ``ranges[i]`` = (start, size) of an
        axis on ``dim`` of ``t`` (sizes may differ, ranges overlap): each
        of this member's positions summed in float32, in member order, over
        the members that hold it, cast back (:meth:`_sum` where ``ranges``
        is None: every member holds all of ``t``).  The parts cross padded
        to the widest range."""
        if ranges is None:
            return self._sum(t)
        width = max(n for _, n in ranges)
        parts = self._parts(pad_to(t, dim, width).contiguous())
        s, n = ranges[self.rank]
        out = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for q, (a, b) in enumerate(ranges):
            lo, hi = max(a, s), min(a + b, s + n)
            if lo < hi:
                out.narrow(dim, lo - s, hi - lo).add_(
                    parts[q].narrow(dim, lo - a, hi - lo).float())
        return out.to(t.dtype)

    def _gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._parts(t.contiguous()), dim=dim)

    def _reduce_scatter(self, t: torch.Tensor, dim: int,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Split ``t`` into ``d`` blocks along ``dim``; member ``j``
        receives every member's block ``j`` and adds them in float32 in
        member order -> its block, in ``dtype`` (default ``t``'s)."""
        moved = t.movedim(dim, 0)
        n = moved.shape[0] // self.d
        got = self._all_to_all(moved.reshape(self.d, n, *moved.shape[1:]))
        out = got[0].float()
        for i in range(1, self.d):
            out = out + got[i].float()
        return out.to(dtype or t.dtype).movedim(0, dim)

    # -- collectives with gradients ---------------------------------------

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of the members' ``t``, in ``t``'s dtype on every member.

        The parts cross as they are (a bfloat16 tensor as its bytes) and
        are added in float32 in member order, then cast back, so every
        member holds the same bits and two runs agree.  The reference sums
        in the compute dtype (``psum`` in ``models/moe.py:253``); gloo has
        no bfloat16 sum.  At ``d == 2`` the float32 sum of two bfloat16
        values rounded to bfloat16 is their bfloat16 sum itself; at
        ``d > 2`` it rounds once where a bfloat16 sum rounds ``d - 1``
        times, so the two agree within tolerance only.  Backward: the
        identity (a region's exit).
        """
        if self.d == 1:
            return t
        if _tracked(t):
            return _Exit.apply(t, self)
        return self._sum(t)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """A region's entry: ``t`` itself; backward, the members' input
        gradients summed (:meth:`psum`)."""
        if self.d == 1 or not _tracked(t):
            return t
        return _Enter.apply(t, self)

    def pmean(self, t: torch.Tensor, own_loss: bool = False
              ) -> torch.Tensor:
        """:meth:`psum` / ``d`` (the reference's ``pmean``)."""
        if self.d == 1:
            return t
        if _tracked(t):
            return _Mean.apply(t, self, own_loss)
        return self._sum(t) / self.d

    def same(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, computed alike on every member (class docstring)."""
        if self.d == 1 or not _tracked(t):
            return t
        return _Same.apply(t, self)

    def all_gather_dim(self, t: torch.Tensor, dim: int,
                       own_loss: bool = False) -> torch.Tensor:
        """The members' equal-shaped blocks concatenated along ``dim`` in
        member order (exact: nothing is added)."""
        if self.d == 1:
            return t
        if _tracked(t):
            return _Gather.apply(t, self, dim % t.dim(), own_loss)
        return self._gather(t, dim)


@dataclass(frozen=True, eq=False)
class ModelGrid:
    """A world of ``data · model`` ranks as the reference's ("data",
    "model") mesh: rank ``data_i · model + model_i``.

    ``model`` holds the ranks with this rank's ``data_i`` (group rank
    ``model_i``), ``data`` those with its ``model_i`` (group rank
    ``data_i``).  ``shape`` and ``axis_names`` read as a mesh's, so
    ``launch/specs.rules_for`` takes a grid.

    Weights split over "data" (``two_d_weights``): :meth:`weight`
    gathers a block over :attr:`weight_data`, the ranks of the "data"
    axis alone; on two pods (the counting grids) that is one pod's 16,
    where ``data`` folds pod × data, and a weight's gradient is summed
    over the pods (:attr:`pods`) after its reduce-scatter, as the
    reference's specs place them (``w_embed`` on "data", the batch on
    ("pod", "data")).
    """

    data: ModelGroup
    model: ModelGroup
    wdata: Optional[ModelGroup] = None
    pod: Optional[ModelGroup] = None

    axis_names = ("data", "model")

    @property
    def weight_data(self) -> ModelGroup:
        """The group a 2-D weight's block is split over: ``data`` on one
        pod."""
        return self.wdata if self.wdata is not None else self.data

    @property
    def pods(self) -> ModelGroup:
        return self.pod if self.pod is not None else ModelGroup(1, 0)

    def weight(self, p: torch.Tensor, dim: int, dtype) -> torch.Tensor:
        """The whole of weight ``p`` on ``dim`` from the blocks the weights'
        data ranks hold, in ``dtype`` (every rank of the group calls it in
        the same order).  Under autograd its backward reduce-scatters the
        gradient into ``p.reduced_grad`` (:class:`_WeightGather`), and
        :func:`regather_saved` gathers it again where the backward needs
        it; with no process group at more than one rank it raises."""
        if not _tracked(p):
            return self.weight_data._gather(p.detach().to(dtype), dim)
        out = _WeightGather.apply(p, self, dim, dtype)
        out.regather = (self, p, dim, dtype)
        return out

    def _weight_grad(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """A gathered weight's gradient -> the float32 gradient of the
        rank's block: reduce-scattered over the weights' data ranks, summed
        over the pods, divided by the folded data size (the train step's
        mean over data shards, ``train/zero.py``)."""
        gf = self.weight_data._reduce_scatter(g, dim, torch.float32)
        if self.pods.d > 1:
            gf = self.pods._sum(gf)
        return gf / self.data.d

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.d, "model": self.model.d}

    @property
    def size(self) -> int:
        return self.data.d * self.model.d

    @property
    def coords(self) -> Dict[str, Tuple[int, int]]:
        """{axis: (this rank's index, the axis size)}: what
        ``launch/sharding.local_block`` reads."""
        return {"data": (self.data.rank, self.data.d),
                "model": (self.model.rank, self.model.d)}


_MODEL_GRIDS: Dict[Tuple[int, int], Tuple[weakref.ref, ModelGrid]] = {}


def model_grid(data: int = 1, model: int = 1) -> ModelGrid:
    """The cached (``data``, ``model``) grid of the default process group,
    the port's ``make_host_mesh(data, model)``.

    A grid of one rank needs no process group.  Any other needs a world of
    exactly ``data · model`` ranks; every rank builds every model group,
    then every data group, in the same order (``dist.new_group`` is
    collective over the world).  An axis of size 1 gets no process group.
    """
    data, model = int(data), int(model)
    if data < 1 or model < 1:
        raise ValueError(f"model_grid needs data, model >= 1, got "
                         f"({data}, {model})")
    n = data * model
    if n == 1:
        return ModelGrid(ModelGroup(1, 0), ModelGroup(1, 0))
    world = _world()
    if world is None:
        raise ValueError(f"model_grid({data}, {model}) needs a process group "
                         f"of {n} ranks and none is initialized; "
                         f"{_launch_hint(n)}")
    cached = _MODEL_GRIDS.get((data, model))
    if cached is not None and cached[0]() is world:
        return cached[1]
    size = dist.get_world_size()
    if size != n:
        raise ValueError(f"model_grid({data}, {model}) but the process group "
                         f"has {size} rank(s); {_launch_hint(n)}")
    d_i, m_i = divmod(dist.get_rank(), model)

    def axis(count, members, mine, index):
        if count == 1:
            return ModelGroup(1, 0)
        pgs = [dist.new_group(list(m)) for m in members]
        return ModelGroup(count, index, pgs[mine])

    model_g = axis(model, [range(i * model, (i + 1) * model)
                           for i in range(data)], d_i, m_i)
    data_g = axis(data, [range(j, n, model) for j in range(model)], m_i, d_i)
    grid = ModelGrid(data=data_g, model=model_g)
    _MODEL_GRIDS[(data, model)] = (weakref.ref(world), grid)
    return grid


# ---------------------------------------------------------------------------
# counting groups: d ranks described, nothing moved
# ---------------------------------------------------------------------------


class CollectiveLedger:
    """What the counting groups of one layout noted, by collective kind
    ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute"):

    * ``calls``;
    * ``bytes``: the collective's output bytes, the reference's accounting
      (``repro/launch/hlo_cost.py`` sums the output shape of each
      collective op);
    * ``wire_bytes``: what the port's implementation makes this rank
      receive: ``ModelGroup.psum`` and every gather take the other
      ``d - 1`` parts, ``dist.all_reduce`` (the graph engine's integer
      sums) a ring's ``2 (d - 1) / d`` of the tensor, ``all_to_all`` and
      a reduce-scatter (``all_to_all`` then an ordered sum) the ``d - 1``
      blocks of the others, the grid transpose the peer's tensor (nothing
      on the diagonal).

    ``listeners`` are called as ``listener(kind, out, in_bytes)`` with each
    collective's output tensor (``launch/hlo_cost.py`` charges its bytes
    and tracks it as live memory).
    """

    def __init__(self) -> None:
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, float] = {}
        self.wire_bytes: Dict[str, float] = {}
        self.listeners: List[Any] = []

    def note(self, kind: str, out: torch.Tensor, in_bytes: float,
             wire_bytes: float) -> torch.Tensor:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0.0) + _nbytes(out)
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0.0) + wire_bytes
        for listener in self.listeners:
            listener(kind, out, in_bytes)
        return out

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "wire_bytes": dict(self.wire_bytes)}

    def repeat_since(self, snap: Dict[str, Dict[str, float]],
                     times: int) -> None:
        """Note ``times`` more of what was noted since ``snap`` (a
        :meth:`snapshot`), as ``launch/hlo_cost.Trips`` counts one trip
        for many; the listeners are not called again."""
        for key in ("calls", "bytes", "wire_bytes"):
            now = getattr(self, key)
            for kind, v in list(now.items()):
                now[kind] = v + times * (v - snap[key].get(kind, 0))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _quiet():
    """The stand-in ops of a counted collective, hidden from the counting
    modes of ``launch/hlo_cost.py`` (the ledger's listener charges the
    collective instead)."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


def _copies(t: torch.Tensor, d: int, dim: int = 0) -> torch.Tensor:
    with _quiet():
        return torch.cat([t] * d, dim=dim)


def _same(t: torch.Tensor) -> torch.Tensor:
    with _quiet():
        return t.clone()


@dataclass(frozen=True, eq=False)
class _CountingShardGroup(ShardGroup):
    """A :class:`ShardGroup` of ``d`` ranks with no process group: each
    collective notes itself in ``ledger`` and moves nothing."""

    ledger: CollectiveLedger = field(default_factory=CollectiveLedger,
                                     compare=False)

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        if self.d == 1:
            return t
        b = _nbytes(t)
        return self.ledger.note("all-gather", _copies(t, self.d), b,
                                (self.d - 1) * b)

    def _ring_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.d == 1:
            return t
        b = _nbytes(t)
        return self.ledger.note("all-reduce", _same(t), b,
                                2.0 * (self.d - 1) / self.d * b)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`ShardGroup.all_reduce_sum`'s input (integers only)."""
        if t.is_floating_point() or t.is_complex():
            return super().all_reduce_sum(t)     # raises as there
        return self._ring_sum(t)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._ring_sum(t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        if self.d == 1:
            return t
        b = _nbytes(t)
        return self.ledger.note("all-to-all", _same(t), b,
                                (self.d - 1) / self.d * b)

    def broadcast(self, header: Any = None,
                  tensors: Sequence[torch.Tensor] = (), src: int = 0,
                  device=None) -> Tuple[Any, List[torch.Tensor]]:
        raise NotImplementedError("a counting group carries no broadcast: "
                                  "no cell of the dry run sends one")


@dataclass(frozen=True, eq=False)
class _CountingGridGroups(GridGroups):
    """A :class:`GridGroups` of counting groups; the transpose notes a
    collective-permute."""

    ledger: CollectiveLedger = field(default_factory=CollectiveLedger,
                                     compare=False)

    def transpose(self, t: torch.Tensor) -> torch.Tensor:
        b = _nbytes(t)
        out = t if self.r == self.c else _same(t)
        return self.ledger.note("collective-permute", out, b,
                                0.0 if self.r == self.c else b)


@dataclass(frozen=True, eq=False)
class _CountingModelGroup(ModelGroup):
    """A :class:`ModelGroup` of ``d`` ranks with no process group: each raw
    collective notes itself in ``ledger`` and returns what keeps one
    rank's shapes (a sum its input, a gather ``d`` copies, a
    reduce-scatter its first block), so the collectives with gradients
    count their backwards too."""

    ledger: CollectiveLedger = field(default_factory=CollectiveLedger,
                                     compare=False)

    def _sum_over(self, t: torch.Tensor, members) -> torch.Tensor:
        b = _nbytes(t)
        return self.ledger.note("all-reduce", _same(t), b, (self.d - 1) * b)

    def _sum_ranges(self, t: torch.Tensor, dim: Optional[int],
                    ranges) -> torch.Tensor:
        """Counted as a sum of the widest range's parts."""
        if ranges is None:
            return self._sum(t)
        b = _nbytes(t) // max(t.shape[dim], 1) * max(n for _, n in ranges)
        return self.ledger.note("all-reduce", _same(t), b, (self.d - 1) * b)

    def _gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        b = _nbytes(t)
        return self.ledger.note("all-gather", _copies(t, self.d, dim), b,
                                (self.d - 1) * b)

    def _reduce_scatter(self, t: torch.Tensor, dim: int,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        b = _nbytes(t)
        with _quiet():
            out = t.narrow(dim, 0, t.shape[dim] // self.d).to(
                dtype or t.dtype, copy=True)
        return self.ledger.note("reduce-scatter", out, b,
                                (self.d - 1) / self.d * b)

    def _all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        b = _nbytes(t)
        return self.ledger.note("all-to-all", _same(t), b,
                                (self.d - 1) / self.d * b)


@dataclass(frozen=True, eq=False)
class _CountingModelGrid(ModelGrid):
    """Rank 0 of a production mesh as a (data, model) grid: ``data`` spans
    every batch axis ("pod" x "data"), and ``coords`` names each mesh axis,
    so the specs that split over ("pod", "data") find their axes."""

    mesh_shape: Dict[str, int] = field(default_factory=dict)

    @property
    def coords(self) -> Dict[str, Tuple[int, int]]:
        return {ax: (0, n) for ax, n in self.mesh_shape.items()}


def counting_group(d: int, rank: int = 0,
                   ledger: Optional[CollectiveLedger] = None) -> ShardGroup:
    """Member ``rank`` of ``d`` graph shards, collectives counted in
    ``ledger`` (a new one by default)."""
    return _CountingShardGroup(int(d), int(rank),
                               ledger=ledger or CollectiveLedger())


def counting_graph_grid(side: int,
                        ledger: Optional[CollectiveLedger] = None
                        ) -> GridGroups:
    """Cell (0, 0) of a ``side x side`` grid of counting groups, all noting
    in one ``ledger``."""
    ledger = ledger or CollectiveLedger()
    row = _CountingShardGroup(side, 0, ledger=ledger)
    col = _CountingShardGroup(side, 0, ledger=ledger)
    world = _CountingShardGroup(side * side, 0, ledger=ledger)
    return _CountingGridGroups(side, 0, 0, row, col, world, ledger=ledger)


def counting_grid(mesh, ledger: Optional[CollectiveLedger] = None
                  ) -> ModelGrid:
    """Rank 0 of ``mesh`` (a :class:`MeshShape`, or anything with
    ``shape``) as a :class:`ModelGrid` of counting groups noting in one
    ``ledger``: the model axis as it is, "pod" x "data" folded into the
    data axis; a 2-D weight's gather over "data" alone, its gradient then
    summed over "pod" (:class:`ModelGrid`)."""
    ledger = ledger or CollectiveLedger()
    shape = dict(mesh.shape)
    pods = shape.get("pod", 1)
    data = pods * shape.get("data", 1)
    return _CountingModelGrid(
        data=_CountingModelGroup(data, 0, ledger=ledger),
        model=_CountingModelGroup(shape.get("model", 1), 0, ledger=ledger),
        wdata=_CountingModelGroup(shape.get("data", 1), 0, ledger=ledger)
        if pods > 1 else None,
        pod=_CountingModelGroup(pods, 0, ledger=ledger) if pods > 1
        else None,
        mesh_shape=shape)
