"""The graph engine's shard groups over ``torch.distributed``.

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
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["GRAPH_AXIS", "ShardGroup", "GridGroups", "graph_group",
           "graph_grid"]

#: the reference's name for the graph engine's 1-D partition axis
GRAPH_AXIS = "gp"

_AS_BYTES = (torch.bool, torch.bfloat16, torch.float16)


def _wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype in _AS_BYTES else t


@dataclass(frozen=True, eq=False)
class ShardGroup:
    """``d`` shards, this process's ``rank`` among them, and their process
    group (``None`` at ``d == 1``).  Every collective is called by every
    member in the same order, or the members deadlock.
    """

    d: int
    rank: int
    group: Optional[object] = None

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
    cached = _GROUPS.get(d)
    if cached is not None and cached.group is world:
        return cached
    if world is None:
        raise ValueError(f"graph_group({d}) needs a process group of {d} "
                         f"ranks and none is initialized; {_launch_hint(d)}")
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


_GRIDS: Dict[int, Tuple[object, GridGroups]] = {}


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
    if cached is not None and cached[0] is world:
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
    _GRIDS[side] = (world, grid)
    return grid
