"""The sharded train step: a model over a (data, model) grid with ZeRO-1
optimizer state (see ``repro/launch/train.py:39-54`` and ``:84-88``).

The reference builds its sharded parameters and state with
``out_shardings`` and runs one ``jax.jit`` step that GSPMD partitions.  The
port does it explicitly.  A rank of a ``launch.mesh.ModelGrid`` holds its
model block of each parameter (``models/transformer.param_blocks``); the
forward's collectives carry the gradients (``launch/mesh.ModelGroup``);
and each rank keeps the optimizer state of one data shard of its block
only, ZeRO-1.  Each parameter's layout is a :class:`Leaf`:

* ``zdim``: the dim of the block split over "data" for the optimizer, by
  ``train/optimizer.zero1_extend_spec``'s rule on the reference's spec and
  the full shape: the first dim that is not split and that divides by the
  data size.  The data size is the grid's data axis, all batch axes
  folded (on two pods, pod × data: 32).  None: every data rank holds the
  whole block's state;
* ``ddim``: the dim the spec itself splits over "data" (``two_d_weights``:
  a weight's d_model dim, over the "data" axis of one pod, ``wd`` ranks);
  such a block is the rank's own, so it has no ``zdim``, and its gradient
  arrives reduced over the data ranks by the forward's weight gather
  (``launch/mesh.ModelGrid.weight``), in float32 in
  ``reduced_grad``;
* ``mdim``: the dim split over "model" (None: whole on every model rank;
  ``models/transformer.model_dim``: the spec's, a Mamba's ``a_log`` on
  its channels); ``mranges``: every model rank's (start, size) on it,
  which differ where attention's or an mLSTM's heads do not split evenly
  (``models/transformer.model_ranges``: whole heads, a rank with none
  holding zero width);
  ``holders``: the model ranks holding the same block (all of them for a
  whole parameter, the ranks reading the same KV heads for a ``wk`` /
  ``wv`` leaf); ``members``: the model ranks whose gradients add up to the
  block's (``models/transformer.grad_members``: shared KV heads, the MoE
  router), each KV head summed over the ranks that hold it; ``msum``:
  some rank's block is such a sum, so every model rank joins it.  A
  position of the whole parameter is counted (norm, Adafactor's sums,
  the checkpoint) by the first rank that holds it (:meth:`Leaf.owned`).

:func:`train_step`, in order:

1. the value and gradient of ``Transformer.loss_fn`` on the rank's rows
   (K4 forward, the PyTorch backward), then each ``members`` leaf's
   gradient summed over those model ranks in rank order;
2. each gradient reduce-scattered over "data" in rank order, in float32:
   a rank receives the other data ranks' parts of its own ZeRO block,
   (d − 1)/d of a gradient, adds them in rank order and divides by the
   data size (a leaf with no ``zdim``: the whole gradient, summed the same
   way; a ``ddim`` leaf: already done by the weight gather's backward);
3. clipping by the global norm of the whole gradient: each rank's sum of
   squares over its blocks, a position that several ranks hold counted by
   the first of them only, summed over "model" then over "data" in rank order;
4. the optimizer's update of the ZeRO block of the parameter, in place,
   and of its state: AdamW elementwise; Adafactor over the reference's
   stacked parameters (``train/optimizer.stack_groups``: a group's layers
   are all on the rank), its row, column and RMS means over the whole
   stacked parameter, from partial sums over its layers and over the
   ranks that hold its pieces, each position counted by its first holder
   (a KV head that straddles ranks too), in rank order
   (:class:`BlockMeans`); the
   reference's formulas, float32 scalars included
   (``train/optimizer.py``);
5. the updated blocks all-gathered over "data" (a ``ddim`` block is the
   rank's own: nothing to gather).

Every rank then holds the same bits in what it shares with another: the
norms, the router, a shared KV head's columns, and a block's data
replicas.  The state's layout is step 0's, :func:`init_state`'s, the
structs of ``launch/specs.opt_structs``: AdamW's m and v per parameter,
the ZeRO block's shape; Adafactor's per stacked group (``f[key]``), the
factors of the group's stack of ZeRO blocks, of the whole stacked
parameter's factoring.  :func:`full_tree` and
:func:`block_sinks` gather and cut the checkpoint's leaves, which are a
one-rank run's (``launch/train.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..launch.mesh import MeshShape, collective_phase, pad_to
from ..launch.sharding import _axes
from ..models.transformer import (grad_members, model_dim, model_holders,
                                  model_ranges, param_blocks)
from .optimizer import (Means, OptHyper, _factored, adafactor_leaf,
                        adafactor_update, adamw_init, adamw_update,
                        clip_by_global_norm, stack_groups, zero1_extend_spec)

__all__ = ["Leaf", "layout_for", "layout", "init_state", "state_structs",
           "BlockMeans", "apply_gradients", "train_step", "full_tree",
           "block_sinks",
           "state_dims"]


@dataclass(frozen=True)
class Leaf:
    """One parameter's place on the grid (module docstring)."""
    full: Tuple[int, ...]
    mdim: Optional[int]
    mranges: Optional[Tuple[Tuple[int, int], ...]]   # (start, size) a rank
    holders: Tuple[int, ...]
    members: Tuple[int, ...]
    msum: bool
    zdim: Optional[int]
    m_rank: int
    d_rank: int
    d: int
    ddim: Optional[int] = None
    w_rank: int = 0
    wd: int = 1

    @property
    def m_owner(self) -> bool:
        """This rank is the first that holds its block."""
        return self.m_rank == self.holders[0]

    @property
    def mrange(self) -> Tuple[int, int]:
        """(start, size) of this rank's block on ``mdim``."""
        return self.mranges[self.m_rank]

    def owned(self, q: int) -> Tuple[int, int]:
        """(start, size) of the part of model rank ``q``'s range that no
        lower rank holds (the ranges ascend, so these tile the dim)."""
        s, n = self.mranges[q]
        lo = max([s] + [a + b for a, b in self.mranges[:q]])
        return lo, max(s + n - lo, 0)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The part of ``t`` (this rank's block, or its ZeRO block) that
        this rank counts: its :meth:`owned` range on ``mdim``; a whole
        parameter on its first holder, nothing elsewhere."""
        if self.mdim is None:
            return t if self.m_owner else t.narrow(0, 0, 0)
        lo, n = self.owned(self.m_rank)
        if n == self.mrange[1]:     # all of it (a ZeRO block may split it)
            return t
        return t.narrow(self.mdim, lo - self.mrange[0], n)

    @property
    def d_owner(self) -> bool:
        """This rank's block of the state is its own (not a data replica's
        copy): a ZeRO block, a 2-D block on the first pod (the folded data
        index is pod · wd + data), or a whole block on data rank 0."""
        if self.ddim is not None:
            return self.d_rank < self.wd
        return self.zdim is not None or self.d_rank == 0

    def zblock(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's ZeRO block of ``t`` (the model block's shape): a
        view."""
        if self.zdim is None:
            return t
        n = t.shape[self.zdim] // self.d
        return t.narrow(self.zdim, self.d_rank * n, n)


def _mrange(full: torch.Tensor, block: torch.Tensor, mdim) -> Tuple[int, int]:
    """Where ``block`` (a view of the contiguous ``full``) starts on
    ``mdim``, and its size there."""
    start = block.storage_offset() // full.stride(mdim) % full.shape[mdim]
    return start, block.shape[mdim]


def layout_for(cfg, coords: Dict[str, Tuple[int, int]], rules,
               data: Tuple[int, int]) -> Dict[str, Leaf]:
    """``{name: Leaf}`` of the rank at ``coords`` (``{axis: (index,
    size)}``) under ``rules``; ``data``: its (index, size) on the folded
    data axis."""
    di, d = data
    r, m = coords.get("model", (0, 1))
    wi, wd = coords.get("data", (0, 1))
    dmesh = MeshShape(("data",), (d,))
    out = {}
    for name, (full, spec, keep) in param_blocks(cfg, coords, rules).items():
        mdim = model_dim(name, spec)
        ddim = next((i for i, e in enumerate(spec)
                     if "data" in _axes(e)), None) if wd > 1 else None
        zdim = None
        if d > 1:
            ext = zero1_extend_spec(spec, tuple(full.shape), dmesh)
            zdim = next((i for i, (a, b) in enumerate(zip(ext, spec))
                         if a == "data" and b != "data"), None)
        ranges = model_ranges(cfg, name, spec, tuple(full.shape), m)
        if mdim is not None and ranges[r][1] and \
                ranges[r] != _mrange(full, keep(full), mdim):
            raise AssertionError(f"{name}: the block is not at "
                                 f"model_ranges' {ranges[r]}")
        out[name] = Leaf(
            full=tuple(full.shape), mdim=mdim, mranges=ranges,
            holders=model_holders(cfg, name, spec, m, r),
            members=grad_members(cfg, name, spec, m, r),
            msum=any(len(grad_members(cfg, name, spec, m, q)) > 1
                     for q in range(m)), zdim=zdim,
            m_rank=r, d_rank=di, d=d, ddim=ddim, w_rank=wi, wd=wd)
    return out


def layout(model) -> Dict[str, Leaf]:
    """The layout of ``model``'s parameters on its grid (cached on it)."""
    lay = getattr(model, "_zero_layout", None)
    if lay is None:
        grid = model.grid
        lay = layout_for(model.cfg, grid.coords, model.rules,
                         (grid.data.rank, grid.data.d))
        model._zero_layout = lay
    return lay


def _state(opt_name: str, blocks: Dict[str, torch.Tensor],
           lay: Dict[str, Leaf]):
    if opt_name == "adamw":
        return adamw_init(blocks)
    if opt_name == "adafactor":
        out = {}
        for key, (stack, members) in stack_groups(blocks).items():
            b = blocks[members[0][1]]
            out[key] = adafactor_leaf(
                stack, tuple(b.shape),
                _factored(stack + lay[members[0][1]].full), b.device)
        return {"f": out}
    raise ValueError(f"unknown optimizer {opt_name!r}")


def init_state(opt_name: str, model):
    """Zero optimizer state of the rank's ZeRO blocks: AdamW's m and v of
    each block, or Adafactor's factors of each stacked group's blocks (of
    the whole stacked parameter's factoring)."""
    lay = layout(model)
    return _state(opt_name, {k: lay[k].zblock(p.detach())
                             for k, p in model.named_parameters()}, lay)


def state_structs(cfg, coords, rules, data: Tuple[int, int]):
    """:func:`init_state`'s tree on the meta device for the rank at
    ``coords`` (``launch/specs.opt_structs``)."""
    lay = layout_for(cfg, coords, rules, data)
    blocks = {k: lay[k].zblock(keep(full)) for k, (full, _, keep)
              in param_blocks(cfg, coords, rules).items()}
    return _state(cfg.optimizer, blocks, lay)


def state_dims(name: str, nd: int, k: int = 0) -> Tuple[int, ...]:
    """The parameter dims a state leaf keeps, -1 for each of its ``k``
    leading stack dims (an Adafactor group's layers): all for m, v and
    Adafactor's ``v``; all but the stacked parameter's last for ``vr``;
    all but its second-to-last for ``vc``."""
    dims = (-1,) * k + tuple(range(nd))
    if name == "vr":
        return dims[:-1]
    if name == "vc":
        return dims[:-2] + dims[-1:]
    return dims


class BlockMeans(Means):
    """Adafactor's sums over a whole parameter from a rank's ZeRO block:
    the block's partial sums over the positions it counts (on the model
    dim, its :meth:`Leaf.owned` range: a position that several ranks hold,
    a KV head shared by ranks whose query heads straddle it, counted by
    its first holder), added over the model ranks, over the data ranks
    when the dim is the ZeRO one, and over the weights' data ranks when
    it is the one the spec splits over "data", in rank order."""

    def __init__(self, lay: Dict[str, Leaf], grid):
        self.lay, self.grid = lay, grid

    def shape(self, k, p):
        return self.lay[k].full

    def part(self, k, t, dim, pdim):
        leaf = self.lay[k]
        if self.grid.model.d == 1 or pdim != leaf.mdim:
            return t
        lo, n = leaf.owned(leaf.m_rank)
        if n == leaf.mrange[1]:     # all of it (a ZeRO block may split it)
            return t
        return t.narrow(dim, lo - leaf.mrange[0], n)

    def total(self, k, part, dims):
        leaf, grid = self.lay[k], self.grid
        if grid.model.d > 1 and leaf.mdim in dims:
            part = grid.model._sum(part)
        if grid.data.d > 1 and leaf.zdim in dims:
            part = grid.data._sum(part)
        if leaf.ddim in dims:
            part = grid.weight_data._sum(part)
        return part


def _reduce(g: torch.Tensor, leaf: Leaf, grid) -> torch.Tensor:
    """Steps 1's model-axis sum and 2 for one leaf -> the float32 gradient
    of its ZeRO block (a ``ddim`` leaf's ``g``: its ``reduced_grad``,
    summed over "data" already)."""
    g = g.float()
    if leaf.msum:
        g = grid.model._sum_ranges(g, leaf.mdim, leaf.mranges)
    data = grid.data
    if data.d == 1 or leaf.ddim is not None:
        return g
    if leaf.zdim is not None:
        return data._reduce_scatter(g, leaf.zdim, torch.float32) / data.d
    return data._sum(g) / data.d


def _global_norm(grads: Dict[str, torch.Tensor], lay: Dict[str, Leaf],
                 grid) -> torch.Tensor:
    """Step 3's norm: each element of the whole gradient counted once."""
    total = None
    for k, g in grads.items():
        sq = torch.sum(torch.square(lay[k].own(g)))
        if not lay[k].d_owner:
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    if grid.model.d > 1:
        total = grid.model._sum(total)
    if grid.data.d > 1:
        total = grid.data._sum(total)
    return torch.sqrt(total)


def _all_gather(p: torch.Tensor, leaf: Leaf, grid) -> None:
    """Step 5 for one parameter: the other data ranks' updated ZeRO blocks
    written into ``p``."""
    data = grid.data
    if leaf.zdim is None or data.d == 1:
        return
    p.copy_(data._gather(leaf.zblock(p), leaf.zdim))


def _update(model, opt_state, grads, step, hyper: OptHyper,
            lay: Dict[str, Leaf]) -> torch.Tensor:
    """Steps 3-5 -> the global norm."""
    grid = model.grid
    norm = _global_norm(grads, lay, grid)
    clip_by_global_norm(grads, hyper.clip_norm, inplace=True, norm=norm)
    params = {k: p.detach() for k, p in model.named_parameters()}
    blocks = {k: lay[k].zblock(p) for k, p in params.items()}
    if model.cfg.optimizer == "adafactor":
        adafactor_update(blocks, grads, opt_state, step, hyper,
                         BlockMeans(lay, grid))
    else:
        adamw_update(blocks, grads, opt_state, step, hyper)
    for k, p in params.items():
        _all_gather(p, lay[k], grid)
    return norm


def _taken_grad(p: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """The gradient the backward left for ``p`` (zeros if none), taken
    off it: ``p.grad``, or for a ``ddim`` leaf the float32
    ``reduced_grad`` that the weight gather's backward summed over "data"
    (a ``p.grad`` there would be a use that bypassed the gather)."""
    if leaf.ddim is None:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
    else:
        if p.grad is not None:
            raise RuntimeError("a weight split over \"data\" got a gradient "
                               "that did not pass its gather")
        g = getattr(p, "reduced_grad", None)
        if g is None:
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    p.grad = None
    p.reduced_grad = None
    return g


def apply_gradients(model, opt_state, step, hyper: OptHyper
                    ) -> torch.Tensor:
    """Steps 1 (the model-axis sums) to 5 from the gradients the backward
    left in the parameters' ``grad`` (freed here) -> the global norm.
    Collective over the grid.  The groups count steps 1-2's collectives
    under the phase "gradients" and 3-5's under "optimizer"
    (``launch/mesh.collective_phase``)."""
    grid, lay = model.grid, layout(model)
    with torch.no_grad():
        grads = {}
        with collective_phase("gradients"):
            for k, p in model.named_parameters():
                g = _taken_grad(p, lay[k])
                grads[k] = _reduce(g, lay[k], grid)
        with collective_phase("optimizer"):
            return _update(model, opt_state, grads, step, hyper, lay)


def train_step(model, opt_state, batch, step: int, hyper: OptHyper, *,
               attn_chunk: int = 1024, skip_upper_triangle: bool = True):
    """One sharded step of ``model`` (over ``model.grid``) on this rank's
    rows ``batch`` -> (model, opt_state, metrics: ``loss``, ``ce`` and
    ``aux`` averaged over the data shards, ``grad_norm``).  Collective:
    every rank of the grid calls it in the same order."""
    grid = model.grid
    model.zero_grad(set_to_none=True)
    for p in model.parameters():
        p.reduced_grad = None
    loss, aux = model.loss_fn(batch, chunk=attn_chunk,
                              skip_upper_triangle=skip_upper_triangle)
    loss.backward()
    norm = apply_gradients(model, opt_state, step, hyper)
    with torch.no_grad(), collective_phase("optimizer"):
        scalars = torch.stack([loss.detach(), aux["ce"].detach(),
                               aux["aux"].detach().float()])
        if grid.data.d > 1:
            scalars = grid.data._sum(scalars) / grid.data.d
    return model, opt_state, {"loss": scalars[0], "ce": scalars[1],
                              "aux": scalars[2], "grad_norm": norm}


# ---------------------------------------------------------------------------
# checkpoints: the one-rank run's leaves
# ---------------------------------------------------------------------------


def _gather_full(x: torch.Tensor, leaf: Leaf, dims, grid,
                 zsplit: bool) -> torch.Tensor:
    """The whole leaf from the ranks' pieces ``x`` (kept parameter dims
    ``dims``, -1 a stack dim): the data ranks' ZeRO blocks, the weights'
    data ranks' blocks of a 2-D leaf, then each model rank's
    :meth:`Leaf.owned` part of its block (the blocks padded to the widest
    for the gather), concatenated in rank order."""
    x = x.detach()
    if zsplit and grid.data.d > 1 and leaf.zdim in dims:
        x = torch.cat(grid.data._parts(x.contiguous()),
                      dims.index(leaf.zdim))
    if leaf.ddim in dims:
        x = torch.cat(grid.weight_data._parts(x.contiguous()),
                      dims.index(leaf.ddim))
    if grid.model.d > 1 and leaf.mdim in dims:
        j = dims.index(leaf.mdim)
        width = max(n for _, n in leaf.mranges)
        parts = grid.model._parts(pad_to(x, j, width).contiguous())
        x = torch.cat([parts[q].narrow(j, lo - s, n) for q, ((s, _), (lo, n))
                       in enumerate(zip(leaf.mranges, map(
                           leaf.owned, range(grid.model.d))))], j)
    return x



def _cut(t: torch.Tensor, leaf: Leaf, dims, zsplit: bool) -> torch.Tensor:
    """:func:`_gather_full`'s inverse: this rank's piece of a whole leaf."""
    if leaf.mdim in dims:
        t = t.narrow(dims.index(leaf.mdim), *leaf.mrange)
    if leaf.ddim in dims:
        j = dims.index(leaf.ddim)
        n = t.shape[j] // leaf.wd
        t = t.narrow(j, leaf.w_rank * n, n)
    if zsplit and leaf.d > 1 and leaf.zdim in dims:
        j = dims.index(leaf.zdim)
        n = t.shape[j] // leaf.d
        t = t.narrow(j, leaf.d_rank * n, n)
    return t


def _state_leaves(opt_state):
    """(path, parameter name, state leaf name, tensor) of each state leaf:
    ``{"m"|"v": {name: t}}`` or ``{"f": {name: {"vr"|"vc"|"v": t}}}``."""
    for part, tree in opt_state.items():
        for name, v in tree.items():
            if isinstance(v, dict):
                for leaf_name, t in v.items():
                    yield (part, name, leaf_name), name, leaf_name, t
            else:
                yield (part, name), name, part, v


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _state_places(opt_state, lay: Dict[str, Leaf]):
    """(path, tensor, its parameter's :class:`Leaf`, the kept dims, the
    whole leaf's shape) of each state leaf; an Adafactor group's leaf has
    the layout of its layers' and their stack dims in front."""
    groups = stack_groups(lay)
    for path, name, sub, t in _state_leaves(opt_state):
        stack, members = groups[name] if path[0] == "f" else ((), [((),
                                                                    name)])
        leaf = lay[members[0][1]]
        dims = state_dims(sub, len(leaf.full), len(stack))
        whole = tuple(stack) + leaf.full
        yield path, t, leaf, dims, tuple(whole[len(stack) + i] if i >= 0
                                         else whole[j]
                                         for j, i in enumerate(dims))


def full_tree(model, opt_state) -> dict:
    """The checkpoint tree ``{"params", "opt"}`` of a one-rank run, each
    leaf a function that gathers it whole (collective: every rank calls
    them in ``checkpoint.store``'s order)."""
    lay, grid = layout(model), model.grid
    tree: dict = {"params": {}, "opt": {}}
    for k, p in model.named_parameters():
        dims = tuple(range(len(lay[k].full)))
        tree["params"][k] = lambda p=p, leaf=lay[k], dims=dims: \
            _gather_full(p, leaf, dims, grid, zsplit=False)
    for path, t, leaf, dims, _ in _state_places(opt_state, lay):
        _set(tree["opt"], path, lambda t=t, leaf=leaf, dims=dims:
             _gather_full(t, leaf, dims, grid, zsplit=True))
    return tree


class _Sink:
    """A checkpoint leaf loaded in place into a rank's piece: the whole
    leaf's ``shape``; ``copy_`` keeps the piece."""

    def __init__(self, target: torch.Tensor, leaf: Leaf, dims,
                 zsplit: bool, shape: Tuple[int, ...]):
        self.target, self.leaf, self.dims, self.zsplit = (target, leaf,
                                                          dims, zsplit)
        self.shape = shape

    def copy_(self, t: torch.Tensor) -> torch.Tensor:
        return self.target.copy_(_cut(t, self.leaf, self.dims, self.zsplit))


def block_sinks(model, opt_state) -> dict:
    """:func:`full_tree`'s shape, each leaf a sink that keeps this rank's
    piece (``checkpoint.store.load_checkpoint(..., inplace=True)``)."""
    lay = layout(model)
    tree: dict = {"params": {}, "opt": {}}
    for k, p in model.named_parameters():
        tree["params"][k] = _Sink(p.detach(), lay[k],
                                  tuple(range(len(lay[k].full))), False,
                                  lay[k].full)
    for path, t, leaf, dims, shape in _state_places(opt_state, lay):
        _set(tree["opt"], path, _Sink(t, leaf, dims, True, shape))
    return tree

