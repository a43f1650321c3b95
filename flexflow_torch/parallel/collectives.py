"""The collectives of the port's mesh: what GSPMD inserts for the JAX
package, written out on each rank's local tensors.

One process runs per rank (``parallel/launch.py``).  Every tensor of the
op graph is held as the rank's block of it under a spec
(``parallel/mesh.py``), and the functions here move blocks between ranks
over ``torch.distributed`` groups.  A ``World`` binds a ``MeshPlan`` to
the process group: the rank, the backend, and one group per set of mesh
axes, all made once per plan in mesh-definition order (every rank makes
every group, in the same order, as ``new_group`` requires).

Gradients follow one rule.  The cotangent a rank holds for a tensor
replicated over some mesh axes is the whole cotangent, the same on each
rank, as long as the work that reads the tensor is itself replicated
over those axes; where split work reads a replicated tensor (a parameter
under data parallelism, ``Linear``'s input under a ``c`` split, a
BatchNorm statistic), each rank holds a partial sum and the reader
all-reduces it (``copy_to``, or the executor for parameters).  So:

- ``split`` (a local slice) all-gathers in the backward, and ``gather``
  (the all-gather that drops an axis) slices; they are each other's
  adjoints.
- ``all_gather`` is the gather for a reader whose backward leaves
  partial sums over the group (``Linear``'s contraction): its backward
  reduce-scatters.
- ``all_reduce`` sums partial results whose sum is read replicated (a
  row-parallel product, the loss): its backward is the identity.
  ``copy_to`` is its dual: the identity forward, an all-reduce backward.
- ``reduce_scatter`` sums partial results of which each rank reads its
  chunk (the MoE's expert slots filled from every ``n`` rank's tokens):
  its backward all-gathers; ``all_gather`` is its adjoint.
- ``move`` (an all-to-all that moves an axis between dims) runs the
  reverse all-to-all in its backward.
- ``shift`` sends each rank's block to its successor along the axes
  (JAX's ``lax.ppermute``): ``cyclic`` for the ring (``i -> (i + 1) mod
  S``), else the chain (``i -> i + 1``; the first rank receives zeros,
  the last sends nothing).  Its backward is the reverse shift.  Autograd
  runs no backward for an output nothing reads, and a shift's backward
  is a collective every rank of the group must enter: ``anchor(y, *xs)``
  is ``y`` with zero cotangents for ``xs``, so a rank whose work does not
  read a shifted block still runs the reverse shift, in the same order
  as its neighbours.
- ``halo_window`` sends each neighbour the boundary rows its window
  reads, and adds the halo rows' cotangents back into their owners.
- ``reshard(x, frm, to)`` walks ``MeshPlan.reshard_hops``'s chain with
  these.

**Gloo and CUDA tensors.**  NCCL takes every collective above on CUDA
tensors.  Gloo took every one of them on CUDA tensors too, in f32 and in
bf16, on the H100 machine (torch 2.11.0+cu128; ``python -m
flexflow_torch.tools.mesh_smoke --gloo-probe``: all_reduce, all_gather,
reduce_scatter, all_to_all_single, broadcast); it stages them through
the host itself.  So both backends run the same calls on the same
tensors, and no other form exists here: a backend that refuses one
raises.  The one exception is ``shift``'s point-to-point send and
receive, which gloo takes on CPU tensors only: over gloo a CUDA block is
copied to the host and back around them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from flexflow_torch.parallel.mesh import MeshPlan, Spec


class World:
    """A rank's binding of a ``MeshPlan`` to the initialised process
    group, over every rank of the world or over the subset ``ranks`` (a
    pipeline stage's): plan index ``i`` is global rank ``ranks[i]``.
    ``rank``, ``index``, ``group``'s members and ``shift`` speak in plan
    indices.  Every rank of the world builds every World, its own stages'
    and the others', in the same order: ``dist.new_group`` is collective
    over the default group.  ``rank`` is None on a rank outside
    ``ranks``, which then uses nothing of it.

    The host group of ``agree`` and ``broadcast_int`` is the world's,
    one a process (gloo: the default group; beside NCCL, one gloo group
    of every rank), so every rank of the world calls them."""

    def __init__(self, plan: MeshPlan, ranks: Optional[Sequence[int]] = None):
        if not dist.is_initialized():
            raise RuntimeError("a World needs an initialised process group "
                               "(flexflow_torch.parallel.launch)")
        size = dist.get_world_size()
        if ranks is None:
            if size != plan.num_devices:
                raise ValueError(f"the mesh has {plan.num_devices} devices "
                                 f"but the world has {size} ranks")
            ranks = range(size)
        ranks = tuple(int(r) for r in ranks)
        if len(ranks) != plan.num_devices or len(set(ranks)) != len(ranks) \
                or not all(0 <= r < size for r in ranks):
            raise ValueError(f"a mesh of {plan.num_devices} devices over "
                             f"ranks {list(ranks)} of a world of {size}")
        self.plan = plan
        #: The global rank of each plan index.
        self.ranks = ranks
        me = dist.get_rank()
        self.rank = ranks.index(me) if me in ranks else None
        self.backend = dist.get_backend()
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        #: Per group whose plan order is not its global order: the group
        #: rank of each member (in plan order).
        self._perm: Dict[Tuple[str, ...], List[int]] = {}
        names = plan.axis_names
        for mask in range(1, 1 << len(names)):
            axes = tuple(a for i, a in enumerate(names) if mask >> i & 1)
            if plan.size(axes) == 1:
                continue
            made = set()
            for r in range(plan.num_devices):
                members = tuple(plan.group_ranks(axes, r))
                if members in made:
                    continue
                made.add(members)
                glob = [ranks[i] for i in members]
                pg = dist.new_group(glob)
                if self.rank in members:
                    self._groups[axes] = (pg, list(members))
                    # A group numbers its members by ascending global
                    # rank; the collectives below order blocks by plan
                    # index, so a stage over reordered ranks ([0, 2, 1,
                    # 3]) permutes between the two.
                    order = sorted(glob)
                    pos = [order.index(r) for r in glob]
                    if pos != sorted(pos):
                        self._perm[axes] = pos
        self._host = _host_group(self.backend)
        #: Seconds spent in collectives while ``timed`` (each one then
        #: waits for the device before it starts and before it returns),
        #: and the same seconds by the collective's name.
        self.comm_s = 0.0
        self.comm_by: Dict[str, float] = {}
        self.timed = False

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(sorted(set(axes), key=self.plan.axis_names.index))

    def group(self, axes: Sequence[str]):
        """``(process group, member ranks)`` of this rank over ``axes``,
        or None when they make one block."""
        return self._groups.get(self._key(axes))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block index along a dim split by ``axes``."""
        return self.plan.block_index(axes, self.rank)

    # -- plain collectives (no autograd) ---------------------------------

    def _run(self, fn, x: torch.Tensor, kind: str):
        """``fn`` on ``x`` made contiguous; with ``timed`` the device is
        synchronised before and after ``fn`` and the host seconds between
        are added to ``comm_s`` and to ``comm_by[kind]`` (the work queued
        before the collective is not charged to it)."""
        import time

        x = x.contiguous()
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter() if self.timed else 0.0
        out = fn(x)
        if self.timed:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            dt = time.perf_counter() - t0
            self.comm_s += dt
            self.comm_by[kind] = self.comm_by.get(kind, 0.0) + dt
        return out

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``x`` over the group of ``axes`` (a new tensor)."""
        g = self.group(axes)
        if g is None:
            return x

        def fn(t):
            t = t.clone()
            dist.all_reduce(t, group=g[0])
            return t

        return self._run(fn, x, "all_reduce")

    def all_gather(self, x: torch.Tensor, dim: int,
                   axes: Sequence[str]) -> torch.Tensor:
        """The members' blocks of ``x`` concatenated along ``dim`` in
        member order (ascending rank: the mixed radix of ``axes`` in mesh
        order)."""
        g = self.group(axes)
        if g is None:
            return x

        pos = self._perm.get(self._key(axes))

        def fn(t):
            out = [torch.empty_like(t) for _ in g[1]]
            dist.all_gather(out, t, group=g[0])
            if pos is not None:
                out = [out[p] for p in pos]
            return torch.cat(out, dim)

        return self._run(fn, x, "all_gather")

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axes: Sequence[str]) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of ``x`` over the
        group."""
        g = self.group(axes)
        if g is None:
            return x

        pos = self._perm.get(self._key(axes))

        def fn(t):
            parts = [c.contiguous() for c in t.chunk(len(g[1]), dim)]
            if pos is not None:
                parts = [parts[pos.index(r)] for r in range(len(pos))]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=g[0])
            return out

        return self._run(fn, x, "reduce_scatter")

    def all_to_all(self, x: torch.Tensor, split_dim: int, cat_dim: int,
                   axes: Sequence[str]) -> torch.Tensor:
        """Chunk ``j`` of ``x`` along ``split_dim`` goes to member ``j``;
        the chunks received are concatenated along ``cat_dim`` in member
        order."""
        g = self.group(axes)
        if g is None:
            return x
        n = len(g[1])
        pos = self._perm.get(self._key(axes))

        def fn(t):
            chunks = t.chunk(n, split_dim)
            if pos is not None:  # chunk j to member j, in group order
                chunks = [chunks[pos.index(r)] for r in range(n)]
            inp = torch.stack(chunks).contiguous()
            out = torch.empty_like(inp)
            dist.all_to_all_single(out, inp, group=g[0])
            got = out.unbind(0)
            if pos is not None:
                got = [got[p] for p in pos]
            return torch.cat(got, cat_dim)

        return self._run(fn, x, "all_to_all")

    def shift(self, x: torch.Tensor, axes: Sequence[str], cyclic: bool,
              reverse: bool = False) -> torch.Tensor:
        """Each member's ``x`` from its predecessor along ``axes`` (member
        order, the block index along a dim they split): cyclic, ``i -> (i
        + 1) mod S``; else the chain ``i -> i + 1``, where the first member
        receives zeros and the last sends nothing.  ``reverse`` runs the
        same shift the other way (its adjoint).  One ``batch_isend_irecv``
        of at most one send and one receive a rank."""
        g = self.group(axes)
        if g is None:
            return x if cyclic else torch.zeros_like(x)
        pg, members = g
        size, i = len(members), members.index(self.rank)
        step = -1 if reverse else 1
        dst, src = i + step, i - step
        if cyclic:
            dst, src = dst % size, src % size
        stage = self.backend == "gloo" and x.is_cuda

        def fn(t):
            send = t.cpu() if stage else t
            recv = torch.zeros_like(send)
            ops = []
            if 0 <= dst < size:
                ops.append(dist.P2POp(dist.isend, send,
                                      self.ranks[members[dst]], pg))
            if 0 <= src < size:
                ops.append(dist.P2POp(dist.irecv, recv,
                                      self.ranks[members[src]], pg))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return recv.to(t.device) if stage else recv

        return self._run(fn, x, "shift")

    # -- the host's agreements -----------------------------------------

    def agree(self, *flags: bool) -> Tuple[bool, ...]:
        """Each flag OR-ed over every rank: one all-reduce (max) of a small
        CPU tensor over the host group, so every rank takes the same
        branch after it."""
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host)
        return tuple(bool(v) for v in t.tolist())

    def broadcast_int(self, value: int) -> int:
        """Plan index 0's ``value`` on every rank (over the host group)."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, src=self.ranks[0], group=self._host)
        return int(t.item())

    def block(self, x: torch.Tensor, dim: int,
              axes: Sequence[str]) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim`` when ``axes`` split it
        further (no communication)."""
        n = self.plan.size(axes)
        if n == 1:
            return x
        return x.chunk(n, dim)[self.index(axes)]


_HOST: Dict[str, object] = {}


def _host_group(backend: str):
    """The world's host group: None (the default group) under gloo, else
    one gloo group of every rank, made by the first World of the process
    (every rank makes its first World at the same point), so an
    agreement never touches the device nor waits for its queue."""
    if backend == "gloo":
        return None
    if "host" not in _HOST:
        _HOST["host"] = dist.new_group(backend="gloo")
    return _HOST["host"]


# -- autograd functions ------------------------------------------------------


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, world, axes):
        ctx.args = (dim, world, axes)
        return world.block(x, dim, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, world, axes = ctx.args
        return world.all_gather(g, dim, axes), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, world, axes):
        ctx.args = (dim, world, axes)
        return world.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        dim, world, axes = ctx.args
        return world.block(g, dim, axes).contiguous(), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, world, axes):
        ctx.args = (dim, world, axes)
        return world.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        dim, world, axes = ctx.args
        return world.reduce_scatter(g, dim, axes), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, world, axes):
        ctx.args = (dim, world, axes)
        return world.reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        dim, world, axes = ctx.args
        return world.all_gather(g, dim, axes), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axes):
        return world.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axes):
        ctx.args = (world, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        world, axes = ctx.args
        return world.all_reduce(g, axes), None, None


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, world, axes):
        ctx.args = (src, dst, world, axes)
        return world.all_to_all(x, dst, src, axes)

    @staticmethod
    def backward(ctx, g):
        src, dst, world, axes = ctx.args
        return world.all_to_all(g, src, dst, axes), None, None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, axes, cyclic, reverse):
        ctx.args = (world, axes, cyclic, reverse)
        return world.shift(x, axes, cyclic, reverse)

    @staticmethod
    def backward(ctx, g):
        world, axes, cyclic, reverse = ctx.args
        return world.shift(g, axes, cyclic, not reverse), None, None, None, \
            None


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, *xs):
        ctx.metas = [(x.shape, x.dtype, x.device) for x in xs]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros(shape, dtype=dtype, device=device)
                 if need else None for need, (shape, dtype, device)
                 in zip(ctx.needs_input_grad[1:], ctx.metas)]
        return (g if ctx.needs_input_grad[0] else None, *zeros)


def _live(world: Optional[World], axes: Sequence[str]) -> bool:
    return world is not None and world.plan.size(axes) > 1


def split(x, dim: int, world: Optional[World], axes: Sequence[str]):
    """This rank's block along ``dim`` of a tensor replicated over
    ``axes``; the backward all-gathers."""
    return _Split.apply(x, dim, world, tuple(axes)) if _live(world, axes) \
        else x


def gather(x, dim: int, world: Optional[World], axes: Sequence[str]):
    """The whole of a dim split by ``axes`` (minor-most on the dim), read
    by work replicated over them; the backward keeps the rank's block."""
    return _Gather.apply(x, dim, world, tuple(axes)) if _live(world, axes) \
        else x


def all_gather(x, dim: int, world: Optional[World], axes: Sequence[str]):
    """The whole of a dim split by ``axes``, read by work whose backward
    leaves partial sums over them; the backward reduce-scatters."""
    return _AllGather.apply(x, dim, world, tuple(axes)) \
        if _live(world, axes) else x


def reduce_scatter(x, dim: int, world: Optional[World],
                   axes: Sequence[str]):
    """This rank's chunk along ``dim`` of the sum over ``axes`` of partial
    results; the backward all-gathers the chunks' cotangents."""
    return _ReduceScatter.apply(x, dim, world, tuple(axes)) \
        if _live(world, axes) else x


def all_reduce(x, world: Optional[World], axes: Sequence[str]):
    """The sum over ``axes`` of partial results read replicated; the
    backward is the identity."""
    return _AllReduce.apply(x, world, tuple(axes)) if _live(world, axes) \
        else x


def copy_to(x, world: Optional[World], axes: Sequence[str]):
    """The identity, at the point where a tensor replicated over ``axes``
    enters work split over them; the backward all-reduces the partial
    cotangents."""
    return _CopyTo.apply(x, world, tuple(axes)) if _live(world, axes) else x


def move(x, src: int, dst: int, world: Optional[World],
         axes: Sequence[str]):
    """Move ``axes`` from the minor-most end of dim ``src``'s split to the
    minor-most end of dim ``dst``'s (one all-to-all)."""
    return _Move.apply(x, src, dst, world, tuple(axes)) \
        if _live(world, axes) else x


def shift(x, world: Optional[World], axes: Sequence[str], cyclic: bool = True,
          reverse: bool = False):
    """The predecessor's block along ``axes`` (``World.shift``); the
    backward sends each cotangent back the other way.  Every rank of the
    group must call it in the same order, forward and backward: anchor an
    output this rank's work does not read (:func:`anchor`)."""
    if not _live(world, axes):
        return x if cyclic else torch.zeros_like(x)
    return _Shift.apply(x, world, tuple(axes), bool(cyclic), bool(reverse))


def anchor(y, *xs):
    """``y``, with each of ``xs`` given a zero cotangent: the backward of
    whatever made ``xs`` (a shift) then runs on this rank although its
    work does not read them."""
    xs = [x for x in xs if x is not None and x.requires_grad]
    return _Anchor.apply(y, *xs) if xs else y


# -- halo exchange -----------------------------------------------------------


def _window_rows(extent: int, out_extent: int, parts: int, k: int, s: int,
                 p: int):
    """Per output block ``r`` of ``parts``: the input rows ``[lo, hi)``
    its window reads (in the unpadded input's coordinates; rows outside
    ``[0, extent)`` are padding)."""
    m = out_extent // parts
    return [(r * m * s - p, ((r + 1) * m - 1) * s - p + k)
            for r in range(parts)]


class _Halo(torch.autograd.Function):
    """The rows ``[lo, hi)`` of rank ``r``'s window along ``dim`` from its
    own block and its neighbours' boundary rows (padding rows at the
    mesh's edges filled with ``fill``)."""

    @staticmethod
    def forward(ctx, x, dim, world, axes, rows, fill):
        parts = len(rows)
        r = world.index(axes)
        L = x.shape[dim]
        need_l = [r_ * L - lo for r_, (lo, _) in enumerate(rows)]
        need_r = [hi - (r_ + 1) * L for r_, (_, hi) in enumerate(rows)]
        bot = max([0] + need_l[1:])    # rows a rank sends to its right
        top = max([0] + need_r[:-1])   # rows a rank sends to its left
        if bot > L or top > L:
            raise ValueError(
                f"halo of {max(bot, top)} rows is wider than a rank's block "
                f"of {L} rows along dim {dim}; use fewer parts on this dim")
        slab = torch.cat([x.narrow(dim, 0, top), x.narrow(dim, L - bot, bot)],
                         dim)
        every = (world.all_gather(slab, dim, axes).chunk(parts, dim)
                 if top + bot else None)
        pieces = []
        nl, nr = need_l[r], need_r[r]
        if nl > 0:
            if r == 0:
                shape = list(x.shape)
                shape[dim] = nl
                pieces.append(x.new_full(shape, fill))
            else:
                pieces.append(every[r - 1].narrow(dim, top + bot - nl, nl))
        pieces.append(x.narrow(dim, max(0, -nl), L - max(0, -nl)
                               - max(0, -nr)))
        if nr > 0:
            if r == parts - 1:
                shape = list(x.shape)
                shape[dim] = nr
                pieces.append(x.new_full(shape, fill))
            else:
                pieces.append(every[r + 1].narrow(dim, 0, nr))
        ctx.args = (dim, world, axes, L, need_l, need_r, top, bot, r, parts)
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, g):
        dim, world, axes, L, need_l, need_r, top, bot, r, parts = ctx.args
        nl, nr = need_l[r], need_r[r]
        off = max(0, nl)
        core = L - max(0, -nl) - max(0, -nr)
        gx = torch.zeros(g.shape[:dim] + (L,) + g.shape[dim + 1:],
                         dtype=g.dtype, device=g.device)
        gx.narrow(dim, max(0, -nl), core).copy_(g.narrow(dim, off, core))
        # Each rank's halo cotangents, padded to the slab widths: the left
        # halo (its left neighbour's bottom rows) then the right halo (its
        # right neighbour's top rows).
        shape = list(g.shape)
        shape[dim] = bot
        left = g.new_zeros(shape)
        if nl > 0 and r > 0:
            left.narrow(dim, bot - nl, nl).copy_(g.narrow(dim, 0, nl))
        shape[dim] = top
        right = g.new_zeros(shape)
        if nr > 0 and r < parts - 1:
            right.narrow(dim, 0, nr).copy_(g.narrow(dim, off + core, nr))
        if not top + bot:
            return gx, None, None, None, None, None
        every = world.all_gather(torch.cat([left, right], dim), dim,
                                 axes).chunk(parts, dim)
        if r + 1 < parts and bot:
            gx.narrow(dim, L - bot, bot).add_(every[r + 1].narrow(dim, 0, bot))
        if r > 0 and top:
            gx.narrow(dim, 0, top).add_(every[r - 1].narrow(dim, bot, top))
        return gx, None, None, None, None, None


def halo_window(x, dim: int, world: Optional[World], in_axes: Sequence[str],
                out_axes: Sequence[str], extent: int, out_extent: int,
                k: int, s: int, p: int, fill: float):
    """The input rows a windowed op (a convolution or a pool of kernel
    ``k``, stride ``s``, padding ``p`` along ``dim``) reads for this
    rank's block of output rows, padding included, so the op then runs
    unpadded along ``dim``.  ``out_axes`` split the output dim (``()``:
    nothing to do, the op pads as usual); ``in_axes`` split the input dim
    the same way (a halo exchange with the neighbours) or are ``()`` (the
    input is whole here: a local slice)."""
    if not _live(world, out_axes):
        return x
    parts = world.plan.size(out_axes)
    rows = _window_rows(extent, out_extent, parts, k, s, p)
    if _live(world, in_axes):
        return _Halo.apply(x, dim, world, tuple(in_axes), rows, fill)
    lo, hi = rows[world.index(out_axes)]
    y = x.narrow(dim, max(0, lo), min(extent, hi) - max(0, lo))
    pads = []
    for n in (max(0, -lo), max(0, hi - extent)):
        if n:
            shape = list(x.shape)
            shape[dim] = n
            pads.append(x.new_full(shape, fill))
    if not pads:
        return y
    head = [pads.pop(0)] if lo < 0 else []
    return torch.cat(head + [y] + pads, dim)


# -- resharding --------------------------------------------------------------


def _in_mesh_order(world: World, axes: Sequence[str]) -> bool:
    order = world.plan.axis_names.index
    return list(axes) == sorted(axes, key=order)


def _drop(x, d: int, world: World, suffix: Sequence[str]):
    """Gather the ``suffix`` axes off the minor end of dim ``d``'s split:
    one collective when they are in mesh order, else one axis at a time
    from the minor end."""
    if _in_mesh_order(world, suffix):
        return gather(x, d, world, suffix)
    for a in reversed(suffix):
        x = gather(x, d, world, (a,))
    return x


def _add(x, d: int, world: World, suffix: Sequence[str]):
    if _in_mesh_order(world, suffix):
        return split(x, d, world, suffix)
    for a in suffix:
        x = split(x, d, world, (a,))
    return x


def _step(x, cur: Spec, nxt: Spec, world: World):
    """One hop ``cur -> nxt``: a single chunk moved between dims is one
    all-to-all; anything else drops what ``nxt`` does not keep (gathers)
    and then adds what it adds (slices), dim by dim."""
    ndim = x.dim()
    cur = tuple(cur) + ((),) * (ndim - len(cur))
    nxt = tuple(nxt) + ((),) * (ndim - len(nxt))
    changed = [d for d in range(ndim) if cur[d] != nxt[d]]
    if len(changed) == 2:
        a, b = changed
        for s, d in ((a, b), (b, a)):
            k = len(cur[s]) - len(nxt[s])
            if k > 0 and cur[s][:len(nxt[s])] == nxt[s] and \
                    nxt[d][:len(cur[d])] == cur[d] and \
                    nxt[d][len(cur[d]):] == cur[s][len(nxt[s]):] and \
                    _in_mesh_order(world, cur[s][len(nxt[s]):]):
                return move(x, s, d, world, cur[s][len(nxt[s]):])
    for d in changed:
        keep = 0
        while keep < min(len(cur[d]), len(nxt[d])) and \
                cur[d][keep] == nxt[d][keep]:
            keep += 1
        if len(cur[d]) > keep:
            x = _drop(x, d, world, cur[d][keep:])
    for d in changed:
        keep = 0
        while keep < min(len(cur[d]), len(nxt[d])) and \
                cur[d][keep] == nxt[d][keep]:
            keep += 1
        if len(nxt[d]) > keep:
            x = _add(x, d, world, nxt[d][keep:])
    return x


def reshard(x, frm: Spec, to: Spec, world: Optional[World]):
    """``x``, this rank's block under ``frm``, as its block under ``to``:
    ``MeshPlan.reshard_hops``'s chain when an axis moves between dims,
    else one step (module docstring)."""
    if world is None:
        return x
    frm, to = tuple(frm), tuple(to)
    pad = (lambda s: s + ((),) * (x.dim() - len(s)))
    frm, to = pad(frm), pad(to)
    if frm == to:
        return x
    cur = frm
    for nxt in world.plan.reshard_hops(frm, to, x.dim()) or [to]:
        x = _step(x, cur, nxt, world)
        cur = nxt
    return x


def axes_of(*specs: Spec) -> Tuple[str, ...]:
    """Every mesh axis that splits some dim of ``specs``."""
    out: List[str] = []
    for spec in specs:
        for entry in spec:
            out.extend(a for a in entry if a not in out)
    return tuple(out)

