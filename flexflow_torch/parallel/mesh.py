"""Mesh planning: the port of ``flexflow_tpu/parallel/mesh.py``'s
arithmetic.

One canonical mesh whose axes are the prime factors of the device count
(``x0..xk``, ranks laid out row-major over them, as JAX reshapes its
device list).  A per-op ``(n, c, h, w, s)`` degree vector is realized by
giving each semantic axis a tuple of mesh axes whose sizes multiply to
the degree.  The assignment order is JAX's and must stay so: ``n`` takes
mesh axes from the left, ``c`` and ``s`` from the right, then ``h`` and
``w`` from the left of what remains, and each tuple is put in
mesh-definition order.  That order is what makes a rank's shard of every
tensor the shard JAX's device of the same index holds.

A spec is a plain tuple with one entry per tensor dim, each entry the
tuple of mesh axes that split the dim (major first; ``()`` for a whole
dim): JAX's ``PartitionSpec`` without its ``None``/str shorthands.  A
rank holds, along each dim, the block whose index is the mixed radix of
its coordinates on that dim's axes, in the order the entry lists them.
``local_slices`` cuts that block from a full array; the collectives of
``parallel/collectives.py`` move blocks between specs.

``check_stage_mesh_feasible`` and ``build_stage_mesh_plan`` are the
shared stage mesh of the compiled pipeline step (JAX's ``mesh.py:362``,
``:385``): arithmetic only here.  The host-driven pipeline
(``runtime/pipeline.py``) gives each stage a plan of its own over its
ranks, as JAX's host mode does.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_torch.parallel.strategy import ParallelConfig

_log = logging.getLogger("ff.mesh")

Spec = Tuple[Tuple[str, ...], ...]


class InfeasibleStrategyError(ValueError):
    pass


def _prime_factors(x: int) -> List[int]:
    out: List[int] = []
    d = 2
    while d * d <= x:
        while x % d == 0:
            out.append(d)
            x //= d
        d += 1
    if x > 1:
        out.append(x)
    return out


def replicated(ndim: int) -> Spec:
    """The spec of a tensor every rank holds whole."""
    return ((),) * ndim


@dataclasses.dataclass
class MeshPlan:
    """The canonical mesh's axes plus the per-strategy assignment."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        self._assign_cache: Dict[ParallelConfig, Dict[str, Tuple[str, ...]]] = {}
        self._warned_drops: set = set()
        self._size = dict(zip(self.axis_names, self.axis_sizes))

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes)

    def size(self, axes: Sequence[str]) -> int:
        """The number of blocks a tuple of mesh axes makes."""
        return math.prod(self._size[a] for a in axes)

    def assign(self, pc: ParallelConfig) -> Dict[str, Tuple[str, ...]]:
        """Map each semantic axis of ``pc`` to a tuple of mesh axes."""
        cached = self._assign_cache.get(pc)
        if cached is not None:
            return cached
        avail: List[Tuple[str, int]] = list(zip(self.axis_names,
                                               self.axis_sizes))
        result: Dict[str, Tuple[str, ...]] = {}
        for sem, from_left in (("n", True), ("c", False), ("s", False),
                               ("h", True), ("w", True)):
            deg = pc.degree(sem)
            picked: List[str] = []
            for p in _prime_factors(deg):
                idxs = (range(len(avail)) if from_left
                        else range(len(avail) - 1, -1, -1))
                hit = next((i for i in idxs if avail[i][1] == p), None)
                if hit is None:
                    raise InfeasibleStrategyError(
                        f"cannot realize degree {deg} on axis {sem!r}: prime "
                        f"{p} unavailable in mesh "
                        f"{dict(zip(self.axis_names, self.axis_sizes))} "
                        f"after assigning {result}")
                picked.append(avail.pop(hit)[0])
            result[sem] = tuple(sorted(picked, key=self.axis_names.index))
        self._assign_cache[pc] = result
        return result

    def local_degrees(self, pc: ParallelConfig, *axes: str):
        """Per requested semantic axis, the (mesh-axis tuple or None,
        total degree) this plan realizes."""
        asg = self.assign(pc)
        out = []
        for sem in axes:
            names = asg.get(sem, ())
            out.append((tuple(names) if names else None, self.size(names)))
        return out

    def spec(self, pc: ParallelConfig, dim_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None,
             extra_leading_axes: Sequence[str] = ()) -> Spec:
        """The spec of a tensor whose dims carry the semantic tags
        ``dim_axes`` ('n'/'c'/'h'/'w'/'s' or None).  With ``shape``,
        mesh axes that do not divide a dim's extent are dropped (that
        factor runs replicated), as JAX drops them.  ``extra_leading_axes``
        folds more mesh axes into the leading dim where divisibility
        allows (ZeRO-1's moment split over the op's data-parallel
        axes), the combined tuple in mesh order."""
        asg = self.assign(pc)
        entries: List[Tuple[str, ...]] = []
        for i, sem in enumerate(dim_axes):
            if sem is None:
                entries.append(())
                continue
            axes = asg.get(sem, ())
            if shape is not None:
                dim = shape[i]
                kept, prod = [], 1
                for ax in axes:
                    if dim % (prod * self._size[ax]) == 0:
                        kept.append(ax)
                        prod *= self._size[ax]
                if len(kept) != len(axes):
                    dropped = tuple(ax for ax in axes if ax not in kept)
                    key = (sem, dropped, i, dim)
                    if key not in self._warned_drops:
                        self._warned_drops.add(key)
                        _log.warning(
                            "partial sharding: axis %r (%s) does not divide "
                            "dim %d (extent %d); dropping %s — that factor "
                            "runs replicated", sem, "x".join(dropped), i, dim,
                            list(dropped))
                axes = tuple(kept)
            entries.append(tuple(axes))
        if extra_leading_axes and shape is not None and entries:
            picked = list(entries[0])
            prod = self.size(picked)
            for ax in extra_leading_axes:
                if ax not in picked and shape[0] % (prod * self._size[ax]) == 0:
                    picked.append(ax)
                    prod *= self._size[ax]
            entries[0] = tuple(sorted(picked, key=self.axis_names.index))
        return tuple(entries)

    def reshard_hops(self, frm: Spec, to: Spec, ndim: int) -> List[Spec]:
        """Decompose ``frm -> to`` into hops that are each one kind of
        collective: axes only in ``to`` are first added minor-most at
        their target dim (a local slice), axes moving between dims go one
        (src, dst) chunk per hop (an all-to-all), and axes only in
        ``frm`` are dropped by the final ``to`` (an all-gather).  Returns
        the chain ending with ``to`` when an axis moves between dims;
        empty when none moves (one add/drop step does it) or when a hop
        would break the mesh-order invariant (logged once per
        transition; the caller then reshards ``frm -> to`` directly)."""
        order = self.axis_names.index

        def chains(spec) -> List[List[str]]:
            entries = list(spec) + [()] * (ndim - len(spec))
            return [list(e) for e in entries[:ndim]]

        f, t = chains(frm), chains(to)
        if f == t:
            return []
        pos_f = {a: d for d, ch in enumerate(f) for a in ch}
        pos_t = {a: d for d, ch in enumerate(t) for a in ch}
        movers = sorted((a for a in pos_f if a in pos_t
                         and pos_f[a] != pos_t[a]), key=order)
        if not movers:
            return []

        def as_spec(cur: List[List[str]]) -> Spec:
            return tuple(tuple(ch) for ch in cur)

        def decline(why: str) -> List[Spec]:
            seen = self.__dict__.setdefault("_undecomposable_seen", set())
            key = (frm, to, ndim)
            if key not in seen:
                seen.add(key)
                _log.warning("reshard_hops: cannot decompose %s -> %s "
                             "(ndim=%d): %s; resharding in one step", frm,
                             to, ndim, why)
            return []

        hops: List[Spec] = []
        cur = [list(ch) for ch in f]
        adds = sorted((a for a in pos_t if a not in pos_f), key=order)
        for a in adds:
            ch = cur[pos_t[a]]
            if ch and order(ch[-1]) > order(a):
                return decline(f"non-minor-most insert of {a}")
            ch.append(a)
        if adds:
            hops.append(as_spec(cur))
        chunks: Dict[Tuple[int, int], List[str]] = {}
        for a in movers:
            chunks.setdefault((pos_f[a], pos_t[a]), []).append(a)
        for (s, d), axes in sorted(
                chunks.items(), key=lambda kv: min(order(a) for a in kv[1])):
            dst = cur[d]
            for a in sorted(axes, key=order):
                if dst and order(dst[-1]) > order(a):
                    return decline(f"non-minor-most move of {a}")
                cur[s].remove(a)
                dst.append(a)
            hops.append(as_spec(cur))
        for d in range(ndim):
            if cur[d][: len(t[d])] != t[d]:
                return decline(f"non-suffix drop on dim {d}")
        if [list(e) for e in hops[-1]] != t:
            hops.append(as_spec(t))
        return hops

    # -- a rank's place on the mesh (no JAX counterpart: JAX's devices
    # -- know their own coordinates) --------------------------------------

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on each mesh axis (row-major)."""
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.axis_sizes)):
            out[name] = rank % size
            rank //= size
        return out

    def block_index(self, axes: Sequence[str], rank: int) -> int:
        """The mixed radix of ``rank``'s coordinates on ``axes``, in the
        order given: its block along a dim those axes split."""
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self._size[a] + c[a]
        return idx

    def group_ranks(self, axes: Sequence[str], rank: int) -> List[int]:
        """The ranks that differ from ``rank`` only on ``axes``, in
        ascending order (the mixed radix of their coordinates on
        ``axes`` in mesh order)."""
        c = self.coords(rank)
        return [r for r in range(self.num_devices)
                if all(self.coords(r)[a] == c[a]
                       for a in self.axis_names if a not in axes)]

    def local_slices(self, spec: Spec, shape: Sequence[int],
                     rank: int) -> Tuple[slice, ...]:
        """The slices that cut ``rank``'s block of a full array."""
        out = []
        for dim, axes in zip(shape, tuple(spec) + ((),) * (len(shape)
                                                            - len(spec))):
            parts = self.size(axes)
            step = dim // parts
            i = self.block_index(axes, rank)
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)

    def local_shape(self, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(dim // self.size(axes) for dim, axes in
                     zip(shape, tuple(spec) + ((),) * (len(shape) - len(spec))))


def factor_axes(n: int, prefix: str = "x"
                ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Prime-factor ``n`` into named mesh axes ``<prefix>0..k``."""
    sizes = tuple(_prime_factors(n)) or (1,)
    return tuple(f"{prefix}{i}" for i in range(len(sizes))), sizes


def make_plan(names: Tuple[str, ...], sizes: Tuple[int, ...]) -> MeshPlan:
    return MeshPlan(axis_names=tuple(names), axis_sizes=tuple(sizes))


def build_mesh_plan(num_devices: int) -> MeshPlan:
    """Factor the device count into prime-sized mesh axes ``x0..xk``."""
    if num_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got "
                         f"{num_devices}")
    return make_plan(*factor_axes(num_devices))


def check_stage_mesh_feasible(stage_device_ids: Sequence[Sequence[int]]
                              ) -> None:
    """Raise ``InfeasibleStrategyError`` unless the stages can share one
    stage-shaped mesh: equal sizes and disjoint device sets (JAX's
    predicate, shared by ``build_stage_mesh_plan`` and the compiled
    pipeline's eligibility check)."""
    sizes = {len(ids) for ids in stage_device_ids}
    if len(sizes) != 1:
        raise InfeasibleStrategyError(
            f"shared stage mesh needs equal-size stages, got sizes "
            f"{sorted(len(ids) for ids in stage_device_ids)}")
    flat = [d for ids in stage_device_ids for d in ids]
    if len(set(flat)) != len(flat):
        raise InfeasibleStrategyError(
            "shared stage mesh needs disjoint stage device sets "
            "(overlapping stages serialize and have no mesh row)")


def build_stage_mesh_plan(stage_device_ids: Sequence[Sequence[int]]
                          ) -> MeshPlan:
    """The one compact plan every stage of a compiled pipeline step
    shares: one stage's device count prime-factored into ``s0..sk``, the
    factorization a stand-alone stage plan of that size has, so each
    stage's intra-stage assignment (and its reduction orders) is the
    same on both.  Feasibility first (:func:`check_stage_mesh_feasible`).
    """
    check_stage_mesh_feasible(stage_device_ids)
    return make_plan(*factor_axes(len(stage_device_ids[0]), prefix="s"))
