"""The port's mesh arithmetic (``flexflow_torch/parallel/mesh.py`` and
``distributed.py``) held against the JAX package's, with no process
spawned.

For 1, 2, 4 and 8 devices: the axes, each ``ParallelConfig``'s
assignment (or the ``InfeasibleStrategyError`` JAX raises), its local
degrees and its specs over several tag layouts and shapes (partial
sharding and ZeRO's extra leading axes included) are equal to JAX's;
``reshard_hops`` gives JAX's chain for the transitions of
``tests/test_reshard.py`` and for every pair of specs the tables below
make; and the block ``MeshPlan.local_slices`` cuts for rank ``r`` is the
block JAX's ``NamedSharding`` puts on device ``r`` of the same mesh, so
a rank's shards are JAX's device's.  ``build_hybrid_mesh_plan``'s axes
equal JAX's.
"""

import itertools

import jax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from flexflow_torch.parallel.distributed import build_hybrid_mesh_plan
from flexflow_torch.parallel.mesh import InfeasibleStrategyError
from flexflow_torch.parallel.mesh import build_mesh_plan as tbuild
from flexflow_torch.parallel.strategy import ParallelConfig as TPC
from flexflow_tpu.parallel.distributed import (
    build_hybrid_mesh_plan as jbuild_hybrid,
)
from flexflow_tpu.parallel.mesh import InfeasibleStrategyError as JInfeasible
from flexflow_tpu.parallel.mesh import build_mesh_plan as jbuild
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC

DEVICES = (1, 2, 4, 8)
DEGREES = (1, 2, 4, 8)
#: Tag layouts of the port's tensors: NHWC activations, a linear's
#: (n, s, c) output, its kernel, a projection, a vector, a token grid.
LAYOUTS = [("n", "h", "w", "c"), ("n", "s", "c"), ("c", None), (None, "c"),
           ("c",), ("n", "s"), ("n", None)]
SHAPES = {4: [(8, 8, 8, 4), (6, 9, 8, 3)], 3: [(8, 32, 64), (4, 6, 10)],
          2: [(64, 32), (6, 8)], 1: [(16,), (6,)]}


def _norm(spec, ndim):
    """A JAX PartitionSpec as the port's spec: a tuple of axis tuples."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(spec)):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def _pcs(n):
    """Every (n, c, h, w) of degrees in DEGREES with at most ``n`` parts,
    plus an s split and a degree no mesh realizes."""
    out = [dict(n=a, c=b, h=c, w=d)
           for a, b, c, d in itertools.product(DEGREES, repeat=4)
           if a * b * c * d <= n]
    out += [dict(n=1, s=2), dict(n=2, s=2), dict(n=3), dict(c=6)]
    return out


def _plans(n):
    return tbuild(n), jbuild(n)


@pytest.mark.parametrize("n", DEVICES)
def test_axes_match_jax(n):
    t, j = _plans(n)
    assert t.axis_names == j.axis_names and t.axis_sizes == j.axis_sizes
    assert t.num_devices == j.num_devices == n


@pytest.mark.parametrize("n", DEVICES)
def test_assign_and_specs_match_jax(n):
    t, j = _plans(n)
    checked = 0
    for kw in _pcs(n):
        try:
            want = j.assign(JPC(**kw))
        except JInfeasible:
            with pytest.raises(InfeasibleStrategyError):
                t.assign(TPC(**kw))
            continue
        tpc, jpc = TPC(**kw), JPC(**kw)
        assert t.assign(tpc) == want, kw
        axes = ("n", "c", "h", "w", "s")
        assert t.local_degrees(tpc, *axes) == j.local_degrees(jpc, *axes)
        for tags in LAYOUTS:
            assert t.spec(tpc, tags) == _norm(j.spec(jpc, tags), len(tags))
            for shape in SHAPES[len(tags)]:
                assert t.spec(tpc, tags, shape) == \
                    _norm(j.spec(jpc, tags, shape), len(tags)), (kw, shape)
                extra = want.get("n", ())
                assert t.spec(tpc, tags, shape, extra_leading_axes=extra) \
                    == _norm(j.spec(jpc, tags, shape,
                                    extra_leading_axes=extra), len(tags))
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("n", DEVICES)
def test_local_slices_are_jax_device_blocks(n):
    """Rank r's block of every spec is what JAX's NamedSharding places
    on device r of the same mesh."""
    t, j = _plans(n)
    devices = list(j.mesh.devices.flat)
    for kw in _pcs(n):
        try:
            j.assign(JPC(**kw))
        except JInfeasible:
            continue
        for tags in LAYOUTS:
            for shape in SHAPES[len(tags)]:
                jspec = j.spec(JPC(**kw), tags, shape)
                tspec = t.spec(TPC(**kw), tags, shape)
                idx = NamedSharding(j.mesh, jspec).devices_indices_map(shape)
                for r, dev in enumerate(devices):
                    got = t.local_slices(tspec, shape, r)
                    want = tuple(slice(*s.indices(d)[:2]) for s, d in
                                 zip(idx[dev], shape))
                    assert got == want, (kw, tags, shape, r)
                    assert t.local_shape(tspec, shape) == tuple(
                        s.stop - s.start for s in want)


# The transitions of tests/test_reshard.py, on the 8-device mesh.
RESHARD = [
    (P("x0", None), P("x0", None), 2),
    (P("x0", None), P(("x0", "x1", "x2"), None), 2),
    (P(("x0", "x1", "x2"), None), P("x0", None), 2),
    (P("x0", "x1", "x2", None), P(("x0", "x1", "x2"), None, None, None), 4),
    (P(None, ("x1", "x2"), None), P(("x0", "x1", "x2"), None, None), 3),
    (P(("x0", "x1", "x2"), None, None), P(None, ("x1", "x2"), None), 3),
    (P("x0", "x1", None), P(("x0", "x1"), None, None), 3),
    (P("x1", "x2", None), P(("x0", "x1"), None, "x2"), 3),
]


@pytest.mark.parametrize("frm,to,ndim", RESHARD)
def test_reshard_hops_match_jax(frm, to, ndim):
    t, j = _plans(8)
    got = t.reshard_hops(_norm(frm, ndim), _norm(to, ndim), ndim)
    want = [_norm(h, ndim) for h in j.reshard_hops(frm, to, ndim)]
    assert got == want


@pytest.mark.parametrize("n", (4, 8))
def test_reshard_hops_match_jax_between_table_specs(n):
    """Every ordered pair of the NHWC specs the tables of _pcs make."""
    t, j = _plans(n)
    tags = ("n", "h", "w", "c")
    specs = set()
    for kw in _pcs(n):
        try:
            specs.add(j.spec(JPC(**kw), tags))
        except JInfeasible:
            continue
    specs = sorted(specs, key=str)
    for frm, to in itertools.product(specs, repeat=2):
        got = t.reshard_hops(_norm(frm, 4), _norm(to, 4), 4)
        assert got == [_norm(h, 4) for h in j.reshard_hops(frm, to, 4)], \
            (frm, to)


@pytest.mark.parametrize("n,granules", [(1, 1), (2, 1), (2, 2), (4, 2),
                                        (8, 2), (8, 4), (8, 8)])
def test_hybrid_plan_axes_match_jax(n, granules):
    t = build_hybrid_mesh_plan(n, granules)
    j = jbuild_hybrid(granules, devices=jax.devices()[:n])
    assert (t.axis_names, t.axis_sizes) == (j.axis_names, j.axis_sizes)


def test_hybrid_plan_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="granules"):
        build_hybrid_mesh_plan(4, 3)
    with pytest.raises(ValueError, match="granules"):
        jbuild_hybrid(3, devices=jax.devices()[:4])


def test_group_ranks_and_block_index():
    """The members of a rank's group over some axes, in ascending rank
    order, are the mixed radix of those axes' coordinates in mesh order."""
    t = tbuild(8)
    for r in range(8):
        c = t.coords(r)
        assert r == c["x0"] * 4 + c["x1"] * 2 + c["x2"]
        for axes in (("x0",), ("x1", "x2"), ("x0", "x2"),
                     ("x0", "x1", "x2")):
            members = t.group_ranks(axes, r)
            assert r in members and len(members) == t.size(axes)
            assert [t.block_index(axes, m) for m in members] == \
                list(range(len(members)))
