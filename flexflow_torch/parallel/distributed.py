"""``build_hybrid_mesh_plan`` of ``flexflow_tpu/parallel/distributed.py``:
the mesh with the slow interconnect's axes outermost (``--granules``).

On one host it only orders the axes granule-major: the granule count is
factored into leading ``d*`` axes and the devices of a granule into
trailing ``x*`` axes, so the assignment order of ``parallel/mesh.py``
(``n`` from the left, ``c``/``s`` from the right) puts data parallelism
on the granule axes and keeps tensor collectives inside a granule.  The
rest of that file (the multi-host bootstrap) is ROADMAP.md item 13.
"""

from __future__ import annotations

from flexflow_torch.parallel.mesh import MeshPlan, factor_axes, make_plan


def build_hybrid_mesh_plan(num_devices: int, num_granules: int = 1
                           ) -> MeshPlan:
    """MeshPlan over ``num_devices`` ranks with the ``num_granules``
    islands' axes outermost."""
    n = num_devices
    if num_granules < 1 or n % num_granules != 0:
        raise ValueError(
            f"{n} devices do not divide into {num_granules} granules "
            f"(num_granules must be a positive divisor of the device "
            f"count)")
    if num_granules == 1:
        return make_plan(*factor_axes(n))
    d_names, d_sizes = factor_axes(num_granules, prefix="d")
    i_names, i_sizes = factor_axes(n // num_granules)
    if n // num_granules == 1:
        i_names, i_sizes = (), ()
    return make_plan(d_names + i_names, d_sizes + i_sizes)
