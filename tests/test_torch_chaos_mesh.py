"""JAX's chaos matrix on a world of eight ranks: the training scenarios
of ``flexflow_torch/runtime/chaos.py`` under JAX's own table (``fc1``
hybrid-parallel ``n2c4``, ``chaos.chaos_table(8)``) at k = 8.

One world of eight gloo ranks (``parallel/launch.py``: CPU ranks of one
thread) runs ``flexflow_torch.tools.mesh_train:chaos_world`` once for the
module under ``WORLD_S``, every rank in every scenario together (each
with its own injector on the same schedule, the checkpoint directory
shared, ``force_save_kill`` on rank 0, which alone writes), from JAX's
initial weights (numpy).

- Each of the six training scenarios (``raised_fault``, ``nan_batch``,
  ``nan_loss``, ``sigterm``, ``corrupt_checkpoint``, ``force_save_kill``)
  recovers on every rank with a trajectory bit for bit the unfaulted
  one's, and so does ``pipeline_superstep_nan`` under JAX's own table
  (two stages of four ranks on the compiled pipeline).
- The unfaulted trajectory equals JAX's ``tiny_factory`` on 8 virtual
  devices (``flexflow_tpu/runtime/chaos.py``, the same table) within
  1e-5, the bar of ``tests/test_torch_resilience.py`` on one device.
- On one device, the superstep loop that prepares the next superstep's
  host side while one runs still gives each of three faults in two
  neighbouring supersteps its own rollback (a NaN loss at step 6, a
  raise before step 9, NaN inputs at step 10; k = 4, a save every 4:
  ``chip_smoke.py``'s phase 24 schedule), bit for bit.
"""

import jax
import numpy as np
import pytest

from flexflow_torch.parallel import launch
from flexflow_torch.runtime import chaos
from flexflow_tpu.runtime import chaos as jchaos

RUN = "flexflow_torch.tools.mesh_train:chaos_world"
WORLD_S = 240
RANKS = 8
SCENARIOS = ("raised_fault", "nan_batch", "nan_loss", "sigterm",
             "corrupt_checkpoint", "force_save_kill",
             "pipeline_superstep_nan")


@pytest.fixture(scope="module")
def jax_run():
    """JAX's n2c4 executor on the 8 devices: its initial weights and the
    unfaulted trajectory (one train step a ``chaos_batch_fn`` batch)."""
    jex = jchaos.tiny_factory()()
    assert jex.plan.num_devices == RANKS
    params, opt, state = jex.init(seed=0)
    start = jax.device_get(params)
    step = jax.jit(jex.train_step)
    losses = []
    for s in range(chaos.ITERS):
        params, opt, state, m = step(params, opt, state,
                                     jex.shard_batch(chaos.chaos_batch_fn(s)))
        losses.append(float(m["train_loss"]))
    return start, losses


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chaos8"))
    start = {op: {k: np.asarray(v) for k, v in g.items()}
             for op, g in jax_run[0].items()}
    return launch.run(RUN, (root, list(SCENARIOS), chaos.K, "cpu", start),
                      nprocs=RANKS, device="cpu", timeout_s=WORLD_S)


def test_the_table_is_jaxs():
    table = chaos.chaos_table(RANKS)
    assert {k: (v.n, v.c) for k, v in table.items()} == {"fc1": (2, 4)}
    assert chaos.chaos_table(1) == {}


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_recovers_bit_for_bit_on_eight_ranks(world, name):
    ranks = world[:1] if name == "force_save_kill" else world
    for r, rank in enumerate(ranks):
        ok, detail = rank[name]
        assert ok, f"rank {r}: {detail}"


def test_unfaulted_trajectory_matches_jax_on_eight_devices(world, jax_run):
    base = world[0]["baseline"]
    for rank in world:
        assert rank["baseline"] == base
    np.testing.assert_allclose(base, jax_run[1], atol=1e-5, rtol=0)


def test_faults_in_neighbouring_supersteps_each_roll_back(tmp_path):
    from flexflow_torch.runtime.resilience import FaultInjector

    inj = FaultInjector(nan_loss_at=(6,), raise_at=(9,),
                        nan_batch_at=(10,))
    out = chaos.fit_once(str(tmp_path / "faulted"), inj, k=4, iters=12,
                         save_every=4, device="cpu")
    base = chaos.fit_once(str(tmp_path / "clean"), k=4, iters=12,
                          save_every=4, device="cpu")
    assert out["restarts"] == 3, inj.fired
    assert sorted(m for m, _ in inj.fired) == ["nan_batch", "nan_loss",
                                               "raise"]
    assert chaos.trajectory(out["losses"], 12).tolist() == \
        chaos.trajectory(base["losses"], 12).tolist()
