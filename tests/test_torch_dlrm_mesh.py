"""The DLRM app across worlds of CPU ranks, through its command line.

``python -m flexflow_torch.apps.dlrm -ll:gpu 2`` spawns its own world
(``apps.common.spawn_ranks``: gloo on the CPU) and prints one report:
with ``dlrm_strategy``'s tables (the stacked tables at c=2), with a
``-s`` table (n=2 c=1, replicated), with ``--lazy-sparse-opt`` and with
``--shard-embeddings`` over tables of mixed vocabularies.
``strategies/dlrm_8chip.json`` behaves as JAX's app does with the same
file: it trains on 8 devices and is refused on 2.  NMT under two ranks is
refused by its LSTM, naming ROADMAP.md item 9d.  The numbers of these
worlds are held in ``tests/test_torch_embedding_sharding.py``.
"""

import json

import numpy as np
import pytest

from flexflow_torch.apps import dlrm as tapp
from flexflow_torch.apps import nmt as tnmt
from flexflow_tpu.apps import dlrm as japp

BASE = ["-b", "8", "-i", "2", "--optimizer", "sgd", "--momentum", "0",
        "--wd", "0", "--lr", "0.5"]
EIGHT_CHIP = "strategies/dlrm_8chip.json"


def _strategy_file(tmp_path):
    path = tmp_path / "replicated.json"
    path.write_text(json.dumps({"version": 1, "num_devices": 2,
                                "ops": {"embeddings": {"n": 2, "c": 1}}}))
    return str(path)


@pytest.mark.parametrize("case", ["dlrm_strategy", "s_table", "lazy",
                                  "shard_embeddings"])
def test_dlrm_app_on_two_cpu_ranks_prints_one_report(capfd, tmp_path, case):
    extra = {
        "dlrm_strategy": [],
        "s_table": ["-s", _strategy_file(tmp_path)],
        "lazy": ["--optimizer", "adam", "--lr", "0.01", "--lazy-sparse-opt"],
        "shard_embeddings": ["--shard-embeddings",
                             "--arch-sparse-feature-size", "8",
                             "--arch-embedding-size", "50-60-70",
                             "--arch-mlp-bot", "4-8", "--arch-mlp-top",
                             "32-8-1"],
    }[case]
    stats = {}
    assert tapp.main(BASE + ["-ll:gpu", "2"] + extra, device="cpu",
                     stats_out=stats) == 0
    out = capfd.readouterr().out
    assert out.count("THROUGHPUT = ") == 1
    assert len(stats["step_losses"]) == 3
    assert np.isfinite(stats["step_losses"]).all()
    assert "final" not in stats and "executor" not in stats


def test_dlrm_8chip_table_on_eight_ranks_as_jax(capfd):
    """The file's ``embeddings`` at c=8 (4 tables, which c=8 does not
    divide: replicated, JAX's rule) trains on 8 ranks, as JAX's app
    trains on 8 devices."""
    args = ["-ll:gpu", "8", "-s", EIGHT_CHIP, "-b", "8", "-i", "1"]
    assert japp.main(args) == 0
    capfd.readouterr()
    stats = {}
    assert tapp.main(args, device="cpu", stats_out=stats) == 0
    assert capfd.readouterr().out.count("THROUGHPUT = ") == 1
    assert np.isfinite(stats["step_losses"]).all()


def test_dlrm_8chip_table_on_two_ranks_is_refused_as_jax():
    """On 2 devices the file's c=8 cannot be realized: JAX's executor
    raises, and the port refuses the table before any rank starts."""
    from flexflow_tpu.parallel.mesh import InfeasibleStrategyError

    args = ["-ll:gpu", "2", "-s", EIGHT_CHIP, "-b", "8", "-i", "1"]
    with pytest.raises(InfeasibleStrategyError, match="degree 8"):
        japp.main(args)
    with pytest.raises(SystemExit, match="8 parts but only 2 devices"):
        tapp.main(args, device="cpu")


def test_nmt_under_two_ranks_is_refused_by_its_lstm():
    """NMT's word embeddings run on a mesh now; its LSTM does not yet,
    and the app names it and item 9d before any rank starts."""
    with pytest.raises(SystemExit, match="lstm.*item 9d"):
        tnmt.main(["-ll:gpu", "2", "-b", "4", "--vocab", "64", "--hidden",
                   "16", "--src-len", "4", "--tgt-len", "4"], device="cpu")
