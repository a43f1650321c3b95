"""Candle-Uno: the port of ``flexflow_tpu/models/candle_uno.py``
(reference ``examples/candle_uno/candle_uno.{h,cc}``), the multi-tower
cancer-drug-response MLP.

Six inputs (a dose scalar, cell RNA-seq, two drugs' descriptors and
fingerprints); each cell/drug input passes through its own feature tower
(``dense_feature_layers``, 3 x 1000 ReLU by default), the encodings are
concatenated, then a dense trunk (``dense_layers``, 3 x 1000) and a
1-unit head into a mean MSE loss (``candle_uno.cc:82-112``).  The same
op names and shapes as the JAX package.  ``candle_uno_strategy`` is the
JAX function's table: the feature towers data-parallel, the trunk's
dense layers the ``n x c`` hybrid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.ops.base import TensorSpec
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore


@dataclasses.dataclass
class CandleConfig:
    """Defaults mirror ``candle_uno.h:20-37``."""

    dense_layers: List[int] = dataclasses.field(default_factory=lambda: [1000] * 3)
    dense_feature_layers: List[int] = dataclasses.field(
        default_factory=lambda: [1000] * 3
    )
    feature_shapes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "dose": 1,
            "cell.rnaseq": 942,
            "drug.descriptors": 5270,
            "drug.fingerprints": 2048,
        }
    )
    input_features: Dict[str, str] = dataclasses.field(
        default_factory=lambda: {
            "dose1": "dose",
            "cell.rnaseq": "cell.rnaseq",
            "drug1.descriptors": "drug.descriptors",
            "drug1.fingerprints": "drug.fingerprints",
            "drug2.descriptors": "drug.descriptors",
            "drug2.fingerprints": "drug.fingerprints",
        }
    )

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "CandleConfig":
        cfg = CandleConfig()
        argv = list(argv)
        for i, a in enumerate(argv):
            if a in ("--dense-layers", "--dense-feature-layers"):
                if i + 1 >= len(argv):
                    raise ValueError(f"flag {a} expects a value")
                widths = [int(w) for w in argv[i + 1].split("-")]
                if a == "--dense-layers":
                    cfg.dense_layers = widths
                else:
                    cfg.dense_feature_layers = widths
        return cfg


def build_candle_uno(
    batch_size: int = 64,
    candle: Optional[CandleConfig] = None,
    config: Optional[FFConfig] = None,
) -> FFModel:
    candle = candle or CandleConfig()
    ff = FFModel(config or FFConfig(batch_size=batch_size))

    # cell.*/drug.* feature types get an encoder tower (candle_uno.cc:70-81).
    tower_types = {
        ft for ft in candle.feature_shapes
        if "." in ft and ft.split(".")[0] in ("cell", "drug")
    }

    encoded: List[TensorSpec] = []
    for in_name, fea_type in candle.input_features.items():
        shape = candle.feature_shapes[fea_type]
        safe = in_name.replace(".", "_")
        t = ff.create_tensor((batch_size, shape), name=f"input_{safe}")
        if fea_type in tower_types:
            for j, width in enumerate(candle.dense_feature_layers):
                t = ff.dense(t, width, activation="relu",
                             name=f"tower_{safe}_dense{j}")
        encoded.append(t)

    out = ff.concat(encoded, axis=1, name="concat")
    for j, width in enumerate(candle.dense_layers):
        out = ff.dense(out, width, activation="relu", name=f"trunk_dense{j}")
    out = ff.dense(out, 1, activation=None, name="head")
    label = ff.create_tensor((batch_size, 1), name="label")
    ff.mse_loss(out, label, reduction="mean", name="mse_loss")
    return ff


def candle_uno_strategy(
    num_devices: int = 1,
    candle: Optional[CandleConfig] = None,
    tp: Optional[int] = None,
) -> StrategyStore:
    """The JAX function's table (``flexflow_tpu/models/candle_uno.py:
    99-120``): every trunk dense layer at ``n = num_devices / tp, c =
    tp`` (``tp`` 2 on an even count of devices above one, else 1), the
    feature towers data-parallel (not in the table)."""
    candle = candle or CandleConfig()
    if tp is None:
        tp = 2 if num_devices % 2 == 0 and num_devices > 1 else 1
    if num_devices % tp:
        raise ValueError(f"candle_uno_strategy({num_devices}, tp={tp}): tp "
                         f"must divide the devices")
    store = StrategyStore(num_devices)
    for j in range(len(candle.dense_layers)):
        store.set(f"trunk_dense{j}",
                  ParallelConfig(n=num_devices // tp, c=tp))
    return store
