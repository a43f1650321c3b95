"""Per-operator parallelization strategies: the port of
``flexflow_tpu/parallel/strategy.py``.

A strategy names an op's *degrees* along the semantic axes ``n``
(sample), ``c`` (channel / output feature), ``h`` and ``w`` (spatial)
and ``s`` (sequence), plus an optional explicit device list (the
reference's ``ParallelConfig`` keyed by op name,
``include/config.h:39-48``).  Strategies are stored in the JAX package's
JSON file, byte for byte::

    {"num_devices": 8, "ops": {"conv1": {"c": 2, "n": 4}}, "version": 1}

The port runs on one GPU, so the apps accept only a store that puts
every op there (``apps.common.load_strategy``); spreading ops over
devices is ROADMAP.md queue 1, item 9.  The reference's protobuf files
(``.pb``) are refused: their codec is the JAX package's native
``ffproto.cc``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

AXES = ("n", "c", "h", "w", "s")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Parallel degrees along the semantic axes for one op; a missing
    axis has degree 1.  ``device_ids`` is an optional explicit placement
    (the reference's ``gpu[]``)."""

    n: int = 1
    c: int = 1
    h: int = 1
    w: int = 1
    s: int = 1
    device_ids: Optional[Tuple[int, ...]] = None

    @property
    def num_parts(self) -> int:
        return self.n * self.c * self.h * self.w * self.s

    def to_json(self) -> Dict:
        d = {a: getattr(self, a) for a in AXES if getattr(self, a) != 1}
        if self.device_ids is not None:
            d["device_ids"] = list(self.device_ids)
        return d

    @staticmethod
    def from_json(d: Dict) -> "ParallelConfig":
        ids = d.get("device_ids")
        return ParallelConfig(**{a: int(d.get(a, 1)) for a in AXES},
                              device_ids=tuple(ids) if ids is not None
                              else None)


class StrategyStore:
    """Op name -> ParallelConfig, as the JAX package's JSON file holds it.
    The port reads a store only to check that it places every op on the
    one GPU; the JAX store's lookup and its data-parallel fallback come
    with the slice that spreads ops over devices."""

    def __init__(self, num_devices: int,
                 table: Optional[Dict[str, ParallelConfig]] = None):
        self.num_devices = num_devices
        self.table: Dict[str, ParallelConfig] = dict(table or {})

    # -- (de)serialization ------------------------------------------------

    def save(self, path: str) -> None:
        payload = {
            "version": 1,
            "num_devices": self.num_devices,
            "ops": {k: v.to_json() for k, v in self.table.items()},
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")

    @staticmethod
    def load(path: str, num_devices: Optional[int] = None) -> "StrategyStore":
        if path.endswith(".pb"):
            raise ValueError(
                f"{path}: the reference's protobuf strategy files are not "
                f"read by the port (their codec is the JAX package's native "
                f"ffproto.cc); save the strategy as JSON")
        with open(path) as f:
            payload = json.load(f)
        nd = (num_devices if num_devices is not None
              else int(payload["num_devices"]))
        table = {k: ParallelConfig.from_json(v)
                 for k, v in payload.get("ops", {}).items()}
        return StrategyStore(nd, table)
