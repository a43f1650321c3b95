"""Per-operator parallelization strategies: the port of
``flexflow_tpu/parallel/strategy.py``.

A strategy names an op's *degrees* along the semantic axes ``n``
(sample), ``c`` (channel / output feature), ``h`` and ``w`` (spatial)
and ``s`` (sequence), plus an optional explicit device list (the
reference's ``ParallelConfig`` keyed by op name,
``include/config.h:39-48``).  Strategies are stored in the JAX package's
JSON file, byte for byte::

    {"num_devices": 8, "ops": {"conv1": {"c": 2, "n": 4}}, "version": 1}

An op the table does not name takes data parallelism over every device,
as in the JAX package.  A table that places an op on a proper subset of
the devices (``device_ids``) is layer-wise placement: the pipeline runs
it (``runtime/pipeline.py``, chosen by ``make_executor``), and the plain
``Executor``, which runs every op on the full mesh, refuses it
(``StrategyStore.check_full_mesh``).  The reference's protobuf files
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

    def degree(self, axis: str) -> int:
        return getattr(self, axis)

    @property
    def num_parts(self) -> int:
        return self.n * self.c * self.h * self.w * self.s

    @staticmethod
    def data_parallel(num_devices: int) -> "ParallelConfig":
        """The reference's DataParallelismID fallback: the sample dim
        split over every device."""
        return ParallelConfig(n=num_devices)

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
    """Op name -> ParallelConfig with a data-parallel fallback, as the
    JAX package's store (``FFConfig::find_parallel_config`` of the
    reference)."""

    def __init__(self, num_devices: int,
                 table: Optional[Dict[str, ParallelConfig]] = None):
        self.num_devices = num_devices
        self.table: Dict[str, ParallelConfig] = dict(table or {})

    def find(self, op_name: str) -> ParallelConfig:
        pc = self.table.get(op_name)
        if pc is None:
            return ParallelConfig.data_parallel(self.num_devices)
        return pc

    def set(self, op_name: str, pc: ParallelConfig) -> None:
        if pc.num_parts > self.num_devices:
            raise ValueError(f"strategy for {op_name!r} uses {pc.num_parts} "
                             f"parts but only {self.num_devices} devices "
                             f"exist")
        self.table[op_name] = pc

    @staticmethod
    def data_parallel(num_devices: int) -> "StrategyStore":
        return StrategyStore(num_devices, {})

    @property
    def layer_wise(self) -> bool:
        """True when some op pins a proper subset of the devices: the
        table then runs as pipeline stages (``make_executor`` routes on
        the same test).  JAX's one source of truth for
        :meth:`superstep_mode`."""
        return any(pc.device_ids is not None
                   and len(set(pc.device_ids)) < self.num_devices
                   for pc in self.table.values())

    def superstep_mode(self, compiled: bool = False) -> str:
        """How ``steps_per_call > 1`` runs this table (JAX's words):
        ``"fused"``, K steps as one program (one CUDA graph a rank on
        CUDA over NCCL), for full-mesh tables and for layer-wise ones on
        the compiled pipeline step; ``"amortized"``, K host-driven
        pipeline steps back to back under one fence
        (``Trainer._fit_superstep_pipeline``), for layer-wise tables on
        the host-driven pipeline."""
        return "amortized" if self.layer_wise and not compiled else "fused"

    def superstep_capable(self, compiled: bool = False) -> bool:
        """Whether the fused superstep realizes this table (see
        :meth:`superstep_mode`)."""
        return self.superstep_mode(compiled=compiled) == "fused"

    def check_devices(self) -> None:
        """Raise when an op needs more devices than the store has: more
        parts than devices, or a device id past the last."""
        for name, pc in sorted(self.table.items()):
            if pc.num_parts > self.num_devices:
                raise ValueError(f"strategy for {name!r} uses "
                                 f"{pc.num_parts} parts but only "
                                 f"{self.num_devices} devices exist "
                                 f"(-ll:gpu {pc.num_parts})")
            ids = pc.device_ids or ()
            if any(not 0 <= d < self.num_devices for d in ids):
                raise ValueError(
                    f"strategy for {name!r} places on devices "
                    f"{sorted(set(ids))} but only {self.num_devices} "
                    f"devices exist (-ll:gpu {max(ids) + 1})")

    def check_full_mesh(self) -> None:
        """Raise unless every op runs on all the devices (the plain
        ``Executor``'s rule, as JAX's): an op pinned to a proper subset
        (``device_ids``) is layer-wise placement, which
        ``runtime/pipeline.py``'s ``PipelineExecutor`` runs
        (``make_executor`` chooses it)."""
        self.check_devices()
        full = set(range(self.num_devices))
        for name, pc in sorted(self.table.items()):
            ids = pc.device_ids
            if ids is not None and set(ids) != full:
                raise ValueError(
                    f"strategy for {name!r} places on devices "
                    f"{sorted(set(ids))} of {self.num_devices}; the "
                    f"Executor runs every op on the full mesh: use "
                    f"flexflow_torch.runtime.pipeline.PipelineExecutor (or "
                    f"make_executor) for layer-wise placement")

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
