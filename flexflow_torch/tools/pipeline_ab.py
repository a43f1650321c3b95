"""The host-driven pipeline's step, this checkout's against another's,
in turns on the same cards.

Run from the root of a checkout, on a machine with CUDA cards:

    python3 flexflow_torch/tools/pipeline_ab.py --against DIR

``DIR`` is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Each turn is a process of
its own that imports ``flexflow_torch`` and ``chip_smoke`` from one
checkout, builds that checkout's kernels and runs chip_smoke's phase 32
arms ``alex_1f1b`` (the README's AlexNet table, m = 4), ``nmt_m1`` and
``nmt_1f1b`` (NMT ``--pipeline`` at bench.py's widths, m = 1 and 2)
through ``flexflow_torch/tools/mesh_pipeline.py::chip_apps`` on a world
of four: NCCL a card a rank with four cards, else gloo with the ranks on
one card.  The arms' argv are this checkout's (``chip_smoke.MESH_PIPE``),
so both turns run the same work.  The turns run theirs, ours, ours,
theirs; each prints one JSON line with every arm's ms a step by rank
(the app's) and its losses, which must agree between the checkouts.
The card's name and power limit come first, the medians by arm last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))


def _runs(nccl: bool) -> list:
    """Phase 32's host-driven arms, with this checkout's widths."""
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs

    c = cs.MESH_PIPE
    ca, cn = c["alexnet"], c["nmt"]
    alex = cs._pipe_alex_argv(ca, ca["batch4"] if nccl else ca["batch"])
    table = ["-s", c["table"], "--microbatches", str(ca["m"])]
    nmt = cs._nmt_argv(cn, ("-i", str(cn["iters"]), "--seed", "0"))
    return [dict(name="alex_1f1b", app="alexnet", argv=alex + table),
            dict(name="nmt_m1", app="nmt",
                 argv=nmt + ["--pipeline", "--microbatches", "1"]),
            dict(name="nmt_1f1b", app="nmt",
                 argv=nmt + ["--pipeline", "--microbatches", str(cn["m"])])]


def _turn(root: str, runs: list, nccl: bool, device: str = "cuda") -> dict:
    """One checkout's arms in this process (``root`` first on the path,
    and the working directory, for the strategy file); ``device="cpu"``
    rehearses a turn on CPU ranks."""
    os.chdir(root)
    sys.path.insert(0, root)
    import flexflow_torch
    from flexflow_torch.ops import kernels
    from flexflow_torch.parallel import launch

    here = os.path.dirname(os.path.abspath(flexflow_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(root):
        raise RuntimeError(f"imported {here}, not {root}'s package")
    if device == "cuda":
        kernels.build()
    ranks = launch.run("flexflow_torch.tools.mesh_pipeline:chip_apps",
                       (runs, {}, device), nprocs=4, device=device,
                       backend=None if nccl or device == "cpu" else "gloo",
                       timeout_s=900)
    return {"root": root, "backend": ranks[0][0]["backend"],
            "ms_step": {run["name"]: [r[i]["ms_step"] for r in ranks]
                        for i, run in enumerate(runs)},
            "losses": {run["name"]: ranks[0][i]["losses"]
                       for i, run in enumerate(runs)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's root")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--runs", help=argparse.SUPPRESS)
    ap.add_argument("--nccl", type=int, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.turn:
        print(json.dumps(_turn(a.turn, json.loads(a.runs), bool(a.nccl))),
              flush=True)
        return 0
    if not a.against:
        ap.error("--against DIR is required")
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    nccl = torch.cuda.device_count() >= 4
    runs = _runs(nccl)
    theirs = os.path.abspath(a.against)
    out = []
    for root in (theirs, _ROOT, _ROOT, theirs):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn", root, "--runs", json.dumps(runs),
                            "--nccl", str(int(nccl))],
                           capture_output=True, text=True, timeout=1500)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
            return p.returncode
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        out.append(json.loads(line))
    if len({json.dumps(o["losses"], sort_keys=True) for o in out}) != 1:
        print("pipeline_ab: the checkouts' losses differ", file=sys.stderr)
        return 1
    summary = {}
    for run in runs:
        for side in ("theirs", "ours"):
            summary[f"{run['name']}_{side}_ms"] = statistics.median(
                ms for o in out if (o["root"] == _ROOT) == (side == "ours")
                for ms in o["ms_step"][run["name"]])
        summary[f"{run['name']}_ours_over_theirs"] = (
            summary[f"{run['name']}_ours_ms"]
            / summary[f"{run['name']}_theirs_ms"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
