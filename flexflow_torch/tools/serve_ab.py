"""The plain ``Server``'s decode superstep, this checkout's against
another's, in turns on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 flexflow_torch/tools/serve_ab.py --against DIR [--runs N]

``DIR`` is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive``, say).  Each turn is a process of
its own that imports ``flexflow_torch`` from one checkout and builds that
checkout's kernels there; the turns run theirs, ours, ours, theirs.  A
turn serves chip_smoke's phase 20 (e) "padded on K6" arm: the bf16
transformer LM at ``bench.py``'s serving widths (vocab 32768, d_model
512, 8 heads, 6 layers, max_seq 128, 8 slots, buckets 64 and 128) with
random weights from seed 0, sixteen ``synthetic_requests`` (prompts of
4-32 tokens, 32 new tokens, seed 0) through ``Server(decode_steps=8)``
with its decode superstep a CUDA graph, ``N`` + 1 times (the first run
captures the graph and is left out).  Each turn prints one JSON line:
the ms per decode step of each later run (``decode_s`` over the decode
steps: the Server's own window around the replay and its readback), its
median, and a digest of the tokens, which must be the same in every
turn.  The card's name and power limit come first.
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


def _turn(root: str, runs: int) -> dict:
    """One checkout's arm in this process (``root`` first on the path)."""
    sys.path.insert(0, root)
    import hashlib

    import torch

    import flexflow_torch
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import (
        Server,
        ServingExecutor,
        synthetic_requests,
    )

    here = os.path.dirname(os.path.abspath(flexflow_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(root):
        raise RuntimeError(f"imported {here}, not {root}'s package")
    cfg = FFConfig(compute_dtype="bfloat16", seed=0)
    ff = build_transformer_lm(batch_size=8, seq_len=128, vocab_size=32768,
                              d_model=512, num_heads=8, num_layers=6,
                              config=cfg)
    ex = ServingExecutor(ff, cfg, max_batch=8, max_seq=128,
                         buckets=(64, 128), device="cuda")
    params = ex.init(0)[0]
    reqs = synthetic_requests(16, 32768, prompt_len=(4, 32),
                              max_new_tokens=32, seed=0)
    srv = Server(ex, params, {}, decode_steps=8, graph=True)
    ms, digest = [], None
    for i in range(runs + 1):
        res, st = srv.run(reqs)
        if st["failed"]:
            raise RuntimeError(f"{root}: {st['failed']} requests failed")
        toks = json.dumps({r: res[r].tokens for r in sorted(res)})
        d = hashlib.sha256(toks.encode()).hexdigest()[:16]
        if digest not in (None, d):
            raise RuntimeError(f"{root}: run {i} gave other tokens")
        digest = d
        if i:
            ms.append(st["decode_s"] * 1e3 / (st["decode_supersteps"] * 8))
    torch.cuda.synchronize()
    return {"root": root, "ms_per_step": ms,
            "median_ms_per_step": statistics.median(ms), "tokens": digest}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's root")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.turn:
        print(json.dumps(_turn(a.turn, a.runs)), flush=True)
        return 0
    if not a.against:
        ap.error("--against DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    theirs = os.path.abspath(a.against)
    out = []
    for root in (theirs, _ROOT, _ROOT, theirs):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn", root, "--runs", str(a.runs)],
                           capture_output=True, text=True, timeout=1200)
        if p.returncode:
            sys.stderr.write(p.stdout + p.stderr)
            return p.returncode
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        out.append(json.loads(line))
    if len({o["tokens"] for o in out}) != 1:
        print("serve_ab: the checkouts' tokens differ", file=sys.stderr)
        return 1
    med = {side: statistics.median(
        m for o in out if (o["root"] == _ROOT) == (side == "ours")
        for m in o["ms_per_step"]) for side in ("theirs", "ours")}
    print(json.dumps({"theirs_ms_per_step": med["theirs"],
                      "ours_ms_per_step": med["ours"],
                      "ours_over_theirs": med["ours"] / med["theirs"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
