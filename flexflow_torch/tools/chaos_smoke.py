"""Chaos smoke: the port's fault matrix (``runtime/chaos.py``), one line
per scenario, the counterpart of the repo's ``tools/chaos_smoke.py``.

The training scenarios (a raised fault, a NaN batch, a NaN loss inside a
k = 8 superstep, SIGTERM and resume, a torn checkpoint, a force-replace
killed between its phases) must end with a loss trajectory bit-identical
to the unfaulted run's; the serving ones (a decode fault, the drain on
SIGTERM, a fault under speculation, the prefix donor's crash) must
isolate the faulted requests and leave every other one's tokens as the
unfaulted run's, padded and paged, and the scheduler's (an overload
shed, an engine crash) must shed the same requests on every replay and
resume a crash with the uninterrupted run's tokens.  Scenarios whose machinery is not
ported yet print ``NOT PORTED`` with their ROADMAP.md item and count
neither as passed nor as failed.

Runs on the GPU by default, in this process::

    python -m flexflow_torch.tools.chaos_smoke [--device cpu] [scenario ...]

Exit code 0 iff every ported scenario that ran passed.
"""

from __future__ import annotations

import sys
import tempfile
import time


def main(argv=None) -> int:
    from flexflow_torch.runtime.chaos import SCENARIOS, run_matrix
    from flexflow_torch.runtime.executor import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    device = resolve_device(device)
    names = [a for a in argv if not a.startswith("-")]
    unknown = set(names) - set(SCENARIOS)
    if unknown:
        print(f"unknown scenarios: {sorted(unknown)} (have: "
              f"{list(SCENARIOS)})", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    passed = failed = skipped = 0
    with tempfile.TemporaryDirectory(prefix="chaos_smoke_") as root:
        for name in names or list(SCENARIOS):
            ts = time.perf_counter()
            for ok, rname, detail in run_matrix(root, [name], device=device):
                dt = time.perf_counter() - ts
                tag = "NOT PORTED" if ok is None else ("PASS" if ok else "FAIL")
                print(f"{tag:<10} {rname:<24} {dt:6.1f}s  {detail}",
                      flush=True)
                passed += ok is True
                failed += ok is False
                skipped += ok is None
    print(f"chaos matrix on {device}: {passed}/{passed + failed} ported "
          f"scenarios passed, {skipped} not ported, in "
          f"{time.perf_counter() - t0:.1f}s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
