"""Run analytics of the port: the read half of its telemetry, the
counterpart of ``flexflow_tpu/obs/``.

``runtime/telemetry.py`` writes one JSONL stream per run (OBSERVABILITY.md's
schema); this package reads them back: the event catalog (``events``),
the typed reader (``reader``), per-request span timelines and the tail
autopsy (``spans``), the cross-run comparator and paired measurement
protocol (``compare``), the box fingerprint and run index (``registry``),
the device-time summary of a ``torch.profiler`` trace (``trace``) and the
CLI (``python -m flexflow_torch.obs report|request|compare|history``).

Nothing here imports torch at module load (the CLI reads logs on any
box); ``registry.box_fingerprint`` imports it inside the call.
"""

from flexflow_torch.obs.events import (
    EVENT_CATALOG,
    EXIT_CLEAN,
    EXIT_PREEMPT,
    EXIT_TRUNCATED,
    exit_exception,
)
from flexflow_torch.obs.reader import (
    Event,
    RunLog,
    latest_run,
    resolve_run,
    run_files,
)
from flexflow_torch.obs.compare import (
    DEFAULT_THRESHOLDS,
    CompareResult,
    PairedResult,
    compare_paths,
    compare_runs,
    paired_measure,
)
from flexflow_torch.obs.registry import (
    append_run,
    box_fingerprint,
    fingerprint_diff,
    history,
    index_record,
)

__all__ = [
    "EVENT_CATALOG", "EXIT_CLEAN", "EXIT_PREEMPT", "EXIT_TRUNCATED",
    "exit_exception",
    "Event", "RunLog", "latest_run", "resolve_run", "run_files",
    "DEFAULT_THRESHOLDS", "CompareResult", "PairedResult",
    "compare_paths", "compare_runs", "paired_measure",
    "append_run", "box_fingerprint", "fingerprint_diff", "history",
    "index_record",
]
