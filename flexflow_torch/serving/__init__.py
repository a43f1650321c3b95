"""Serving above the single loop, the counterpart of
``flexflow_tpu/serving``: the open-loop workloads (``workload``), the
SLO-aware scheduler on its virtual clock with its failure model
(``scheduler``), the serving latency model that prices it
(``latency_model``) and the crash-recovery request journal
(``journal``).  The fleet and the ``--serve-auto`` search come with
ROADMAP.md queue 1, item 8's rest."""

from flexflow_torch.serving.journal import (
    EV_ADMIT,
    EV_DONE,
    EV_DRAIN,
    EV_TOKENS,
    KNOWN_KINDS,
    JournalState,
    MemoryJournal,
    RequestJournal,
    fold_journal_events,
)
from flexflow_torch.serving.latency_model import ServingLatencyModel
from flexflow_torch.serving.scheduler import (
    ADAPTIVE_K_CANDIDATES,
    ScheduledServer,
    SchedulerPolicy,
    ServingResilience,
    SlotShape,
)
from flexflow_torch.serving.workload import (
    WorkloadSpec,
    make_workload,
    production_workload,
    uniform_workload,
)

__all__ = ["EV_ADMIT", "EV_DONE", "EV_DRAIN", "EV_TOKENS", "KNOWN_KINDS",
           "JournalState", "MemoryJournal", "RequestJournal",
           "fold_journal_events", "ServingLatencyModel",
           "ADAPTIVE_K_CANDIDATES", "ScheduledServer", "SchedulerPolicy",
           "ServingResilience", "SlotShape", "WorkloadSpec",
           "make_workload", "production_workload", "uniform_workload"]
