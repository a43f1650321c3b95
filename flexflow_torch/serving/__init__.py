"""Serving above the single loop, the counterpart of
``flexflow_tpu/serving``: the open-loop workloads (``workload``), the
SLO-aware scheduler on its virtual clock with its failure model
(``scheduler``), the serving latency model that prices it
(``latency_model``), the crash-recovery request journal (``journal``),
the fleet of N replicas behind a failure-aware router (``fleet``) and
the ``--serve-auto`` config search (``search``)."""

from flexflow_torch.serving.fleet import (
    EXIT_FLEET_FAILURE,
    FleetCrashLoop,
    FleetRouter,
    ROUTER_POLICIES,
)
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
from flexflow_torch.serving.search import (
    ServingConfig,
    ServingSearchResult,
    search_serving_config,
)
from flexflow_torch.serving.workload import (
    WorkloadSpec,
    make_workload,
    production_workload,
    uniform_workload,
)

__all__ = ["EXIT_FLEET_FAILURE", "FleetCrashLoop", "FleetRouter",
           "ROUTER_POLICIES", "EV_ADMIT", "EV_DONE", "EV_DRAIN", "EV_TOKENS",
           "KNOWN_KINDS",
           "JournalState", "MemoryJournal", "RequestJournal",
           "fold_journal_events", "ServingLatencyModel",
           "ADAPTIVE_K_CANDIDATES", "ScheduledServer", "SchedulerPolicy",
           "ServingResilience", "SlotShape", "ServingConfig",
           "ServingSearchResult", "search_serving_config", "WorkloadSpec",
           "make_workload", "production_workload", "uniform_workload"]
