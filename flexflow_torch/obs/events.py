"""The registered telemetry event-name catalog: the port's copy of
``flexflow_tpu/obs/events.py``, name for name.

The writer (``runtime/telemetry.py``) emits only these names, and fflint
rule FF008 holds every ``emit`` call site of the repo against the same
set, so a run log of the port reads with the JAX package's reader.
This module imports nothing.
"""

from __future__ import annotations

#: Every event type the runtime may emit, one per OBSERVABILITY.md
#: schema row.  frozenset: membership is the only operation.
EVENT_CATALOG = frozenset({
    # lifecycle
    "run_start",
    "run_end",
    # training loop
    "step",
    "input_wait",
    "superstep",
    "fence",
    "compiled_step",
    "program_cost",
    "embedding_gather",
    "embedding_combine",
    # checkpoint / resilience
    "ckpt_save",
    "ckpt_restore",
    "ckpt_torn",
    "fault",
    "rollback",
    "replay",
    "preempt",
    # watchdog / profiling
    "stall",
    "stall_recovered",
    "profile_skipped",
    # static analysis + execution search
    "analysis",
    "search",
    # serving (SERVING.md)
    "request_start",
    "kv_wait",
    "prefill",
    "prefix_hit",
    "kv_cow",
    "decode_superstep",
    "spec_verify",
    "request_end",
    "serving_program",
    # serving scheduler (SERVING.md "Scheduler policy")
    "sched_decision",
    "request_preempt",
    "request_shed",
    # serving failure model (SERVING.md "Failure model")
    "request_retry",
    "request_expire",
    "serving_drain",
    "engine_restart",
    "degraded_mode",
    # serving fleet (SERVING.md "Fleet")
    "replica_route",
    "replica_loss",
    "fleet_state",
    # multi-host / elastic (RESILIENCE.md "Host loss & elastic resize")
    "distributed_init",
    "elastic_resize",
})

#: ``run_end.exit`` classifications (the reader adds ``truncated`` for
#: logs that never reached ``run_end`` at all).
EXIT_CLEAN = "clean"
EXIT_PREEMPT = "preempt"
EXIT_TRUNCATED = "truncated"


def exit_exception(exc_type_name: str) -> str:
    """The ``exception:<type>`` exit form for ``run_end.exit``."""
    return f"exception:{exc_type_name}"
