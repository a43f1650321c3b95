"""Preemption handling: the first part of ``flexflow_tpu/runtime/
resilience.py``.

:class:`PreemptionHandler` turns SIGTERM / SIGINT into a flag that a
loop reads at its step or superstep boundaries, the analogue of a cloud
scheduler's grace window: the serving loop's drain (``Server(
drain_on_preempt=True)``, armed by a journal) stops admitting at the
next boundary and exits with its in-flight work journaled.  The rest of
the JAX module (``FailurePolicy``, ``FaultInjector``,
``ResilientTrainer``) comes with checkpoints (ROADMAP.md queue 1,
item 7).
"""

from __future__ import annotations

import logging
import signal
from typing import Any, Dict, Iterable, Optional

logger = logging.getLogger("ff.resilience")


class PreemptionHandler:
    """SIGTERM/SIGINT -> ``triggered``, read by the loop at its
    boundaries.  A second SIGINT restores the default handling (an
    impatient ^C^C still kills).  Handlers can be installed only on the
    main thread; elsewhere the handler is never triggered.  Use it as a
    context manager: leaving restores the previous handlers."""

    def __init__(self, install: bool = True,
                 signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self._install = install
        self._signals = tuple(signals)
        self._previous: Dict[int, Any] = {}
        self.triggered = False
        self.signum: Optional[int] = None

    def _on_signal(self, signum, frame):
        if self.triggered and signum == signal.SIGINT:
            self._restore()
            raise KeyboardInterrupt
        self.triggered = True
        self.signum = signum
        logger.warning("received signal %d: stopping at the next step or "
                       "superstep boundary, then a clean exit", signum)

    def __enter__(self) -> "PreemptionHandler":
        if self._install:
            try:
                for s in self._signals:
                    self._previous[s] = signal.signal(s, self._on_signal)
            except ValueError:  # not the main thread
                logger.info("signal handlers unavailable off the main "
                            "thread; preemption handling disabled")
                self._previous = {}
        return self

    def _restore(self) -> None:
        for s, h in self._previous.items():
            signal.signal(s, h)
        self._previous = {}

    def __exit__(self, *exc) -> None:
        self._restore()
