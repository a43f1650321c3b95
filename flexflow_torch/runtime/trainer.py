"""The cap on fused steps per host readback.

Only ``MAX_STEPS_PER_CALL`` and ``relay_safe_steps`` of
``flexflow_tpu/runtime/trainer.py`` for now: the serving loop clamps its
decode steps per superstep through them exactly as the JAX one does,
which keeps the two loops' superstep counts comparable and the fflint
rule FF006 satisfied.  ``Trainer`` comes with the training slice.
"""

from __future__ import annotations

import logging

_log = logging.getLogger("ff.trainer")

#: Most fused steps between two host readbacks.
MAX_STEPS_PER_CALL = 20


def relay_safe_steps(k: int, what: str = "steps_per_call",
                     log: logging.Logger = _log) -> int:
    """Clamp a fused step count to ``[1, MAX_STEPS_PER_CALL]``, warning
    when it cuts."""
    k = int(k)
    if k > MAX_STEPS_PER_CALL:
        log.warning("%s=%d exceeds the fused-step cap; clamping to %d",
                    what, k, MAX_STEPS_PER_CALL)
        return MAX_STEPS_PER_CALL
    return max(1, k)
