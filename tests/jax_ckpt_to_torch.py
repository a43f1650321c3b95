"""Test-side converter: a checkpoint directory of the JAX package
(orbax) into the port's format.

The port never imports this module (it needs ``jax`` and ``orbax``).  It
restores one step with the JAX package's ``CheckpointManager``, turns
each tree into numpy and then into tensors through the port's
``weights.py`` (bf16 through its raw bits), and writes the step with the
port's ``CheckpointManager.save``.
"""

import jax

from flexflow_torch.runtime.checkpoint import CheckpointManager
from flexflow_torch.weights import (
    opt_state_from_numpy,
    params_from_numpy,
    state_from_numpy,
)


def convert(jax_dir: str, torch_dir: str, templates, step=None) -> int:
    """Write step ``step`` (default: the latest) of the JAX checkpoint
    ``jax_dir`` into ``torch_dir`` in the port's format.  ``templates``
    is a JAX ``Executor.init()`` of the same model and optimizer.
    Returns the step."""
    from flexflow_tpu.runtime.checkpoint import CheckpointManager as JCkpt

    with JCkpt(jax_dir) as ck:
        step, params, opt_state, state = ck.restore(templates=templates,
                                                    step=step)
    params, opt_state, state = jax.device_get((params, opt_state, state))
    with CheckpointManager(torch_dir) as ck:
        ck.save(step, params_from_numpy(params, device="cpu"),
                opt_state_from_numpy(opt_state, device="cpu"),
                state_from_numpy(state or {}, device="cpu"), force=True)
    return int(step)
