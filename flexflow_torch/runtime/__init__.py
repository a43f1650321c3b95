"""Runtime of the port: executor, serving (the counterparts of
``flexflow_tpu/runtime``)."""
