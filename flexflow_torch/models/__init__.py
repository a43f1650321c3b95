"""Models of the port (the counterparts of ``flexflow_tpu/models``)."""
