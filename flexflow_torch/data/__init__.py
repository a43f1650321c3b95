"""Host data for the port (the counterpart of ``flexflow_tpu/data``)."""
