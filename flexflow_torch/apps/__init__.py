"""Command-line apps of the port (the counterparts of ``flexflow_tpu/apps``)."""
