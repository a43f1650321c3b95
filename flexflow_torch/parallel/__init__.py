"""Parallelization strategies of the port (the counterpart of
``flexflow_tpu/parallel``): the strategy table and its JSON files."""
