"""The analytic op cost of the port (the flops part of
``flexflow_tpu/search``)."""
