"""Parallelization of the port (the counterpart of
``flexflow_tpu/parallel``): the strategy table and its JSON files
(``strategy``), the mesh plan (``mesh``, ``distributed``), the world of
ranks (``launch``) and the collectives between them (``collectives``)."""
