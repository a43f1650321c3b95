"""The port's copies of what its run telemetry needs from
``flexflow_tpu/obs/``: the event catalog (``events.py``), the box
fingerprint and run index (``registry.py``) and the device-time summary
of a ``torch.profiler`` trace (``trace.py``).  ``flexflow_tpu.obs``
imports JAX, which the GPU machine lacks; the reader, spans, compare and
the CLI come with a later slice (ROADMAP.md queue 1, item 7's rest)."""
