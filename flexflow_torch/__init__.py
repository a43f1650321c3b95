"""flexflow_torch: the PyTorch/CUDA port of flexflow_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``flexflow_tpu`` is the reference each slice of the port
is held against; this package imports neither it nor JAX.  Modules are
named after their JAX counterparts.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; without a GPU they raise.  ROADMAP.md
lists what is ported and what comes next.
"""
