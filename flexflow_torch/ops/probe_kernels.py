"""The flash variants of the kernel race and their plain versions.

The counterpart of the Pallas kernels in ``tools/probe_flash_variants.py``
(P1: ``_v2_kernel``, ``_v3_kernel``, ``_v4_kernel``, launched by ``_call``)
and ``tools/probe_flash_bwd_variants.py`` (P2: ``_dq_kernel_lanes`` and
``_dkv_kernel_lanes``, launched by ``_bwd_call_lanes``).  The races
``flexflow_torch.tools.probe_flash_variants`` and
``probe_flash_bwd_variants`` time them beside K1f, K1s, K1b, K1sb and
PyTorch's fused attention; no other module of the port calls them.  In
bf16 every variant runs on the Hopper ``wgmma``/TMA machinery: v2 on K1f's
kernel (``csrc/flash_fwd.cu``), v3 and v4 on the two-pass kernel of
``csrc/flash_probe.cu``, b2 on K1b's pair (``csrc/flash_bwd.cu``); in f32
on the FMA kernels of ``csrc/flash_probe.cu`` and
``csrc/flash_probe_bwd.cu`` (:func:`probe_entry`, :func:`bwd_probe_entry`).
All are built and loaded as every kernel of
:mod:`flexflow_torch.ops.kernels`.

The wrappers follow that module's rule: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises, and each counts its
launches in ``.launches``.  Their gate (:func:`probe_unsupported`) is
checked on every device, so a shape the kernels do not take raises the
same ``ValueError`` on the CPU as on the card.  Operands are ``(..., t,
hd)``: the probes' ``(bh, t, hd)`` or the port's ``(b, h, t, hd)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from flexflow_torch.ops import kernels
from flexflow_torch.ops.kernels import _dense, _load, _raise_on

#: Key-tile widths (the races' ``--blocks``) the kernels are instantiated
#: for; the query tile is 128 rows (two warpgroups of 64) in bf16, 64 rows
#: (4 warps of 16) in f32.
PROBE_BLOCKS = (64, 128)
#: Head dims the kernels are instantiated for.
PROBE_HEAD_DIMS = (64, 128)


def probe_unsupported(shape, dtype, block: int) -> Optional[str]:
    """``None`` if the race kernels take ``(..., t, hd)`` operands of
    ``dtype`` at key tile ``block``; else the part of the gate that fails.
    The gate: f32 or bf16, ``hd`` in ``PROBE_HEAD_DIMS``, ``block`` in
    ``PROBE_BLOCKS``, any ``t >= 1`` (ragged tiles are masked), and at
    most 65535 heads (one grid row per head)."""
    if len(shape) < 3:
        return f"operands must be (..., t, hd), got {tuple(shape)}"
    t, hd = shape[-2], shape[-1]
    bh = math.prod(shape[:-2])
    if dtype not in kernels._KERNEL_DTYPES:
        return f"dtype {dtype} is not instantiated (float32, bfloat16)"
    if hd not in PROBE_HEAD_DIMS:
        return f"head dim {hd} is not in {PROBE_HEAD_DIMS}"
    if block not in PROBE_BLOCKS:
        return f"block {block} is not in {PROBE_BLOCKS}"
    if t < 1 or not 1 <= bh <= 65535:
        return f"t = {t} must be >= 1 and the heads ({bh}) in [1, 65535]"
    return None


def _gate(what, block, q, *others):
    for x in others:
        if x.shape != q.shape:
            raise ValueError(f"{what}: operands {tuple(q.shape)} and "
                             f"{tuple(x.shape)} differ")
    why = probe_unsupported(tuple(q.shape), q.dtype, block)
    if why is not None:
        raise ValueError(f"{what}: outside the race kernels' gate: {why}")


def _cuda_args(what, *tensors):
    """Dense CUDA operands of one dtype and the kernel's dtype code."""
    code = kernels._check_cuda(what, *tensors, head_dim=False)
    return [_dense(x) for x in tensors], code


# ---------------------------------------------------------------------------
# P1: the forward variants v2 (row state), v3 (two passes), v4 (full row)
# ---------------------------------------------------------------------------


def _fwd_plain(q, k, v, causal: bool = True):
    """The function the three forward variants compute: K1f's ``o``
    (:func:`kernels.flash_attention_lse_plain`), with its cast points."""
    return kernels.flash_attention_lse_plain(q, k, v, causal)[0]


#: Plain versions of the three forward variants: one function, K1f's.
flash_fwd_row_state_plain = _fwd_plain
flash_fwd_two_pass_plain = _fwd_plain
flash_fwd_full_row_plain = _fwd_plain


def probe_entry(variant: int, dtype) -> Tuple[str, str]:
    """The library and C entry a forward variant (0 v2, 1 v3, 2 v4) of
    ``dtype`` launches.  In bf16 all three run on the ``wgmma`` machinery
    fed by TMA (``csrc/wgmma_tile.cuh``): v2 on K1f's kernel
    (``flash_fwd``'s ``ff_flash_fwd_row_state``: K1f's formulation at the
    race's key tile, without the lse), v3 and v4 on the two-pass kernel
    (``flash_probe``'s ``ff_flash_probe_fwd_wg``).  In f32 each takes
    ``flash_probe``'s ``ff_flash_probe_fwd``, the FMA kernels of
    ``csrc/mma_tile.cuh`` (``wgmma`` takes f32 only as TF32).  The three
    entries share one C signature."""
    if dtype != torch.bfloat16:
        return "flash_probe", "ff_flash_probe_fwd"
    if variant == 0:
        return "flash_fwd", "ff_flash_fwd_row_state"
    return "flash_probe", "ff_flash_probe_fwd_wg"


def bwd_probe_entry(dtype) -> Tuple[str, str]:
    """The library and C entry b2 of ``dtype`` launches: in bf16 K1b's
    ``wgmma`` pair with the dq pass reading the caller's ``delta``
    (``flash_bwd``'s ``ff_flash_bwd_row_state``), in f32 the FMA kernels of
    ``csrc/mma_tile.cuh`` (``flash_probe_bwd``'s ``ff_flash_probe_bwd``).
    The two entries share one C signature."""
    if dtype == torch.bfloat16:
        return "flash_bwd", "ff_flash_bwd_row_state"
    return "flash_probe_bwd", "ff_flash_probe_bwd"


def probe_attrs(kernel: str, hd: int, block: int) -> Tuple[int, int, int]:
    """(registers per thread, spill bytes per thread, dynamic shared
    memory) of a bf16 race kernel at head dim ``hd`` and block ``block``:
    ``kernel`` is ``"v2"``, ``"v3"``, ``"v4"`` or one of b2's passes,
    ``"b2 dq"`` and ``"b2 dkv"``.  On the card only."""
    out = (ctypes.c_int * 3)()
    if kernel == "v2":
        err = _load("flash_fwd").ff_flash_fwd_row_state_attrs(hd, block, out)
    elif kernel in ("v3", "v4"):
        err = _load("flash_probe").ff_flash_probe_wg_attrs(
            {"v3": 1, "v4": 2}[kernel], hd, block, out)
    elif kernel in ("b2 dq", "b2 dkv"):
        err = _load("flash_bwd").ff_flash_bwd_row_state_attrs(
            int(kernel == "b2 dkv"), hd, block, out)
    else:
        raise ValueError(f"probe_attrs: no race kernel {kernel!r}")
    _raise_on(err, "probe_attrs")
    return tuple(out)


def _probe_fwd(wrapper, variant: int, q, k, v, causal, block):
    what = wrapper.__name__
    _gate(what, block, q, k, v)
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal)
    (q, k, v), code = _cuda_args(what, q, k, v)
    t, hd = q.shape[-2:]
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib, entry = probe_entry(variant, q.dtype)
    err = getattr(_load(lib), entry)(
        variant, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q.numel() // (t * hd), t, hd, int(bool(causal)),
        1.0 / math.sqrt(hd), code, block, stream,
    )
    _raise_on(err, what)
    wrapper.launches += 1
    return o


def flash_fwd_row_state(q, k, v, causal: bool = True, block: int = 64):
    """``o`` of softmax attention by the online softmax, with the row
    state ``(m, l)`` whole in every thread that holds part of a row and
    the correction applied once per key tile of ``block`` keys.  The port
    of ``tools/probe_flash_variants.py::_v2_kernel``; source
    ``csrc/flash_fwd.cu`` in bf16 (K1f's kernel, :func:`probe_entry`),
    ``csrc/flash_probe.cu`` in f32."""
    return _probe_fwd(flash_fwd_row_state, 0, q, k, v, causal, block)


def flash_fwd_two_pass(q, k, v, causal: bool = True, block: int = 64):
    """``o`` by two passes over key tiles of ``block`` keys: the row max,
    then ``exp(s - m)``, its sum and ``P.V`` with no corrections; the
    scores are recomputed in the second pass.  The causal loops stop at
    the diagonal.  The port of ``_v3_kernel``; source
    ``csrc/flash_probe.cu`` (bf16 on ``wgmma``, :func:`probe_entry`)."""
    return _probe_fwd(flash_fwd_two_pass, 1, q, k, v, causal, block)


def flash_fwd_full_row(q, k, v, causal: bool = True, block: int = 64):
    """``o`` by one softmax over each whole masked row: the two passes of
    :func:`flash_fwd_two_pass` over every key tile, keys above the
    diagonal included.  The port of ``_v4_kernel``; source
    ``csrc/flash_probe.cu`` (bf16 on ``wgmma``, :func:`probe_entry`)."""
    return _probe_fwd(flash_fwd_full_row, 2, q, k, v, causal, block)


flash_fwd_row_state.launches = 0
flash_fwd_two_pass.launches = 0
flash_fwd_full_row.launches = 0


# ---------------------------------------------------------------------------
# P2: the row-state backward b2
# ---------------------------------------------------------------------------


#: Plain version of :func:`flash_bwd_row_state`: K1b's backward from the
#: caller's ``delta``.
flash_bwd_row_state_plain = kernels.flash_attention_bwd_delta_plain


def flash_bwd_row_state(q, k, v, do, lse, delta, causal: bool = True,
                        block: int = 64):
    """``(dq, dk, dv)`` of softmax attention from ``do``, ``lse`` and
    ``delta = rowsum(o * do) - g_lse`` (both ``(..., t)`` f32, from the
    caller), by a dq pass over key tiles and a dk/dv pass over query tiles
    of ``block`` rows, each thread holding the ``lse`` and ``delta`` of
    its rows in registers; no atomics.  The port of
    ``tools/probe_flash_bwd_variants.py::_bwd_call_lanes``
    (``_dq_kernel_lanes``, ``_dkv_kernel_lanes``); source
    ``csrc/flash_bwd.cu`` in bf16 (K1b's pair, :func:`bwd_probe_entry`),
    ``csrc/flash_probe_bwd.cu`` in f32.  The kernels read ``lse`` and
    ``delta`` by TMA boxes, so they are handed over as f32 buffers whose
    base is 16-byte aligned (copied when it is not)."""
    what = "flash_bwd_row_state"
    _gate(what, block, q, k, v, do)
    for name, r in (("lse", lse), ("delta", delta)):
        if r.shape != q.shape[:-1]:
            raise ValueError(f"{what}: {name} must be {tuple(q.shape[:-1])}, "
                             f"got {tuple(r.shape)}")
    if q.device.type == "cpu":
        return flash_bwd_row_state_plain(q, k, v, do, lse, delta, causal)
    (q, k, v, do), code = _cuda_args(what, q, k, v, do.to(q.dtype))
    for r in (lse, delta):
        if r.device != q.device:
            raise ValueError(f"{what}: lse and delta must be on {q.device}")
    lse, delta = _dense(lse.float()), _dense(delta.float())
    t, hd = q.shape[-2:]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib, entry = bwd_probe_entry(q.dtype)
    err = getattr(_load(lib), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), q.numel() // (t * hd), t, hd, int(bool(causal)),
        1.0 / math.sqrt(hd), code, block, stream,
    )
    _raise_on(err, what)
    flash_bwd_row_state.launches += 1
    return dq, dk, dv


flash_bwd_row_state.launches = 0

#: The race's kernel wrappers.
PROBE_KERNELS = (flash_fwd_row_state, flash_fwd_two_pass, flash_fwd_full_row,
                 flash_bwd_row_state)
#: Every kernel wrapper of the port: :data:`kernels.KERNELS` and the
#: race's, for callers that reset and read all the counters.
KERNELS = kernels.KERNELS + PROBE_KERNELS
