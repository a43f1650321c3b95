"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

The counterpart of ``flexflow_tpu/ops/pallas_kernels.py``.  Each kernel
is CUDA C++ under ``flexflow_torch/csrc/`` compiled for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, from the sources in the checkout only, into
``flexflow_torch/_build/``, and each library is keyed by a hash of its
sources and flags, so an edited source rebuilds.

Every wrapper follows one rule: a tensor on the CPU goes to the plain
PyTorch version beside the kernel (the CPU tests run it); a tensor on
CUDA launches the kernel or raises for what the kernel does not take.
There is no fallback from the kernel to the plain version.  (The
serving dry run traces on ``meta`` tensors under :func:`shapes_only`,
where K1f and K6 check their gates and return empty outputs.)  Each
wrapper counts its launches in a plain integer attribute
(``flash_attention_lse.launches``), so a run can show that its main
path went through the kernel.

Dense attention reaches the flash kernels through the dispatcher
:func:`flash_attention_lse_auto` at the end of this module, which also
holds the plain-torch formulations JAX keeps in jnp around its kernels
(``merge_lse``, the chunked and blocked forms).

The differentiable kernels (flash attention, the fused cross-entropy)
are ``torch.autograd.Function``s on every device: on the CPU their
forward and backward run the plain versions explicitly, so the CPU
tests exercise the very backward formulas the CUDA kernels implement,
not torch's autograd through the plain forward.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch

_NEG_INF = -1e30

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: One shared library per kernel source.
_SOURCES = ("flash_fwd", "flash_bwd", "flash_stream", "flash_decode",
            "softmax_xent", "embedding_rows", "flash_probe", "flash_probe_bwd")
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "the port's CUDA kernels need nvcc (CUDA_HOME/bin or PATH) to "
            "build flexflow_torch/csrc; none was found"
        )
    return found


def _lib_path(name: str) -> str:
    """The library file for csrc/<name>.cu, named by a hash of the
    source, the shared headers and the compiler flags."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_SRC_DIR) if f.endswith(".cuh"))
    for f in [f"{name}.cu"] + headers:
        with open(os.path.join(_SRC_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(_BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Tuple[str, ...] = _SOURCES) -> Dict[str, float]:
    """Build the named kernel libraries that are not built yet, one
    ``nvcc`` per source, all started together; load every one.  Returns
    {name: seconds spent building} for the ones it built."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    todo = [n for n in names
            if n not in _libs and not os.path.isfile(_lib_path(n))]
    nvcc = _nvcc() if todo else None
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        path = _lib_path(name)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp,
               os.path.join(_SRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, path)
    built = {}
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        built[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in names:
        _load(name)
    return built


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not os.path.isfile(path):
        build((name,))
        return _libs[name]
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_fwd":
        lib.ff_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
        lib.ff_flash_fwd.restype = i
        lib.ff_flash_fwd_attrs.argtypes = [i, p]
        lib.ff_flash_fwd_attrs.restype = i
        lib.ff_flash_fwd_row_state.argtypes = [i] + [p] * 4 + [i, i, i, i, f,
                                                               i, i, p]
        lib.ff_flash_fwd_row_state.restype = i
        lib.ff_flash_fwd_row_state_attrs.argtypes = [i, i, p]
        lib.ff_flash_fwd_row_state_attrs.restype = i
    elif name == "flash_bwd":
        lib.ff_flash_bwd.argtypes = [p] * 11 + [i, i, i, i, f, i, p]
        lib.ff_flash_bwd.restype = i
        lib.ff_flash_bwd_attrs.argtypes = [i, i, p]
        lib.ff_flash_bwd_attrs.restype = i
        lib.ff_flash_bwd_row_state.argtypes = [p] * 9 + [i, i, i, i, f, i, i,
                                                         p]
        lib.ff_flash_bwd_row_state.restype = i
        lib.ff_flash_bwd_row_state_attrs.argtypes = [i, i, i, p]
        lib.ff_flash_bwd_row_state_attrs.restype = i
    elif name == "flash_stream":
        lib.ff_flash_stream_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
        lib.ff_flash_stream_fwd.restype = i
        lib.ff_flash_stream_bwd.argtypes = [p] * 11 + [i, i, i, i, f, i, p]
        lib.ff_flash_stream_bwd.restype = i
        lib.ff_flash_stream_attrs.argtypes = [i, i, i, p]
        lib.ff_flash_stream_attrs.restype = i
    elif name == "flash_decode":
        lib.ff_flash_decode.argtypes = [p] * 7 + [i, i, i, i, i, f, i, p]
        lib.ff_flash_decode.restype = i
    elif name == "softmax_xent":
        lib.ff_xent_fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.ff_xent_fwd.restype = i
        lib.ff_xent_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.ff_xent_bwd.restype = i
    elif name == "embedding_rows":
        ll = ctypes.c_longlong
        lib.ff_gather_rows.argtypes = [i] + [p] * 7 + [ll] + [i] * 6 + [
            ll, i, p]
        lib.ff_gather_rows.restype = i
        lib.ff_scatter_add_rows.argtypes = [p, p, p, ll, i, i, i, i, i, i, p,
                                            ll, ll, p]
        lib.ff_scatter_add_rows.restype = i
        lib.ff_scatter_scratch_bytes.argtypes = [ll, i]
        lib.ff_scatter_scratch_bytes.restype = ll
    elif name == "flash_probe":
        for fn in (lib.ff_flash_probe_fwd, lib.ff_flash_probe_fwd_wg):
            fn.argtypes = [i] + [p] * 4 + [i, i, i, i, f, i, i, p]
            fn.restype = i
        lib.ff_flash_probe_wg_attrs.argtypes = [i, i, i, p]
        lib.ff_flash_probe_wg_attrs.restype = i
    elif name == "flash_probe_bwd":
        lib.ff_flash_probe_bwd.argtypes = [p] * 9 + [i, i, i, i, f, i, i, p]
        lib.ff_flash_probe_bwd.restype = i
    _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------


def _dense(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


#: Set by :func:`shapes_only`: the serving kernels' wrappers then take
#: ``meta`` tensors too.
_SHAPES_ONLY = False


@contextlib.contextmanager
def shapes_only():
    """The dry run's mode (``ServingExecutor.abstract_programs``): inside
    it K1f's and K6's wrappers take ``meta`` tensors, the card's stand-in,
    check them against the kernel's gate as they would CUDA ones, and
    return empty ``meta`` outputs with no launch.  Outside it a ``meta``
    tensor raises like any tensor that is not on CUDA."""
    global _SHAPES_ONLY
    before, _SHAPES_ONLY = _SHAPES_ONLY, True
    try:
        yield
    finally:
        _SHAPES_ONLY = before


def _check_cuda(what: str, *tensors: torch.Tensor, head_dim: bool = True,
                meta: bool = False) -> int:
    """The kernel's dtype code for CUDA operands of one device and
    dtype; raises for anything else (and, with ``head_dim``, for a last
    dim the attention kernels do not take).  ``meta``: the wrapper also
    takes ``meta`` tensors under :func:`shapes_only`."""
    dev = tensors[0].device
    if dev.type != "cuda" and not (meta and _SHAPES_ONLY
                                   and dev.type == "meta"):
        raise ValueError(f"{what}: tensors on {dev} (the kernel needs CUDA; "
                         f"CPU tensors take the plain version)")
    dt = tensors[0].dtype
    for x in tensors:
        if x.device != dev or x.dtype != dt:
            raise ValueError(
                f"{what}: every operand must share device and dtype, got "
                f"{[(y.device, y.dtype) for y in tensors]}"
            )
    if dt not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: dtype {dt} is not instantiated "
                         f"(float32, bfloat16)")
    hd = tensors[0].shape[-1]
    if head_dim and (hd % 8 or not 8 <= hd <= 128):
        raise ValueError(f"{what}: head dim {hd} must be a multiple of 8 in "
                         f"[8, 128]")
    return _KERNEL_DTYPES[dt]


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


# ---------------------------------------------------------------------------
# K1f: flash-attention forward
# ---------------------------------------------------------------------------


def flash_attention_lse_plain(q, k, v, causal: bool = True):
    """Plain version of :func:`flash_attention_lse`: the same cast points
    (f32 scores, the scale after the dot, p rounded to v's dtype before
    P.V, l summed from the f32 p) and the finite ``-1e30`` mask."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t = s.shape[-1]
        mask = torch.ones((t, t), dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(dtype), (m + torch.log(l))[..., 0]


def _flash_shapes(what, q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one (b, h, t, hd) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def fwd_entry(streamed: bool, dtype) -> Tuple[str, str]:
    """The library and C entry a flash forward launches: K1f's
    (``csrc/flash_fwd.cu``: the wgmma kernel in bf16, the FMA kernel in
    f32) for K1f, and for K1s in bf16, where the streamed form's
    sequential grid axis is exactly the loop inside each of the wgmma
    kernel's CTAs over TMA-fed K/V tiles; ``csrc/flash_stream.cu``'s FMA
    kernel for K1s in f32 (wgmma takes f32 only as TF32).  The two
    entries share one C signature."""
    if streamed and dtype != torch.bfloat16:
        return "flash_stream", "ff_flash_stream_fwd"
    return "flash_fwd", "ff_flash_fwd"


def _launch_fwd(what, streamed, q, k, v, causal):
    """Checks the forward's dense CUDA operands and launches K1f's kernel
    or (``streamed``) K1s's, through :func:`fwd_entry`.  Returns ``(o,
    lse)``."""
    code = _check_cuda(what, q, k, v, head_dim=not streamed,
                       meta=not streamed)
    if streamed:
        _stream_check(what, q)
    b, h, t, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib, entry = fwd_entry(streamed, q.dtype)
    err = getattr(_load(lib), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, t, hd, int(bool(causal)),
        1.0 / math.sqrt(hd), code, stream,
    )
    _raise_on(err, what)
    return o, lse


def _flash_fwd(q, k, v, causal: bool):
    """K1f on already dense operands: the plain version on the CPU, the
    kernel on CUDA (counted in ``flash_attention_lse.launches``)."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal)
    o, lse = _launch_fwd("flash_attention_lse", False, q, k, v, causal)
    if q.device.type != "meta":
        flash_attention_lse.launches += 1
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """K1f forward and K1b backward, or with ``streamed`` K1s and K1sb;
    both outputs are differentiable (the lse cotangent enters the
    backward as ``delta -= g_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, streamed):
        if q.device.type != "cpu":
            q, k, v = _dense(q), _dense(k), _dense(v)
        o, lse = (_stream_fwd if streamed else _flash_fwd)(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.streamed = streamed
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        bwd = (flash_attention_lse_streamed_bwd if ctx.streamed
               else flash_attention_lse_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, g_o, g_lse, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal: bool = True):
    """Blocked flash attention over ``(b, h, t, hd)`` heads.

    Returns ``(o, lse)``: ``o`` in the input dtype and ``lse`` as
    ``(b, h, t)`` f32, both differentiable.  The port of
    ``pallas_kernels.flash_attention_lse`` (forward kernel
    ``_fwd_kernel``, source ``csrc/flash_fwd.cu``; backward
    :func:`flash_attention_lse_bwd`).  Every ``t >= 1`` is supported:
    ragged tiles are masked in the kernels.
    """
    _flash_shapes("flash_attention_lse", q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal), False)


flash_attention_lse.launches = 0


# ---------------------------------------------------------------------------
# K1b: flash-attention backward
# ---------------------------------------------------------------------------


def flash_attention_lse_bwd_plain(q, k, v, o, lse, do, g_lse=None,
                                  causal: bool = True):
    """Plain version of :func:`flash_attention_lse_bwd`, with the
    kernels' cast points: ``delta = rowsum(o * do) - g_lse`` in f32,
    ``do`` in the input dtype, ``p = exp(s - lse)`` recomputed from f32
    scores (scale after the dot, the finite ``-1e30`` mask), ``p`` and
    ``ds = p * (dp - delta)`` rounded to the operand dtype before their
    products, f32 sums written in the input dtype."""
    delta = (o.float() * do.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return flash_attention_bwd_delta_plain(q, k, v, do, lse, delta, causal)


def flash_attention_bwd_delta_plain(q, k, v, do, lse, delta,
                                    causal: bool = True):
    """The flash backward from the caller's f32 ``delta`` (``rowsum(o *
    do) - g_lse``), with :func:`flash_attention_lse_bwd_plain`'s cast
    points; that function computes ``delta`` and calls this one."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t = s.shape[-1]
        mask = torch.ones((t, t), dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do.float())
    ds = ds.to(dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse=None,
                            causal: bool = True):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_lse` from
    the cotangents ``do`` of ``o`` and ``g_lse`` of ``lse`` (None is
    zero).  The port of ``pallas_kernels._bwd_call`` (kernels
    ``_dq_kernel`` and ``_dkv_kernel``, with the delta preprocess of
    ``_cotangent_delta_lanes``); source ``csrc/flash_bwd.cu``.  Takes
    every shape the forward takes."""
    if q.device.type == "cpu":
        return flash_attention_lse_bwd_plain(q, k, v, o, lse, do, g_lse,
                                             causal)
    dq, dk, dv = _launch_bwd("flash_attention_lse_bwd", False, q, k, v, o,
                             lse, do, g_lse, causal)
    flash_attention_lse_bwd.launches += 1
    return dq, dk, dv


def bwd_entry(streamed: bool, dtype) -> Tuple[str, str]:
    """The library and C entry a flash backward launches: K1b's
    (``csrc/flash_bwd.cu``: the wgmma pair in bf16, the FMA kernels in
    f32) for K1b, and for K1sb in bf16, where the streamed form's
    sequential grid axis is exactly the loop inside each of the pair's
    CTAs; ``csrc/flash_stream.cu``'s FMA passes for K1sb in f32 (wgmma
    takes f32 only as TF32).  The two entries share one C signature."""
    if streamed and dtype != torch.bfloat16:
        return "flash_stream", "ff_flash_stream_bwd"
    return "flash_bwd", "ff_flash_bwd"


def _launch_bwd(what, streamed, q, k, v, o, lse, do, g_lse, causal,
                delta=None):
    """Checks the backward's CUDA operands and launches the two-pass
    backward, K1b's or (``streamed``) K1sb's, through :func:`bwd_entry`.
    ``delta``: the ``(b, h, t)`` f32 buffer the dq pass writes ``rowsum(o
    do) - g_lse`` into for the dk/dv pass (a new one when None).  Returns
    ``(dq, dk, dv)``."""
    _flash_shapes(what, q, k, v)
    do = do.to(q.dtype)
    code = _check_cuda(what, q, k, v, o, do, head_dim=not streamed)
    if streamed:
        _stream_check(what, q, backward=True)
    b, h, t, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{what}: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be {tuple(q.shape)}")
    rows = [lse] if g_lse is None else [lse, g_lse]
    for r in rows:
        if r.shape != (b, h, t) or r.device != q.device:
            raise ValueError(f"{what}: lse/g_lse must be ({b}, {h}, {t}) on "
                             f"{q.device}, got {tuple(r.shape)} on {r.device}")
    q, k, v, o, do = (_dense(x) for x in (q, k, v, o, do))
    lse = lse.float().contiguous()
    g_lse = None if g_lse is None else g_lse.float().contiguous()
    if delta is None:
        delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    elif (delta.shape != (b, h, t) or delta.dtype != torch.float32
          or delta.device != q.device or not delta.is_contiguous()
          or delta.data_ptr() % 16):
        raise ValueError(f"{what}: delta must be a 16-byte aligned, "
                         f"contiguous ({b}, {h}, {t}) f32 buffer on "
                         f"{q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib, entry = bwd_entry(streamed, q.dtype)
    launch = getattr(_load(lib), entry)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, hd,
        int(bool(causal)), 1.0 / math.sqrt(hd), code, stream,
    )
    _raise_on(err, what)
    return dq, dk, dv


flash_attention_lse_bwd.launches = 0


def flash_attrs(hd: int) -> Dict[str, Tuple[int, int, int]]:
    """Registers per thread, spilled bytes per thread and dynamic shared
    bytes of the bf16 K1f/K1b kernels (``fwd``, ``dq``, ``dkv``) at head
    dim ``hd``'s tile width, as the loaded libraries report them (CUDA
    only; the f32 instantiations are the FMA kernels)."""
    out = {}
    for name, call in (
            ("fwd", lambda v: _load("flash_fwd").ff_flash_fwd_attrs(hd, v)),
            ("dq", lambda v: _load("flash_bwd").ff_flash_bwd_attrs(0, hd, v)),
            ("dkv", lambda v: _load("flash_bwd").ff_flash_bwd_attrs(1, hd, v))):
        vals = (ctypes.c_int * 3)()
        _raise_on(call(vals), "flash_attrs")
        out[name] = tuple(vals)
    return out


# ---------------------------------------------------------------------------
# K1s / K1sb: streamed flash-attention forward and backward
# ---------------------------------------------------------------------------

#: Head dims ``csrc/flash_stream.cu`` is instantiated for.
_STREAM_HEAD_DIMS = (32, 64, 128)


def flash_stream_supported(shape, dtype=torch.float32) -> bool:
    """Whether the streamed kernels (K1s, K1sb) take ``(b, h, t, hd)``
    attention of ``dtype``: f32 or bf16, ``hd`` in {32, 64, 128}, any
    ``t >= 1`` (ragged tiles are masked), ``b * h <= 65535`` (one grid
    row per head).  Hopper's gate in place of the TPU's
    ``_stream_blocks`` / ``_stream_default_block``, which fit blocks to
    VMEM.  The bf16 K1sb is K1b's wgmma pair (:func:`bwd_entry`), which
    also refuses what :func:`_k1b_limit` names."""
    if len(shape) != 4:
        return False
    b, h, t, hd = shape
    return (dtype in _KERNEL_DTYPES and t >= 1 and hd in _STREAM_HEAD_DIMS
            and 1 <= b * h <= 65535)


def _stream_check(what, q, backward: bool = False):
    """Raises unless the streamed kernels take ``q``'s shape and dtype:
    their gate, and in bf16, where both launch K1f/K1b's wgmma kernels
    (:func:`fwd_entry`, :func:`bwd_entry`), those kernels' launch
    limits."""
    if not flash_stream_supported(tuple(q.shape), q.dtype):
        raise ValueError(f"{what}: shape {tuple(q.shape)} {q.dtype} is "
                         f"outside the streamed kernels' gate (head dim in "
                         f"{_STREAM_HEAD_DIMS}, b * h <= 65535)")
    lib, _ = (bwd_entry if backward else fwd_entry)(True, q.dtype)
    if lib != "flash_stream":
        limit = _k1b_limit(tuple(q.shape), q.dtype)
        if limit is not None:
            which = "K1b's wgmma pair" if backward else "K1f's wgmma kernel"
            raise ValueError(f"{what}: shape {tuple(q.shape)} {q.dtype} is "
                             f"outside {which}, which the bf16 streamed "
                             f"{'backward' if backward else 'forward'} "
                             f"launches: {limit}")


def _stream_fwd(q, k, v, causal: bool):
    """K1s on already dense operands: the plain version on the CPU, the
    kernel of :func:`fwd_entry` on CUDA (counted in
    ``flash_attention_lse_streamed.launches``, never in K1f's count)."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal)
    o, lse = _launch_fwd("flash_attention_lse_streamed", True, q, k, v,
                         causal)
    flash_attention_lse_streamed.launches += 1
    return o, lse


def flash_attention_lse_streamed(q, k, v, causal: bool = True):
    """Streamed flash attention over ``(b, h, t, hd)`` heads: the same
    ``(o, lse)`` as :func:`flash_attention_lse`, both differentiable.
    The port of ``pallas_kernels.flash_attention_lse_streamed`` (forward
    kernel ``_fwd_stream_kernel``; backward
    :func:`flash_attention_lse_streamed_bwd`).  In bf16 the forward
    launches K1f's wgmma kernel of ``csrc/flash_fwd.cu``, whose producer
    warpgroup streams K/V tiles by TMA through an mbarrier ring, the loop
    that replaces the TPU grid's sequential key axis: the same bits as
    :func:`flash_attention_lse`.  In f32 it launches the FMA kernel of
    ``csrc/flash_stream.cu`` (:func:`fwd_entry`).  The TPU signature's
    ``block_q``/``block_k`` (VMEM tiling) are dropped.  Its plain version
    is :func:`flash_attention_lse_plain`: the function and the cast
    points are K1f's.  Takes the shapes :func:`flash_stream_supported`
    admits, and in bf16 refuses what :func:`_k1b_limit` names."""
    _flash_shapes("flash_attention_lse_streamed", q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal), True)


flash_attention_lse_streamed.launches = 0


def flash_attention_lse_streamed_bwd(q, k, v, o, lse, do, g_lse=None,
                                     causal: bool = True):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_lse_streamed`
    from the cotangents ``do`` and ``g_lse`` (None is zero).  The port of
    ``pallas_kernels._bwd_stream_call`` (kernels ``_dq_stream_kernel`` and
    ``_dkv_stream_kernel``, with the delta of ``_cotangent_delta_lanes``
    computed in the dq pass), no atomics.  In bf16 it launches K1b's wgmma
    pair of ``csrc/flash_bwd.cu``, whose per-CTA loop over TMA-fed tiles is
    the TPU grid's sequential axis; in f32 the FMA passes of
    ``csrc/flash_stream.cu`` (:func:`bwd_entry`).  Its plain version is
    :func:`flash_attention_lse_bwd_plain`, K1b's: the function and the
    cast points are the same."""
    if q.device.type == "cpu":
        return flash_attention_lse_bwd_plain(q, k, v, o, lse, do, g_lse,
                                             causal)
    dq, dk, dv = _launch_bwd("flash_attention_lse_streamed_bwd", True, q, k,
                             v, o, lse, do, g_lse, causal)
    flash_attention_lse_streamed_bwd.launches += 1
    return dq, dk, dv


flash_attention_lse_streamed_bwd.launches = 0


def flash_stream_attrs(hd: int, dtype) -> Dict[str, Tuple[int, int, int]]:
    """Registers per thread, spilled bytes per thread and dynamic shared
    bytes of the three streamed kernels (``fwd``, ``dq``, ``dkv``) at head
    dim ``hd``, as the loaded libraries report them (CUDA only); in bf16
    they are K1f's wgmma kernel and K1b's wgmma pair (:func:`flash_attrs`),
    in f32 ``csrc/flash_stream.cu``'s FMA kernels."""
    if dtype == torch.bfloat16:
        return flash_attrs(hd)
    out = {}
    for which, name in enumerate(("fwd", "dq", "dkv")):
        vals = (ctypes.c_int * 3)()
        _raise_on(_load("flash_stream").ff_flash_stream_attrs(
            which, hd, _KERNEL_DTYPES[dtype], vals), "flash_stream_attrs")
        out[name] = tuple(vals)
    return out


# ---------------------------------------------------------------------------
# K6: flash decode
# ---------------------------------------------------------------------------


def flash_decode_plain(q, cache_k, cache_v, lengths):
    """Plain version of :func:`flash_decode`: f32 scores masked to key
    positions ``< lengths[b]`` with the finite ``-1e30``, p rounded to
    the cache dtype before P.V, the output in ``q``'s dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,bshd->bhs", q.float(), cache_k.float()) * scale
    pos = torch.arange(cache_k.shape[1], device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]        # (B, S)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhs,bshd->bhd", p.to(cache_v.dtype).float(),
                     cache_v.float())
    return (o / l).to(q.dtype)


#: K6's split policy: enough CTAs for four per SM of an H100 (132 SMs),
#: at least this many keys per split, at most this many splits (the last
#: CTA of each (b, head) walks them in order).
_DECODE_CTAS = 4 * 132
_DECODE_MIN_KEYS = 32
_DECODE_MAX_SPLITS = 128


def decode_splits(B: int, S: int, h: int) -> int:
    """How many key chunks K6 cuts a ``(B, S, h, hd)`` cache into: the
    fewest that give ``B h`` x splits at least ``_DECODE_CTAS`` CTAs, but
    chunks of at least ``_DECODE_MIN_KEYS`` keys and at most
    ``_DECODE_MAX_SPLITS`` splits; then as few as keep the chunk length,
    ``ceil(S / splits)``, so every chunk starts before ``S``.  From the
    shape alone: ``lengths`` live on the device, and reading them would
    cost every decode step a host sync."""
    want = -(-_DECODE_CTAS // (B * h))
    n = max(1, min(want, S // _DECODE_MIN_KEYS, _DECODE_MAX_SPLITS))
    chunk = -(-S // n)
    return -(-S // chunk)


def flash_decode_split_plain(q, cache_k, cache_v, lengths, splits: int):
    """K6's split-K formulation in plain torch, for the tests and
    ``chip_smoke.py``: the keys cut into ``splits`` chunks of ``ceil(S /
    splits)``; per chunk ``m`` (the finite ``-1e30`` when no key of it is
    valid), ``p = exp(s - m)`` (0 at masked keys), ``l = sum p`` and
    ``acc = sum round(p) v`` in f32; then the chunks merged in order with
    the weights ``exp(m_i - max m)`` of :func:`merge_lse` (an empty
    chunk's is 0), ``o = sum w acc / sum w l`` in ``q``'s dtype."""
    B, S, h, hd = cache_k.shape
    scale = 1.0 / math.sqrt(hd)
    chunk = -(-S // splits)
    s = torch.einsum("bhd,bshd->bhs", q.float(), cache_k.float()) * scale
    pos = torch.arange(S, device=q.device)
    valid = (pos[None, :] < lengths.to(q.device)[:, None])[:, None, :]
    ms, ls, accs = [], [], []
    for i in range(splits):
        sl = slice(min(S, i * chunk), min(S, (i + 1) * chunk))
        vi = valid[..., sl]
        si = torch.where(vi, s[..., sl], torch.full_like(s[..., sl], _NEG_INF))
        m = torch.full((B, h, 1), _NEG_INF, device=q.device)
        if si.shape[-1]:
            m = torch.maximum(m, si.amax(dim=-1, keepdim=True))
        p = torch.where(vi, torch.exp(si - m), torch.zeros_like(si))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhs,bshd->bhd", p.to(cache_v.dtype).float(),
                                 cache_v[:, sl].float()))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(dim=0))
    o = (w * torch.stack(accs)).sum(dim=0) / (w * torch.stack(ls)).sum(dim=0)
    return o.to(q.dtype)


#: One zeroed ticket buffer per device for K6's merge, which every launch
#: leaves zeroed; it grows with the largest ``B h`` seen.
_decode_tickets: Dict[torch.device, torch.Tensor] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    buf = _decode_tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _decode_tickets[device] = buf
    return buf


def flash_decode_supported(cache_shape, dtype=torch.float32) -> bool:
    """K6's gate, the counterpart of ``pallas_kernels.
    flash_decode_supported``: a 4-d ``(B, S, h, hd)`` cache in f32 or
    bf16 whose head dim is a multiple of 8 in [8, 128] (the kernel's
    16-byte vectors and its head-dim instantiations).  Callers route
    around it as JAX routes around its own: ``MultiHeadAttention.
    _decode_attend`` takes the einsum where it does not hold.  JAX's
    gate differs by design: it takes any ``hd >= 8`` (hd 12 or 256 run
    its kernel and the port's einsum) and asks for ``S >= 8``, which
    the port's kernel does not need."""
    if len(cache_shape) != 4:
        return False
    hd = cache_shape[-1]
    return dtype in _KERNEL_DTYPES and hd % 8 == 0 and 8 <= hd <= 128


def flash_decode(q, cache_k, cache_v, lengths):
    """Single-token decode attention against a padded KV cache.

    ``q``: ``(B, h, hd)``; ``cache_k``/``cache_v``: ``(B, S, h, hd)``;
    ``lengths``: ``(B,)`` int32 in ``[1, S]``, the valid keys per slot.
    Returns ``(B, h, hd)`` in ``q``'s dtype.  The port of
    ``pallas_kernels.flash_decode`` (kernel ``_decode_kernel``); source
    ``csrc/flash_decode.cu``: split-K over :func:`decode_splits` chunks of
    the keys in one launch, the chunks merged in order by the last CTA of
    each (b, head), no float atomic (two calls give the same bits).  The
    kernel reads only the first ``lengths[b]`` cache rows of each slot.
    Capturable in a CUDA graph: no host sync; the partials come from
    torch's caching allocator and the tickets from one zeroed buffer per
    device (made at the first call).
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, cache_k, cache_v, lengths)
    code = _check_cuda("flash_decode", q, cache_k, cache_v, meta=True)
    B, S, h, hd = cache_k.shape
    if q.shape != (B, h, hd) or cache_v.shape != cache_k.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} and caches "
                         f"{tuple(cache_k.shape)}/{tuple(cache_v.shape)} "
                         f"disagree")
    if lengths.device != q.device or lengths.dtype != torch.int32 or \
            lengths.shape != (B,):
        raise ValueError(f"flash_decode: lengths must be ({B},) int32 on "
                         f"{q.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if q.device.type == "meta":
        return torch.empty_like(q)
    q, cache_k, cache_v = _dense(q), _dense(cache_k), _dense(cache_v)
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    splits = decode_splits(B, S, h)
    part = tickets = None
    if splits > 1:
        part = torch.empty((B * h * splits * (hd + 2),), dtype=torch.float32,
                           device=q.device)
        tickets = _tickets(q.device, B * h)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _load("flash_decode").ff_flash_decode(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), B, S, h, hd, splits,
        1.0 / math.sqrt(hd), code, stream,
    )
    _raise_on(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


# ---------------------------------------------------------------------------
# K3: fused softmax cross-entropy
# ---------------------------------------------------------------------------


def softmax_xent_plain(logits, labels):
    """Plain version of :func:`softmax_xent`: f32 ``lse``, ``nll = lse -
    x[label]`` and ``pred`` the first index of the row maximum."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    target = x.gather(-1, labels.long()[:, None])[:, 0]
    return lse - target, lse, torch.argmax(x, dim=-1).to(torch.int32)


def softmax_xent_bwd_plain(logits, labels, lse, g_nll=None, g_lse=None):
    """Plain version of :func:`softmax_xent_bwd`: ``exp(x - lse) *
    (g_nll + g_lse) - onehot * g_nll`` in f32, rounded once to the
    logits' dtype."""
    n = logits.shape[0]
    zeros = torch.zeros((n,), dtype=torch.float32, device=logits.device)
    gn = zeros if g_nll is None else g_nll.float()
    gl = zeros if g_lse is None else g_lse.float()
    d = torch.exp(logits.float() - lse[:, None]) * (gn + gl)[:, None]
    d[torch.arange(n, device=logits.device), labels.long()] -= gn
    return d.to(logits.dtype)


def _xent_check(what, logits, labels):
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{what}: logits must be (N, V) and labels (N,), "
                         f"got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if labels.device != logits.device or labels.dtype != torch.int32:
        raise ValueError(f"{what}: labels must be int32 on {logits.device}, "
                         f"got {labels.dtype} on {labels.device}")
    return _check_cuda(what, logits, head_dim=False)


#: K3's threads per CTA, in both forms.
_XENT_THREADS = 256
#: K3 takes the row-group form up to this many classes and a CTA per row
#: above: where the two forms' forward and backward chain slopes, summed,
#: cross at N = 2048 bf16 (``tools/kernel_race.py``'s sweep, PERF.md §6).
_XENT_ROWS_MAX_V = 8192


class XentForm(NamedTuple):
    """How K3 covers a row of V classes (``csrc/softmax_xent.cu``)."""

    form: str            # "rows": row groups; "cta": a CTA per row
    rows_per_cta: int
    lanes_per_row: int   # threads that share a row
    loads: str           # "16-byte" (V % 8 == 0) or "scalar"


def _xent_form(v: int, force: Optional[str] = None) -> XentForm:
    """K3's form for rows of ``v`` classes: row groups (8 lanes a row up
    to 64 classes, 16 up to 128, else a warp) up to
    ``_XENT_ROWS_MAX_V`` classes, a 256-thread CTA per row above; or the
    form ``force`` names ("rows", "cta"), which takes every shape."""
    form = force or ("rows" if v <= _XENT_ROWS_MAX_V else "cta")
    loads = "16-byte" if v % 8 == 0 else "scalar"
    if form == "cta":
        return XentForm("cta", 1, _XENT_THREADS, loads)
    if form != "rows":
        raise ValueError(f"softmax_xent: form {form!r} is not 'rows' or "
                         f"'cta'")
    lanes = 8 if v <= 64 else 16 if v <= 128 else 32
    return XentForm("rows", _XENT_THREADS // lanes, lanes, loads)


def _xent_lanes(form: XentForm) -> int:
    """The C entries' ``lanes``: 0 for a CTA per row."""
    return 0 if form.form == "cta" else form.lanes_per_row


def _xent_fwd(logits, labels, form: Optional[str] = None):
    """K3 forward on already dense operands: the plain version on the
    CPU, the kernel on CUDA (counted in ``softmax_xent.launches``) in the
    form :func:`_xent_form` picks, or in ``form`` ("rows", "cta")."""
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels)
    code = _xent_check("softmax_xent", logits, labels)
    n, v = logits.shape
    lanes = _xent_lanes(_xent_form(v, form))
    nll = torch.empty((n,), dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    pred = torch.empty((n,), dtype=torch.int32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = _load("softmax_xent").ff_xent_fwd(
        logits.data_ptr(), labels.data_ptr(), nll.data_ptr(), lse.data_ptr(),
        pred.data_ptr(), n, v, code, lanes, stream,
    )
    _raise_on(err, "softmax_xent")
    softmax_xent.launches += 1
    return nll, lse, pred


def softmax_xent_bwd(logits, labels, lse, g_nll=None, g_lse=None):
    """``dlogits`` of :func:`softmax_xent` from the cotangents of
    ``nll`` and ``lse`` (None is zero; ``pred`` has none), in the
    logits' dtype.  The port of ``pallas_kernels._xent_bwd_kernel``;
    source ``csrc/softmax_xent.cu``."""
    return _xent_bwd(logits, labels, lse, g_nll, g_lse)


def _xent_bwd(logits, labels, lse, g_nll=None, g_lse=None,
              form: Optional[str] = None):
    """:func:`softmax_xent_bwd` in the form :func:`_xent_form` picks, or
    in ``form`` ("rows", "cta"); counted in
    ``softmax_xent_bwd.launches``."""
    if logits.device.type == "cpu":
        return softmax_xent_bwd_plain(logits, labels, lse, g_nll, g_lse)
    code = _xent_check("softmax_xent_bwd", logits, labels)
    n, v = logits.shape
    lanes = _xent_lanes(_xent_form(v, form))
    logits, labels = _dense(logits), labels.contiguous()
    lse = lse.float().contiguous()
    g_nll = None if g_nll is None else g_nll.float().contiguous()
    g_lse = None if g_lse is None else g_lse.float().contiguous()
    dlogits = torch.empty_like(logits)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = _load("softmax_xent").ff_xent_bwd(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        None if g_nll is None else g_nll.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(), dlogits.data_ptr(), n, v,
        code, lanes, stream,
    )
    _raise_on(err, "softmax_xent_bwd")
    softmax_xent_bwd.launches += 1
    return dlogits


softmax_xent_bwd.launches = 0


class _SoftmaxXent(torch.autograd.Function):
    """K3 forward and backward; ``pred`` is integer and gets no
    cotangent."""

    @staticmethod
    def forward(ctx, logits, labels):
        if logits.device.type != "cpu":
            logits, labels = _dense(logits), labels.contiguous()
        nll, lse, pred = _xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.mark_non_differentiable(pred)
        ctx.set_materialize_grads(False)
        return nll, lse, pred

    @staticmethod
    def backward(ctx, g_nll, g_lse, _g_pred):
        logits, labels, lse = ctx.saved_tensors
        return softmax_xent_bwd(logits, labels, lse, g_nll, g_lse), None


def softmax_xent(logits, labels):
    """Fused cross-entropy over ``(N, V)`` logits (f32 or bf16) with
    int32 ``(N,)`` labels in ``[0, V)``: returns per-row ``(nll, lse,
    pred)`` (f32, f32, int32) without materialising the softmax; ``nll``
    and ``lse`` are differentiable.  The port of
    ``pallas_kernels.softmax_xent`` (kernels ``_xent_fwd_kernel`` and
    ``_xent_bwd_kernel``); source ``csrc/softmax_xent.cu``.  Every
    ``(N, V)`` is supported."""
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"softmax_xent: logits must be (N, V) and labels "
                         f"(N,), got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    return _SoftmaxXent.apply(logits, labels)


softmax_xent.launches = 0


# ---------------------------------------------------------------------------
# K4 / K5: embedding row gather and deterministic row scatter-add
# ---------------------------------------------------------------------------


def _row_ids_ok(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_rows)


def _window(ids: torch.Tensor, row_start: Optional[int]) -> torch.Tensor:
    """The ids as rows of a table that holds rows ``[row_start, row_start
    + R)`` (the rank's block of a row-sharded table); the ids themselves
    without a window."""
    return ids if row_start is None else ids.long() - int(row_start)


def gather_rows_plain(table, ids, row_start: Optional[int] = None):
    """Plain version of :func:`gather_rows`: ``table[ids]``, with a NaN
    row (``jnp.take``'s fill) for an id outside ``[0, R)``; with
    ``row_start``, ``table[ids - row_start]`` with a zero row for an id
    outside ``[row_start, row_start + R)`` (JAX's masked take)."""
    loc = _window(ids, row_start)
    ok = _row_ids_ok(loc, table.shape[0])
    rows = table.index_select(0, torch.where(ok, loc, 0).long())
    fill = math.nan if row_start is None else 0.0
    return torch.where(ok[:, None], rows, torch.full_like(rows, fill))


def scatter_add_rows_plain(table, ids, upd, row_start: Optional[int] = None):
    """Plain version of :func:`scatter_add_rows`, in place, with the
    kernel's exact arithmetic: the updates of each row are summed in f32
    from 0 in stable-sorted order (batch order within a row), and the sum
    is added to the table row once; updates of ids outside ``[0, R)`` are
    dropped.  Round ``k`` adds the ``k``-th update of every run at once;
    a run that has ended adds ``+0.0``, which leaves its sum unchanged
    (a sum that starts at ``+0.0`` is never ``-0.0``).  With
    ``row_start`` the table holds rows ``[row_start, row_start + R)``:
    row ``id - row_start`` takes the updates, and those of ids outside
    the window are dropped."""
    n = ids.shape[0]
    if n == 0:
        return table
    ids = _window(ids, row_start)
    sid, perm = torch.sort(ids, stable=True)
    su = upd.float().index_select(0, perm)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    starts = first.nonzero().squeeze(1)
    lens = torch.diff(starts, append=starts.new_tensor([n]))
    acc = torch.zeros((starts.shape[0], su.shape[1]), dtype=torch.float32,
                      device=su.device)
    for k in range(int(lens.max())):
        nth = su.index_select(0, (starts + k).clamp_(max=n - 1))
        acc += torch.where((lens > k)[:, None], nth, 0.0)
    rows = sid[starts]
    ok = _row_ids_ok(rows, table.shape[0])
    table[rows[ok]] += acc[ok]
    return table


def _row_check(what, table, ids, upd=None):
    """Shapes common to both row kernels, on every device."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"{what}: table must be (R, D) and ids (n,), got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: ids must be int32 or int64, got {ids.dtype}")
    if upd is not None and upd.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"{what}: updates must be ({ids.shape[0]}, "
                         f"{table.shape[1]}), got {tuple(upd.shape)}")


def _row_cuda(what, table, *others):
    """The launch geometry of a row kernel on CUDA operands: ``log2`` of
    the threads per row and whether 16-byte vectors fit; raises for what
    the kernels do not take."""
    _check_cuda(what, table, head_dim=False)
    if table.dtype != torch.float32:
        raise ValueError(f"{what}: the row kernels take f32 tables, got "
                         f"{table.dtype}")
    for x in others:
        if x.device != table.device:
            raise ValueError(f"{what}: operands on {x.device} and "
                             f"{table.device}")
    if not table.is_contiguous():
        raise ValueError(f"{what}: the table must be contiguous")
    d = table.shape[1]
    vec = d % 4 == 0 and all(x.data_ptr() % 16 == 0
                             for x in (table,) + others if x.is_floating_point())
    units = d // 4 if vec else d
    g = 1
    while g < min(units, 32):
        g *= 2
    return g.bit_length() - 1, vec


#: K4's grid: threads a CTA (the kernel's ``kThreads``), and CTAs per SM
#: at most, so that the grid is one wave.
_GATHER_THREADS = 256
_GATHER_CTAS_PER_SM = 4
#: The most tables one K4 launch gathers by the same ids.
_GATHER_MAX_TABLES = 3

_SM_COUNT: Dict[int, int] = {}


def gather_ctas(n: int, log_g: int, sms: int) -> int:
    """K4's grid for ``n`` ids, ``2**log_g`` threads each, on a card of
    ``sms`` SMs: a thread per (id, vector) up to one wave of
    ``_GATHER_CTAS_PER_SM`` CTAs per SM; threads beyond it loop."""
    return max(1, min(-(-(n << log_g) // _GATHER_THREADS),
                      sms * _GATHER_CTAS_PER_SM))


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    sms = _SM_COUNT.get(index)
    if sms is None:
        sms = _SM_COUNT[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _tables_check(what, tables):
    """The gate of a launch over several tables: 1 to 3 of them, one
    shape, dtype and device (on every device)."""
    if not 1 <= len(tables) <= _GATHER_MAX_TABLES:
        raise ValueError(f"{what}: takes 1 to {_GATHER_MAX_TABLES} tables, "
                         f"got {len(tables)}")
    t0 = tables[0]
    for t in tables[1:]:
        if t.shape != t0.shape:
            raise ValueError(f"{what}: the tables must share one (R, D), got "
                             f"{tuple(t0.shape)} and {tuple(t.shape)}")
        if t.dtype != t0.dtype:
            raise ValueError(f"{what}: the tables must share one dtype, got "
                             f"{t0.dtype} and {t.dtype}")
        if t.device != t0.device:
            raise ValueError(f"{what}: the tables must share one device, got "
                             f"{t0.device} and {t.device}")


def _gather(what, tables, ids, counters, row_start=None):
    """K4 over ``tables`` (already gated) by ``ids``: one launch on CUDA,
    counted once in each wrapper of ``counters``; returns one output per
    table."""
    table = tables[0]
    _row_check(what, table, ids)
    if table.device.type == "cpu":
        return [gather_rows_plain(t, ids, row_start) for t in tables]
    ids = ids.contiguous()
    n, d = ids.shape[0], table.shape[1]
    outs = [torch.empty((n, d), dtype=table.dtype, device=table.device)
            for _ in tables]
    log_g, vec = _row_cuda(what, table, ids, *tables[1:], *outs)
    for t in tables[1:]:
        if not t.is_contiguous():
            raise ValueError(f"{what}: the tables must be contiguous")
    if n == 0:
        return outs
    k = len(tables)
    ptrs = [t.data_ptr() for t in tables] + [None] * (3 - k)
    optrs = [o.data_ptr() for o in outs] + [None] * (3 - k)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _load("embedding_rows").ff_gather_rows(
        k, *ptrs, *optrs, ids.data_ptr(), table.shape[0], d, n,
        int(ids.dtype == torch.int64), int(vec), log_g,
        gather_ctas(n, log_g, _sm_count(table.device)),
        0 if row_start is None else int(row_start), int(row_start is not None),
        stream,
    )
    _raise_on(err, what)
    for fn in counters:
        fn.launches += 1
    return outs


def gather_rows(table, ids, row_start: Optional[int] = None):
    """``table (R, D) [ids (n,)] -> (n, D)``, reading only the addressed
    rows; an id outside ``[0, R)`` gives a NaN row.  With ``row_start``
    (the first row of a rank's block of a row-sharded table) row ``i`` is
    ``table[ids[i] - row_start]``, a zero row where that is outside
    ``[0, R)``: JAX's masked take.  The port of
    ``pallas_kernels.gather_rows`` (kernel ``_gather_kernel``); source
    ``csrc/embedding_rows.cu``.  Any ``D``; f32 tables, int32 or int64
    ids."""
    return _gather("gather_rows", (table,), ids, (gather_rows,),
                   row_start)[0]


gather_rows.launches = 0


def gather_rows_multi_plain(tables, ids, row_start: Optional[int] = None):
    """Plain version of :func:`gather_rows_multi`: one
    :func:`gather_rows_plain` per table."""
    return [gather_rows_plain(t, ids, row_start) for t in tables]


def gather_rows_multi(tables, ids, row_start: Optional[int] = None):
    """``[t[ids] for t in tables]`` in ONE K4 launch: 1 to 3 tables of one
    ``(R, D)``, dtype and device, gathered by the same ids (the lazy
    optimizers' param and state rows), each output the bits
    :func:`gather_rows` gives for its table.  Counted in
    ``gather_rows.launches`` (one launch, one count) and in its own
    ``launches``.  A mismatch of the tables raises ``ValueError`` on every
    device.  ``row_start`` windows every table as in :func:`gather_rows`."""
    tables = tuple(tables)
    _tables_check("gather_rows_multi", tables)
    return _gather("gather_rows_multi", tables, ids,
                   (gather_rows, gather_rows_multi), row_start)


gather_rows_multi.launches = 0


#: K5's single-launch cap: up to this many ids, one CTA's shared memory
#: holds the grouping arrays of every id (the kernel refuses more).
_SCATTER_CAP = 4096
#: K5's grid: the CTAs that own the rows (one per SM of an H100), at most
#: one per 16 ids.
_SCATTER_MAX_CTAS = 132


def scatter_plan(n: int) -> Tuple[int, int]:
    """K5's launch plan for ``n`` ids, from ``n`` alone (reading the ids
    back would cost a device-to-host sync): ``(launches, ctas)``.  Up to
    the cap one launch bins in shared memory; above it a counting launch
    and the binning launch use a scratch whose size the kernel's library
    gives (``ff_scatter_scratch_bytes``: the layout is the kernel's)."""
    ctas = max(1, min(_SCATTER_MAX_CTAS, -(-n // 16)))
    return (1 if n <= _SCATTER_CAP else 2), ctas


def scatter_add_rows(table, ids, upd, row_start: Optional[int] = None):
    """``table[ids] += upd`` IN PLACE, touching only the addressed rows,
    with no float atomics: duplicate ids are summed in f32 in batch order
    and added to their row once, so two calls on the same inputs give
    bit-identical tables; updates of ids outside ``[0, R)`` are dropped
    and ``n = 0`` is a no-op.  With ``row_start`` (the first row of a
    rank's block of a row-sharded table) the update of ``ids[i]`` goes to
    row ``ids[i] - row_start``, and those outside ``[0, R)`` are dropped.
    Returns ``table``.  The port of
    ``pallas_kernels.scatter_add_rows`` (kernel ``_scatter_add_kernel``;
    ``_collapse_runs``' sort becomes the kernel's own binning, see
    :func:`scatter_plan`); source ``csrc/embedding_rows.cu``.  Any ``D``;
    f32 tables and updates, int32 or int64 ids."""
    _row_check("scatter_add_rows", table, ids, upd)
    if table.device.type == "cpu":
        ids = _window(ids, row_start)
        return scatter_add_rows_plain(table, ids, upd)
    if upd.dtype != table.dtype:
        raise ValueError(f"scatter_add_rows: updates must be {table.dtype}, "
                         f"got {upd.dtype}")
    upd = _dense(upd)
    log_g, vec = _row_cuda("scatter_add_rows", table, ids, upd)
    n = ids.shape[0]
    if n == 0:
        return table
    ids = ids.contiguous()
    launches, ctas = scatter_plan(n)
    lib = _load("embedding_rows")
    scratch, nbytes = None, 0
    if launches == 2:
        nbytes = lib.ff_scatter_scratch_bytes(n, ctas)
        scratch = torch.empty((nbytes,), dtype=torch.uint8,
                              device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.ff_scatter_add_rows(
        table.data_ptr(), ids.data_ptr(), upd.data_ptr(), table.shape[0],
        table.shape[1], n, log_g, int(ids.dtype == torch.int64), int(vec),
        ctas, None if scratch is None else scratch.data_ptr(), nbytes,
        0 if row_start is None else int(row_start), stream,
    )
    _raise_on(err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return table


scatter_add_rows.launches = 0


# ---------------------------------------------------------------------------
# around the flash kernels: the dispatcher and its plain-torch formulations
# ---------------------------------------------------------------------------
#
# The JAX package computes these in jnp around its Pallas kernels
# (pallas_kernels.py:813-1047); here they are plain torch, differentiable
# by autograd through the kernels' Functions.


def merge_lse(o1, lse1, o2, lse2):
    """Combine two flash partials ``(o_i, lse_i) -> (o, lse)``: the
    streaming-softmax merge of ``pallas_kernels.merge_lse``.  ``o_i``
    ``(..., t, hd)`` f32, ``lse_i`` ``(..., t)`` f32; ``lse = -1e30`` marks
    an empty partial, whose weight is then 0."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse


def flash_supported(shape, dtype=torch.float32) -> bool:
    """K1f/K1b's gate: f32 or bf16, ``hd`` a multiple of 8 in [8, 128],
    any ``t >= 1`` (the port keeps no t < 16 einsum branch: the kernel
    masks ragged tiles).  Hopper's gate in place of the TPU's VMEM block
    cap."""
    if len(shape) != 4:
        return False
    _, _, t, hd = shape
    return (dtype in _KERNEL_DTYPES and t >= 1 and hd % 8 == 0
            and 8 <= hd <= 128 and _k1b_limit(shape, dtype) is None)


def _k1b_limit(shape, dtype) -> Optional[str]:
    """The launch limit of K1f/K1b that ``(b, h, t, hd)`` attention of
    ``dtype`` breaks, or None: at most 65535 64-row tiles per head (the
    grid's second axis) and, for the bf16 wgmma pair's TMA row maps,
    ``b h t < 2^31`` rows."""
    b, h, t, _ = shape
    if -(-t // 64) > 65535:
        return f"t = {t} is more than 65535 64-row tiles"
    if dtype == torch.bfloat16 and b * h * t > 0x7fffffff:
        return f"b h t = {b * h * t} rows is 2^31 or more"
    return None


#: Sequences at least this long that no kernel takes stream through the
#: plain blocked formulation instead of a t x t einsum.
_BLOCKED_MIN_T = 4096


def blocked_attention_applies(shape) -> bool:
    """Long-context shapes :func:`attention_lse_blocked` absorbs when no
    kernel takes them (the einsum would materialise a t x t matrix)."""
    if len(shape) != 4:
        return False
    _, _, t, hd = shape
    return t >= _BLOCKED_MIN_T and hd >= 8


def flash_attention_lse_chunked(q, k, v, causal: bool = True,
                                chunk=None):
    """Flash attention as sequence chunks: one K1f launch per (q chunk, k
    chunk) pair that the mask leaves visible, partials combined by
    :func:`merge_lse` in f32 (``pallas_kernels.flash_attention_lse_chunked``).
    ``chunk`` must divide ``t`` and be shorter than it.  There is no
    automatic length and no gate that picks this form: on the TPU it
    catches shapes past the single launch's VMEM cap, while K1f keeps no
    resident K/V and takes every ``t`` in one launch."""
    b, h, t, hd = q.shape
    c = chunk or 0
    if c <= 0 or c >= t or t % c:
        raise ValueError(f"flash_attention_lse_chunked: chunk {chunk} must "
                         f"divide t={t} and be shorter than it")
    n = t // c

    def sl(x, i):
        return x[:, :, i * c:(i + 1) * c]

    outs, lses = [], []
    for i in range(n):
        qi = sl(q, i)
        # The diagonal chunk under the kernel's own mask; the others are
        # fully visible (all of them when not causal, j < i when causal).
        o, lse = flash_attention_lse(qi, sl(k, i), sl(v, i), causal)
        o = o.float()
        for j in range(i) if causal else range(n):
            if j == i:
                continue
            o_j, lse_j = flash_attention_lse(qi, sl(k, j), sl(v, j), False)
            o, lse = merge_lse(o, lse, o_j.float(), lse_j)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def _blocked_rows(qi, kp, vp, q0: int, t: int, causal: bool, block_k: int):
    """One q block of :func:`attention_lse_blocked`: the online softmax
    over the k blocks in f32, ``p`` rounded to v's dtype before P.V."""
    b, h, bq, hd = qi.shape
    scale = 1.0 / math.sqrt(hd)
    q_pos = q0 + torch.arange(bq, device=qi.device)
    m = torch.full((b, h, bq, 1), _NEG_INF, dtype=torch.float32,
                   device=qi.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, bq, hd), dtype=torch.float32, device=qi.device)
    nk = kp.shape[2] // block_k
    # Causal: the blocks past the diagonal are masked whole and would add
    # exact zeros (p = 0, corr = 1), so the loop stops there.
    stop = min(nk, -(-(q0 + bq) // block_k)) if causal else nk
    qf = qi.float()
    for j in range(stop):
        kj = kp[:, :, j * block_k:(j + 1) * block_k]
        vj = vp[:, :, j * block_k:(j + 1) * block_k]
        s = torch.matmul(qf, kj.float().transpose(-1, -2)) * scale
        k_pos = j * block_k + torch.arange(block_k, device=qi.device)
        valid = (k_pos < t)[None, :]
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        acc = acc * corr + torch.matmul(p.to(vj.dtype).float(), vj.float())
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (acc / l_safe).to(qi.dtype), (m + torch.log(l_safe))[..., 0]


def attention_lse_blocked(q, k, v, causal: bool = True, block_q: int = 512,
                          block_k: int = 512):
    """Plain streaming attention ``(o, lse)`` over ``(b, h, t, hd)`` for
    any ``t`` and ``hd`` (tails padded and masked), in ``O(t * block)``
    memory: the port of ``pallas_kernels.attention_lse_blocked``, the
    long-context safety net for shapes no kernel takes.  A Python loop
    over q blocks replaces ``lax.scan``; each q block runs under
    ``torch.utils.checkpoint``, so the backward recomputes its k loop
    instead of keeping every score block."""
    from torch.utils.checkpoint import checkpoint

    b, h, t, hd = q.shape
    nq, nk = -(-t // block_q), -(-t // block_k)
    qp = torch.nn.functional.pad(q, (0, 0, 0, nq * block_q - t))
    kp = torch.nn.functional.pad(k, (0, 0, 0, nk * block_k - t))
    vp = torch.nn.functional.pad(v, (0, 0, 0, nk * block_k - t))
    outs, lses = [], []
    for i in range(nq):
        o, lse = checkpoint(_blocked_rows,
                            qp[:, :, i * block_q:(i + 1) * block_q], kp, vp,
                            i * block_q, t, causal, block_k,
                            use_reentrant=False, preserve_rng_state=False)
        outs.append(o)
        lses.append(lse)
    return (torch.cat(outs, dim=2)[:, :, :t], torch.cat(lses, dim=2)[:, :, :t])


#: FF_FLASH_FORCE_CHUNK=<len>: route the shapes K1f takes through the
#: chunked form at that chunk length (0 = off), as in the JAX package.
_FORCE_CHUNK = int(os.environ.get("FF_FLASH_FORCE_CHUNK", "0") or 0)

#: FF_FLASH_STREAMED=1: route every shape the streamed kernels take
#: through them (K1s forward, K1sb backward), as in the JAX package.
_STREAMED = os.environ.get("FF_FLASH_STREAMED", "0") == "1"


def flash_attention_lse_auto(q, k, v, causal: bool = True):
    """``(o, lse)`` by the first formulation whose gate takes the shape,
    in the order of ``pallas_kernels.flash_attention_lse_auto``: the
    streamed kernels under ``FF_FLASH_STREAMED=1``, the chunked form
    under ``FF_FLASH_FORCE_CHUNK``, one K1f launch, the blocked form at
    ``t >= 4096``; ``None`` when none applies, which callers take as the
    signal for the einsum.  (JAX's automatic chunked branch, for shapes
    past its VMEM cap, has no Hopper counterpart: K1f takes every ``t``.)
    Every route is chosen by a gate before any launch, and the gates are
    the same on the CPU and on the card."""
    b, h, t, hd = q.shape
    if _STREAMED and flash_stream_supported(q.shape, q.dtype):
        return flash_attention_lse_streamed(q, k, v, causal)
    if (_FORCE_CHUNK and t > _FORCE_CHUNK and t % _FORCE_CHUNK == 0
            and flash_supported((b, h, _FORCE_CHUNK, hd), q.dtype)):
        return flash_attention_lse_chunked(q, k, v, causal,
                                           chunk=_FORCE_CHUNK)
    if flash_supported(q.shape, q.dtype):
        return flash_attention_lse(q, k, v, causal)
    if blocked_attention_applies(q.shape):
        return attention_lse_blocked(q, k, v, causal)
    return None


#: The port's kernel wrappers, for callers that reset and read the counters.
KERNELS = (flash_attention_lse, flash_attention_lse_bwd, flash_decode,
           softmax_xent, softmax_xent_bwd, gather_rows, gather_rows_multi,
           scatter_add_rows,
           flash_attention_lse_streamed, flash_attention_lse_streamed_bwd)
