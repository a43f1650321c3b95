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
There is no fallback from the kernel to the plain version.  Each
wrapper counts its launches in a plain integer attribute
(``flash_attention_lse.launches``), so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

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
_SOURCES = ("flash_fwd", "flash_decode")
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
    elif name == "flash_decode":
        lib.ff_flash_decode.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
        lib.ff_flash_decode.restype = i
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


def _check_cuda(what: str, *tensors: torch.Tensor) -> int:
    dev = tensors[0].device
    if dev.type != "cuda":
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
    if hd % 8 or not 8 <= hd <= 128:
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


def flash_attention_lse(q, k, v, causal: bool = True):
    """Blocked flash attention over ``(b, h, t, hd)`` heads.

    Returns ``(o, lse)``: ``o`` in the input dtype and ``lse`` as
    ``(b, h, t)`` f32.  The port of ``pallas_kernels.flash_attention_lse``
    (forward kernel ``_fwd_kernel``); source ``csrc/flash_fwd.cu``.
    Every ``t >= 1`` is supported: ragged tiles are masked in the kernel.
    """
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal)
    code = _check_cuda("flash_attention_lse", q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_lse: q, k, v must share one "
                         f"(b, h, t, hd) shape, got {q.shape}, {k.shape}, "
                         f"{v.shape}")
    b, h, t, hd = q.shape
    q, k, v = _dense(q), _dense(k), _dense(v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _load("flash_fwd").ff_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, t, hd, int(bool(causal)),
        1.0 / math.sqrt(hd), code, stream,
    )
    _raise_on(err, "flash_attention_lse")
    flash_attention_lse.launches += 1
    return o, lse


flash_attention_lse.launches = 0


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


def flash_decode(q, cache_k, cache_v, lengths):
    """Single-token decode attention against a padded KV cache.

    ``q``: ``(B, h, hd)``; ``cache_k``/``cache_v``: ``(B, S, h, hd)``;
    ``lengths``: ``(B,)`` int32 in ``[1, S]``, the valid keys per slot.
    Returns ``(B, h, hd)`` in ``q``'s dtype.  The port of
    ``pallas_kernels.flash_decode`` (kernel ``_decode_kernel``); source
    ``csrc/flash_decode.cu``.  The kernel reads only the first
    ``lengths[b]`` cache rows of each slot.
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, cache_k, cache_v, lengths)
    code = _check_cuda("flash_decode", q, cache_k, cache_v)
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
    q, cache_k, cache_v = _dense(q), _dense(cache_k), _dense(cache_v)
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _load("flash_decode").ff_flash_decode(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, S, h, hd,
        1.0 / math.sqrt(hd), code, stream,
    )
    _raise_on(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


#: The port's kernel wrappers, for callers that reset and read the counters.
KERNELS = (flash_attention_lse, flash_decode)
