"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is a plain C entry point in a ``csrc/*.cu`` source
(``SOURCES``).  At first use each source is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``; nothing is compiled at import,
so the CPU tests import this module without ``nvcc``.  The library name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel
and nowhere else, so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# kernel -> the source that holds its entry point
SOURCES = {
    "flash_attn_fwd": "flash_attn_fwd.cu",
    "flash_attn_bwd_dq": "flash_attn_bwd.cu",
    "flash_attn_bwd_dkv": "flash_attn_bwd.cu",
}
KERNELS = tuple(SOURCES)
_P, _I = ctypes.c_void_p, ctypes.c_int
# pointers, then (bh, t, d, kv_len, dtype), then the stream
ARGTYPES = {
    "flash_attn_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "flash_attn_bwd_dq": [_P] * 8 + [_I] * 5 + [_P],
    "flash_attn_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P],
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIBS: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _library_path(name: str) -> Path:
    """The shared library that holds kernel ``name`` (one per source); its
    name hashes the source, the headers it may include and the flags."""
    src = CSRC / SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(names=KERNELS) -> Dict[str, dict]:
    """Compile the source of every named kernel that is not built yet, one
    ``nvcc`` per source, all started together.  Returns ``{name: {"path",
    "seconds", "log"}}``; ``log`` holds the compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills) of the kernel's source.  Raises if a
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        so = _library_path(name)
        if so.exists() or so in procs:
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[so] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for so, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.stem}:\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
        so.with_suffix(".log").write_text(log)
    seconds = time.perf_counter() - t0
    out = {}
    for name in names:
        so = _library_path(name)
        log = so.with_suffix(".log")
        out[name] = {"path": str(so), "seconds": seconds,
                     "log": log.read_text() if log.exists() else ""}
    return out


def _fn(name: str):
    """The C entry point of kernel ``name``, its source built and loaded at
    first use."""
    fn = _LIBS.get(name)
    if fn is None:
        build((name,))
        fn = getattr(ctypes.CDLL(str(_library_path(name))), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ARGTYPES[name]
        _LIBS[name] = fn
    return fn


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: Optional[int]) -> int:
    """Raise on what the flash kernels do not take; return the effective
    ``kv_len``.  Device-agnostic, so the CPU path checks the same layout."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes fp32 or bf16, got {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must be one [B, H, T, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, h, t, d = q.shape
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"head_dim must be a multiple of 8 up to 128, got {d}")
    if not 1 <= b * h <= 65535 or t < 1:
        raise ValueError(f"unsupported batch*heads {b * h} or length {t}")
    kv = t if kv_len is None else int(kv_len)
    if not 1 <= kv <= t:
        raise ValueError(f"kv_len must lie in [1, {t}], got {kv_len}")
    return kv


def _check_cuda(name: str, *xs: torch.Tensor) -> None:
    if not all(x.is_cuda for x in xs):
        raise ValueError(f"{name} takes CUDA tensors")
    if any(x.device != xs[0].device for x in xs):
        raise ValueError(f"{name}: all inputs must lie on one device")
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{name}: inputs must start on a 16-byte boundary")


def _dtype_code(q: torch.Tensor) -> int:
    return 0 if q.dtype == torch.float32 else 1


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[int] = None):
    """Launch the Hopper flash-attention forward on CUDA tensors.

    q, k, v: [B, H, T, D] contiguous, one dtype (bf16 or fp32), q already
    scaled by 1/sqrt(D).  Keys at or beyond ``kv_len`` are masked.
    Returns (O [B, H, T, D] in q's dtype, LSE [B, H, T] fp32)."""
    _check_cuda("flash_attn_fwd", q, k, v)
    kv = check_flash_inputs(q, k, v, kv_len)
    b, h, t, d = q.shape
    fn = _fn("flash_attn_fwd")
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b * h, t, d, kv, _dtype_code(q), stream)
    _check(err, "flash_attn_fwd")
    LAUNCHES["flash_attn_fwd"] += 1
    return o, lse


def _check_bwd(name, q, k, v, kv_len, rows, stats) -> int:
    """Raise on what a backward kernel does not take; ``rows`` names the
    [B, H, T, D] inputs beside q, k, v (dO, and O for dq), ``stats`` the fp32
    [B, H, T] ones (LSE, and D for dk/dv).  Return the effective ``kv_len``."""
    _check_cuda(name, q, k, v, *rows.values(), *stats.values())
    kv = check_flash_inputs(q, k, v, kv_len)
    for label, x in rows.items():
        if x.shape != q.shape or x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous with q's shape and dtype")
    for label, x in stats.items():
        if x.shape != q.shape[:3] or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous fp32 [B, H, T]")
    return kv


def flash_attn_bwd_dq(q, k, v, o, do, lse, kv_len: Optional[int] = None):
    """Launch the Hopper dq kernel on CUDA tensors: q, k, v, O (the
    forward's output) and dO [B, H, T, D] contiguous in one dtype, LSE (the
    forward's) fp32 [B, H, T].  Returns (dq in q's dtype, D = rowsum(dO * O)
    fp32 [B, H, T]); the kernel computes D from its dO and O tiles, and
    ``flash_attn_bwd_dkv`` takes that D on the same stream."""
    kv = _check_bwd("flash_attn_bwd_dq", q, k, v, kv_len, {"dO": do, "O": o}, {"LSE": lse})
    b, h, t, d = q.shape
    fn = _fn("flash_attn_bwd_dq")
    with torch.cuda.device(q.device):
        dq = torch.empty_like(q)
        delta = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, t, d, kv,
                 _dtype_code(q), stream)
    _check(err, "flash_attn_bwd_dq")
    LAUNCHES["flash_attn_bwd_dq"] += 1
    return dq, delta


def flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len: Optional[int] = None):
    """Launch the Hopper dk/dv kernel on CUDA tensors: q, k, v, dO as
    ``flash_attn_bwd_dq``, LSE and D (the one ``flash_attn_bwd_dq`` returns)
    fp32 [B, H, T].  Returns (dk, dv) in k's dtype; rows at keys >=
    ``kv_len`` are exactly 0."""
    kv = _check_bwd("flash_attn_bwd_dkv", q, k, v, kv_len, {"dO": do},
                    {"LSE": lse, "D": delta})
    b, h, t, d = q.shape
    fn = _fn("flash_attn_bwd_dkv")
    with torch.cuda.device(q.device):
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b * h, t, d, kv, _dtype_code(q), stream)
    _check(err, "flash_attn_bwd_dkv")
    LAUNCHES["flash_attn_bwd_dkv"] += 1
    return dk, dv
