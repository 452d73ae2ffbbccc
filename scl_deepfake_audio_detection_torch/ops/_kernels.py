"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (listed in ``.gitignore``) and loaded with ``ctypes``; nothing
is compiled at import, so the CPU tests import this module without
``nvcc``.  The library name carries a hash of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded.

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
KERNELS = ("flash_attn_fwd",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}


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
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc`` each,
    all started together.  Returns ``{name: {"path", "seconds", "log"}}``;
    ``log`` holds the compiler's ``-Xptxas -v`` report (registers, shared
    memory, spills).  Raises if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name in names:
        so = _library_path(name)
        log = ""
        if name in procs:
            _, tmp, proc = procs[name]
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
            so.with_suffix(".log").write_text(log)
        elif so.with_suffix(".log").exists():
            log = so.with_suffix(".log").read_text()
        out[name] = {"path": str(so), "seconds": time.perf_counter() - t0, "log": log}
    return out


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if name == "flash_attn_fwd":
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _LIBS[name] = lib
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: Optional[int]) -> int:
    """Raise on what the flash kernel does not take; return the effective
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


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: Optional[int] = None):
    """Launch the Hopper flash-attention forward on CUDA tensors.

    q, k, v: [B, H, T, D] contiguous, one dtype (bf16 or fp32), q already
    scaled by 1/sqrt(D).  Keys at or beyond ``kv_len`` are masked.
    Returns (O [B, H, T, D] in q's dtype, LSE [B, H, T] fp32)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attn_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    kv = check_flash_inputs(q, k, v, kv_len)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    b, h, t, d = q.shape
    fn = _lib("flash_attn_fwd").flash_attn_fwd
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b * h, t, d, kv,
                 0 if q.dtype == torch.float32 else 1, stream)
    _check(err, "flash_attn_fwd")
    LAUNCHES["flash_attn_fwd"] += 1
    return o, lse
