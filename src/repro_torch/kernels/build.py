"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ under ``src/repro_torch/csrc/`` with a plain C
interface, compiled at first use with ``nvcc`` for ``sm_90a`` into one shared
library and bound with ``ctypes``. Each source compiles in its own ``nvcc``
process, all started together, then one link step joins them. The library
lands in ``build/repro_torch/`` at the repository root (git-ignored), named
by a hash of the sources, the headers they share (``csrc/*.cuh``) and the
flags, so an edited source or header never loads a stale build. Nothing
happens at import: the CPU tests import every module of the port on a
machine without ``nvcc``.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one exactly
where it launches its kernel, so a run can show that its path went through
the kernels (``reset_launch_counts`` before it, ``launch_counts`` after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -fmad=false: no multiply-add is contracted behind the source's back, so
# the attention kernels' shared row step rounds the same in every kernel
# (its own fused multiply-adds are explicit intrinsics).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")

LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "aqua_gather_pages": [_P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _P],
    "aqua_gather_pages_info": [_I, _I, _P],
    "aqua_scatter_pages": [_P, _P, _P, _L, _L, _L, _P],
    "aqua_write_kv_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _L, _I, _P],
    "aqua_write_kv_rows_info": [_I, _I, _P],
    "aqua_mixed_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _L, ctypes.c_float, _I, _P],
    "aqua_prefill_attention_pool": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _L, ctypes.c_float, _I, _P],
    "aqua_decode_attention_pool": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _L, ctypes.c_float, _I, _P],
    "aqua_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "aqua_wkv6_info": [_I, _I, _P],
    "aqua_paged_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _L, _L, _L, ctypes.c_float, _I, _P],
    "aqua_flash_attention_fwd": [_P] * 5 + [_I] * 8 + [ctypes.c_float, _I,
                                                       _P],
    "aqua_flash_attention_bwd": [_P] * 10 + [_I] * 8 + [ctypes.c_float, _I,
                                                        _P],
    "aqua_flash_attention_tc_info": [_I, _I, _P],
    "aqua_paged_attention_tc_info": [_I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log: str = ""


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from src/repro_torch/csrc on a machine with the CUDA "
                       "toolkit")


def build_tag() -> str:
    """Hash of the flags and of every source and header under ``CSRC``
    (``*.cu``, ``*.cuh``): the name of the library they build, so an edited
    source or shared header never loads a stale build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link
    them into one shared library; returns its path. Reuses a library built
    from the same sources and flags."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    tag = build_tag()
    out = BUILD_DIR / f"libaqua_kernels_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp.replace(out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, rc: int) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def require_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 kernels read and write rows in 16-byte pieces (``cp.async``,
    vector loads), so their operands start on a 16-byte boundary."""
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: bfloat16 operands must start on a "
                             f"16-byte boundary (data_ptr {t.data_ptr()})")
