"""Public wrapper of the chunked RWKV-6 WKV recurrence.

Dispatch goes by the tensors' device: CPU tensors take ``wkv6_plain`` (the
reference layer's dispatch between the chunked form and the scan); CUDA
tensors launch the kernel of ``csrc/wkv6.cu`` (and raise if they cannot).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def wkv6_kernel_info(hd: int) -> dict:
    """Registers, local bytes (spills and stack), dynamic shared memory and
    resident blocks per SM of the kernel at head dim ``hd``, per compute
    dtype, as the loaded library reports them. Builds the library on first
    use."""
    out = (ctypes.c_int * 4)()
    info = {}
    for dtype, code in _DTYPE_CODES.items():
        name = f"wkv6<{str(dtype).split('.')[-1]}>"
        build.check(f"wkv6 info {name}",
                    build.lib().aqua_wkv6_info(code, hd,
                                               ctypes.addressof(out)))
        info[name] = dict(registers=out[0], local_bytes=out[1],
                          smem_bytes=out[2], blocks_per_sm=out[3])
    return info


def wkv6(r, k, v, w, u, state):
    """r, k, v: (B,T,H,hd) of one compute dtype (float32 or bfloat16); w:
    (B,T,H,hd) float32 log-decay <= 0; u: (H,hd) float32; state:
    (B,H,hd,hd) float32. Any T >= 1 (the last chunk may be short).
    -> (y (B,T,H,hd) in r's dtype, state' (B,H,hd,hd) float32)"""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state)
    name = "wkv6"
    B, T, H, hd = r.shape
    if T < 1:
        raise ValueError(f"{name}: needs at least one token")
    if hd not in (32, 64):
        raise ValueError(f"{name}: head_dim {hd} must be 32 or 64")
    if T * H * hd >= 2 ** 31:
        raise ValueError(f"{name}: T * H * head_dim must stay below "
                         "2**31 (the kernel's offsets within a sequence "
                         "are 32-bit)")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"{name}: r, k, v must share float32 or bfloat16, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}")
    for t, what in ((w, "w"), (u, "u"), (state, "state")):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32, got {t.dtype}")
    for t, shape, what in ((k, r.shape, "k"), (v, r.shape, "v"),
                           (w, r.shape, "w"), (u, (H, hd), "u"),
                           (state, (B, H, hd, hd), "state")):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} != "
                             f"{tuple(shape)}")
    build.require_cuda(name, r, k, v, w, u, state)
    for t, what in ((r, "r"), (k, "k"), (v, "v"), (w, "w"),
                    (state, "state")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte "
                             f"boundary (data_ptr {t.data_ptr()})")
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    lib = build.lib()
    rc = lib.aqua_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(), state.data_ptr(),
                       y.data_ptr(), s_out.data_ptr(), B, T, H, hd,
                       _DTYPE_CODES[r.dtype], build.stream_of(r))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return y, s_out
