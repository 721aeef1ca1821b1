"""Public wrapper of blocked causal/windowed GQA flash attention, with its
gradient.

``flash_attention`` is a ``torch.autograd.Function``. Dispatch goes by the
tensors' device: CPU tensors take the plain versions of ``ref.py``
(``flash_attention_fwd_ref`` forward, ``flash_attention_bwd_ref`` backward);
CUDA tensors launch the kernels of ``csrc/flash_attention.cu`` (the forward,
and in the backward its dQ and dK/dV kernels) and raise if they cannot:
bfloat16 the tensor-core kernels (16-byte aligned operands: they are copied
in 16-byte pieces), float32 the CUDA-core ones.
The TPU kernel's ``block_q`` / ``block_k`` arguments are its tiling for the
TPU and are not part of this signature: the CUDA kernels pick their own
tiles by head dim.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def _check(name, q, k, v):
    B, Sq, H, hd = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd \
            or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    K = k.shape[2]
    if Sq < 1 or k.shape[1] < 1 or H % K:
        raise ValueError(f"{name}: needs Sq, Sk >= 1 and H % K == 0, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")


def tc_kernel_info(hd: int) -> dict:
    """Registers, local bytes (spills and stack) and dynamic shared memory
    of the three bf16 tensor-core kernels at head dim ``hd``, as the loaded
    library reports them. Builds the library on first use."""
    out = (ctypes.c_int * 3)()
    info = {}
    for part, name in enumerate(("forward", "dq", "dkdv")):
        build.check(f"flash_attention tc_info {name}",
                    build.lib().aqua_flash_attention_tc_info(
                        part, hd, ctypes.addressof(out)))
        info[name] = dict(registers=out[0], local_bytes=out[1],
                          smem_bytes=out[2])
    return info


def _forward_kernel(q, k, v, causal, window, scale):
    name = "flash_attention"
    _check(name, q, k, v)
    build.require_cuda(name, q, k, v)
    build.require_aligned16(name, q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = build.lib().aqua_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, K, hd, int(causal), window, scale,
        _DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return o, lse


def _backward_kernel(q, k, v, o, lse, do, causal, window, scale):
    name = "flash_attention_bwd"
    _check(name, q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"{name}: o / dO must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    build.require_cuda(name, q, k, v, o, lse, do)
    build.require_aligned16(name, q, k, v, o, do)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = build.lib().aqua_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), D.data_ptr(), B, Sq, Sk, H, K, hd, int(causal), window,
        scale, _DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """The forward alone -> (o (B, Sq, H, hd), lse (B, H, Sq) float32)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    return _forward_kernel(q, k, v, causal, window, scale)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """The backward from the saved output and row log-sum-exp ->
    (dq, dk, dv); dk and dv summed over each KV head's query heads."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale)
    return _backward_kernel(q, k, v, o, lse, do, causal, window, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd); H % K == 0 -> (B, Sq, H, hd)
    in q's dtype, differentiable in q, k and v. Queries are right-aligned
    against the keys; ``window > 0`` keeps keys with ``q_pos - k_pos <
    window``. CUDA tensors: float32 or bfloat16, contiguous, hd in
    ``HEAD_DIMS``."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)
