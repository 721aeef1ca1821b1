"""Public wrappers for the fused serving step's paged kernels.

Dispatch goes by the tensors' device: CPU tensors take the plain versions
in ``ref.py``; CUDA tensors launch the kernels of ``csrc/paged_attention.cu``
(and raise if they cannot). Index operands (block tables, slots, offsets,
per-row metadata) are int32 tensors on the pool's device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    append_kv_ref, paged_mixed_attention_pool_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _index(name, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index operands must be int32")


def paged_mixed_attention_pool(q, kv_pool, block_tables, q_starts, n_reals,
                               is_decode, *, scale: Optional[float] = None):
    """One launch of attention for a packed batch of decode lanes and
    prefill chunk rows over the page pool.

    q: (R,Tc,H,hd); kv_pool: (P,2,K,page,hd) of q's dtype; block_tables:
    (R, read_pps) int32 pool slots; q_starts/n_reals/is_decode: (R,) int32.
    -> (R,Tc,H,hd)
    """
    if q.device.type == "cpu":
        return paged_mixed_attention_pool_ref(q, kv_pool, block_tables,
                                              q_starts, n_reals, is_decode,
                                              scale=scale)
    name = "paged_mixed_attention_pool"
    R, Tc, H, hd = q.shape
    P, two, K, page, hd2 = kv_pool.shape
    if two != 2 or hd2 != hd or H % K:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match pool "
                         f"{tuple(kv_pool.shape)}")
    if hd % 32 or hd > 128:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 32, "
                         "at most 128")
    if q.dtype != kv_pool.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: q and pool must share float32 or "
                         f"bfloat16, got {q.dtype} and {kv_pool.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != R:
        raise ValueError(f"{name}: block_tables must be (R, read_pps)")
    for t in (q_starts, n_reals, is_decode):
        if tuple(t.shape) != (R,):
            raise ValueError(f"{name}: per-row metadata must be (R,)")
    _index(name, block_tables, q_starts, n_reals, is_decode)
    build.require_cuda(name, q, kv_pool, q_starts, n_reals, is_decode)
    if block_tables.device != q.device or block_tables.stride(1) != 1:
        raise ValueError(f"{name}: block_tables must be on q's device with "
                         "unit stride along pages")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    lib = build.lib()
    rc = lib.aqua_mixed_attention(
        q.data_ptr(), kv_pool.data_ptr(), block_tables.data_ptr(),
        q_starts.data_ptr(), n_reals.data_ptr(), is_decode.data_ptr(),
        out.data_ptr(), R, Tc, H, K, page, hd, block_tables.shape[1],
        block_tables.stride(0), P, float(scale), _DTYPE_CODES[q.dtype],
        build.stream_of(q))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return out


def append_kv(kv_pool, k_new, v_new, slots, offsets):
    """Append one decode token's K/V per lane into its page, in place:
    pool[slots[b], 0|1, :, offsets[b], :]. Returns the pool."""
    if kv_pool.device.type == "cpu":
        return append_kv_ref(kv_pool, k_new, v_new, slots, offsets)
    name = "append_kv"
    P, two, K, page, hd = kv_pool.shape
    B = k_new.shape[0]
    k_new = k_new.to(kv_pool.dtype).contiguous()
    v_new = v_new.to(kv_pool.dtype).contiguous()
    if (two != 2 or tuple(k_new.shape) != (B, K, hd)
            or tuple(v_new.shape) != (B, K, hd)):
        raise ValueError(f"{name}: k/v {tuple(k_new.shape)} do not match "
                         f"pool {tuple(kv_pool.shape)}")
    if tuple(slots.shape) != (B,) or tuple(offsets.shape) != (B,):
        raise ValueError(f"{name}: slots/offsets must be (B,)")
    if kv_pool.element_size() not in (2, 4):
        raise ValueError(f"{name}: pool element size must be 2 or 4 bytes")
    _index(name, slots, offsets)
    build.require_cuda(name, kv_pool, k_new, v_new, slots, offsets)
    if B == 0:
        return kv_pool
    lib = build.lib()
    rc = lib.aqua_append_kv(kv_pool.data_ptr(), k_new.data_ptr(),
                            v_new.data_ptr(), slots.data_ptr(),
                            offsets.data_ptr(), B, K, page, hd, P,
                            kv_pool.element_size(), build.stream_of(kv_pool))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return kv_pool
