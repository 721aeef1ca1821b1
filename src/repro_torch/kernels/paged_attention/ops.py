"""Public wrappers for the serving paths' paged kernels.

Dispatch goes by the tensors' device: CPU tensors take the plain versions
in ``ref.py``; CUDA tensors launch the kernels of ``csrc/paged_attention.cu``
(and raise if they cannot). Index operands (block tables, slots, offsets,
per-row metadata) are int32 tensors on the pool's device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    append_kv_ref, paged_attention_pool_ref, paged_attention_ref,
    paged_mixed_attention_pool_ref, paged_prefill_attention_pool_ref,
    write_kv_rows_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims of the bf16 kernels (rows of a power-of-two count of 16-byte
# chunks); float32 takes any multiple of 32 up to 128
BF16_HEAD_DIMS = (32, 64, 128)
TC_KERNELS = ("mixed", "prefill", "decode_pool", "decode_split")


def writer_kernel_info(hd: int) -> dict:
    """Registers and local bytes (spills and stack) of the row writer for
    bfloat16 and float32 pools at head dim ``hd`` (it uses no shared
    memory), as the loaded library reports them."""
    out = (ctypes.c_int * 3)()
    info = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        build.check(f"write_kv_rows info {name}",
                    build.lib().aqua_write_kv_rows_info(
                        dtype.itemsize, hd, ctypes.addressof(out)))
        info[name] = dict(registers=out[0], local_bytes=out[1])
    return info


def tc_kernel_info(hd: int) -> dict:
    """Registers, local bytes (spills and stack) and dynamic shared memory
    of the bf16 paged-attention kernels at head dim ``hd``, as the loaded
    library reports them. Builds the library on first use."""
    out = (ctypes.c_int * 3)()
    info = {}
    for part, name in enumerate(TC_KERNELS):
        build.check(f"paged_attention tc_info {name}",
                    build.lib().aqua_paged_attention_tc_info(
                        part, hd, ctypes.addressof(out)))
        info[name] = dict(registers=out[0], local_bytes=out[1],
                          smem_bytes=out[2])
    return info


def _index(name, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index operands must be int32")


def _heads(name, q, H, K, hd, pool_dtype):
    if H % K:
        raise ValueError(f"{name}: {H} query heads are not a multiple of "
                         f"{K} kv heads")
    if hd % 32 or hd > 128:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 32, "
                         "at most 128")
    if q.dtype != pool_dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: q and pool must share float32 or "
                         f"bfloat16, got {q.dtype} and {pool_dtype}")
    if q.dtype == torch.bfloat16 and hd not in BF16_HEAD_DIMS:
        raise ValueError(f"{name}: bfloat16 head_dim {hd} not in "
                         f"{BF16_HEAD_DIMS}")


def _table(name, q, block_tables, B):
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be (B, pages)")
    if block_tables.device != q.device or block_tables.stride(1) != 1:
        raise ValueError(f"{name}: block_tables must be on q's device with "
                         "unit stride along pages")


def _per_seq(name, t, B):
    if tuple(t.shape) != (B,):
        raise ValueError(f"{name}: per-sequence operand must be ({B},), got "
                         f"{tuple(t.shape)}")


def _scale(scale, hd):
    return float(scale if scale is not None else 1.0 / math.sqrt(hd))


def paged_prefill_attention_pool(q, kv_pool, block_tables, q_starts, *,
                                 scale: Optional[float] = None):
    """Chunked-prefill attention over the page pool: chunk token t of
    sequence b at q_starts[b] + t attends to keys at positions <= it.

    q: (B,Tc,H,hd); kv_pool: (P,2,K,page,hd) of q's dtype; block_tables:
    (B, read_pps) int32 pool slots; q_starts: (B,) int32. -> (B,Tc,H,hd)
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_pool_ref(q, kv_pool, block_tables,
                                                q_starts, scale=scale)
    name = "paged_prefill_attention_pool"
    B, Tc, H, hd = q.shape
    P, two, K, page, hd2 = kv_pool.shape
    if two != 2 or hd2 != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match pool "
                         f"{tuple(kv_pool.shape)}")
    _heads(name, q, H, K, hd, kv_pool.dtype)
    _per_seq(name, q_starts, B)
    _index(name, block_tables, q_starts)
    build.require_cuda(name, q, kv_pool, q_starts)
    _table(name, q, block_tables, B)
    build.require_aligned16(name, q, kv_pool)
    out = torch.empty_like(q)
    rc = build.lib().aqua_prefill_attention_pool(
        q.data_ptr(), kv_pool.data_ptr(), block_tables.data_ptr(),
        q_starts.data_ptr(), out.data_ptr(), B, Tc, H, K, page, hd,
        block_tables.shape[1], block_tables.stride(0), P, _scale(scale, hd),
        _DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return out


def paged_attention_pool(q, kv_pool, block_tables, lengths, *,
                         scale: Optional[float] = None):
    """Decode attention over the page pool: one query token per sequence,
    keys at positions < lengths[b].

    q: (B,H,hd); kv_pool: (P,2,K,page,hd) of q's dtype; block_tables:
    (B, pps) int32 pool slots; lengths: (B,) int32. -> (B,H,hd)
    """
    if q.device.type == "cpu":
        return paged_attention_pool_ref(q, kv_pool, block_tables, lengths,
                                        scale=scale)
    name = "paged_attention_pool"
    B, H, hd = q.shape
    P, two, K, page, hd2 = kv_pool.shape
    if two != 2 or hd2 != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match pool "
                         f"{tuple(kv_pool.shape)}")
    _heads(name, q, H, K, hd, kv_pool.dtype)
    _per_seq(name, lengths, B)
    _index(name, block_tables, lengths)
    build.require_cuda(name, q, kv_pool, lengths)
    _table(name, q, block_tables, B)
    build.require_aligned16(name, q, kv_pool)
    out = torch.empty_like(q)
    rc = build.lib().aqua_decode_attention_pool(
        q.data_ptr(), kv_pool.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, K, page, hd,
        block_tables.shape[1], block_tables.stride(0), P, _scale(scale, hd),
        _DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: Optional[float] = None):
    """Decode attention over split K and V pools (K,P,page,hd). The pools
    may be strided along (K, P), as the halves ``pool[:, 0|1]
    .movedim(1, 0)`` of the fused pool are; each page's (page, hd) block
    must be contiguous, and K and V must share their strides.

    q: (B,H,hd); block_tables: (B, pps) int32 page ids; lengths: (B,) int32.
    -> (B,H,hd)
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, scale=scale)
    name = "paged_attention"
    B, H, hd = q.shape
    K, P, page, hd2 = k_pages.shape
    if hd2 != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if v_pages.stride() != k_pages.stride() \
            or k_pages.stride()[2:] != (hd, 1):
        raise ValueError(f"{name}: K and V must share strides, each page's "
                         "(page, head_dim) block contiguous")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: K and V pools of different dtypes")
    _heads(name, q, H, K, hd, k_pages.dtype)
    _per_seq(name, lengths, B)
    _index(name, block_tables, lengths)
    build.require_cuda(name, q, lengths)
    for t in (k_pages, v_pages):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    _table(name, q, block_tables, B)
    build.require_aligned16(name, q, k_pages, v_pages)
    if q.dtype == torch.bfloat16 and (k_pages.stride(0) % 8
                                      or k_pages.stride(1) % 8):
        raise ValueError(f"{name}: bfloat16 pools need strides that are "
                         "multiples of 8 elements (16-byte pages)")
    out = torch.empty_like(q)
    rc = build.lib().aqua_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H, K,
        page, hd, block_tables.shape[1], block_tables.stride(0),
        k_pages.stride(0), k_pages.stride(1), P, _scale(scale, hd),
        _DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return out


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
    if two != 2 or hd2 != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match pool "
                         f"{tuple(kv_pool.shape)}")
    _heads(name, q, H, K, hd, kv_pool.dtype)
    for t in (q_starts, n_reals, is_decode):
        _per_seq(name, t, R)
    _index(name, block_tables, q_starts, n_reals, is_decode)
    build.require_cuda(name, q, kv_pool, q_starts, n_reals, is_decode)
    _table(name, q, block_tables, R)
    build.require_aligned16(name, q, kv_pool)
    out = torch.empty_like(q)
    rc = build.lib().aqua_mixed_attention(
        q.data_ptr(), kv_pool.data_ptr(), block_tables.data_ptr(),
        q_starts.data_ptr(), n_reals.data_ptr(), is_decode.data_ptr(),
        out.data_ptr(), R, Tc, H, K, page, hd, block_tables.shape[1],
        block_tables.stride(0), P, _scale(scale, hd), _DTYPE_CODES[q.dtype],
        build.stream_of(q))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return out


def _write_rows(name, kv_pool, k_new, v_new, table, starts, n_write):
    """Launch the row writer: row r writes its tokens t < n_write[r] (all of
    them when ``n_write`` is None) at positions starts[r] + t through
    table row r. k_new/v_new: (R, T, K, hd)."""
    P, two, K, page, hd = kv_pool.shape
    R, T = k_new.shape[:2]
    k_new = k_new.to(kv_pool.dtype).contiguous()
    v_new = v_new.to(kv_pool.dtype).contiguous()
    if (two != 2 or tuple(k_new.shape) != (R, T, K, hd)
            or tuple(v_new.shape) != (R, T, K, hd)):
        raise ValueError(f"{name}: k/v {tuple(k_new.shape)} / "
                         f"{tuple(v_new.shape)} do not match pool "
                         f"{tuple(kv_pool.shape)}")
    if kv_pool.dtype not in _DTYPE_CODES or hd not in BF16_HEAD_DIMS:
        raise ValueError(f"{name}: pool must be float32 or bfloat16 with "
                         f"head_dim in {BF16_HEAD_DIMS}, got {kv_pool.dtype} "
                         f"and {hd}")
    index = [starts] + ([] if n_write is None else [n_write])
    for t in index:
        _per_seq(name, t, R)
    _index(name, table, *index)
    build.require_cuda(name, kv_pool, k_new, v_new, *index)
    _table(name, kv_pool, table, R)
    build.require_aligned16(name, kv_pool, k_new, v_new)
    if R == 0 or T == 0 or table.shape[1] == 0:
        return kv_pool
    rc = build.lib().aqua_write_kv_rows(
        kv_pool.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        table.data_ptr(), starts.data_ptr(),
        None if n_write is None else n_write.data_ptr(), R, T, K, page, hd,
        table.shape[1], table.stride(0), P, kv_pool.element_size(),
        build.stream_of(kv_pool))
    build.check(name, rc)
    # row 5 of the kernel table: one count for both entry points
    build.LAUNCHES["append_kv"] += 1
    return kv_pool


def write_kv_rows(kv_pool, k_new, v_new, block_table, q_starts, n_write):
    """Write a packed step's new K/V into the pages, in place, in one
    launch: for each row r and token t < n_write[r], at position
    pos = q_starts[r] + t, pool[block_table[r, pos // page], 0|1, :,
    pos % page] = k_new[r, t] / v_new[r, t]. Positions whose page index is
    at or past the table's width, and slots outside the pool, are skipped.

    kv_pool: (P,2,K,page,hd); k_new/v_new: (R,T,K,hd); block_table: (R, W)
    int32 pool slots; q_starts/n_write: (R,) int32. Returns the pool.
    """
    if kv_pool.device.type == "cpu":
        return write_kv_rows_ref(kv_pool, k_new, v_new, block_table,
                                 q_starts, n_write)
    return _write_rows("write_kv_rows", kv_pool, k_new, v_new, block_table,
                       q_starts, n_write)


def append_kv(kv_pool, k_new, v_new, slots, offsets):
    """Append one decode token's K/V per lane into its page, in place:
    pool[slots[b], 0|1, :, offsets[b], :]. Returns the pool. On the card
    the row writer's launch with a one-entry table per lane."""
    if kv_pool.device.type == "cpu":
        return append_kv_ref(kv_pool, k_new, v_new, slots, offsets)
    B = k_new.shape[0]
    if tuple(slots.shape) != (B,) or tuple(offsets.shape) != (B,):
        raise ValueError("append_kv: slots/offsets must be (B,)")
    return _write_rows("append_kv", kv_pool, k_new[:, None], v_new[:, None],
                       slots.contiguous().view(B, 1), offsets, None)
