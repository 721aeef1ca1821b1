"""GQA attention — ``repro/layers/attention.py`` for the dense family:
full-sequence training attention (``attention_full``) and, against the
paged KV pool, the fused serving step's mixed attention and the
per-request chunked-prefill and decode attention.

``impl='kernel'`` routes to ``kernels/flash_attention`` (training) and
``kernels/paged_attention`` (serving): the CUDA kernels on a CUDA device,
their plain versions on the CPU; ``impl='ref'`` calls the plain versions
directly (the reference's ``'pallas'`` / ``'xla'``), under autograd for
training. Pools are updated IN PLACE (the reference returns new arrays;
here the mutated pool is returned for the same call shape). The dense
KV-cache prefill (``return_kv``) is not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (
    append_kv_ref, paged_attention_pool_ref, paged_mixed_attention_pool_ref,
    paged_prefill_attention_pool_ref, write_kv_rows_ref)
from repro_torch.layers.core import Linear, apply_rope, check_impl, linear


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.use_qk_norm or cfg.attn_logit_softcap > 0:
            raise NotImplementedError(f"{cfg.name}: qk-norm / logit softcap "
                                      "attention is not ported")
        d, hd, dt = cfg.d_model, cfg.resolved_head_dim, cfg.dtype()
        kw = dict(generator=generator)
        self.wq = Linear(d, cfg.n_heads * hd, dt, device, bias=cfg.qkv_bias,
                         **kw)
        self.wk = Linear(d, cfg.n_kv_heads * hd, dt, device,
                         bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, cfg.n_kv_heads * hd, dt, device,
                         bias=cfg.qkv_bias, **kw)
        self.wo = Linear(cfg.n_heads * hd, d, dt, device, **kw)


def _project_qkv(p: Attention, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p.wq, x).reshape(B, T, cfg.n_heads, hd)
    k = linear(p.wk, x).reshape(B, T, cfg.n_kv_heads, hd)
    v = linear(p.wv, x).reshape(B, T, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_full(p: Attention, cfg: ModelConfig, x, *, window: int = 0,
                   pos_offset: int = 0, impl: str = "kernel"):
    """Training full-sequence causal attention: x (B,T,d) at positions
    ``pos_offset + [0, T)`` -> (B,T,d). The reference's einsum ``_sdpa``
    under ``_causal_mask`` is exactly flash attention with ``Sq == Sk`` when
    there is no logit softcap, so ``impl='kernel'`` runs the flash op
    (forward and backward kernels on CUDA) and ``impl='ref'`` its plain
    version under autograd."""
    check_impl(impl)
    B, T, _ = x.shape
    positions = pos_offset + torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    attend = fa_ops.flash_attention if impl == "kernel" else \
        flash_attention_ref
    ctx = attend(q, k, v, causal=True, window=window)
    return linear(p.wo, ctx.reshape(B, T, -1))


def attention_prefill_chunk(p: Attention, cfg: ModelConfig, x, kv_pool,
                            block_table, q_start: int, *,
                            read_pps: Optional[int] = None,
                            impl: str = "kernel", meta=None):
    """Chunked prefill attention for ONE request.

    x: (1,Tc,d) — one chunk of the prompt at absolute positions
    ``q_start + [0, Tc)``; kv_pool: (P,2,K,page,hd); block_table: (pps_pad,)
    int32 LOCAL slots of the request's pages from position 0, scratch-padded,
    on the pool's device; q_start: host int. ``meta`` optionally carries the
    device copies ``step_meta`` makes once per chunk (shared by every
    layer).

    The chunk's K/V is written into its pages first (one row-writer
    launch), then the chunk attends to every page written so far (causal
    within the chunk, bucket padding included) in one
    ``paged_prefill_attention_pool`` launch.
    ``read_pps`` bounds the attention sweep to the pages a request can own:
    the table's tail entries always point at scratch, which takes the
    writes of the chunk's bucket padding past the request's pages. Returns
    (out (1,Tc,d), pool).
    """
    check_impl(impl)
    B, Tc, _ = x.shape
    if B != 1:
        raise ValueError(f"chunked prefill is per-request, got {B} rows")
    if meta is None:
        meta = step_meta([q_start], [Tc], 0, Tc, x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, meta["positions"])
    write = pa_ops.write_kv_rows if impl == "kernel" else write_kv_rows_ref
    write(kv_pool, k_new, v_new, block_table[None], meta["q_starts"],
          meta["n_write"])
    bt = block_table[None, :read_pps]
    if impl == "kernel":
        ctx = pa_ops.paged_prefill_attention_pool(q, kv_pool, bt,
                                                  meta["q_starts"])
    else:
        ctx = paged_prefill_attention_pool_ref(q, kv_pool, bt,
                                               meta["q_starts"])
    out = linear(p.wo, ctx.reshape(B, Tc, -1))
    return out, kv_pool


def attention_decode_paged(p: Attention, cfg: ModelConfig, x, kv_pool,
                           block_table, pos, *, impl: str = "kernel",
                           meta=None):
    """One-token decode for a batch of lanes against the page pool.

    x: (B,1,d); kv_pool: (P,2,K,page,hd); block_table: (B,pps) int32 LOCAL
    slots on the pool's device (idle lanes point at scratch); pos: (B,) host
    positions of the new tokens. ``meta`` optionally carries the device
    copies ``decode_meta`` makes once per step.

    Each lane's K/V is appended in place through the page-append writer,
    then every lane attends to its keys at positions <= pos in one
    ``paged_attention_pool`` launch over the whole table. Returns
    (out (B,1,d), pool).
    """
    check_impl(impl)
    B = x.shape[0]
    page = kv_pool.shape[3]
    if meta is None:
        meta = decode_meta(pos, x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, meta["positions"])
    pos_d = meta["q_starts"]
    slot = torch.gather(block_table, 1, (pos_d // page)[:, None].long())[:, 0]
    off = pos_d % page
    qd, kd, vd = q[:, 0], k_new[:, 0], v_new[:, 0]
    if impl == "kernel":
        pa_ops.append_kv(kv_pool, kd, vd, slot.contiguous(), off)
        ctx = pa_ops.paged_attention_pool(qd, kv_pool, block_table,
                                          meta["lengths"])
    else:
        append_kv_ref(kv_pool, kd, vd, slot, off)
        ctx = paged_attention_pool_ref(qd, kv_pool, block_table,
                                       meta["lengths"])
    out = linear(p.wo, ctx.reshape(B, 1, -1))
    return out, kv_pool


def attention_mixed_paged(p: Attention, cfg: ModelConfig, x, kv_pool,
                          block_table, q_starts, n_reals, *, n_decode: int,
                          read_pps: Optional[int] = None,
                          impl: str = "kernel", meta=None):
    """Fused mixed-mode attention: decode lanes AND prefill chunk rows of a
    packed engine step against the pool, in ONE kernel launch.

    x: (R,Tc,d) packed rows — rows ``[:n_decode]`` are decode lanes (their
    single real token at column 0, absolute position ``q_starts[r]``), the
    rest prefill chunk rows (``n_reals[r]`` real tokens from ``q_starts[r]``;
    ``n_real == 0`` marks a bucket-pad row pointing at the scratch page).
    kv_pool: (P,2,K,page,hd); block_table: (R, pps_pad) int32 LOCAL slots
    from position 0, scratch-padded, on the pool's device; q_starts /
    n_reals: (R,) host integer arrays. ``meta`` optionally carries the
    device copies ``step_meta`` makes once per step (shared by every
    layer).

    Every row's new K/V goes into its pages in one row-writer launch
    (decode lanes 1 token, chunk rows their Tc, bucket-pad rows none), then
    every row attends in one ``paged_mixed_attention_pool`` launch.
    Returns (out (R,Tc,d), pool).
    """
    check_impl(impl)
    R, Tc, _ = x.shape
    if meta is None:
        meta = step_meta(q_starts, n_reals, n_decode, Tc, x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, meta["positions"])

    write = pa_ops.write_kv_rows if impl == "kernel" else write_kv_rows_ref
    write(kv_pool, k_new, v_new, block_table, meta["q_starts"],
          meta["n_write"])
    bt = block_table[:, :read_pps]
    args = (q, kv_pool, bt, meta["q_starts"], meta["n_reals"],
            meta["is_decode"])
    if impl == "kernel":
        ctx = pa_ops.paged_mixed_attention_pool(*args)
    else:
        ctx = paged_mixed_attention_pool_ref(*args)
    out = linear(p.wo, ctx.reshape(R, Tc, -1))
    return out, kv_pool


def step_meta(q_starts, n_reals, n_decode: int, Tc: int, device) -> dict:
    """Device copies of a packed step's per-row metadata (int32) and the
    token positions, made once per step and shared by every layer.
    ``n_write``, the tokens each row writes into its pages: 1 for a decode
    lane (an idle one writes scratch), Tc for a chunk row with real tokens
    (its padding too, as the reference's page window does), 0 for a
    bucket-pad row."""
    qs_np = np.asarray(q_starts, np.int32).reshape(-1)
    nr_np = np.asarray(n_reals, np.int32).reshape(-1)
    R = qs_np.shape[0]
    is_dec_np = np.arange(R) < n_decode
    n_write = np.where(is_dec_np, 1, np.where(nr_np > 0, Tc, 0))
    qs = torch.as_tensor(qs_np).to(device)
    nr = torch.as_tensor(nr_np).to(device)
    is_dec = torch.as_tensor(is_dec_np.astype(np.int32)).to(device)
    positions = qs[:, None] + torch.arange(Tc, dtype=torch.int32,
                                           device=device)[None, :]
    return {"q_starts": qs, "n_reals": nr, "is_decode": is_dec,
            "n_write": torch.as_tensor(n_write.astype(np.int32)).to(device),
            "positions": positions}


def decode_meta(pos, device) -> dict:
    """Device copies of a decode step's lane positions (int32), their token
    positions (B,1) and lengths pos + 1, made once per step and shared by
    every layer."""
    meta = step_meta(pos, np.ones(len(pos), np.int32), len(pos), 1, device)
    meta["lengths"] = meta["q_starts"] + 1
    return meta
