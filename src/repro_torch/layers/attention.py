"""GQA attention — ``repro/layers/attention.py`` for the dense family:
full-sequence attention (``attention_full``: training, and the dense
KV-cache prefill with ``return_kv``; ``attention_prefill_sharded`` and
``attention_decode_sharded`` are the dense cache's prefill and decode on
one rank of a mesh), bidirectional attention
(``attention_bidir``: the encoder-decoder's encoder self-attention and its
cross-attention), the dense cache's one-token decode
(``attention_decode``) and, against the paged KV pool, the fused serving
step's mixed attention and the per-request chunked-prefill and decode
attention. Grouped KV heads, RoPE, qk-norm (gemma3) and sliding windows;
a windowed layer's dense cache is a ring of ``min(window, seq)`` slots.

``impl='kernel'`` routes to ``kernels/flash_attention`` (training and
prefill) and ``kernels/paged_attention`` (serving): the CUDA kernels on a
CUDA device, their plain versions on the CPU; ``impl='ref'`` calls the
plain versions directly (the reference's ``'pallas'`` / ``'xla'``), under
autograd for training. The dense cache's decode is the reference's einsum
``_sdpa`` over the ring (no Pallas kernel there either). Pools and dense
caches are updated IN PLACE (the reference returns new arrays; here the
mutated pool or cache is returned for the same call shape). A logit
softcap is not ported: no config has one.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import attn_route, pspec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (
    append_kv_ref, paged_attention_pool_ref, paged_mixed_attention_pool_ref,
    paged_prefill_attention_pool_ref, write_kv_rows_ref)
from repro_torch.layers.core import (Linear, _param, apply_rope, check_impl,
                                     linear, linear_cols, linear_gathered,
                                     linear_rows, own_weight, qk_head_norm,
                                     select_update)


class KVCache(NamedTuple):
    """A layer's dense KV cache. ``k``/``v``: (B, S_slots, n_kv, hd). Full
    attention layers hold S_slots = seq; windowed layers min(window, seq),
    a ring indexed by ``pos % S_slots``."""
    k: torch.Tensor
    v: torch.Tensor


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo``; with qk-norm also ``q_norm`` and
    ``k_norm`` (hd,) scales (``1 + w``, zeros at init)."""

    def __init__(self, cfg: ModelConfig, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.attn_logit_softcap > 0:
            raise NotImplementedError(f"{cfg.name}: an attention logit "
                                      "softcap is not ported")
        d, hd, dt = cfg.d_model, cfg.resolved_head_dim, cfg.dtype()
        kw = dict(generator=generator)
        self.wq = Linear(d, cfg.n_heads * hd, dt, device, bias=cfg.qkv_bias,
                         **kw)
        self.wk = Linear(d, cfg.n_kv_heads * hd, dt, device,
                         bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, cfg.n_kv_heads * hd, dt, device,
                         bias=cfg.qkv_bias, **kw)
        self.wo = Linear(cfg.n_heads * hd, d, dt, device, **kw)
        self.q_norm = self.k_norm = None
        if cfg.use_qk_norm:
            self.q_norm = _param(torch.zeros(hd, dtype=dt, device=device))
            self.k_norm = _param(torch.zeros(hd, dtype=dt, device=device))


def _project_qkv(p: Attention, cfg: ModelConfig, x, positions):
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p.wq, x).reshape(B, T, cfg.n_heads, hd)
    k = linear(p.wk, x).reshape(B, T, cfg.n_kv_heads, hd)
    v = linear(p.wv, x).reshape(B, T, cfg.n_kv_heads, hd)
    q, k = _norm_rope(p, cfg, q, k, positions)
    return q, k, v


def _norm_rope(p: Attention, cfg: ModelConfig, q, k, positions, rank=None):
    """The q/k head norms (where the config has them), then RoPE: what
    every projection of q and k goes through, whole or a rank's (whose
    head-norm scales enter its own work: ``own_weight``)."""
    if p.q_norm is not None:
        qs, ks = ((p.q_norm, p.k_norm) if rank is None else
                  (own_weight(p, "q_norm", rank),
                   own_weight(p, "k_norm", rank)))
        q = qk_head_norm(qs, q, cfg.rmsnorm_eps)
        k = qk_head_norm(ks, k, cfg.rmsnorm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _sdpa(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """Grouped scaled-dot-product attention (the reference's ``_sdpa``):
    the scores in the compute dtype, then float32 under ``mask`` (-1e30
    where masked), the probabilities cast back before the value product.
    q: (B,T,H,hd) k/v: (B,S,K,hd) mask: broadcastable to (B,1,1,T,S)."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, T, K, H // K, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) * (1.0 / math.sqrt(hd))
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return ctx.reshape(B, T, H, hd)


def _causal_mask(q_pos, k_pos, window: int) -> torch.Tensor:
    """q_pos: (...,T) k_pos: (...,S) -> bool (...,1,1,T,S) mask."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    m &= k_pos[..., None, :] >= 0
    return m[..., None, None, :, :]


def attention_full(p: Attention, cfg: ModelConfig, x, *, window: int = 0,
                   pos_offset: int = 0, return_kv: bool = False,
                   impl: str = "kernel"):
    """Full-sequence causal attention (training and the dense cache's
    prefill): x (B,T,d) at positions ``pos_offset + [0, T)`` -> (B,T,d),
    and with ``return_kv`` also the roped k and the v (B,T,K,hd) it
    attended to. The reference's einsum ``_sdpa`` under ``_causal_mask`` is
    exactly flash attention with ``Sq == Sk`` when there is no logit
    softcap, so ``impl='kernel'`` runs the flash op (forward and backward
    kernels on CUDA) and ``impl='ref'`` its plain version under autograd."""
    check_impl(impl)
    B, T, _ = x.shape
    positions = pos_offset + torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    attend = fa_ops.flash_attention if impl == "kernel" else \
        flash_attention_ref
    ctx = attend(q, k, v, causal=True, window=window)
    out = linear(p.wo, ctx.reshape(B, T, -1))
    return (out, (k, v)) if return_kv else out


def attention_bidir(p, cfg: ModelConfig, x, *, kv=None,
                    impl: str = "kernel"):
    """Bidirectional attention (no causal mask), x (B,T,d) -> (B,T,d).
    With ``kv`` None, self-attention over x with RoPE at ``arange(T)``
    (the reference's ``encdec._bidir_attention``); else cross-attention:
    q = x @ wq, no RoPE, against ``kv`` = (k, v) (B,Sk,K,hd), the encoder
    output's projections (``encdec._cross_attend``), at any Sk. The
    reference's einsum ``_sdpa`` under an all-true mask is flash attention
    with ``causal=False``: ``impl='kernel'`` runs the flash op (the CUDA
    kernels on a card), ``impl='ref'`` its plain version."""
    check_impl(impl)
    B, T, _ = x.shape
    if kv is None:
        positions = torch.arange(T, device=x.device)[None, :]
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        q = linear(p.wq, x).reshape(B, T, cfg.n_heads, cfg.resolved_head_dim)
        k, v = kv
    attend = fa_ops.flash_attention if impl == "kernel" else \
        flash_attention_ref
    ctx = attend(q, k, v, causal=False)
    return linear(p.wo, ctx.reshape(B, T, -1))


def make_kv_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0,
                  dtype=None, device=None) -> KVCache:
    """A zeroed cache of ``min(window, seq)`` slots for a windowed layer,
    ``seq`` otherwise."""
    slots = min(window, seq) if window > 0 else seq
    dt = dtype or cfg.torch_compute_dtype()
    shape = (batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def fill_kv_cache(cache: KVCache, k, v, window: int = 0) -> KVCache:
    """Write prefill K/V (B,T,K,hd) into slots [0, T) of ``cache`` in
    place. A windowed layer whose T exceeds its slots keeps the last
    ``slots`` rows, rolled by ``(T - slots) % slots`` so that slot j holds
    the position p with ``p % slots == j``."""
    T, slots = k.shape[1], cache.k.shape[1]
    if window > 0 and T > slots:
        roll = (T - slots) % slots
        cache.k.copy_(torch.roll(k[:, T - slots:], roll, dims=1))
        cache.v.copy_(torch.roll(v[:, T - slots:], roll, dims=1))
        return cache
    if T > slots:
        raise ValueError(f"a {T}-token prefill does not fit {slots} slots")
    cache.k[:, :T] = k.to(cache.k.dtype)
    cache.v[:, :T] = v.to(cache.v.dtype)
    return cache


def attention_decode(p: Attention, cfg: ModelConfig, x, cache: KVCache, pos,
                     *, window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode against a dense cache. x: (B,1,d); pos: (B,) int
    positions of the new tokens, on x's device. The new K/V goes into slot
    ``pos % slots`` of a ring (a windowed layer's cache of at most
    ``window`` slots), slot ``pos`` otherwise, in place; then every lane
    attends over all slots, a ring's slot j standing for position
    ``p - ((p - j) mod slots)``, under the causal (and window) mask.
    Returns (out (B,1,d), cache)."""
    B = x.shape[0]
    positions = pos.reshape(-1, 1).expand(B, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    ctx = _decode_attend(cfg, q, k_new, v_new, cache, positions, window)
    return linear(p.wo, ctx.reshape(B, 1, -1)), cache


def _decode_attend(cfg: ModelConfig, q, k_new, v_new, cache: KVCache,
                   positions, window: int) -> torch.Tensor:
    """``attention_decode`` after the projections: the new K/V into its
    slot, then every lane over all slots -> ctx (B,1,H,hd)."""
    B = q.shape[0]
    slots = cache.k.shape[1]
    is_ring = 0 < window and slots <= window
    p_ = positions[:, :1]
    slot = p_[:, 0] % slots if is_ring else p_[:, 0]
    select_update(cache.k, k_new[:, 0], slot)
    select_update(cache.v, v_new[:, 0], slot)
    j = torch.arange(slots, device=q.device)[None, :]
    k_pos = p_ - torch.remainder(p_ - j, slots) if is_ring \
        else j.expand(B, slots)
    return _sdpa(cfg, q, cache.k, cache.v, _causal_mask(p_, k_pos, window))


# ---------------------------------------------------------------------------
# The partitioned step (a rank's shards; ``distributed/partition.py``)
# ---------------------------------------------------------------------------
def _heads_qkv(p: Attention, cfg: ModelConfig, x, positions, rank):
    """The rank's whole heads of q, k and v (the head route: each
    projection's columns are whole heads), normed and roped as
    ``_project_qkv`` does -> (q, k, v, (lo, hi) q's global features)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q, lo, hi = linear_cols(p.wq, x, rank)
    k = linear_cols(p.wk, x, rank)[0].reshape(B, T, -1, hd)
    v = linear_cols(p.wv, x, rank)[0].reshape(B, T, -1, hd)
    q, k = _norm_rope(p, cfg, q.reshape(B, T, -1, hd), k, positions, rank)
    return q, k, v, (lo, hi)


def _gathered_qkv(p: Attention, x, rank, with_q: bool):
    """The projections' outputs with every column, in ONE all-gather over
    ``model`` (``linear_gathered``) -> [q if with_q], k, v, each (B, T,
    features)."""
    projs = ([p.wq] if with_q else []) + [p.wk, p.wv]
    return linear_gathered([(w, x) for w in projs], rank)


def _covered_heads(cfg: ModelConfig, p: Attention, rank):
    """The global features [flo, fhi) of ``wo``'s rows the rank holds and
    the heads [h0, h1) they touch."""
    hd = cfg.resolved_head_dim
    flo, fhi = rank.range(pspec(p.wo, "w")[0], p.wo.w.shape[0])
    return flo, fhi, flo // hd, -(-fhi // hd)


def _kv_for_heads(k, v, h0: int, h1: int, group: int):
    """The kv heads that q heads [h0, h1) read (head h reads h // group):
    a slice where each kv head serves an equal run of them, else one
    kv row a q head."""
    kv = [h // group for h in range(h0, h1)]
    lo, n = kv[0], kv[-1] + 1 - kv[0]
    run = (h1 - h0) // n
    if run * n == h1 - h0 and kv == [lo + j // run for j in range(h1 - h0)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.tensor(kv, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _slot_range(cache: KVCache, spec, rank) -> Tuple[int, int]:
    """The rank's first global slot and the layer's global slot count."""
    local = cache.k.shape[1]
    lo, _ = rank.range(spec[2], local)
    return lo, local * rank.index(spec[2])[1]


def _fill_owned_slots(cache: KVCache, k, v, window: int, spec, rank):
    """``fill_kv_cache`` on a rank that holds slots [lo, lo + local) of the
    layer's: each slot takes the position ``fill_kv_cache`` puts there
    (a ring's slot j the p of the last ``slots`` with p % slots == j)."""
    local = cache.k.shape[1]
    lo, slots = _slot_range(cache, spec, rank)
    T = k.shape[1]
    if window > 0 and T > slots:
        j = torch.arange(lo, lo + local, device=k.device)
        src = T - slots + torch.remainder(j - (T - slots), slots)
        cache.k.copy_(k.index_select(1, src))
        cache.v.copy_(v.index_select(1, src))
        return
    if T > slots:
        raise ValueError(f"a {T}-token prefill does not fit {slots} slots")
    n = min(lo + local, T) - lo
    if n > 0:
        cache.k[:, :n] = k[:, lo:lo + n].to(cache.k.dtype)
        cache.v[:, :n] = v[:, lo:lo + n].to(cache.v.dtype)


def attention_prefill_sharded(p: Attention, cfg: ModelConfig, x,
                              cache: KVCache, *, window: int, spec, rank,
                              impl: str = "kernel") -> torch.Tensor:
    """``attention_full(return_kv=True)`` + ``fill_kv_cache`` on a rank:
    x (B,T,d) replicated over ``model``, ``cache`` the rank's block of the
    layer's cache under ``spec`` (its route, ``partition.attn_route``).

    Heads: the rank's heads through the flash op, its kv heads into its
    cache, its rows of ``wo`` and one all-reduce. Sequence (or
    replicated): k and v (and q where the rank's ``wo`` rows are not its
    own q columns) all-gathered in one collective; the rank runs the
    flash op over the q heads its ``wo`` rows touch (its own heads where
    the q heads divide the axis; else at most a head more on each side),
    keeps its features, writes its slot range of the cache and applies its
    rows of ``wo``, all-reduced."""
    check_impl(impl)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :]
    attend = fa_ops.flash_attention if impl == "kernel" else \
        flash_attention_ref
    if attn_route(spec) == "heads":
        q, k, v, (lo, hi) = _heads_qkv(p, cfg, x, positions, rank)
        ctx = attend(q, k, v, causal=True, window=window)
        fill_kv_cache(cache, k, v, window)
        return linear_rows(p.wo, ctx.reshape(B, T, -1), lo, hi, rank)
    out, k, v = _covered_attention(p, cfg, x, rank, causal=True,
                                   window=window, impl=impl)
    _fill_owned_slots(cache, k, v, window, spec, rank)
    return out


def _covered_attention(p, cfg: ModelConfig, x, rank, *, kv=None,
                       causal: bool, window: int = 0, impl: str = "kernel",
                       scatter=None):
    """The flash op over the q heads the rank's ``wo`` rows touch (its own
    heads where the q heads divide the axis; else at most a head more on
    each side), against every kv head they read: self-attention with
    ``kv`` None (k and v, and q where the rank's ``wo`` rows are not its
    own q columns, all-gathered in one collective; norms and RoPE at
    ``arange(T)``), else cross-attention over ``kv`` = (k, v) (B,Sk,K,hd)
    whole (q alone, no RoPE, at any Sk). The rank's features through its
    rows of ``wo``, all-reduced (reduce-scattered along ``scatter``
    under sequence parallelism). -> (out (B,T,d), k, v)"""
    B, T, _ = x.shape
    hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    flo, fhi, h0, h1 = _covered_heads(cfg, p, rank)
    qlo, qhi = rank.range(pspec(p.wq, "w")[1], p.wq.w.shape[1])
    own_q = (qlo, qhi) == (h0 * hd, h1 * hd)
    if own_q:
        # q before k and v, as ``_project_qkv`` makes them: at a group of
        # one their gradients then reach x in the unpartitioned order
        q = linear_cols(p.wq, x, rank)[0].reshape(B, T, -1, hd)
    outs = linear_gathered([(w, x) for w in ([] if own_q else [p.wq])
                            + ([p.wk, p.wv] if kv is None else [])], rank)
    if not own_q:
        q = outs.pop(0).reshape(B, T, H, hd)[:, :, h0:h1]
    if kv is None:
        k, v = (t.reshape(B, T, K, hd) for t in outs)
        q, k = _norm_rope(p, cfg, q, k,
                          torch.arange(T, device=x.device)[None, :], rank)
    else:
        k, v = kv
    kc, vc = _kv_for_heads(k, v, h0, h1, H // K)
    attend = fa_ops.flash_attention if impl == "kernel" else \
        flash_attention_ref
    ctx = attend(q.contiguous(), kc.contiguous(), vc.contiguous(),
                 causal=causal, window=window)
    feats = ctx.reshape(B, T, -1)[..., flo - h0 * hd:fhi - h0 * hd]
    return linear_rows(p.wo, feats, flo, fhi, rank, scatter), k, v


def attention_train_sharded(p: Attention, cfg: ModelConfig, x, rank, *,
                            window: int, sp: bool,
                            impl: str = "kernel") -> torch.Tensor:
    """``attention_full`` in the partitioned train step: x (B,T,d), the
    rank's block of the positions (B, T / model, d) under sequence
    parallelism (``sp``), all-gathered along T, else the stream,
    replicated over ``model``, entering the rank's work. Where the kv
    heads divide ``model`` the rank's heads (``_heads_qkv``, the serving
    prefill's head route); else the q heads its ``wo`` rows touch against
    every kv head they read (``_covered_attention``). Both run the flash
    op, forward and backward, under the layer's window; ``wo``'s partial
    sums are all-reduced, or reduce-scattered along T under ``sp``."""
    check_impl(impl)
    x = rank.all_gather(x, 1, "model") if sp else rank.enter(x)
    B, T, _ = x.shape
    scatter = 1 if sp else None
    if cfg.n_kv_heads % rank.model_n:
        return _covered_attention(p, cfg, x, rank, causal=True,
                                  window=window, impl=impl,
                                  scatter=scatter)[0]
    positions = torch.arange(T, device=x.device)[None, :]
    attend = fa_ops.flash_attention if impl == "kernel" else \
        flash_attention_ref
    q, k, v, (lo, hi) = _heads_qkv(p, cfg, x, positions, rank)
    ctx = attend(q, k, v, causal=True, window=window)
    return linear_rows(p.wo, ctx.reshape(B, T, -1), lo, hi, rank, scatter)


def attention_bidir_sharded(p, cfg: ModelConfig, x, rank, *, kv=None,
                            impl: str = "kernel") -> torch.Tensor:
    """``attention_bidir`` on a rank (x (B,T,d) replicated over
    ``model``, entering the rank's work; ``kv`` the cross-attention's
    whole (k, v)): the flash op at ``causal=False`` over the q heads the
    rank's ``wo`` rows touch (``_covered_attention``), forward and
    backward."""
    check_impl(impl)
    return _covered_attention(p, cfg, rank.enter(x), rank, kv=kv,
                              causal=False, impl=impl)[0]


def _partial_sdpa(q, k, v, mask):
    """``_sdpa`` over a rank's slots without the normalisation: -> (o
    (B,T,H,hd) float32, the un-normalised value product of the
    probabilities cast to the compute dtype; m, l (B,T,H) float32: each
    row's max score and its sum of exp(score - m))."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, T, K, H // K, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) * (1.0 / math.sqrt(hd))
    scores = torch.where(mask, scores.float(), -1e30)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    o = torch.einsum("bkgts,bskd->btkgd", e.to(q.dtype), v)

    def rows(t):                              # (B,K,G,T) -> (B,T,H)
        return t.permute(0, 3, 1, 2).reshape(B, T, H)
    return o.reshape(B, T, H, hd).float(), rows(m[..., 0]), rows(e.sum(-1))


def _merge_partials(o, m, l, rank, dtype) -> torch.Tensor:
    """Flash-decoding's merge over ``model``: every rank's (o, m, l) in ONE
    all-gather, then sum_r o_r e^(m_r - M) / sum_r l_r e^(m_r - M)."""
    hd = o.shape[-1]
    packed = torch.cat([o, m[..., None], l[..., None]], -1)
    parts = rank.all_gather(packed, 0, "model").reshape(
        rank.model_n, *packed.shape)
    w = torch.exp(parts[..., hd] - parts[..., hd].amax(0))
    num = (w[..., None] * parts[..., :hd]).sum(0)
    return (num / (w * parts[..., hd + 1]).sum(0)[..., None]).to(dtype)


def attention_decode_sharded(p: Attention, cfg: ModelConfig, x,
                             cache: KVCache, pos, *, window: int, spec,
                             rank) -> torch.Tensor:
    """``attention_decode`` on a rank (x (B,1,d), ``cache`` the rank's
    block under ``spec``), the cache updated in place.

    Heads: the rank's heads over its kv heads' cache, its rows of ``wo``,
    one all-reduce. Sequence: q, k and v gathered in one all-gather; the
    new K/V written only by the rank whose slot range holds the token's
    slot (``pos % slots`` in a ring); every head attends over the rank's
    slots, the partial outputs, row maxima and row sums merged over
    ``model`` (``_merge_partials``); the rank's features through its rows
    of ``wo``, all-reduced. Replicated: every slot on every rank."""
    B = x.shape[0]
    positions = pos.reshape(-1, 1).expand(B, 1)
    route = attn_route(spec)
    if route == "heads":
        q, k_new, v_new, (lo, hi) = _heads_qkv(p, cfg, x, positions, rank)
        ctx = _decode_attend(cfg, q, k_new, v_new, cache, positions, window)
        return linear_rows(p.wo, ctx.reshape(B, 1, -1), lo, hi, rank)
    hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k_new, v_new = (t.reshape(B, 1, -1, hd)
                       for t in _gathered_qkv(p, x, rank, with_q=True))
    q, k_new = _norm_rope(p, cfg, q, k_new, positions)
    flo, fhi, _, _ = _covered_heads(cfg, p, rank)
    if route == "replicated":
        ctx = _decode_attend(cfg, q, k_new, v_new, cache, positions, window)
    else:
        local = cache.k.shape[1]
        lo, slots = _slot_range(cache, spec, rank)
        is_ring = 0 < window and slots <= window
        p_ = positions[:, :1]
        slot = (p_[:, 0] % slots if is_ring else p_[:, 0]) - lo
        own = (slot >= 0) & (slot < local)
        slot = slot.clamp(0, local - 1)
        rows = torch.arange(B, device=x.device)
        for buf, new in ((cache.k, k_new), (cache.v, v_new)):
            buf[rows, slot] = torch.where(own[:, None, None],
                                          new[:, 0].to(buf.dtype),
                                          buf[rows, slot])
        j = lo + torch.arange(local, device=x.device)[None, :]
        k_pos = p_ - torch.remainder(p_ - j, slots) if is_ring \
            else j.expand(B, local)
        o, m, l = _partial_sdpa(q, cache.k, cache.v,
                                _causal_mask(p_, k_pos, window))
        ctx = _merge_partials(o, m, l, rank, q.dtype)
    feats = ctx.reshape(B, 1, H * hd)[..., flo:fhi]
    return linear_rows(p.wo, feats, flo, fhi, rank)


def cross_decode_sharded(p, cfg: ModelConfig, x, cache: KVCache, *, spec,
                         rank, impl: str = "kernel") -> torch.Tensor:
    """``attention_bidir(kv=cache)`` of one token a lane on a rank:
    ``cache`` the rank's block of a layer's cross K/V under ``spec`` (the
    stacked leaf's). Heads: the rank's heads over its kv heads, its rows
    of ``wo``. Replicated: the q heads its ``wo`` rows touch over every
    kv head (``_covered_attention``). Sequence: every head over the
    rank's slots, the partials merged over ``model``
    (``_merge_partials``), the rank's features through its rows of
    ``wo``. Each route all-reduces after ``wo``."""
    check_impl(impl)
    B = x.shape[0]
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    k, v = cache.k.to(x.dtype), cache.v.to(x.dtype)
    route = attn_route(spec)
    if route == "replicated":
        return attention_bidir_sharded(p, cfg, x, rank, kv=(k, v),
                                       impl=impl)
    if route == "heads":
        q, lo, hi = linear_cols(p.wq, x, rank)
        attend = fa_ops.flash_attention if impl == "kernel" else \
            flash_attention_ref
        ctx = attend(q.reshape(B, 1, -1, hd), k, v, causal=False)
        return linear_rows(p.wo, ctx.reshape(B, 1, -1), lo, hi, rank)
    q = linear_gathered([(p.wq, x)], rank)[0].reshape(B, 1, H, hd)
    every = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device)
    ctx = _merge_partials(*_partial_sdpa(q, k, v, every), rank, q.dtype)
    flo, fhi, _, _ = _covered_heads(cfg, p, rank)
    return linear_rows(p.wo, ctx.reshape(B, 1, H * hd)[..., flo:fhi], flo,
                       fhi, rank)


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


def step_meta(q_starts, n_reals, n_decode: int, Tc: int, device,
              page: Optional[int] = None) -> dict:
    """Device copies of a packed step's per-row metadata (int32) and the
    token positions, made once per step and shared by every layer.
    ``n_write``, the tokens each row writes into its pages: 1 for a decode
    lane (an idle one writes scratch), Tc for a chunk row with real tokens
    (its padding too, as the reference's page window does), 0 for a
    bucket-pad row.

    With ``page``, a chunk row writes only the tokens that land in its own
    pages, the ceil((q_start + n_real) / page) pages from position 0 that
    the runtime gives it; past them its table holds the scratch padding,
    which then keeps what it held (``lm._own_pages_only`` says when)."""
    qs_np = np.asarray(q_starts, np.int32).reshape(-1)
    nr_np = np.asarray(n_reals, np.int32).reshape(-1)
    R = qs_np.shape[0]
    is_dec_np = np.arange(R) < n_decode
    n_write = np.where(is_dec_np, 1, np.where(nr_np > 0, Tc, 0))
    if page:
        own = -(-(qs_np.astype(np.int64) + nr_np) // page) * page - qs_np
        n_write = np.where(is_dec_np, n_write, np.minimum(n_write, own))
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
