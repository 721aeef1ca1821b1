"""Plain PyTorch versions of blocked causal/windowed GQA flash attention:
the CPU path of ``ops.py`` and the oracles the CUDA kernels are held
against.

``flash_attention_ref`` is ``repro/kernels/flash_attention/ref.py``: queries
right-aligned against the keys (``q_pos = arange(Sq) + Sk - Sq``), masked
scores set to ``-1e30`` (not ``-inf``), the softmax in float32, the
probabilities rounded to the input type before the value product. A row
that sees no key (causal with ``Sq > Sk``) therefore gets the mean of V
over all ``Sk`` keys, not zeros. Scores are taken in float32 (the reference
takes the product in the input type and then casts; the two agree in
float32).

``flash_attention_fwd_ref`` also returns the row log-sum-exp, and
``flash_attention_bwd_ref`` is the explicit backward formula the kernels
compute from it:

    P  = exp(S - lse)          (1 / Sk on a row that sees no key)
    dV = P^T dO                D = rowsum(dO * O)
    dS = P * (dO V^T - D)      (0 where masked: the mask is a constant)
    dQ = scale * dS K          dK = scale * dS^T Q

with dK and dV summed over the G query heads of each KV head. Arithmetic is
float32 (float64 for float64 inputs, so ``gradcheck`` can run on it).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def attention_mask(Sq: int, Sk: int, causal: bool, window: int,
                   device) -> torch.Tensor:
    """(Sq, Sk) bool: which key each right-aligned query sees."""
    q_pos = torch.arange(Sq, device=device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def _grouped_scores(q, k, scale, mask):
    """Masked scores (B, K, G, Sq, Sk) in the work dtype."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    dt = _work_dtype(q)
    qg = q.to(dt).reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.to(dt)) * scale
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd); H % K == 0 ->
    (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    s = _grouped_scores(q, k, _scale(q, scale), mask)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(q.dtype))
    return out.reshape(B, Sq, H, hd).contiguous()


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            scale: float | None = None):
    """The forward with its row log-sum-exp: -> (o (B, Sq, H, hd) in q's
    dtype, lse (B, H, Sq) in the work dtype). Outputs are contiguous, as
    the kernels take them."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    s = _grouped_scores(q, k, _scale(q, scale), mask)
    lse = torch.logsumexp(s, dim=-1)                       # (B, K, G, Sq)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgts,bskd->btkgd", probs, v.to(q.dtype))
    return o.reshape(B, Sq, H, hd).contiguous(), lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, scale: float | None = None):
    """Gradients of ``flash_attention_ref`` from the saved output and row
    log-sum-exp: -> (dq, dk, dv) in the dtypes of q, k, v."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    sc = _scale(q, scale)
    dt = _work_dtype(q)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    s = _grouped_scores(q, k, sc, mask)
    p = torch.exp(s - lse.to(dt).reshape(B, K, G, Sq)[..., None])
    # a row that sees no key: every score is -1e30, the softmax uniform
    # (its lse, -1e30 + log Sk, rounds to -1e30 and cannot say so)
    empty = ~mask.any(dim=-1)
    p = torch.where(empty[:, None], torch.full_like(p, 1.0 / Sk), p)
    dog = do.to(dt).reshape(B, Sq, K, G, hd)
    dv = torch.einsum("bkgts,btkgd->bskd", p, dog)
    dp = torch.einsum("btkgd,bskd->bkgts", dog, v.to(dt))
    D = (do.to(dt) * o.to(dt)).sum(-1)                     # (B, Sq, H)
    Dg = D.reshape(B, Sq, K, G).permute(0, 2, 3, 1)[..., None]
    ds = torch.where(mask, p * (dp - Dg), torch.zeros_like(p))
    qg = q.to(dt).reshape(B, Sq, K, G, hd)
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.to(dt)) * sc
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qg) * sc
    return (dq.reshape(B, Sq, H, hd).to(q.dtype).contiguous(),
            dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous())
