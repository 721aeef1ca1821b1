"""Plain PyTorch versions of the RWKV-6 WKV recurrence: the CPU path of
``ops.py`` and the oracles the CUDA kernel is held against.

Per head (head_dim hd, state S in R^{hd x hd}):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t <= 0)

``wkv6_ref`` is the sequential scan and ``wkv6_chunked`` the chunked form of
``repro/layers/rwkv6.py`` (the algorithm of the Pallas kernel); ``wkv6_plain``
applies the reference layer's dispatch between them.
"""
from __future__ import annotations

import torch

WKV_CHUNK = 32


def wkv6_ref(r, k, v, w, u, state):
    """r,k,v,w: (B,T,H,hd); u: (H,hd); state: (B,H,hd,hd) -> (y in r's
    dtype, state' float32). Sequential over T, in float32."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhi,bhj->bhij", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf * kv))
        S = torch.exp(wf[:, t])[..., None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def wkv6_chunked(r, k, v, w, u, state, chunk: int = WKV_CHUNK):
    """The chunked form, in float32: per chunk of C tokens a (C,hd)x(hd,hd)
    state product, an exact pairwise (C,C,hd) intra-chunk decay tensor, a
    (C,C)x(C,hd) combine and a (hd,C)x(C,hd) state update. Every
    materialised exponent is <= 0 (the reference's jnp form multiplies the
    upper triangle's positive exponents by zero after exp, which turns an
    overflow into NaN; the Pallas kernel masks with ``where``, as here).
    Falls back to the scan when no chunk length divides T, as the reference
    does."""
    B, T, H, hd = r.shape
    chunk = min(chunk, T)
    if T % chunk != 0:
        return wkv6_ref(r, k, v, w, u, state)
    nt = T // chunk

    def fold(x):
        return (x.float().permute(0, 2, 1, 3)
                .reshape(B * H, nt, chunk, hd))

    rf, kf, vf, wf = fold(r), fold(k), fold(v), fold(w)
    uf = u.float()[None].expand(B, H, hd).reshape(B * H, 1, hd)
    S = state.float().reshape(B * H, hd, hd)
    ti = torch.arange(chunk, device=r.device)
    lower = (ti[None, :] < ti[:, None])[None, :, :, None]    # tau < t
    ys = []
    for c in range(nt):
        rc, kc, vc, wc = rf[:, c], kf[:, c], vf[:, c], wf[:, c]  # (BH,C,hd)
        lw = torch.cumsum(wc, dim=1)
        lw_prev = lw - wc
        y_cross = torch.einsum("bch,bhj->bcj", rc * torch.exp(lw_prev), S)
        # exponents lw_prev[t] - lw[tau] <= 0 for tau < t; the pairs
        # tau >= t are set to -inf BEFORE exp, so no positive exponent is
        # ever materialised (strong decays would overflow to inf * 0)
        ldiff = (lw_prev[:, :, None, :] - lw[:, None, :, :]).masked_fill(
            ~lower, float("-inf"))                            # (BH,C,C,hd)
        A = torch.sum((rc[:, :, None] * kc[:, None]) * torch.exp(ldiff), -1)
        diag = torch.sum(rc * uf * kc, -1, keepdim=True)
        ys.append(y_cross + torch.einsum("bct,bth->bch", A, vc) + diag * vc)
        k_tail = kc * torch.exp(lw[:, -1:] - lw)
        S = (torch.exp(lw[:, -1])[..., None] * S
             + torch.einsum("bch,bcj->bhj", k_tail, vc))
    y = torch.stack(ys, dim=1).reshape(B, H, T, hd).permute(0, 2, 1, 3)
    return y.to(r.dtype), S.reshape(B, H, hd, hd)


def wkv6_plain(r, k, v, w, u, state):
    """The reference layer's dispatch (``repro/layers/rwkv6.py``
    ``rwkv_time_mix`` without the kernel): the chunked form when
    ``T >= 2 * WKV_CHUNK`` and ``T % WKV_CHUNK == 0``, the scan
    otherwise."""
    T = r.shape[1]
    if T >= 2 * WKV_CHUNK and T % WKV_CHUNK == 0:
        return wkv6_chunked(r, k, v, w, u, state)
    return wkv6_ref(r, k, v, w, u, state)
