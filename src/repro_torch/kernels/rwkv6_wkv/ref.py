"""Plain PyTorch versions of the RWKV-6 WKV recurrence: the CPU path of
``ops.py`` and the oracles the CUDA kernel is held against.

Per head (head_dim hd, state S in R^{hd x hd}):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t <= 0)

``wkv6_ref`` is the sequential scan and ``wkv6_chunked`` the chunked form of
``repro/layers/rwkv6.py`` (the algorithm of the Pallas kernel); ``wkv6_plain``
applies the reference layer's dispatch between them.

The forward's plain versions also take a rectangular state: r, k, w of
shape (B,T,H,K), v (B,T,H,V), u (H,K) and the state (B,H,K,V) with K <= V.
Each term of the recurrence is a sum over the key dims i (y_t = sum_i
r_t[i] (S[i] + u[i] k_t[i] v_t)) and row i of the state is updated from key
dim i alone, so a key slice's call gives that slice's share of y, exactly,
and its rows of the new state: the partitioned step's sum of y over the
slices is the whole y.

The key-slice kernels' passes have twins of their own, which compose to
the functions above: ``wkv6_keyslice_sums_plain`` (each 32-token chunk's
decay, its recurrence from a zero state and the reverse recurrence of the
state gradient from zero), ``wkv6_keyslice_scan_plain`` (the chunk states
from those) and ``wkv6_keyslice_chunk_plain`` (y of every chunk from its
entry state); the backward's chunk pass is ``wkv6_bwd_chunk_plain``.
"""
from __future__ import annotations

import torch

WKV_CHUNK = 32


def _acc_dtype(*tensors) -> torch.dtype:
    """float32, or float64 when an input is float64 (``gradcheck``)."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def wkv6_ref(r, k, v, w, u, state):
    """r,k,w: (B,T,H,K); v: (B,T,H,V); u: (H,K); state: (B,H,K,V) -> (y
    (B,T,H,V) in r's dtype, state' float32). Sequential over T, in float32
    (float64 when an input is float64)."""
    acc = _acc_dtype(r, k, v, w, u, state)
    rf, kf, vf, wf = (a.to(acc) for a in (r, k, v, w))
    uf = u.to(acc)[None, :, :, None]
    S = state.to(acc)
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
    does. A rectangular state (K key rows, V value columns) as
    ``wkv6_ref`` takes it."""
    B, T, H, hd = r.shape
    V = v.shape[-1]
    chunk = min(chunk, T)
    if T % chunk != 0:
        return wkv6_ref(r, k, v, w, u, state)
    nt = T // chunk

    acc = _acc_dtype(r, k, v, w, u, state)

    def fold(x):
        return (x.to(acc).permute(0, 2, 1, 3)
                .reshape(B * H, nt, chunk, x.shape[-1]))

    rf, kf, vf, wf = fold(r), fold(k), fold(v), fold(w)
    uf = u.to(acc)[None].expand(B, H, hd).reshape(B * H, 1, hd)
    S = state.to(acc).reshape(B * H, hd, V)
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
    y = torch.stack(ys, dim=1).reshape(B, H, T, V).permute(0, 2, 1, 3)
    return y.to(r.dtype), S.reshape(B, H, hd, V)


def wkv6_plain(r, k, v, w, u, state):
    """The reference layer's dispatch (``repro/layers/rwkv6.py``
    ``rwkv_time_mix`` without the kernel): the chunked form when
    ``T >= 2 * WKV_CHUNK`` and ``T % WKV_CHUNK == 0``, the scan
    otherwise. Square or rectangular (a key slice) states."""
    T = r.shape[1]
    if T >= 2 * WKV_CHUNK and T % WKV_CHUNK == 0:
        return wkv6_chunked(r, k, v, w, u, state)
    return wkv6_ref(r, k, v, w, u, state)


def _chunk_logdecay(w):
    """(BH, c, hd) log-decays of one chunk -> (lw, lw_prev): the inclusive
    cumsum and the same shifted by one token (0 at the chunk's first), so
    lw_prev[t] = lw[t - 1] exactly and every difference below is <= 0."""
    lw = torch.cumsum(w, dim=1)
    return lw, torch.cat([torch.zeros_like(lw[:, :1]), lw[:, :-1]], dim=1)


def _fold_bh(x, acc):
    """(B,T,H,hd) -> (B*H, T, hd) in ``acc``."""
    B, T, H, hd = x.shape
    return x.to(acc).permute(0, 2, 1, 3).reshape(B * H, T, hd)


def _chunk_bounds(T):
    return [(t0, min(T, t0 + WKV_CHUNK)) for t0 in range(0, T, WKV_CHUNK)]


def _by_chunk(x, acc):
    """(B,T,H,n) -> (B*H, nt, WKV_CHUNK, n) in ``acc``, the last chunk
    padded with zero rows (a zero k or r adds nothing, a zero w decays
    nothing)."""
    xf = _fold_bh(x, acc)
    T = xf.shape[1]
    nt = -(-T // WKV_CHUNK)
    pad = xf.new_zeros((xf.shape[0], nt * WKV_CHUNK - T, xf.shape[2]))
    return torch.cat([xf, pad], 1).reshape(xf.shape[0], nt, WKV_CHUNK,
                                           xf.shape[2])


def wkv6_keyslice_sums_plain(k, v, w, r=None, dy=None):
    """Pass 1 of the key-slice WKV's chunked passes (the plain twin of
    ``csrc/wkv6_keyslice.cuh``'s ``sums_kernel``): per chunk of
    ``WKV_CHUNK`` tokens (the last may be short), with lw the inclusive
    cumsum of w in the chunk and lw_prev[t] = lw[t - 1],

        d     = e^{lw_last}                            (B,H,nt,K)
        Delta = sum_t (k_t e^{lw_last - lw_t}) v_t^T   (B,H,nt,K,V)
        Gamma = sum_t (r_t e^{lw_prev_t}) dy_t^T       (B,H,nt,K,V)

    Delta is the recurrence S <- e^{w_t} S + k_t v_t^T over the chunk from
    a zero state, Gamma the reverse recurrence of the state gradient dS <-
    r_t dy_t^T + e^{w_t} dS from zero; Gamma only given r and dy (None
    otherwise). k, r, w (B,T,H,K), v, dy (B,T,H,V) -> (d, Delta, Gamma),
    float32 (float64 when an input is)."""
    B, T, H, K = k.shape
    V = v.shape[-1]
    acc = _acc_dtype(k, v, w, *(() if r is None else (r, dy)))
    kc, vc, wc = (_by_chunk(x, acc) for x in (k, v, w))
    nt = kc.shape[1]
    lw = torch.cumsum(wc, 2)
    last = lw[:, :, -1:]
    d = torch.exp(last[:, :, 0]).reshape(B, H, nt, K)
    delta = torch.einsum("bcti,bctj->bcij", kc * torch.exp(last - lw), vc)
    gamma = None
    if r is not None:
        rc, dyc = _by_chunk(r, acc), _by_chunk(dy, acc)
        lw_prev = torch.cat([torch.zeros_like(lw[:, :, :1]), lw[:, :, :-1]],
                            2)
        gamma = torch.einsum("bcti,bctj->bcij", rc * torch.exp(lw_prev),
                             dyc).reshape(B, H, nt, K, V)
    return d, delta.reshape(B, H, nt, K, V), gamma


def wkv6_keyslice_scan_plain(d, delta, state, gamma=None, dstate_out=None):
    """Pass 2 (the twin of ``scan_kernel``): the chunks in order from the
    initial state, S_{c+1} = d_c S_c + Delta_c, and given Gamma in reverse
    from the final state's gradient, dS_exit(c - 1) = d_c dS_exit(c) +
    Gamma_c. d (B,H,nt,K), Delta and Gamma (B,H,nt,K,V) of
    ``wkv6_keyslice_sums_plain``; state, dstate_out (B,H,K,V) (None is
    zero) -> (each chunk's entry state (B,H,nt,K,V), and given Gamma each
    chunk's exit-state gradient (B,H,nt,K,V) and the initial state's
    gradient (B,H,K,V), None otherwise), float32 (float64 when an input
    is). The final state is the chunk pass's
    (``wkv6_keyslice_chunk_plain``)."""
    acc = _acc_dtype(d, delta, state)
    nt = d.shape[2]
    dd = d.to(acc)[..., None]
    S = state.to(acc)
    states = []
    for c in range(nt):
        states.append(S)
        S = dd[:, :, c] * S + delta[:, :, c].to(acc)
    if gamma is None:
        return torch.stack(states, 2), None, None
    G = (torch.zeros_like(S) if dstate_out is None else dstate_out.to(acc))
    exits = [None] * nt
    for c in reversed(range(nt)):
        exits[c] = G
        G = dd[:, :, c] * G + gamma[:, :, c].to(acc)
    return torch.stack(states, 2), torch.stack(exits, 2), G


def wkv6_keyslice_chunk_plain(r, k, v, w, u, states):
    """Pass 3 of the forward (the twin of ``csrc/wkv6_keyslice.cu``'s
    ``fwd_chunk_kernel``): each chunk's tokens walked from its entry state
    (``states``, (B,H,nt,K,V)), every chunk at once, as ``wkv6_ref`` walks
    them. r, k, w (B,T,H,K), v (B,T,H,V), u (H,K) -> (y (B,T,H,V) in r's
    dtype, the last chunk's exit state (B,H,K,V) float32; float64 when an
    input is)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    acc = _acc_dtype(r, k, v, w, u, states)
    rc, kc, vc, wc = (_by_chunk(x, acc) for x in (r, k, v, w))
    nt = rc.shape[1]
    S = states.to(acc).reshape(B * H, nt, K, V)
    uf = u.to(acc)[None].expand(B, H, K).reshape(B * H, 1, K, 1)
    ys = []
    for t in range(WKV_CHUNK):
        kv = kc[:, :, t, :, None] * vc[:, :, t, None, :]
        ys.append(torch.einsum("bci,bcij->bcj", rc[:, :, t], S + uf * kv))
        S = torch.exp(wc[:, :, t])[..., None] * S + kv
    y = torch.stack(ys, 2).reshape(B, H, nt * WKV_CHUNK, V)[:, :, :T]
    return (y.permute(0, 2, 1, 3).to(r.dtype),
            S[:, -1].reshape(B, H, K, V))


def wkv6_bwd_states_plain(k, v, w, state):
    """Pass 1 of the backward: the entry state of each chunk of
    ``WKV_CHUNK`` tokens (the last may be short), recomputed from the
    initial state. k, w: (B,T,H,K), w float32; v: (B,T,H,V); state:
    (B,H,K,V) -> (B,H,nt,K,V) float32 (float64 when an input is)."""
    B, T, H, K = k.shape
    V = v.shape[-1]
    acc = _acc_dtype(k, v, w, state)
    kf, vf, wf = _fold_bh(k, acc), _fold_bh(v, acc), _fold_bh(w, acc)
    S = state.to(acc).reshape(B * H, K, V)
    entry = []
    for t0, t1 in _chunk_bounds(T):
        entry.append(S)
        lw, _ = _chunk_logdecay(wf[:, t0:t1])
        kb = kf[:, t0:t1] * torch.exp(lw[:, -1:] - lw)
        S = (torch.exp(lw[:, -1])[..., None] * S
             + torch.einsum("bti,btj->bij", kb, vf[:, t0:t1]))
    return torch.stack(entry, 1).reshape(B, H, len(entry), K, V)


def wkv6_bwd_dstates_plain(r, w, dy, dstate_out):
    """Pass 2: the chunks in reverse, carrying dS. r, w: (B,T,H,K), w
    float32; dy: (B,T,H,V); dstate_out: (B,H,K,V) the gradient of the
    final state, or None (zero) -> (dstates (B,H,nt,K,V), the gradient of
    each chunk's exit state; dstate (B,H,K,V), that of the initial state),
    float32 (float64 when an input is). Per chunk, a_t = e^{lw_prev_t}:

        dS <- sum_t (r_t a_t) dy_t^T + e^{lw_last} dS
    """
    B, T, H, K = r.shape
    V = dy.shape[-1]
    acc = _acc_dtype(r, w, dy, *(() if dstate_out is None else
                                 (dstate_out,)))
    rf, wf, dyf = _fold_bh(r, acc), _fold_bh(w, acc), _fold_bh(dy, acc)
    dS = (torch.zeros((B * H, K, V), dtype=acc, device=r.device)
          if dstate_out is None
          else dstate_out.to(acc).reshape(B * H, K, V))
    bounds = _chunk_bounds(T)
    exits = [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        t0, t1 = bounds[c]
        exits[c] = dS
        lw, lw_prev = _chunk_logdecay(wf[:, t0:t1])
        dS = (torch.einsum("bti,btj->bij", rf[:, t0:t1] * torch.exp(lw_prev),
                           dyf[:, t0:t1])
              + torch.exp(lw[:, -1])[..., None] * dS)
    return (torch.stack(exits, 1).reshape(B, H, len(bounds), K, V),
            dS.reshape(B, H, K, V))


def wkv6_bwd_chunk_plain(r, k, v, w, u, dy, states, dstates):
    """Pass 3: every gradient of each chunk from its entry state S
    (``states``, pass 1) and its exit-state gradient dS (``dstates``, pass
    2); the chunks are independent. -> (dr, dk (B,T,H,K) in r's dtype, dv
    (B,T,H,V) in v's, dw (B,T,H,K) and du_part (B,H,nt,K), each chunk's
    share of du, float32; float64 when an input is). A key slice of the
    state (K of the V key rows) gives its rows' dr, dk, dw and du and its
    share of dv: the shares of the slices sum to the whole's dv.

    Per chunk, with lw the inclusive cumsum of w, lw_prev[t] = lw[t - 1],
    a_t = e^{lw_prev_t}, D[t,tau] = e^{lw_prev_t - lw_tau} (tau < t), b_tau
    = e^{lw_last - lw_tau} (every exponent <= 0) and A[t,tau] = sum_i r_t
    k_tau D[t,tau] (A[t,t] = sum_i r_t u k_t):

        dv_tau = sum_{t>=tau} A[t,tau] dy_t + (k_tau b_tau)^T dS
        dr_t   = a_t (S dy_t) + sum_{tau<t} D k_tau (v_tau.dy_t)
                 + u k_t (v_t.dy_t)
        dk_tau = sum_{t>tau} D r_t (v_tau.dy_t) + u r_tau (v_tau.dy_tau)
                 + b_tau (dS v_tau)
        du    += sum_t r_t k_t (v_t.dy_t)
        dw_s   = sum_{t>s} X_t - sum_{t>=s} YA_t + sum_{t<s} YS_t + Z

    with X_t = r_t (dr_t without its u term), YA_tau = k_tau (the pairwise
    sum of dk_tau), YS_tau = k_tau b_tau (dS v_tau) and Z = e^{lw_last}
    rowsum(S * dS): the derivatives through lw_prev, lw and lw_last,
    gathered onto each w_s."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    acc = _acc_dtype(r, k, v, w, u, dy, states, dstates)
    rf, kf, vf, wf, dyf = (_fold_bh(a, acc) for a in (r, k, v, w, dy))
    uf = u.to(acc)[None].expand(B, H, K).reshape(B * H, 1, K)
    nt = states.shape[2]
    Sc = states.to(acc).reshape(B * H, nt, K, V)
    dSc = dstates.to(acc).reshape(B * H, nt, K, V)
    dr, dk, dw = (torch.empty_like(rf) for _ in range(3))
    dv = torch.empty_like(vf)
    du = []
    for c, (t0, t1) in enumerate(_chunk_bounds(T)):
        S, dS = Sc[:, c], dSc[:, c]
        rc, kc, vc, dyc = (a[:, t0:t1] for a in (rf, kf, vf, dyf))
        n = t1 - t0
        lw, lw_prev = _chunk_logdecay(wf[:, t0:t1])
        last = lw[:, -1]
        a = torch.exp(lw_prev)
        b = torch.exp(last[:, None] - lw)
        ti = torch.arange(n, device=r.device)
        lower = (ti[None, :] < ti[:, None])[None, :, :, None]     # tau < t
        D = torch.exp((lw_prev[:, :, None] - lw[:, None]).masked_fill(
            ~lower, float("-inf")))                          # (BH,t,tau,hd)
        vdy = torch.einsum("bti,bsi->bts", dyc, vc)     # [t,tau] v_tau.dy_t
        vdy_diag = torch.diagonal(vdy, dim1=1, dim2=2)[..., None]
        Sdy = torch.einsum("bij,btj->bti", S, dyc)
        dSv = torch.einsum("bij,btj->bti", dS, vc)
        Dv = D * vdy[..., None]
        X = rc * (a * Sdy + torch.sum(Dv * kc[:, None], dim=2))
        ya = torch.sum(Dv * rc[:, :, None], dim=1)      # pairwise part of dk
        YA, YS = kc * ya, kc * b * dSv
        dr[:, t0:t1] = a * Sdy + torch.sum(Dv * kc[:, None], dim=2) \
            + uf * kc * vdy_diag
        dk[:, t0:t1] = ya + uf * rc * vdy_diag + b * dSv
        A = torch.sum(rc[:, :, None] * kc[:, None] * D, dim=-1) \
            + torch.diag_embed(torch.sum(rc * uf * kc, dim=-1))
        dv[:, t0:t1] = (torch.einsum("bts,btj->bsj", A, dyc)
                        + torch.einsum("bsi,bij->bsj", kc * b, dS))
        du.append(torch.sum(rc * kc * vdy_diag, dim=1))
        Z = torch.exp(last) * torch.sum(S * dS, dim=-1)
        after = X.flip(1).cumsum(1).flip(1) - X          # sum_{t>s} X_t
        from_s = YA.flip(1).cumsum(1).flip(1)            # sum_{t>=s} YA_t
        before = YS.cumsum(1) - YS                       # sum_{t<s} YS_t
        dw[:, t0:t1] = after - from_s + before + Z[:, None]

    def unfold(x, dtype):
        return x.reshape(B, H, T, -1).permute(0, 2, 1, 3).to(dtype)

    out_f = torch.float64 if acc == torch.float64 else torch.float32
    return (unfold(dr, r.dtype), unfold(dk, k.dtype), unfold(dv, v.dtype),
            unfold(dw, out_f),
            torch.stack(du, 1).reshape(B, H, nt, K).to(out_f))


def wkv6_backward_plain(r, k, v, w, u, state, dy, dstate_out):
    """The backward of the WKV recurrence in float32 (float64 when an input
    is float64): the composition of the three passes the CUDA backward
    kernel runs, ``wkv6_bwd_states_plain``, ``wkv6_bwd_dstates_plain`` and
    ``wkv6_bwd_chunk_plain``, whose order of operations they fix.

    r, k, v, dy: (B,T,H,hd); w: (B,T,H,hd) log-decay <= 0; u: (H,hd);
    state: (B,H,hd,hd) the state before token 0; dstate_out: (B,H,hd,hd)
    the gradient of the final state, or None (zero).
    -> (dr, dk, dv in r's dtype, dw float32 (B,T,H,hd), du float32 (H,hd)
    summed over B and the chunks, dstate float32 (B,H,hd,hd)).

    A rectangular state, as the forward's plain versions take it (r, k, w
    (B,T,H,K), v and dy (B,T,H,V), u (H,K), state and dstate_out
    (B,H,K,V)): the backward of a key slice's call, the plain twin of the
    key-slice backward kernel. Its dr, dk, dw, du and dstate are the
    whole's rows of the slice, and its dv the slice's share of the
    whole's (the shares of the slices sum to it)."""
    states = wkv6_bwd_states_plain(k, v, w, state)
    dstates, dstate = wkv6_bwd_dstates_plain(r, w, dy, dstate_out)
    acc = _acc_dtype(r, k, v, w, u, state, dy)
    dr, dk, dv, dw, du_part = wkv6_bwd_chunk_plain(
        r, k, v, w, u, dy, states.to(acc), dstates.to(acc))
    out_f = torch.float64 if acc == torch.float64 else torch.float32
    return (dr, dk, dv, dw.to(out_f), du_part.sum((0, 2)).to(out_f),
            dstate.to(out_f))
