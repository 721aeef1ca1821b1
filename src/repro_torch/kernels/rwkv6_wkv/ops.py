"""Public wrapper of the chunked RWKV-6 WKV recurrence and its backward.

Dispatch goes by the tensors' device: CPU tensors take ``wkv6_plain`` (the
reference layer's dispatch between the chunked form and the scan) and
``wkv6_backward_plain``; CUDA tensors launch the kernels of
``csrc/wkv6.cu`` and ``csrc/wkv6_bwd.cu`` (and raise if they cannot). The
backward is three launches behind one call (``wkv6_bwd``); each pass also
runs alone (``wkv6_bwd_states``, ``wkv6_bwd_dstates``, ``wkv6_bwd_chunk``)
so it can be held against its plain twin.
``wkv6_keyslice`` is the forward over a key slice of the state (K of the
head's V key rows, the partitioned step's share), which ``wkv6`` routes a
rectangular state to, and ``wkv6_keyslice_bwd`` its backward (CPU
tensors take the rectangular ``wkv6_plain`` and ``wkv6_backward_plain``).
Each is three launches behind one call (``csrc/wkv6_keyslice.cu``,
``csrc/wkv6_keyslice_bwd.cu``): 32-token chunk sums, a scan over the
chunks, a chunk pass. Each kernel also runs alone against its plain twin
(``wkv6_keyslice_sums``, ``wkv6_keyslice_scan``, ``wkv6_keyslice_chunk``,
``wkv6_keyslice_bwd_chunk``), and so do the backward's state passes
(``wkv6_keyslice_bwd_states``, ``wkv6_keyslice_bwd_dstates``).
``wkv6`` and ``wkv6_keyslice`` go through their autograd ops (``WKV6``,
``WKV6KeySlice``) when a gradient is wanted, and straight to the forward
otherwise (the serving path, under ``no_grad``). Meta tensors (the dry
run's trace) of the forwards and backwards launch nothing: they get meta
outputs and one ``build.meta_call`` entry with their cost.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.perfmodel import H100_SXM
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv.ref import (WKV_CHUNK, wkv6_backward_plain,
                                               wkv6_bwd_chunk_plain,
                                               wkv6_bwd_dstates_plain,
                                               wkv6_bwd_states_plain,
                                               wkv6_keyslice_chunk_plain,
                                               wkv6_keyslice_scan_plain,
                                               wkv6_keyslice_sums_plain,
                                               wkv6_plain)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


BWD_PASSES = ("wkv6_bwd_states", "wkv6_bwd_dstates", "wkv6_bwd_chunk")
# the key-slice kernels' passes, one launch each (csrc/wkv6_keyslice.cuh)
KEYSLICE_PASSES = ("sums", "scan", "chunk")

F32_FLOPS = 67e12                   # H100 SXM datasheet, outside tensor cores
SFU_PER_S = 132 * 16 * 1.98e9       # exponentials/s: 132 SMs x 16 SFU lanes


def work(B: int, T: int, H: int, hd: int, itemsize: int = 2, *,
         backward: bool = False):
    """(float32 FLOP, exponentials, bytes) one call must do and move.

    Bytes: forward r, k, v, y in the compute dtype, w and the state in and
    out in float32, u; backward r, k, v, dy read and dr, dk, dv written in
    the compute dtype, w read and dw written, the state and dstate_out
    read and dstate written, u read and du written, in float32. Operations
    per 32-token chunk of c tokens with p = c (c - 1) / 2 causal pairs:
    forward, the chunked algorithm's; backward, the entry state's
    recomputation, v.dy and A over the pairs, S dy, dS v and Z, dr and dk
    over the pairs, dv, dS and the dw scan, with one exponential a causal
    pair and key dim (the least: A, dr and dk share it). The scratch the
    backward keeps between its passes is not counted."""
    if backward:
        nbytes = (B * T * H * hd * (7 * itemsize + 8)
                  + 3 * B * H * hd * hd * 4 + 2 * H * hd * 4)
    else:
        nbytes = (B * T * H * hd * (4 * itemsize + 4)
                  + 2 * B * H * hd * hd * 4 + H * hd * 4)
    flops = exps = 0
    for t0 in range(0, T, WKV_CHUNK):
        c = min(WKV_CHUNK, T - t0)
        p = c * (c - 1) // 2
        if backward:
            flops += (2 * c * hd * hd + hd * hd + 4 * c * hd      # entry state
                      + 2 * (p + c) * hd                        # v . dy
                      + 4 * p * hd + 3 * c * hd                 # A
                      + 4 * c * hd * hd + 2 * hd * hd           # S dy, dS v, Z
                      + 8 * p * hd + 12 * c * hd                # dr, dk
                      + 2 * (p + c) * hd + 2 * c * hd * hd + c * hd   # dv
                      + 2 * c * hd * hd + hd * hd + c * hd      # dS
                      + 5 * c * hd)                             # dw
            exps += p * hd + 4 * c * hd + 2 * hd
        else:
            flops += (7 * c * hd + 4 * p * hd + 4 * c * hd * hd
                      + 2 * (p + c) * hd + hd * hd)
            exps += 2 * c * hd + p * hd + hd
    return flops * B * H, exps * B * H, nbytes


def cost(B: int, T: int, H: int, hd: int, itemsize: int = 2, *,
         backward: bool = False):
    """(FLOP, bytes) of one call (``work``), for a roofline that divides
    FLOP by the bf16 peak (``H100_SXM.flops_peak``) and bytes by the
    memory rate. The float32 FLOP run at 67 TFLOP/s and the exponentials
    on the special-function units, not at the bf16 peak, so the FLOP
    returned is the peak's worth of the slower of the two: their least
    time x the bf16 peak."""
    flops, exps, nbytes = work(B, T, H, hd, itemsize, backward=backward)
    t_ops = max(flops / F32_FLOPS, exps / SFU_PER_S)
    return t_ops * H100_SXM.flops_peak, nbytes


def keyslice_work(B: int, T: int, H: int, K: int, V: int,
                  itemsize: int = 2):
    """(float32 FLOP, exponentials, bytes) of one key-slice call: r, k in
    the compute dtype and w in float32 (K a token and head), v and y in
    the compute dtype (V), the state slice (K x V float32) read and
    written, u's slice; per token and head K V products for y, K V for
    the update, 3 K V additions and multiplies, and one exponential a key
    dim."""
    nbytes = (B * T * H * (K * (2 * itemsize + 4) + 2 * V * itemsize)
              + 2 * B * H * K * V * 4 + H * K * 4)
    return 5 * B * T * H * K * V, B * T * H * K, nbytes


def keyslice_cost(B: int, T: int, H: int, K: int, V: int,
                  itemsize: int = 2):
    """(FLOP, bytes) of one key-slice call for the roofline, as ``cost``
    gives them."""
    flops, exps, nbytes = keyslice_work(B, T, H, K, V, itemsize)
    t_ops = max(flops / F32_FLOPS, exps / SFU_PER_S)
    return t_ops * H100_SXM.flops_peak, nbytes


def keyslice_bwd_work(B: int, T: int, H: int, K: int, V: int,
                     itemsize: int = 2):
    """(float32 FLOP, exponentials, bytes) of the backward of one key-slice
    call. Bytes: r, k, dr, dk in the compute dtype and w, dw in float32 (K
    a token and head), v, dy, dv in the compute dtype (V), the state slice
    and dstate_out read and dstate written (K x V float32), u read and du
    written. Operations per token and head, the least the gradients need:
    the state recomputed (3 K V), the sums over the value columns of dr,
    dk and dw and dv's over the key rows (8 K V), the dS update (3 K V),
    dy . v (2 V); one exponential a key dim. The scratch of chunk states
    the kernels keep between their passes is not counted."""
    nbytes = (B * T * H * (K * (4 * itemsize + 8) + 3 * V * itemsize)
              + 3 * B * H * K * V * 4 + 2 * H * K * 4)
    return B * T * H * (14 * K * V + 2 * V), B * T * H * K, nbytes


def keyslice_bwd_cost(B: int, T: int, H: int, K: int, V: int,
                      itemsize: int = 2):
    """(FLOP, bytes) of the backward of one key-slice call for the
    roofline, as ``cost`` gives them."""
    flops, exps, nbytes = keyslice_bwd_work(B, T, H, K, V, itemsize)
    t_ops = max(flops / F32_FLOPS, exps / SFU_PER_S)
    return t_ops * H100_SXM.flops_peak, nbytes


def _kernel_info(export: str, labels, *dims: int) -> dict:
    out = (ctypes.c_int * (4 * len(labels)))()
    info = {}
    for dtype, code in _DTYPE_CODES.items():
        dname = str(dtype).split('.')[-1]
        build.check(f"{export} {dname}",
                    getattr(build.lib(), export)(code, *dims,
                                                 ctypes.addressof(out)))
        for n, label in enumerate(labels):
            info[f"{label}<{dname}>"] = dict(
                registers=out[4 * n], local_bytes=out[4 * n + 1],
                smem_bytes=out[4 * n + 2], blocks_per_sm=out[4 * n + 3])
    return info


def wkv6_kernel_info(hd: int) -> dict:
    """Registers, local bytes (spills and stack), dynamic shared memory and
    resident blocks per SM of the kernel at head dim ``hd``, per compute
    dtype, as the loaded library reports them. Builds the library on first
    use."""
    return _kernel_info("aqua_wkv6_info", ("wkv6",), hd)


def wkv6_bwd_kernel_info(hd: int) -> dict:
    """The same for the backward's three kernels, one per pass
    (``BWD_PASSES``)."""
    return _kernel_info("aqua_wkv6_bwd_info", BWD_PASSES, hd)


def wkv6_keyslice_kernel_info(K: int, V: int) -> dict:
    """The same for the key-slice forward's three kernels at K key rows of
    V columns, one per pass (``KEYSLICE_PASSES``); the shared memory is
    static and dynamic together."""
    return _kernel_info("aqua_wkv6_keyslice_info",
                        tuple(f"wkv6_keyslice_{p}" for p in KEYSLICE_PASSES),
                        K, V)


def wkv6_keyslice_bwd_kernel_info(K: int, V: int) -> dict:
    """The same for the key-slice backward's three kernels."""
    return _kernel_info("aqua_wkv6_keyslice_bwd_info",
                        tuple(f"wkv6_keyslice_bwd_{p}"
                              for p in KEYSLICE_PASSES), K, V)


def _check(name, r, k, v, w, u, state):
    """The kernels' contract on the forward's operands; raises on what they
    do not take."""
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


def _keyslice_check(name, r, k, v, w, u, state):
    """The key-slice kernel's contract; raises on what it does not take
    (a square state is ``wkv6``'s)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if T < 1:
        raise ValueError(f"{name}: needs at least one token")
    if V not in (32, 64) or K >= V or V % K or K & (K - 1):
        raise ValueError(f"{name}: a key slice of K {K} rows of a V {V} "
                         "state needs V in (32, 64) and K a power of two "
                         "below V")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"{name}: r, k, v must share float32 or bfloat16, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}")
    for t, what in ((w, "w"), (u, "u"), (state, "state")):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32, got {t.dtype}")
    for t, shape, what in ((k, r.shape, "k"), (w, r.shape, "w"),
                           (v, (B, T, H, V), "v"), (u, (H, K), "u"),
                           (state, (B, H, K, V), "state")):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} != "
                             f"{tuple(shape)}")


def wkv6_keyslice(r, k, v, w, u, state):
    """The forward over a key slice of every head's state: r, k, w (B,T,H,K)
    (w float32), v (B,T,H,V), u (H,K) float32, state (B,H,K,V) float32, K
    a power of two below V, V 32 or 64 -> (the slice's share of y
    (B,T,H,V) in r's dtype, its rows of the new state (B,H,K,V) float32).
    CPU tensors take ``wkv6_plain``; CUDA tensors launch the three passes
    of ``csrc/wkv6_keyslice.cu`` (the chunk pass alone at T <= 32). Under
    autograd (grad enabled and an input requiring it) the call is the
    ``WKV6KeySlice`` op, whose backward is ``wkv6_keyslice_bwd``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        return WKV6KeySlice.apply(r, k, v, w, u, state)
    return _keyslice_forward(r, k, v, w, u, state)


def _require_aligned(name, **tensors):
    """The kernels read rows in 16-byte pieces, so these operands start on
    a 16-byte boundary; raises on one that does not."""
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte "
                             f"boundary (data_ptr {t.data_ptr()})")


def _chunk_scratch(like, *shape):
    """A float32 (B, H, ceil(T / 32), *shape) tensor beside ``like``
    (B,T,H,.): a decay (K) or a state (K, V) a chunk."""
    B, T, H = like.shape[:3]
    return torch.empty((B, H, -(-T // WKV_CHUNK)) + shape,
                       dtype=torch.float32, device=like.device)


def _ks_launch(name, export, passes, at, dims, dtype, ptrs):
    """One call of the key-slice C entry ``export`` (``aqua_wkv6_keyslice``
    or ``aqua_wkv6_keyslice_bwd``) running the passes of bit mask
    ``passes`` (1 sums, 2 scan, 4 chunk) on ``ptrs`` (None where unused),
    dims (B, T, H, K, V), on ``at``'s card and stream."""
    with build.on_device(at):
        rc = getattr(build.lib(), export)(
            *(0 if t is None else t.data_ptr() for t in ptrs), *dims,
            _DTYPE_CODES[dtype], passes, build.stream_of(at))
    build.check(name, rc)


def _fwd_launch(name, passes, r, k, v, w, u, s0, *, y=None, s_out=None,
                d=None, states=None):
    B, T, H, K = k.shape
    _require_aligned(name, v=v)
    _ks_launch(name, "aqua_wkv6_keyslice", passes, k,
               (B, T, H, K, v.shape[-1]), k.dtype,
               (r, k, v, w, u, s0, y, s_out, d, states))


def _keyslice_forward(r, k, v, w, u, state):
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state)
    name = "wkv6_keyslice"
    B, T, H, K = r.shape
    V = v.shape[-1]
    _keyslice_check(name, r, k, v, w, u, state)
    if r.device.type == "meta":
        return build.meta_call(
            name, (r, k, v, w, u, state),
            (torch.empty_like(v), torch.empty_like(state)),
            *keyslice_cost(B, T, H, K, V, r.element_size()))
    build.require_cuda(name, r, k, v, w, u, state)
    y = torch.empty_like(v)
    s_out = torch.empty_like(state)
    if T <= WKV_CHUNK:
        _fwd_launch(name, 4, r, k, v, w, u, state, y=y, s_out=s_out,
                    states=state)
    else:
        _fwd_launch(name, 7, r, k, v, w, u, state, y=y, s_out=s_out,
                    d=_chunk_scratch(k, K), states=_chunk_scratch(k, K, V))
    build.LAUNCHES[name] += 1
    return y, s_out


def _on_card(name, *tensors) -> bool:
    """True for CUDA tensors (checked as the kernels want them), False for
    CPU ones; a single pass does not run on ``meta``."""
    dev = tensors[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"{name}: takes CPU or CUDA tensors, not {dev}")
    build.require_cuda(name, *tensors)
    return True


def wkv6_keyslice_sums(k, v, w, r=None, dy=None):
    """Pass 1 alone, the chunk sums: k, w (B,T,H,K), v (B,T,H,V) and, for
    the backward's, r (B,T,H,K) and dy (B,T,H,V) -> (d (B,H,nt,K), Delta
    and Gamma (B,H,nt,K,V), float32; Gamma None without r). CPU tensors
    take ``wkv6_keyslice_sums_plain``; CUDA tensors launch ``sums_kernel``
    (through the backward's entry given r)."""
    name = "wkv6_keyslice_sums"
    extra = () if r is None else (r, dy)
    if not _on_card(name, k, v, w, *extra):
        return wkv6_keyslice_sums_plain(k, v, w, r, dy)
    K, V = k.shape[-1], v.shape[-1]
    d, delta = _chunk_scratch(k, K), _chunk_scratch(k, K, V)
    if r is None:
        _fwd_launch(name, 1, None, k, v, w, None, None, d=d, states=delta)
        gamma = None
    else:
        gamma = _chunk_scratch(k, K, V)
        _bwd_ks_launch(name, 1, r, k, v, w, None, None, dy, None, d=d,
                       states=delta, dstates=gamma)
    build.LAUNCHES[name] += 1
    return d, delta, gamma


def wkv6_keyslice_scan(d, delta, state, gamma=None, dstate_out=None):
    """Pass 2 alone, the scan over the chunks, from pass 1's summaries: d
    (B,H,nt,K), Delta (B,H,nt,K,V), state (B,H,K,V) and, for the
    backward's reverse scan, Gamma (B,H,nt,K,V) and dstate_out (B,H,K,V;
    None is zero) -> (each chunk's entry state (B,H,nt,K,V), and given
    Gamma each chunk's exit-state gradient and the initial state's
    gradient, None otherwise), float32. CPU tensors take
    ``wkv6_keyslice_scan_plain``; CUDA tensors launch ``scan_kernel`` (both
    directions in one launch given Gamma)."""
    name = "wkv6_keyslice_scan"
    extra = () if gamma is None else (gamma,)
    if not _on_card(name, d, delta, state, *extra):
        return wkv6_keyslice_scan_plain(d, delta, state, gamma, dstate_out)
    B, H, nt, K, V = delta.shape
    dims = (B, nt * WKV_CHUNK, H, K, V)
    states = delta.clone()
    dstates = dstate = None
    if gamma is None:
        _ks_launch(name, "aqua_wkv6_keyslice", 2, d, dims, torch.float32,
                   (None,) * 5 + (state, None, None, d, states))
    else:
        if dstate_out is None:
            dstate_out = torch.zeros_like(state)
        dstates, dstate = gamma.clone(), torch.empty_like(state)
        _ks_launch(name, "aqua_wkv6_keyslice_bwd", 2, d, dims, torch.float32,
                   (None,) * 5 + (state, None, dstate_out) + (None,) * 5
                   + (dstate, d, states, dstates))
    build.LAUNCHES[name] += 1
    return states, dstates, dstate


def wkv6_keyslice_chunk(r, k, v, w, u, states):
    """Pass 3 of the forward alone: ``wkv6_keyslice``'s operands but each
    chunk's entry state (B,H,nt,K,V) float32 in place of the initial one
    -> (y (B,T,H,V) in r's dtype, the last chunk's exit state (B,H,K,V)
    float32). CPU tensors take ``wkv6_keyslice_chunk_plain``; CUDA tensors
    launch ``fwd_chunk_kernel``."""
    name = "wkv6_keyslice_chunk"
    if not _on_card(name, r, k, v, w, u, states):
        return wkv6_keyslice_chunk_plain(r, k, v, w, u, states)
    _keyslice_check(name, r, k, v, w, u, states[:, :, 0])
    _states_check(name, states, k, v)
    y = torch.empty_like(v)
    s_out = torch.empty_like(states[:, :, 0])
    _fwd_launch(name, 4, r, k, v, w, u, None, y=y, s_out=s_out,
                states=states)
    build.LAUNCHES[name] += 1
    return y, s_out


def _states_check(name, states, k, v):
    """Chunk states (or their gradients) as the chunk passes read them."""
    B, T, H, K = k.shape
    want = (B, H, -(-T // WKV_CHUNK), K, v.shape[-1])
    if states.dtype != torch.float32 or tuple(states.shape) != want \
            or not states.is_contiguous():
        raise ValueError(f"{name}: chunk states must be contiguous float32 "
                         f"{want}, got {states.dtype} "
                         f"{tuple(states.shape)}")


def _forward(r, k, v, w, u, state):
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state)
    name = "wkv6"
    B, T, H, hd = r.shape
    _check(name, r, k, v, w, u, state)
    if r.device.type == "meta":
        return build.meta_call(
            name, (r, k, v, w, u, state),
            (torch.empty_like(r), torch.empty_like(state)),
            *cost(B, T, H, hd, r.element_size()))
    build.require_cuda(name, r, k, v, w, u, state)
    _require_aligned(name, r=r, k=k, v=v, w=w, state=state)
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    lib = build.lib()
    with build.on_device(r):
        rc = lib.aqua_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           w.data_ptr(), u.data_ptr(), state.data_ptr(),
                           y.data_ptr(), s_out.data_ptr(), B, T, H, hd,
                           _DTYPE_CODES[r.dtype], build.stream_of(r))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return y, s_out


def _bwd_check(name, r, k, v, w, u, state, dy, dstate_out):
    """The backward kernels' contract; returns dstate_out (zeros for
    None)."""
    _check(name, r, k, v, w, u, state)
    if dstate_out is None:
        dstate_out = torch.zeros_like(state)
    if dy.dtype != r.dtype or tuple(dy.shape) != tuple(r.shape):
        raise ValueError(f"{name}: dy {dy.dtype} {tuple(dy.shape)} must "
                         f"match r {r.dtype} {tuple(r.shape)}")
    if dstate_out.dtype != torch.float32 \
            or tuple(dstate_out.shape) != tuple(state.shape):
        raise ValueError(f"{name}: dstate_out {dstate_out.dtype} "
                         f"{tuple(dstate_out.shape)} must be float32 "
                         f"{tuple(state.shape)}")
    build.require_cuda(name, r, k, v, w, u, state, dy, dstate_out)
    for t, what in ((r, "r"), (k, "k"), (v, "v"), (w, "w"), (dy, "dy"),
                    (state, "state"), (dstate_out, "dstate_out")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte "
                             f"boundary (data_ptr {t.data_ptr()})")
    return dstate_out


def _bwd_launch(name, passes, r, k, v, w, u, state, dy, dstate_out, bufs):
    """One ``aqua_wkv6_bwd`` call running the passes of bit mask
    ``passes`` (1 states, 2 dstates, 4 chunk) on the buffers ``bufs`` (dr,
    dk, dv, dw, du_part, dstate, states, dstates; None where unused)."""
    B, T, H, hd = r.shape
    ptrs = [0 if t is None else t.data_ptr() for t in bufs]
    with build.on_device(r):
        rc = build.lib().aqua_wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), dy.data_ptr(),
            dstate_out.data_ptr(), *ptrs, B, T, H, hd, _DTYPE_CODES[r.dtype],
            passes, build.stream_of(r))
    build.check(name, rc)


def _scratch(r):
    """One float32 (B, H, ceil(T / 32), hd, hd) tensor: a state per
    chunk."""
    B, T, H, hd = r.shape
    return torch.empty((B, H, -(-T // WKV_CHUNK), hd, hd),
                       dtype=torch.float32, device=r.device)


def wkv6_bwd(r, k, v, w, u, state, dy, dstate_out):
    """The backward of ``wkv6``: the forward's operands, dy (B,T,H,hd) in
    r's dtype and dstate_out (B,H,hd,hd) float32 (the gradient of the final
    state; None is zero) -> (dr, dk, dv in r's dtype, dw (B,T,H,hd), du
    (H,hd), dstate (B,H,hd,hd), float32). On CUDA tensors one call runs the
    three passes (each chunk's entry state, each chunk's exit-state
    gradient, every gradient of each chunk); the kernel writes du per
    (sequence, chunk), and the sum over both is taken here, in a fixed
    order."""
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, w, u, state, dy, dstate_out)
    name = "wkv6_bwd"
    B, T, H, hd = r.shape
    if r.device.type == "meta":
        _check(name, r, k, v, w, u, state)
        out = tuple(torch.empty_like(t) for t in (r, r, r, w, u, state))
        return build.meta_call(name, (r, k, v, w, u, state, dy), out,
                               *cost(B, T, H, hd, r.element_size(),
                                     backward=True))
    dstate_out = _bwd_check(name, r, k, v, w, u, state, dy, dstate_out)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du_part = torch.empty((B, H, -(-T // WKV_CHUNK), hd),
                          dtype=torch.float32, device=r.device)
    dstate = torch.empty_like(state)
    _bwd_launch(name, 7, r, k, v, w, u, state, dy, dstate_out,
                (dr, dk, dv, dw, du_part, dstate, _scratch(r), _scratch(r)))
    build.LAUNCHES[name] += 1
    return dr, dk, dv, dw, du_part.sum((0, 2)), dstate


def wkv6_bwd_states(r, k, v, w, u, state, dy, dstate_out):
    """Pass 1 alone (``wkv6_bwd``'s operands): each chunk's entry state,
    (B,H,nt,hd,hd) float32. CPU tensors take ``wkv6_bwd_states_plain``."""
    if r.device.type == "cpu":
        return wkv6_bwd_states_plain(k, v, w, state)
    name = "wkv6_bwd_states"
    dstate_out = _bwd_check(name, r, k, v, w, u, state, dy, dstate_out)
    states = _scratch(r)
    _bwd_launch(name, 1, r, k, v, w, u, state, dy, dstate_out,
                (None,) * 6 + (states, None))
    build.LAUNCHES[name] += 1
    return states


def wkv6_bwd_dstates(r, k, v, w, u, state, dy, dstate_out):
    """Pass 2 alone: (each chunk's exit-state gradient (B,H,nt,hd,hd), the
    initial state's (B,H,hd,hd)), float32. CPU tensors take
    ``wkv6_bwd_dstates_plain``."""
    if r.device.type == "cpu":
        return wkv6_bwd_dstates_plain(r, w, dy, dstate_out)
    name = "wkv6_bwd_dstates"
    dstate_out = _bwd_check(name, r, k, v, w, u, state, dy, dstate_out)
    dstates, dstate = _scratch(r), torch.empty_like(state)
    _bwd_launch(name, 2, r, k, v, w, u, state, dy, dstate_out,
                (None,) * 5 + (dstate, None, dstates))
    build.LAUNCHES[name] += 1
    return dstates, dstate


def wkv6_bwd_chunk(r, k, v, w, u, state, dy, states, dstates):
    """Pass 3 alone, from the chunks' entry states and exit-state gradients
    (B,H,nt,hd,hd) float32: (dr, dk, dv in r's dtype, dw (B,T,H,hd), du
    (H,hd) float32). CPU tensors take ``wkv6_bwd_chunk_plain``."""
    if r.device.type == "cpu":
        dr, dk, dv, dw, du_part = wkv6_bwd_chunk_plain(
            r, k, v, w, u, dy, states, dstates)
        return dr, dk, dv, dw, du_part.sum((0, 2))
    name = "wkv6_bwd_chunk"
    _bwd_check(name, r, k, v, w, u, state, dy, None)
    want = tuple(_scratch(r).shape)
    for t, what in ((states, "states"), (dstates, "dstates")):
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or t.device != r.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 "
                             f"{want} on {r.device}")
    B, T, H, hd = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du_part = torch.empty((B, H, want[2], hd), dtype=torch.float32,
                          device=r.device)
    _bwd_launch(name, 4, r, k, v, w, u, state, dy, torch.zeros_like(state),
                (dr, dk, dv, dw, du_part, None, states, dstates))
    build.LAUNCHES[name] += 1
    return dr, dk, dv, dw, du_part.sum((0, 2))


def _bwd_ks_launch(name, passes, r, k, v, w, u, s0, dy, ds_out, *,
                   grads=(None,) * 6, d=None, states=None, dstates=None):
    """``aqua_wkv6_keyslice_bwd`` on ``grads`` (dr, dk, dv, dw, du_part,
    ds_in) and the scratch."""
    B, T, H, K = k.shape
    _require_aligned(name, v=v, dy=dy)
    _ks_launch(name, "aqua_wkv6_keyslice_bwd", passes, k,
               (B, T, H, K, v.shape[-1]), k.dtype,
               (r, k, v, w, u, s0, dy, ds_out, *grads, d, states, dstates))


def _keyslice_bwd_keys(name, r, k, v, w, u, state):
    """``_keyslice_check`` and the backward's 1 to 16 key rows."""
    _keyslice_check(name, r, k, v, w, u, state)
    if r.shape[-1] > 16:
        raise ValueError(f"{name}: K {r.shape[-1]} key rows; the kernel "
                         "takes 1 to 16")


def _keyslice_bwd_check(name, r, k, v, w, u, state, dy, dstate_out):
    """The key-slice backward's contract; returns dstate_out (zeros for
    None)."""
    _keyslice_bwd_keys(name, r, k, v, w, u, state)
    if dstate_out is None:
        dstate_out = torch.zeros_like(state)
    if dy.dtype != r.dtype or tuple(dy.shape) != tuple(v.shape):
        raise ValueError(f"{name}: dy {dy.dtype} {tuple(dy.shape)} must be "
                         f"{r.dtype} {tuple(v.shape)}")
    if dstate_out.dtype != torch.float32 \
            or tuple(dstate_out.shape) != tuple(state.shape):
        raise ValueError(f"{name}: dstate_out {dstate_out.dtype} "
                         f"{tuple(dstate_out.shape)} must be float32 "
                         f"{tuple(state.shape)}")
    build.require_cuda(name, r, k, v, w, u, state, dy, dstate_out)
    return dstate_out


def _keyslice_grads(r, v, w, nt):
    """dr, dk, dv, dw and du_part (B,H,nt,K) of a key-slice backward."""
    B, T, H, K = r.shape
    return (torch.empty_like(r), torch.empty_like(r), torch.empty_like(v),
            torch.empty_like(w),
            torch.empty((B, H, nt, K), dtype=torch.float32, device=r.device))


def wkv6_keyslice_bwd(r, k, v, w, u, state, dy, dstate_out):
    """The backward of ``wkv6_keyslice``: its operands, dy (B,T,H,V) in r's
    dtype and dstate_out (B,H,K,V) float32 (the gradient of the slice's
    final state; None is zero) -> (dr, dk (B,T,H,K) in r's dtype, dv
    (B,T,H,V) in v's, the slice's share of the whole's, dw (B,T,H,K), du
    (H,K) and dstate (B,H,K,V), float32). K a power of two from 1 to 16
    below V, V 32 or 64. CPU tensors take ``wkv6_backward_plain``; CUDA
    tensors launch the three passes of ``csrc/wkv6_keyslice_bwd.cu`` (the
    chunk pass alone at T <= 32), which write du per (sequence, chunk): the
    sum over both is taken here, in a fixed order. The scratch, a decay a
    chunk and two float32 (B, H, ceil(T / 32), K, V) tensors of chunk
    states, lives for the call."""
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, w, u, state, dy, dstate_out)
    name = "wkv6_keyslice_bwd"
    B, T, H, K = r.shape
    V = v.shape[-1]
    if r.device.type == "meta":
        _keyslice_bwd_keys(name, r, k, v, w, u, state)
        out = tuple(torch.empty_like(t) for t in (r, r, v, w, u, state))
        return build.meta_call(name, (r, k, v, w, u, state, dy), out,
                               *keyslice_bwd_cost(B, T, H, K, V,
                                                  r.element_size()))
    dstate_out = _keyslice_bwd_check(name, r, k, v, w, u, state, dy,
                                     dstate_out)
    nt = -(-T // WKV_CHUNK)
    dr, dk, dv, dw, du_part = _keyslice_grads(r, v, w, nt)
    dstate = torch.empty_like(state)
    grads = (dr, dk, dv, dw, du_part, dstate)
    if nt == 1:
        _bwd_ks_launch(name, 4, r, k, v, w, u, state, dy, dstate_out,
                       grads=grads, states=state, dstates=dstate_out)
    else:
        _bwd_ks_launch(name, 7, r, k, v, w, u, state, dy, dstate_out,
                       grads=grads, d=_chunk_scratch(k, K),
                       states=_chunk_scratch(k, K, V),
                       dstates=_chunk_scratch(k, K, V))
    build.LAUNCHES[name] += 1
    return dr, dk, dv, dw, du_part.sum((0, 2)), dstate


def _keyslice_bwd_state_passes(name, r, k, v, w, u, state, dy,
                               dstate_out):
    """Passes 1 and 2 of the key-slice backward, both ways in one call:
    (each chunk's entry state, each chunk's exit-state gradient
    (B,H,nt,K,V), the initial state's (B,H,K,V)), float32."""
    dstate_out = _keyslice_bwd_check(name, r, k, v, w, u, state, dy,
                                     dstate_out)
    K, V = k.shape[-1], v.shape[-1]
    states, dstates = _chunk_scratch(k, K, V), _chunk_scratch(k, K, V)
    dstate = torch.empty_like(state)
    _bwd_ks_launch(name, 3, r, k, v, w, u, state, dy, dstate_out,
                   grads=(None,) * 5 + (dstate,), d=_chunk_scratch(k, K),
                   states=states, dstates=dstates)
    build.LAUNCHES[name] += 1
    return states, dstates, dstate


def wkv6_keyslice_bwd_states(r, k, v, w, u, state, dy, dstate_out):
    """Passes 1 and 2 of the key-slice backward (``wkv6_keyslice_bwd``'s
    operands), forward in time: each chunk's entry state, (B,H,nt,K,V)
    float32. CPU tensors take ``wkv6_bwd_states_plain``; CUDA tensors run
    both directions and keep this one."""
    name = "wkv6_keyslice_bwd_states"
    if not _on_card(name, r, k, v, w, u, state, dy):
        return wkv6_bwd_states_plain(k, v, w, state)
    return _keyslice_bwd_state_passes(name, r, k, v, w, u, state, dy,
                                      dstate_out)[0]


def wkv6_keyslice_bwd_dstates(r, k, v, w, u, state, dy, dstate_out):
    """Passes 1 and 2 in reverse: (each chunk's exit-state gradient
    (B,H,nt,K,V), the initial state's (B,H,K,V)), float32. CPU tensors take
    ``wkv6_bwd_dstates_plain``; CUDA tensors run both directions and keep
    this one."""
    name = "wkv6_keyslice_bwd_dstates"
    if not _on_card(name, r, k, v, w, u, state, dy):
        return wkv6_bwd_dstates_plain(r, w, dy, dstate_out)
    return _keyslice_bwd_state_passes(name, r, k, v, w, u, state, dy,
                                      dstate_out)[1:]


def wkv6_keyslice_bwd_chunk(r, k, v, w, u, state, dy, states, dstates):
    """Pass 3 alone, from the chunks' entry states and exit-state gradients
    (B,H,nt,K,V) float32: (dr, dk, dv in r's dtype, dw (B,T,H,K), du (H,K)
    float32). CPU tensors take ``wkv6_bwd_chunk_plain``."""
    name = "wkv6_keyslice_bwd_chunk"
    if not _on_card(name, r, k, v, w, u, state, dy, states, dstates):
        dr, dk, dv, dw, du_part = wkv6_bwd_chunk_plain(
            r, k, v, w, u, dy, states, dstates)
        return dr, dk, dv, dw, du_part.sum((0, 2))
    _keyslice_bwd_check(name, r, k, v, w, u, state, dy, None)
    for t in (states, dstates):
        _states_check(name, t, k, v)
    dr, dk, dv, dw, du_part = _keyslice_grads(r, v, w, states.shape[2])
    _bwd_ks_launch(name, 4, r, k, v, w, u, state, dy, None,
                   grads=(dr, dk, dv, dw, du_part, None), states=states,
                   dstates=dstates)
    build.LAUNCHES[name] += 1
    return dr, dk, dv, dw, du_part.sum((0, 2))


def _grad_operand(g, dtype):
    """A gradient handed to a backward kernel: contiguous, of ``dtype``, on
    a 16-byte boundary (the kernels read whole rows in 16-byte pieces)."""
    g = g.to(dtype).contiguous()
    return g.clone() if g.data_ptr() % 16 else g


class WKV6KeySlice(torch.autograd.Function):
    """``wkv6_keyslice`` with its backward: the key-slice forward (its plain
    version on the CPU), then ``wkv6_keyslice_bwd`` from the saved
    operands, which recomputes the states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return _keyslice_forward(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        return wkv6_keyslice_bwd(r, k, v, w, u, state,
                                 _grad_operand(dy, r.dtype),
                                 _grad_operand(dstate, state.dtype))


class WKV6(torch.autograd.Function):
    """``wkv6`` with its backward: the forward kernel (or its plain version
    on the CPU), then ``wkv6_bwd`` from the saved operands. Neither y nor
    the per-chunk states are kept: the backward recomputes the states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return _forward(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        return wkv6_bwd(r, k, v, w, u, state, _grad_operand(dy, r.dtype),
                        _grad_operand(dstate, state.dtype))


def wkv6(r, k, v, w, u, state):
    """r, k, v: (B,T,H,hd) of one compute dtype (float32 or bfloat16); w:
    (B,T,H,hd) float32 log-decay <= 0; u: (H,hd) float32; state:
    (B,H,hd,hd) float32. Any T >= 1 (the last chunk may be short).
    -> (y (B,T,H,hd) in r's dtype, state' (B,H,hd,hd) float32)

    Under autograd (grad enabled and an input requiring it) the call is the
    ``WKV6`` op, whose backward is ``wkv6_bwd``. A key slice (v's last dim
    wider than r's: a rectangular state) goes to ``wkv6_keyslice``."""
    if v.shape[-1] != r.shape[-1]:
        return wkv6_keyslice(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        return WKV6.apply(r, k, v, w, u, state)
    return _forward(r, k, v, w, u, state)
