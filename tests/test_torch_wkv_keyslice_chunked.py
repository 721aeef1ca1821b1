"""The key-slice WKV's chunked passes, on the CPU.

The key-slice forward (``csrc/wkv6_keyslice.cu``) and backward
(``csrc/wkv6_keyslice_bwd.cu``) split the tokens into 32-token chunks:
chunk sums (the decay d, the recurrence from zero Delta and, backward, the
reverse recurrence of the state gradient from zero Gamma), a scan of the
chunk states, then a chunk pass. Held here:

- The plain twins of the passes (``kernels/rwkv6_wkv/ref.py``:
  ``wkv6_keyslice_sums_plain``, ``wkv6_keyslice_scan_plain``,
  ``wkv6_keyslice_chunk_plain``), composed, against the plain functions
  that existed before them: the forward against ``wkv6_ref`` and
  ``wkv6_plain``, the backward's state passes against
  ``wkv6_bwd_states_plain`` / ``wkv6_bwd_dstates_plain`` and, with
  ``wkv6_bwd_chunk_plain``, the whole against ``wkv6_backward_plain``; in
  float64 within 1e-12 relative norm at K 4, 8, 16 of V 32 and 64, T 1 to
  96 (a chunk, one short of it, one past it, short last chunks).
- Key slices against the JAX package: a square problem of head dim 32 cut
  into eight K = 4 slices, each through the composed twins; the slices'
  y and dv shares summed and their state, dr, dk, dw, du and dstate rows
  joined equal ``repro.layers.rwkv6.wkv6_chunked`` (T 96) and ``wkv6_ref``
  (T 70) and ``jax.grad`` of each, float32 within 1e-5 relative norm.
  Decays in [-1, -0.01]: the reference's chunked form takes ``exp``
  before it masks (ROADMAP queue 3).
- The wrappers (``kernels/rwkv6_wkv/ops.py``): on CPU tensors each pass's
  wrapper is its twin, bit for bit; on ``meta`` ``wkv6_keyslice`` and
  ``wkv6_keyslice_bwd`` each make one trace entry with ``keyslice_cost``
  / ``keyslice_bwd_cost``, and a pass alone refuses ``meta``.
- ``cuda``-marked (they skip here): each kernel against its twin on the
  card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv import ops, ref

B, H = 2, 3
SLICES = [(K, V) for V in (32, 64) for K in (4, 8, 16)]
LENGTHS = (1, 5, 31, 32, 33, 70, 96)
GRADS = ("dr", "dk", "dv", "dw", "du", "dstate")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one intra-op thread keeps them from spinning
    against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(T, K, V, seed=0, B=B, H=H):
    """r, k, w (B,T,H,K), v (B,T,H,V), u (H,K), the state (B,H,K,V), dy
    (B,T,H,V) and dstate_out (B,H,K,V) as float64 numpy arrays from one
    seed; w = -uniform(0.01, 1)."""
    rng = np.random.default_rng(seed)
    r, k = rng.standard_normal((2, B, T, H, K))
    v = rng.standard_normal((B, T, H, V))
    w = -rng.uniform(0.01, 1.0, (B, T, H, K))
    return (r, k, v, w, 0.5 * rng.standard_normal((H, K)),
            0.5 * rng.standard_normal((B, H, K, V)),
            rng.standard_normal((B, T, H, V)),
            rng.standard_normal((B, H, K, V)))


def _inputs(T, K, V, dtype=torch.float64, seed=0):
    return tuple(torch.from_numpy(a).to(dtype)
                 for a in _arrays(T, K, V, seed))


def _rel(a, b) -> float:
    a, b = (x.double() if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.array(x, dtype=np.float64))
            for x in (a, b))
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _forward(r, k, v, w, u, s0):
    """The forward's passes composed: chunk sums, the scan, the chunk
    pass -> (y, the final state)."""
    d, delta, _ = ref.wkv6_keyslice_sums_plain(k, v, w)
    states = ref.wkv6_keyslice_scan_plain(d, delta, s0)[0]
    return ref.wkv6_keyslice_chunk_plain(r, k, v, w, u, states)


def _backward(r, k, v, w, u, s0, dy, ds):
    """The backward's passes composed: chunk sums with Gamma, the scan both
    ways, the chunk pass -> (dr, dk, dv, dw, du, dstate, the chunks' entry
    states, their exit-state gradients)."""
    d, delta, gamma = ref.wkv6_keyslice_sums_plain(k, v, w, r, dy)
    states, dstates, dstate = ref.wkv6_keyslice_scan_plain(
        d, delta, s0, gamma, ds)
    dr, dk, dv, dw, du_part = ref.wkv6_bwd_chunk_plain(
        r, k, v, w, u, dy, states, dstates)
    return dr, dk, dv, dw, du_part.sum((0, 2)), dstate, states, dstates


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("K,V", SLICES)
def test_forward_twins_compose_to_the_plain_forward(K, V, T):
    args = _inputs(T, K, V)[:6]
    y, s_out = _forward(*args)
    for fn in (ref.wkv6_ref, ref.wkv6_plain):
        want_y, want_s = fn(*args)
        assert _rel(y, want_y) <= 1e-12, fn.__name__
        assert _rel(s_out, want_s) <= 1e-12, fn.__name__


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("K,V", SLICES)
def test_backward_twins_compose_to_the_plain_backward(K, V, T):
    args = _inputs(T, K, V)
    r, k, v, w, u, s0, dy, ds = args
    *grads, states, dstates = _backward(*args)
    assert _rel(states, ref.wkv6_bwd_states_plain(k, v, w, s0)) <= 1e-12
    want_exits, want_d0 = ref.wkv6_bwd_dstates_plain(r, w, dy, ds)
    assert _rel(dstates, want_exits) <= 1e-12
    assert _rel(grads[5], want_d0) <= 1e-12
    for name, got, want in zip(GRADS, grads,
                               ref.wkv6_backward_plain(*args)):
        assert got.shape == want.shape, name
        assert _rel(got, want) <= 1e-12, name


@pytest.mark.parametrize("T,fwd", [(96, "wkv6_chunked"), (70, "wkv6_ref")])
def test_key_slices_sum_to_the_reference(T, fwd):
    """Eight K = 4 slices of a head-dim-32 state through the composed twins
    against the JAX package's forward and ``jax.grad`` of it."""
    import jax
    import jax.numpy as jnp

    from repro.layers import rwkv6 as jrwkv
    hd, K = 32, 4
    arrays = [a.astype(np.float32) for a in _arrays(T, hd, hd, seed=7)]
    jfwd = getattr(jrwkv, fwd)
    jargs = [jnp.asarray(a) for a in arrays]
    want_y, want_s = jfwd(*jargs[:6])

    def loss(*a):
        y, s = jfwd(*a)
        return jnp.sum(y * jargs[6]) + jnp.sum(s * jargs[7])
    want_g = jax.grad(loss, argnums=tuple(range(6)))(*jargs[:6])

    r, k, v, w, u, s0, dy, ds = (torch.from_numpy(a) for a in arrays)
    y = torch.zeros_like(v)
    s1 = torch.empty_like(s0)
    grads = [torch.empty_like(r), torch.empty_like(k), torch.zeros_like(v),
             torch.empty_like(w), torch.empty_like(u), torch.empty_like(s0)]
    for lo in range(0, hd, K):
        ks = slice(lo, lo + K)
        part = (r[..., ks], k[..., ks], v, w[..., ks], u[:, ks],
                s0[:, :, ks])
        yy, s_out = _forward(*part)
        y += yy
        s1[:, :, ks] = s_out
        g = _backward(*part, dy, ds[:, :, ks])
        grads[0][..., ks], grads[1][..., ks] = g[0], g[1]
        grads[2] += g[2]
        grads[3][..., ks], grads[4][:, ks] = g[3], g[4]
        grads[5][:, :, ks] = g[5]
    assert _rel(y, want_y) <= 1e-5
    assert _rel(s1, want_s) <= 1e-5
    for name, got, want in zip(GRADS, grads, want_g):
        assert np.isfinite(np.asarray(want)).all(), name
        assert _rel(got, want) <= 1e-5, (name, _rel(got, want))


def test_pass_wrappers_on_the_cpu_are_the_twins():
    r, k, v, w, u, s0, dy, ds = _inputs(70, 4, 64, torch.float32, seed=3)
    pairs = [
        (ops.wkv6_keyslice_sums(k, v, w),
         ref.wkv6_keyslice_sums_plain(k, v, w)),
        (ops.wkv6_keyslice_sums(k, v, w, r, dy),
         ref.wkv6_keyslice_sums_plain(k, v, w, r, dy))]
    d, delta, gamma = pairs[1][1]
    pairs += [
        (ops.wkv6_keyslice_scan(d, delta, s0),
         ref.wkv6_keyslice_scan_plain(d, delta, s0)),
        (ops.wkv6_keyslice_scan(d, delta, s0, gamma, ds),
         ref.wkv6_keyslice_scan_plain(d, delta, s0, gamma, ds))]
    states, dstates, _ = pairs[-1][1]
    part = ref.wkv6_bwd_chunk_plain(r, k, v, w, u, dy, states, dstates)
    pairs += [
        (ops.wkv6_keyslice_chunk(r, k, v, w, u, states),
         ref.wkv6_keyslice_chunk_plain(r, k, v, w, u, states)),
        ((ops.wkv6_keyslice_bwd_states(r, k, v, w, u, s0, dy, ds),),
         (ref.wkv6_bwd_states_plain(k, v, w, s0),)),
        (ops.wkv6_keyslice_bwd_dstates(r, k, v, w, u, s0, dy, ds),
         ref.wkv6_bwd_dstates_plain(r, w, dy, ds)),
        (ops.wkv6_keyslice_bwd_chunk(r, k, v, w, u, s0, dy, states,
                                     dstates),
         tuple(part[:4]) + (part[4].sum((0, 2)),))]
    for n, (got, want) in enumerate(pairs):
        assert len(got) == len(want), n
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), n


def _meta(T, K, V):
    bf = dict(dtype=torch.bfloat16, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    return (torch.empty((B, T, H, K), **bf), torch.empty((B, T, H, K), **bf),
            torch.empty((B, T, H, V), **bf), torch.empty((B, T, H, K), **f32),
            torch.empty((H, K), **f32), torch.empty((B, H, K, V), **f32),
            torch.empty((B, T, H, V), **bf), None)


@pytest.mark.parametrize("T", [1, 32, 33, 4096])
def test_meta_calls_make_one_entry_with_their_cost(T):
    """The trace of a call is one entry whatever its passes: the dry run's
    launches a path and its bound stay as they were."""
    args = _meta(T, 4, 64)
    seen = []
    build.META_SINKS.append(seen.append)
    try:
        y, s1 = ops.wkv6_keyslice(*args[:6])
        grads = ops.wkv6_keyslice_bwd(*args)
    finally:
        build.META_SINKS.remove(seen.append)
    assert [e["kernel"] for e in seen] == ["wkv6_keyslice",
                                           "wkv6_keyslice_bwd"]
    assert (y.shape, s1.shape) == ((B, T, H, 64), (B, H, 4, 64))
    assert [tuple(g.shape) for g in grads] == [
        (B, T, H, 4), (B, T, H, 4), (B, T, H, 64), (B, T, H, 4), (H, 4),
        (B, H, 4, 64)]
    assert (seen[0]["flops"], seen[0]["bytes"]) == \
        ops.keyslice_cost(B, T, H, 4, 64)
    assert (seen[1]["flops"], seen[1]["bytes"]) == \
        ops.keyslice_bwd_cost(B, T, H, 4, 64)


def test_pass_wrappers_refuse_meta():
    r, k, v, w, u, s0, dy, _ = _meta(40, 4, 64)
    ds = torch.empty_like(s0)
    states = torch.empty((B, H, 2, 4, 64), dtype=torch.float32,
                         device="meta")
    d = torch.empty((B, H, 2, 4), dtype=torch.float32, device="meta")
    calls = [lambda: ops.wkv6_keyslice_sums(k, v, w),
             lambda: ops.wkv6_keyslice_sums(k, v, w, r, dy),
             lambda: ops.wkv6_keyslice_scan(d, states, s0),
             lambda: ops.wkv6_keyslice_chunk(r, k, v, w, u, states),
             lambda: ops.wkv6_keyslice_bwd_states(r, k, v, w, u, s0, dy, ds),
             lambda: ops.wkv6_keyslice_bwd_dstates(r, k, v, w, u, s0, dy,
                                                   ds),
             lambda: ops.wkv6_keyslice_bwd_chunk(r, k, v, w, u, s0, dy,
                                                 states, states)]
    for call in calls:
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 31, 33, 70, 1031])
@pytest.mark.parametrize("K,V", SLICES)
def test_cuda_each_pass_matches_its_twin(K, V, T, dtype):
    """Every kernel alone against its twin on the same inputs (the later
    passes from the twins' summaries and states), then the whole calls:
    float32 within 1e-4, bf16 within 2e-2 relative norm."""
    dev = _cuda()
    r, k, v, w, u, s0, dy, ds = (x.to(dev) for x in _inputs(
        T, K, V, torch.float32, seed=4))
    r, k, v, dy = (x.to(dtype) for x in (r, k, v, dy))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    d, delta, gamma = ref.wkv6_keyslice_sums_plain(k, v, w, r, dy)
    states, dstates, dstate = ref.wkv6_keyslice_scan_plain(
        d, delta, s0, gamma, ds)
    part = ref.wkv6_bwd_chunk_plain(r, k, v, w, u, dy, states, dstates)
    checks = [
        (ops.wkv6_keyslice_sums(k, v, w)[:2], (d, delta)),
        (ops.wkv6_keyslice_sums(k, v, w, r, dy), (d, delta, gamma)),
        (ops.wkv6_keyslice_scan(d, delta, s0)[:1], (states,)),
        (ops.wkv6_keyslice_scan(d, delta, s0, gamma, ds),
         (states, dstates, dstate)),
        (ops.wkv6_keyslice_chunk(r, k, v, w, u, states),
         ref.wkv6_keyslice_chunk_plain(r, k, v, w, u, states)),
        (ops.wkv6_keyslice_bwd_chunk(r, k, v, w, u, s0, dy, states, dstates),
         tuple(part[:4]) + (part[4].sum((0, 2)),)),
        ((ops.wkv6_keyslice_bwd_states(r, k, v, w, u, s0, dy, ds),),
         (states,)),
        (ops.wkv6_keyslice_bwd_dstates(r, k, v, w, u, s0, dy, ds),
         (dstates, dstate)),
        (ops.wkv6_keyslice(r, k, v, w, u, s0), ref.wkv6_ref(r, k, v, w, u,
                                                            s0)),
        (ops.wkv6_keyslice_bwd(r, k, v, w, u, s0, dy, ds),
         ref.wkv6_backward_plain(r, k, v, w, u, s0, dy, ds))]
    torch.cuda.synchronize()
    for n, (got, want) in enumerate(checks):
        for a, b in zip(got, want):
            assert _rel(a.float().cpu(), b.float().cpu()) <= tol, n
