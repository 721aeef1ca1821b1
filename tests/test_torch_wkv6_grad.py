"""The backward of the RWKV-6 WKV recurrence, on the CPU.

``wkv6_backward_plain`` (``repro_torch/kernels/rwkv6_wkv/ref.py``), the
explicit per-chunk backward the CUDA kernel ``csrc/wkv6_bwd.cu`` is held to
on the card, against:

- autograd through the port's chunked form ``wkv6_chunked`` and its scan
  ``wkv6_ref``, at T in {64, 96, 70, 1} and head dims 64 and 32, in
  float32 at 1e-5 relative norm per gradient (dr, dk, dv, dw, du,
  dstate). At T 70 the plain backward ends on a short chunk of 6 tokens,
  as the kernel does, while the port's chunked forward takes the scan
  there (no chunk length divides 70); at T 1 everything is one step of the
  scan. Decays up to 1 and a strong decay of 8 (the forward sweep's
  stress), both computed with every exponent <= 0.
- ``jax.grad`` of the reference's ``wkv6_chunked`` and ``wkv6_ref``
  (``repro/layers/rwkv6.py``) on the same numpy inputs at 1e-4, at the
  weak decays only: the reference's chunked form takes ``exp`` of the
  upper triangle's positive exponents and is NaN under the strong decay
  (ROADMAP queue 3), which is checked against the port's scan only.
- The ``WKV6`` autograd op on CPU tensors: forward equal to the plain
  forward, backward equal to the plain backward, ``gradcheck`` in float64
  at a tiny shape (across a chunk boundary), and ``wkv6`` taking the op
  only when a gradient is wanted.
- The plain twins of the kernel's three passes, at T in {64, 70, 1} and
  head dims 32 and 64, weak and strong decays, in float32 at 1e-5: pass
  1's entry state of each chunk against the state ``wkv6_ref`` reaches
  after the tokens before it; pass 2's exit-state gradient of each chunk
  against autograd's gradient of the state entering the next chunk (the
  scan split at that boundary, the state a leaf), and its initial-state
  gradient against autograd's; and the three composed (and the CPU pass
  wrappers of ``ops``) equal to ``wkv6_backward_plain`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import rwkv6 as jrwkv
from repro_torch.kernels.rwkv6_wkv import ops
from repro_torch.kernels.rwkv6_wkv.ref import (wkv6_backward_plain,
                                               wkv6_bwd_chunk_plain,
                                               wkv6_bwd_dstates_plain,
                                               wkv6_bwd_states_plain,
                                               wkv6_chunked, wkv6_plain,
                                               wkv6_ref)

B, H = 2, 3
PORT_REL, JAX_REL = 1e-5, 1e-4
SHAPES = [(64, 64), (96, 32), (70, 64), (1, 32)]
PASS_SHAPES = [(T, hd) for T in (64, 70, 1) for hd in (32, 64)]
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one intra-op thread keeps them from spinning
    against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(T, hd, wmax, seed=0):
    """r, k, v, w, u, state, dy, dstate_out as float32 numpy arrays: the
    reference sweep's distributions (w uniform in [-wmax, -1e-3])."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
                   for _ in range(4))
    w = -(rng.random((B, T, H, hd)) * (wmax - 1e-3) + 1e-3).astype(
        np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    ds = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0, dy, ds


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _autograd(fwd, arrays):
    r, k, v, w, u, s0, dy, ds = arrays
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (r, k, v, w, u, s0)]
    y, s = fwd(*leaves)
    loss = (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _plain(arrays):
    return [g.numpy() for g in wkv6_backward_plain(
        *(torch.from_numpy(a) for a in arrays))]


@pytest.mark.parametrize("wmax", [1.0, 8.0])
@pytest.mark.parametrize("fwd", [wkv6_chunked, wkv6_ref],
                         ids=["chunked", "scan"])
@pytest.mark.parametrize("T,hd", SHAPES)
def test_plain_backward_matches_port_autograd(T, hd, fwd, wmax):
    arrays = _inputs(T, hd, wmax)
    got, want = _plain(arrays), _autograd(fwd, arrays)
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        assert _rel(g, w) <= PORT_REL, (name, _rel(g, w))


@pytest.mark.parametrize("fwd", ["wkv6_chunked", "wkv6_ref"])
@pytest.mark.parametrize("T,hd", SHAPES)
def test_plain_backward_matches_jax_grad(T, hd, fwd):
    arrays = _inputs(T, hd, 1.0, seed=1)
    r, k, v, w, u, s0, dy, ds = (jnp.asarray(a) for a in arrays)
    jfwd = getattr(jrwkv, fwd)

    def loss(*a):
        y, s = jfwd(*a)
        return jnp.sum(y * dy) + jnp.sum(s * ds)
    want = jax.grad(loss, argnums=tuple(range(6)))(r, k, v, w, u, s0)
    got = _plain(arrays)
    for name, g, w_ in zip(NAMES, got, want):
        assert np.isfinite(np.asarray(w_)).all(), name
        assert _rel(g, np.asarray(w_)) <= JAX_REL, (name, _rel(g, w_))


def test_autograd_op_on_cpu_equals_the_plain_pair():
    arrays = _inputs(70, 32, 1.0, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
    y, s = ops.wkv6(*leaves)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    want_y, want_s = wkv6_plain(*(torch.from_numpy(a) for a in arrays[:6]))
    assert torch.equal(y.detach(), want_y) and torch.equal(s.detach(), want_s)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(arrays[6])).sum()
        + (s * torch.from_numpy(arrays[7])).sum(), leaves)
    for name, g, w in zip(NAMES, grads, _plain(arrays)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    with torch.no_grad():
        y2, _ = ops.wkv6(*leaves)
    assert y2.grad_fn is None and torch.equal(y2, want_y)


def test_autograd_op_gradcheck_float64():
    rng = np.random.default_rng(3)
    T, hd = 35, 4                       # one whole chunk and a short one
    shapes = [(1, T, 1, hd)] * 3 + [(1, T, 1, hd), (1, hd), (1, 1, hd, hd)]
    leaves = [torch.from_numpy(rng.standard_normal(s)) for s in shapes]
    leaves[3] = -(leaves[3].abs() * 0.5 + 1e-3)            # w <= 0
    leaves[5] = leaves[5] * 0.1
    leaves = [t.requires_grad_() for t in leaves]
    assert torch.autograd.gradcheck(ops.WKV6.apply, leaves, eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


def _torch_inputs(T, hd, wmax, seed):
    return [torch.from_numpy(a) for a in _inputs(T, hd, wmax, seed)]


@pytest.mark.parametrize("wmax", [1.0, 8.0])
@pytest.mark.parametrize("T,hd", PASS_SHAPES)
def test_states_twin_is_the_scans_state_at_each_chunk(T, hd, wmax):
    r, k, v, w, u, s0, _, _ = _torch_inputs(T, hd, wmax, seed=4)
    got = wkv6_bwd_states_plain(k, v, w, s0)
    assert got.shape == (B, H, -(-T // 32), hd, hd)
    for c, t0 in enumerate(range(0, T, 32)):
        want = s0 if t0 == 0 else wkv6_ref(r[:, :t0], k[:, :t0], v[:, :t0],
                                          w[:, :t0], u, s0)[1]
        assert _rel(got[:, :, c], want) <= PORT_REL, (c, _rel(got[:, :, c],
                                                              want))


@pytest.mark.parametrize("wmax", [1.0, 8.0])
@pytest.mark.parametrize("T,hd", PASS_SHAPES)
def test_dstates_twin_is_autograds_gradient_at_each_boundary(T, hd, wmax):
    r, k, v, w, u, s0, dy, ds = _torch_inputs(T, hd, wmax, seed=5)
    got, dstate = wkv6_bwd_dstates_plain(r, w, dy, ds)
    assert got.shape == (B, H, -(-T // 32), hd, hd)
    for c, t0 in enumerate(range(0, T, 32)):
        t1 = min(T, t0 + 32)
        if t1 == T:                     # the last chunk's exit: the output
            want = ds
        else:
            with torch.no_grad():
                mid = wkv6_ref(r[:, :t1], k[:, :t1], v[:, :t1], w[:, :t1],
                               u, s0)[1]
            leaf = mid.clone().requires_grad_()
            y, s = wkv6_ref(r[:, t1:], k[:, t1:], v[:, t1:], w[:, t1:], u,
                            leaf)
            want, = torch.autograd.grad(
                (y * dy[:, t1:]).sum() + (s * ds).sum(), [leaf])
        assert _rel(got[:, :, c], want) <= PORT_REL, (c, _rel(got[:, :, c],
                                                              want))
    leaf = s0.clone().requires_grad_()
    y, s = wkv6_ref(r, k, v, w, u, leaf)
    want, = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), [leaf])
    assert _rel(dstate, want) <= PORT_REL


@pytest.mark.parametrize("T,hd", PASS_SHAPES)
def test_passes_compose_to_the_plain_backward(T, hd):
    args = _torch_inputs(T, hd, 1.0, seed=6)
    r, k, v, w, u, s0, dy, ds = args
    states = wkv6_bwd_states_plain(k, v, w, s0)
    dstates, dstate = wkv6_bwd_dstates_plain(r, w, dy, ds)
    dr, dk, dv, dw, du_part = wkv6_bwd_chunk_plain(r, k, v, w, u, dy,
                                                   states, dstates)
    assert du_part.shape == (B, H, -(-T // 32), hd)
    want = wkv6_backward_plain(*args)
    got = (dr, dk, dv, dw, du_part.sum((0, 2)), dstate)
    wrapped = ops.wkv6_bwd_chunk(r, k, v, w, u, s0, dy,
                                 ops.wkv6_bwd_states(*args),
                                 ops.wkv6_bwd_dstates(*args)[0]) \
        + (ops.wkv6_bwd_dstates(*args)[1],)
    for name, g, c, w_ in zip(NAMES, got, wrapped, want):
        assert torch.equal(g, w_), name
        assert torch.equal(c, w_), name
