"""The backward of the RWKV-6 WKV recurrence over a key slice of the state
(K of a head's V key rows: the partitioned train step's share), on the CPU.

- ``wkv6_backward_plain`` (``repro_torch/kernels/rwkv6_wkv/ref.py``), the
  plain twin of the key-slice backward kernel ``csrc/wkv6_keyslice_bwd.cu``,
  at a rectangular state against autograd of the scan ``wkv6_ref`` in
  float64 at K 4, 8 and 16 of V 32 and 64, T 70 (a short last chunk) and
  T 5, within 1e-10 relative norm per gradient.
- Key slices of a whole state: each slice's dr, dk, dw, du and dstate
  are the whole's rows of the slice, and the slices' dv shares sum to the
  whole's dv.
- The ``WKV6KeySlice`` autograd op on CPU tensors: ``wkv6`` takes it under
  autograd for a rectangular state, forward and backward equal to the
  plain twins bit for bit; ``gradcheck`` in float64.
- On ``meta`` tensors (the dry run's trace) the backward makes one
  ``meta_call`` entry with ``keyslice_bwd_cost``, and the kernel's
  refusals.
- ``cuda``-marked: the kernel against the plain twin on the card (they
  skip here), within the WKV backward's 2e-2 of the plain norm in bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv import ops
from repro_torch.kernels.rwkv6_wkv.ref import (wkv6_backward_plain,
                                               wkv6_plain, wkv6_ref)

B, H = 2, 3
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
SLICES = [(K, V) for V in (32, 64) for K in (4, 8, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one intra-op thread keeps them from spinning
    against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(T, K, V, dtype=torch.float64, seed=0, decay=1.0, B=B, H=H):
    """r, k, w (B,T,H,K), v, dy (B,T,H,V), u (H,K), state and dstate_out
    (B,H,K,V) from one numpy seed; w = -decay x uniform(0.01, 1)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)
    r, k, v = t(B, T, H, K), t(B, T, H, K), t(B, T, H, V)
    w = torch.from_numpy(-decay * rng.uniform(0.01, 1.0, (B, T, H, K))
                         ).to(dtype)
    return (r, k, v, w, t(H, K, scale=0.5), t(B, H, K, V, scale=0.5),
            t(B, T, H, V), t(B, H, K, V))


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300))


def _autograd(r, k, v, w, u, s0, dy, ds):
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s1 = wkv6_ref(*leaves)
    loss = (y * dy).sum() + (s1 * ds).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("T", [70, 5])
@pytest.mark.parametrize("K,V", SLICES)
def test_plain_backward_of_a_key_slice_matches_autograd(K, V, T):
    args = _inputs(T, K, V)
    got = wkv6_backward_plain(*args)
    want = _autograd(*args)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-10, (name, _rel(a, b))


@pytest.mark.parametrize("K,V", SLICES)
def test_key_slices_hold_the_whole_rows_and_share_dv(K, V):
    """The whole state's (V x V) backward, then each K-row slice's: the
    slice's dr, dk, dw, du and dstate are the whole's rows, its dv a share
    and the shares sum to the whole's dv."""
    r, k, v, w, u, s0, dy, ds = _inputs(70, V, V, seed=1)
    whole = wkv6_backward_plain(r, k, v, w, u, s0, dy, ds)
    dv = torch.zeros_like(whole[2])
    for lo in range(0, V, K):
        ks = slice(lo, lo + K)
        part = wkv6_backward_plain(r[..., ks], k[..., ks], v, w[..., ks],
                                   u[:, ks], s0[:, :, ks], dy, ds[:, :, ks])
        rows = (whole[0][..., ks], whole[1][..., ks], None,
                whole[3][..., ks], whole[4][:, ks], whole[5][:, :, ks])
        for name, got, want in zip(NAMES, part, rows):
            if want is not None:
                assert _rel(got, want) <= 1e-12, (name, lo)
        dv += part[2]
    assert _rel(dv, whole[2]) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keyslice_op_on_the_cpu_is_the_plain_twin(dtype):
    r, k, v, w, u, s0, dy, ds = _inputs(70, 8, 64, torch.float32, seed=2)
    r, k, v, dy = (x.to(dtype) for x in (r, k, v, dy))
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s1 = ops.wkv6(*leaves)
    assert y.grad_fn.name() == "WKV6KeySliceBackward"
    fy, fs = wkv6_plain(r, k, v, w, u, s0)
    assert torch.equal(y, fy) and torch.equal(s1, fs)
    got = torch.autograd.grad((y.float() * dy.float()).sum()
                              + (s1 * ds).sum(), leaves)
    want = wkv6_backward_plain(r, k, v, w, u, s0,
                               (dy.float().to(dtype)), ds)
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b.to(a.dtype)), name
    # without a gradient wanted, the forward alone
    with torch.no_grad():
        y2, _ = ops.wkv6(*leaves)
    assert y2.grad_fn is None and torch.equal(y2, fy)


def test_keyslice_op_gradcheck():
    """At a tiny shape across the plain backward's 32-token chunk."""
    args = _inputs(34, 2, 4, seed=3, B=1, H=2)[:6]
    leaves = tuple(x.clone().requires_grad_() for x in args)
    assert torch.autograd.gradcheck(ops.WKV6KeySlice.apply, leaves,
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def _meta(B_, T, H_, K, V):
    """The backward's operands on ``meta``, bf16 r/k/v/dy, dstate_out
    None."""
    bf = dict(dtype=torch.bfloat16, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    return (torch.empty((B_, T, H_, K), **bf),
            torch.empty((B_, T, H_, K), **bf),
            torch.empty((B_, T, H_, V), **bf),
            torch.empty((B_, T, H_, K), **f32),
            torch.empty((H_, K), **f32), torch.empty((B_, H_, K, V), **f32),
            torch.empty((B_, T, H_, V), **bf), None)


def test_meta_backward_makes_one_trace_entry_with_its_cost():
    seen = []
    build.META_SINKS.append(seen.append)
    try:
        out = ops.wkv6_keyslice_bwd(*_meta(4, 4096, 40, 4, 64))
    finally:
        build.META_SINKS.remove(seen.append)
    assert [e["kernel"] for e in seen] == ["wkv6_keyslice_bwd"]
    assert [tuple(t.shape) for t in out] == [
        (4, 4096, 40, 4), (4, 4096, 40, 4), (4, 4096, 40, 64),
        (4, 4096, 40, 4), (40, 4), (4, 40, 4, 64)]
    flops, nbytes = ops.keyslice_bwd_cost(4, 4096, 40, 4, 64)
    assert (seen[0]["flops"], seen[0]["bytes"]) == (flops, nbytes)
    # a pod256 rank's rwkv6-3b train_4k micro-batch: 448 bytes a token
    # and head (r, k, dr, dk 8 each, w, dw 16 each, v, dy, dv 128 each)
    # besides the state slices
    _, _, moved = ops.keyslice_bwd_work(4, 4096, 40, 4, 64)
    assert moved == 448 * 4 * 4096 * 40 + 3 * 4 * 40 * 4 * 64 * 4 \
        + 2 * 40 * 4 * 4
    # under autograd on meta, forward and backward each leave one entry
    seen = []
    build.META_SINKS.append(seen.append)
    try:
        leaves = [t.requires_grad_() if t.is_floating_point() else t
                  for t in _meta(2, 7, 3, 4, 64)[:6]]
        y, _ = ops.wkv6(*leaves)
        y.float().sum().backward()
    finally:
        build.META_SINKS.remove(seen.append)
    assert [e["kernel"] for e in seen] == ["wkv6_keyslice",
                                           "wkv6_keyslice_bwd"]


def test_backward_refuses_what_the_kernel_does_not_take():
    for K, V in ((3, 64), (32, 64), (64, 128)):
        with pytest.raises(ValueError):
            ops.wkv6_keyslice_bwd(*_meta(2, 7, 3, K, V))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 19, 70, 257])
@pytest.mark.parametrize("K,V", SLICES)
def test_cuda_keyslice_bwd_matches_plain(K, V, T, dtype):
    dev = _cuda()
    args = _inputs(T, K, V, torch.float32, seed=4)
    r, k, v, w, u, s0, dy, ds = (x.to(dev) for x in args)
    r, k, v, dy = (x.to(dtype) for x in (r, k, v, dy))
    before = build.launch_counts().get("wkv6_keyslice_bwd", 0)
    got = ops.wkv6_keyslice_bwd(r, k, v, w, u, s0, dy, ds)
    want = wkv6_backward_plain(r, k, v, w, u, s0, dy, ds)
    torch.cuda.synchronize()
    assert build.launch_counts()["wkv6_keyslice_bwd"] == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(NAMES, got, want):
        assert _rel(a.float(), b.float()) <= tol, (name, _rel(a, b))


@pytest.mark.cuda
def test_cuda_keyslice_op_through_autograd_matches_plain():
    dev = _cuda()
    args = _inputs(300, 4, 64, torch.float32, seed=5)
    r, k, v, w, u, s0, dy, ds = (x.to(dev) for x in args)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s1 = ops.wkv6(*leaves)
    got = torch.autograd.grad((y * dy).sum() + (s1 * ds).sum(), leaves)
    want = wkv6_backward_plain(r, k, v, w, u, s0, dy, ds)
    for name, a, b in zip(NAMES, got, want):
        assert _rel(a, b) <= 1e-4, name
