"""The port's kernels of the serving paths against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; those are held here
against the reference's Pallas kernels in interpret mode on the same numpy
inputs: the four paged attention kernels (mixed, chunked prefill, decode
over the fused pool and over split pools) at 3e-5 (float32) / 3e-2
(bfloat16), page append, gather and scatter exactly. The packed step's
page writer (``write_kv_rows``) equals the reference's two writers together,
``append_kv`` in interpret mode for the decode lanes and
``write_chunk_pages`` for the chunk rows, exactly at every page but scratch
(which takes duplicate writes of idle lanes, pad rows and chunk padding).
``test_torch_cuda.py`` holds the CUDA kernels against these plain versions
on a card.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_gather.kernel import gather_pages as j_gather
from repro.kernels.kv_gather.kernel import scatter_pages as j_scatter
from repro.kernels.paged_attention.kernel import append_kv as j_append
from repro.kernels.paged_attention.kernel import paged_attention as j_split
from repro.kernels.paged_attention.kernel import \
    paged_attention_pool as j_pool
from repro.kernels.paged_attention.kernel import \
    paged_mixed_attention_pool as j_mixed
from repro.kernels.paged_attention.kernel import \
    paged_prefill_attention_pool as j_prefill
from repro.layers.attention import write_chunk_pages as j_write_chunk
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.kv_gather import ops as kv_ops
from repro_torch.kernels.kv_gather import ref as kv_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.layers import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, name):
    """One numpy array as a JAX array and a torch tensor of ``name``."""
    jd, td = DTYPES[name]
    return (jnp.asarray(a, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mixed_inputs(seed, R, Tc, H, K, hd, P, page, pps, starts, n_reals,
                  is_dec):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((R, Tc, H, hd)),
                pool=rng.standard_normal((P, 2, K, page, hd)),
                bt=rng.integers(0, P, (R, pps)).astype(np.int32),
                starts=np.asarray(starts, np.int32),
                n_reals=np.asarray(n_reals, np.int32),
                is_dec=np.asarray(is_dec, np.int32))


MIXED_CASES = {
    # the reference's test_mixed_kernel_matches_ref plan: 2 decode lanes,
    # a chunk row and a pad row
    "ref_plan": (0, 4, 8, 4, 2, 32, 12, 8, 4, [5, 9, 0, 3], [1, 1, 6, 0],
                 [1, 1, 0, 0]),
    # MHA (G=1, as qwen), a mid-page chunk start, hd 64, 16-token pages
    "mha_midpage": (1, 3, 16, 4, 4, 64, 10, 16, 3, [20, 13, 0],
                    [1, 16, 0], [1, 0, 0]),
    # pages wider than a warp, grouped heads G=4
    "wide_page": (2, 2, 4, 8, 2, 32, 6, 40, 2, [70, 33], [1, 4], [1, 0]),
    # a decode-only step (Tc = 1, every row a live decode lane), as the
    # engine packs it when no prompt chunk is scheduled
    "decode_only": (4, 4, 1, 4, 4, 64, 30, 16, 6, [77, 5, 40, 0],
                    [1, 1, 1, 1], [1, 1, 1, 1]),
    # gemma-7b's head dim 256, and internvl2-1b's odd group G = 7
    "hd256": (5, 3, 8, 2, 2, 256, 10, 16, 3, [20, 13, 0], [1, 8, 0],
              [1, 0, 0]),
    "g7": (6, 3, 8, 14, 2, 64, 10, 16, 3, [20, 5, 0], [1, 8, 0], [1, 0, 0]),
    # dbrx-132b's group G = 6 at head dim 128
    "g6": (10, 3, 8, 12, 2, 128, 10, 16, 3, [20, 5, 0], [1, 8, 0],
           [1, 0, 0]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_mixed_attention_plain_matches_reference_kernel(case, dtype):
    x = _mixed_inputs(*MIXED_CASES[case])
    jq, tq = _both(x["q"], dtype)
    jp, tp = _both(x["pool"], dtype)
    meta = [x["bt"], x["starts"], x["n_reals"], x["is_dec"]]
    ref = j_mixed(jq, jp, *[jnp.asarray(m) for m in meta], interpret=True)
    out = pa_ops.paged_mixed_attention_pool(
        tq, tp, *[torch.from_numpy(m) for m in meta])
    tol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)


# the reference's test_paged_attention_sweep shapes (GQA, GQA, MHA, MQA)
# as (B, H, K, hd, P, page, pps), each with a row at lengths == 1 and
# (where B > 1) a row at lengths == 0, plus a case of the edges alone
DECODE_CASES = {
    "gqa": ((2, 4, 2, 64, 16, 8, 4), [1, 0]),
    "gqa_hd32": ((3, 6, 2, 32, 32, 16, 6), [1, 57, 0]),
    "mha": ((1, 8, 8, 128, 8, 8, 8), [1]),
    "mqa": ((4, 8, 1, 64, 64, 32, 4), [1, 100, 128, 0]),
    "edges": ((3, 4, 2, 32, 12, 8, 5), [0, 1, 40]),
    "hd256": ((2, 4, 4, 256, 10, 16, 3), [40, 0]),
    "g7": ((2, 14, 2, 64, 10, 16, 3), [33, 1]),
    "g6": ((2, 12, 2, 128, 10, 16, 3), [33, 1]),
}


def _decode_inputs(case, seed=6):
    (B, H, K, hd, P, page, pps), lengths = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((B, H, hd)),
                pool=rng.standard_normal((P, 2, K, page, hd)),
                bt=rng.integers(0, P, (B, pps)).astype(np.int32),
                lengths=np.asarray(lengths, np.int32))


def _split(pool):
    """The fused pool's K and V halves as (K, P, page, hd)."""
    if torch.is_tensor(pool):
        return pool[:, 0].movedim(1, 0), pool[:, 1].movedim(1, 0)
    return jnp.moveaxis(pool[:, 0], 1, 0), jnp.moveaxis(pool[:, 1], 1, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["split", "pool"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_plain_matches_reference_kernel(case, layout,
                                                         dtype):
    x = _decode_inputs(case)
    jq, tq = _both(x["q"], dtype)
    jp, tp = _both(x["pool"], dtype)
    jbt, jln = jnp.asarray(x["bt"]), jnp.asarray(x["lengths"])
    tbt, tln = torch.from_numpy(x["bt"]), torch.from_numpy(x["lengths"])
    if layout == "split":
        jk, jv = (jnp.asarray(a) for a in _split(jp))
        ref = j_split(jq, jk, jv, jbt, jln, interpret=True)
        out = pa_ops.paged_attention(tq, *_split(tp), tbt, tln)
    else:
        ref = j_pool(jq, jp, jbt, jln, interpret=True)
        out = pa_ops.paged_attention_pool(tq, tp, tbt, tln)
    tol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)
    # a sequence with no tokens gets the uniform mean over every swept key
    (B, H, K, hd, P, page, pps), _ = DECODE_CASES[case]
    G = H // K
    for b in np.nonzero(x["lengths"] == 0)[0]:
        v = _np(tp)[x["bt"][b], 1]                    # (pps, K, page, hd)
        mean = v.transpose(1, 0, 2, 3).reshape(K, pps * page, hd).mean(1)
        np.testing.assert_allclose(_np(out)[b], np.repeat(mean, G, axis=0),
                                   atol=tol)


# the reference's test_chunk_kernel_matches_ref plan (mid-page chunk starts
# 3 and 10) as (B, Tc, H, K, hd, P, page, pps, starts), and an MHA chunk of
# 16-token pages over a page boundary
PREFILL_CASES = {
    "ref_plan": (2, 6, 4, 2, 32, 16, 8, 4, [3, 10]),
    "mha_midpage": (2, 16, 4, 4, 64, 12, 16, 3, [0, 21]),
    "hd256": (1, 8, 2, 2, 256, 8, 16, 3, [13]),
    "g7": (1, 9, 14, 2, 64, 8, 16, 3, [5]),
    "g6": (1, 11, 12, 2, 128, 8, 16, 3, [5]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_attention_plain_matches_reference_kernel(case, dtype):
    B, Tc, H, K, hd, P, page, pps, starts = PREFILL_CASES[case]
    rng = np.random.default_rng(0)
    jq, tq = _both(rng.standard_normal((B, Tc, H, hd)), dtype)
    jp, tp = _both(rng.standard_normal((P, 2, K, page, hd)), dtype)
    bt = rng.integers(0, P, (B, pps)).astype(np.int32)
    starts = np.asarray(starts, np.int32)
    ref = j_prefill(jq, jp, jnp.asarray(bt), jnp.asarray(starts),
                    interpret=True)
    out = pa_ops.paged_prefill_attention_pool(tq, tp, torch.from_numpy(bt),
                                              torch.from_numpy(starts))
    tol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_kv_plain_matches_reference_kernel(dtype):
    rng = np.random.default_rng(5)
    P, K, page, hd, B = 10, 2, 8, 32, 4
    pool = rng.standard_normal((P, 2, K, page, hd))
    k, v = (rng.standard_normal((B, K, hd)) for _ in range(2))
    slots = np.asarray([3, 7, 0, 0], np.int32)      # idle lanes on scratch 0
    offs = np.asarray([5, 0, 0, 0], np.int32)
    k[3], v[3] = k[2], v[2]                         # idle lanes: same data
    jp, tp = _both(pool, dtype)
    (jk, tk), (jv, tv) = _both(k, dtype), _both(v, dtype)
    ref = j_append(jp, jk, jv, jnp.asarray(slots), jnp.asarray(offs),
                   interpret=True)
    out = pa_ops.append_kv(tp, tk, tv, torch.from_numpy(slots),
                           torch.from_numpy(offs))
    assert out is tp                                # in place
    np.testing.assert_array_equal(_np(out), _np(ref))


# the packed step's page writes: page, Tc, table width W and rows of
# (kind, q_start, n_real) — "dec" a decode lane, "idle" an idle lane on
# scratch, "chunk" a prompt chunk row (n_real 0: a bucket-pad row)
WRITER_CASES = {
    "decode_idle_lanes": (8, 1, 6, [("dec", 13, 1), ("dec", 30, 1),
                                    ("idle", 0, 1), ("idle", 0, 1)]),
    "chunk_from_mid_page": (8, 12, 6, [("dec", 9, 1), ("chunk", 5, 12),
                                       ("chunk", 0, 0)]),
    "chunk_crossing_pages": (8, 16, 8, [("dec", 3, 1), ("chunk", 20, 16)]),
    "tc_below_one_page": (16, 5, 5, [("dec", 47, 1), ("chunk", 35, 3)]),
    "pad_rows": (8, 8, 4, [("dec", 2, 1), ("chunk", 0, 8), ("chunk", 0, 0),
                           ("chunk", 0, 0), ("chunk", 0, 0)]),
    # the window (pages 3..5) ends at the table's last entry; the padding
    # past the chunk's 4 pages lands on the table's scratch tail
    "window_reaches_scratch_tail": (8, 16, 6, [("chunk", 26, 5)]),
}
SCRATCH = 0


def _writer_inputs(case, seed=11, K=2, hd=32, P=40):
    page, T, W, rows = WRITER_CASES[case]
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(np.arange(1, P)))
    bt = np.full((len(rows), W), SCRATCH, np.int32)
    for r, (kind, q, n) in enumerate(rows):
        need = 0 if kind == "idle" or n == 0 else -(-(q + n) // page)
        bt[r, :need], free = free[:need], free[need:]
    return dict(page=page, T=T, rows=rows, bt=bt,
                pool=rng.standard_normal((P, 2, K, page, hd)),
                k=rng.standard_normal((len(rows), T, K, hd)),
                v=rng.standard_normal((len(rows), T, K, hd)),
                q_starts=np.asarray([q for _, q, _ in rows], np.int32),
                n_reals=np.asarray([n for _, _, n in rows], np.int32),
                n_dec=sum(kind != "chunk" for kind, _, _ in rows))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_write_kv_rows_plain_matches_reference_writers(case, dtype):
    """One ``write_kv_rows`` call (n_write as ``step_meta`` makes it) ==
    the reference's ``append_kv`` over the decode lanes then
    ``write_chunk_pages`` per chunk row == the port's own old pair, at every
    page but scratch."""
    _check_writer(case, dtype, hd=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["chunk_from_mid_page",
                                  "window_reaches_scratch_tail"])
def test_write_kv_rows_plain_matches_reference_writers_hd256(case, dtype):
    """The same at gemma-7b's head dim 256."""
    _check_writer(case, dtype, hd=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["chunk_from_mid_page",
                                  "window_reaches_scratch_tail"])
def test_write_kv_rows_plain_matches_reference_writers_k8_hd128(case, dtype):
    """The same at dbrx-132b's and codellama-34b's 8 KV heads of 128."""
    _check_writer(case, dtype, hd=128, K=8)


def _check_writer(case, dtype, hd, K=2):
    x = _writer_inputs(case, hd=hd, K=K)
    page, T, n_dec, bt = x["page"], x["T"], x["n_dec"], x["bt"]
    jp, tp = _both(x["pool"], dtype)
    (jk, tk), (jv, tv) = _both(x["k"], dtype), _both(x["v"], dtype)
    old = tp.clone()
    win = pa_ref.window_pages(T, page)
    if n_dec:
        pos = x["q_starts"][:n_dec]
        slots = bt[np.arange(n_dec), pos // page].astype(np.int32)
        offs = (pos % page).astype(np.int32)
        jp = j_append(jp, jk[:n_dec, 0], jv[:n_dec, 0], jnp.asarray(slots),
                      jnp.asarray(offs), interpret=True)
        pa_ref.append_kv_ref(old, tk[:n_dec, 0], tv[:n_dec, 0],
                             torch.from_numpy(slots), torch.from_numpy(offs))
    for r in range(n_dec, len(x["rows"])):
        q = int(x["q_starts"][r])
        window = bt[r, q // page:q // page + win]
        jp = j_write_chunk(jp, jk[r:r + 1], jv[r:r + 1], jnp.asarray(window),
                           q % page, page_tokens=page)
        pa_ref.write_chunk_pages(old, tk[r:r + 1], tv[r:r + 1],
                                 torch.from_numpy(window).long(), q % page,
                                 page_tokens=page)
    meta = tattn.step_meta(x["q_starts"], x["n_reals"], n_dec, T, "cpu")
    out = pa_ops.write_kv_rows(tp, tk, tv, torch.from_numpy(bt),
                               meta["q_starts"], meta["n_write"])
    assert out is tp                                # in place
    real = np.arange(x["pool"].shape[0]) != SCRATCH
    np.testing.assert_array_equal(_np(out)[real], _np(jp)[real])
    np.testing.assert_array_equal(_np(out)[real], _np(old)[real])


@pytest.mark.parametrize("entry", ["mixed", "prefill_chunk"])
def test_layers_write_pages_through_one_writer_call(monkeypatch, entry):
    """One ``attention_mixed_paged`` (or ``attention_prefill_chunk``) call
    on the kernel path makes exactly one ``write_kv_rows`` call, and neither
    ``append_kv`` nor ``write_chunk_pages``."""
    calls = []
    for mod, name in ((pa_ops, "write_kv_rows"), (pa_ops, "append_kv"),
                      (pa_ref, "write_chunk_pages")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    assert not hasattr(tattn, "write_chunk_pages")
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    mix = tattn.Attention(cfg, "cpu", generator=torch.Generator()
                          .manual_seed(0))
    x = _writer_inputs("pad_rows", K=cfg.n_kv_heads,
                       hd=cfg.resolved_head_dim)
    pool = torch.from_numpy(x["pool"]).float()
    bt = torch.from_numpy(x["bt"])
    rng = np.random.default_rng(0)
    if entry == "mixed":
        h = torch.from_numpy(rng.standard_normal(
            (len(x["rows"]), x["T"], cfg.d_model))).float()
        tattn.attention_mixed_paged(mix, cfg, h, pool, bt, x["q_starts"],
                                    x["n_reals"], n_decode=x["n_dec"],
                                    impl="kernel")
    else:
        h = torch.from_numpy(rng.standard_normal(
            (1, x["T"], cfg.d_model))).float()
        tattn.attention_prefill_chunk(mix, cfg, h, pool, bt[1], 0,
                                      impl="kernel")
    assert calls == ["write_kv_rows"]


def _pool(rng, shape, dtype):
    if dtype == "int8":
        a = rng.integers(-100, 100, shape)
        return jnp.asarray(a, jnp.int8), torch.from_numpy(a.astype(np.int8))
    return _both(rng.standard_normal(shape), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("P,page,d,n", [(16, 8, 32, 5), (64, 16, 128, 64),
                                        (8, 4, 8, 1)])
def test_gather_plain_matches_reference_kernel(P, page, d, n, dtype):
    rng = np.random.default_rng(3)
    jp, tp = _pool(rng, (P, page, d), dtype)
    ids = rng.choice(P, n, replace=False).astype(np.int32)
    ref = j_gather(jp, jnp.asarray(ids), interpret=True)
    out = kv_ops.gather_pages(tp, torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("P,n", [(2, 1), (9, 4), (32, 16), (17, 17)])
def test_gather_scatter_roundtrip_matches_reference(P, n):
    rng = np.random.default_rng(P * 31 + n)
    pool = rng.standard_normal((P, 8, 16)).astype(np.float32)
    ids = rng.choice(P, n, replace=False).astype(np.int32)
    tpool = torch.from_numpy(pool.copy())
    tids = torch.from_numpy(ids)
    staging = kv_ops.gather_pages(tpool, tids)
    kv_ops.scatter_pages(tpool, staging, tids)
    np.testing.assert_array_equal(tpool.numpy(), pool)
    new = np.full((n, 8, 16), 7.0, np.float32)
    ref = j_scatter(jnp.asarray(pool), jnp.asarray(new), jnp.asarray(ids),
                    interpret=True)
    out = kv_ops.scatter_pages(tpool, torch.from_numpy(new), tids)
    assert out is tpool                             # in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gather_scatter_fold_any_payload():
    """A (P, 2, K, page, hd) KV page moves as flat bytes, like ``_canon``."""
    rng = np.random.default_rng(9)
    pool = torch.from_numpy(rng.standard_normal((6, 2, 2, 4, 8)))
    ids = torch.tensor([4, 1], dtype=torch.int32)
    staging = kv_ops.gather_pages(pool, ids)
    assert tuple(staging.shape) == (2, 2, 2, 4, 8)
    assert torch.equal(staging, pool[[4, 1]])


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(kv_ops, "gather_pages_ref",
                        spy(kv_ref.gather_pages_ref))
    monkeypatch.setattr(kv_ops, "scatter_pages_ref",
                        spy(kv_ref.scatter_pages_ref))
    monkeypatch.setattr(pa_ops, "append_kv_ref", spy(pa_ref.append_kv_ref))
    monkeypatch.setattr(pa_ops, "paged_mixed_attention_pool_ref",
                        spy(pa_ref.paged_mixed_attention_pool_ref))
    build.reset_launch_counts()
    x = _mixed_inputs(*MIXED_CASES["ref_plan"])
    q = torch.from_numpy(x["q"]).float()
    pool = torch.from_numpy(x["pool"]).float()
    ids = torch.tensor([1, 2], dtype=torch.int32)
    kv_ops.scatter_pages(pool, kv_ops.gather_pages(pool, ids), ids)
    pa_ops.append_kv(pool, q[:2, 0, :2], q[:2, 0, 2:], ids, ids)
    pa_ops.paged_mixed_attention_pool(
        q, pool, *[torch.from_numpy(x[k])
                   for k in ("bt", "starts", "n_reals", "is_dec")])
    assert calls == ["gather_pages_ref", "scatter_pages_ref",
                     "append_kv_ref", "paged_mixed_attention_pool_ref"]
    assert build.launch_counts() == {}              # no kernel launched


def test_cpu_tensors_take_the_plain_per_request_versions(monkeypatch):
    calls = []
    for name in ("paged_attention_ref", "paged_attention_pool_ref",
                 "paged_prefill_attention_pool_ref"):
        fn = getattr(pa_ref, name)
        monkeypatch.setattr(pa_ops, name,
                            lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    build.reset_launch_counts()
    x = _decode_inputs("gqa")
    q = torch.from_numpy(x["q"]).float()
    pool = torch.from_numpy(x["pool"]).float()
    bt, ln = torch.from_numpy(x["bt"]), torch.from_numpy(x["lengths"])
    pa_ops.paged_attention(q, *_split(pool), bt, ln)
    pa_ops.paged_attention_pool(q, pool, bt, ln)
    pa_ops.paged_prefill_attention_pool(q[:, None], pool, bt, ln)
    assert calls == ["paged_attention_ref", "paged_attention_pool_ref",
                     "paged_prefill_attention_pool_ref"]
    assert build.launch_counts() == {}              # no kernel launched


def test_kernel_modules_import_without_nvcc(monkeypatch, tmp_path):
    """This module imported every kernel module already; building is what
    needs nvcc, and without it the build fails loudly, writing nothing."""
    b = build
    monkeypatch.setattr(b.shutil, "which", lambda _: None)
    monkeypatch.setattr(b, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    monkeypatch.setattr(b, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        b.build()
    assert not (tmp_path / "build").exists()


def test_every_csrc_kernel_notes_what_it_replaces():
    """Each CUDA source names the TPU kernel it replaces, its bound on the
    card and what its design does about it."""
    csrc = Path(build.CSRC)
    sources = sorted(csrc.glob("*.cu"))
    assert [s.name for s in sources] == ["flash_attention.cu",
                                         "kv_gather.cu",
                                         "paged_attention.cu", "wkv6.cu",
                                         "wkv6_bwd.cu", "wkv6_keyslice.cu",
                                         "wkv6_keyslice_bwd.cu"]
    for s in sources:
        text = s.read_text()
        assert "Replaces" in text or "replaces" in text
        assert "src/repro/kernels/" in text
        assert "Bound:" in text and "design" in text.lower()
    names = set()
    for s in sources:
        for line in s.read_text().splitlines():
            if line.startswith('extern "C" int '):
                names.add(line.split()[3].split("(")[0])
    assert names == set(build._SIGNATURES)
