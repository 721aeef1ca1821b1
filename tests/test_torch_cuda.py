"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU (``cuda`` marker; every test skips where
``torch.cuda.is_available()`` is false). Imports neither JAX nor ``repro``,
so it runs on a card's machine as it is:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: attention 3e-5 in float32, 3e-2 in bfloat16 (the plain version
rounds the probabilities to bfloat16 before the value product); the page
writer (``write_kv_rows`` and its ``append_kv`` form), gather and scatter
bit-exact; the gather on both of its routes (the bulk copy at the port's
row sizes, the vector kernel for rows that are no multiple of 16 bytes or
start off a 16-byte boundary), an id outside the pool gathering a zero
row and scattering nothing, as the plain versions do. The attention
kernels share their row
arithmetic (float32: one row step; bf16: one decode path and one
tensor-core chunk path), so decode over split pools equals decode over the
fused pool, and a mixed launch's decode lanes and chunk rows equal the
per-request kernels' rows, bit for bit, at every head dim, group size and
page size the cases cover. The WKV recurrence is held against the float32 scan (and the
chunked form) at the reference's ``test_wkv6_sweep`` tolerances: float32
rtol 1e-3 / atol 5e-4, bfloat16 rtol 2e-2 / atol 5e-2 (bf16 rounding of
outputs that grow to ~1e2 under weak decay). Flash attention forward at
the attention tolerances above (the bf16 tensor-core kernels round the
probabilities to bf16 before the value product, as the plain version
does), its row log-sum-exp at rtol 1e-5 over the reference's sweep; the
backward's dq/dk/dv within 1e-4 (float32) and 2e-2 (bfloat16, where the
kernels also round dS to bf16) of the plain formula's norm, and, in
float32, the autograd op within 1e-4 of autograd through the plain forward.
The bf16 kernels are also swept over every head dim and G in {1, 2, 8} at
sizes that are no multiple of a tile (their lse within 1e-5 absolute: the
kernel sums the scores in another order, and at a row that sees few keys
lse = m + log l nearly cancels), and both passes are bit-identical from
call to call.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.kv_gather import ops as kv_ops
from repro_torch.kernels.kv_gather import ref as kv_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    "ref_plan": (0, 4, 8, 4, 2, 32, 12, 8, 4, [5, 9, 0, 3], [1, 1, 6, 0],
                 [1, 1, 0, 0]),
    "mha_midpage": (1, 3, 16, 4, 4, 64, 10, 16, 3, [20, 13, 0],
                    [1, 16, 0], [1, 0, 0]),
    "wide_page": (2, 2, 4, 8, 2, 32, 6, 40, 2, [70, 33], [1, 4], [1, 0]),
    # more query rows than one tile, decode tails mixed with live rows
    "many_rows": (3, 3, 40, 2, 2, 64, 20, 16, 6, [77, 0, 50], [1, 40, 17],
                  [1, 0, 0]),
    # decode-only steps (Tc = 1): every tile holds only live decode rows
    # and takes the cut page loop; MHA as qwen, and grouped heads
    "decode_only": (4, 4, 1, 4, 4, 64, 30, 16, 6, [77, 5, 40, 0],
                    [1, 1, 1, 1], [1, 1, 1, 1]),
    "decode_only_gqa": (5, 5, 1, 8, 2, 64, 40, 16, 8, [120, 15, 16, 63, 0],
                        [1, 1, 1, 1, 1], [1, 1, 1, 1, 1]),
    # head dims 32 and 128, G 8 and 2, pages of 8 and 40, Tc below 16; a
    # decode lane with n_real 0 (every row the uniform mean)
    "hd32_g8_page8": (6, 3, 12, 8, 1, 32, 30, 8, 10, [61, 5, 0],
                      [1, 12, 7], [1, 0, 0]),
    "hd128_g2_page40": (7, 3, 20, 4, 2, 128, 12, 40, 4, [150, 41, 0],
                        [1, 0, 3], [1, 1, 0]),
    "g4_page16": (8, 4, 33, 8, 2, 64, 40, 16, 8, [100, 3, 17, 0],
                  [1, 1, 33, 5], [1, 1, 0, 0]),
    # the engine's chunk length from a mid-page start, beside a long lane
    "tc256_midpage": (9, 3, 256, 4, 4, 64, 70, 16, 40, [600, 200, 0],
                      [1, 256, 0], [1, 0, 0]),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_cuda_mixed_attention_matches_plain(case, dtype):
    dev = _cuda()
    x = _mixed_inputs(*MIXED_CASES[case])
    td = DTYPES[dtype]
    q = torch.from_numpy(x["q"]).to(dev, td)
    pool = torch.from_numpy(x["pool"]).to(dev, td)
    meta = [torch.from_numpy(x[k]).to(dev)
            for k in ("bt", "starts", "n_reals", "is_dec")]
    out = pa_ops.paged_mixed_attention_pool(q, pool, *meta)
    ref = pa_ref.paged_mixed_attention_pool_ref(q, pool, *meta)
    torch.cuda.synchronize()
    tol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_append_gather_scatter_match_plain(dtype):
    dev = _cuda()
    td = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(0)
    pool = torch.randn((12, 2, 4, 16, 64), generator=g, device=dev).to(td)
    k = torch.randn((3, 4, 64), generator=g, device=dev).to(td)
    v = torch.randn((3, 4, 64), generator=g, device=dev).to(td)
    slots = torch.tensor([5, 2, 9], dtype=torch.int32, device=dev)
    offs = torch.tensor([15, 0, 7], dtype=torch.int32, device=dev)
    want = pa_ref.append_kv_ref(pool.clone(), k, v, slots, offs)
    got = pa_ops.append_kv(pool.clone(), k, v, slots, offs)
    assert torch.equal(got, want)
    ids = torch.tensor([7, 1, 11, 0], dtype=torch.int32, device=dev)
    staging = kv_ops.gather_pages(pool, ids)
    assert torch.equal(staging, kv_ref.gather_pages_ref(pool, ids))
    new = torch.randn(staging.shape, generator=g, device=dev).to(td)
    want = kv_ref.scatter_pages_ref(pool.clone(), new, ids)
    assert torch.equal(kv_ops.scatter_pages(pool.clone(), new, ids), want)


GATHER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def _gather_pool(dev, dtype, row_bytes, P, seed=7):
    td = GATHER_DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (P, row_bytes // td.itemsize)
    if td == torch.int8:
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    return torch.randn(shape, generator=g, device=dev).to(td)


def _spy_plans(monkeypatch):
    plans = []
    plan = kv_ops.gather_plan

    def spy(*args):
        plans.append(plan(*args))
        return plans[-1]
    monkeypatch.setattr(kv_ops, "gather_plan", spy)
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("n_case", ["one", "below_grid", "above_grid"])
@pytest.mark.parametrize("dtype", sorted(GATHER_DTYPES))
@pytest.mark.parametrize("row_bytes", [16, 10240, 65536, 655360])
def test_cuda_gather_bulk_copy_bit_exact(row_bytes, dtype, n_case,
                                         monkeypatch):
    """The bulk-copy gather at the port's row sizes (one 16-byte vector,
    the shift, kv and wkv pages), for one row, fewer work items than the
    grid and a multiple of the grid plus a remainder, duplicates included."""
    dev = _cuda()
    sms = kv_ops.sm_count(dev.index or 0)
    n = {"one": 1, "below_grid": 7,
         "above_grid": 3 * kv_ops.BLOCKS_PER_SM * sms + 5}[n_case]
    pool = _gather_pool(dev, dtype, row_bytes, P=48)
    rng = np.random.default_rng(row_bytes + n)
    ids = torch.from_numpy(rng.integers(0, 48, n).astype(np.int32)).to(dev)
    plans = _spy_plans(monkeypatch)
    before = build.launch_counts().get("gather_pages", 0)
    got = kv_ops.gather_pages(pool, ids)
    torch.cuda.synchronize()
    assert [p.route for p in plans] == ["bulk"]
    assert build.launch_counts()["gather_pages"] == before + 1
    assert torch.equal(got, kv_ref.gather_pages_ref(pool, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("row_bytes", [12, 10240, 65536])
def test_cuda_gather_keeps_rows_of_ids_outside_the_pool(row_bytes, dtype):
    """Duplicate ids are copied each time; an id outside [0, P) gets a zero
    row, whatever the caller's buffer held (through the wrapper's launch
    into a pre-filled buffer), on both routes."""
    dev = _cuda()
    P = 10
    pool = _gather_pool(dev, dtype, row_bytes, P)
    ids_np = np.array([3, -1, 9, 10, 3, 0, 1 << 30, 7, 3], np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    out = torch.full((len(ids_np),) + tuple(pool.shape[1:]), 7,
                     dtype=pool.dtype, device=dev)
    kv_ops._gather_into(pool, ids, out)
    torch.cuda.synchronize()
    bad = torch.from_numpy((ids_np < 0) | (ids_np >= P)).to(dev)
    assert torch.equal(out[~bad], pool[ids[~bad].long()])
    assert (out[bad] == 0).all()


OUT_OF_POOL = (-11, -2, -1, 10, 11, 1 << 30)       # P = 10: -P-1 .. 2^30


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes,route", [
    (12, "vector"), (1000, "vector"), (10240, "bulk"), (65536, "bulk")])
def test_cuda_gather_and_scatter_equal_plain_outside_the_pool(
        row_bytes, route, monkeypatch):
    """The one out-of-pool contract, kernel against plain version: gather
    gives a zero row and scatter writes nothing for every id outside
    [0, P), beside in-pool ids and duplicates, on both gather routes."""
    dev = _cuda()
    P = 10
    pool = _gather_pool(dev, "float32", row_bytes, P, seed=row_bytes)
    ids_np = np.array([4, *OUT_OF_POOL, 0, 4, 9], np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    plans = _spy_plans(monkeypatch)
    got = kv_ops.gather_pages(pool, ids)
    torch.cuda.synchronize()
    assert [p.route for p in plans] == [route]
    assert torch.equal(got, kv_ref.gather_pages_ref(pool, ids))
    assert (got[1:1 + len(OUT_OF_POOL)] == 0).all()
    g = torch.Generator(device=dev).manual_seed(1)
    new = torch.randn(got.shape, generator=g, device=dev)
    new[-2] = new[0]               # the duplicate id 4 carries one row
    want = kv_ref.scatter_pages_ref(pool.clone(), new, ids)
    out = kv_ops.scatter_pages(pool.clone(), new, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    untouched = sorted(set(range(P)) - set(ids_np.tolist()))
    assert torch.equal(out[untouched], pool[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["row_12_bytes", "row_1000_bytes",
                                  "pool_offset_4_bytes"])
def test_cuda_gather_unaligned_rows_take_the_vector_kernel(case,
                                                           monkeypatch):
    dev = _cuda()
    if case == "pool_offset_4_bytes":
        flat = _gather_pool(dev, "float32", 4 * (6 * 4096 + 1), 1)
        pool = flat[0, 1:].view(6, 4096)            # 16 KiB rows, base + 4
        assert pool.data_ptr() % 16 == 4
    else:
        row = int(case.split("_")[1])
        pool = _gather_pool(dev, "int8", row, 6)
    ids = torch.tensor([5, 0, 5, 2], dtype=torch.int32, device=dev)
    plans = _spy_plans(monkeypatch)
    got = kv_ops.gather_pages(pool, ids)
    torch.cuda.synchronize()
    assert [p.route for p in plans] == ["vector"]
    assert torch.equal(got, kv_ref.gather_pages_ref(pool, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes,plan", [
    (24, kv_ops.GatherPlan("bulk", 16, kv_ops.STAGES, 1)),     # unaligned
    (64, kv_ops.GatherPlan("bulk", 16, 1, 1)),     # a ring of one stage
    (64, kv_ops.GatherPlan("bulk", 24, kv_ops.STAGES, 1))])    # chunk % 16
def test_cuda_gather_bulk_copy_refuses_plans_it_cannot_run(row_bytes, plan,
                                                           monkeypatch):
    """A bulk plan the kernel cannot run fails the launch, and the wrapper
    raises: nothing retries on the vector kernel."""
    dev = _cuda()
    pool = _gather_pool(dev, "int8", row_bytes, 4)
    monkeypatch.setattr(kv_ops, "gather_plan", lambda *a: plan)
    with pytest.raises(RuntimeError, match="gather_pages"):
        kv_ops.gather_pages(pool, torch.tensor([1], dtype=torch.int32,
                                               device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,row_bytes", [(1200, 65536), (32, 655360),
                                         (32, 10240)])
def test_cuda_gather_bulk_copy_resources(n, row_bytes):
    """At the engine's leg shapes: no local memory, and the ring within the
    card's opt-in shared memory per block."""
    _cuda()
    plan = kv_ops.gather_plan(n, row_bytes, 16, kv_ops.sm_count(0))
    info = kv_ops.gather_kernel_info(plan)
    assert info["local_bytes"] == 0
    assert info["smem_bytes"] == plan.smem_bytes
    assert 0 < info["smem_bytes"] <= info["smem_optin_bytes"]


def _writer_case(dev, td, hd, page, seed=12, K=2, T=256):
    """Rows of the page writer: n_write 0, 1, below a page, 256 from
    mid-page, 256 running past the table's end, and an idle lane on
    scratch; every table entry its own page, so no write lands twice."""
    W = (page + page // 2 + T) // page + 2
    q_starts = [37, 13, 2 * page + 3, page + page // 2, (W - 2) * page + 1,
                0]
    n_write = [0, 1, page - 5, T, T, 1]
    R = len(q_starts)
    rng = np.random.default_rng(seed)
    P = R * W + 1
    bt = rng.permutation(np.arange(1, P))[:R * W].reshape(R, W)
    bt[-1] = 0                                      # the idle lane: scratch
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.randn((P, 2, K, page, hd), generator=g, device=dev).to(td)
    k = torch.randn((R, T, K, hd), generator=g, device=dev).to(td)
    v = torch.randn((R, T, K, hd), generator=g, device=dev).to(td)
    ints = [torch.tensor(a, dtype=torch.int32, device=dev)
            for a in (bt, q_starts, n_write)]
    return pool, k, v, *ints


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [8, 16, 40])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_cuda_write_kv_rows_matches_plain_bitwise(hd, page, dtype):
    dev = _cuda()
    pool, k, v, bt, qs, nw = _writer_case(dev, DTYPES[dtype], hd, page)
    want = pa_ref.write_kv_rows_ref(pool.clone(), k, v, bt, qs, nw)
    build.reset_launch_counts()
    got = pa_ops.write_kv_rows(pool.clone(), k, v, bt, qs, nw)
    torch.cuda.synchronize()
    assert build.launch_counts() == {"append_kv": 1}
    assert torch.equal(got, want)
    assert not torch.equal(got, pool)               # it wrote something


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_cuda_write_kv_rows_kernel_has_no_local_memory(hd):
    _cuda()
    for dtype, info in pa_ops.writer_kernel_info(hd).items():
        assert info["local_bytes"] == 0, (dtype, info)
        assert 0 < info["registers"] <= 128, (dtype, info)


@pytest.mark.cuda
def test_cuda_write_kv_rows_rejects_what_it_does_not_take():
    dev = _cuda()
    pool, k, v, bt, qs, nw = _writer_case(dev, torch.bfloat16, 64, 16)
    with pytest.raises(ValueError, match="int32"):
        pa_ops.write_kv_rows(pool, k, v, bt, qs.long(), nw)
    with pytest.raises(ValueError, match="head_dim"):
        pa_ops.write_kv_rows(pool[..., :48], k[..., :48], v[..., :48], bt,
                             qs, nw)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)
        pa_ops.write_kv_rows(pool, flat[1:].view(k.shape), v, bt, qs, nw)
    with pytest.raises(ValueError, match="do not match"):
        pa_ops.write_kv_rows(pool, k[:, :, :1], v[:, :, :1], bt, qs, nw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rows_independent_of_packing_and_sweep_length(dtype):
    """A row's result is bit-identical whatever else rides the launch, and
    sweeping extra (fully masked) pages leaves live rows bit-identical."""
    dev = _cuda()
    x = _mixed_inputs(*MIXED_CASES["many_rows"])
    td = DTYPES[dtype]
    q = torch.from_numpy(x["q"]).to(dev, td)
    pool = torch.from_numpy(x["pool"]).to(dev, td)
    meta = [torch.from_numpy(x[k]).to(dev)
            for k in ("bt", "starts", "n_reals", "is_dec")]
    full = pa_ops.paged_mixed_attention_pool(q, pool, *meta)
    alone = pa_ops.paged_mixed_attention_pool(
        q[1:2].contiguous(), pool, meta[0][1:2], *[m[1:2] for m in meta[1:]])
    assert torch.equal(alone[0], full[1])
    # row 1 is a chunk of 40 from position 0: it needs 3 pages of 16; a
    # table twice as long (extra pages masked) must not change it
    bt2 = torch.cat([meta[0], meta[0]], dim=1)
    longer = pa_ops.paged_mixed_attention_pool(q, pool, bt2, *meta[1:])
    assert torch.equal(longer[1], full[1])
    assert torch.equal(longer[2], full[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_only_cut_matches_full_sweep(dtype):
    """A decode-only launch (Tc = 1) stops each lane's page loop at its last
    needed page; the same lanes packed with Tc = 8, whose fully masked tail
    rows sweep all pages (float32: in the same tiles; bf16: in one pass of
    their own), give bit-identical real tokens."""
    dev = _cuda()
    x = _mixed_inputs(*MIXED_CASES["decode_only_gqa"])
    td = DTYPES[dtype]
    q1 = torch.from_numpy(x["q"]).to(dev, td)
    pool = torch.from_numpy(x["pool"]).to(dev, td)
    meta = [torch.from_numpy(x[k]).to(dev)
            for k in ("bt", "starts", "n_reals", "is_dec")]
    q8 = torch.zeros((q1.shape[0], 8) + tuple(q1.shape[2:]), device=dev,
                     dtype=td)
    q8[:, :1] = q1
    cut = pa_ops.paged_mixed_attention_pool(q1, pool, *meta)
    swept = pa_ops.paged_mixed_attention_pool(q8, pool, *meta)
    assert torch.equal(cut[:, 0], swept[:, 0])


# (B, H, K, hd, P, page, pps) and lengths: a row at 1, a row at 0 (the
# uniform mean over every page), full and mid-page lengths
DECODE_CASES = {
    "gqa": ((2, 4, 2, 64, 16, 8, 4), [1, 0]),
    "mha_qwen": ((4, 16, 16, 64, 40, 16, 8), [128, 77, 1, 0]),
    "mqa_wide_page": ((3, 8, 1, 64, 20, 40, 3), [100, 41, 0]),
    "hd128": ((2, 8, 8, 128, 8, 8, 8), [64, 13]),
    # every warp gets pages (500 tokens: 63 pages of 8) beside a lane whose
    # pages all land on warp 0; G 8 takes two passes of 4 heads
    "hd32_g8_page8": ((3, 8, 1, 32, 80, 8, 64), [500, 3, 0]),
    "hd128_g2_page40": ((3, 8, 4, 128, 30, 40, 12), [470, 7, 0]),
    "g4_long_short": ((2, 16, 4, 64, 100, 16, 64), [1000, 5]),
    "g1_page16_long": ((2, 4, 4, 64, 80, 16, 64), [700, 40]),
}
# (B, Tc, H, K, hd, P, page, pps, starts): mid-page chunk starts
PREFILL_CASES = {
    "ref_plan": (2, 6, 4, 2, 32, 16, 8, 4, [3, 10]),
    "mha_midpage": (2, 40, 16, 16, 64, 30, 16, 8, [0, 53]),
    "gqa_many_rows": (1, 24, 8, 2, 64, 12, 16, 4, [9]),
    "hd32_g8_page8_short": (2, 9, 8, 1, 32, 40, 8, 12, [5, 60]),
    "hd128_g2_page40": (1, 70, 8, 4, 128, 10, 40, 4, [33]),
    "g4_page16": (2, 20, 16, 4, 64, 40, 16, 8, [0, 77]),
    "tc256_midpage": (1, 256, 16, 16, 64, 80, 16, 64, [200]),
}


def _decode_case(case, dev, td, seed=6):
    (B, H, K, hd, P, page, pps), lengths = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, hd))).to(dev, td)
    pool = torch.from_numpy(rng.standard_normal((P, 2, K, page, hd))).to(
        dev, td)
    bt = torch.from_numpy(rng.integers(0, P, (B, pps)).astype(np.int32))
    return q, pool, bt.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                             device=dev)


def _split(pool):
    return pool[:, 0].movedim(1, 0), pool[:, 1].movedim(1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_cuda_decode_attention_matches_plain(case, dtype):
    dev = _cuda()
    q, pool, bt, ln = _decode_case(case, dev, DTYPES[dtype])
    tol = 3e-5 if dtype == "float32" else 3e-2
    want = pa_ref.paged_attention_pool_ref(q, pool, bt, ln)
    for got in (pa_ops.paged_attention_pool(q, pool, bt, ln),
                pa_ops.paged_attention(q, *_split(pool), bt, ln)):
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_cuda_prefill_attention_matches_plain(case, dtype):
    dev = _cuda()
    B, Tc, H, K, hd, P, page, pps, starts = PREFILL_CASES[case]
    rng = np.random.default_rng(7)
    td = DTYPES[dtype]
    q = torch.from_numpy(rng.standard_normal((B, Tc, H, hd))).to(dev, td)
    pool = torch.from_numpy(rng.standard_normal((P, 2, K, page, hd))).to(
        dev, td)
    bt = torch.from_numpy(rng.integers(0, P, (B, pps)).astype(np.int32)).to(
        dev)
    qs = torch.tensor(starts, dtype=torch.int32, device=dev)
    got = pa_ops.paged_prefill_attention_pool(q, pool, bt, qs)
    want = pa_ref.paged_prefill_attention_pool_ref(q, pool, bt, qs)
    torch.cuda.synchronize()
    tol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_pools_equal_fused_pool_bitwise(dtype):
    """Decode over the split halves, read in place as strided views or
    copied out contiguous, equals decode over the fused pool."""
    dev = _cuda()
    q, pool, bt, ln = _decode_case("mha_qwen", dev, DTYPES[dtype])
    fused = pa_ops.paged_attention_pool(q, pool, bt, ln)
    k, v = _split(pool)
    assert not k.is_contiguous()
    assert torch.equal(pa_ops.paged_attention(q, k, v, bt, ln), fused)
    assert torch.equal(pa_ops.paged_attention(q, k.contiguous(),
                                              v.contiguous(), bt, ln), fused)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_cuda_per_request_kernels_equal_mixed_rows_bitwise(G, dtype):
    """One mixed launch of 3 decode lanes and 2 chunk rows (one from a
    mid-page start): each decode lane equals the decode kernel's row and
    each chunk row the prefill kernel's, on the same q and pool."""
    dev = _cuda()
    td = DTYPES[dtype]
    rng = np.random.default_rng(8)
    K, hd, P, page, pps, Tc = 4, 64, 40, 16, 6, 24
    H = K * G
    q = torch.from_numpy(rng.standard_normal((5, Tc, H, hd))).to(dev, td)
    pool = torch.from_numpy(rng.standard_normal((P, 2, K, page, hd))).to(
        dev, td)
    bt = torch.from_numpy(rng.integers(0, P, (5, pps)).astype(np.int32)).to(
        dev)
    starts = torch.tensor([90, 0, 47, 37, 0], dtype=torch.int32, device=dev)
    n_reals = torch.tensor([1, 1, 1, 24, 11], dtype=torch.int32, device=dev)
    is_dec = torch.tensor([1, 1, 1, 0, 0], dtype=torch.int32, device=dev)
    mixed = pa_ops.paged_mixed_attention_pool(q, pool, bt, starts, n_reals,
                                              is_dec)
    dec = pa_ops.paged_attention_pool(q[:3, 0].contiguous(), pool, bt[:3],
                                      starts[:3] + 1)
    assert torch.equal(mixed[:3, 0], dec)
    split = pa_ops.paged_attention(q[:3, 0].contiguous(), *_split(pool),
                                   bt[:3], starts[:3] + 1)
    assert torch.equal(split, dec)
    chunk = pa_ops.paged_prefill_attention_pool(q[3:].contiguous(), pool,
                                                bt[3:].contiguous(),
                                                starts[3:].contiguous())
    assert torch.equal(mixed[3:], chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,page,G,Tc", [(32, 8, 8, 12), (128, 40, 2, 70),
                                          (64, 16, 1, 256)])
def test_cuda_mixed_rows_equal_per_request_rows_across_shapes(hd, page, G,
                                                              Tc, dtype):
    """The same bit-identities at other head dims, page sizes, groups and
    chunk lengths: a long decode lane (every warp gets pages), a short one,
    a chunk row from a mid-page start and a pad-only chunk row."""
    dev = _cuda()
    td = DTYPES[dtype]
    rng = np.random.default_rng(hd + page + G)
    K, pps = 2, 900 // page + 1
    H, P = K * G, pps + 9
    q = torch.from_numpy(rng.standard_normal((4, Tc, H, hd))).to(dev, td)
    pool = torch.from_numpy(rng.standard_normal((P, 2, K, page, hd))).to(
        dev, td)
    bt = torch.from_numpy(rng.integers(0, P, (4, pps)).astype(np.int32)).to(
        dev)
    starts = torch.tensor([880, 2, page + 3, 0], dtype=torch.int32,
                          device=dev)
    n_reals = torch.tensor([1, 1, Tc, 0], dtype=torch.int32, device=dev)
    is_dec = torch.tensor([1, 1, 0, 0], dtype=torch.int32, device=dev)
    mixed = pa_ops.paged_mixed_attention_pool(q, pool, bt, starts, n_reals,
                                              is_dec)
    dec = pa_ops.paged_attention_pool(q[:2, 0].contiguous(), pool, bt[:2],
                                      starts[:2] + 1)
    assert torch.equal(mixed[:2, 0], dec)
    assert torch.equal(pa_ops.paged_attention(
        q[:2, 0].contiguous(), *_split(pool), bt[:2], starts[:2] + 1), dec)
    chunk = pa_ops.paged_prefill_attention_pool(q[2:].contiguous(), pool,
                                                bt[2:].contiguous(),
                                                starts[2:].contiguous())
    assert torch.equal(mixed[2:], chunk)
    want = pa_ref.paged_mixed_attention_pool_ref(q, pool, bt, starts,
                                                 n_reals, is_dec)
    torch.cuda.synchronize()
    tol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(mixed.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["hd32_g8_page8", "hd128_g2_page40",
                                  "g4_long_short", "g1_page16_long"])
def test_cuda_decode_cut_equals_sweep_bitwise(case, dtype):
    """A lane long enough that every warp gets pages and one so short that
    most warps see no live key: the row stops at its last page, and pages
    past it (a table four times as long, pointing anywhere in the pool)
    change no bit; the same lanes as decode rows of a mixed launch whose
    fully masked tail rows sweep every page (Tc 8) give the same bits."""
    dev = _cuda()
    td = DTYPES[dtype]
    q, pool, bt, ln = _decode_case(case, dev, td)
    P, pps = pool.shape[0], bt.shape[1]
    rng = np.random.default_rng(9)
    extra = torch.from_numpy(rng.integers(0, P, (bt.shape[0], 3 * pps))
                             .astype(np.int32)).to(dev)
    bt4 = torch.cat([bt, extra], dim=1)
    live = ln > 0
    cut = pa_ops.paged_attention_pool(q, pool, bt, ln)
    longer = pa_ops.paged_attention_pool(q, pool, bt4, ln)
    assert torch.equal(cut[live], longer[live])
    B, H, hd = q.shape
    q8 = torch.zeros((B, 8, H, hd), device=dev, dtype=td)
    q8[:, 0] = q
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    mixed = pa_ops.paged_mixed_attention_pool(q8, pool, bt, ln - 1, ones,
                                              ones)
    assert torch.equal(mixed[live, 0], cut[live])
    tol = 3e-5 if dtype == "float32" else 3e-2
    want = pa_ref.paged_attention_pool_ref(q, pool, bt4, ln)
    torch.cuda.synchronize()
    np.testing.assert_allclose(longer.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_cuda_paged_bf16_kernels_do_not_spill(hd):
    """No local memory (spills or stack) in the bf16 paged-attention
    kernels, and their shared memory within the 227 KB a block may use."""
    _cuda()
    for name, info in pa_ops.tc_kernel_info(hd).items():
        assert info["local_bytes"] == 0, (name, info)
        assert 0 < info["smem_bytes"] <= 232448, (name, info)


@pytest.mark.cuda
def test_cuda_per_request_kernels_reject_mixed_devices_and_index_types():
    dev = _cuda()
    q, pool, bt, ln = _decode_case("gqa", dev, torch.float32)
    calls = {
        "paged_attention_pool": lambda q_, p_, b_, l_: (
            pa_ops.paged_attention_pool(q_, p_, b_, l_)),
        "paged_attention": lambda q_, p_, b_, l_: (
            pa_ops.paged_attention(q_, *_split(p_), b_, l_)),
        "paged_prefill_attention_pool": lambda q_, p_, b_, l_: (
            pa_ops.paged_prefill_attention_pool(
                q_[:, None].contiguous(), p_, b_, l_)),
    }
    for call in calls.values():
        for args in ((q, pool.cpu(), bt, ln), (q, pool, bt.cpu(), ln),
                     (q, pool, bt, ln.cpu())):
            with pytest.raises(ValueError, match="device|tensors on"):
                call(*args)
        for args in ((q, pool, bt.long(), ln), (q, pool, bt, ln.long())):
            with pytest.raises(ValueError, match="int32"):
                call(*args)


# ---------------------------------------------------------------------------
# RWKV-6 WKV recurrence (csrc/wkv6.cu)
# ---------------------------------------------------------------------------
# (B, T, H, hd, wmax): the reference's test_wkv6_sweep, then the engine's
# launch lengths (a decode lane, a short bucket, a length no chunk divides,
# a full chunk bucket) at the model's head_dim 64, the chunk's edges (one
# token short of a chunk, one chunk, one token into the next, one short of
# two) and the engine's whole chunk region at full width, strong decay
WKV_CASES = {
    "sweep_weak": (2, 64, 3, 32, 0.1),
    "sweep_mid": (1, 128, 2, 64, 1.0),
    "sweep_strong": (2, 96, 4, 32, 5.0),
    "decode": (4, 1, 5, 64, 1.0),
    "short_bucket": (2, 24, 3, 64, 5.0),
    "ragged": (1, 70, 2, 64, 0.5),
    "bucket_256": (2, 256, 2, 64, 0.05),
    "edge_31": (2, 31, 3, 64, 5.0),
    "edge_32": (2, 32, 3, 64, 5.0),
    "edge_33": (2, 33, 3, 64, 5.0),
    "edge_63": (2, 63, 3, 64, 5.0),
    "engine_chunk": (8, 256, 40, 64, 5.0),
}
WKV_TOL = {"float32": dict(rtol=1e-3, atol=5e-4),
           "bfloat16": dict(rtol=2e-2, atol=5e-2)}


def _wkv_case(case, dev, td, seed=4):
    B, T, H, hd, wmax = WKV_CASES[case]
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, hd))).to(
        dev, td) for _ in range(3))
    w = -torch.from_numpy(rng.uniform(1e-3, wmax, (B, T, H, hd))).to(
        dev, torch.float32)
    u = torch.from_numpy(rng.standard_normal((H, hd))).to(dev, torch.float32)
    s0 = torch.from_numpy(rng.standard_normal((B, H, hd, hd)) * 0.1).to(
        dev, torch.float32)
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_cuda_wkv6_matches_plain(case, dtype):
    """The kernel against the float32 scan, and against the chunked form
    where the reference's dispatch takes it; a launch is counted."""
    dev = _cuda()
    args = _wkv_case(case, dev, DTYPES[dtype])
    before = build.launch_counts().get("wkv6", 0)
    y, s = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert build.launch_counts()["wkv6"] == before + 1
    assert y.dtype == args[0].dtype and s.dtype == torch.float32
    refs = [wkv_ref.wkv6_ref(*args), wkv_ref.wkv6_plain(*args)]
    for yr, sr in refs:
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   yr.float().cpu().numpy(), **WKV_TOL[dtype])
        np.testing.assert_allclose(s.cpu().numpy(), sr.cpu().numpy(),
                                   **WKV_TOL[dtype])


@pytest.mark.cuda
def test_cuda_wkv6_state_handoff_across_calls():
    """70 tokens in one launch equal 40 then 30 with the state carried
    (the chunked prefill's handoff), and a padded tail with k = 0, w = 0
    leaves the state of the last real token."""
    dev = _cuda()
    r, k, v, w, u, s0 = _wkv_case("ragged", dev, torch.float32, seed=9)
    y, s = wkv_ops.wkv6(r, k, v, w, u, s0)
    part = [a[:, :40].contiguous() for a in (r, k, v, w)]
    y1, s1 = wkv_ops.wkv6(*part, u, s0)
    rest = [a[:, 40:].contiguous() for a in (r, k, v, w)]
    y2, s2 = wkv_ops.wkv6(*rest, u, s1)
    torch.cuda.synchronize()
    np.testing.assert_allclose(torch.cat([y1, y2], 1).cpu().numpy(),
                               y.cpu().numpy(), **WKV_TOL["float32"])
    np.testing.assert_allclose(s2.cpu().numpy(), s.cpu().numpy(),
                               **WKV_TOL["float32"])
    kp, wp = k.clone(), w.clone()
    kp[:, 40:], wp[:, 40:] = 0, 0
    _, sp = wkv_ops.wkv6(r, kp, v, wp, u, s0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(sp.cpu().numpy(), s1.cpu().numpy(),
                               **WKV_TOL["float32"])


@pytest.mark.cuda
def test_cuda_wkv6_rejects_what_it_does_not_take():
    dev = _cuda()
    r, k, v, w, u, s0 = _wkv_case("decode", dev, torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        wkv_ops.wkv6(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="share"):
        wkv_ops.wkv6(r, k.float(), v, w, u, s0)
    with pytest.raises(ValueError, match="head_dim"):
        wkv_ops.wkv6(*(a[..., :48].contiguous() for a in (r, k, v, w)),
                     u[:, :48].contiguous(), s0[..., :48, :48].contiguous())
    strided = torch.cat([r, r], dim=-1)[..., :r.shape[-1]]  # same shape
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops.wkv6(strided, k, v, w, u, s0)
    with pytest.raises(ValueError, match="device|tensors on"):
        wkv_ops.wkv6(r, k, v, w, u, s0.cpu())
    shifted = torch.empty(r.numel() + 8, dtype=r.dtype, device=dev)[1:]
    shifted = shifted[:r.numel()].view(r.shape)         # 2 bytes off
    shifted.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        wkv_ops.wkv6(shifted, k, v, w, u, s0)
    long_seq = torch.empty((1, 2 ** 25, 1, 64), dtype=r.dtype, device=dev)
    with pytest.raises(ValueError, match="32-bit"):
        wkv_ops.wkv6(long_seq, k, v, w, u, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
def test_cuda_wkv6_resources(hd):
    """No local memory (spills or stack), dynamic shared memory within a
    third of the SM's (76,800 bytes) and three resident blocks per SM, so
    the engine's 320 (b, h) blocks run in one wave on 132 SMs."""
    _cuda()
    for name, info in wkv_ops.wkv6_kernel_info(hd).items():
        assert info["local_bytes"] == 0, (name, info)
        assert 0 < info["smem_bytes"] <= 76800, (name, info)
        assert info["blocks_per_sm"] >= 3, (name, info)


@pytest.mark.cuda
@pytest.mark.parametrize("n_real", [None, [24, 5, 1, 0]])
def test_cuda_rwkv_time_mix_kernel_matches_plain(n_real):
    """One rwkv6-3b-width time-mix (d 2560, 40 heads of 64, bf16) on a
    24-token bucket, through the kernel and the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.layers import rwkv6 as trwkv
    dev = _cuda()
    cfg = get_config("rwkv6-3b").replace(n_layers=1)
    g = torch.Generator(device=dev).manual_seed(0)
    tm = trwkv.TimeMix(cfg, dev, g)
    x = torch.randn((4, 24, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    shift = torch.randn((4, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    st = torch.randn((4, 40, 64, 64), generator=g, device=dev) * 0.1
    out_k, sh_k, s_k = trwkv.rwkv_time_mix(tm, cfg, x, shift, st,
                                           impl="kernel", n_real=n_real)
    out_r, sh_r, s_r = trwkv.rwkv_time_mix(tm, cfg, x, shift, st,
                                           impl="ref", n_real=n_real)
    torch.cuda.synchronize()
    assert torch.equal(sh_k, sh_r)
    np.testing.assert_allclose(s_k.cpu().numpy(), s_r.cpu().numpy(),
                               **WKV_TOL["float32"])
    scale = out_r.float().abs().amax(-1).clamp_min(1e-6)
    rel = ((out_k.float() - out_r.float()).abs().amax(-1) / scale).max()
    assert rel.item() <= 2e-2


# (B, Sq, Sk, H, K, hd, causal, window): the reference's sweep, rows that
# see no key (Sq > Sk), and ragged tiles with G > 1 under a window
FLASH_CASES = {
    "gqa": (2, 128, 128, 4, 2, 64, True, 0),
    "window": (1, 256, 256, 4, 4, 32, True, 64),
    "sq_lt_sk": (2, 64, 192, 6, 2, 64, True, 0),
    "bidir": (1, 128, 128, 2, 2, 128, False, 0),
    "mqa_hd256": (1, 64, 64, 8, 1, 256, True, 0),
    "sq_gt_sk": (1, 96, 64, 4, 2, 32, True, 0),
    "ragged_gqa_window": (2, 100, 150, 6, 3, 64, True, 40),
    "bidir_window_sq_gt_sk": (1, 80, 50, 4, 4, 128, False, 16),
}
FLASH_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
FLASH_BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}


def _flash_case(case, dev, td, seed=7):
    B, Sq, Sk, H, K, hd, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    t = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev, td) for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                           (B, Sq, H, hd))]
    return t, dict(causal=causal, window=window)


def _rel_norm(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_forward_matches_plain(case, dtype):
    dev = _cuda()
    (q, k, v, _), kw = _flash_case(case, dev, DTYPES[dtype])
    o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert (o.float() - ro.float()).abs().max().item() <= FLASH_TOL[dtype]
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_backward_matches_plain(case, dtype):
    """The backward kernels on the plain forward's o and lse, against the
    plain formula; twice, bit-identical (no atomics)."""
    dev = _cuda()
    (q, k, v, do), kw = _flash_case(case, dev, DTYPES[dtype])
    o, lse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse.float(), do, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, o, lse.float(), do, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, g, g2, w in zip("qkv", got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, g2), name
        assert _rel_norm(g, w) <= FLASH_BWD_REL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gqa", "sq_gt_sk", "ragged_gqa_window"])
def test_cuda_flash_op_grads_match_autograd_of_plain(case):
    dev = _cuda()
    (q, k, v, do), kw = _flash_case(case, dev, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = build.launch_counts()
    out = fa_ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    after = build.launch_counts()
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = fa_ref.flash_attention_ref(*ref_leaves, **kw)
    want = torch.autograd.grad(ref_out, ref_leaves, do)
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert after.get(name, 0) - before.get(name, 0) == 1, name
    assert (out - ref_out).abs().max().item() <= FLASH_TOL["float32"]
    for g, w in zip(got, want):
        assert _rel_norm(g, w) <= FLASH_BWD_REL["float32"]


@pytest.mark.cuda
def test_cuda_flash_rejects_what_it_does_not_take():
    dev = _cuda()
    (q, k, v, do), kw = _flash_case("gqa", dev, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention_fwd(*(a[..., :48].contiguous()
                                     for a in (q, k, v)))
    with pytest.raises(ValueError, match="share"):
        fa_ops.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention_fwd(q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="device|tensors on"):
        fa_ops.flash_attention_fwd(q, k, v.cpu())


# (B, Sq, Sk, causal, window) for the bf16 tensor-core sweep, with K = 2 KV
# heads and H = 2 G: ragged tiles on both sides, right-aligned queries, rows
# that see no key, a window edge inside a tile
TC_CASES = {
    "causal_200": (1, 200, 200, True, 0),
    "right_aligned_100_300": (1, 100, 300, True, 0),
    "empty_rows_96_64": (1, 96, 64, True, 0),
    "window_48": (1, 200, 200, True, 48),
}


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_cuda_flash_bf16_tensor_cores_match_plain(case, hd, G):
    """The bf16 forward and backward against the plain versions, each
    bit-identical across two calls."""
    dev = _cuda()
    B, Sq, Sk, causal, window = TC_CASES[case]
    K = 2
    rng = np.random.default_rng(hd + G)
    q, k, v, do = [torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev, torch.bfloat16)
        for s in ((B, Sq, K * G, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                  (B, Sq, K * G, hd))]
    kw = dict(causal=causal, window=window)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = fa_ops.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    got = fa_ops.flash_attention_bwd(q, k, v, ro, rlse.float(), do, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, ro, rlse.float(), do, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, ro, rlse, do, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - ro.float()).abs().max().item() <= FLASH_TOL["bfloat16"]
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    for name, g, g2, w in zip("qkv", got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all()), name
        assert torch.equal(g, g2), name
        assert _rel_norm(g, w) <= FLASH_BWD_REL["bfloat16"], name


@pytest.mark.cuda
def test_cuda_flash_bf16_rejects_unaligned_operands():
    dev = _cuda()
    (q, k, v, _), kw = _flash_case("gqa", dev, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention_fwd(shifted, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_cuda_flash_bf16_kernels_do_not_spill(hd):
    """No local memory (spills or stack) in the tensor-core kernels, and
    their shared memory within the 227 KB a block may use."""
    _cuda()
    for name, info in fa_ops.tc_kernel_info(hd).items():
        assert info["local_bytes"] == 0, (name, info)
        assert 0 < info["smem_bytes"] <= 232448, (name, info)
