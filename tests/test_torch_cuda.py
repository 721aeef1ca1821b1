"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU (``cuda`` marker; every test skips where
``torch.cuda.is_available()`` is false). Imports neither JAX nor ``repro``,
so it runs on a card's machine as it is:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q -m cuda

Deepseek-v2-lite-16b's ``mla`` pages (16, 576) bf16 = 18,432 B through
the gather and scatter (a 16 KiB chunk and a 2 KiB tail a row on the bulk
route), bit-exact; and a bf16 smoke deepseek engine held against float32:
every MLA and MoE call of its run against a float32 copy of the layer on
the same input, within 2% per token, and its greedy tokens against the
same weights served in float32 wherever the float32 top-2 margin decides.

Also the request lifecycle on the card, on a bf16 smoke qwen engine: a
snapshot holds its payload on the host as raw 16-bit words, and restore ->
snapshot gives the same words; ``drain`` parks through the gather kernel
and leaves no pin and only scratch LOCAL; a restored engine finishes with
the uninterrupted engine's tokens.

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
call to call. The WKV backward kernel (``csrc/wkv6_bwd.cu``) against
``wkv6_backward_plain`` at the training shape (float32 at the forward's
state limits, bf16 within 2e-2 of the plain norm) and a float32 sweep,
bit-identical from call to call, its autograd op against autograd of the
scan, its refusals and its resources; and each of its three passes alone
against its plain twin (the state passes at the float32 limits in both
dtypes, their arithmetic being float32).
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
    # dbrx-132b's G 6 at hd 128: 40 tokens x 6 heads, a 64-row tile ends
    # inside a token's group
    "g6_hd128": (10, 3, 40, 12, 2, 128, 40, 16, 8, [120, 37, 0],
                 [1, 40, 11], [1, 0, 0]),
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
@pytest.mark.parametrize("row_bytes", [16, 10240, 18432, 65536, 655360])
def test_cuda_gather_bulk_copy_bit_exact(row_bytes, dtype, n_case,
                                         monkeypatch):
    """The bulk-copy gather at the port's row sizes (one 16-byte vector,
    the shift, mla, kv and wkv pages), for one row, fewer work items than
    the grid and a multiple of the grid plus a remainder, duplicates
    included."""
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


MLA_PAGE = (16, 576)                    # deepseek's mla page: 18,432 B bf16


@pytest.mark.cuda
@pytest.mark.parametrize("n_case", ["one", "below_grid", "above_grid",
                                    "engine_leg"])
def test_cuda_gather_and_scatter_mla_rows_bit_exact(n_case, monkeypatch):
    """Rows 6-7 at deepseek's mla pages, (16, 576) bf16 = 18,432 B: a 16
    KiB chunk and a 2,048 B tail a row on the bulk route once the rows fill
    the grid (one row and 7 rows are cut into 2 KiB chunks, no tail), ids
    outside the pool included; gather and scatter bit-exact against their
    plain versions."""
    dev = _cuda()
    sms = kv_ops.sm_count(dev.index or 0)
    n = {"one": 1, "below_grid": 7,
         "above_grid": 3 * kv_ops.BLOCKS_PER_SM * sms + 5,
         "engine_leg": 1350}[n_case]
    P = 2 * n + 3
    g = torch.Generator(device=dev).manual_seed(n)
    pool = torch.randn((P,) + MLA_PAGE, generator=g, device=dev).to(
        torch.bfloat16)
    rng = np.random.default_rng(n)
    ids_np = rng.choice(P, n, replace=False).astype(np.int32)
    if n > 2:
        ids_np[0], ids_np[n // 2] = -1, P
    ids = torch.from_numpy(ids_np).to(dev)
    plans = _spy_plans(monkeypatch)
    got = kv_ops.gather_pages(pool, ids)
    torch.cuda.synchronize()
    (plan,) = plans
    assert plan.route == "bulk"
    assert (18432 % plan.chunk_bytes == 2048) == (n >= 132)
    assert torch.equal(got, kv_ref.gather_pages_ref(pool, ids))
    new = torch.randn(got.shape, generator=g, device=dev).to(torch.bfloat16)
    out = kv_ops.scatter_pages(pool.clone(), new, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, kv_ref.scatter_pages_ref(pool.clone(), new, ids))


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
                                         (32, 10240), (1350, 18432)])
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
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [8, 40, 56])
def test_cuda_write_kv_rows_matches_plain_bitwise_at_model_heads(K, dtype):
    """The writer at hd 128 and 16-token pages with the KV heads of dbrx
    and codellama-34b (8), llama2-13b (40) and opt-30b (56)."""
    dev = _cuda()
    pool, k, v, bt, qs, nw = _writer_case(dev, DTYPES[dtype], 128, 16, K=K)
    want = pa_ref.write_kv_rows_ref(pool.clone(), k, v, bt, qs, nw)
    got = pa_ops.write_kv_rows(pool.clone(), k, v, bt, qs, nw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not torch.equal(got, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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
    # gemma-7b's head dim (MHA of 256) and internvl2-1b's odd group (G 7:
    # a pass of 4 heads, then one of 3)
    "hd256_mha": ((3, 4, 4, 256, 40, 16, 24), [330, 9, 0]),
    "g7_hd64": ((3, 14, 2, 64, 60, 16, 40), [600, 5, 0]),
    # the paper's models and dbrx at hd 128: dbrx's 48 heads on 8 (G 6),
    # codellama-34b's 64 on 8 (G 8), llama2-13b's 40 on 40 (G 1)
    "g6_hd128": ((3, 48, 8, 128, 60, 16, 40), [600, 5, 0]),
    "g8_hd128_h64": ((2, 64, 8, 128, 60, 16, 40), [600, 7]),
    "g1_hd128_h40": ((2, 40, 40, 128, 30, 16, 24), [350, 3]),
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
    # hd 256 (32-key tiles, 128 accumulators a thread) and G 7 (a 64-row
    # tile ends inside a token's group of 7 heads)
    "hd256_midpage": (2, 70, 4, 4, 256, 30, 16, 8, [37, 0]),
    "g7_hd64_midpage": (2, 40, 14, 2, 64, 30, 16, 8, [0, 45]),
    # G 6 (a 64-row tile ends inside a token's group of 6 heads), G 8 and
    # G 1 at 40 heads, all at hd 128
    "g6_hd128_midpage": (2, 40, 12, 2, 128, 30, 16, 8, [0, 45]),
    "g8_hd128_midpage": (1, 30, 16, 2, 128, 20, 16, 6, [37]),
    "g1_hd128_h40_midpage": (1, 33, 40, 40, 128, 20, 16, 6, [21]),
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
@pytest.mark.parametrize("G", [1, 2, 4, 6, 7, 8])
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
                                          (64, 16, 1, 256), (256, 16, 1, 70),
                                          (64, 16, 7, 40), (128, 16, 6, 70),
                                          (128, 16, 8, 40)])
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
                                  "g4_long_short", "g1_page16_long",
                                  "hd256_mha", "g7_hd64", "g6_hd128",
                                  "g8_hd128_h64", "g1_hd128_h40"])
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
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
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


# (B, T, H, hd, wmax) of the WKV backward: the training shape of rwkv6-3b
# (batch 4 x 2048, 40 heads of 64) at weak and strong decay, a short last
# chunk (T 2047), and a float32 sweep of B, T, H and decays over the
# chunk's edges and head dim 32
WKV_BWD_CASES = {
    "train_weak": (4, 2048, 40, 64, 0.1),
    "train_strong": (4, 2048, 40, 64, 5.0),
    "train_short_tail": (4, 2047, 40, 64, 5.0),
    "one_token": (3, 1, 2, 32, 1.0),
    "edge_31": (2, 31, 3, 64, 5.0),
    "edge_33": (1, 33, 5, 32, 0.5),
    "ragged": (2, 70, 3, 64, 1.0),
    "two_chunks": (5, 64, 4, 32, 8.0),
}


def _wkv_bwd_case(case, dev, td, seed=11):
    B, T, H, hd, wmax = WKV_BWD_CASES[case]
    rng = np.random.default_rng(seed)
    args = list(_wkv_case_of(B, T, H, hd, wmax, rng, dev, td))
    dy = torch.from_numpy(rng.standard_normal((B, T, H, hd))).to(dev, td)
    ds = torch.from_numpy(rng.standard_normal((B, H, hd, hd))).to(
        dev, torch.float32)
    return args + [dy, ds]


def _wkv_case_of(B, T, H, hd, wmax, rng, dev, td):
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, hd))).to(
        dev, td) for _ in range(3))
    w = -torch.from_numpy(rng.uniform(1e-3, wmax, (B, T, H, hd))).to(
        dev, torch.float32)
    u = torch.from_numpy(rng.standard_normal((H, hd))).to(dev, torch.float32)
    s0 = torch.from_numpy(rng.standard_normal((B, H, hd, hd)) * 0.1).to(
        dev, torch.float32)
    return r, k, v, w, u, s0


def _rel_norm(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in sorted(WKV_BWD_CASES)] + [
    (c, "bfloat16") for c in sorted(WKV_BWD_CASES) if c.startswith("train")])
def test_cuda_wkv6_bwd_matches_plain(case, dtype):
    """The backward kernel against ``wkv6_backward_plain`` on the same
    inputs: float32 at the forward's state limits (rtol 1e-3, atol 5e-4),
    bf16 (at the training shapes) within 2e-2 of the plain norm (the flash
    backward's limit); two launches counted and bit-identical."""
    dev = _cuda()
    args = _wkv_bwd_case(case, dev, DTYPES[dtype])
    before = build.launch_counts().get("wkv6_bwd", 0)
    got = wkv_ops.wkv6_bwd(*args)
    again = wkv_ops.wkv6_bwd(*args)
    want = wkv_ref.wkv6_backward_plain(*args)
    torch.cuda.synchronize()
    assert build.launch_counts()["wkv6_bwd"] == before + 2
    for name, g, a, w in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                             again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        assert torch.isfinite(g).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=1e-3, atol=5e-4, err_msg=name)
        else:
            assert _rel_norm(g, w) <= 2e-2, (name, _rel_norm(g, w))


@pytest.mark.cuda
def test_cuda_wkv6_autograd_op_matches_plain_autograd():
    """``wkv6`` under autograd on CUDA tensors (the forward kernel, then
    the backward kernel) against autograd through the plain chunked form,
    float32, at the forward's limits."""
    dev = _cuda()
    args = _wkv_bwd_case("ragged", dev, torch.float32)
    grads = []
    for fwd in (wkv_ops.wkv6, wkv_ref.wkv6_ref):
        leaves = [a.clone().requires_grad_() for a in args[:6]]
        y, s = fwd(*leaves)
        grads.append(torch.autograd.grad(
            (y * args[6]).sum() + (s * args[7]).sum(), leaves))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-3, atol=5e-4)


@pytest.mark.cuda
def test_cuda_wkv6_bwd_rejects_what_it_does_not_take():
    dev = _cuda()
    r, k, v, w, u, s0, dy, ds = _wkv_bwd_case("edge_31", dev,
                                              torch.bfloat16)
    with pytest.raises(ValueError, match="dy"):
        wkv_ops.wkv6_bwd(r, k, v, w, u, s0, dy.float(), ds)
    with pytest.raises(ValueError, match="dstate_out"):
        wkv_ops.wkv6_bwd(r, k, v, w, u, s0, dy, ds.bfloat16())
    with pytest.raises(ValueError, match="float32"):
        wkv_ops.wkv6_bwd(r, k, v, w.bfloat16(), u, s0, dy, ds)
    with pytest.raises(ValueError, match="head_dim"):
        wkv_ops.wkv6_bwd(*(a[..., :48].contiguous() for a in (r, k, v, w)),
                         u[:, :48].contiguous(),
                         s0[..., :48, :48].contiguous(),
                         dy[..., :48].contiguous(),
                         ds[..., :48, :48].contiguous())
    strided = torch.cat([dy, dy], dim=-1)[..., :dy.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops.wkv6_bwd(r, k, v, w, u, s0, strided, ds)
    with pytest.raises(ValueError, match="device|tensors on"):
        wkv_ops.wkv6_bwd(r, k, v, w, u, s0, dy, ds.cpu())


# resident blocks per SM each backward pass is designed for (at least): the
# state passes' 320 blocks of the training shape in one wave (3 an SM),
# the chunk pass two blocks of 256 threads (~108 KB of shared memory at hd
# 64)
WKV_BWD_BLOCKS = {"wkv6_bwd_states": 3, "wkv6_bwd_dstates": 3,
                  "wkv6_bwd_chunk": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
def test_cuda_wkv6_bwd_resources(hd):
    """Every pass of the backward: no local memory (spills or stack),
    shared memory within the card's opt-in limit per block, and at least
    its design's resident blocks per SM (printed)."""
    _cuda()
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", 232448)
    infos = wkv_ops.wkv6_bwd_kernel_info(hd)
    assert len(infos) == 2 * len(wkv_ops.BWD_PASSES)
    for name, info in infos.items():
        print(f"hd {hd} {name}: {info}")
        assert info["local_bytes"] == 0, (name, info)
        assert 0 < info["smem_bytes"] <= optin, (name, info)
        assert info["blocks_per_sm"] >= WKV_BWD_BLOCKS[name.split("<")[0]], \
            (name, info)


def _wkv_pass_case(T, hd, dtype, dev, seed=13):
    B, H = (2, 3) if T < 2047 else (1, 4)
    rng = np.random.default_rng(seed + T + hd)
    td = DTYPES[dtype]
    args = list(_wkv_case_of(B, T, H, hd, 5.0, rng, dev, td))
    dy = torch.from_numpy(rng.standard_normal((B, T, H, hd))).to(dev, td)
    ds = torch.from_numpy(rng.standard_normal((B, H, hd, hd))).to(
        dev, torch.float32)
    return args + [dy, ds]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("T", [31, 32, 33, 63, 2047])
@pytest.mark.parametrize("which", ["states", "dstates", "chunk"])
def test_cuda_wkv6_bwd_pass_matches_twin(which, T, hd, dtype):
    """Each pass of the backward alone against its plain twin on the same
    inputs (the chunk pass from the twins' states and state gradients, so
    a fault shows in the pass where it lies): the two state passes at the
    forward's state limits (rtol 1e-3, atol 5e-4; their arithmetic is
    float32 whatever r's dtype), the chunk pass's float32 gradients there
    too and its bf16 ones within 2e-2 of the plain norm; two launches
    counted and bit-identical."""
    dev = _cuda()
    args = _wkv_pass_case(T, hd, dtype, dev)
    r, k, v, w, u, s0, dy, ds = args
    if which == "states":
        run = lambda: (wkv_ops.wkv6_bwd_states(*args),)            # noqa
        want = (wkv_ref.wkv6_bwd_states_plain(k, v, w, s0),)
    elif which == "dstates":
        run = lambda: wkv_ops.wkv6_bwd_dstates(*args)              # noqa
        want = wkv_ref.wkv6_bwd_dstates_plain(r, w, dy, ds)
    else:
        states = wkv_ref.wkv6_bwd_states_plain(k, v, w, s0).contiguous()
        dstates = wkv_ref.wkv6_bwd_dstates_plain(r, w, dy, ds)[0] \
            .contiguous()
        run = lambda: wkv_ops.wkv6_bwd_chunk(                      # noqa
            r, k, v, w, u, s0, dy, states, dstates)
        part = wkv_ref.wkv6_bwd_chunk_plain(r, k, v, w, u, dy, states,
                                            dstates)
        want = part[:4] + (part[4].sum((0, 2)),)
    name = f"wkv6_bwd_{which}"
    before = build.launch_counts().get(name, 0)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 2
    for n, (g, a, w_) in enumerate(zip(got, again, want)):
        assert g.dtype == w_.dtype and g.shape == w_.shape, n
        assert torch.equal(g, a), n
        assert torch.isfinite(g).all(), n
        if which != "chunk" or dtype == "float32":
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w_.float().cpu().numpy(), rtol=1e-3,
                                       atol=5e-4, err_msg=f"{which} {n}")
        else:
            assert _rel_norm(g, w_) <= 2e-2, (n, _rel_norm(g, w_))


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


# -- the request lifecycle on the card: snapshot, restore, drain -----------
def _bf16_engine(dev, **kw):
    """A bf16 smoke qwen engine on the card, CFS parking on HOST, four
    seeded 10-token requests of 6 new tokens, stepped 3 times."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.aqua_tensor import HOST
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(smoke_config(get_config("qwen1.5-0.5b")),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    eng = ServingEngine(cfg, model, max_running=2, max_seq=64,
                        scheduler="cfs", slice_tokens=4, offload_tier=HOST,
                        prefetch=False, device=dev, **kw)
    rng = np.random.default_rng(6)
    for _ in range(4):
        eng.submit(list(map(int, 1 + rng.integers(0, cfg.vocab_size - 1,
                                                  10))), 6)
    for _ in range(3):
        eng.step()
    return cfg, model, eng


@pytest.mark.cuda
def test_cuda_snapshot_round_trip_bit_identical_in_raw_words():
    """A snapshot's bf16 payload sits on the host as raw 16-bit words; a
    restore on the card and a second snapshot give the same words page for
    page (by position in each request's tables)."""
    from repro_torch.serving.engine import ServingEngine
    dev = _cuda()
    cfg, model, eng = _bf16_engine(dev)
    snap = eng.snapshot()
    a = snap["kv"]["planes"]["kv"]
    assert a["dtype"] == "bfloat16" and isinstance(a["data"], np.ndarray)
    assert a["data"].dtype == np.int16 and (a["data"] != 0).any()
    restored = ServingEngine.restore(cfg, model, snap, device=dev)
    b = restored.snapshot()["kv"]["planes"]["kv"]
    pos_a = {lp: i for i, lp in enumerate(a["lps"])}
    pos_b = {lp: i for i, lp in enumerate(b["lps"])}
    assert set(a["pages"]) == set(b["pages"])
    for rid, rows in a["pages"].items():
        for row_a, row_b in zip(rows, b["pages"][rid]):
            assert len(row_a) == len(row_b)
            for la, lb in zip(row_a, row_b):
                np.testing.assert_array_equal(a["data"][pos_a[la]],
                                              b["data"][pos_b[lb]])


@pytest.mark.cuda
def test_cuda_drain_unpins_everything_through_the_gather_kernel():
    from repro_torch.core.aqua_tensor import LOCAL
    dev = _cuda()
    _, _, eng = _bf16_engine(dev)
    assert eng.running
    build.reset_launch_counts()
    n = eng.drain()
    torch.cuda.synchronize()
    assert n >= 1 and build.launch_counts().get("gather_pages", 0) >= 1
    assert not eng.running and not eng.kv._active
    assert all(r.slot is None for r in eng.waiting)
    for plane in eng.kv.planes.values():
        local = plane.aqua.page_table[:, 0] == LOCAL
        assert int(local.sum()) == 1 and local[plane.scratch_lp]


@pytest.mark.cuda
def test_cuda_restored_engine_finishes_with_the_uninterrupted_tokens():
    from repro_torch.serving.engine import ServingEngine
    dev = _cuda()
    cfg, model, eng = _bf16_engine(dev)
    snap = eng.snapshot()
    eng.run(500)
    restored = ServingEngine.restore(cfg, model, snap, device=dev)
    restored.run(500)
    want = {r.rid: r.generated for r in eng.finished}
    got = {r.rid: r.generated for r in restored.finished}
    assert got == want and all(len(t) == 6 for t in got.values())


# -- deepseek-v2-lite-16b and jamba-v0.1-52b on the card: MLA, Mamba and
# the MoE, bf16 vs float32 -------------------------------------------------
DS_LAYER_REL = 2e-2     # bf16 vs float32 per token, relative (chip_smoke's)


def _float_pools(pools):
    if isinstance(pools, dict):
        return {k: v.to(torch.float32, copy=True) for k, v in pools.items()}
    return pools.to(torch.float32, copy=True)


def _smoke_engine(dev, arch, dtype, model=None, per_layer=None):
    """A smoke engine of ``arch`` on the card (CFS, a REMOTE lease, no
    speculative chunks): six seeded requests of 5 new tokens. Returns the
    engine, the model, its requests and each produced token's logits row by
    (rid, position), recorded from ``api.serve_step_paged`` and the rows'
    rids. With a ``per_layer`` list, every mixer call of the run (MLA,
    attention, Mamba) and every MoE call is also made by a float32 copy of
    its layer on the same input (and float32 copies of the pools as they
    were), and the largest per-real-token distance, relative to the
    token's largest float32 entry, is appended as (kind, distance)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.layers import attention as attn
    from repro_torch.layers import mla as mla_mod
    from repro_torch.layers.moe import MoE
    from repro_torch.models import api, lm
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype=dtype, compute_dtype=dtype)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    if model is None:
        model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), dev)
    eng = ServingEngine(cfg, model, max_running=2, max_seq=64,
                        scheduler="cfs", slice_tokens=3, step_tokens=16,
                        offload_tier=REMOTE, spec_chunk_ahead=False,
                        device=dev)
    eng.pager.add_remote_lease("donor0", 1 << 24)
    rng = np.random.default_rng(7)
    reqs = [eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, n))), 5)
            for n in (9, 21, 14, 30, 5, 17)]
    rows, logits, f32 = [], {}, {}
    serve, tables = api.serve_step_paged, eng.kv.block_tables
    mixers = [(mla_mod, "mla_mixed_paged", "mla"),
              (attn, "attention_mixed_paged", "attn"),
              (lm, "mamba_mixed_paged", "mamba")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in mixers]
    saved.append((lm, "ffn_apply", lm.ffn_apply))
    ffn, real = lm.ffn_apply, [None]

    def recorded_tables(lane_rids, *a, **kw):
        rows[:] = list(lane_rids)
        return tables(lane_rids, *a, **kw)

    def recorded(*a, **kw):
        out = serve(*a, **kw)
        host = out[0].float().cpu()
        for i, rid in enumerate(rows):
            if rid is not None:
                r = next(q for q in reqs if q.rid == rid)
                logits[(rid, len(r.generated))] = host[i]
        return out

    def rel(got, want):
        scale = want.abs().amax(-1).clamp_min(1e-6)
        d = (got.float() - want).abs().amax(-1) / scale
        return d[real[0]].max().item()

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    def checked(kind, mixer):
        def call(p, c, x, pools, *rest, **kw):
            # (bt, q_starts, n_reals) or (ssm, conv, n_reals, n_decode)
            nr = rest[2]
            nr = np.asarray(nr.cpu() if torch.is_tensor(nr) else nr)
            n_decode = kw["n_decode"] if "n_decode" in kw else rest[3]
            q = f32.setdefault(id(p), copy.deepcopy(p).float())
            want = first(mixer(q, cfg32, x.float(), _float_pools(pools),
                               *rest, **kw))
            out = mixer(p, c, x, pools, *rest, **kw)
            n = np.where(np.arange(len(nr)) < n_decode, 1, nr)
            real[0] = torch.as_tensor(np.arange(x.shape[1])[None]
                                      < n[:, None]).to(x.device)
            per_layer.append((kind, rel(first(out), want)))
            return out
        return call

    def ffn_checked(p, c, h):
        got = ffn(p, c, h)
        if isinstance(p, MoE):
            q = f32.setdefault(id(p), copy.deepcopy(p).float())
            per_layer.append(("moe", rel(got, ffn(q, cfg32, h.float()))))
        return got
    api.serve_step_paged, eng.kv.block_tables = recorded, recorded_tables
    if per_layer is not None:
        for (mod, name, kind), (_, _, fn) in zip(mixers, saved):
            setattr(mod, name, checked(kind, fn))
        lm.ffn_apply = ffn_checked
    try:
        eng.run(500)
    finally:
        api.serve_step_paged = serve
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del eng.kv.block_tables
    return eng, model, reqs, logits


def _engine_matches_float32(arch, kinds):
    """The bf16 smoke engine of ``arch`` on the card, held against float32
    two ways (see the tests below); returns the per-layer distances."""
    dev = _cuda()
    build.reset_launch_counts()
    per_layer = []
    eng, model, reqs, lg16 = _smoke_engine(dev, arch, "bfloat16",
                                           per_layer=per_layer)
    launches = build.launch_counts()
    assert eng.metrics.preemptions > 0
    assert launches.get("gather_pages", 0) > 0
    assert launches.get("scatter_pages", 0) > 0
    for kind, per_step in kinds.items():
        d = [v for k, v in per_layer if k == kind]
        assert len(d) == eng.metrics.steps * per_step, kind
        assert max(d) <= DS_LAYER_REL, (kind, max(d))
    _, _, reqs32, lg32 = _smoke_engine(dev, arch, "float32",
                                       model=_float_copy(model))
    held = 0
    for r16, r32 in zip(reqs, reqs32):
        assert len(r16.generated) == len(r32.generated) == 5
        for pos, (a, b) in enumerate(zip(r16.generated, r32.generated)):
            x16, x32 = lg16[(r16.rid, pos)], lg32[(r32.rid, pos)]
            top2 = x32.topk(2).values
            if (top2[0] - top2[1]).item() > 2 * (x16 - x32).abs().max():
                assert a == b, (r16.rid, pos)
                held += 1
            elif a != b:
                break
    assert held >= 1
    return launches


@pytest.mark.cuda
def test_cuda_deepseek_engine_bf16_matches_float32():
    """The bf16 smoke deepseek engine on the card, held against float32
    two ways. Per layer: every MLA and MoE call of the run against a
    float32 copy of its layer on the same input, within 2% per real token
    (the MoE's routing is float32 on both sides, so the same experts run).
    Per token: against the same weights served in float32 (the schedule
    depends on token counts, not values), each request followed while its
    context is the float32 run's; wherever the float32 top-2 margin
    exceeds twice the row's distance to the bf16 row, the greedy tokens
    must be equal (elsewhere a routing near-tie may part them, and the
    per-layer check stands). The bf16 run preempts through the gather and
    scatter kernels."""
    _engine_matches_float32("deepseek-v2-lite-16b", {"mla": 4, "moe": 4})


@pytest.mark.cuda
def test_cuda_jamba_engine_bf16_matches_float32():
    """The bf16 smoke jamba engine (8 layers: 7 Mamba, 1 attention, the
    MoE in 4) on the card, held against float32 as the deepseek engine
    above: every Mamba, attention and MoE call of the run against a
    float32 copy of its layer within 2% per real token, greedy tokens
    where the float32 margin decides. Its parks move the ssm, conv and kv
    pages through the gather and scatter kernels; the attention layer
    runs rows 4 and 5 at every step."""
    launches = _engine_matches_float32("jamba-v0.1-52b",
                                       {"mamba": 7, "attn": 1, "moe": 4})
    assert launches["append_kv"] == launches["paged_mixed_attention_pool"] \
        > 0


@pytest.mark.cuda
def test_cuda_dbrx_engine_bf16_matches_float32():
    """The bf16 smoke dbrx engine (4 layers: attention at G 2 and the MoE,
    4 experts top 2, no shared expert) on the card, held against float32
    as the deepseek engine above: every attention and MoE call of the run
    against a float32 copy of its layer within 2% per real token, greedy
    tokens where the float32 margin decides; rows 4 and 5 once per layer
    per step, parks through the gather and scatter kernels."""
    launches = _engine_matches_float32("dbrx-132b", {"attn": 4, "moe": 4})
    assert launches["append_kv"] == launches["paged_mixed_attention_pool"] \
        > 0


def _float_copy(model):
    import copy
    return copy.deepcopy(model).float()


# -- jamba-v0.1-52b: the ssm and conv rows, the Mamba layer -----------------
HYBRID_ROWS = {"ssm": 524288, "conv": 49152}    # (8192, 16) f32, (3, 8192) bf16


@pytest.mark.cuda
@pytest.mark.parametrize("n_case", ["one", "below_grid", "above_grid",
                                    "engine_leg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("leg", sorted(HYBRID_ROWS))
def test_cuda_gather_and_scatter_hybrid_rows_bit_exact(leg, dtype, n_case):
    """Rows 6-7 at jamba's state rows: the ssm page (524,288 B, 32 chunks
    of 16 KiB) and the conv page (49,152 B, 3 chunks), in float32 and
    bf16, at one row, fewer work items than the grid, a grid multiple plus
    a remainder and one request's leg (14 Mamba layers at 16 layers), ids
    outside the pool included; gather and scatter bit-exact against their
    plain versions."""
    dev = _cuda()
    sms = kv_ops.sm_count(dev.index or 0)
    n = {"one": 1, "below_grid": 7,
         "above_grid": 3 * kv_ops.BLOCKS_PER_SM * sms + 5,
         "engine_leg": 14}[n_case]
    P = 2 * n + 3
    pool = _gather_pool(dev, dtype, HYBRID_ROWS[leg], P, seed=n)
    rng = np.random.default_rng(n)
    ids_np = rng.choice(P, n, replace=False).astype(np.int32)
    if n > 2:
        ids_np[0], ids_np[n // 2] = -1, P
    ids = torch.from_numpy(ids_np).to(dev)
    got = kv_ops.gather_pages(pool, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, kv_ref.gather_pages_ref(pool, ids))
    new = torch.randn(got.shape, device=dev).to(pool.dtype)
    out = kv_ops.scatter_pages(pool.clone(), new, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, kv_ref.scatter_pages_ref(pool.clone(), new, ids))


# -- internvl2-1b's kv page, a LoRA adapter page, gemma-7b's kv page -------
# (kv: 2 x 2 heads x 16 tokens x 64 bf16; 65,536 bf16; 2 x 16 x 16 x 256
# bf16) and one leg of each: a park of 800 tokens over 24 and 28 layers,
# one rank-16 qwen1.5-0.5b adapter
PAGE_ROWS = {"internvl2_kv": (8192, 1200), "lora": (131072, 24),
             "gemma_kv": (262144, 1400),
             # llama2-13b's and opt-30b's kv rows (2 x 40 and 56 heads x 16
             # x 128 bf16), a park of 800 tokens over 40 and 48 layers
             "llama2_kv": (327680, 2000), "opt_kv": (458752, 2400)}


@pytest.mark.cuda
@pytest.mark.parametrize("n_case", ["one", "below_grid", "above_grid",
                                    "engine_leg"])
@pytest.mark.parametrize("leg", sorted(PAGE_ROWS))
def test_cuda_gather_and_scatter_page_rows_bit_exact(leg, n_case):
    """Rows 6-7 at the internvl2 kv row (8,192 B), the LoRA adapter page
    (131,072 B), the gemma kv row (262,144 B) and the llama2-13b and
    opt-30b kv rows (327,680 B and 458,752 B), bf16, at one row, fewer
    work items than the grid, a grid multiple plus a remainder and one
    leg, ids outside the pool included; gather and scatter bit-exact
    against their plain versions."""
    dev = _cuda()
    sms = kv_ops.sm_count(dev.index or 0)
    row_bytes, leg_rows = PAGE_ROWS[leg]
    n = {"one": 1, "below_grid": 7,
         "above_grid": 3 * kv_ops.BLOCKS_PER_SM * sms + 5,
         "engine_leg": leg_rows}[n_case]
    P = 2 * n + 3
    pool = _gather_pool(dev, "bfloat16", row_bytes, P, seed=n)
    rng = np.random.default_rng(n)
    ids_np = rng.choice(P, n, replace=False).astype(np.int32)
    if n > 2:
        ids_np[0], ids_np[n // 2] = -1, P
    ids = torch.from_numpy(ids_np).to(dev)
    got = kv_ops.gather_pages(pool, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, kv_ref.gather_pages_ref(pool, ids))
    new = torch.randn(got.shape, device=dev).to(pool.dtype)
    out = kv_ops.scatter_pages(pool.clone(), new, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, kv_ref.scatter_pages_ref(pool.clone(), new, ids))


@pytest.mark.cuda
def test_cuda_kernels_reach_the_last_page_of_a_pool_past_2_31_elements():
    """opt-30b's LOCAL pool: 12,289 pages of (2, 56 heads, 16, 128) bf16,
    2.82e9 elements (5.64 GB), so a page offset past slot 9,362 overflows
    32 bits. Row 4 (a decode lane and a chunk row whose tables end on the
    pool's last pages), rows 1-3 on the same rows (bit for bit against
    the mixed launch), row 5 writing into the last page and rows 6-7
    gathering and scattering it, each against its plain version."""
    dev = _cuda()
    P, K, page, hd, H = 12289, 56, 16, 128, 56
    g = torch.Generator(device=dev).manual_seed(21)
    pool = torch.randn((P, 2, K, page, hd), generator=g, device=dev,
                       dtype=torch.bfloat16)
    assert pool.numel() > 2 ** 31
    last = [P - 1 - i for i in range(16)]              # all past 2^31
    # (2, 8): the decode lane's eighth page, where it writes, is the
    # pool's last
    bt = torch.tensor([last[0::2][::-1], last[1::2]], dtype=torch.int32,
                      device=dev)
    starts = torch.tensor([120, 37], dtype=torch.int32, device=dev)
    n_reals = torch.tensor([1, 40], dtype=torch.int32, device=dev)
    is_dec = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    q = torch.randn((2, 40, H, hd), generator=g, device=dev,
                    dtype=torch.bfloat16)
    mixed = pa_ops.paged_mixed_attention_pool(q, pool, bt, starts, n_reals,
                                              is_dec)
    want = pa_ref.paged_mixed_attention_pool_ref(q, pool, bt, starts,
                                                 n_reals, is_dec)
    dec = pa_ops.paged_attention_pool(q[:1, 0].contiguous(), pool, bt[:1],
                                      starts[:1] + 1)
    split = pa_ops.paged_attention(q[:1, 0].contiguous(), *_split(pool),
                                   bt[:1], starts[:1] + 1)
    chunk = pa_ops.paged_prefill_attention_pool(q[1:].contiguous(), pool,
                                                bt[1:].contiguous(),
                                                starts[1:].contiguous())
    torch.cuda.synchronize()
    np.testing.assert_allclose(mixed.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=3e-2)
    assert torch.equal(mixed[:1, 0], dec) and torch.equal(split, dec)
    assert torch.equal(mixed[1:], chunk)
    # row 5: the lane's token at 120 into the pool's last page, the chunk
    # row's 40 tokens from 37 into its pages 2-4
    k, v = (torch.randn((2, 40, K, hd), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    touched = torch.tensor(last, device=dev).long()
    before = pool[touched].clone()
    want = pa_ref.write_kv_rows_ref(before.clone(), k, v, _local(bt, last),
                                    starts, n_reals)
    pa_ops.write_kv_rows(pool, k, v, bt, starts, n_reals)
    torch.cuda.synchronize()
    assert torch.equal(pool[touched], want)
    assert not torch.equal(pool[touched], before)
    # rows 6-7 at the last pages and one below 2^31
    ids = torch.tensor([P - 1, 0, P - 2, 9362, 9363], dtype=torch.int32,
                       device=dev)
    got = kv_ops.gather_pages(pool, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, kv_ref.gather_pages_ref(pool, ids))
    new = torch.randn(got.shape, generator=g, device=dev).to(pool.dtype)
    kv_ops.scatter_pages(pool, new, ids)
    torch.cuda.synchronize()
    assert torch.equal(pool[ids.long()], new)


def _local(bt, slots):
    """``bt``'s entries renumbered as indices into ``slots``."""
    index = {s: i for i, s in enumerate(slots)}
    return torch.tensor([[index[int(x)] for x in row] for row in bt.tolist()],
                        dtype=torch.int32, device=bt.device)


def _mamba_layer(dev, dtype):
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.layers.mamba import Mamba
    cfg = dataclasses.replace(smoke_config(get_config("jamba-v0.1-52b")),
                              param_dtype=dtype, compute_dtype=dtype)
    return cfg, Mamba(cfg, dev, torch.Generator(device=dev).manual_seed(3))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["forward", "decode"])
def test_cuda_mamba_matches_float32(fn):
    """``mamba_forward`` (a bucket-padded chunk of 256 rows: two scan
    chunks, per-lane ``n_real``) and ``mamba_decode`` on the card: in
    float32 within 1e-4 of the same function on the CPU, and in bf16
    within 2% per token (relative to the token's largest float32 entry)
    of a float32 copy of the layer, its states within 2e-2."""
    import copy

    from repro_torch.layers import mamba as mamba_mod
    dev = _cuda()
    cfg32, mix32 = _mamba_layer(dev, "float32")
    cfg16 = cfg32.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    mix16 = copy.deepcopy(mix32).to(torch.bfloat16)
    mix16.A_log.data, mix16.D.data = mix32.A_log.data, mix32.D.data
    di, ds, dc, _ = mamba_mod._dims(cfg32)
    g = torch.Generator(device=dev).manual_seed(5)
    B, T = (3, 256) if fn == "forward" else (4, 1)
    x = torch.randn((B, T, cfg32.d_model), generator=g, device=dev)
    st = mamba_mod.MambaState(
        0.5 * torch.randn((B, di, ds), generator=g, device=dev),
        torch.randn((B, dc - 1, di), generator=g, device=dev))
    n_real = np.asarray([256, 131, 0]) if fn == "forward" else None

    def run(mix, cfg, x, st, device):
        mix = copy.deepcopy(mix).to(device)
        st = mamba_mod.MambaState(*(t.to(device) for t in st))
        if fn == "forward":
            return mamba_mod.mamba_forward(mix, cfg, x.to(device), st,
                                           n_real=n_real)
        return mamba_mod.mamba_decode(mix, cfg, x.to(device), st)
    out, new = run(mix32, cfg32, x, st, dev)
    cpu_out, cpu_new = run(mix32, cfg32, x, st, torch.device("cpu"))
    torch.cuda.synchronize()
    for a, b in ((out, cpu_out), (new.ssm, cpu_new.ssm),
                 (new.conv, cpu_new.conv)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    st16 = mamba_mod.MambaState(st.ssm, st.conv.to(torch.bfloat16))
    out16, new16 = run(mix16, cfg16, x.to(torch.bfloat16), st16, dev)
    torch.cuda.synchronize()
    assert out16.dtype == torch.bfloat16 and new16.ssm.dtype == torch.float32
    scale = out.abs().amax(-1).clamp_min(1e-6)
    rel = ((out16.float() - out).abs().amax(-1) / scale)
    if fn == "forward":
        rel = rel[torch.as_tensor(np.arange(T)[None] < n_real[:, None],
                                  device=dev)]
    assert rel.max().item() <= DS_LAYER_REL
    np.testing.assert_allclose(new16.ssm.cpu().numpy(),
                               new.ssm.cpu().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_jamba_packed_step_is_deterministic():
    """A bf16 smoke jamba packed step whose chunk rows' padding reaches
    past their pages (into the table's scratch padding), run twice on the
    card: the logits and every pool bit-identical. The padding is not
    written, so the scratch page that pad rows read holds the same values
    each run, and the MoE's per-expert row counts are the same."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import api, lm
    dev = _cuda()
    cfg = dataclasses.replace(smoke_config(get_config("jamba-v0.1-52b")),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                           dev)
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    page, R, Tc, n_dec = 8, 6, 32, 2
    q_starts = np.asarray([40, 17, 3, 0, 0, 0], np.int32)
    n_reals = np.asarray([1, 1, 20, 9, 0, 0], np.int32)
    need = [-(-(q + max(n, 1)) // page) if n else 0
            for q, n in zip(q_starts, n_reals)]
    pps = 8
    kv_bt = np.zeros((1, 1, R, pps), np.int32)
    free = list(1 + rng.permutation(sum(need)))
    for r in range(R):
        kv_bt[0, 0, r, :need[r]], free = free[:need[r]], free[need[r]:]
    st = np.zeros((1, 7, R), np.int32)
    st[0, :, :4] = (1 + rng.permutation(28)).reshape(7, 4)
    di = cfg.ssm.mamba_expand * cfg.d_model
    pools0 = {"ssm": 0.1 * torch.randn((29, di, cfg.ssm.mamba_d_state),
                                       generator=g, device=dev),
              "conv": torch.randn((29, cfg.ssm.mamba_d_conv - 1, di),
                                  generator=g, device=dev).to(torch.bfloat16),
              "kv": torch.randn((1 + sum(need), 2, cfg.n_kv_heads, page,
                                 cfg.resolved_head_dim), generator=g,
                                device=dev).to(torch.bfloat16)}
    bt = {"ssm": st, "conv": st.copy(), "kv": kv_bt}
    tokens = rng.integers(0, cfg.vocab_size, (R, Tc)).astype(np.int32)
    runs = []
    for _ in range(2):
        pools = {k: v.clone() for k, v in pools0.items()}
        lg, pools = api.serve_step_paged(model, cfg, tokens, pools, bt,
                                         q_starts, n_reals, n_decode=n_dec,
                                         read_pps=pps)
        torch.cuda.synchronize()
        runs.append((lg, pools))
    assert torch.equal(runs[0][0], runs[1][0])
    for name in pools0:
        assert torch.equal(runs[0][1][name], runs[1][1][name]), name


# the dense KV-cache path: every family's smoke config, and row 9 at the
# prefill shapes of gemma3-12b's local and global layers and of
# aqua-mistral-7b's, at lengths that are no multiple of a tile
DENSE_CACHE_ARCHS = ("qwen1.5-0.5b", "gemma3-12b", "aqua-mistral-7b",
                     "rwkv6-3b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
                     "internvl2-1b", "dbrx-132b")
DENSE_FLASH_CASES = {"gemma3_local": (1, 1300, 16, 8, 256, 1024),
                     "gemma3_global": (1, 1300, 16, 8, 256, 0),
                     "mistral": (1, 4150, 32, 8, 128, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE_CACHE_ARCHS)
def test_cuda_dense_cache_path_matches_cpu(arch):
    """``api.prefill`` of 20 tokens (a VLM's 8 prefix rows before them)
    then 4 ``api.decode_step``s at the float32 smoke config, on the card
    and on the CPU from the same weights: logits and every cache leaf
    within 1e-4. On the card the prefill runs the flash kernel once per
    attention layer, and rwkv6-3b the WKV kernel once per layer a call,
    from the cache's state."""
    import copy

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import api, lm
    dev = _cuda()
    cfg = smoke_config(get_config(arch))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    B, T, S, TP = 2, 24, 32, 20
    toks = rng.integers(0, cfg.vocab_size, (B, T))
    P = cfg.n_prefix_embeds
    pre = (torch.from_numpy((0.02 * rng.standard_normal(
        (B, P, cfg.d_model))).astype(np.float32)) if P else None)

    def run(m, device):
        cache = api.init_decode_state(cfg, B, S, torch.float32,
                                      device=device)
        lg, cache = api.prefill(m, cfg, toks[:, :TP], cache,
                                prefix_embeds=pre)
        out = [lg]
        for i in range(TP, T):
            lg, cache = api.decode_step(m, cfg, cache, toks[:, i],
                                        np.full(B, P + i))
            out.append(lg)
        return out, cache
    before = build.launch_counts()
    got, cache = run(copy.deepcopy(model).to(dev), dev)
    torch.cuda.synchronize()
    after = build.launch_counts()
    want, cpu_cache = run(model, torch.device("cpu"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for sub, c in cache.items():
        for g, w in zip(c, cpu_cache[sub]):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=sub)
    n_attn = sum(lm.mixer_kind(cfg, l % lm.group_size(cfg))
                 in ("attn", "attn_local") for l in range(cfg.n_layers))
    launched = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("flash_attention", "wkv6")}
    n_wkv = cfg.n_layers * (1 + T - TP) if cfg.family == "ssm" else 0
    assert launched == {"flash_attention": n_attn, "wkv6": n_wkv}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DENSE_FLASH_CASES))
def test_cuda_flash_at_dense_cache_shapes(case, dtype):
    """The flash forward at hd 256 under a window of 1,024 (and none) and
    at hd 128 under 4,096, GQA, T ragged: within the attention tolerance
    of the plain version, its lse within 1e-5, two calls bit-identical."""
    dev = _cuda()
    B, T, H, K, hd, window = DENSE_FLASH_CASES[case]
    rng = np.random.default_rng(hd + window)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev, DTYPES[dtype])
        for s in ((B, T, H, hd), (B, T, K, hd), (B, T, K, hd))]
    kw = dict(causal=True, window=window)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = fa_ops.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - ro.float()).abs().max().item() <= FLASH_TOL[dtype]
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_link_legs_fit():
    """A 4-size version of ``chip_smoke.py``'s link legs: aqua-llama2-13b's
    kv pages (327,680 B) moved LOCAL -> HOST -> LOCAL and LOCAL -> REMOTE
    slab -> LOCAL through ``AquaTensor``'s own moves at 4, 16, 64 and 256
    pages, each move timed wall to wall (median of 3), every round trip
    bit-identical, each move metered as its pages' bytes in one message;
    ``fit_link_model`` fits both legs' samples to positive terms and
    ``calibrate_profile`` takes the host fit, leaving the fabric as it is."""
    import time

    from repro_torch.core.aqua_tensor import (HOST, REMOTE, AquaTensor,
                                              TransferMeter)
    from repro_torch.core.perfmodel import (H100_SXM, calibrate_profile,
                                            fit_link_model)
    dev = _cuda()
    shape, n_pages = (2, 40, 16, 128), 256
    aq = AquaTensor(n_logical=n_pages, page_shape=shape, local_slots=n_pages,
                    host_slots=n_pages, dtype=torch.bfloat16,
                    meter=TransferMeter(hw=H100_SXM), device=dev)
    aq.add_remote_lease("slab0", n_pages)
    assert aq.page_bytes == 327_680 and aq.host_pool.is_pinned()
    lps = aq.allocate(n_pages)
    data = torch.randn((n_pages,) + shape, device=dev).to(torch.bfloat16)
    aq.write_local(lps, data)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    samples = {"host": [], "slab": []}
    for n in (4, 16, 64, 256):
        sel = lps[:n]
        for leg, tier, link in (("host", HOST, "host"),
                                ("slab", REMOTE, "fabric")):
            secs = {"out": [], "in": []}
            for rep in range(4):
                b0 = getattr(aq.meter, f"bytes_{link}")
                m0 = getattr(aq.meter, f"messages_{link}")
                t_out = timed(lambda: aq.offload(sel, prefer=tier))
                assert aq.tier_counts()[
                    "host" if tier == HOST else "remote"] == n
                t_in = timed(lambda: aq.ensure_local(sel))
                assert getattr(aq.meter, f"bytes_{link}") - b0 == \
                    2.0 * n * aq.page_bytes
                assert getattr(aq.meter, f"messages_{link}") - m0 == 2
                assert torch.equal(aq.read(sel), data[:n])
                if rep:
                    secs["out"].append(t_out)
                    secs["in"].append(t_in)
            for d in ("out", "in"):
                samples[leg].append((float(n * aq.page_bytes),
                                     float(np.median(secs[d]))))
    host = fit_link_model(samples["host"], "pcie5-measured")
    slab = fit_link_model(samples["slab"], "same-card slab, not NVLink")
    for link in (host, slab):
        assert link is not None and link.peak_bw > 0 and link.latency >= 0
    cal = calibrate_profile(H100_SXM, host_samples=samples["host"])
    assert cal.host_link == host and cal.fabric is H100_SXM.fabric
    assert cal.name == "h100-sxm-datasheet-calibrated"


# whisper-tiny (the encoder-decoder): row 9 at its shapes, bidirectional
# over the 1,500 encoder frames and cross-attention of 1, 4 and a ragged
# 70 decoder rows against them; its dense cache and training on the card
# against the CPU; ``compress_tree`` on the card against the CPU; the
# windowed configs' train steps on the card against the CPU
WHISPER_FLASH_CASES = {"encoder": (1, 1500, 1500, 6, 6, 64, False, 0),
                       "cross_decode": (3, 1, 1500, 6, 6, 64, False, 0),
                       "cross_prefill": (2, 4, 1500, 6, 6, 64, False, 0),
                       "cross_ragged": (2, 70, 1500, 6, 6, 64, False, 0),
                       "decoder": (2, 448, 448, 6, 6, 64, True, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WHISPER_FLASH_CASES))
def test_cuda_flash_at_whisper_shapes(case, dtype):
    """The flash forward within the attention tolerance of the plain
    version (its lse within 1e-5) and the backward's dq / dk / dv within
    the flash backward's limits of the plain formula's norm, at Sq = 1 and
    at Sq and Sk that are no multiple of a tile; each twice,
    bit-identical."""
    dev = _cuda()
    B, Sq, Sk, H, K, hd, causal, window = WHISPER_FLASH_CASES[case]
    rng = np.random.default_rng(Sq + Sk)
    q, k, v, do = [torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev, DTYPES[dtype])
        for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                  (B, Sq, H, hd))]
    kw = dict(causal=causal, window=window)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = fa_ops.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
    got = fa_ops.flash_attention_bwd(q, k, v, ro, rlse, do, **kw)
    again = fa_ops.flash_attention_bwd(q, k, v, ro, rlse, do, **kw)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, ro, rlse, do, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - ro.float()).abs().max().item() <= FLASH_TOL[dtype]
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    for name, g, g2, w in zip("qkv", got, again, want):
        assert torch.equal(g, g2), name
        assert _rel_norm(g, w) <= FLASH_BWD_REL[dtype], name


def _whisper_smoke():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import api
    cfg = smoke_config(get_config("whisper-tiny"))
    model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    enc = torch.from_numpy((0.02 * rng.standard_normal(
        (2, cfg.encdec.encoder_seq_len, cfg.d_model))).astype(np.float32))
    return cfg, model, rng.integers(0, cfg.vocab_size, (2, 24)), enc


@pytest.mark.cuda
def test_cuda_whisper_dense_cache_matches_cpu():
    """``api.prefill`` of 20 tokens over 32 frames then 4
    ``api.decode_step``s at the float32 smoke config, on the card and on
    the CPU from the same weights: logits and every cache leaf within
    1e-4. On the card the prefill runs the flash kernel once a layer's
    attention (the encoder's, the decoder's self and cross) and each
    decode step once a decoder layer (its cross-attention, one row)."""
    import copy

    from repro_torch.models import api
    dev = _cuda()
    cfg, model, toks, enc = _whisper_smoke()
    B, TP, T = 2, 20, 24

    def run(m, device):
        cache = api.init_decode_state(cfg, B, 32, torch.float32,
                                      device=device)
        lg, cache = api.prefill(m, cfg, toks[:, :TP], cache,
                                enc_embeds=enc)
        out = [lg]
        for i in range(TP, T):
            lg, cache = api.decode_step(m, cfg, cache, toks[:, i],
                                        np.full(B, i))
            out.append(lg)
        return out, cache
    before = build.launch_counts()
    got, cache = run(copy.deepcopy(model).to(dev), dev)
    torch.cuda.synchronize()
    after = build.launch_counts()
    want, cpu_cache = run(model, torch.device("cpu"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for sub, c in cache.items():
        for g, w in zip(c, cpu_cache[sub]):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=sub)
    n = after.get("flash_attention", 0) - before.get("flash_attention", 0)
    assert n == cfg.encdec.n_encoder_layers + 2 * cfg.n_layers \
        + (T - TP) * cfg.n_layers


def _grads(loss_fn, model):
    from repro_torch.training.train_loop import trainable_params
    params = trainable_params(model)
    loss = loss_fn(model)
    return loss.item(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "gemma3-12b",
                                  "aqua-mistral-7b"])
def test_cuda_train_step_matches_cpu(arch):
    """The float32 smoke config's loss (1e-5 relative) and every
    gradient (1e-4 of its norm) through the flash kernels on the card
    against the plain versions on the CPU, from the same weights and
    batch (whisper: 2 x 24 tokens over 32 frames; the windowed configs: 2
    x 40 tokens past their window of 16); forward and backward launched
    once a layer's attention."""
    import copy

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import api
    from repro_torch.training.data import DataConfig, make_batch
    dev = _cuda()
    cfg = smoke_config(get_config(arch))
    model = api.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = make_batch(DataConfig(seed=3, batch=2, seq_len=24
                                  if cfg.encdec else 40), cfg, 0)
    card = copy.deepcopy(model).to(dev)
    before = build.launch_counts()
    loss_k, g_k = _grads(lambda m: api.loss_fn(m, cfg, {
        k: v.to(dev) for k, v in batch.items()}), card)
    torch.cuda.synchronize()
    after = build.launch_counts()
    loss_c, g_c = _grads(lambda m: api.loss_fn(m, cfg, batch), model)
    assert abs(loss_k - loss_c) <= 1e-5 * abs(loss_c)
    for name, g in g_c.items():
        assert _rel_norm(g_k[name].cpu(), g) <= 1e-4, name
    n_attn = cfg.n_layers + (cfg.encdec.n_encoder_layers + cfg.n_layers
                             if cfg.encdec else 0)
    for name in ("flash_attention", "flash_attention_bwd"):
        assert after.get(name, 0) - before.get(name, 0) == n_attn, name


@pytest.mark.cuda
def test_cuda_compress_tree_bit_equal_to_cpu():
    """``compress_tree`` of bf16 and float32 gradients on the card, with
    a non-zero error buffer fed back once: payloads, scales and error
    buffers equal to the CPU's bit for bit."""
    from repro_torch.training import compression
    dev = _cuda()
    rng = np.random.default_rng(4)
    grads = {f"g{i}": torch.from_numpy((rng.standard_normal(s) * 10.0 ** (
        i - 3)).astype(np.float32)) for i, s in enumerate(
        [(7,), (64, 33), (3, 128, 40), (1000,), (5, 5)])}
    grads["g0"] = grads["g0"].bfloat16()

    def run(device):
        g = {k: t.to(device) for k, t in grads.items()}
        err = compression.init_error_buffers(g)
        out = []
        for _ in range(2):
            comps, err = compression.compress_tree(g, err)
            out.append((comps, err))
        return out

    def bits(t):
        return t.contiguous().view(torch.int32).cpu()
    for (cg, eg), (cc, ec) in zip(run(dev), run(torch.device("cpu"))):
        for k in grads:
            assert torch.equal(cg[k].q.cpu(), cc[k].q), k
            assert torch.equal(bits(cg[k].scale), bits(cc[k].scale)), k
            assert torch.equal(bits(eg[k]), bits(ec[k])), k


# -- the scale-up domain on the card: a domain over [cuda:0, cuda:0] (the
# "peer" is the same card, each leg a same-memory copy plus rows 6 and 7),
# the int8 all-reduce on NCCL at world size 1, and a gather on a second
# card launched while the first is current -------------------------------
@pytest.mark.cuda
def test_cuda_mesh_domain_round_trip_one_leg_a_move():
    """An ``AquaTensor`` over ``MeshTierDomain([cuda:0, cuda:0])``: offload
    to the donor slab and back, bit-exact, each move one leg, one meter
    message and one scatter (push) or gather (pull) on the donor side."""
    from repro_torch.core.aqua_tensor import (LOCAL, REMOTE, AquaTensor,
                                              TransferMeter)
    from repro_torch.distributed.mesh_tiers import MeshTierDomain
    dev = _cuda()
    dom = MeshTierDomain(devices=[dev, dev])
    for dtype in (torch.float32, torch.bfloat16):
        a = AquaTensor(n_logical=64, page_shape=(2, 4, 16, 32),
                       local_slots=32, host_slots=8, dtype=dtype,
                       meter=TransferMeter(), device=dev, mesh=dom)
        a.add_remote_lease("d0", 32)
        assert a.remote_pools["d0"].shape[0] == 33
        lps = a.allocate(13)
        payload = torch.randn((13,) + a.page_shape, device=dev).to(dtype)
        a.write_local(lps, payload)
        for move, tier in ((lambda: a.offload(lps, prefer=REMOTE), REMOTE),
                           (lambda: a.ensure_local(lps), LOCAL)):
            c0, m0 = dom.collectives, a.meter.messages_fabric
            build.reset_launch_counts()
            move()
            torch.cuda.synchronize()
            counts = build.launch_counts()
            assert (a.page_table[lps, 0] == tier).all()
            assert dom.collectives - c0 == 1
            assert a.meter.messages_fabric - m0 == 1
            # push: the LOCAL gather + the donor scatter; pull: the donor
            # gather + the LOCAL scatter
            assert counts.get("gather_pages", 0) == 1
            assert counts.get("scatter_pages", 0) == 1
            assert torch.equal(a.read(lps), payload)
    assert len(dom.samples["fabric"]) > 0


@pytest.mark.cuda
def test_cuda_compressed_psum_nccl_world_one():
    """``compressed_psum`` on an NCCL group of world size 1 built from a
    ``HashStore`` (no socket): the mean and error buffer equal
    ``decompress(compress(g, err))`` on the card, and the CPU's, bit for
    bit, through two rounds of error feedback."""
    import torch.distributed as dist
    from repro_torch.training import compression
    dev = _cuda()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rng = np.random.default_rng(81)
        for shape in ((7,), (64, 33), (3, 128, 40)):
            g = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
            err_k = torch.zeros(shape, device=dev)
            err_c = torch.zeros(shape)
            for _ in range(2):
                mean, err_k2 = compression.compressed_psum(g.to(dev), err_k)
                comp, want_err = compression.compress(g.to(dev), err_k)
                comp_c, err_c = compression.compress(g, err_c)
                want = compression.decompress(comp)
                assert torch.equal(mean.cpu().view(torch.int32),
                                   want.cpu().view(torch.int32))
                assert torch.equal(err_k2.cpu().view(torch.int32),
                                   want_err.cpu().view(torch.int32))
                assert torch.equal(mean.cpu().view(torch.int32),
                                   compression.decompress(comp_c).view(
                                       torch.int32))
                assert torch.equal(err_k2.cpu().view(torch.int32),
                                   err_c.view(torch.int32))
                err_k = err_k2
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_gather_on_second_card_while_first_is_current():
    """The device guard: a gather and a scatter on ``cuda:1`` tensors,
    called while ``cuda:0`` is current, launch on ``cuda:1`` and give the
    plain version's rows."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.kernels.kv_gather import ops as kv_ops
    d1 = torch.device("cuda:1")
    pool = torch.randn((64, 4, 128), device=d1)
    ids = torch.tensor([5, 0, 63, 17], dtype=torch.int32, device=d1)
    with torch.cuda.device(0):
        got = kv_ops.gather_pages(pool, ids)
        kv_ops.scatter_pages(pool, got * 2, ids)
    torch.cuda.synchronize(d1)
    assert got.device == d1
    assert torch.equal(got.cpu(), pool.cpu()[ids.long().cpu()] / 2)
