"""The gather's work plan and a model of its bulk-copy kernel, on the CPU.

``kv_gather.ops.gather_plan`` decides the route (bulk copy or vector kernel),
the chunk, the ring's stages and the grid from the shapes, the base
addresses' alignment and the SM count; the CUDA kernel
(``csrc/kv_gather.cu``, ``gather_bulk_kernel``) walks the plan's work items.
Here the plan is checked at the engine's three leg shapes and at rows the
bulk copy cannot take, and ``_model_gather`` replays the kernel's loop in
Python (its item order, its id windows, its ring of stages with a load
only into a stage whose store has read it): every byte of every staging
row is written exactly once, and the rows equal ``gather_pages_ref`` and
the reference's Pallas ``gather_pages`` in interpret mode, exactly. Ids
outside the pool: the port gathers a zero row and scatters nothing on
both devices, where the reference's kernels clamp into the pool; the
reference's answers are recorded beside the port's.
``test_torch_cuda.py`` holds the kernel itself against the plain version
on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_gather.kernel import gather_pages as j_gather
from repro_torch.kernels.kv_gather import ops as kv_ops
from repro_torch.kernels.kv_gather import ref as kv_ref

H100_SMS = 132


@pytest.mark.parametrize("leg,n,row_bytes,chunk,blocks", [
    ("qwen kv", 1200, 65536, 16384, 2 * H100_SMS),
    ("rwkv wkv", 32, 655360, 16384, 2 * H100_SMS),
    ("rwkv shift", 32, 10240, 2560, 128),
])
def test_plan_at_the_engine_legs(leg, n, row_bytes, chunk, blocks):
    plan = kv_ops.gather_plan(n, row_bytes, 16, H100_SMS)
    assert plan == kv_ops.GatherPlan("bulk", chunk, kv_ops.STAGES, blocks)
    assert plan.smem_bytes <= 227 * 1024 // kv_ops.BLOCKS_PER_SM


@pytest.mark.parametrize("n,row_bytes,base_align", [
    (4, 12, 16), (4, 1000, 16), (7, 65540, 16), (4, 65536, 4),
    (4, 64, 8), (3, 3, 1)])
def test_plan_sends_unaligned_rows_to_the_vector_kernel(n, row_bytes,
                                                        base_align):
    plan = kv_ops.gather_plan(n, row_bytes, base_align, H100_SMS)
    assert plan.route == "vector"
    assert plan.smem_bytes == 0


@pytest.mark.parametrize("n", [1, 5, 264, 2 * 264 + 7, 5000])
@pytest.mark.parametrize("row_bytes", [16, 48, 2048, 10240, 65536, 655360])
def test_plan_is_well_formed(n, row_bytes):
    plan = kv_ops.gather_plan(n, row_bytes, 16, H100_SMS)
    assert plan.route == "bulk"
    assert plan.chunk_bytes % 16 == 0
    assert 0 < plan.chunk_bytes <= kv_ops.CHUNK_BYTES
    items = n * -(-row_bytes // plan.chunk_bytes)
    assert 1 <= plan.blocks == min(items, 2 * H100_SMS)
    if plan.chunk_bytes < min(row_bytes, kv_ops.CHUNK_BYTES):
        # cut finer only while the items leave blocks idle
        assert plan.chunk_bytes >= kv_ops.MIN_CHUNK_BYTES
        assert n * -(-row_bytes // (2 * plan.chunk_bytes)) < 2 * H100_SMS


def _model_gather(pool_rows, ids, plan, out_rows):
    """Replay ``gather_bulk_kernel`` over ``plan``: every block walks its
    items k = b + m * blocks through a ring of ``plan.stages`` stages, its
    ids read 32 items a window, one window ahead. Writes into ``out_rows``
    (n, row_bytes) uint8 and returns how often each byte was written."""
    n, row = out_rows.shape
    chunk, S, blocks = plan.chunk_bytes, plan.stages, plan.blocks
    cpr = -(-row // chunk)
    n_items = n * cpr
    writes = np.zeros(out_rows.shape, np.int64)
    for b in range(blocks):
        if b >= n_items:
            continue
        my = (n_items - 1 - b) // blocks + 1

        def id_of(m, b=b, my=my):
            return int(ids[(b + m * blocks) // cpr]) if m < my else -1
        win = {"w": 0, "cur": [id_of(l) for l in range(32)],
               "nxt": [id_of(32 + l) for l in range(32)]}
        ring = [None] * S         # stage -> (item, bytes) loaded, or None
        pending = []              # stages whose store has not read them

        def load(m, s, b=b, win=win, ring=ring):
            if m >> 5 != win["w"]:
                assert m >> 5 == win["w"] + 1
                win["cur"], win["w"] = win["nxt"], win["w"] + 1
                win["nxt"] = [id_of(((win["w"] + 1) << 5) + l)
                              for l in range(32)]
            pid = win["cur"][m & 31]
            assert pid == id_of(m)
            assert ring[s] is None, "load into a stage still being read"
            if not 0 <= pid < len(pool_rows):
                ring[s] = (m, None)       # the warp writes the zeros
                return
            off = ((b + m * blocks) % cpr) * chunk
            ring[s] = (m, pool_rows[pid, off:off + min(chunk, row - off)]
                       .copy())

        for m in range(min(S, my)):
            load(m, m)
        s = prev = 0
        for j in range(my):
            m_loaded, data = ring[s]
            assert m_loaded == j
            k = b + j * blocks
            i, off = divmod(k, cpr)
            off *= chunk
            if data is None:              # an id outside the pool
                data = np.zeros(min(chunk, row - off), np.uint8)
            out_rows[i, off:off + len(data)] = data
            writes[i, off:off + len(data)] += 1
            pending.append(s)         # the item's bulk group, maybe empty
            m = j - 1 + S
            if j >= 1 and m < my:
                while len(pending) > 1:          # wait_group.read 1
                    ring[pending.pop(0)] = None
                load(m, prev)
            prev = s
            s = (s + 1) % S
    return writes


def _bytes(t):
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], -1).numpy()


MODEL_CASES = {
    # (P, page shape, dtype, n, sm_count): the ring wraps, the id windows
    # advance more than once, a few rows on a wide grid, shift-like rows cut
    # finer, a row of one 16-byte vector
    "kv_pages": (48, (2, 4, 16, 32), "bfloat16", 37, 1),
    "many_items": (300, (4,), "float32", 290, 1),
    "few_rows": (8, (2, 2560), "bfloat16", 3, 132),
    "wkv_like": (6, (4, 32, 64), "float32", 4, 3),
    "int8_ragged_chunk": (9, (3, 16, 16, 31), "int8", 7, 2),
}


def _pool(rng, P, page, dtype):
    if dtype == "int8":
        a = rng.integers(-100, 100, (P,) + page)
        return jnp.asarray(a, jnp.int8), torch.from_numpy(a.astype(np.int8))
    a = rng.standard_normal((P,) + page).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_of_bulk_kernel_matches_reference(case):
    P, page, dtype, n, sms = MODEL_CASES[case]
    rng = np.random.default_rng(len(case))
    jp, tp = _pool(rng, P, page, dtype)
    ids = rng.integers(0, P, n).astype(np.int32)     # duplicates allowed
    ids[0] = ids[-1]
    want = kv_ref.gather_pages_ref(tp, torch.from_numpy(ids))
    row_bytes = _bytes(tp).shape[1]
    plan = kv_ops.gather_plan(n, row_bytes, 16, sms)
    assert plan.route == "bulk"
    out = np.zeros((n, row_bytes), np.uint8)
    writes = _model_gather(_bytes(tp), ids, plan, out)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, _bytes(want))
    # the reference's Pallas gather folds a page to (page, d)
    jp3 = jp.reshape(P, page[0], -1)
    ref = j_gather(jp3, jnp.asarray(ids), interpret=True)
    ref = np.array(ref.reshape((n,) + page).astype(jnp.float32))
    np.testing.assert_array_equal(
        out, _bytes(torch.from_numpy(ref).to(want.dtype)))


def test_model_skips_ids_outside_the_pool():
    """An id outside [0, P) gets a zero staging row, written once like
    every other row; its stage still turns over, so the rows after it are
    gathered as usual, and the rows equal the plain version's."""
    rng = np.random.default_rng(5)
    _, tp = _pool(rng, 12, (8, 16), "float32")
    ids = np.array([3, -1, 11, 12, 3, 0, 99, 7, 5], np.int32)
    rows = _bytes(tp)
    plan = kv_ops.gather_plan(len(ids), rows.shape[1], 16, 1)
    out = np.full((len(ids), rows.shape[1]), 0xAB, np.uint8)
    writes = _model_gather(rows, ids, plan, out)
    bad = (ids < 0) | (ids >= len(rows))
    assert (writes == 1).all()
    assert (out[bad] == 0).all()
    np.testing.assert_array_equal(out[~bad], rows[ids[~bad]])
    np.testing.assert_array_equal(
        out, _bytes(kv_ref.gather_pages_ref(tp, torch.from_numpy(ids))))


# ids outside a 4-page pool: -P-1, -2, -1, P, P+1, 2^30
OUT_OF_POOL = (-5, -2, -1, 4, 5, 1 << 30)
# the page the reference's Pallas kernels (interpret mode) read or write
# for each: a negative id wraps once, then the index is clamped into the
# pool. The port's contract differs on purpose: a zero row, no write.
REFERENCE_PAGE = (0, 2, 3, 3, 3, 3)


@pytest.mark.parametrize("pid,ref_page", list(zip(OUT_OF_POOL,
                                                  REFERENCE_PAGE)))
def test_out_of_pool_ids_port_contract_beside_the_reference(pid, ref_page):
    from repro.kernels.kv_gather.kernel import scatter_pages as j_scatter
    P = 4
    a = np.arange(P * 2 * 8, dtype=np.float32).reshape(P, 2, 8) + 1
    new = -np.ones((2, 2, 8), np.float32)
    ids = np.array([1, pid], np.int32)
    # the reference: pages clamped into the pool
    ref = np.asarray(j_gather(jnp.asarray(a), jnp.asarray(ids),
                              interpret=True))
    np.testing.assert_array_equal(ref[1], a[ref_page])
    ref_pool = np.asarray(j_scatter(jnp.asarray(a), jnp.asarray(new),
                                    jnp.asarray(ids), interpret=True))
    changed = [p for p in range(P) if (ref_pool[p] != a[p]).any()]
    assert changed == sorted({1, ref_page})
    # the port's plain versions (the CPU path of ops.py): a zero row, and
    # no write for the out-of-pool id
    for fn in (kv_ref.gather_pages_ref, kv_ops.gather_pages):
        got = fn(torch.from_numpy(a), torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(got[0], a[1])
        assert (got[1] == 0).all()
    for fn in (kv_ref.scatter_pages_ref, kv_ops.scatter_pages):
        pool = fn(torch.from_numpy(a.copy()), torch.from_numpy(new),
                  torch.from_numpy(ids)).numpy()
        want = a.copy()
        want[1] = -1
        np.testing.assert_array_equal(pool, want)
