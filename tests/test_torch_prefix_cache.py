"""The port's global radix prefix cache, on the CPU: tree-indexed pages
outlive refcount 0 (CACHED) and revive on re-adoption, a cache hit's
prefill and decode are bit-identical to a cold prefill on a sharing-off
runtime, the radix tree splits on mid-prompt divergence, the index seed
partitions the cache, a revived sole referencer still copies on write,
eviction yields cached pages (LRU, cold-first demotion) before any
allocation fails, donor loss drops cached pages, the auditor flags
corrupted cache state, and the prefix-aware CFS co-schedules sharers.

These are the cases of the reference's ``test_prefix_cache.py`` that need
neither admission nor other families, held as the port against itself
(a cache hit against a cold prefill on the same code path), with the
port's own seeded weights: the reference's end-to-end bit-identity is
not an oracle here. Two cases are the port's own: the engine's prefix and
sizing knobs reaching its runtime, and a live victim's LOST pages freed
(not cached) on release.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.aqua_tensor import HOST, LOCAL, REMOTE
from repro_torch.core.faults import InvariantAuditor
from repro_torch.models import api, lm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PagedStateRuntime
from repro_torch.serving.scheduler import CFSScheduler, ReqState, \
    bucket_tokens

ARCH = "qwen1.5-0.5b"
PAD = 11


def _prefill(kv, cfg, model, rid, prompt, chunks, start=0):
    """Chunked prefill straight on the runtime, registering completed
    prefix pages as the engine does. Returns the last chunk's logits."""
    pos = start
    for c in chunks:
        kv.ensure_capacity(rid, pos + c)
        kv.make_writable(rid, pos, pos + c)
        bt = kv.block_tables_prefill(rid, pad_to=PAD)
        toks = np.zeros((1, bucket_tokens(c)), np.int32)
        toks[0, :c] = prompt[pos:pos + c]
        lg, kv.pools = api.prefill_chunk_paged(model, cfg, toks, kv.pools,
                                               bt, pos, c - 1,
                                               read_pps=kv.pps)
        pos += c
        kv.register_prefix(rid, pos)
    return lg.numpy()


def _decode(kv, cfg, model, rid, ctx0, first_tok, steps):
    out, logs = first_tok, []
    for t in range(steps):
        ctx = ctx0 + t + 1
        kv.ensure_capacity(rid, ctx)
        kv.make_writable(rid, ctx - 1, ctx)
        lg, kv.pools = api.decode_step_paged(
            model, cfg, kv.pools, kv.block_tables([rid, None]),
            np.asarray([out, 0], np.int32),
            np.asarray([ctx - 1, 0], np.int32))
        logs.append(lg[0].numpy())
        out = int(np.argmax(logs[-1]))
    return logs


@pytest.fixture(scope="module")
def qwen():
    cfg = smoke_config(get_config(ARCH))
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _runtime(cfg, **kw):
    args = dict(max_seq=64, page_tokens=8, max_running=2, device="cpu")
    args.update(kw)
    return PagedStateRuntime(cfg, **args)


def _prompt(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return list(map(int, rng.integers(0, cfg.vocab_size, n)))


# ---------------------------------------------------------------------------
# retention past refcount 0, revival on re-adoption
# ---------------------------------------------------------------------------
def test_pages_outlive_refcount_zero_and_revive(qwen):
    cfg, model = qwen
    prompt = _prompt(cfg, 10, 16)
    kv = _runtime(cfg)
    assert kv.sharing and kv.caching
    kv.adopt_prefix(0, prompt)
    _prefill(kv, cfg, model, 0, prompt, [8, 8])
    plane = kv.planes["kv"]
    cached_lps = [row[0] for row in plane.pages[0]]
    kv.release(0)
    assert (plane.aqua.refcounts(cached_lps) == 0).all()
    assert (plane.aqua.page_table[cached_lps, 0] != -1).all()
    assert kv.cached_pages()["kv"] == 2 * plane.n_layers
    assert InvariantAuditor().check(kv) == []
    assert kv.adopt_prefix(1, prompt) == 16
    assert (plane.aqua.refcounts(cached_lps) == 1).all()
    c = kv.stats()["cache"]
    assert c["hits"] == 1 and c["hit_tokens"] == 16
    assert kv.cached_pages()["kv"] == 0
    kv.release(1)
    assert kv.cached_pages()["kv"] == 2 * plane.n_layers


def test_cache_hit_decode_bit_identical_to_cold_prefill(qwen):
    """Serving a prompt off revived cached pages gives logits bit-identical
    to a cold prefill on a sharing-off runtime, prefill and 3 decode
    steps."""
    cfg, model = qwen
    prefix = _prompt(cfg, 12, 16)
    prompt = prefix + _prompt(cfg, 13, 5)
    kv0 = _runtime(cfg, prefix_sharing=False)
    lg0 = _prefill(kv0, cfg, model, 0, prompt, [8, 8, 5])
    dec0 = _decode(kv0, cfg, model, 0, len(prompt), int(np.argmax(lg0[0])), 3)
    kv = _runtime(cfg)
    kv.adopt_prefix(0, prefix)
    _prefill(kv, cfg, model, 0, prefix, [8, 8])
    kv.release(0)
    assert kv.cached_pages()["kv"] > 0
    assert kv.adopt_prefix(1, prompt) == 16
    assert kv.stats()["cache"]["hits"] == 1
    lg1 = _prefill(kv, cfg, model, 1, prompt, [5], start=16)
    dec1 = _decode(kv, cfg, model, 1, len(prompt), int(np.argmax(lg1[0])), 3)
    np.testing.assert_array_equal(lg0, lg1)
    for a, b in zip(dec0, dec1):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# radix-tree structure and the index seed
# ---------------------------------------------------------------------------
def test_mid_prompt_divergence_splits_the_edge(qwen):
    cfg, model = qwen
    a = _prompt(cfg, 13, 24)
    b = a[:16] + [int(t) + 1 for t in a[16:]]    # diverges in block 3
    kv = _runtime(cfg)
    kv.adopt_prefix(0, a)
    _prefill(kv, cfg, model, 0, a, [24])         # one 3-block edge
    root = kv._roots[None]
    assert len(root.children) == 1
    assert len(root.children[tuple(a[:8])].blocks) == 3
    assert kv.adopt_prefix(1, b) == 16
    _prefill(kv, cfg, model, 1, b, [8], start=16)
    node = root.children[tuple(a[:8])]
    assert len(node.blocks) == 2
    assert set(node.children) == {tuple(a[16:24]), tuple(b[16:24])}
    assert all(c.parent is node for c in node.children.values())
    assert InvariantAuditor().check(kv) == []
    kv.release(0)
    kv.release(1)
    assert kv.adopt_prefix(2, a) == 24
    assert kv.adopt_prefix(3, b) == 24
    assert kv.stats()["cache"]["hits"] >= 2


def test_index_seed_partitions_the_cache(qwen):
    cfg, model = qwen
    prompt = _prompt(cfg, 14, 16)
    kv = _runtime(cfg)
    kv.adopt_prefix(0, prompt, seed=7)
    _prefill(kv, cfg, model, 0, prompt, [8, 8])
    kv.release(0)
    assert kv.cached_pages()["kv"] > 0
    assert kv.adopt_prefix(1, prompt, seed=8) == 0
    assert kv.adopt_prefix(2, prompt, seed=7) == 16
    assert kv.stats()["cache"]["hits"] == 1


def test_cache_revived_sole_referencer_still_copies_on_write(qwen):
    cfg, model = qwen
    prompt = _prompt(cfg, 15, 16)
    kv = _runtime(cfg)
    kv.adopt_prefix(0, prompt)
    lga = _prefill(kv, cfg, model, 0, prompt, [8, 8])
    kv.release(0)
    assert kv.adopt_prefix(1, prompt) == 16      # full match, refs 0 -> 1
    n_layers = kv.planes["kv"].n_layers
    lgb = _prefill(kv, cfg, model, 1, prompt, [1], start=15)
    assert kv.cow_copies == n_layers             # cloned despite refs == 1
    np.testing.assert_array_equal(lga, lgb)
    kv.release(1)
    assert kv.adopt_prefix(2, prompt) == 16
    lgc = _prefill(kv, cfg, model, 2, prompt, [1], start=15)
    np.testing.assert_array_equal(lga, lgc)


# ---------------------------------------------------------------------------
# eviction: the cache yields, LRU order, cold-first demotion
# ---------------------------------------------------------------------------
def test_eviction_yields_cache_before_memory_error(qwen):
    cfg, model = qwen
    prompt = _prompt(cfg, 16, 16)
    kv = _runtime(cfg, host_pages=0)
    kv.adopt_prefix(0, prompt)
    _prefill(kv, cfg, model, 0, prompt, [8, 8])
    kv.release(0)
    plane = kv.planes["kv"]
    assert kv.cached_pages()["kv"] == 2 * plane.n_layers
    filler = plane.aqua.allocate(plane.aqua.local_free, prefer=LOCAL)
    assert plane.aqua.local_free == 0
    extra = plane.aqua.allocate(1, prefer=LOCAL)
    assert kv.stats()["cache"]["evictions"] >= 1
    plane.aqua.free(list(extra) + list(filler))
    assert InvariantAuditor().check(kv) == []
    assert kv.adopt_prefix(1, prompt) < 16       # no stale adoption


def test_lru_evicts_the_coldest_family_first(qwen):
    cfg, model = qwen
    cold, warm = _prompt(cfg, 17, 8), _prompt(cfg, 170, 8)
    kv = _runtime(cfg, host_pages=0)
    kv.adopt_prefix(0, cold)
    _prefill(kv, cfg, model, 0, cold, [8])
    kv.release(0)
    kv.adopt_prefix(1, warm)
    _prefill(kv, cfg, model, 1, warm, [8])
    kv.release(1)
    assert kv.adopt_prefix(2, warm) == 8         # bump warm's LRU stamp
    kv.release(2)
    plane = kv.planes["kv"]
    filler = plane.aqua.allocate(plane.aqua.local_free, prefer=LOCAL)
    plane.aqua.free(list(plane.aqua.allocate(1, prefer=LOCAL)))
    plane.aqua.free(filler)
    assert kv.adopt_prefix(3, cold) == 0, "coldest must evict first"
    assert kv.adopt_prefix(4, warm) == 8, "warm family must survive"


def test_cold_first_demotion_keeps_the_block_adoptable(qwen):
    cfg, model = qwen
    prompt = _prompt(cfg, 18, 16)
    kv = _runtime(cfg, host_pages=64)
    kv.adopt_prefix(0, prompt)
    _prefill(kv, cfg, model, 0, prompt, [8, 8])
    plane = kv.planes["kv"]
    cached_lps = [lp for row in plane.pages[0] for lp in row]
    payload = plane.aqua.read(cached_lps).clone()
    kv.release(0)
    filler = plane.aqua.allocate(plane.aqua.local_free, prefer=LOCAL)
    extra = plane.aqua.allocate(1, prefer=LOCAL)
    c = kv.stats()["cache"]
    assert c["demotions"] >= 1 and c["evictions"] == 0
    assert (plane.aqua.page_table[cached_lps, 0] == HOST).any()
    plane.aqua.free(list(extra) + list(filler))
    assert InvariantAuditor().check(kv) == []
    assert kv.adopt_prefix(1, prompt) == 16
    kv.ensure_capacity(1, 16)                    # activates: pages LOCAL
    assert (plane.aqua.page_table[cached_lps, 0] == LOCAL).all()
    assert torch.equal(plane.aqua.read(cached_lps), payload)


def test_capacity_with_cache_on_still_runs_two_sharers(qwen):
    """A LOCAL budget sized for one unshared request still runs two
    sharers at once with the cache on: cached pages never shrink what the
    scheduler can admit."""
    cfg, model = qwen
    prefix = _prompt(cfg, 19, 16)
    kv = _runtime(cfg, local_pages=27)
    assert kv.caching
    eng = ServingEngine(cfg, model, max_running=2, max_seq=64,
                        scheduler="cfs", slice_tokens=3, offload_tier=HOST,
                        kv=kv, device="cpu")
    lead = eng.submit(prefix + [1, 2, 3], 6)
    while not lead.prefilled:
        eng.step()
    eng.submit(prefix + [4, 5, 6], 6)
    peak = 0
    while eng.waiting or eng.running:
        eng.step()
        peak = max(peak, sum(r.slot is not None for r in eng.running))
    assert peak == 2


# ---------------------------------------------------------------------------
# donor loss drops cached pages; the auditor flags cache corruption
# ---------------------------------------------------------------------------
def test_donor_loss_drops_cached_pages_and_prunes_the_tree(qwen):
    cfg, model = qwen
    prompt = _prompt(cfg, 20, 16)
    kv = _runtime(cfg)
    plane = kv.planes["kv"]
    kv.add_remote_lease("d0", 64 * plane.aqua.page_bytes)
    kv.adopt_prefix(0, prompt)
    _prefill(kv, cfg, model, 0, prompt, [8, 8])
    kv.park(0, 16, prefer=REMOTE)
    kv.release(0)                                # CACHED on REMOTE
    assert kv.cached_pages()["kv"] == 2 * plane.n_layers
    assert (plane.aqua.page_table[:, 0] == REMOTE).any()
    assert kv.fail_donor("d0") == []             # no live request touched
    assert kv.cached_pages()["kv"] == 0
    assert kv.physical_pages()["kv"] == 1        # scratch only: no leak
    assert kv.adopt_prefix(1, prompt) == 0       # dead prefix unadoptable
    assert InvariantAuditor().check(kv) == []


def test_donor_loss_of_a_live_sharer_frees_lost_pages_on_release(qwen):
    """A live request whose parked pages died is named a victim; releasing
    it frees the LOST pages instead of caching them, and prunes the
    coverage they backed."""
    cfg, model = qwen
    prompt = _prompt(cfg, 21, 16)
    kv = _runtime(cfg)
    plane = kv.planes["kv"]
    kv.add_remote_lease("d0", 64 * plane.aqua.page_bytes)
    kv.adopt_prefix(0, prompt)
    _prefill(kv, cfg, model, 0, prompt, [8, 8])
    kv.park(0, 16, prefer=REMOTE)
    assert kv.fail_donor("d0") == [0]
    assert kv.stats()["tiers"]["lost"] == 2 * plane.n_layers
    kv.release(0)
    assert "lost" not in kv.stats()["tiers"]
    assert kv.cached_pages()["kv"] == 0 and not kv._lp_node
    assert InvariantAuditor().check(kv) == []


def test_auditor_flags_cache_state_corruption(qwen):
    cfg, model = qwen
    prompt = _prompt(cfg, 21, 16)
    kv = _runtime(cfg)
    kv.adopt_prefix(0, prompt)
    _prefill(kv, cfg, model, 0, prompt, [8, 8])
    kv.release(0)
    auditor = InvariantAuditor()
    assert auditor.check(kv) == []
    plane = kv.planes["kv"]
    lp = next(i for i in range(len(plane.aqua.page_refs))
              if plane.aqua.page_refs[i] == 0
              and plane.aqua.page_table[i, 0] != -1
              and i != plane.scratch_lp)
    plane.pin[lp] = 1                            # a cached page pinned
    assert any("pinned" in v for v in auditor.check(kv))
    plane.pin.pop(lp)
    entry = kv._lp_node.pop(("kv", lp))          # cached but unindexed
    assert auditor.check(kv)
    kv._lp_node[("kv", lp)] = entry
    assert auditor.check(kv) == []
    kv2 = _runtime(cfg, prefix_cache=False)
    kv2.ensure_capacity(0, 8)
    p2 = kv2.planes["kv"]
    lp2 = int(p2.pages[0][0][0])
    kv2.release(0)
    p2.aqua.page_refs[lp2] = 0
    p2.aqua.page_table[lp2, 0] = 0               # a forged refs-0 page
    assert any("caching is off" in v for v in auditor.check(kv2))


# ---------------------------------------------------------------------------
# prefix-aware scheduling
# ---------------------------------------------------------------------------
def test_cfs_clusters_same_prefix_group_within_vruntime_class():
    groups = {0: "g", 1: None, 2: "g", 3: "h"}
    sched = CFSScheduler(4, 3, prefix_group=lambda r: groups.get(r.rid))
    reqs = [ReqState(i, float(i), [1] * 4, 4) for i in range(4)]
    assert [r.rid for r in sched.plan(0, reqs, []).run] == [0, 2, 1, 3]
    reqs[0].generated = [9, 9]
    assert [r.rid for r in sched.plan(1, reqs, []).run] == [1, 2, 3, 0]


def test_engine_coschedules_sharers_parking_the_prefix_once(qwen):
    cfg, model = qwen
    prefix = _prompt(cfg, 22, 16)
    eng = ServingEngine(cfg, model, max_running=2, max_seq=64,
                        scheduler="cfs", slice_tokens=3, offload_tier=HOST,
                        device="cpu")
    assert eng.sched.prefix_group is not None
    lead = eng.submit(prefix + [1, 2], 5)
    while not lead.prefilled:
        eng.step()
    a = eng.submit(prefix + [3, 4], 5)
    b = eng.submit(prefix + [5, 6], 5)
    assert eng.kv.prefix_group_of(a.rid) is eng.kv.prefix_group_of(b.rid)
    eng.run(500)
    assert all(r.done for r in eng.finished) and len(eng.finished) == 3


def test_engine_prefix_knobs_reach_the_runtime(qwen):
    """``prefix_sharing``/``prefix_cache`` and the ``kv_*`` sizing knobs
    build the engine's own runtime as the reference's do."""
    cfg, model = qwen
    kw = dict(max_running=2, max_seq=64, device="cpu")
    on = ServingEngine(cfg, model, **kw)
    assert on.kv.sharing and on.kv.caching and on.prefetch
    no_cache = ServingEngine(cfg, model, prefix_cache=False, **kw)
    assert no_cache.kv.sharing and not no_cache.kv.caching
    off = ServingEngine(cfg, model, prefix_sharing=False, prefetch=False,
                        kv_local_pages=33, kv_host_pages=17, **kw)
    assert not off.kv.sharing and not off.kv.caching and not off.prefetch
    aq = off.kv.planes["kv"].aqua
    assert aq.local_pool.shape[0] == 33 and aq.host_pool.shape[0] == 17


# ---------------------------------------------------------------------------
# the quickstart-shaped smoke: followers hit the cache
# ---------------------------------------------------------------------------
def test_cache_smoke_quickstart_workload(qwen):
    cfg, model = qwen
    eng = ServingEngine(cfg, model, max_running=2, max_seq=96,
                        scheduler="cfs", slice_tokens=3,
                        offload_tier=REMOTE, device="cpu")
    eng.pager.add_remote_lease("donor-gpu", 1 << 22)
    rng = np.random.default_rng(1)
    system = list(map(int, rng.integers(0, cfg.vocab_size, 16)))
    eng.submit(system + [1, 2], 6)
    eng.run(500)
    assert not eng.running and not eng.waiting
    assert eng.kv.cached_pages()["kv"] > 0
    followers = [eng.submit(system + list(map(
        int, rng.integers(0, cfg.vocab_size, 4))), 6) for _ in range(3)]
    assert all(f.shared_tokens == 16 for f in followers)
    m = eng.run(500)
    c = eng.kv.stats()["cache"]
    assert c["hits"] >= 1 and c["hit_tokens"] >= 16
    assert all(len(f.generated) == 6 for f in followers)
    assert m.sim_time > 0
