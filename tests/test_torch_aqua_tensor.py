"""The port's AquaTensor against the JAX reference's: the same operation
sequence (allocate, write, offload to REMOTE and to HOST, ensure_local,
read, retain/free, free_to_cache/revive/drop_cached, a coalesced multi-leg
transaction, a rolled-back migration on an exhausted tier, a donor
eviction) must leave identical page tables, free lists, refcounts and fills,
identical TransferMeter bytes and message counts, and bit-equal payloads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aqua_tensor as J
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro_torch.core import aqua_tensor as T
from repro_torch.core.perfmodel import A100_NVLINK as T_A100

PAGE = (2, 2, 4, 8)


def _pair(dtype_name):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    kw = dict(n_logical=24, page_shape=PAGE, local_slots=8, host_slots=5)
    j = J.AquaTensor(dtype=jd, meter=J.TransferMeter(hw=J_A100), **kw)
    t = T.AquaTensor(dtype=td, meter=T.TransferMeter(hw=T_A100),
                     device="cpu", **kw)
    return j, t


def _same_state(j, t):
    np.testing.assert_array_equal(t.page_table, j.page_table)
    np.testing.assert_array_equal(t.page_refs, j.page_refs)
    np.testing.assert_array_equal(t.page_fill, j.page_fill)
    assert t._free_local == j._free_local
    assert t._free_host == j._free_host
    assert t._remote_free == j._remote_free
    assert t.remote_capacity == j.remote_capacity
    for key in ("bytes_fabric", "bytes_host", "messages_fabric",
                "messages_host", "sim_time"):
        assert getattr(t.meter, key) == getattr(j.meter, key), key
    assert t.tier_counts() == {k: v for k, v in j.tier_counts().items()}


def _same_payload(j, t, lps):
    a = np.asarray(jnp.asarray(j.read(lps), jnp.float32))
    b = t.read(lps).float().numpy()
    np.testing.assert_array_equal(b, a)


def _both(j, t, op, *args, **kw):
    getattr(j, op)(*args, **kw)
    getattr(t, op)(*args, **kw)
    _same_state(j, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aqua_tensor_matches_reference(dtype):
    j, t = _pair(dtype)
    rng = np.random.default_rng(0)
    _both(j, t, "add_remote_lease", "d0", 4)
    _both(j, t, "add_remote_lease", "d1", 2)
    lps = j.allocate(7)
    np.testing.assert_array_equal(t.allocate(7), lps)
    _same_state(j, t)
    data = rng.standard_normal((7,) + PAGE).astype(np.float32)
    j.write(lps, jnp.asarray(data))
    t.write(lps, torch.from_numpy(data))
    _same_state(j, t)
    _same_payload(j, t, lps)

    # partial tail fills, then a REMOTE park spilling across both donors
    _both(j, t, "set_page_fill", lps[:5], [1.0, 1.0, 0.5, 0.25, 0.0])
    _both(j, t, "offload", lps[:5], prefer=J.REMOTE)
    _both(j, t, "offload", lps[5:7], prefer=J.HOST)
    _same_payload(j, t, lps)

    # one coalesced page-in across tiers, then a metered read
    with j.meter.coalesce(), t.meter.coalesce():
        j.ensure_local(lps[[0, 5, 3]])
        t.ensure_local(lps[[0, 5, 3]])
    _same_state(j, t)
    a = np.asarray(jnp.asarray(j.read(lps, meter=True), jnp.float32))
    np.testing.assert_array_equal(t.read(lps, meter=True).float().numpy(), a)
    _same_state(j, t)

    # writes to non-local pages are metered legs
    new = rng.standard_normal((3,) + PAGE).astype(np.float32)
    j.write(lps[[1, 6, 2]], jnp.asarray(new))
    t.write(lps[[1, 6, 2]], torch.from_numpy(new))
    _same_state(j, t)
    _same_payload(j, t, lps)

    # refcounts and the CACHED state
    _both(j, t, "retain", lps[:2])
    freed_j, freed_t = j.free(lps[:3]), t.free(lps[:3])
    assert freed_t == freed_j
    _same_state(j, t)
    assert t.free_to_cache(lps[3:5]) == j.free_to_cache(lps[3:5])
    _same_state(j, t)
    _both(j, t, "revive", lps[3:4])
    assert t.drop_cached(lps[4:5]) == j.drop_cached(lps[4:5])
    _same_state(j, t)

    # donor reclaim: evacuate to host
    assert t.evict_remote("d0") == j.evict_remote("d0")
    _same_state(j, t)
    live = [int(lp) for lp in lps if j.page_table[lp, 0] != -1]
    _same_payload(j, t, live)


def test_move_rolls_back_on_exhausted_tier():
    j, t = _pair("float32")
    lps = j.allocate(7)
    t.allocate(7)
    data = np.arange(7 * np.prod(PAGE), dtype=np.float32).reshape((7,) + PAGE)
    j.write(lps, jnp.asarray(data))
    t.write(lps, torch.from_numpy(data))
    _both(j, t, "offload", lps[:3], prefer=J.HOST)
    # 4 more pages do not fit the 2 host slots left (no remote lease)
    with pytest.raises(MemoryError):
        j.offload(lps[3:], prefer=J.HOST)
    with pytest.raises(MemoryError):
        t.offload(lps[3:], prefer=J.HOST)
    _same_state(j, t)
    assert (t.page_table[lps[3:], 0] == T.LOCAL).all()
    _same_payload(j, t, lps)
    with pytest.raises(MemoryError):
        t.allocate(30)
    _same_state(j, t)
