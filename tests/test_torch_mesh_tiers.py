"""The port's mesh-real memory tiers (``repro_torch/distributed/
mesh_tiers.py``): a twin of each test of ``tests/test_mesh_tiers.py`` over a
four-entry CPU domain (the counterpart of the reference's four forced host
devices), and one parity test that drives the same offloads, restores, a
donor reclaim and a re-lease through both packages and holds the port's leg
count, sample bytes, page table and meter to the reference's exactly.

On the CPU every entry is the same device, so a "peer" slab shares the
serving memory and a leg is a same-memory copy; what is held here is the
bookkeeping and the bytes (one leg a move, bit-exact round trips), not the
fabric. The card's twins are in ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aqua_tensor import AquaTensor as JAquaTensor
from repro.core.aqua_tensor import TransferMeter as JTransferMeter
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.distributed.mesh_tiers import MeshTierDomain as JDomain
from repro.models.lm import PAGED_FAMILY_ARCHS
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.aqua_tensor import (HOST, LOCAL, REMOTE, AquaTensor,
                                          TransferMeter)
from repro_torch.core.errors import LeaseRevokedError
from repro_torch.core.faults import FaultInjector, InvariantAuditor
from repro_torch.core.perfmodel import A100_NVLINK, TPU_V5E, fit_link_model
from repro_torch.distributed.mesh_tiers import MeshTierDomain
from repro_torch.models import api, lm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PagedStateRuntime
from repro_torch.serving.scheduler import bucket_tokens

CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dom():
    return MeshTierDomain(devices=CPU4)


def _tensor(dom, *, slots=8, page=(4, 6)):
    a = AquaTensor(n_logical=32, page_shape=page, local_slots=slots,
                   host_slots=slots, dtype=torch.float32,
                   meter=TransferMeter(), device="cpu", mesh=dom)
    a.add_remote_lease("d0", slots)
    return a


def _payload(n, page, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n,) + page).astype(np.float32))


# ---------------------------------------------------------------------------
# the lease is a slab of its own on the donor's entry; round trips are exact
# ---------------------------------------------------------------------------
def test_donor_pool_resident_on_peer_device():
    dom = _dom()
    a = _tensor(dom)
    pool = a.remote_pools["d0"]
    dst = dom.donor_device("d0")
    assert dst != 0                       # entry 0 serves, never donates
    assert pool.device == dom.devices[dst]
    assert tuple(pool.shape) == (8 + 1,) + a.page_shape   # + scratch row
    assert pool.data_ptr() != a.local_pool.data_ptr()


def test_offload_restore_round_trip_bit_exact():
    a = _tensor(_dom())
    lps = a.allocate(5)
    payload = _payload(5, a.page_shape)
    a.write_local(lps, payload)
    a.offload(lps, prefer=REMOTE)
    assert (a.page_table[lps, 0] == REMOTE).all()
    assert torch.equal(a.read(lps), payload)
    a.ensure_local(lps)
    assert (a.page_table[lps, 0] == LOCAL).all()
    assert torch.equal(a.read(lps), payload)


def test_one_collective_per_tier_donor_leg():
    """Each leg of a tier flip is ONE message on the wire: the domain's leg
    counter and the meter's priced messages move in lockstep, one a leg
    however many pages move."""
    dom = _dom()
    a = _tensor(dom)
    lps = a.allocate(6)
    a.write_local(lps, torch.ones((6,) + a.page_shape))
    c0, m0 = dom.collectives, a.meter.messages_fabric
    a.offload(lps, prefer=REMOTE)
    assert dom.collectives - c0 == 1
    assert a.meter.messages_fabric - m0 == 1
    c0, m0 = dom.collectives, a.meter.messages_fabric
    a.ensure_local(lps)
    assert dom.collectives - c0 == 1
    assert a.meter.messages_fabric - m0 == 1


def test_two_donors_one_collective_each():
    dom = _dom()
    a = AquaTensor(n_logical=32, page_shape=(4, 6), local_slots=8,
                   host_slots=8, dtype=torch.float32, meter=TransferMeter(),
                   device="cpu", mesh=dom)
    a.add_remote_lease("d0", 4)
    a.add_remote_lease("d1", 4)
    assert dom.donor_device("d0") != dom.donor_device("d1")
    lps = a.allocate(6)
    a.write_local(lps, torch.full((6,) + a.page_shape, 2.0))
    c0 = dom.collectives
    a.offload(lps, prefer=REMOTE)
    assert set(a.page_table[lps, 2].tolist()) == {0, 1}
    assert dom.collectives - c0 == 2      # one push per donor leg
    c0 = dom.collectives
    a.ensure_local(lps)
    assert dom.collectives - c0 == 2      # one pull per donor leg
    assert torch.equal(a.read(lps), torch.full((6,) + a.page_shape, 2.0))


# ---------------------------------------------------------------------------
# mesh vs single-device: bit-identical logits + pool contents per family
# ---------------------------------------------------------------------------
def _roundtrip_logits(cfg, model, prompt, chunks, mesh, decode_steps=2):
    """Chunked prefill + decode, parking REMOTE at every boundary; returns
    the logits arrays and the request's final owned-page payloads."""
    kv = PagedStateRuntime(cfg, max_seq=64, page_tokens=8, max_running=2,
                           device="cpu", mesh=mesh)
    kv.add_remote_lease("d0", 1 << 24)
    logs, pos = [], 0
    for c in chunks:
        kv.ensure_capacity(0, pos + c)
        toks = np.zeros((1, bucket_tokens(c)), np.int32)
        toks[0, :c] = prompt[pos:pos + c]
        lg, kv.pools = api.prefill_chunk_paged(
            model, cfg, toks, kv.pools,
            kv.block_tables_prefill(0, pad_to=kv.pps + 3), pos, c - 1,
            read_pps=kv.pps)
        pos += c
        kv.park(0, pos, prefer=REMOTE)
        kv.restore(0)
    logs.append(lg.numpy())
    out = int(np.argmax(logs[-1][0]))
    for t in range(decode_steps):
        ctx = len(prompt) + t + 1
        kv.ensure_capacity(0, ctx)
        lg, kv.pools = api.decode_step_paged(
            model, cfg, kv.pools, kv.block_tables([0, None]), [out, 0],
            [ctx - 1, 0])
        logs.append(lg[0].numpy())
        out = int(np.argmax(logs[-1]))
        kv.park(0, ctx, prefer=REMOTE)
        kv.restore(0)
    pages = {name: pl.aqua.read([lp for row in pl.pages[0] for lp in row])
             for name, pl in kv.planes.items()}
    return logs, pages, kv


@pytest.mark.parametrize("arch", PAGED_FAMILY_ARCHS)
def test_mesh_matches_single_device_bit_exact(arch):
    """Every family (attention, MLA, hybrid SSM, RWKV6): a run whose pages
    bounce through a donor slab of the domain at every chunk and decode
    boundary gives bit-identical logits AND page payloads to the slab on
    the serving device."""
    cfg = smoke_config(get_config(arch))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = list(map(int, np.random.default_rng(1).integers(
        0, cfg.vocab_size, 17)))
    base_logs, base_pages, _ = _roundtrip_logits(cfg, model, prompt,
                                                 [7, 10], None)
    dom = _dom()
    mesh_logs, mesh_pages, kv = _roundtrip_logits(cfg, model, prompt,
                                                  [7, 10], dom)
    for a, b in zip(base_logs, mesh_logs):
        np.testing.assert_array_equal(a, b)
    assert set(base_pages) == set(mesh_pages)
    for name in base_pages:
        assert torch.equal(base_pages[name], mesh_pages[name]), name
    # 4 parks and 4 restores, one message a leg across every plane
    assert dom.collectives >= kv.meter.messages_fabric > 0


# ---------------------------------------------------------------------------
# donor reclaim mid-flight
# ---------------------------------------------------------------------------
def test_donor_reclaim_mid_flight_evacuates_to_host_bit_exact():
    """The donor is reclaimed while a request is parked on its slab: pages
    evacuate donor -> serving -> host (one pull a plane), the lease drops,
    and the restored run continues bit-exact."""
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = list(map(int, np.random.default_rng(2).integers(
        0, cfg.vocab_size, 17)))
    base_logs, _, _ = _roundtrip_logits(cfg, model, prompt, [7, 10], None)

    dom = _dom()
    kv = PagedStateRuntime(cfg, max_seq=64, page_tokens=8, max_running=2,
                           device="cpu", mesh=dom)
    kv.add_remote_lease("d0", 1 << 24)
    pos = 0
    for c in (7, 10):
        kv.ensure_capacity(0, pos + c)
        toks = np.zeros((1, bucket_tokens(c)), np.int32)
        toks[0, :c] = prompt[pos:pos + c]
        lg, kv.pools = api.prefill_chunk_paged(
            model, cfg, toks, kv.pools,
            kv.block_tables_prefill(0, pad_to=kv.pps + 3), pos, c - 1,
            read_pps=kv.pps)
        pos += c
    kv.park(0, pos, prefer=REMOTE)
    plane = kv.planes["kv"]
    assert (plane.aqua.page_table[:, 0] == REMOTE).any()
    c0 = dom.collectives
    moved = kv.evict_remote("d0")         # mid-flight reclaim
    assert moved > 0
    assert dom.collectives - c0 >= 1      # the evacuation pull really ran
    assert not plane.aqua.remote_pools    # lease dropped
    assert (plane.aqua.page_table[:, 0] != REMOTE).all()
    kv.restore(0)                         # restore now comes from HOST

    out = int(np.argmax(lg.numpy()[0]))
    logs = [lg.numpy()]
    for t in range(2):
        ctx = len(prompt) + t + 1
        kv.ensure_capacity(0, ctx)
        lg, kv.pools = api.decode_step_paged(
            model, cfg, kv.pools, kv.block_tables([0, None]), [out, 0],
            [ctx - 1, 0])
        logs.append(lg[0].numpy())
        out = int(np.argmax(logs[-1]))
    for a, b in zip(base_logs, logs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# re-lease bookkeeping
# ---------------------------------------------------------------------------
def test_donor_re_lease_reuses_bookkeeping_index():
    """An evicted donor that re-leases reuses its ``_donors`` entry (no
    mesh)."""
    a = AquaTensor(n_logical=16, page_shape=(2, 4), local_slots=8,
                   host_slots=16, dtype=torch.float32, meter=TransferMeter(),
                   device="cpu")
    a.add_remote_lease("d0", 4)
    lps = a.allocate(3)
    payload = torch.arange(3 * 8, dtype=torch.float32).reshape((3, 2, 4))
    a.write_local(lps, payload)
    a.offload(lps, prefer=REMOTE)
    assert a.evict_remote("d0") == 3
    a.add_remote_lease("d0", 4)
    assert a._donors.count("d0") == 1
    a.ensure_local(lps)
    a.offload(lps, prefer=REMOTE)
    assert (a.page_table[lps, 0] == REMOTE).all()
    assert (a.page_table[lps, 2] == a._donors.index("d0")).all()
    assert torch.equal(a.read(lps), payload)
    assert a.evict_remote("d0") == 3
    assert torch.equal(a.read(lps), payload)


def test_re_leased_donor_keeps_its_device():
    dom = _dom()
    a = _tensor(dom, slots=4)
    dev = dom.donor_device("d0")
    lps = a.allocate(2)
    a.write_local(lps, torch.ones((2,) + a.page_shape))
    a.offload(lps, prefer=REMOTE)
    a.evict_remote("d0")
    a.add_remote_lease("d0", 4)
    assert dom.donor_device("d0") == dev


# ---------------------------------------------------------------------------
# clock calibration
# ---------------------------------------------------------------------------
def test_warm_legs_record_fabric_samples():
    dom = _dom()
    a = _tensor(dom)
    lps = a.allocate(4)
    a.write_local(lps, torch.ones((4,) + a.page_shape))
    for _ in range(3):                    # same key: the first is unsampled
        a.offload(lps, prefer=REMOTE)
        a.ensure_local(lps)
    assert len(dom.samples["fabric"]) == 4
    assert all(b == 4 * 24 * 4 and t > 0 for b, t in dom.samples["fabric"])


def test_fit_link_model_recovers_known_link():
    alpha, bw = 5e-6, 100e9
    sizes = [1 << 16, 1 << 18, 1 << 20, 1 << 22]
    samples = [(float(s), alpha + s / bw) for s in sizes]
    link = fit_link_model(samples, "fit")
    assert link is not None
    assert link.latency == pytest.approx(alpha, rel=1e-6)
    assert link.peak_bw == pytest.approx(bw, rel=1e-6)
    assert fit_link_model(samples[:1], "fit") is None
    assert fit_link_model([samples[0]] * 4, "fit") is None


def test_calibrated_profile_replaces_fabric_link():
    dom = _dom()
    dom.samples["fabric"] = [(float(s), 1e-5 + s / 50e9)
                             for s in (1 << 14, 1 << 16, 1 << 18, 1 << 20)]
    hw = dom.calibrated_profile(TPU_V5E)
    assert hw is not TPU_V5E
    assert hw.name.endswith("-calibrated")
    assert hw.fabric.peak_bw == pytest.approx(50e9, rel=1e-3)
    assert _dom().calibrated_profile(TPU_V5E) is TPU_V5E


def test_engine_calibrate_clock_installs_fitted_profile():
    """``calibrate_clock`` installs the fitted profile in the engine AND
    the meter; without samples (or without a mesh) it is a no-op."""
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dom = _dom()
    eng = ServingEngine(cfg, model, max_running=2, max_seq=64, mesh=dom,
                        device="cpu")
    assert eng.kv.mesh is dom
    assert all(p.aqua.mesh is dom for p in eng.kv.planes.values())
    hw0 = eng.hw
    assert eng.calibrate_clock() is False         # no samples yet
    assert eng.hw is hw0
    dom.samples["fabric"] = [(float(s), 2e-5 + s / 25e9)
                             for s in (1 << 14, 1 << 16, 1 << 18, 1 << 20)]
    assert eng.calibrate_clock() is True
    assert eng.hw.name == f"{hw0.name}-calibrated"
    assert eng.pager.meter.hw is eng.hw
    assert eng.hw.fabric.peak_bw == pytest.approx(25e9, rel=1e-3)
    assert eng.hw.fabric.latency == pytest.approx(2e-5, rel=1e-3)
    assert eng.calibrate_clock() is True          # refit stays installable
    plain = ServingEngine(cfg, model, max_running=2, max_seq=64,
                          device="cpu")
    assert plain.calibrate_clock() is False


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------
def test_single_device_domain_rejected():
    with pytest.raises(ValueError, match="2 devices"):
        MeshTierDomain(devices=["cpu"])


def test_default_domain_needs_two_cuda_devices():
    """The default device list is every CUDA device: without two, the
    domain raises instead of dropping to a slab on the serving device."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices present: the default domain builds")
    assert MeshTierDomain.available() is False
    with pytest.raises(ValueError, match="2 devices"):
        MeshTierDomain()


def test_lost_donor_is_never_addressed():
    """A donor marked lost is refused at the domain's own boundary, even
    when the caller's bookkeeping still holds its pool."""
    dom = _dom()
    a = _tensor(dom)
    lps = a.allocate(2)
    a.write_local(lps, torch.ones((2,) + a.page_shape))
    a.offload(lps, prefer=REMOTE)
    faults = FaultInjector(seed=0)
    dom.attach_faults(faults)
    faults.mark_donor_lost("d0")
    c0 = dom.collectives
    with pytest.raises(LeaseRevokedError):
        dom.pull(a.remote_pools["d0"], "d0", a.page_table[lps, 1])
    with pytest.raises(LeaseRevokedError):
        dom.alloc_pool("d0", 4, a.page_shape, torch.float32)
    assert dom.collectives == c0


def test_auditor_holds_legs_against_priced_messages():
    """The auditor's mesh check: priced fabric messages never outrun the
    legs put on the wire between two audits."""
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    dom = _dom()
    kv = PagedStateRuntime(cfg, max_seq=64, page_tokens=8, max_running=2,
                           device="cpu", mesh=dom)
    kv.add_remote_lease("d0", 1 << 24)
    aud = InvariantAuditor()
    aud.audit(kv)
    kv.ensure_capacity(0, 17)
    kv.park(0, 17, prefer=REMOTE)
    kv.restore(0)
    aud.audit(kv)
    kv.meter.messages_fabric += 1         # a message with no leg behind it
    assert any("collectives" in v for v in aud.check(kv))


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
def _drive(pkg):
    """The same moves through either package's AquaTensor over its domain:
    two donors, offloads and restores (a bucket padded 5 -> 8 and 3 -> 4
    among them), a read of REMOTE pages, the reclaim of d0 mid-flight, a
    re-lease of d0 and more moves onto it."""
    if pkg == "jax":
        dom = JDomain()
        a = JAquaTensor(n_logical=32, page_shape=(4, 6), local_slots=16,
                        host_slots=16, dtype=jnp.float32,
                        meter=JTransferMeter(hw=J_A100), mesh=dom)
        put = lambda x: jnp.asarray(x)                         # noqa: E731
        get = np.asarray
    else:
        dom = MeshTierDomain(devices=CPU4)
        a = AquaTensor(n_logical=32, page_shape=(4, 6), local_slots=16,
                       host_slots=16, dtype=torch.float32,
                       meter=TransferMeter(hw=A100_NVLINK), device="cpu",
                       mesh=dom)
        put = torch.from_numpy                                 # noqa: E731
        get = lambda t: t.numpy()                              # noqa: E731
    a.add_remote_lease("d0", 5)
    a.add_remote_lease("d1", 3)
    payload = np.random.default_rng(7).standard_normal(
        (10, 4, 6)).astype(np.float32)
    lps = a.allocate(10)
    a.write_local(lps, put(payload))
    a.set_page_fill(lps[-1:], 0.5)
    reads = []
    for _ in range(2):
        a.offload(lps[:8], prefer=REMOTE)
        reads.append(get(a.read(lps)))
        a.ensure_local(lps[:8])
    a.offload(lps[:3], prefer=REMOTE)
    a.offload(lps[3:7], prefer=REMOTE)
    moved = a.evict_remote("d0")
    a.add_remote_lease("d0", 5)
    a.ensure_local(lps[:7])
    a.offload(lps[2:9], prefer=REMOTE)
    reads.append(get(a.read(lps)))
    a.ensure_local(lps)
    reads.append(get(a.read(lps)))
    m = a.meter
    return dict(collectives=dom.collectives,
                sample_bytes=[b for b, _ in dom.samples["fabric"]],
                donors={d: dom.donor_device(d) for d in ("d0", "d1")},
                page_table=a.page_table.copy(), moved=moved,
                meter=(m.bytes_fabric, m.bytes_host, m.messages_fabric,
                       m.messages_host, m.sim_time),
                reads=reads, payload=payload)


def test_mesh_legs_match_reference_exactly():
    """One sequence of moves through both packages: the port's legs on the
    wire, the bytes of every sampled leg, the donor -> entry map, the page
    table, the pages evicted and the meter (bytes, messages, simulated
    time) equal the reference's, and every read returns the payload."""
    ref, port = _drive("jax"), _drive("torch")
    assert port["collectives"] == ref["collectives"] > 0
    assert port["sample_bytes"] == ref["sample_bytes"]
    assert len(port["sample_bytes"]) > 0
    assert port["donors"] == ref["donors"]
    np.testing.assert_array_equal(port["page_table"], ref["page_table"])
    assert port["moved"] == ref["moved"] > 0
    assert port["meter"] == ref["meter"]
    for r, p in zip(ref["reads"], port["reads"]):
        np.testing.assert_array_equal(r, ref["payload"])
        np.testing.assert_array_equal(p, port["payload"])
    assert (port["page_table"][:, 0] != HOST).any()
