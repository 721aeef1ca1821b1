"""The port's discrete-event serving simulator (``repro_torch/core/
simulator.py``) against the JAX reference's ``repro/core/simulator.py``,
then the reference's paper gates on the port alone.

  * Port against reference: the same request lists, built from one numpy
    seed into each package's ``Request``, and each package's own
    ``FaultInjector`` / ``FaultEvent``s from the same draws, run through
    both simulators with the same knobs. Every request's ``ttft``,
    ``finish``, ``generated``, ``prefill_pos``, ``cancelled``,
    ``cancel_reason`` and ``recovered``, every ``timeline`` row and the
    counters must be equal, exactly. Runs: the two schedulers on both
    tiers, the blob path and the uncoalesced path, chunked prefill with
    prefetched page-ins and speculative chunk-ahead, the per-request
    launch model, jamba-v0.1-52b and rwkv6-3b with planes uncoalesced,
    prefix groups with the cache on and off, the LoRA adapter cache,
    admission, leg faults with donor-loss, lease-shrink, cancel and
    deadline events, and the typed ``CapacityError``.
  * The reference's gates as port-only twins: the paper's Fig. 9, 1b, 7
    and 3a claims (``test_aqua_core.py``), the lifecycle mirror
    (``test_lifecycle.py``), admission on the byte clock
    (``test_burst_stability.py``), speculative chunk-ahead, plane
    coalescing and the fused step's p99 (``test_fused_step.py``), chunked
    prefill at paper scale (``test_prefill_chunking.py``) and the fault
    schedules (``test_faults.py``).
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import errors as j_errors
from repro.core import faults as j_faults
from repro.core import perfmodel as JP
from repro.core import simulator as JS
from repro_torch.configs import get_config
from repro_torch.core import errors as t_errors
from repro_torch.core import faults as t_faults
from repro_torch.core import perfmodel as TP
from repro_torch.core import simulator as TS
from repro_torch.core import workload as t_wl

REQ_FIELDS = ("ttft", "finish", "generated", "prefill_pos", "cancelled",
              "cancel_reason", "recovered", "prefilled", "resident")
COUNTERS = ("cache_hits", "cache_hit_tokens", "adopted_tokens",
            "leg_retries", "donor_losses", "lease_shrinks", "overflow_swaps",
            "cancelled", "deadline_missed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# port against reference
# ---------------------------------------------------------------------------
PACKAGES = {
    "ref": dict(P=JP, S=JS, get_config=j_get_config, faults=j_faults),
    "port": dict(P=TP, S=TS, get_config=get_config, faults=t_faults),
}


def _draws(seed, n, rate, prompt, gen, *, groups=0, shared=0, lora=0.0,
           deadlines=()):
    """Request fields from one numpy seed: Poisson arrivals at ``rate``,
    uniform prompt and generation lengths; ``groups`` prefix groups of a
    ``shared``-token prefix; ``deadlines``: (index, field, seconds)."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / rate, n))
    out = []
    for i in range(n):
        kw = dict(rid=i, arrival=float(arr[i]),
                  prompt_len=int(rng.integers(*prompt)),
                  gen_len=int(rng.integers(*gen)))
        if groups:
            kw.update(prefix_group=int(rng.integers(0, groups)),
                      shared_prefix_len=shared)
        if lora:
            kw["lora_bytes"] = lora
        out.append(kw)
    for i, name, secs in deadlines:
        out[i][name] = secs
    return out


def _fig9_draws(seed, n=80):
    """``test_aqua_core.py``'s ``_mkreqs(5.0, n, seed)``."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / 5.0, n))
    return [dict(rid=i, arrival=float(arr[i]),
                 prompt_len=int(rng.integers(400, 1600)),
                 gen_len=int(rng.integers(150, 500))) for i in range(n)]


def _unit(pkg, arch, pod=1):
    """Profile, cost, weight bytes and KV capacity of ``arch`` on the
    package's A100 profile (a ``pod``-card slice for a model past 80 GB)."""
    cfg = pkg["get_config"](arch)
    hw = pkg["P"].A100_NVLINK.pod_slice(pod)
    wb = cfg.param_count() * 2
    return hw, pkg["P"].ModelCost.from_config(cfg), wb, hw.hbm_bytes - wb - 2e9


def _run(pkg, arch, draws, *, pod=1, faults=None, horizon=1e9, **kw):
    hw, mc, wb, cap = _unit(pkg, arch, pod)
    args = dict(weight_bytes=wb, kv_capacity_bytes=cap, max_running=20)
    args.update(kw)
    injector = None
    if faults is not None:
        f = pkg["faults"]
        injector = f.FaultInjector(
            seed=faults["seed"], leg_fault_rate=faults["rate"],
            events=[f.FaultEvent(**ev) for ev in faults["events"]])
    sim = pkg["S"].ServingSimulator(hw, mc, faults=injector, **args)
    res = sim.run([pkg["S"].Request(**d) for d in draws], horizon=horizon)
    return sim, res


def _record(sim, res):
    return ([tuple(getattr(r, f) for f in REQ_FIELDS) for r in res.requests],
            list(res.timeline), {c: getattr(sim, c) for c in COUNTERS})


CODE = "aqua-codellama-34b"
SMALL = dict(n=24, rate=40.0, prompt=(300, 900), gen=(30, 120))
RUNS = {
    "vllm-host": (CODE, dict(draws="fig9", scheduler="vllm",
                             offload_tier="host")),
    "vllm-fabric": (CODE, dict(draws="fig9", scheduler="vllm",
                               offload_tier="fabric")),
    "cfs-host": (CODE, dict(draws="fig9", scheduler="cfs",
                            offload_tier="host")),
    "cfs-fabric": (CODE, dict(draws="fig9", scheduler="cfs",
                              offload_tier="fabric")),
    "blob": (CODE, dict(scheduler="cfs", offload_tier="fabric", max_running=6,
                        paging="blob")),
    "uncoalesced": (CODE, dict(scheduler="cfs", offload_tier="host",
                               max_running=6, coalesced=False)),
    "step-none-overlap": (CODE, dict(scheduler="cfs", offload_tier="fabric",
                                     max_running=6, step_tokens=None,
                                     overlap_pagein=True)),
    "step-256-overlap-spec": (CODE, dict(scheduler="cfs",
                                         offload_tier="fabric", max_running=6,
                                         step_tokens=256, overlap_pagein=True,
                                         spec_chunk_ahead=True)),
    "vllm-step-96-spec": (CODE, dict(scheduler="vllm", offload_tier="fabric",
                                     max_running=4, step_tokens=96,
                                     spec_chunk_ahead=True)),
    "per-request-launches": (CODE, dict(scheduler="cfs",
                                        offload_tier="fabric", max_running=8,
                                        step_tokens=256, fused_step=False)),
    "jamba-planes-split": ("jamba-v0.1-52b", dict(
        pod=2, scheduler="cfs", offload_tier="fabric", max_running=6,
        step_tokens=256, coalesce_planes=False, spec_chunk_ahead=True)),
    "rwkv-planes-split": ("rwkv6-3b", dict(
        scheduler="cfs", offload_tier="host", max_running=6,
        step_tokens=256, coalesce_planes=False)),
    "prefix-cache-on": (CODE, dict(draws="prefix", scheduler="cfs",
                                   offload_tier="fabric", max_running=6,
                                   step_tokens=256, prefix_cache=True)),
    "prefix-cache-off": (CODE, dict(draws="prefix", scheduler="cfs",
                                    offload_tier="fabric", max_running=6,
                                    step_tokens=256, prefix_cache=False)),
    "prefix-vllm": (CODE, dict(draws="prefix", scheduler="vllm",
                               offload_tier="host", max_running=6,
                               step_tokens=256)),
    "lora-cache": (CODE, dict(draws="lora", scheduler="cfs",
                              offload_tier="fabric", max_running=6,
                              lora_cache_bytes=4e9, lora_num_adapters=100)),
    "lora-host": (CODE, dict(draws="lora", scheduler="vllm",
                             offload_tier="host", max_running=6)),
    "admission-cfs": (CODE, dict(draws="burst", scheduler="cfs",
                                 offload_tier="fabric", max_running=32,
                                 step_tokens=256, admission=True,
                                 admission_headroom=0.9)),
    "admission-vllm": (CODE, dict(draws="burst", scheduler="vllm",
                                  offload_tier="host", max_running=32,
                                  step_tokens=256, admission=True,
                                  admission_headroom=0.95,
                                  prefill_admit_limit=2, horizon=300.0)),
    "faults": (CODE, dict(draws="deadlines", scheduler="cfs",
                          offload_tier="fabric", max_running=4,
                          step_tokens=256, faults="all")),
    "faults-vllm-admission": (CODE, dict(draws="deadlines", scheduler="vllm",
                                         offload_tier="fabric", max_running=4,
                                         step_tokens=256, admission=True,
                                         faults="all")),
}


def _run_draws(kind):
    if kind == "fig9":
        return _fig9_draws(0)
    if kind == "prefix":
        return _draws(3, 24, 1.0, (600, 1400), (20, 80), groups=3,
                      shared=512)
    if kind == "lora":
        return _draws(4, **SMALL, lora=120e6)
    if kind == "burst":
        return [dict(rid=r.rid, arrival=r.arrival, prompt_len=r.prompt_len,
                     gen_len=r.gen_len)
                for r in t_wl.make_bursty_requests(
                    16, seed=3, base_rate=1.0, prompt_median=512,
                    prompt_sigma=0.3, gen_median=1500, gen_sigma=0.2)]
    if kind == "deadlines":
        return _draws(2, 16, 80.0, (300, 800), (40, 120),
                      deadlines=((5, "deadline_s", 0.4),
                                 (9, "ttft_deadline_s", 1e-6)))
    return _draws(1, **SMALL)


def _fault_spec(draws):
    """A fault schedule from the draws: leg faults at 0.2, a donor loss,
    a lease shrink and two cancels at fixed times after the arrivals."""
    last = draws[-1]["arrival"]
    return dict(seed=4, rate=0.2, events=[
        dict(kind="donor_loss", donor="d0", frac=1.0, at_time=last + 0.8),
        dict(kind="lease_shrink", donor="d1", frac=0.5, at_time=last + 1.5),
        dict(kind="cancel", rid=2, at_time=draws[2]["arrival"] + 0.01),
        dict(kind="cancel", rid=11, at_time=last + 1.0)])


@pytest.mark.parametrize("name", list(RUNS))
def test_simulator_equals_reference(name):
    arch, kw = RUNS[name]
    kw = dict(kw)
    draws = _run_draws(kw.pop("draws", None))
    if kw.pop("faults", None):
        kw["faults"] = _fault_spec(draws)
    got = _run(PACKAGES["port"], arch, draws, **kw)
    want = _run(PACKAGES["ref"], arch, draws, **kw)
    got_reqs, got_tl, got_c = _record(*got)
    want_reqs, want_tl, want_c = _record(*want)
    assert got_reqs == want_reqs
    assert got_tl == want_tl
    assert got_c == want_c
    assert got_tl, "no round ran"
    if "faults" in kw:
        assert got_c["cancelled"] == 4 and got_c["deadline_missed"] == 2
        assert got_c["donor_losses"] == 1 and got_c["lease_shrinks"] == 1
    if name == "faults":
        assert got_c["leg_retries"] > 0
    if name.startswith("prefix"):
        assert got_c["adopted_tokens"] > 0
    if name == "prefix-cache-on":
        assert got_c["cache_hits"] > 0
    if name == "prefix-cache-off":
        assert got_c["cache_hits"] == 0


def test_capacity_error_is_typed_like_the_reference():
    draws = _draws(2, 1, 80.0, (300, 800), (40, 120))
    with pytest.raises(t_errors.CapacityError):
        _run(PACKAGES["port"], CODE, draws, kv_capacity_bytes=0.0)
    with pytest.raises(j_errors.CapacityError):
        _run(PACKAGES["ref"], CODE, draws, kv_capacity_bytes=0.0)
    assert issubclass(t_errors.CapacityError, t_errors.AquaError)


def test_request_is_the_workload_record():
    assert TS.Request is t_wl.Request
    assert [f for f in TS.Request.__dataclass_fields__] == \
        [f for f in JS.Request.__dataclass_fields__]


def test_long_prompt_tokens_per_s_equals_reference():
    for pkg_t, pkg_j in ((TP.A100_NVLINK, JP.A100_NVLINK),
                         (TP.TPU_V5E, JP.TPU_V5E)):
        for arch in ("aqua-opt-30b", CODE, "rwkv6-3b"):
            cfg, jcfg = get_config(arch), j_get_config(arch)
            wb = cfg.param_count() * 2
            for ctx in (1000, 8000, 32000):
                for free in (1e9, 80e9 - wb - 12e9, 1e12):
                    for tier in ("fabric", "host"):
                        assert TS.long_prompt_tokens_per_s(
                            pkg_t, TP.ModelCost.from_config(cfg),
                            ctx_tokens=ctx, free_hbm_bytes=free,
                            weight_bytes=wb, tier=tier) == \
                            JS.long_prompt_tokens_per_s(
                                pkg_j, JP.ModelCost.from_config(jcfg),
                                ctx_tokens=ctx, free_hbm_bytes=free,
                                weight_bytes=wb, tier=tier)


# ---------------------------------------------------------------------------
# the reference's gates, port only
# ---------------------------------------------------------------------------
def _codellama(scheduler, tier, **kw):
    cfg = get_config(CODE)
    mc = TP.ModelCost.from_config(cfg)
    wb = cfg.param_count() * 2
    args = dict(weight_bytes=wb, kv_capacity_bytes=80e9 - wb - 2e9,
                scheduler=scheduler, offload_tier=tier, max_running=20)
    args.update(kw)
    return TS.ServingSimulator(TP.A100_NVLINK, mc, **args)


def _mkreqs(seed, n=80):
    return [TS.Request(**d) for d in _fig9_draws(seed, n)]


def _p90(xs):
    xs = sorted(xs)
    return xs[int(0.9 * len(xs))]


def test_cfs_improves_ttft_multiple_x():
    """Fig. 9 (``test_aqua_core.py:229``)."""
    r_v = _codellama("vllm", "host").run(_mkreqs(0))
    r_a = _codellama("cfs", "fabric").run(_mkreqs(0))
    assert _p90(r_a.ttfts()) < _p90(r_v.ttfts()) / 2.0
    assert r_a.p50(r_a.ttfts()) < r_v.p50(r_v.ttfts()) / 1.8


def test_aqua_recovers_cfs_rct_penalty():
    """Fig. 1b/9 (``test_aqua_core.py:241``)."""
    r_h = _codellama("cfs", "host").run(_mkreqs(1))
    r_f = _codellama("cfs", "fabric").run(_mkreqs(1))
    assert r_f.p50(r_f.rcts()) < r_h.p50(r_h.rcts())


def test_long_prompt_6x_on_paper_hardware():
    """Fig. 7 (``test_aqua_core.py:248``)."""
    cfg = get_config("aqua-opt-30b")
    mc = TP.ModelCost.from_config(cfg)
    wb = cfg.param_count() * 2
    free = 80e9 - wb - 12e9
    th = {tier: TS.long_prompt_tokens_per_s(
        TP.A100_NVLINK, mc, ctx_tokens=8000, free_hbm_bytes=free,
        weight_bytes=wb, tier=tier) for tier in ("host", "fabric")}
    assert 4.0 < th["fabric"] / th["host"] < 8.0


def test_fabric_bandwidth_curve_matches_fig3a():
    bw2mb = TP.A100_NVLINK.fabric.effective_bw(2e6)
    assert 80e9 < bw2mb < 120e9
    assert TP.A100_NVLINK.fabric.effective_bw(1e9) > 230e9
    assert TP.A100_NVLINK.fabric.effective_bw(64e3) < 10e9


def _lifecycle_sim(faults=None):
    return _codellama("cfs", "fabric", max_running=4, step_tokens=256,
                      faults=faults)


def _lifecycle_requests(n=12, seed=2):
    return [TS.Request(**d) for d in _draws(seed, n, 80.0, (300, 800),
                                            (40, 120))]


def test_simulator_cancel_events_tear_out_the_named_request():
    """``test_lifecycle.py:358``."""
    reqs = _lifecycle_requests()
    fi = t_faults.FaultInjector(seed=0, events=[
        t_faults.FaultEvent(kind="cancel", rid=2,
                            at_time=reqs[2].arrival + 0.01),
        t_faults.FaultEvent(kind="cancel", rid=7,
                            at_time=reqs[7].arrival + 0.01)])
    sim = _lifecycle_sim(faults=fi)
    res = sim.run(reqs)
    assert sim.cancelled == 2
    for r in res.requests:
        if r.rid in (2, 7):
            assert r.cancelled and r.cancel_reason == "fault"
            assert r.finish is None and not r.resident
        else:
            assert r.finish is not None and not r.cancelled


def test_simulator_deadline_sweep_mirrors_the_engine():
    """``test_lifecycle.py:374``."""
    reqs = _lifecycle_requests(seed=5)
    reqs[3].deadline_s = 1e-6
    reqs[6].ttft_deadline_s = 1e-6
    sim = _lifecycle_sim()
    res = sim.run(reqs)
    assert sim.deadline_missed == 2 and sim.cancelled == 2
    for r in res.requests:
        if r.rid in (3, 6):
            assert r.cancelled and r.cancel_reason == "deadline"
            assert r.finish is None
        else:
            assert r.finish is not None


def _overload_sim(admission):
    vets = t_wl.make_bursty_requests(16, seed=0, base_rate=0.5,
                                     prompt_median=512, prompt_sigma=0.3,
                                     gen_median=6000, gen_sigma=0.2,
                                     max_gen=8000)
    spike = t_wl.make_bursty_requests(10, seed=1, base_rate=2.0,
                                      prompt_median=1024, prompt_sigma=0.3,
                                      gen_median=64, gen_sigma=0.3)
    for r in spike:
        r.arrival += 40.0
    reqs = sorted(vets + spike, key=lambda r: (r.arrival, r.rid))
    for i, r in enumerate(reqs):
        r.rid = i
    sim = _codellama("vllm", "host", step_tokens=256, max_running=32,
                     admission=admission, admission_headroom=0.95,
                     prefill_admit_limit=4)
    sim.run(reqs, horizon=400.0)
    return sim, reqs


def test_admission_on_byte_clock_prevents_overflow_churn():
    """``test_burst_stability.py:268``."""
    off, _ = _overload_sim(False)
    on, on_reqs = _overload_sim(True)
    assert off.overflow_swaps > 0
    assert on.overflow_swaps == 0
    assert on.admission.deferred_total > 0
    assert all(r.finish is not None or r.ttft is not None
               for r in on_reqs if r.arrival < 100.0)


def test_simulator_admission_occupancy_bounded():
    """``test_burst_stability.py:280``."""
    reqs = t_wl.make_bursty_requests(16, seed=3, base_rate=1.0,
                                     prompt_median=512, prompt_sigma=0.3,
                                     gen_median=2000, gen_sigma=0.2)
    sim = _codellama("vllm", "host", step_tokens=256, max_running=32,
                     admission=True, admission_headroom=0.9)
    res = sim.run(reqs, horizon=600.0)
    assert res.timeline
    for row in res.timeline:
        assert row["occ_frac"] <= 1.0 + 1e-9
        assert row["deferred"] >= 0
    assert sim.overflow_swaps == 0


def test_speculative_chunk_ahead_priced_in_simulator():
    """``test_fused_step.py:326``."""
    def run(spec):
        sim = _codellama("vllm", "fabric", max_running=2, step_tokens=96,
                         spec_chunk_ahead=spec)
        reqs = [TS.Request(0, 0.0, 96, 200), TS.Request(1, 0.0, 96, 200),
                TS.Request(2, 0.001, 3000, 20)]
        res = sim.run(reqs)
        return res.requests[2].ttft - res.requests[2].arrival

    assert run(True) < run(False) - 0.5


def test_plane_coalescing_priced_in_perfmodel_and_simulator():
    """``test_fused_step.py:376``."""
    mc = TP.ModelCost.from_config(get_config("jamba-v0.1-52b"))
    assert mc.n_planes == 3
    assert TP.ModelCost.from_config(get_config("rwkv6-3b")).n_planes == 2
    assert TP.ModelCost.from_config(get_config("qwen1.5-0.5b")).n_planes == 1
    nbytes = mc.context_bytes(4096)
    fused = TP.page_flip_time(TP.A100_NVLINK, nbytes, tier="fabric",
                              n_groups=1)
    split = TP.page_flip_time(TP.A100_NVLINK, nbytes, tier="fabric",
                              n_groups=mc.n_planes)
    assert split - fused == pytest.approx(2 * TP.A100_NVLINK.fabric.latency)


def test_simulator_fused_step_p99_no_worse_at_scale():
    """``test_fused_step.py:406``."""
    def run(fused, n):
        sim = _codellama("cfs", "fabric", max_running=n, step_tokens=256,
                         fused_step=fused)
        res = sim.run([TS.Request(i, 0.0005 * i, 800, 40) for i in range(n)])
        steps = np.diff([0.0] + [e["t"] for e in res.timeline])
        return float(np.percentile(steps, 99)), float(res.requests[-1].finish)

    for n in (16, 64):
        p99_f, fin_f = run(True, n)
        p99_b, fin_b = run(False, n)
        assert p99_f <= p99_b
        assert fin_f <= fin_b


def test_ttft_under_burst_improves_at_paper_scale():
    """``test_prefill_chunking.py:206``."""
    def run(step_tokens):
        sim = _codellama("cfs", "fabric", max_running=8,
                         step_tokens=step_tokens)
        reqs = [TS.Request(0, 0.0, 6000, 30)]
        reqs += [TS.Request(i, 0.001 * i, 120, 30) for i in range(1, 13)]
        res = sim.run(reqs)
        ttfts = sorted(r.ttft - r.arrival for r in res.requests
                       if r.prompt_len == 120)
        steps = np.diff([0.0] + [e["t"] for e in res.timeline])
        return ttfts, float(max(steps))

    (whole, ms_whole), (chunked, ms_chunk) = run(None), run(256)
    assert chunked[len(chunked) // 2] < whole[len(whole) // 2] / 3.0
    assert chunked[-1] < whole[-1] / 2.0
    assert ms_chunk < ms_whole / 2.0


def _faults_requests(n=16, seed=2):
    return [TS.Request(**d) for d in _draws(seed, n, 80.0, (300, 800),
                                            (40, 120))]


def test_simulator_capacity_error_is_typed():
    """``test_faults.py:381``."""
    with pytest.raises(t_errors.CapacityError):
        _codellama("cfs", "fabric", kv_capacity_bytes=0.0).run(
            _faults_requests(1))


def test_simulator_fault_events_and_retry_pricing():
    """``test_faults.py:386``."""
    def run(faults):
        sim = _codellama("cfs", "fabric", max_running=4, step_tokens=256,
                         faults=faults)
        res = sim.run(_faults_requests())
        assert all(r.finish is not None for r in res.requests)
        return sim, res

    sim0, res0 = run(None)
    t0 = max(r.finish for r in res0.requests)
    fi = t_faults.FaultInjector(seed=4, leg_fault_rate=0.2, events=[
        t_faults.FaultEvent(kind="donor_loss", donor="d0", frac=1.0,
                            at_time=t0 * 0.3),
        t_faults.FaultEvent(kind="lease_shrink", donor="d1", frac=0.5,
                            at_time=t0 * 0.5)])
    sim1, res1 = run(fi)
    assert sim1.leg_retries > 0
    assert sim1.donor_losses == 1 and sim1.lease_shrinks == 1
    assert len(fi.events_fired) == 2
    assert max(r.finish for r in res1.requests) > t0
    assert any(r.recovered for r in res1.requests)
