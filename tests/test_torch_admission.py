"""Admission in the port against the JAX reference: the workload generators
(``core/workload.py``), the SLO-aware ``AdmissionController`` and the
engine under admission — the reference's ``tests/test_burst_stability.py``
cases on the port.

  * Each generator (bursty, multi-tenant, cancel schedules, prompt tokens,
    the modulated rate) gives the reference's trace for the same arguments,
    field for field, and is a pure function of its seed.
  * Both packages' controllers, fed the same requests and cost callables,
    partition the queue identically and log the same decisions; the
    reference's unit cases (typed config errors, the region, the
    idle-system progress floor, eligibility of admitted requests) hold on
    the port's.
  * The engine cases (occupancy supermartingale for seeds 0-2, admission
    composed with a donor loss mid-burst, the burst smoke) run on both
    engines (weights carried by ``params.from_jax``, the reference side on
    ``paged_impl="xla"``): tokens, ``occupancy_trace``,
    ``queue_depth_trace``, ``admission_deferrals`` and the meter equal.
  * ``split_step_budget``'s progress floor (the port's copy of the
    scheduler) gives the reference's grants.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config, smoke_config
from repro.core import aqua_tensor as J
from repro.core import faults as j_faults
from repro.core import workload as j_wl
from repro.core.errors import AdmissionError as JAdmissionError
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.serving.admission import AdmissionController as JController
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro.serving.scheduler import split_step_budget as j_split
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core import aqua_tensor as T
from repro_torch.core import faults as t_faults
from repro_torch.core import workload as t_wl
from repro_torch.core.errors import AdmissionError
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.params import from_jax
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime
from repro_torch.serving.scheduler import split_step_budget

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

ARCH = "qwen1.5-0.5b"
METER_KEYS = ("bytes_fabric", "bytes_host", "messages_fabric",
              "messages_host", "retries_fabric", "retries_host", "sim_time")


def _trace(reqs):
    return [(r.rid, r.arrival, r.prompt_len, r.gen_len, r.prefix_group,
             r.shared_prefix_len, r.lora_bytes, r.deadline_s,
             r.ttft_deadline_s) for r in reqs]


# ---------------------------------------------------------------------------
# workload generators: the reference's traces, and pure in their seed
# ---------------------------------------------------------------------------
BURSTY = {
    "plain": dict(seed=0),
    "spike_tenants": dict(seed=7, base_rate=2.0, n_tenants=3,
                          bursts=[(5.0, 3.0, 10.0)]),
    "overlapping_spikes": dict(seed=3, base_rate=1.0,
                               bursts=[(1.0, 4.0, 3.0), (2.0, 1.0, 8.0)],
                               lora_bytes=1e6),
    "clamped": dict(seed=1, n_tenants=4, max_prompt=2048, max_gen=512),
    "engine_burst": dict(seed=2, base_rate=5.0, bursts=[(0.0, 1.0, 5.0)],
                         prompt_median=10, prompt_sigma=0.3, gen_median=4,
                         gen_sigma=0.3, max_prompt=20, max_gen=6),
}


def _bursty(wl, n, kw):
    kw = dict(kw)
    kw["bursts"] = [wl.BurstSpec(*b) for b in kw.get("bursts", ())]
    return wl.make_bursty_requests(n, **kw)


@pytest.mark.parametrize("case", sorted(BURSTY))
def test_bursty_requests_match_reference(case):
    got = _bursty(t_wl, 96, BURSTY[case])
    assert _trace(got) == _trace(_bursty(j_wl, 96, BURSTY[case]))
    assert _trace(got) == _trace(_bursty(t_wl, 96, BURSTY[case]))
    other = dict(BURSTY[case], seed=BURSTY[case]["seed"] + 1)
    assert _trace(got) != _trace(_bursty(t_wl, 96, other))


@pytest.mark.parametrize("kw", [dict(n_tenants=4, seed=3),
                                dict(n_tenants=6, seed=0, burst=2.0),
                                dict(n_tenants=2, seed=5, gen=(4, 9),
                                     system_prompt=(16, 64))])
def test_multi_tenant_requests_match_reference(kw):
    got = t_wl.make_multi_tenant_requests(48, **kw)
    assert _trace(got) == _trace(j_wl.make_multi_tenant_requests(48, **kw))
    assert [r.rid for r in got] == list(range(48))
    assert _trace(got) != _trace(t_wl.make_multi_tenant_requests(
        48, **dict(kw, seed=kw["seed"] + 1)))


@pytest.mark.parametrize("frac,seed,wait", [(0.5, 2, 5.0), (0.2, 0, 1.0),
                                            (1.0, 7, 0.5), (0.0, 1, 5.0)])
def test_cancel_events_match_reference(frac, seed, wait):
    reqs = t_wl.make_bursty_requests(24, seed=1)
    jreqs = j_wl.make_bursty_requests(24, seed=1)
    got = t_wl.make_cancel_events(reqs, frac=frac, seed=seed,
                                  mean_wait_s=wait)
    want = j_wl.make_cancel_events(jreqs, frac=frac, seed=seed,
                                   mean_wait_s=wait)
    assert [(e.kind, e.rid, e.at_time, e.at_step) for e in got] == \
        [(e.kind, e.rid, e.at_time, e.at_step) for e in want]
    assert all(isinstance(e, t_faults.FaultEvent) for e in got)
    assert all(x.at_time <= y.at_time for x, y in zip(got, got[1:]))
    by_rid = {r.rid: r for r in reqs}
    assert all(e.at_time >= by_rid[e.rid].arrival for e in got)


def test_cancel_events_refuse_a_fraction_outside_unit_interval():
    reqs = t_wl.make_bursty_requests(4, seed=1)
    for frac in (-0.1, 1.5):
        with pytest.raises(ValueError):
            t_wl.make_cancel_events(reqs, frac=frac)


@pytest.mark.parametrize("n_tenants,vocab,seed", [(2, 97, 5), (0, 251, 0),
                                                  (3, 512, 9)])
def test_prompt_tokens_match_reference_and_share_prefixes(n_tenants, vocab,
                                                          seed):
    reqs = t_wl.make_bursty_requests(32, seed=2, n_tenants=n_tenants)
    jreqs = j_wl.make_bursty_requests(32, seed=2, n_tenants=n_tenants)
    toks = t_wl.prompt_tokens_for(reqs, vocab=vocab, seed=seed)
    assert toks == j_wl.prompt_tokens_for(jreqs, vocab=vocab, seed=seed)
    by_group = {}
    for r in reqs:
        assert len(toks[r.rid]) == r.prompt_len
        assert all(0 < t < vocab for t in toks[r.rid])
        if r.prefix_group is not None:
            by_group.setdefault(r.prefix_group, []).append(r)
    for members in by_group.values():
        n = min(m.shared_prefix_len for m in members)
        for m in members[1:]:
            assert toks[m.rid][:n] == toks[members[0].rid][:n]


def test_rate_and_spike_window_match_reference():
    spikes = [(50.0, 10.0, 10.0), (55.0, 20.0, 3.0)]
    tb = [t_wl.BurstSpec(*b) for b in spikes]
    jb = [j_wl.BurstSpec(*b) for b in spikes]
    for t in np.linspace(0.0, 90.0, 181):
        assert t_wl.rate_at(float(t), 1.5, tb) == \
            j_wl.rate_at(float(t), 1.5, jb)
    spike = t_wl.BurstSpec(start=50.0, duration=10.0, factor=10.0)
    reqs = t_wl.make_bursty_requests(400, seed=0, base_rate=1.0,
                                     bursts=[spike])
    inside = sum(1 for r in reqs
                 if spike.start <= r.arrival < spike.start + spike.duration)
    assert inside > 50
    assert t_wl.rate_at(spike.start, 1.0, [spike]) == 10.0
    assert t_wl.rate_at(spike.start + spike.duration, 1.0, [spike]) == 1.0


def test_bursty_fields_are_well_formed():
    reqs = t_wl.make_bursty_requests(128, seed=1, n_tenants=4,
                                     max_prompt=2048, max_gen=512)
    assert [r.rid for r in reqs] == list(range(128))
    assert all(a.arrival <= b.arrival for a, b in zip(reqs, reqs[1:]))
    for r in reqs:
        assert 1 <= r.prompt_len <= 2048 and 1 <= r.gen_len <= 512
        assert r.prefix_group is not None and 0 <= r.prefix_group < 4
        assert 0 < r.shared_prefix_len <= r.prompt_len


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16), factor=st.floats(1.0, 20.0),
       rate=st.floats(0.1, 5.0))
def test_bursty_trace_matches_reference_property(seed, factor, rate):
    kw = dict(seed=seed, base_rate=rate, bursts=[(2.0, 4.0, factor)],
              n_tenants=2)
    assert _trace(_bursty(t_wl, 24, kw)) == _trace(_bursty(j_wl, 24, kw))


# ---------------------------------------------------------------------------
# the admission controller, both packages on the same inputs
# ---------------------------------------------------------------------------
def _controller(cls, cap, headroom=0.9, **kw):
    """The reference test's controller over a 1-plane token cost."""
    def cost(r, chosen, terminal):
        ctx = r.prompt_len + (r.gen_len if terminal else r.generated)
        return np.array([float(ctx)])
    return cls(
        budget=lambda: np.array([float(cap)]),
        current_cost=lambda r, c: cost(r, c, False),
        terminal_cost=lambda r, c: cost(r, c, True),
        remaining_tokens=lambda r: (r.prompt_len - r.prefill_pos,
                                    r.gen_len - r.generated),
        headroom=headroom, step_tokens=64, **kw)


def _pair(cap, reqs_kw, **kw):
    """(reference, port) controllers and their own copies of the same
    requests."""
    out = []
    for cls, wl in ((JController, j_wl), (AdmissionController, t_wl)):
        ctl = _controller(cls, cap, **kw)
        out.append((ctl, [wl.Request(**r) for r in reqs_kw]))
    return out


def _decisions(ctl):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in d.items()} for d in ctl.decisions]


def _same_filter(cap, reqs_kw, rounds=1, running=(), **kw):
    (jc, jr), (tc, tr) = _pair(cap, reqs_kw, **kw)
    for _ in range(rounds):
        je, jd = jc.filter(jr, [jr[i] for i in running])
        te, td = tc.filter(tr, [tr[i] for i in running])
        assert [r.rid for r in te] == [r.rid for r in je]
        assert [r.rid for r in td] == [r.rid for r in jd]
    assert _decisions(tc) == _decisions(jc)
    for key in ("admitted_total", "deferred_total", "slo_at_risk",
                "deadline_doomed", "occupancy_frac", "projected_peak_frac"):
        assert getattr(tc, key) == getattr(jc, key), key
    assert tc.admitted_rids == jc.admitted_rids
    return tc, tr, te, td


def _reqs(n, prompt, gen, gap=0.01):
    return [dict(rid=i, arrival=float(i) * gap, prompt_len=prompt,
                 gen_len=gen) for i in range(n)]


@pytest.mark.parametrize("headroom", [0.0, 1.5])
def test_admission_config_refused_with_typed_errors(headroom):
    for cls, err in ((AdmissionController, AdmissionError),
                     (JController, JAdmissionError)):
        with pytest.raises(err):
            _controller(cls, 100, headroom=headroom)
        with pytest.raises(err):
            _controller(cls, 100, horizon=0)
        with pytest.raises(err):
            _controller(cls, 100, prefill_admit_limit=0)


def test_admission_never_exceeds_region_except_progress_floor():
    ctl, reqs, eligible, deferred = _same_filter(
        1000.0, _reqs(12, 200, 150), prefill_admit_limit=None)
    assert eligible and deferred
    floor_rids = set()
    for d in ctl.decisions:
        if d["admitted"]:
            assert d["fits"] and d["mix_ok"]
            assert np.all(d["projected_peak"] <= 0.9 * d["budget"] + 1e-9)
        else:
            floor_rids.add(d["rid"])
    floored = [r for r in eligible
               if r.rid in floor_rids and r.rid in ctl.admitted_rids]
    assert len(floored) <= 1


def test_admission_progress_floor_prevents_idle_deadlock():
    ctl, reqs, eligible, deferred = _same_filter(1000.0, _reqs(1, 5000, 5000))
    assert eligible == reqs and deferred == []


def test_admitted_requests_stay_eligible_and_forget_reprices():
    ctl, reqs, eligible, _ = _same_filter(
        1000.0, _reqs(4, 100, 100, gap=1.0), rounds=2,
        prefill_admit_limit=None)
    assert {r.rid for r in eligible} >= {0}
    admitted = set(ctl.admitted_rids)
    e2, _ = ctl.filter(reqs, running=[])
    assert {r.rid for r in e2} >= admitted
    for rid in admitted:
        ctl.forget(rid)
    assert not ctl.admitted_rids


@pytest.mark.parametrize("limit", [1, 2, None])
def test_prefill_mixing_cap_matches_reference(limit):
    """With a decoding request running, at most ``limit`` new requests may
    be in prefill at once."""
    reqs = _reqs(6, 50, 40)
    reqs[0] = dict(reqs[0], prompt_len=20)
    (jc, jr), (tc, tr) = _pair(5000.0, reqs, prefill_admit_limit=limit)
    jr[0].prefill_pos = tr[0].prefill_pos = 20      # decoding
    je, _ = jc.filter(jr[1:], [jr[0]])
    te, _ = tc.filter(tr[1:], [tr[0]])
    assert [r.rid for r in te] == [r.rid for r in je]
    assert _decisions(tc) == _decisions(jc)
    if limit is not None:
        assert len(te) == limit


def test_deadline_ordering_and_doomed_candidates_match_reference():
    """Earliest-deadline-first ordering and the exclusion of candidates
    that cannot finish inside their slack, with an SLO on the step time."""
    reqs = _reqs(6, 120, 60)
    slack = {0: None, 1: 0.5, 2: 1e-4, 3: None, 4: 2.0, 5: 0.05}
    kw = dict(prefill_admit_limit=None, slo_ttft_s=0.002,
              step_time=lambda: 1e-3,
              order_key=lambda r: (slack[r.rid] if slack[r.rid] is not None
                                   else float("inf"), r.arrival, r.rid),
              deadline_of=lambda r: slack[r.rid])
    ctl, _, eligible, deferred = _same_filter(2000.0, reqs, **kw)
    assert ctl.deadline_doomed > 0 and ctl.slo_at_risk > 0
    assert 2 in {r.rid for r in deferred}


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), cap=st.integers(500, 5000),
       headroom=st.floats(0.5, 1.0))
def test_admission_budget_safety_property(seed, cap, headroom):
    rng = np.random.default_rng(seed)
    reqs = sorted(({"rid": i, "arrival": float(rng.uniform(0, 5)),
                    "prompt_len": int(rng.integers(10, 400)),
                    "gen_len": int(rng.integers(10, 400))}
                   for i in range(10)), key=lambda r: r["arrival"])
    ctl, _, _, _ = _same_filter(float(cap), reqs, headroom=headroom,
                                prefill_admit_limit=None)
    for d in ctl.decisions:
        if d["admitted"]:
            assert np.all(d["projected_peak"]
                          <= headroom * d["budget"] + 1e-9)


# ---------------------------------------------------------------------------
# split_step_budget: the progress floor under the adversarial mix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("budget,lanes,remaining,slack,total", [
    (256, 256, [4096] * 10, None, 1), (128, 512, [8192] * 10, None, 1),
    (64, 64, [2048] * 10 + [512] * 5, None, 1),
    (256, 300, [1024] * 4, 0, 1), (256, 16, [4096] * 10, None, 240),
    (256, 0, [10, 4096, 3], None, None)])
def test_split_step_budget_matches_reference(budget, lanes, remaining, slack,
                                             total):
    got = split_step_budget(budget, lanes, remaining, flops_slack=slack)
    assert got == j_split(budget, lanes, remaining, flops_slack=slack)
    if total is not None:
        assert sum(got) == total
    assert all(c <= r for c, r in zip(got, remaining))
    assert sum(got) <= budget


def test_progress_floor_drains_long_prefill_eventually():
    remaining = [300] + [4096] * 9
    for _ in range(300):
        chunks = split_step_budget(256, 256, remaining)
        remaining = [r - c for r, c in zip(remaining, chunks)]
        if remaining[0] == 0:
            break
    assert remaining[0] == 0


# ---------------------------------------------------------------------------
# the engines under admission: supermartingale occupancy, donor loss, smoke
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return {"reference": (cfg, params), "port": (tcfg, model)}


def _bursty_engine(side, models, seed, faults=None, n=6):
    """The reference test's burst engine: LOCAL for one request, two lanes,
    CFS parking on a 16 MiB REMOTE lease, admission and the auditor on."""
    cfg, params = models[side]
    rt = dict(max_seq=64, page_tokens=8, max_running=1, prefix_sharing=False)
    kw = dict(max_running=2, max_seq=64, scheduler="cfs", slice_tokens=3,
              faults=faults, audit=True, prefetch=False, admission=True)
    if side == "reference":
        kv = JRuntime(cfg, meter=J.TransferMeter(hw=J_A100), **rt)
        eng = JEngine(cfg, params, offload_tier=J.REMOTE, hw=J_A100,
                      paged_impl="xla", kv=kv, **kw)
        wl = j_wl
    else:
        kv = TRuntime(cfg, meter=T.TransferMeter(hw=T_A100), device="cpu",
                      **rt)
        eng = TEngine(cfg, params, offload_tier=T.REMOTE, hw=T_A100, kv=kv,
                      device="cpu", **kw)
        wl = t_wl
    eng.pager.add_remote_lease("d0", 2 ** 24)
    reqs = wl.make_bursty_requests(
        n, seed=seed, base_rate=5.0,
        bursts=[wl.BurstSpec(start=0.0, duration=1.0, factor=5.0)],
        prompt_median=10, prompt_sigma=0.3, gen_median=4, gen_sigma=0.3,
        max_prompt=20, max_gen=6)
    toks = wl.prompt_tokens_for(reqs, vocab=cfg.vocab_size, seed=seed)
    for r in reqs:
        eng.submit(toks[r.rid], max(r.gen_len, 1), arrival=r.arrival)
    return eng


def _burst_outcome(eng):
    m = eng.metrics
    return {"tokens": sorted((r.rid, tuple(r.generated))
                             for r in eng.finished),
            "occupancy": list(m.occupancy_trace),
            "queue_depth": list(m.queue_depth_trace),
            "deferrals": m.admission_deferrals,
            "steps": m.steps, "audits": eng.auditor.audits,
            "recomputes": m.recomputes,
            "meter": {k: getattr(eng.pager.meter, k) for k in METER_KEYS},
            "admitted": sorted(eng.admission.admitted_rids),
            "budget": np.asarray(eng.admission._budget()).tolist()}


def _burst_both(models, seed, steps, faults=None, n=6):
    out = {}
    for side, mod in (("reference", j_faults), ("port", t_faults)):
        eng = _bursty_engine(side, models, seed,
                             faults=faults(mod) if faults else None, n=n)
        cap = float(np.sum(eng.kv.total_capacity()))
        eng.run(steps)
        out[side] = (eng, cap, _burst_outcome(eng))
    assert out["port"][2] == out["reference"][2]
    return out["port"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_occupancy_supermartingale_under_admission(models, seed):
    eng, _, got = _burst_both(models, seed, 80)
    occ = got["occupancy"]
    assert occ and max(occ) <= 1.0 + 1e-9
    above = [occ[t + 1] - occ[t] for t in range(len(occ) - 1)
             if occ[t] >= 0.9]
    if above:
        assert sum(above) / len(above) <= 1e-9
    assert got["queue_depth"]
    assert got["audits"] == got["steps"]


def test_engine_admission_composes_with_donor_loss_mid_burst(models):
    faults = (lambda m: m.FaultInjector(seed=0, events=[
        m.FaultEvent(kind="donor_loss", donor="d0", at_step=6)]))
    budget_before = float(np.sum(_bursty_engine(
        "port", models, 3).admission._budget()))
    eng, cap_before, got = _burst_both(models, 3, 400, faults=faults)
    assert float(np.sum(eng.kv.total_capacity())) < cap_before
    assert float(np.sum(got["budget"])) <= budget_before
    assert eng.finished and all(r.done for r in eng.finished)
    assert not eng.running and not eng.waiting


def test_burst_smoke_engine_admission_audit(models):
    eng, _, got = _burst_both(models, 0, 200, n=4)
    assert not eng.waiting and not eng.running
    m = eng.metrics
    assert len(eng.finished) == 4
    assert m.occupancy_trace and m.queue_depth_trace
    assert np.isfinite(m.ttft_quantile(0.5))
    assert m.ttft_quantile(0.99) >= m.ttft_quantile(0.5)
    assert m.admission_deferrals >= 0
