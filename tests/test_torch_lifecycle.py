"""The request lifecycle in the port against the JAX reference: cancel from
every state (a request parked on REMOTE among them), both deadline clocks,
drain/resume, the watchdog, crash-consistent snapshot/restore mid-stream
and with admission and the prefix cache, an ``engine_crash`` event restored
from the last journal record, the refusal of a dirty runtime and the
censored TTFT quantile — the reference's ``tests/test_lifecycle.py`` cases,
each run on both engines under one schedule.

The two engines share weights (``params.from_jax``), prompts, knobs and an
A100 profile; the reference side runs ``paged_impl="xla"``. Each case
holds the port's tokens, terminal states, lifecycle metrics, meter and
auditor verdict to the reference's. Snapshots are held against each other
too: block tables, page ids, fills, the radix tree, counters, requests and
metrics exactly, payloads within 1e-5 (float32 smoke weights; rwkv6-3b's
recurrent state within the state tolerance of ``test_torch_rwkv.py``).
Three exceptions, by design: the reference's ``req_tokens`` record
(written by its runtime, read only by its snapshot and restore; the port
keeps no such record), the knobs' ``paged_impl`` (the port dispatches by
device), and the engine's analytic step clock (``sim_time``, TTFT/RCT, step
times), which the port prices with its own trimmed perf model. Each
runtime's TransferMeter is priced on the engine's A100 profile, so the
meters' clocks are compared.

Port-only: a bf16 snapshot -> restore -> snapshot round trip equal in raw
16-bit words, and rwkv6-3b (the ``wkv``/``shift`` state planes) restored
mid-stream with the reference engine's tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core import aqua_tensor as J
from repro.core import errors as j_errs
from repro.core import faults as j_faults
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.serving.engine import EngineMetrics as JMetrics
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core import aqua_tensor as T
from repro_torch.core import errors as errs
from repro_torch.core import faults as t_faults
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.engine import EngineMetrics as TMetrics
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime

ARCH = "qwen1.5-0.5b"
SIDES = ("reference", "port")
METER_KEYS = ("bytes_fabric", "bytes_host", "messages_fabric",
              "messages_host", "retries_fabric", "retries_host", "sim_time")
LIFECYCLE = ("submitted", "cancelled", "deadline_missed", "drained",
             "watchdog_trips", "steps", "preemptions", "restores",
             "recomputes", "admission_deferrals")
# priced by each package's own perf model (see the module docstring)
CLOCK_METRICS = ("sim_time", "ttft", "rct", "step_times", "overlap_hidden_s")
PAYLOAD_TOL = dict(rtol=0, atol=1e-5)
# rwkv6-3b's float32 recurrent state after several steps: the state
# tolerance of tests/test_torch_rwkv.py (the frameworks sum in other orders)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one intra-op thread: under the tier-1 run's six workers the default
    # (one a core) oversubscribes the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    cfg = smoke_config(get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(arch))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return {"reference": (cfg, params), "port": (tcfg, model)}


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


def _mod(side):
    return {"errs": j_errs if side == "reference" else errs,
            "faults": j_faults if side == "reference" else t_faults,
            "at": J if side == "reference" else T}


def _prompts(vocab, n=4, length=10, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, 1 + rng.integers(0, vocab - 1, length)))
            for _ in range(n)]


def _side_kw(side):
    return (dict(paged_impl="xla", hw=J_A100) if side == "reference"
            else dict(hw=T_A100, device="cpu"))


def _engine(side, models, **kw):
    """The reference test's engine: 2 lanes, 64-token contexts, CFS parking
    on HOST, no prefetch."""
    cfg, params = models[side]
    args = dict(max_running=2, max_seq=64, scheduler="cfs", slice_tokens=4,
                offload_tier=_mod(side)["at"].HOST, prefetch=False)
    args.update(_side_kw(side))
    args.update(kw)
    return _priced((JEngine if side == "reference" else TEngine)(
        cfg, params, **args))


def _priced(eng):
    """Price the default runtime's meter on the engine's profile too, so
    both packages' meters run on one A100 clock."""
    eng.kv.meter.hw = eng.hw
    return eng


def _restore(side, models, snap, **kw):
    cfg, params = models[side]
    args = _side_kw(side)
    args.pop("paged_impl", None)
    args.update(kw)
    return _priced((JEngine if side == "reference" else TEngine).restore(
        cfg, params, snap, **args))


def _auditor(side):
    return _mod(side)["faults"].InvariantAuditor()


def _finished_map(eng):
    return {tuple(r.prompt_tokens): r.generated for r in eng.finished
            if r.terminal == "finished"}


def _outcome(eng):
    """What both engines must agree on after a case."""
    return {"finished": _finished_map(eng),
            "terminal": sorted((r.rid, r.terminal, r.cancel_reason)
                               for r in eng.finished),
            "metrics": {k: getattr(eng.metrics, k) for k in LIFECYCLE},
            "meter": {k: getattr(eng.pager.meter, k) for k in METER_KEYS},
            "audit": _auditor_verdict(eng),
            "tiers": eng.kv.stats()["tiers"]}


def _auditor_verdict(eng):
    side = "port" if isinstance(eng, TEngine) else "reference"
    return _auditor(side).check(eng.kv, engine=eng)


def _both(case, models, **kw):
    """Run ``case(side, models)`` on both engines; their outcomes must be
    equal. Returns {side: value returned by the case}."""
    out = {side: case(side, models, **kw) for side in SIDES}
    ref, port = out["reference"], out["port"]
    assert port["outcome"] == ref["outcome"]
    return out


def _baseline(side, models, prompts, max_new=6, **kw):
    eng = _engine(side, models, **kw)
    for p in prompts:
        eng.submit(p, max_new)
    eng.run(500)
    return _finished_map(eng)


def _same_payload(ref_data, port_plane, tol):
    assert port_plane["dtype"] == "float32"
    got = port_plane["data"]
    want = np.asarray(ref_data)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def _same_snapshot(ref, port, tol=PAYLOAD_TOL):
    """Snapshot dicts equal across packages, less the documented
    differences (module docstring); payloads within ``tol``."""
    ref_cfg = dict(ref["config"])
    assert ref_cfg.pop("paged_impl") == "xla"
    assert port["config"] == ref_cfg
    for key in ("version", "next_rid", "running", "waiting", "finished",
                "admitted", "since_switch", "draining"):
        assert port[key] == ref[key], key
    for k, v in ref["metrics"].items():
        if k in CLOCK_METRICS:
            if isinstance(v, dict):
                assert sorted(port["metrics"][k]) == sorted(v), k
            continue
        assert port["metrics"][k] == v, k
    assert set(port["metrics"]) == set(ref["metrics"])
    rkv, pkv = ref["kv"], port["kv"]
    assert set(pkv) == set(rkv) - {"req_tokens"}
    for key in ("version", "tree", "req_blocks", "req_seed",
                "req_registered", "clock", "counters"):
        assert pkv[key] == rkv[key], key
    assert set(pkv["planes"]) == set(rkv["planes"])
    for name, rp in rkv["planes"].items():
        pp = pkv["planes"][name]
        for key in ("pages", "lps", "fills"):
            assert pp[key] == rp[key], (name, key)
        if rp["data"] is None:
            assert pp["data"] is None
        else:
            _same_payload(rp["data"], pp, tol)


def _no_pages(eng, rid):
    return all(rid not in p.pages for p in eng.kv.planes.values())


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------
def _cancel_every_state(side, models):
    e = _mod(side)["errs"]
    prompts = _prompts(models[side][0].vocab_size, n=4)
    eng = _engine(side, models, audit=True, step_tokens=8)
    rs = [eng.submit(p, 6) for p in prompts]
    auditor = _auditor(side)
    assert rs[3].lifecycle == "waiting"
    assert eng.cancel(rs[3].rid)
    assert auditor.check(eng.kv, engine=eng) == []
    eng.step()
    victim = next(r for r in (rs[0], rs[1]) if r.lifecycle == "prefilling")
    assert eng.cancel(victim.rid)
    assert auditor.check(eng.kv, engine=eng) == []
    survivor = rs[1] if victim is rs[0] else rs[0]
    for _ in range(20):
        if survivor.generated:
            break
        eng.step()
    assert survivor.lifecycle == "running"
    assert eng.cancel(survivor.rid, reason="client")
    assert auditor.check(eng.kv, engine=eng) == []
    for r in (rs[3], victim, survivor):
        assert r.terminal == "cancelled" and r.lifecycle == "cancelled"
        assert r.slot is None and _no_pages(eng, r.rid)
        with pytest.raises(e.CancelledError) as ei:
            eng.output(r.rid)
        assert ei.value.rid == r.rid and ei.value.reason == r.cancel_reason
        assert eng.cancel(r.rid) is False
    assert eng.cancel(10 ** 9) is False
    with pytest.raises(ValueError):
        eng.output(rs[2].rid)                   # still in flight
    m = eng.run(500)
    assert rs[2].terminal == "finished"
    assert eng.output(rs[2].rid) == rs[2].generated
    assert m.cancelled == 3 and m.submitted == 4
    assert eng.auditor.audits == m.steps
    return {"outcome": _outcome(eng), "victim": victim.rid}


def test_cancel_every_state_reclaims_all_pages(models):
    out = _both(_cancel_every_state, models)
    assert out["port"]["victim"] == out["reference"]["victim"]
    assert out["port"]["outcome"]["audit"] == []


def _cancel_parked(side, models):
    cfg, _ = models[side]
    at = _mod(side)["at"]
    prompts = _prompts(cfg.vocab_size, n=3, length=8, seed=1)
    rt = dict(max_seq=64, page_tokens=8, max_running=1, prefix_sharing=False)
    kv = (JRuntime(cfg, meter=J.TransferMeter(hw=J_A100), **rt)
          if side == "reference" else
          TRuntime(cfg, meter=T.TransferMeter(hw=T_A100), device="cpu", **rt))
    eng = _engine(side, models, slice_tokens=3, offload_tier=at.REMOTE, kv=kv)
    eng.pager.add_remote_lease("d0", 2 ** 24)
    for p in prompts:
        eng.submit(p, 6)
    parked = None
    for _ in range(200):
        eng.step()
        parked = next((r for r in eng.running + eng.waiting if r.parked),
                      None)
        if parked is not None:
            break
    assert parked is not None, "1-page runtime under 2 runners must park"
    plane = next(iter(eng.kv.planes.values()))
    on_remote = plane.aqua.page_table[plane.flat(parked.rid), 0]
    assert (on_remote == at.REMOTE).all()
    assert eng.cancel(parked.rid)
    assert _no_pages(eng, parked.rid)
    assert _auditor(side).check(eng.kv, engine=eng) == []
    eng.run(500)
    assert sum(r.terminal == "finished" for r in eng.finished) == 2
    return {"outcome": _outcome(eng), "parked": parked.rid}


def test_cancel_parked_request_mid_offload_pressure(models):
    out = _both(_cancel_parked, models)
    assert out["port"]["parked"] == out["reference"]["parked"]


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def _deadline(side, models):
    prompts = _prompts(models[side][0].vocab_size, n=2, seed=2)
    base = _baseline(side, models, prompts)
    e = _mod(side)["errs"]
    eng = _engine(side, models)
    r1 = eng.submit(prompts[0], 6, deadline_s=1e-9)
    r2 = eng.submit(prompts[1], 6, deadline_s=1e9)
    m = eng.run(500)
    assert r1.terminal == "expired" and r1.cancel_reason == "deadline"
    assert r2.terminal == "finished"
    assert m.deadline_missed == 1 and m.cancelled == 1
    assert _no_pages(eng, r1.rid)
    with pytest.raises(e.CancelledError):
        eng.output(r1.rid)
    assert r2.generated == base[tuple(prompts[1])]
    return {"outcome": _outcome(eng)}


def test_deadline_expiry_sheds_and_counts(models):
    _both(_deadline, models)


def _ttft_deadline(side, models):
    prompts = _prompts(models[side][0].vocab_size, n=2, seed=3)
    eng = _engine(side, models, step_tokens=8)
    r1 = eng.submit(prompts[0], 6, ttft_deadline_s=1e-9)
    r2 = eng.submit(prompts[1], 6, ttft_deadline_s=1e9)
    m = eng.run(500)
    assert r1.terminal == "expired" and m.deadline_missed == 1
    assert r2.terminal == "finished"
    return {"outcome": _outcome(eng)}


def test_ttft_deadline_binds_only_until_first_token(models):
    _both(_ttft_deadline, models)


# ---------------------------------------------------------------------------
# drain / resume
# ---------------------------------------------------------------------------
def _drain(side, models):
    at = _mod(side)["at"]
    prompts = _prompts(models[side][0].vocab_size, n=4, seed=4)
    base = _baseline(side, models, prompts)
    eng = _engine(side, models)
    for p in prompts:
        eng.submit(p, 6)
    for _ in range(3):
        eng.step()
    n = eng.drain()
    assert n >= 1 and eng.metrics.drained == n
    assert not eng.running and not eng.kv._active
    assert all(r.slot is None for r in eng.waiting)
    # only the scratch page is LOCAL; every parked page sits on HOST
    for plane in eng.kv.planes.values():
        tiers = plane.aqua.page_table[:, 0]
        assert (tiers == at.LOCAL).sum() == 1
        assert tiers[plane.scratch_lp] == at.LOCAL
    steps_before = eng.metrics.steps
    eng.step()
    assert not eng.running and eng.metrics.steps == steps_before + 1
    eng.resume()
    eng.run(500)
    assert _finished_map(eng) == base
    return {"outcome": _outcome(eng), "drained": n}


def test_drain_quiesces_and_resume_completes_bit_identically(models):
    out = _both(_drain, models)
    assert out["port"]["drained"] == out["reference"]["drained"]


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
def _watchdog(side, models):
    prompts = _prompts(models[side][0].vocab_size, n=10, length=24, seed=5)
    eng = _engine(side, models, max_running=10, scheduler="fcfs",
                  step_tokens=8, watchdog_steps=5)
    for p in prompts:
        eng.submit(p, 4)
    m = eng.run(2000)
    assert m.watchdog_trips > 0
    assert sum(r.terminal == "finished" for r in eng.finished) == 10
    return {"outcome": _outcome(eng), "recovered": list(m.recovered_rids)}


def test_watchdog_flags_noprogress_requests(models):
    out = _both(_watchdog, models)
    assert out["port"]["recovered"] == out["reference"]["recovered"]


# ---------------------------------------------------------------------------
# crash-consistent snapshot / restore
# ---------------------------------------------------------------------------
def _snapshot_mid_stream(side, models):
    prompts = _prompts(models[side][0].vocab_size, n=4, seed=6)
    base = _baseline(side, models, prompts)
    eng = _engine(side, models)
    for p in prompts:
        eng.submit(p, 6)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    restored = _restore(side, models, snap)
    assert _auditor(side).check(restored.kv, engine=restored) == []
    assert restored.metrics.submitted == 4
    restored.run(500)
    assert _finished_map(restored) == base
    eng.run(500)
    assert _finished_map(eng) == base
    return {"outcome": _outcome(restored), "original": _outcome(eng),
            "snap": snap}


def test_snapshot_restore_mid_stream_bit_identical(models):
    out = _both(_snapshot_mid_stream, models)
    assert out["port"]["original"] == out["reference"]["original"]
    _same_snapshot(out["reference"]["snap"], out["port"]["snap"])


def test_snapshot_holds_no_tensor(models):
    """A snapshot is a journal record: plain Python and host numpy only,
    nothing tied to a device or to torch."""
    out = _snapshot_mid_stream("port", models)

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(k)
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            assert not isinstance(x, torch.Tensor)
            assert isinstance(x, (np.ndarray, int, float, str, bool,
                                  type(None))), type(x)

    walk(out["snap"])
    assert any(p["data"] is not None
               for p in out["snap"]["kv"]["planes"].values())


def _snapshot_admission_cache(side, models):
    shared = list(range(1, 17))
    prompts = [shared + t for t in _prompts(models[side][0].vocab_size,
                                            n=3, length=6, seed=7)]
    base = _baseline(side, models, prompts, admission=True)
    eng = _engine(side, models, admission=True)
    eng.submit(prompts[0], 6)
    for _ in range(3):
        eng.step()
    for p in prompts[1:]:
        eng.submit(p, 6)
    for _ in range(2):
        eng.step()
    assert eng.kv.prefix_hits > 0
    snap = eng.snapshot()
    restored = _restore(side, models, snap)
    assert _auditor(side).check(restored.kv, engine=restored) == []
    assert restored.admission._admitted == eng.admission._admitted
    assert restored.kv.prefix_hits == eng.kv.prefix_hits
    assert restored.kv.adopted_tokens == eng.kv.adopted_tokens
    restored.run(500)
    assert _finished_map(restored) == base
    return {"outcome": _outcome(restored), "snap": snap}


def test_snapshot_restore_with_admission_and_prefix_cache(models):
    out = _both(_snapshot_admission_cache, models)
    _same_snapshot(out["reference"]["snap"], out["port"]["snap"])
    assert out["port"]["snap"]["kv"]["tree"], "the radix tree was carried"


def _engine_crash(side, models):
    f, e = _mod(side)["faults"], _mod(side)["errs"]
    prompts = _prompts(models[side][0].vocab_size, n=3, seed=8)
    base = _baseline(side, models, prompts)
    fi = f.FaultInjector(seed=0, events=[
        f.FaultEvent(kind="engine_crash", at_step=4)])
    eng = _engine(side, models, faults=fi)
    for p in prompts:
        eng.submit(p, 6)
    snap = eng.snapshot()
    with pytest.raises(e.EngineCrashError):
        for _ in range(500):
            snap = eng.snapshot()
            eng.step()
            if not (eng.waiting or eng.running):
                break
    crash_step = eng.metrics.steps
    restored = _restore(side, models, snap)
    assert _auditor(side).check(restored.kv, engine=restored) == []
    restored.run(500)
    assert _finished_map(restored) == base
    return {"outcome": _outcome(restored), "crash_step": crash_step,
            "snap": snap}


def test_engine_crash_fault_is_recoverable(models):
    out = _both(_engine_crash, models)
    assert out["port"]["crash_step"] == out["reference"]["crash_step"] == 4
    _same_snapshot(out["reference"]["snap"], out["port"]["snap"])


def test_restore_refuses_a_dirty_runtime(models):
    for side in SIDES:
        eng = _engine(side, models)
        eng.submit(_prompts(models[side][0].vocab_size, n=1, seed=9)[0], 4)
        eng.step()
        snap = eng.snapshot()
        with pytest.raises(ValueError, match="FRESH"):
            eng.kv.restore_state(snap["kv"])


def test_restore_refuses_a_payload_of_another_dtype(models):
    """The port's payload carries its dtype's name; a runtime whose planes
    hold another dtype refuses it before writing anything."""
    eng = _engine("port", models)
    eng.submit(_prompts(models["port"][0].vocab_size, n=1, seed=9)[0], 4)
    eng.step()
    snap = eng.snapshot()
    cfg16 = dataclasses.replace(models["port"][0], param_dtype="bfloat16",
                                compute_dtype="bfloat16")
    kv = TRuntime(cfg16, max_seq=64, page_tokens=8, max_running=2,
                  device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        kv.restore_state(snap["kv"])
    assert not any(p.pages for p in kv.planes.values())
    assert all(int((p.aqua.page_table[:, 0] != -1).sum()) == 1
               for p in kv.planes.values())          # scratch only


def test_restore_defaults_to_cuda_and_raises_without_it(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    eng = _engine("port", models)
    eng.submit(_prompts(models["port"][0].vocab_size, n=1, seed=9)[0], 4)
    eng.step()
    cfg, model = models["port"]
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine.restore(cfg, model, eng.snapshot())


def test_bf16_snapshot_round_trip_bit_identical_in_raw_words():
    """A bf16 plane's payload is its raw 16-bit words on the host; a
    restore into a fresh runtime and a second snapshot give the same words,
    block tables and tree."""
    tcfg = dataclasses.replace(t_smoke_config(t_get_config(ARCH)),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = TEngine(tcfg, model, max_running=2, max_seq=64, scheduler="cfs",
                  slice_tokens=4, offload_tier=T.HOST, prefetch=False,
                  device="cpu")
    for p in _prompts(tcfg.vocab_size, n=4, seed=6):
        eng.submit(p, 6)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    plane = snap["kv"]["planes"]["kv"]
    assert plane["dtype"] == "bfloat16" and plane["data"].dtype == np.int16
    assert (plane["data"] != 0).any()
    restored = TEngine.restore(tcfg, model, snap, device="cpu")
    again = restored.snapshot()["kv"]
    kv = snap["kv"]
    for key in ("tree", "req_blocks", "req_seed", "req_registered", "clock",
                "counters"):
        assert again[key] == kv[key], key
    # page ids are remapped on restore: compare each request's pages by
    # position in its tables
    a, b = kv["planes"]["kv"], again["planes"]["kv"]
    assert a["dtype"] == b["dtype"] == "bfloat16"
    pos_a = {lp: i for i, lp in enumerate(a["lps"])}
    pos_b = {lp: i for i, lp in enumerate(b["lps"])}
    assert set(a["pages"]) == set(b["pages"])
    for rid, rows in a["pages"].items():
        for row_a, row_b in zip(rows, b["pages"][rid]):
            assert len(row_a) == len(row_b)
            for la, lb in zip(row_a, row_b):
                np.testing.assert_array_equal(a["data"][pos_a[la]],
                                              b["data"][pos_b[lb]])
    assert sorted(a["fills"]) == sorted(b["fills"])


def test_rwkv_snapshot_restore_mid_stream():
    """rwkv6-3b: both state planes snapshotted mid-stream (equal to the
    reference's snapshot) and restored; the restored port engine finishes
    with the reference engine's tokens."""
    models = _models("rwkv6-3b")

    def case(side, models):
        prompts = _prompts(models[side][0].vocab_size, n=4, seed=6)
        base = _baseline(side, models, prompts)
        eng = _engine(side, models, step_tokens=8)
        for p in prompts:
            eng.submit(p, 6)
        for _ in range(3):
            eng.step()
        snap = eng.snapshot()
        restored = _restore(side, models, snap)
        assert _auditor(side).check(restored.kv, engine=restored) == []
        restored.run(500)
        assert _finished_map(restored) == base
        return {"outcome": _outcome(restored), "snap": snap, "base": base}

    out = _both(case, models)
    snap = out["port"]["snap"]
    assert set(snap["kv"]["planes"]) == {"wkv", "shift"}
    assert all(p["data"] is not None for p in snap["kv"]["planes"].values())
    _same_snapshot(out["reference"]["snap"], snap, STATE_TOL)
    assert out["port"]["base"] == out["reference"]["base"]


# ---------------------------------------------------------------------------
# metrics: explicit right-censoring in the TTFT quantile
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ttft,q,censored", [
    ({}, 0.5, 0), ({0: 1.0, 1: 2.0, 2: 3.0}, 0.5, 0),
    ({0: 1.0, 1: 2.0, 2: 3.0}, 0.99, 3), ({0: 1.0, 1: 2.0, 2: 3.0}, 0.25, 3),
    ({}, 0.5, 4)])
def test_ttft_quantile_censoring(ttft, q, censored):
    want = JMetrics(ttft=dict(ttft)).ttft_quantile(q, censored=censored)
    got = TMetrics(ttft=dict(ttft)).ttft_quantile(q, censored=censored)
    assert (np.isnan(got) and np.isnan(want)) or got == want
    m = TMetrics(ttft={0: 1.0, 1: 2.0, 2: 3.0})
    assert m.ttft_quantile(0.5) == 2.0
    assert m.ttft_quantile(0.99, censored=3) == float("inf")
    assert m.ttft_quantile(0.25, censored=3) == 2.0
    assert np.isnan(TMetrics().ttft_quantile(0.5))
    assert TMetrics().ttft_quantile(0.5, censored=4) == float("inf")


# ---------------------------------------------------------------------------
# engine chaos: random lifecycle ops on both engines in lockstep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_chaos_lifecycle_ops_match_reference(models, seed):
    """The reference's engine chaos loop (step / submit / cancel in any
    state / drain + resume / snapshot-and-swap to a restored engine), one
    seeded op sequence applied to both engines: after every op both
    auditors are clean and both engines hold the same requests in the same
    states with the same tokens; both then run to the end alike."""
    rng = np.random.default_rng(seed)
    vocab = models["port"][0].vocab_size
    engs = {side: _engine(side, models, step_tokens=8) for side in SIDES}
    auditors = {side: _auditor(side) for side in SIDES}

    def state(eng):
        return (sorted((r.rid, tuple(r.generated), r.prefill_pos, r.slot,
                        bool(r.parked)) for r in eng.running),
                sorted((r.rid, tuple(r.generated), r.prefill_pos,
                        bool(r.parked)) for r in eng.waiting),
                sorted((r.rid, r.terminal) for r in eng.finished))

    for i in range(30):
        op = rng.choice(["step", "submit", "cancel", "drain", "snapshot"],
                        p=[0.45, 0.25, 0.15, 0.05, 0.10])
        if op == "submit":
            n = int(rng.integers(4, 16))
            toks = list(map(int, 1 + rng.integers(0, vocab - 1, n)))
            new = int(rng.integers(1, 6))
        elif op == "cancel":
            live = sorted(r.rid for r in engs["port"].waiting
                          + engs["port"].running)
            rid = int(rng.choice(live)) if live else None
        for side in SIDES:
            eng = engs[side]
            if op == "submit":
                eng.submit(toks, new)
            elif op == "cancel" and rid is not None:
                assert eng.cancel(rid)
            elif op == "drain":
                eng.drain()
                eng.resume()
            elif op == "snapshot":
                eng = engs[side] = _restore(side, models, eng.snapshot())
                auditors[side] = _auditor(side)
            elif op == "step":
                eng.step()
            bad = auditors[side].check(eng.kv, engine=eng)
            assert not bad, (seed, i, op, side, bad)
        assert state(engs["port"]) == state(engs["reference"]), (i, op)
    for side in SIDES:
        engs[side].run(500)
        assert not (engs[side].waiting or engs[side].running)
    assert _outcome(engs["port"]) == _outcome(engs["reference"])
