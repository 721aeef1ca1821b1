"""Faults and recovery in the port against the JAX reference: the typed
errors, allocation and plane-boundary rollbacks, transfer-leg retries under
a seeded ``FaultInjector``, lease shrink with live migration, donor loss
into the LOST tier, the ``InvariantAuditor``, a seeded runtime chaos loop,
and the engine's recovery.

Each tensor- and runtime-level case runs the same operations on both
packages (the port on the CPU, its own copy of ``core/faults.py``) and
requires identical page tables, free lists, refcounts, TransferMeter
totals (bytes, messages, retries, the analytic clock) and bit-equal
payloads. The engine cases serve the same seeded requests on both engines,
each priced on its own package's A100 profile, under the same fault
schedule: donor loss at the first step after which pages sit on the donor
(found by a probe run), a lease shrink at that step, and transient leg
faults at rate 0.3. Greedy tokens, the fault metrics and the meter
(bytes, messages, retries and its clock) must be equal, and the tokens
equal to the fault-free run's. (The engines' step clocks differ by the
compute pricing of the port's trimmed perf model, so only the meter's
clock is compared across packages.) A ``cancel`` and an
``engine_crash`` event in one schedule tear down the same request and
crash at the same step on both engines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core import aqua_tensor as J
from repro.core import errors as j_errs
from repro.core import faults as j_faults
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core import aqua_tensor as T
from repro_torch.core import errors as errs
from repro_torch.core import faults as t_faults
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime

ARCH = "qwen1.5-0.5b"
METER_KEYS = ("bytes_fabric", "bytes_host", "messages_fabric",
              "messages_host", "retries_fabric", "retries_host", "sim_time")


def _pair(faults=None, **kw):
    """(reference, port) AquaTensors, float32 pages of 4, the A100 meter;
    ``faults(module)`` builds each side's injector."""
    args = dict(n_logical=64, page_shape=(4,), local_slots=8, host_slots=8)
    args.update(kw)
    j = J.AquaTensor(dtype=jnp.float32, meter=J.TransferMeter(hw=J_A100),
                     faults=faults(j_faults) if faults else None, **args)
    t = T.AquaTensor(dtype=torch.float32, meter=T.TransferMeter(hw=T_A100),
                     faults=faults(t_faults) if faults else None,
                     device="cpu", **args)
    return j, t


def _same_tensor(j, t):
    np.testing.assert_array_equal(t.page_table, j.page_table)
    np.testing.assert_array_equal(t.page_refs, j.page_refs)
    assert t._free_local == j._free_local
    assert t._free_host == j._free_host
    assert t._remote_free == j._remote_free
    assert t.remote_capacity == j.remote_capacity
    assert t.tier_counts() == j.tier_counts()
    for key in METER_KEYS:
        assert getattr(t.meter, key) == getattr(j.meter, key), key


def _same_payload(j, t, lps):
    np.testing.assert_array_equal(t.read(lps).numpy(),
                                  np.asarray(j.read(lps)))


def _both(j, t, op, *args, **kw):
    """Call ``op`` on both; they must both return equal values or both
    raise the same error class."""
    out = []
    for x in (j, t):
        try:
            out.append(("ok", getattr(x, op)(*args, **kw)))
        except (MemoryError, errs.AquaError, j_errs.AquaError) as e:
            out.append(("raise", type(e).__name__))
    (jk, jv), (tk, tv) = out
    assert jk == tk and (jk == "raise" and jv == tv or jk == "ok"), out
    if jk == "ok" and jv is not None:
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
    _same_tensor(j, t)
    return out


# ---------------------------------------------------------------------------
# typed error hierarchy
# ---------------------------------------------------------------------------
def test_error_hierarchy():
    for sub in (errs.PageLossError, errs.LeaseRevokedError,
                errs.TransferFaultError, errs.SchedulingInvariantError,
                errs.InvariantViolation, errs.CapacityError,
                errs.CancelledError, errs.EngineCrashError):
        assert issubclass(sub, errs.AquaError)
        assert issubclass(sub, RuntimeError)
        assert sub.__name__ in vars(j_errs)
    e = errs.PageLossError("gone", plane="kv", pages=[3, 4])
    assert e.plane == "kv" and e.pages == (3, 4)
    v = errs.InvariantViolation(["a", "b"])
    assert v.violations == ("a", "b") and "a" in str(v)


# ---------------------------------------------------------------------------
# rollbacks
# ---------------------------------------------------------------------------
def test_allocate_rollback_when_tiers_exhaust_midway():
    j, t = _pair(local_slots=3, host_slots=2)     # 5 physical slots total
    assert _both(j, t, "allocate", 6)[1] == ("raise", "MemoryError")
    assert (t.page_table[:, 0] == -1).all() and (t.page_refs == 0).all()
    _both(j, t, "allocate", 5)


def _runtimes(arch, **kw):
    cfg = smoke_config(get_config(arch))
    tcfg = t_smoke_config(t_get_config(arch))
    return (JRuntime(cfg, meter=J.TransferMeter(hw=J_A100), **kw),
            TRuntime(tcfg, meter=T.TransferMeter(hw=T_A100), device="cpu",
                     **kw))


def _same_runtime(jkv, tkv):
    assert list(tkv.planes) == list(jkv.planes)
    for name in jkv.planes:
        jp, tp = jkv.planes[name], tkv.planes[name]
        np.testing.assert_array_equal(tp.aqua.page_table, jp.aqua.page_table)
        np.testing.assert_array_equal(tp.aqua.page_refs, jp.aqua.page_refs)
        assert tp.aqua._free_local == jp.aqua._free_local
        assert tp.aqua._free_host == jp.aqua._free_host
        assert tp.aqua._remote_free == jp.aqua._remote_free
        assert tp.aqua.remote_capacity == jp.aqua.remote_capacity
        assert tp.pages == jp.pages and tp.pin == jp.pin
    assert tkv._active == jkv._active
    assert tkv.stats()["tiers"] == jkv.stats()["tiers"]
    for key in METER_KEYS:
        assert getattr(tkv.meter, key) == getattr(jkv.meter, key), key


@pytest.mark.parametrize("arch,plane_idx", [
    ("qwen1.5-0.5b", 0), ("rwkv6-3b", 0), ("rwkv6-3b", 1)])
def test_ensure_capacity_rollback_at_each_plane_boundary(arch, plane_idx):
    """Exhaust plane ``plane_idx``'s LOCAL pool (its only tier) so the
    grow fails there: every page an earlier plane took is handed back, on
    both packages alike, and the same grow succeeds after the drain."""
    runtimes = _runtimes(arch, max_seq=64, page_tokens=8, max_running=2,
                         host_pages=0)
    drained = []
    for kv in runtimes:
        victim = list(kv.planes.values())[plane_idx]
        snap = {n: p.aqua.tier_counts() for n, p in kv.planes.items()}
        drained.append(victim.aqua.allocate(victim.aqua.local_free))
        with pytest.raises(MemoryError):
            kv.ensure_capacity(7, 40)
        assert all(7 not in p.pages for p in kv.planes.values())
        for n, p in kv.planes.items():
            want = dict(snap[n])
            if p is victim:
                want["local"] += len(drained[-1])
            assert p.aqua.tier_counts() == want
    _same_runtime(*runtimes)
    for kv, lps, mod in zip(runtimes, drained, (j_faults, t_faults)):
        list(kv.planes.values())[plane_idx].aqua.free(lps)
        kv.ensure_capacity(7, 40)
        assert mod.InvariantAuditor().check(kv) == []
        kv.release(7)
    _same_runtime(*runtimes)


def test_make_writable_clone_rollback_frees_the_clone():
    jkv, tkv = _runtimes(ARCH, max_seq=64, page_tokens=8, max_running=2,
                         host_pages=64)
    toks = list(range(100, 109))                 # 9 tokens: one full page
    fillers = []
    for kv in (jkv, tkv):
        kv.adopt_prefix(1, toks)
        kv.ensure_capacity(1, 9)
        kv.register_prefix(1, 9)
        assert kv.adopt_prefix(2, toks) == 8     # page 0 now shared
        kv.ensure_capacity(2, 9)
        plane = kv.planes["kv"]
        fillers.append(plane.aqua.allocate(plane.aqua.local_free))
        before = plane.aqua.tier_counts()
        with pytest.raises(MemoryError):
            kv.make_writable(2, 0, 9)            # the clone would spill
        assert plane.aqua.tier_counts() == before, "spilled clone leaked"
    _same_runtime(jkv, tkv)
    for kv, filler in zip((jkv, tkv), fillers):
        kv.planes["kv"].aqua.free(filler)
        kv.make_writable(2, 0, 9)
        assert kv.cow_copies > 0
    _same_runtime(jkv, tkv)


# ---------------------------------------------------------------------------
# transient transfer-leg faults
# ---------------------------------------------------------------------------
def _payload(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)


def _write(j, t, lps, a):
    j.write_local(lps, jnp.asarray(a))
    t.write_local(lps, torch.from_numpy(a))


def test_leg_retry_converges_and_prices_backoff():
    j, t = _pair(lambda m: m.FaultInjector(seed=11, leg_fault_rate=0.8,
                                           max_consecutive=2))
    clean = T.AquaTensor(n_logical=64, page_shape=(4,), local_slots=8,
                         host_slots=8, dtype=torch.float32,
                         meter=T.TransferMeter(hw=T_A100), device="cpu")
    lps = _both(j, t, "allocate", 6)[1][1]
    a = _payload(6)
    _write(j, t, lps, a)
    clean.allocate(6)
    clean.write_local(lps, torch.from_numpy(a))
    for x in (j, t, clean):
        x.offload(lps, prefer=T.HOST)
        x.ensure_local(lps)
    _same_tensor(j, t)
    _same_payload(j, t, lps)
    np.testing.assert_array_equal(t.read(lps).numpy(), a)
    assert t.meter.retries_host > 0
    assert t.faults.leg_faults_injected == t.meter.retries_host
    assert t.meter.sim_time > clean.meter.sim_time
    assert t.meter.messages_host == clean.meter.messages_host


def test_leg_guard_raises_past_retry_budget():
    j, t = _pair(lambda m: m.FaultInjector(
        seed=0, leg_fault_rate=1.0, max_consecutive=10, max_leg_retries=2))
    lps = _both(j, t, "allocate", 2)[1][1]
    _write(j, t, lps, np.zeros((2, 4), np.float32))
    with pytest.raises(errs.TransferFaultError) as ei:
        t.offload(lps, prefer=T.HOST)
    assert ei.value.attempts == 2 and ei.value.tier == T.HOST
    with pytest.raises(j_errs.TransferFaultError):
        j.offload(lps, prefer=J.HOST)
    _same_tensor(j, t)                           # rolled back alike


def test_fault_injection_is_seed_deterministic_and_matches_reference():
    def draws(mod, seed, rate=0.5, **kw):
        f = mod.FaultInjector(seed=seed, leg_fault_rate=rate, **kw)
        return [f.leg_fails(T.REMOTE, "d0") for _ in range(32)]

    assert draws(t_faults, 7) == draws(t_faults, 7) == draws(j_faults, 7)
    assert draws(t_faults, 7) != draws(t_faults, 8)
    run = draws(t_faults, 3, rate=1.0, max_consecutive=3)
    assert max(len(s) for s in
               "".join("T" if x else "F" for x in run).split("F")) <= 3
    events = [dict(kind="donor_loss", donor="d0", at_step=4),
              dict(kind="lease_shrink", donor="d1", frac=0.5, at_time=0.2)]
    for mod in (t_faults, j_faults):
        f = mod.FaultInjector(events=[mod.FaultEvent(**e) for e in events])
        assert f.due_events(step=3) == []
        assert [e.kind for e in f.due_events(step=4, now=0.3)] == [
            "donor_loss", "lease_shrink"]
        assert f.due_events(step=9, now=9.0) == []


# ---------------------------------------------------------------------------
# lease shrink: live migration off the shrinking donor
# ---------------------------------------------------------------------------
def test_shrink_lease_migrates_excluding_the_shrinking_donor():
    j, t = _pair(local_slots=4, host_slots=16)
    _both(j, t, "add_remote_lease", "d0", 8)
    _both(j, t, "add_remote_lease", "d1", 8)
    lps = _both(j, t, "allocate", 8, prefer=T.REMOTE)[1][1]
    assert (t.page_table[lps, 2] == 0).all()     # d0 full
    assert _both(j, t, "shrink_lease", "d0", 4)[1][1] == 4
    assert t.remote_capacity["d0"] == 4
    on_d0 = [lp for lp in lps
             if t.page_table[lp, 0] == T.REMOTE and t.page_table[lp, 2] == 0]
    assert len(on_d0) == 4 and all(t.page_table[lp, 1] < 4 for lp in on_d0)
    _both(j, t, "shrink_lease", "d0", 4)         # to zero: the lease drops
    assert "d0" not in t.remote_pools and "d0" not in t.remote_capacity
    assert _both(j, t, "shrink_lease", "d0", 1)[1] == (
        "raise", "LeaseRevokedError")


def test_shrink_preserves_payload_bits():
    j, t = _pair(local_slots=8, host_slots=16)
    _both(j, t, "add_remote_lease", "d0", 8)
    _both(j, t, "add_remote_lease", "d1", 8)
    lps = _both(j, t, "allocate", 8)[1][1]
    a = _payload(8, seed=5)
    _write(j, t, lps, a)
    _both(j, t, "offload", lps, prefer=T.REMOTE)
    _both(j, t, "shrink_lease", "d0", 8)
    _both(j, t, "ensure_local", lps)
    _same_payload(j, t, lps)
    np.testing.assert_array_equal(t.read(lps).numpy(), a)


# ---------------------------------------------------------------------------
# donor loss: the LOST tier
# ---------------------------------------------------------------------------
def test_fail_donor_marks_lost_and_every_touch_raises():
    j, t = _pair(lambda m: m.FaultInjector(seed=0))
    _both(j, t, "add_remote_lease", "d0", 8)
    lps = _both(j, t, "allocate", 4)[1][1]
    _write(j, t, lps, np.ones((4, 4), np.float32))
    _both(j, t, "offload", lps, prefer=T.REMOTE)
    lost = _both(j, t, "fail_donor", "d0")[1][1]
    assert sorted(map(int, lost)) == sorted(map(int, lps))
    assert (t.page_table[lps, 0] == T.LOST).all()
    assert t.tier_counts()["lost"] == 4 and t.faults.donor_lost("d0")
    for op in (lambda: t.read(lps), lambda: t.ensure_local(lps),
               lambda: t.block_tables([list(lps)], pad_to=8),
               lambda: t.offload(lps, prefer=T.HOST)):
        with pytest.raises(errs.PageLossError):
            op()
    assert _both(j, t, "add_remote_lease", "d0", 8)[1] == (
        "raise", "LeaseRevokedError")
    _both(j, t, "free", lps)
    assert (t.page_table[lps, 0] == -1).all()
    assert "lost" not in t.tier_counts()


# ---------------------------------------------------------------------------
# invariant auditor
# ---------------------------------------------------------------------------
def test_auditor_green_then_detects_seeded_corruption():
    jkv, tkv = _runtimes(ARCH, max_seq=64, page_tokens=8, max_running=2)
    for kv in (jkv, tkv):
        kv.ensure_capacity(1, 20)
        kv.ensure_capacity(2, 12)
    _same_runtime(jkv, tkv)
    auditor = t_faults.InvariantAuditor()
    assert auditor.check(tkv) == []
    auditor.audit(tkv)
    plane = tkv.planes["kv"]
    lp = int(plane.pages[1][0][0])
    for kv in (jkv, tkv):
        kv.planes["kv"].aqua.page_refs[lp] += 1  # a phantom reference
    assert auditor.check(tkv) == j_faults.InvariantAuditor().check(jkv)
    with pytest.raises(errs.InvariantViolation):
        auditor.audit(tkv)
    plane.aqua.page_refs[lp] -= 1
    assert auditor.check(tkv) == []
    plane.aqua._free_local.append(int(plane.aqua.page_table[lp, 1]))
    assert any("free" in v or "occupancy" in v for v in auditor.check(tkv))
    assert auditor.audits == 6


# ---------------------------------------------------------------------------
# chaos: seeded random op interleavings, both packages in lockstep
# ---------------------------------------------------------------------------
def _chaos_round(seed, n_ops=80):
    rng = np.random.default_rng(seed)
    jkv, tkv = _runtimes(ARCH, max_seq=64, page_tokens=8, max_running=2)
    sides = ((jkv, j_faults), (tkv, t_faults))
    for kv, mod in sides:
        kv.attach_faults(mod.FaultInjector(seed=seed, leg_fault_rate=0.05))
        page_bytes = kv.planes["kv"].aqua.page_bytes
        kv.add_remote_lease("d0", 64 * page_bytes)
        kv.add_remote_lease("d1", 64 * page_bytes)
    auditor = t_faults.InvariantAuditor()
    fam = [list(map(int, rng.integers(0, 50, 60))) for _ in range(3)]
    live, parked, next_rid = {}, set(), 0
    ops = []

    def each(fn):
        """Run ``fn(kv)`` on both sides: same result or same error."""
        out = []
        for kv, _ in sides:
            try:
                out.append(("ok", fn(kv)))
            except (MemoryError, errs.LeaseRevokedError, errs.PageLossError,
                    j_errs.LeaseRevokedError, j_errs.PageLossError) as e:
                out.append(("raise", type(e).__name__))
        assert out[0] == out[1], (seed, ops, out)
        if out[1][0] == "raise":
            raise MemoryError(out[1][1])         # legal under chaos
        return out[1][1]

    for _ in range(n_ops):
        op = str(rng.choice(["grow", "park", "restore", "release", "shrink",
                             "fail"], p=[0.35, 0.2, 0.2, 0.15, 0.07, 0.03]))
        ops.append(op)
        try:
            if op == "grow":
                rid = (int(rng.choice(list(live)))
                       if live and rng.random() < 0.5 else next_rid)
                if rid == next_rid:
                    next_rid += 1
                    base = fam[int(rng.integers(len(fam)))]
                    prompt = list(base)
                    if rng.random() < 0.4:       # mid-prompt divergence
                        cut = int(rng.integers(8, 60))
                        prompt = base[:cut] + [x + 1 for x in base[cut:]]
                    live[rid] = 0
                    live[rid] = each(lambda kv: kv.adopt_prefix(rid, prompt))
                if rid in parked:
                    each(lambda kv: kv.restore(rid))
                    parked.discard(rid)
                tok = min(live[rid] + int(rng.integers(1, 12)), 60)
                each(lambda kv: kv.ensure_capacity(rid, tok))
                live[rid] = tok
                each(lambda kv: kv.register_prefix(rid, tok))
            elif op == "park" and live:
                rid = int(rng.choice([r for r in live if r not in parked]
                                     or list(live)))
                if rid not in parked and live[rid] > 0:
                    prefer = T.REMOTE if rng.random() < 0.7 else T.HOST
                    each(lambda kv: kv.park(rid, live[rid], prefer=prefer))
                    parked.add(rid)
            elif op == "restore" and parked:
                rid = int(rng.choice(sorted(parked)))
                if each(lambda kv: kv.can_restore(rid)):
                    each(lambda kv: kv.restore(rid))
                    parked.discard(rid)
            elif op == "release" and live:
                rid = int(rng.choice(sorted(live)))
                each(lambda kv: kv.release(rid))
                live.pop(rid)
                parked.discard(rid)
            elif op == "shrink":
                donor = str(rng.choice(["d0", "d1"]))
                frac = float(rng.uniform(0.2, 0.8))
                if any(donor in p.aqua.remote_pools
                       for p in tkv.planes.values()):
                    each(lambda kv: kv.shrink_lease(donor, frac))
            elif op == "fail":
                donor = str(rng.choice(["d0", "d1"]))
                for rid in each(lambda kv: kv.fail_donor(donor)):
                    each(lambda kv: kv.release(rid))
                    live.pop(rid, None)
                    parked.discard(rid)
        except MemoryError:
            pass
        _same_runtime(jkv, tkv)
        violations = auditor.check(tkv)
        assert not violations, (seed, op, violations)
    for rid in list(live):
        each(lambda kv: kv.release(rid))
    _same_runtime(jkv, tkv)
    assert auditor.check(tkv) == []
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_interleavings_keep_every_invariant(seed):
    ops = _chaos_round(seed)
    assert {"grow", "park", "release"} <= set(ops)


# ---------------------------------------------------------------------------
# the engines under one fault schedule
# ---------------------------------------------------------------------------
def _engine_prompts(vocab, n=3, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, length)))
            for _ in range(n)]


def _build(side, models, prompts, faults=None, audit=False):
    """The reference's fault-test engine: LOCAL sized for one request, two
    lanes, CFS parking on a 16 MiB REMOTE lease, no prefetch, no sharing."""
    cfg, params, tcfg, model = models
    kw = dict(max_running=2, max_seq=64, scheduler="cfs", slice_tokens=3,
              faults=faults, audit=audit, prefetch=False)
    rt = dict(max_seq=64, page_tokens=8, max_running=1, prefix_sharing=False)
    if side == "reference":
        kv = JRuntime(cfg, meter=J.TransferMeter(hw=J_A100), **rt)
        eng = JEngine(cfg, params, offload_tier=J.REMOTE, hw=J_A100,
                      paged_impl="xla", kv=kv, **kw)
    else:
        kv = TRuntime(tcfg, meter=T.TransferMeter(hw=T_A100), device="cpu",
                      **rt)
        eng = TEngine(tcfg, model, offload_tier=T.REMOTE, hw=T_A100, kv=kv,
                      device="cpu", **kw)
    eng.pager.add_remote_lease("d0", 2 ** 24)
    for p in prompts:
        eng.submit(p, 6)
    return eng


def _outcome(eng):
    m, meter = eng.metrics, eng.pager.meter
    return {"tokens": {tuple(r.prompt_tokens): list(r.generated)
                       for r in eng.finished},
            "metrics": {k: getattr(m, k) for k in (
                "steps", "preemptions", "restores", "leg_retries",
                "donor_losses", "lease_shrinks", "migrated_pages",
                "recomputes", "recovered_rids")},
            # the analytic step clock: the port prices compute with its own
            # trimmed perf model, so only the meter's clock is compared
            "sim_time": m.sim_time,
            "meter": {k: getattr(meter, k) for k in METER_KEYS},
            "audits": (eng.auditor.audits if eng.auditor is not None
                       else None),
            "budget": np.asarray(eng.sched.page_budget).tolist(),
            "tiers": eng.kv.stats()["tiers"]}


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


@pytest.fixture(scope="module")
def fault_runs(models):
    """Both engines: fault-free, donor loss at the probed step, lease
    shrink (frac 1.0) at that step, and (other prompts) fault-free and
    transient leg faults at rate 0.3."""
    prompts = _engine_prompts(models[0].vocab_size)
    prompts1 = _engine_prompts(models[0].vocab_size, seed=1)
    probe = _build("port", models, prompts)
    hit = None
    for _ in range(200):
        if not (probe.waiting or probe.running):
            break
        probe.step()
        if probe.kv.stats()["tiers"].get("remote", 0) > 0:
            hit = probe.metrics.steps
            break
    assert hit is not None, "CFS under page pressure must park remotely"
    schedules = {
        "clean": (prompts, None),
        "donor_loss": (prompts, lambda m: m.FaultInjector(seed=3, events=[
            m.FaultEvent(kind="donor_loss", donor="d0", at_step=hit)])),
        "lease_shrink": (prompts, lambda m: m.FaultInjector(seed=5, events=[
            m.FaultEvent(kind="lease_shrink", donor="d0", frac=1.0,
                         at_step=hit)])),
        "clean1": (prompts1, None),
        "transient": (prompts1, lambda m: m.FaultInjector(
            seed=9, leg_fault_rate=0.3)),
    }
    out = {}
    for name, (ps, mk) in schedules.items():
        for side, mod in (("reference", j_faults), ("port", t_faults)):
            eng = _build(side, models, ps, faults=mk(mod) if mk else None,
                         audit=mk is not None)
            eng.run(500)
            out[name, side] = _outcome(eng)
    return out


@pytest.mark.parametrize("schedule", ["clean", "donor_loss", "lease_shrink",
                                      "clean1", "transient"])
def test_engine_faults_match_reference(fault_runs, schedule):
    port, ref = fault_runs[schedule, "port"], fault_runs[schedule, "reference"]
    assert port["tokens"] == ref["tokens"]
    assert port["metrics"] == ref["metrics"]
    assert port["meter"] == ref["meter"]
    assert port["budget"] == ref["budget"]
    assert port["tiers"] == ref["tiers"]
    assert port["audits"] == ref["audits"]


def test_engine_recovers_from_donor_loss_and_lease_shrink_bit_identical(
        fault_runs):
    base = fault_runs["clean", "port"]
    assert len(base["tokens"]) == 3
    loss = fault_runs["donor_loss", "port"]
    m = loss["metrics"]
    assert m["donor_losses"] == 1 and m["recomputes"] > 0
    assert m["recovered_rids"]
    assert loss["tokens"] == base["tokens"], "recompute must regenerate"
    assert loss["audits"] == m["steps"]
    assert "lost" not in loss["tiers"]
    shrink = fault_runs["lease_shrink", "port"]
    m2 = shrink["metrics"]
    assert m2["lease_shrinks"] == 1 and m2["migrated_pages"] > 0
    assert m2["recomputes"] == 0
    assert shrink["tokens"] == base["tokens"], "migration keeps the KV"


def test_engine_transient_leg_faults_priced_not_fatal(fault_runs):
    base, got = fault_runs["clean1", "port"], fault_runs["transient", "port"]
    assert got["tokens"] == base["tokens"]
    assert got["metrics"]["leg_retries"] > 0
    assert got["sim_time"] > base["sim_time"]
    assert got["meter"]["messages_fabric"] == base["meter"]["messages_fabric"]


def test_engine_lifecycle_fault_events_match_reference(models):
    """One schedule holding a ``cancel`` and an ``engine_crash`` event on
    both engines: the same request torn down at the same step, the same
    crash step, the same tokens for the rest and the same meter."""
    prompts = _engine_prompts(models[0].vocab_size)
    out = {}
    for side, mod, err in (("reference", j_faults, j_errs.EngineCrashError),
                           ("port", t_faults, errs.EngineCrashError)):
        fi = mod.FaultInjector(seed=0, events=[
            mod.FaultEvent(kind="cancel", rid=1, at_step=2),
            mod.FaultEvent(kind="engine_crash", at_step=5)])
        eng = _build(side, models, prompts, faults=fi)
        with pytest.raises(err, match="step 5"):
            eng.run(500)
        r1 = next(r for r in eng.finished if r.rid == 1)
        assert r1.terminal == "cancelled" and r1.cancel_reason == "fault"
        assert r1.finish_step == 2
        out[side] = {"crash_step": eng.metrics.steps,
                     "cancelled": eng.metrics.cancelled,
                     "tokens": [list(r.generated) for r in sorted(
                         eng.running + eng.waiting + eng.finished,
                         key=lambda r: r.rid)],
                     "meter": {k: getattr(eng.pager.meter, k)
                               for k in METER_KEYS}}
    assert out["port"] == out["reference"]
    assert out["port"]["crash_step"] == 5 and out["port"]["cancelled"] == 1
