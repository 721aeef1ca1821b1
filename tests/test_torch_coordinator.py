"""The port's AQUA coordinator, control-loop informers and the engine's
coordinator hook against the JAX reference.

The coordinator and the informers are numpy-free copies: each protocol
scenario of the reference's ``test_aqua_core.py`` runs on both packages'
classes and must give the same grants, pending reclaims, reclaim statuses
and informer decisions. Elastic reclaim (the reference's
``test_serving.py`` case): a coordinator-granted engine has its donor
reclaimed mid-serve; the port's greedy tokens must equal the port's
fault-free run and the reference engine's under the same reclaim step,
with the remote tier drained to 0, the reclaim honoured and the same
TransferMeter bytes and messages as the reference.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config, smoke_config
from repro.core import control_loop as j_loop
from repro.core import coordinator as j_coord
from repro.core.aqua_tensor import REMOTE as J_REMOTE
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core import control_loop as t_loop
from repro_torch.core import coordinator as t_coord
from repro_torch.core.aqua_tensor import REMOTE as T_REMOTE
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine

PACKAGES = {"reference": (j_coord, j_loop), "port": (t_coord, t_loop)}


def _both(scenario):
    """Run ``scenario(coordinator_module, loop_module)`` on both packages;
    their transcripts must agree. Returns the port's."""
    out = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert out["port"] == out["reference"]
    return out["port"]


def _decision(d):
    return (d.delta_bytes, d.donate, d.reclaim)


def test_coordinator_lease_allocate_reclaim_cycle():
    def run(cm, _):
        c = cm.Coordinator(strict_pairing=False)
        c.offer("gpu0", 30e9)
        log = [c.allocate("gpu1", 10e9)]
        c.request_reclaim("gpu0")
        log += [c.pending_reclaims("gpu1"), c.reclaim_status("gpu0")]
        c.free("gpu1", "gpu0", 10e9)
        return log + [c.reclaim_status("gpu0"), c.stats()]
    log = _both(run)
    assert log[:4] == [[("gpu0", 10e9)], ["gpu0"], False, True]


def test_coordinator_strict_pairing_routes_to_matched_producer():
    def run(cm, _):
        c = cm.Coordinator(strict_pairing=True)
        c.set_pairing({"llm0": "sd0"})
        c.offer("sd0", 20e9)
        c.offer("sd1", 40e9)                  # bigger, but not the match
        return [c.allocate("llm0", 5e9), c.allocate("other", 50e9),
                c.stats()]
    log = _both(run)
    assert log[0] == [("sd0", 5e9)]
    assert log[1] == [("sd1", 40e9), ("sd0", 10e9)]


def test_coordinator_falls_back_to_empty_when_no_producers():
    assert _both(lambda cm, _: cm.Coordinator().allocate("llm0", 5e9)) == []


def test_llm_informer_donates_then_reclaims():
    def run(cm, lm):
        c = cm.Coordinator(strict_pairing=False)
        inf = lm.LLMInformer("llm0", c, total_bytes=40e9, reserve_bytes=5e9,
                             low_rate=2.0, high_rate=4.0, window=2)
        log = [_decision(inf.inform_stats(pending_requests=1,
                                          kv_utilization=0.1)),
               c.allocate("peer", 1e9),
               _decision(inf.inform_stats(pending_requests=50,
                                          kv_utilization=0.9))]
        c.free("peer", "llm0", 1e9)
        log.append(_decision(inf.inform_stats(pending_requests=50,
                                              kv_utilization=0.9)))
        return log + [c.stats()]
    log = _both(run)
    assert log[0] == (-35e9, True, False)
    assert log[1] == [("llm0", 1e9)]
    assert log[2] == (0.0, False, True)
    assert log[3] == (35e9, False, True)


def test_batch_informer_donates_non_working_set():
    def run(cm, lm):
        c = cm.Coordinator(strict_pairing=False)
        inf = lm.BatchInformer("sd0", c, total_bytes=80e9,
                               working_set_bytes=50e9)
        return [_decision(inf.inform_stats()), _decision(inf.inform_stats()),
                c.stats()]
    log = _both(run)
    assert log[0] == (-30e9, True, False)
    assert log[1] == (0.0, False, False)


# ---------------------------------------------------------------------------
# elastic reclaim mid-serve
# ---------------------------------------------------------------------------
ARCH = "qwen1.5-0.5b"
RECLAIM_AT = 10
LEASE = 1 << 22
KNOBS = dict(max_running=2, max_seq=96, scheduler="cfs", slice_tokens=3,
             name="llm0")


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [list(map(int, rng.integers(0, vocab, 8))) for _ in range(5)]


def _serve(eng, coord, prompts, reclaim):
    reqs = [eng.submit(p, 8) for p in prompts]
    if reclaim:
        for _ in range(RECLAIM_AT):
            eng.step()
        remote_before = eng.kv.stats()["tiers"]["remote"]
        coord.request_reclaim("producer0")
    else:
        remote_before = None
    m = eng.run(500)
    meter = eng.pager.meter
    return {"tokens": [list(r.generated) for r in reqs],
            "finished": len(eng.finished),
            "remote_before": remote_before,
            "remote_after": eng.kv.stats()["tiers"]["remote"],
            "reclaimed": coord.reclaim_status("producer0"),
            "grants": coord.stats(),
            "steps": m.steps,
            "meter": (meter.bytes_fabric, meter.messages_fabric,
                      meter.bytes_host, meter.messages_host)}


@pytest.fixture(scope="module")
def reclaim_runs():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    out = {}
    jc = j_coord.Coordinator(strict_pairing=False)
    jc.offer("producer0", LEASE)
    jeng = JEngine(cfg, params, offload_tier=J_REMOTE, hw=J_A100,
                   paged_impl="xla", coordinator=jc, want_remote_bytes=LEASE,
                   respond_every=1, **KNOBS)
    out["reference"] = _serve(jeng, jc, prompts, reclaim=True)
    for name, reclaim in (("port", True), ("port_fault_free", False)):
        tc = t_coord.Coordinator(strict_pairing=False)
        tc.offer("producer0", LEASE)
        teng = TEngine(tcfg, model, offload_tier=T_REMOTE, hw=T_A100,
                       coordinator=tc, want_remote_bytes=LEASE,
                       respond_every=1, device="cpu", **KNOBS)
        out[name] = _serve(teng, tc, prompts, reclaim=reclaim)
    return out


def test_elastic_reclaim_mid_serve_preserves_correctness(reclaim_runs):
    port, ref = reclaim_runs["port"], reclaim_runs["reference"]
    assert port["remote_before"] > 0, "the reclaim must find parked pages"
    assert port["reclaimed"] and port["remote_after"] == 0
    assert port["finished"] == 5
    assert port["tokens"] == reclaim_runs["port_fault_free"]["tokens"]
    assert port["tokens"] == ref["tokens"]
    assert all(len(t) == 8 for t in port["tokens"])


def test_elastic_reclaim_meter_and_grants_match_reference(reclaim_runs):
    port, ref = reclaim_runs["port"], reclaim_runs["reference"]
    for key in ("remote_before", "remote_after", "reclaimed", "grants",
                "steps", "meter"):
        assert port[key] == ref[key], key
    # the evacuation is metered: the reclaimed run moved more host bytes
    assert port["meter"][2] > reclaim_runs["port_fault_free"]["meter"][2]
