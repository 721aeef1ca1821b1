"""The port's ServingEngine against the JAX reference engine: the same
weights, the same 8 seeded requests, CFS with preemption and a REMOTE donor
lease, each engine priced on its own package's A100 profile (the chunk
budget depends on the profile through ``piggyback_tokens``), for the dense
family (qwen1.5-0.5b, one ``kv`` token plane) and RWKV-6 (rwkv6-3b, the
``wkv`` and ``shift`` state planes). Greedy token streams,
preemption/restore counts and TransferMeter bytes and messages must be
identical. Also: the engine's entry points refuse to run on a
missing GPU by default, and knobs of the reference that the port has not
ported yet (admission, the watchdog, the mesh, ``paged_impl``) are refused,
not ignored."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core.aqua_tensor import REMOTE as J_REMOTE
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import REMOTE as T_REMOTE
from repro_torch.core.aqua_tensor import AquaTensor as TAquaTensor
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import PagedStateRuntime

ARCH = "qwen1.5-0.5b"
KNOBS = dict(max_running=2, max_seq=64, scheduler="cfs", slice_tokens=3,
             step_tokens=16, kv_page_tokens=8)
LEASE = 1 << 22


def _requests():
    rng = np.random.default_rng(11)
    out = []
    for i in range(8):
        n = int(rng.integers(5, 30))
        out.append((list(map(int, rng.integers(0, 512, n))),
                    int(rng.integers(3, 9)), 0.01 * i))
    return out


def _serve(eng):
    reqs = [eng.submit(p, m, arrival=a) for p, m, a in _requests()]
    eng.run(2000)
    meter = eng.pager.meter
    return {"tokens": [list(r.generated) for r in reqs],
            "preemptions": eng.metrics.preemptions,
            "restores": eng.metrics.restores,
            "bytes_fabric": meter.bytes_fabric,
            "messages_fabric": meter.messages_fabric,
            "bytes_host": meter.bytes_host,
            "messages_host": meter.messages_host}


@pytest.fixture(scope="module", params=[ARCH, "rwkv6-3b"])
def served(request):
    arch = request.param
    cfg = smoke_config(get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    jeng = JEngine(cfg, params, offload_tier=J_REMOTE, hw=J_A100,
                   paged_impl="xla", **KNOBS)
    jeng.pager.add_remote_lease("donor0", LEASE)
    ref = _serve(jeng)
    tcfg = t_smoke_config(t_get_config(arch))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tcfg, model, offload_tier=T_REMOTE, hw=T_A100,
                   device="cpu", **KNOBS)
    teng.pager.add_remote_lease("donor0", LEASE)
    return ref, _serve(teng)


def test_engine_greedy_streams_match_reference(served):
    ref, port = served
    assert port["tokens"] == ref["tokens"]
    assert all(len(t) > 0 for t in port["tokens"])


def test_engine_preemption_and_meter_match_reference(served):
    ref, port = served
    assert port["preemptions"] > 0 and port["restores"] > 0
    for key in ("preemptions", "restores", "bytes_fabric", "messages_fabric",
                "bytes_host", "messages_host"):
        assert port[key] == ref[key], key


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = t_smoke_config(t_get_config(ARCH))
    model = tlm.LM(cfg, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(cfg, torch.Generator())


@pytest.mark.parametrize("entry", ["from_jax", "aqua_tensor", "runtime"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    """Carried-over weights, an AquaTensor and the paged runtime built
    without naming a device land on CUDA, never quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = t_smoke_config(t_get_config(ARCH))
    build = {
        "from_jax": lambda: from_jax({}, cfg),
        "aqua_tensor": lambda: TAquaTensor(n_logical=4, page_shape=(2, 8),
                                           local_slots=2, host_slots=2),
        "runtime": lambda: PagedStateRuntime(cfg, max_seq=32),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


@pytest.mark.parametrize("knob", [
    dict(admission=True), dict(watchdog_steps=3), dict(mesh=object()),
    dict(paged_impl="ref")])
def test_engine_refuses_unported_knobs(knob):
    cfg = t_smoke_config(t_get_config(ARCH))
    model = tlm.LM(cfg, torch.device("cpu"))
    with pytest.raises(TypeError):
        TEngine(cfg, model, device="cpu", **knob)


def test_engine_fcfs_serves_everything_without_preemption():
    cfg = t_smoke_config(t_get_config(ARCH))
    model = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = TEngine(cfg, model, device="cpu", **{**KNOBS, "scheduler": "fcfs"})
    reqs = [eng.submit(p, m, arrival=a) for p, m, a in _requests()]
    m = eng.run(2000)
    assert all(r.done for r in reqs) and len(eng.finished) == len(reqs)
    assert m.preemptions == 0
