"""The port's performance model (``repro_torch/core/perfmodel.py``) against
the JAX reference's ``repro/core/perfmodel.py``.

  * Every function and method, port against reference, on every profile
    of the port's ``PROFILES`` (the reference side is handed the same
    constants as its own ``HardwareProfile``): exact float64 equality.
  * ``ModelCost.from_config`` for every config both packages have: every
    field, in the reference's order, equal.
  * ``fit_link_model`` on noisy ``alpha + s / B`` samples within 1e-9 of
    the reference's fit, and its ``None`` cases; ``calibrate_profile``'s
    identity return and its ``-calibrated`` name.
  * ``H100_SXM`` keeps its datasheet values and stays the engine's default,
    and the engine's simulated clock (``EngineMetrics.sim_time``, the
    meter's) is what it was before ``ModelCost`` gained its state and plane
    fields, for qwen1.5-0.5b, rwkv6-3b and jamba-v0.1-52b smoke runs.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs, load_all as j_load_all
from repro.core import perfmodel as J
from repro_torch.configs import get_config, load_all, smoke_config
from repro_torch.configs.base import _REGISTRY
from repro_torch.core import perfmodel as T
from repro_torch.models import lm
from repro_torch.serving import engine as engine_mod

j_load_all()
load_all()
SHARED = sorted(set(list_archs()) & set(_REGISTRY))
PROFILE_NAMES = sorted(T.PROFILES)
COST_FIELDS = ("n_params", "kv_bytes_per_token", "dtype_bytes",
               "state_bytes", "n_layers", "n_planes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_link(link):
    return J.LinkModel(link.name, link.peak_bw, link.latency)


def _j_profile(hw):
    """The reference's ``HardwareProfile`` holding the port profile's
    constants."""
    return J.HardwareProfile(
        hw.name, hw.flops_peak, hw.hbm_bw, hw.hbm_bytes, _j_link(hw.fabric),
        _j_link(hw.host_link), hw.mfu, hw.membw_util, hw.launch_overhead,
        hw.retry_backoff)


def _j_cost(mc):
    return J.ModelCost(*dataclasses.astuple(mc))


def _fields(obj):
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]


def test_profiles_and_h100_datasheet_values():
    assert set(T.PROFILES) == {"a100-nvlink", "tpu-v5e", "h100-sxm-datasheet"}
    for name, ref in J.PROFILES.items():
        assert _fields(_j_profile(T.PROFILES[name])) == _fields(ref)
    h = T.H100_SXM
    assert T.PROFILES[h.name] is h
    assert (h.flops_peak, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert (h.fabric.name, h.fabric.peak_bw, h.fabric.latency) == \
        ("nvlink4", 450e9, 12e-6)
    assert (h.host_link.name, h.host_link.peak_bw, h.host_link.latency) == \
        ("pcie5", 64e9, 10e-6)
    assert "DATASHEET values, not measured" in T.__doc__
    default = inspect.signature(engine_mod.ServingEngine.__init__) \
        .parameters["hw"].default
    assert default is T.H100_SXM


@pytest.mark.parametrize("arch", SHARED)
def test_model_cost_from_config_equals_reference(arch):
    got = T.ModelCost.from_config(get_config(arch))
    want = J.ModelCost.from_config(j_get_config(arch))
    assert tuple(f.name for f in dataclasses.fields(got)) == COST_FIELDS
    assert tuple(f.name for f in dataclasses.fields(want)) == COST_FIELDS
    assert _fields(got) == _fields(want)


def test_model_cost_state_and_planes():
    assert T.ModelCost.from_config(get_config("rwkv6-3b")).state_bytes \
        == 21_299_200.0
    planes = {a: T.ModelCost.from_config(get_config(a)).n_planes
              for a in ("qwen1.5-0.5b", "rwkv6-3b", "jamba-v0.1-52b",
                        "deepseek-v2-lite-16b")}
    assert planes == {"qwen1.5-0.5b": 1, "rwkv6-3b": 2, "jamba-v0.1-52b": 3,
                      "deepseek-v2-lite-16b": 1}


@pytest.mark.parametrize("profile", PROFILE_NAMES)
@pytest.mark.parametrize("arch", SHARED)
def test_cost_methods_equal_reference(profile, arch):
    hw = T.PROFILES[profile]
    jhw = _j_profile(hw)
    mc = T.ModelCost.from_config(get_config(arch))
    jmc = _j_cost(mc)
    wb = get_config(arch).param_count() * 2.0
    for n in (0, 1, 17, 4096):
        assert mc.prefill_time(hw, n) == jmc.prefill_time(jhw, n)
        assert mc.launch_time(hw, n) == jmc.launch_time(jhw, n)
        assert mc.kv_bytes(n) == jmc.kv_bytes(n)
        assert mc.context_bytes(n) == jmc.context_bytes(n)
        for shared in (0, 5, 17, 5000):
            assert mc.unique_context_bytes(n, shared) == \
                jmc.unique_context_bytes(n, shared)
    for batch, ctx, chunk in ((1, 0.0, 0), (4, 731.5, 0), (16, 2048.0, 256),
                              (64, 123.25, 3000)):
        assert mc.decode_step_time(hw, batch, ctx, wb) == \
            jmc.decode_step_time(jhw, batch, ctx, wb)
        assert mc.fused_step_time(hw, batch, ctx, wb, chunk) == \
            jmc.fused_step_time(jhw, batch, ctx, wb, chunk)
        assert mc.piggyback_tokens(hw, batch, ctx, wb) == \
            jmc.piggyback_tokens(jhw, batch, ctx, wb)
    for hit in (1, 16, 1000):
        for tier in ("fabric", "host"):
            for groups in (1, 3):
                assert T.prefix_hit_saving(hw, mc, hit_tokens=hit, tier=tier,
                                           n_groups=groups) == \
                    J.prefix_hit_saving(jhw, jmc, hit_tokens=hit, tier=tier,
                                        n_groups=groups)


@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_link_and_profile_functions_equal_reference(profile):
    hw = T.PROFILES[profile]
    jhw = _j_profile(hw)
    for link, jlink in ((hw.fabric, jhw.fabric),
                        (hw.host_link, jhw.host_link)):
        for s in (1.0, 64e3, 2e6, 327_680.0 * 2048, 1e9):
            assert link.effective_bw(s) == jlink.effective_bw(s)
            assert link.time(s, 3) == jlink.time(s, 3)
    for n in (1, 2, 4, 8):
        assert _fields(_j_profile(hw.pod_slice(n))) == \
            _fields(jhw.pod_slice(n))
    assert hw.pod_slice(1) is hw
    for nbytes in (0.0, 4096.0, 5.24e9):
        for tier in ("fabric", "host"):
            for coalesced in (True, False):
                for frags in (0, 1, 40):
                    assert T.context_switch_time(
                        hw, nbytes, tier=tier, coalesced=coalesced,
                        n_fragments=frags) == J.context_switch_time(
                        jhw, nbytes, tier=tier, coalesced=coalesced,
                        n_fragments=frags)
            for groups in (0, 1, 3):
                assert T.page_flip_time(hw, nbytes, tier=tier,
                                        n_groups=groups) == \
                    J.page_flip_time(jhw, nbytes, tier=tier, n_groups=groups)
    for n in (-1, 0, 96):
        assert T.launch_overhead_time(hw, n) == J.launch_overhead_time(jhw, n)
    for attempt in (0, 1, 2, 5):
        assert T.retry_backoff_time(hw, attempt) == \
            J.retry_backoff_time(jhw, attempt)
    for c, x in ((0.0, 1.0), (2.0, 1.0), (1e-3, 4e-3)):
        assert T.overlapped_transfer_time(c, x) == \
            J.overlapped_transfer_time(c, x)


def _noisy_samples(seed, alpha, bw, sizes):
    rng = np.random.default_rng(seed)
    return [(float(s), alpha + s / bw
             + float(rng.normal(0.0, 0.01 * (alpha + s / bw))))
            for s in sizes]


@pytest.mark.parametrize("seed", range(4))
def test_fit_link_model_matches_reference(seed):
    sizes = [327_680 * 2 ** k for k in range(12)]
    samples = _noisy_samples(seed, 40e-6, 2.5e9, sizes) \
        + _noisy_samples(seed + 10, 40e-6, 2.5e9, sizes)
    got = T.fit_link_model(samples, "pcie5-measured")
    want = J.fit_link_model(samples, "pcie5-measured")
    assert got.name == want.name == "pcie5-measured"
    assert got.peak_bw == pytest.approx(want.peak_bw, rel=1e-9)
    assert got.latency == pytest.approx(want.latency, rel=1e-9, abs=0.0)
    assert got.peak_bw == pytest.approx(2.5e9, rel=0.05)


def test_fit_link_model_none_cases():
    for samples in ([], [(1e6, 1e-3)], [(1e6, 1e-3), (1e6, 2e-3),
                                        (1e6, 3e-3)],
                    # a non-positive slope whose largest size is 0
                    [(-1e6, 5e-3), (0.0, 1e-3)]):
        assert T.fit_link_model(samples, "x") is None
        assert J.fit_link_model(samples, "x") is None
    # a non-positive slope falls back to the largest sample's bandwidth
    samples = [(1e6, 2e-3), (2e6, 1e-3)]
    got = T.fit_link_model(samples, "x")
    want = J.fit_link_model(samples, "x")
    assert (got.peak_bw, got.latency) == (want.peak_bw, want.latency)
    assert got.peak_bw == pytest.approx(2e9, rel=1e-12)
    # a negative intercept clamps to 0
    got = T.fit_link_model([(1e6, 1e-3), (2e6, 3e-3)], "x")
    assert got.latency == 0.0


def test_calibrate_profile():
    hw = T.H100_SXM
    assert T.calibrate_profile(hw) is hw
    few = _noisy_samples(0, 40e-6, 2.5e9, [1e6, 2e6, 4e6])
    assert T.calibrate_profile(hw, host_samples=few) is hw
    one_size = [(1e6, 1e-3)] * 6
    assert T.calibrate_profile(hw, fabric_samples=one_size) is hw
    host = _noisy_samples(1, 40e-6, 2.5e9, [2 ** k * 1e5 for k in range(8)])
    slab = _noisy_samples(2, 8e-6, 1.2e12, [2 ** k * 1e5 for k in range(8)])
    for kw in (dict(host_samples=host), dict(fabric_samples=slab),
               dict(host_samples=host, fabric_samples=slab)):
        got = T.calibrate_profile(hw, **kw)
        want = J.calibrate_profile(_j_profile(hw), **kw)
        assert got.name == want.name == "h100-sxm-datasheet-calibrated"
        assert _fields(_j_profile(got)) == _fields(want)
    got = T.calibrate_profile(hw, host_samples=host)
    assert got.fabric is hw.fabric
    assert got.host_link.name == "pcie5-measured"
    assert (got.flops_peak, got.hbm_bw) == (hw.flops_peak, hw.hbm_bw)


class _CostBeforeStateFields:
    """``ModelCost.from_config`` as it was before the state and plane
    fields: only the three fields the engine prices with."""

    @staticmethod
    def from_config(cfg):
        c = T.ModelCost.from_config(cfg)
        return T.ModelCost(c.n_params, c.kv_bytes_per_token,
                           n_layers=c.n_layers)


def _engine_run(arch):
    cfg = smoke_config(get_config(arch))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = engine_mod.ServingEngine(cfg, model, max_running=2, max_seq=64,
                                   scheduler="cfs", slice_tokens=3,
                                   step_tokens=16, kv_page_tokens=8,
                                   offload_tier=1, device="cpu")
    eng.pager.add_remote_lease("donor0", 1 << 22)
    rng = np.random.default_rng(11)
    reqs = [eng.submit(list(map(int, rng.integers(0, 512,
                                                  int(rng.integers(5, 30))))),
                       int(rng.integers(3, 9)), arrival=0.01 * i)
            for i in range(6)]
    eng.run(2000)
    assert len(eng.finished) == len(reqs)
    return (eng.metrics.sim_time, eng.pager.meter.sim_time,
            [list(r.generated) for r in reqs], eng.metrics.preemptions)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_engine_sim_time_unchanged(arch, monkeypatch):
    now = _engine_run(arch)
    monkeypatch.setattr(engine_mod, "ModelCost", _CostBeforeStateFields)
    before = _engine_run(arch)
    assert now == before
    assert now[0] > 0.0 and now[3] > 0
