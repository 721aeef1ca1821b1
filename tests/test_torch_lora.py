"""LoRA adapters and the AQUA adapter cache (``serving/lora.py``) on both
packages, on the CPU: the reference's ``test_serving.py`` LoRA cases run
on the reference and on the port with the same adapters (the reference's
``init_adapter`` carried over as numpy by ``adapter_from_numpy``).

The cache's meter moves alike on both, op for op, with and without a
donor lease (puts, hits, misses, LRU evictions); an adapter parks in its
native dtype within one page of ``adapter_bytes``, and its pages read
back equal to its raveled leaves bit for bit. ``apply_lora`` merges equal
the reference's at 1e-6 (float32), B = 0 leaves the logits unchanged bit
for bit and B != 0 moves them; the original model and every tensor but
the merged ones are shared, not copied.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core.aqua_tensor import TransferMeter as JTransferMeter
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.serving import lora as jlora
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import TransferMeter as TTransferMeter
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving import lora as tlora

ARCH = "qwen1.5-0.5b"
METER = ("bytes_fabric", "bytes_host", "messages_fabric", "messages_host")


def _cfgs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (smoke_config(get_config(ARCH)).replace(**kw),
            t_smoke_config(t_get_config(ARCH)).replace(**kw))


def _adapters(cfg, tcfg, n, rank=4):
    out = []
    for i in range(n):
        ad = jlora.init_adapter(jax.random.PRNGKey(i + 1), cfg, rank=rank)
        out.append((ad, tlora.adapter_from_numpy(
            jax.tree.map(np.asarray, ad), tcfg, "cpu")))
    return out


def _meter(m):
    return tuple(getattr(m, k) for k in METER)


@pytest.mark.parametrize("lease_pages", [0, 10])
def test_cache_meters_like_the_reference(lease_pages):
    """Four adapters of 8 pages each on both packages' caches (capacity 2),
    with no lease (every page on HOST) or a 10-page donor lease (the first
    adapter and part of the second on REMOTE): the meter after every put
    and fetch (hits, misses, re-fetches after an LRU eviction) is equal,
    a hit adds nothing and a miss adds one message per tier its pages
    lie on."""
    cfg, tcfg = _cfgs()
    ads = _adapters(cfg, tcfg, 4)
    jc = jlora.AdapterCache(capacity_local=2, page_elems=1024,
                            dtype=cfg.dtype(),
                            meter=JTransferMeter(hw=J_A100))
    tc = tlora.AdapterCache(capacity_local=2, page_elems=1024,
                            dtype=tcfg.dtype(), device="cpu",
                            meter=TTransferMeter(hw=T_A100))
    if lease_pages:
        jc.aqua.add_remote_lease("d0", lease_pages)
        tc.aqua.add_remote_lease("d0", lease_pages)
    for aid, (ja, ta) in enumerate(ads):
        jc.put(aid, ja)
        tc.put(aid, ta)
        assert _meter(tc.aqua.meter) == _meter(jc.aqua.meter)
    assert len(tc.pages_of(0)) == 8
    for aid in (0, 0, 1, 2, 0, 3, 3, 1):
        before = _meter(tc.aqua.meter)
        hit = aid in tc.hits_resident
        assert tc.fetch(aid) is ads[aid][1]
        jc.fetch(aid)
        assert _meter(tc.aqua.meter) == _meter(jc.aqua.meter)
        assert tc.hits_resident == jc.hits_resident
        after = _meter(tc.aqua.meter)
        if hit:
            assert after == before
        else:
            tiers = set(tc.aqua.page_table[tc.pages_of(aid), 0].tolist())
            assert sum(after[2:]) - sum(before[2:]) == len(tiers)
    assert jc.aqua.meter.sim_time == pytest.approx(tc.aqua.meter.sim_time,
                                                   rel=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adapter_parks_native_dtype_pages(dtype):
    """Native-dtype pages: the bytes parked equal ``adapter_bytes`` up to
    one page of tail padding, on both packages, and the pages read back
    equal the raveled leaves (``q_a``, ``q_b``, ``v_a``, ``v_b``) bit for
    bit."""
    cfg, tcfg = _cfgs(dtype)
    ((ja, ta),) = _adapters(cfg, tcfg, 1)
    ta = dict(ta, q_b=torch.randn(ta["q_b"].shape).to(tcfg.dtype()))
    for mod, ad, dt in ((jlora, ja, cfg.dtype()),
                        (tlora, ta, tcfg.dtype())):
        kw = {} if mod is jlora else {"device": "cpu"}
        cache = mod.AdapterCache(capacity_local=1, page_elems=4096, dtype=dt,
                                 **kw)
        cache.put(0, ad)
        parked = cache.aqua.meter.bytes_fabric + cache.aqua.meter.bytes_host
        nbytes = mod.adapter_bytes(ad)
        assert nbytes <= parked <= nbytes + cache.aqua.page_bytes
    assert tlora.adapter_bytes(ta) == jlora.adapter_bytes(ja)
    assert cache.aqua.dtype == tcfg.dtype()
    got = cache.aqua.read(cache.pages_of(0)).reshape(-1)
    want = torch.cat([ta[k].reshape(-1) for k in ("q_a", "q_b", "v_a",
                                                  "v_b")])
    assert torch.equal(got[:want.numel()], want)
    assert not got[want.numel():].any()


def test_init_adapter_shapes_dtypes_and_scales():
    _, tcfg = _cfgs("bfloat16")
    ad = tlora.init_adapter(torch.Generator().manual_seed(0), tcfg, rank=16)
    L, d, hd = tcfg.n_layers, tcfg.d_model, tcfg.resolved_head_dim
    assert ad["alpha"] == 32.0 and ad["rank"] == 16
    assert tuple(ad["q_a"].shape) == tuple(ad["v_a"].shape) == (L, d, 16)
    assert tuple(ad["q_b"].shape) == (L, 16, tcfg.n_heads * hd)
    assert tuple(ad["v_b"].shape) == (L, 16, tcfg.n_kv_heads * hd)
    assert all(v.dtype == torch.bfloat16
               for v in tlora.adapter_arrays(ad).values())
    assert not ad["q_b"].any() and not ad["v_b"].any()
    a = ad["q_a"].float()
    assert a.abs().max() <= 2.0 / d ** 0.5 + 1e-6
    assert 0.7 / d ** 0.5 < a.std() < 1.0 / d ** 0.5
    full = t_get_config(ARCH)          # rank 16 at full width: 3,145,728 B
    assert tlora.adapter_bytes(tlora.init_adapter(
        torch.Generator().manual_seed(0), full.replace(n_layers=1))) \
        * full.n_layers == 3_145_728


@pytest.fixture(scope="module")
def merged():
    cfg, tcfg = _cfgs()
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    ((ja, ta),) = _adapters(cfg, tcfg, 1)
    q_b = 0.02 * np.random.default_rng(5).standard_normal(ja["q_b"].shape)
    ja2 = dict(ja, q_b=jnp.asarray(q_b, jnp.float32))
    ta2 = dict(ta, q_b=torch.from_numpy(q_b.astype(np.float32)))
    return cfg, tcfg, params, model, (ja, ta), (ja2, ta2)


def _logits(model, tcfg):
    toks = torch.tensor([[1, 2, 3, 4]])
    return tlm.forward(model, tcfg, toks, impl="ref")[0]


def test_apply_lora_at_zero_b_is_the_identity(merged):
    _, tcfg, _, model, (_, ta), _ = merged
    m1 = tlora.apply_lora(model, tcfg, ta)
    assert torch.equal(_logits(m1, tcfg), _logits(model, tcfg))


def test_apply_lora_merges_equal_the_reference(merged):
    cfg, tcfg, params, model, _, (ja2, ta2) = merged
    jp = jlora.apply_lora(params, cfg, ja2)
    m2 = tlora.apply_lora(model, tcfg, ta2)
    for name in ("wq", "wv"):
        want = np.asarray(jp["blocks"]["sub0"]["mix"][name]["w"])
        got = np.stack([getattr(b.mix, name).w.numpy() for b in m2.blocks])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert float((_logits(m2, tcfg) - _logits(model, tcfg)).abs().max()) \
        > 1e-4


def test_apply_lora_shares_everything_but_the_merged_weights(merged):
    _, tcfg, _, model, _, (_, ta2) = merged
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m2 = tlora.apply_lora(model, tcfg, ta2)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    orig = dict(model.named_parameters())
    new = dict(m2.named_parameters())
    assert set(new) == set(orig)
    for k, p in new.items():
        fresh = k.endswith(("mix.wq.w", "mix.wv.w"))
        assert (p.data_ptr() != orig[k].data_ptr()) == fresh, k


def test_apply_lora_refuses_a_hybrid_stack():
    tcfg = t_smoke_config(t_get_config("jamba-v0.1-52b"))
    model = tlm.LM(tcfg, torch.device("cpu"))
    ad = tlora.init_adapter(torch.Generator().manual_seed(0), tcfg, rank=2)
    with pytest.raises(ValueError, match="group size"):
        tlora.apply_lora(model, tcfg, ad)


def test_adapter_from_numpy_defaults_to_cuda(monkeypatch):
    """Like ``from_jax``, the carried-over adapter lands on CUDA unless the
    caller passes a device, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = t_smoke_config(t_get_config(ARCH))
    ad = jax.tree.map(np.asarray, jlora.init_adapter(
        jax.random.PRNGKey(0), smoke_config(get_config(ARCH)), rank=2))
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tlora.adapter_from_numpy(ad, tcfg)
    assert tlora.adapter_from_numpy(ad, tcfg, "cpu")["q_a"].device.type \
        == "cpu"
