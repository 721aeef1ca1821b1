"""The port's paged layer and model step against the JAX reference.

Weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the qwen1.5-0.5b smoke config (float32) and are carried over with
``from_jax``; pools and plans are made with numpy from a seed. The plan packs
two decode lanes, a chunk row starting mid-page and a bucket-pad row; the
reference runs with ``impl="pallas"`` (its kernels in interpret mode on the
CPU). Outputs/logits of every row but the pad row and every pool page but
the scratch page must agree at rtol 1e-4 / atol 1e-5: the pad row and the
scratch page take duplicate-index writes whose winner neither framework
defines, and no later read sees them unmasked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.layers import attention as jattn
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.layers import attention as tattn
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax

ARCH = "qwen1.5-0.5b"
TOL = dict(rtol=1e-4, atol=1e-5)
PAGE, P, PPS, PPS_PAD = 8, 40, 4, 8
SCRATCH = 0


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def _plan(cfg, seed=0, R=4, Tc=16):
    """Rows: decode at 9, decode at 20, a 6-token chunk from 5 (mid-page),
    a pad row on scratch."""
    rng = np.random.default_rng(seed)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    pool = rng.standard_normal((P, 2, K, PAGE, hd)).astype(np.float32)
    bt = np.full((cfg.n_layers, 1, R, PPS_PAD), SCRATCH, np.int32)
    for l in range(cfg.n_layers):
        for r in range(R - 1):
            bt[l, 0, r, :PPS] = rng.choice(np.arange(1, P), PPS,
                                           replace=False)
    tokens = rng.integers(0, cfg.vocab_size, (R, Tc)).astype(np.int32)
    x = rng.standard_normal((R, Tc, cfg.d_model)).astype(np.float32)
    return dict(pool=pool, bt=bt, tokens=tokens, x=x,
                q_starts=np.asarray([9, 20, 5, 0], np.int32),
                n_reals=np.asarray([1, 1, 6, 0], np.int32), n_decode=2)


def _real_pages(a):
    return np.delete(np.asarray(a), SCRATCH, axis=0)


def test_attention_mixed_paged_matches_reference(models):
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=1)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])
    bt = p["bt"][0, 0]
    jout, jpool = jattn.attention_mixed_paged(
        jp, cfg, jnp.asarray(p["x"]), jnp.asarray(p["pool"]),
        jnp.asarray(bt), jnp.asarray(p["q_starts"]),
        jnp.asarray(p["n_reals"]), n_decode=p["n_decode"], read_pps=PPS,
        impl="pallas")
    tpool = torch.from_numpy(p["pool"].copy())
    tout, tpool = tattn.attention_mixed_paged(
        model.blocks[0].mix, tcfg, torch.from_numpy(p["x"]), tpool,
        torch.from_numpy(bt), p["q_starts"], p["n_reals"],
        n_decode=p["n_decode"], read_pps=PPS, impl="kernel")
    np.testing.assert_allclose(tout.numpy()[:3], np.asarray(jout)[:3], **TOL)
    np.testing.assert_allclose(_real_pages(tpool.numpy()),
                               _real_pages(jpool), **TOL)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_serve_step_paged_matches_reference(models, impl):
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=2)
    jlog, jpools = japi.serve_step_paged(
        params, cfg, jnp.asarray(p["tokens"]), {"kv": jnp.asarray(p["pool"])},
        {"kv": jnp.asarray(p["bt"])}, jnp.asarray(p["q_starts"]),
        jnp.asarray(p["n_reals"]), n_decode=p["n_decode"], read_pps=PPS,
        impl="pallas")
    tlog, tpools = tapi.serve_step_paged(
        model, tcfg, p["tokens"], {"kv": torch.from_numpy(p["pool"].copy())},
        {"kv": p["bt"]}, p["q_starts"], p["n_reals"],
        n_decode=p["n_decode"], read_pps=PPS, impl=impl)
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    np.testing.assert_allclose(_real_pages(tpools["kv"].numpy()),
                               _real_pages(jpools["kv"]), **TOL)


def test_serve_step_paged_rejects_out_of_pool_slots(models):
    cfg, _, tcfg, model = models
    p = _plan(cfg)
    p["bt"][1, 0, 0, 0] = P
    with pytest.raises(ValueError, match="outside the pool"):
        tlm.serve_step_paged(model, tcfg, p["tokens"],
                             {"kv": torch.from_numpy(p["pool"])},
                             {"kv": p["bt"]}, p["q_starts"], p["n_reals"],
                             n_decode=2, read_pps=PPS)


def test_paged_layout_matches_reference(models):
    cfg, _, tcfg, _ = models
    j = jlm.paged_layout(cfg)["kv"]
    t = tlm.paged_layout(tcfg)["kv"]
    for key in ("kind", "positions", "dims", "token_bytes", "shareable"):
        assert t[key] == j[key], key
    assert tlm.supports_paged(tcfg) and tapi.supports_paged(tcfg)
    assert not tlm.supports_paged(tcfg.replace(sliding_window=16))


def _named_shapes(model):
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def test_init_params_keys_shapes_and_scales_match_reference(models):
    cfg, params, tcfg, carried = models
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _named_shapes(model) == _named_shapes(carried)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    # init scales: std of trunc-normal(-2, 2) is ~0.88 of the scale
    for name, want in (("embed.tok", 0.02),
                       ("blocks.0.mix.wq.w", 1 / np.sqrt(cfg.d_model)),
                       ("blocks.0.ffn.down.w", 1 / np.sqrt(cfg.d_ff))):
        got = dict(model.named_parameters())[name].std().item()
        ref = float(np.std(np.asarray(
            dict(carried.named_parameters())[name].detach())))
        assert abs(got / ref - 1) < 0.1, name
        assert abs(got / (0.88 * want) - 1) < 0.1, name
    for name, p in model.named_parameters():
        if name.endswith(".b") or name.endswith("scale"):
            assert not p.any(), name
