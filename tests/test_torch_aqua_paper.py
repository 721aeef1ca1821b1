"""The paper's own evaluated models (``configs/aqua_paper.py``:
aqua-llama2-13b, aqua-codellama-34b, aqua-opt-30b and aqua-mistral-7b) on
the port against the JAX reference, on the CPU.

Each configuration field for field and its parameter count. For the three
paged models, the reference's smoke config with weights from its
``api.init_params(PRNGKey(0), cfg)`` through ``from_jax`` (float32), held
at rtol 1e-4 / atol 1e-5: the training forward's logits and the fused step
``serve_step_paged`` (logits; every page a live row owns; the rest
untouched). aqua-opt-30b's MLP is the non-gated tanh-gelu one (no ``gate``
leaf). aqua-mistral-7b's sliding window has no page plane: ``supports_paged``
is false in both packages and both engines refuse it; its model builds and
its forward equals the reference's. The serve CLI for each name.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine

TOL = dict(rtol=1e-4, atol=1e-5)
PAGED = ["aqua-llama2-13b", "aqua-codellama-34b", "aqua-opt-30b"]
COUNTS = {"aqua-llama2-13b": 13_015_859_200,
          "aqua-codellama-34b": 33_744_224_256,
          "aqua-opt-30b": 30_316_396_544,
          "aqua-mistral-7b": 7_241_728_000}
# one layer's 16-token kv page and one token's kv over every layer, bf16
KV_BYTES = {"aqua-llama2-13b": (327_680, 819_200),
            "aqua-codellama-34b": (65_536, 196_608),
            "aqua-opt-30b": (458_752, 1_376_256)}


def _same_fields(tcfg, cfg):
    """Every field of the port's config equals the reference's (a
    sub-config field by field)."""
    for f in dataclasses.fields(tcfg):
        a, b = getattr(tcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_config_and_param_count_match_reference(arch):
    tcfg, cfg = t_get_config(arch), get_config(arch)
    _same_fields(tcfg, cfg)
    assert tcfg.param_count() == cfg.param_count() == COUNTS[arch]


@pytest.mark.parametrize("arch", sorted(KV_BYTES))
def test_kv_page_and_token_bytes(arch):
    tcfg = t_get_config(arch)
    kv = tlm.paged_layout(tcfg)["kv"]
    page_bytes, token_bytes = KV_BYTES[arch]
    assert kv["token_bytes"] * 16 == page_bytes
    assert kv["token_bytes"] * tcfg.n_layers == token_bytes


def _build(arch):
    cfg, tcfg = smoke_config(get_config(arch)), t_smoke_config(
        t_get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


@pytest.fixture(scope="module", params=PAGED)
def models(request):
    return _build(request.param)


def test_smoke_config_and_mlp_match_reference(models):
    cfg, params, tcfg, model = models
    _same_fields(tcfg, cfg)
    ffn, tree = model.blocks[0].ffn, params["blocks"]["sub0"]["ffn"]
    assert (ffn.gate is None) == (cfg.activation == "gelu") \
        == ("gate" not in tree)


def test_forward_logits_match_reference(models):
    cfg, params, tcfg, model = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    want, _ = jlm.forward(params, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = tapi.forward(model, tcfg, torch.from_numpy(toks), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


P_KV, PPS = 48, 6


def _plan(cfg, seed=4):
    """Two decode lanes (positions 9 and 20), a 12-token chunk from 4, a
    pad row; every live row owns the pages its tokens reach, in every
    layer pages of its own."""
    rng = np.random.default_rng(seed)
    K, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    R, Tc, page = 4, 16, 8
    pool = rng.standard_normal((P_KV, 2, K, page, hd)).astype(np.float32)
    bt = np.zeros((L, 1, R, PPS), np.int32)
    pages = rng.choice(np.arange(1, P_KV), (L, 7), replace=False)
    bt[:, 0, 0, :2], bt[:, 0, 1, :3] = pages[:, :2], pages[:, 2:5]
    bt[:, 0, 2, :2] = pages[:, 5:7]
    return dict(pool=pool, bt={"kv": bt}, live=np.unique(pages),
                tokens=rng.integers(0, cfg.vocab_size, (R, Tc))
                .astype(np.int32),
                q_starts=np.asarray([9, 20, 4, 0], np.int32),
                n_reals=np.asarray([1, 1, 12, 0], np.int32), n_decode=2)


def test_serve_step_paged_matches_reference(models):
    cfg, params, tcfg, model = models
    p = _plan(cfg)
    jlog, jpools = japi.serve_step_paged(
        params, cfg, jnp.asarray(p["tokens"]), {"kv": jnp.asarray(p["pool"])},
        {"kv": jnp.asarray(p["bt"]["kv"])}, jnp.asarray(p["q_starts"]),
        jnp.asarray(p["n_reals"]), n_decode=p["n_decode"], read_pps=PPS,
        impl="xla")
    tlog, tpools = tapi.serve_step_paged(
        model, tcfg, p["tokens"], {"kv": torch.from_numpy(p["pool"].copy())},
        p["bt"], p["q_starts"], p["n_reals"], n_decode=p["n_decode"],
        read_pps=PPS)
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    live = p["live"]
    np.testing.assert_allclose(tpools["kv"].numpy()[live],
                               np.asarray(jpools["kv"])[live], **TOL)
    untouched = np.setdiff1d(np.arange(1, P_KV), live)
    np.testing.assert_array_equal(tpools["kv"].numpy()[untouched],
                                  p["pool"][untouched])


def test_mistral_is_refused_by_both_engines():
    """aqua-mistral-7b's 4,096-token window (16 in the smoke config) has
    no page plane: neither package's engine serves it. Its model builds
    and its training forward equals the reference's (the dense KV-cache
    path serves it: ``test_torch_kv_cache_path.py``)."""
    arch = "aqua-mistral-7b"
    cfg, tcfg = smoke_config(get_config(arch)), t_smoke_config(
        t_get_config(arch))
    assert tcfg.sliding_window == cfg.sliding_window == 16
    assert not jlm.supports_paged(get_config(arch))
    assert not tlm.supports_paged(t_get_config(arch))
    assert not jlm.supports_paged(cfg) and not tlm.supports_paged(tcfg)
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    with pytest.raises(ValueError, match="not paged-servable"):
        JEngine(cfg, params, hw=J_A100, max_running=2, max_seq=64)
    dense = t_smoke_config(t_get_config("aqua-llama2-13b"))
    model = tlm.init_params(dense, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="not paged-servable"):
        TEngine(tcfg, model, hw=T_A100, max_running=2, max_seq=64,
                device="cpu")
    with pytest.raises(ValueError, match="not paged-servable"):
        tlm.paged_layout(tcfg)
    mistral = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = japi.model_module(cfg).forward(params, cfg, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = tlm.forward(mistral, tcfg, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_serve_cli_serves_each_name(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new-tokens", "3"]
    if arch not in PAGED:
        with pytest.raises(ValueError, match="not paged-servable"):
            tserve.main(argv)
        return
    tserve.main(argv)
    out = capsys.readouterr().out
    assert "(planes: kv)" in out
    assert "served 3 requests" in out
