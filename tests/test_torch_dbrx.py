"""dbrx-132b (16 experts, top 4, no shared expert; 48 heads on 8 KV heads
of 128, G 6) on the port's paged runtime against the JAX reference, on the
CPU.

The configuration field for field, its parameter count whole and at the 8
layers the card holds. On the reference's smoke config (4 layers, 4
experts, top 2, no shared expert), weights from its
``api.init_params(PRNGKey(0), cfg)`` through ``from_jax`` (float32), held
at rtol 1e-4 / atol 1e-5: a prompt prefilled in one chunk and then decoded
token by token through the pages against the reference's training forward
at every position (the port's MoE training forward is not ported), and the
fused step ``serve_step_paged`` (logits; every page a live row owns; the
rest untouched). The MoE without a shared expert runs no shared GEMM. The
serve CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.layers import moe as tmoe
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.kv_cache import PagedStateRuntime

ARCH = "dbrx-132b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _same_fields(tcfg, cfg):
    """Every field of the port's config equals the reference's (a
    sub-config field by field)."""
    for f in dataclasses.fields(tcfg):
        a, b = getattr(tcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


@pytest.mark.parametrize("n_layers,want", [(40, 131_596_517_376),
                                           (8, 27_305_803_776)])
def test_param_count_matches_reference(n_layers, want):
    tcfg = t_get_config(ARCH).replace(n_layers=n_layers)
    cfg = get_config(ARCH).replace(n_layers=n_layers)
    assert tcfg.param_count() == cfg.param_count() == want


def test_config_matches_reference_field_for_field():
    tcfg, cfg = t_get_config(ARCH), get_config(ARCH)
    _same_fields(tcfg, cfg)
    assert tcfg.n_heads // tcfg.n_kv_heads == 6
    assert tlm.paged_layout(tcfg)["kv"]["token_bytes"] * 16 == 65_536


@pytest.fixture(scope="module")
def models():
    cfg, tcfg = smoke_config(get_config(ARCH)), t_smoke_config(
        t_get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def test_smoke_config_and_experts_match_reference(models):
    cfg, params, tcfg, model = models
    _same_fields(tcfg, cfg)
    m = tcfg.moe
    assert m.n_shared_experts == 0
    for l, blk in enumerate(model.blocks):
        assert isinstance(blk.ffn, tmoe.MoE)
        assert blk.ffn.shared is None
        tree = params["blocks"]["sub0"]["ffn"]
        assert "shared" not in tree
        for name in ("up", "gate", "down"):
            np.testing.assert_array_equal(getattr(blk.ffn, name).numpy(),
                                          np.asarray(tree[name][l]))
        np.testing.assert_array_equal(blk.ffn.router.w.numpy(),
                                      np.asarray(tree["router"]["w"][l]))


def test_moe_without_shared_experts_runs_no_shared_mlp(models, monkeypatch):
    cfg, params, tcfg, model = models

    def no_mlp(*a, **kw):
        raise AssertionError("a shared-expert GEMM ran")
    monkeypatch.setattr(tmoe, "mlp", no_mlp)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32))
    out, _ = tmoe.moe_apply(model.blocks[0].ffn, tcfg, x)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_paged_prefill_and_decode_match_reference_forward(models):
    """A 12-token prompt: its first 5 tokens in one chunk
    (``prefill_chunk_paged``), then 7 decode steps
    (``decode_step_paged``), each step's logits against the reference's
    training forward at that position."""
    cfg, params, tcfg, model = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 12))
    want, _ = jlm.forward(params, cfg, jnp.asarray(toks, jnp.int32))
    want = np.asarray(want)[0]
    kv = PagedStateRuntime(tcfg, max_seq=64, page_tokens=8, max_running=2,
                           device="cpu")
    n0 = 5
    kv.ensure_capacity(0, n0)
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :n0] = toks[0, :n0]
    lg, kv.pools = tapi.prefill_chunk_paged(
        model, tcfg, chunk, kv.pools, kv.block_tables_prefill(0, pad_to=11),
        0, n0 - 1, read_pps=kv.pps)
    np.testing.assert_allclose(lg.numpy()[0], want[n0 - 1], **TOL)
    for t in range(n0, toks.shape[1]):
        kv.ensure_capacity(0, t + 1)
        lg, kv.pools = tapi.decode_step_paged(
            model, tcfg, kv.pools, kv.block_tables([0, None]),
            np.asarray([toks[0, t], 0], np.int32),
            np.asarray([t, 0], np.int32))
        np.testing.assert_allclose(lg.numpy()[0], want[t], **TOL)


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


def test_serve_cli_serves_the_smoke_config(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                 "3", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "(planes: kv)" in out
    assert "served 3 requests" in out
