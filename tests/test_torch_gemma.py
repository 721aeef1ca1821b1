"""gemma-7b (GeGLU, embeddings scaled by sqrt(d), 16 heads of 256 on a
d_model of 3,072, so the heads span more than d_model) on the port's paged
runtime against the JAX reference, on the CPU.

Two small configurations, both with weights from the reference's
``api.init_params(PRNGKey(0), cfg)`` through ``from_jax`` (float32): the
reference's smoke config (4 layers, d 128, 4 heads of 32) and the same at
``head_dim=256`` (q 128 -> 1,024, o 1,024 -> 128, the head-dim-256 path of
every paged plain version and the page writer). Held against the
reference at rtol 1e-4 / atol 1e-5: the training forward's logits, the
fused step ``serve_step_paged`` (logits; every non-scratch page of the
pool) and, on the smoke config, the engine's greedy tokens and meter
(exact). Also the configuration's parameter count and the embedding
scale's rounding in bf16 (bit for bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core.aqua_tensor import REMOTE as J_REMOTE
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.layers import core as jcore
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import REMOTE as T_REMOTE
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.layers import core as tcore
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "gemma-7b"
TOL = dict(rtol=1e-4, atol=1e-5)
KNOBS = dict(max_running=2, max_seq=64, scheduler="cfs", slice_tokens=3,
             step_tokens=16, kv_page_tokens=8)


def _build(kind):
    cfg, tcfg = smoke_config(get_config(ARCH)), t_smoke_config(
        t_get_config(ARCH))
    if kind == "hd256":
        cfg, tcfg = cfg.replace(head_dim=256), tcfg.replace(head_dim=256)
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


@pytest.fixture(scope="module", params=["smoke", "hd256"])
def models(request):
    return _build(request.param)


def test_param_count_matches_reference():
    tcfg = t_get_config(ARCH)
    assert tcfg.param_count() == get_config(ARCH).param_count() \
        == 8_537_677_824
    assert round(tcfg.param_count() * 2 / 2 ** 30, 2) == 15.90
    assert tcfg.n_heads * tcfg.resolved_head_dim == 4096 != tcfg.d_model
    assert tlm.paged_layout(tcfg)["kv"]["token_bytes"] * tcfg.n_layers \
        == 458_752


def test_smoke_config_matches_reference(models):
    cfg, _, tcfg, model = models
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "activation", "embed_scale",
                  "tie_embeddings", "param_dtype"):
        assert getattr(tcfg, field) == getattr(cfg, field), field
    hd, d = tcfg.resolved_head_dim, tcfg.d_model
    mix = model.blocks[0].mix
    assert tuple(mix.wq.w.shape) == (d, tcfg.n_heads * hd)
    assert tuple(mix.wo.w.shape) == (tcfg.n_heads * hd, d)
    assert model.blocks[0].ffn.gate is not None       # GeGLU


def test_forward_logits_match_reference(models):
    cfg, params, tcfg, model = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    want, _ = jlm.forward(params, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = tapi.forward(model, tcfg, torch.from_numpy(toks), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_scale_rounds_like_the_reference_in_bf16():
    """sqrt(3,072) = 55.43 is rounded to bf16 (55.5) before the product,
    as the reference does: bit for bit at the full width's d."""
    cfg = get_config(ARCH).replace(vocab_size=64, compute_dtype="bfloat16")
    tcfg = t_get_config(ARCH).replace(vocab_size=64,
                                      compute_dtype="bfloat16")
    tok = np.random.default_rng(2).standard_normal((64, cfg.d_model))
    ids = np.arange(0, 64, 3)
    want = jcore.embed({"tok": jnp.asarray(tok, jnp.float32)}, cfg,
                       jnp.asarray(ids))
    emb = tcore.Embedding(tcfg, "cpu")
    emb.tok.data = torch.from_numpy(tok.astype(np.float32))
    got = tcore.embed(emb, tcfg, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


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


def _serve(eng, cfg):
    rng = np.random.default_rng(11)
    reqs = [eng.submit(list(map(int, rng.integers(0, cfg.vocab_size,
                                                  int(rng.integers(5, 30))))),
                       int(rng.integers(3, 7)), arrival=0.01 * i)
            for i in range(5)]
    eng.run(2000)
    meter = eng.pager.meter
    return {"tokens": [list(r.generated) for r in reqs],
            "preemptions": eng.metrics.preemptions,
            "restores": eng.metrics.restores,
            "bytes_fabric": meter.bytes_fabric,
            "messages_fabric": meter.messages_fabric}


def test_engine_tokens_and_meter_match_reference():
    cfg, params, tcfg, model = _build("smoke")
    jeng = JEngine(cfg, params, offload_tier=J_REMOTE, hw=J_A100,
                   paged_impl="xla", **KNOBS)
    jeng.pager.add_remote_lease("donor0", 1 << 22)
    teng = TEngine(tcfg, model, offload_tier=T_REMOTE, hw=T_A100,
                   device="cpu", **KNOBS)
    teng.pager.add_remote_lease("donor0", 1 << 22)
    ref, port = _serve(jeng, cfg), _serve(teng, tcfg)
    assert port == ref
    assert port["preemptions"] > 0 and all(port["tokens"])
