"""internvl2-1b (the VLM: a dense backbone whose prompts open with the stub
frontend's prefix embedding rows) on the port's paged runtime against the
JAX reference, on the CPU.

Weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the smoke config (4 layers, d 128, 4 heads on 2 KV heads, 8 prefix rows;
float32) through ``from_jax``; prefix blocks are numpy arrays handed to
both packages. Held against the reference: the configuration
(``param_count`` at full width, the smoke fields), the plane layout
(``kv`` alone), the fused step ``serve_step_paged`` and the per-request
``prefill_chunk_paged`` with prefix rows (logits at rtol 1e-4 / atol
1e-5, every non-scratch page of the pool), and the engine (the
reference's ``test_state_paging.py`` VLM case: greedy tokens exact with
the prefix chunked by ``step_tokens=8``, the zero prefix by default, the
meter equal; a text model refusing a prefix). As the port against
itself: VLM requests take no part in prefix sharing, a retired request
drops its prefix, and a snapshot -> restore mid-stream finishes with the
uninterrupted tokens in float32 and in bf16 (prefix blocks as raw 16-bit
words; another dtype refused before anything is built).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core.aqua_tensor import HOST as J_HOST
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import HOST as T_HOST
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "internvl2-1b"
TOL = dict(rtol=1e-4, atol=1e-5)
KNOBS = dict(max_running=2, max_seq=96, scheduler="cfs", slice_tokens=3,
             step_tokens=8)


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def _requests(cfg):
    """The reference test's two prompts (9 and 6 tokens) and their prefix
    blocks, drawn from one seeded generator."""
    rng = np.random.default_rng(0)
    P = cfg.n_prefix_embeds
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (9, 6)]
    pres = [(rng.standard_normal((1, P, cfg.d_model)) * 0.1)
            .astype(np.float32) for _ in prompts]
    return prompts, pres


def _serve(eng, prompts, pres):
    reqs = [eng.submit(p, 4, prefix_embeds=pre)
            for p, pre in zip(prompts, pres)]
    m = eng.run(400)
    meter = eng.pager.meter
    return {"tokens": [list(r.generated) for r in reqs],
            "n_prefix": [r.n_prefix for r in reqs],
            "positions": [r.prompt_positions for r in reqs],
            "prefills": m.prefills, "preemptions": m.preemptions,
            "restores": m.restores, "bytes_host": meter.bytes_host,
            "messages_host": meter.messages_host}


@pytest.fixture(scope="module")
def served(models):
    """Both engines on the reference test's requests, then the first
    prompt alone with the default (zero) prefix."""
    cfg, params, tcfg, model = models
    prompts, pres = _requests(cfg)
    out = {}
    for side in ("reference", "port"):
        def engine():
            if side == "reference":
                return JEngine(cfg, params, offload_tier=J_HOST, hw=J_A100,
                               paged_impl="xla", **KNOBS)
            return TEngine(tcfg, model, offload_tier=T_HOST, hw=T_A100,
                           device="cpu", **KNOBS)
        out[side] = (_serve(engine(), prompts, pres),
                     _serve(engine(), prompts[:1], [None]))
    return out


# ---------------------------------------------------------------------------
# configuration and layout
# ---------------------------------------------------------------------------
def test_param_count_and_smoke_config_match_reference(models):
    cfg, _, tcfg, _ = models
    full = t_get_config(ARCH)
    assert full.param_count() == get_config(ARCH).param_count() \
        == 493_752_448
    assert (full.n_heads, full.n_kv_heads, full.n_prefix_embeds) == (14, 2,
                                                                      256)
    for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "n_prefix_embeds",
                  "tie_embeddings", "rope_theta", "param_dtype"):
        assert getattr(tcfg, field) == getattr(cfg, field), field
    assert tcfg.n_prefix_embeds == 8


def test_paged_layout_is_the_kv_plane(models):
    cfg, _, tcfg, _ = models
    assert tlm.supports_paged(tcfg) and jlm.supports_paged(cfg)
    t, j = tlm.paged_layout(tcfg), jlm.paged_layout(cfg)
    assert list(t) == list(j) == ["kv"]
    assert t["kv"]["token_bytes"] == j["kv"]["token_bytes"]
    assert t["kv"]["dims"] == tuple(j["kv"]["dims"])
    full = t_get_config(ARCH)                 # 12,288 B of K/V a token
    assert tlm.paged_layout(full)["kv"]["token_bytes"] * full.n_layers \
        == 12288


# ---------------------------------------------------------------------------
# the fused step and the per-request chunk with prefix rows
# ---------------------------------------------------------------------------
P_KV, PPS = 48, 6


def _prefix_plan(cfg, seed=3):
    """Two decode lanes past the prefix (positions 19 and 30), a chunk row
    of 12 from 0 (8 prefix rows, then text), a chunk row of 10 from 5
    (crossing the prefix's end), a pad row; each live row owns the pages
    its tokens reach, in every layer pages of its own."""
    rng = np.random.default_rng(seed)
    K, hd, P, d = (cfg.n_kv_heads, cfg.resolved_head_dim,
                   cfg.n_prefix_embeds, cfg.d_model)
    R, Tc, page, L = 5, 16, 8, cfg.n_layers
    pool = rng.standard_normal((P_KV, 2, K, page, hd)).astype(np.float32)
    bt = np.zeros((L, 1, R, PPS), np.int32)
    pages = rng.choice(np.arange(1, P_KV), (L, 11), replace=False)
    bt[:, 0, 0, :3], bt[:, 0, 1, :4] = pages[:, :3], pages[:, 3:7]
    bt[:, 0, 2, :2], bt[:, 0, 3, :2] = pages[:, 7:9], pages[:, 9:11]
    pre = (rng.standard_normal((R, P, d)) * 0.1).astype(np.float32)
    pre[:2] = 0.0                       # decode lanes: no VLM chunk
    pre[4] = 0.0                        # the pad row
    return dict(pool=pool, bt={"kv": bt}, pre=pre,
                tokens=rng.integers(0, cfg.vocab_size, (R, Tc))
                .astype(np.int32),
                q_starts=np.asarray([19, 30, 0, 5, 0], np.int32),
                n_reals=np.asarray([1, 1, 12, 10, 0], np.int32),
                n_decode=2, live=np.unique(pages))


def test_serve_step_paged_with_prefix_rows_matches_reference(models):
    cfg, params, tcfg, model = models
    p = _prefix_plan(cfg)
    jlog, jpools = japi.serve_step_paged(
        params, cfg, jnp.asarray(p["tokens"]), {"kv": jnp.asarray(p["pool"])},
        {"kv": jnp.asarray(p["bt"]["kv"])}, jnp.asarray(p["q_starts"]),
        jnp.asarray(p["n_reals"]), n_decode=p["n_decode"],
        prefix_embeds=jnp.asarray(p["pre"]), read_pps=PPS, impl="xla")
    tlog, tpools = tapi.serve_step_paged(
        model, tcfg, p["tokens"], {"kv": torch.from_numpy(p["pool"].copy())},
        p["bt"], p["q_starts"], p["n_reals"], n_decode=p["n_decode"],
        prefix_embeds=torch.from_numpy(p["pre"]), read_pps=PPS)
    np.testing.assert_allclose(tlog.numpy()[:4], np.asarray(jlog)[:4], **TOL)
    live = p["live"]
    np.testing.assert_allclose(tpools["kv"].numpy()[live],
                               np.asarray(jpools["kv"])[live], **TOL)
    # the prefix rows matter: without them the chunk rows move
    nolog, _ = tapi.serve_step_paged(
        model, tcfg, p["tokens"], {"kv": torch.from_numpy(p["pool"].copy())},
        p["bt"], p["q_starts"], p["n_reals"], n_decode=p["n_decode"],
        read_pps=PPS)
    assert not np.allclose(nolog.numpy()[2:4], tlog.numpy()[2:4], **TOL)
    np.testing.assert_array_equal(nolog.numpy()[:2], tlog.numpy()[:2])


@pytest.mark.parametrize("q_start,n", [(0, 6), (5, 7)])
def test_prefill_chunk_with_prefix_rows_matches_reference(models, q_start,
                                                          n):
    """One chunk inside the prefix and one crossing its end, on a pool
    whose earlier pages hold seeded rows."""
    cfg, params, tcfg, model = models
    rng = np.random.default_rng(q_start)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L = cfg.n_layers
    pool = rng.standard_normal((3 * L + 1, 2, K, 8, hd)).astype(np.float32)
    bt = np.zeros((L, 1, PPS), np.int32)
    bt[:, 0, :3] = 1 + rng.permutation(3 * L).reshape(L, 3)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
    pre = (rng.standard_normal((1, cfg.n_prefix_embeds, cfg.d_model))
           * 0.1).astype(np.float32)
    jlog, jpools = japi.prefill_chunk_paged(
        params, cfg, jnp.asarray(toks), {"kv": jnp.asarray(pool)},
        {"kv": jnp.asarray(bt)}, q_start, n - 1,
        prefix_embeds=jnp.asarray(pre), read_pps=3, impl="xla")
    tlog, tpools = tapi.prefill_chunk_paged(
        model, tcfg, toks, {"kv": torch.from_numpy(pool.copy())}, {"kv": bt},
        q_start, n - 1, prefix_embeds=torch.from_numpy(pre), read_pps=3)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    written = bt[:, 0, :2].reshape(-1)           # positions 0 .. 15
    np.testing.assert_allclose(tpools["kv"].numpy()[written],
                               np.asarray(jpools["kv"])[written], **TOL)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------
def test_engine_tokens_with_chunked_prefix_match_reference(served):
    (ref, _), (port, _) = served["reference"], served["port"]
    assert port["tokens"] == ref["tokens"]
    assert all(len(t) == 4 for t in port["tokens"])
    assert port["n_prefix"] == ref["n_prefix"] == [8, 8]
    assert port["positions"] == ref["positions"] == [17, 14]
    assert port["prefills"] == ref["prefills"] > 2   # the prefix chunked
    for key in ("preemptions", "restores", "bytes_host", "messages_host"):
        assert port[key] == ref[key], key


def test_engine_zero_prefix_by_default_matches_reference(served):
    (_, ref0), (_, port0) = served["reference"], served["port"]
    assert port0["tokens"] == ref0["tokens"]
    assert len(port0["tokens"][0]) == 4


def test_text_models_reject_prefix_embeds():
    cfg = t_smoke_config(t_get_config("qwen1.5-0.5b"))
    model = tlm.LM(cfg, torch.device("cpu"))
    eng = TEngine(cfg, model, max_running=1, max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        eng.submit([1, 2, 3], 2, prefix_embeds=np.zeros((1, 4, cfg.d_model)))


def test_vlm_rejects_a_prefix_of_the_wrong_size(models):
    _, _, tcfg, model = models
    eng = TEngine(tcfg, model, device="cpu", **KNOBS)
    with pytest.raises(ValueError, match="prefix"):
        eng.submit([1, 2], 2, prefix_embeds=np.zeros((3, tcfg.d_model)))


def test_vlm_requests_share_no_prefix_and_drop_it_on_retire(models):
    """Two requests of one prompt: no prefix adopted (the image is not in
    the prompt's hash), nothing published to the index; a finished
    request holds no prefix block."""
    cfg, _, tcfg, model = models
    prompts, pres = _requests(cfg)
    eng = TEngine(tcfg, model, device="cpu", **KNOBS)
    assert eng.kv.sharing
    rs = [eng.submit(prompts[0], 3, prefix_embeds=pre) for pre in pres]
    eng.run(400)
    assert eng.kv.prefix_hits == 0 and eng.kv.adopted_tokens == 0
    assert eng.kv.stats()["cache"]["nodes"] == 0
    assert all(r.done and r.prefix_embeds is None for r in rs)


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------
def _snapshot_run(tcfg, model, after=5):
    """The reference test's requests, snapshotted after ``after`` steps;
    the original runs to its end, the snapshot is restored and run to its
    end. Returns (original tokens, restored tokens, snapshot)."""
    prompts, pres = _requests(tcfg)
    eng = TEngine(tcfg, model, device="cpu", **KNOBS)
    reqs = [eng.submit(p, 4, prefix_embeds=pre)
            for p, pre in zip(prompts, pres)]
    for _ in range(after):
        eng.step()
    snap = eng.snapshot()
    eng.run(400)
    restored = TEngine.restore(tcfg, model, snap, device="cpu")
    restored.run(400)
    got = {r.rid: list(r.generated) for r in restored.finished}
    return ([list(r.generated) for r in reqs],
            [got[r.rid] for r in reqs], snap)


def _inflight_prefix(snap):
    return [d["prefix_embeds"] for d in snap["running"] + snap["waiting"]
            if d["n_prefix"]]


def test_snapshot_restore_mid_stream_float32(models):
    _, _, tcfg, model = models
    want, got, snap = _snapshot_run(tcfg, model)
    assert got == want
    held = _inflight_prefix(snap)
    assert held and all(isinstance(a, np.ndarray)
                        and a.dtype == np.float32 for a in held)


def test_snapshot_restore_mid_stream_bf16_raw_words(models):
    _, params, _, _ = models
    tcfg = t_smoke_config(t_get_config(ARCH)).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    want, got, snap = _snapshot_run(tcfg, model)
    assert got == want
    held = _inflight_prefix(snap)
    assert held and all(a.dtype == np.int16 for a in held)
    prompts, pres = _requests(tcfg)
    words = torch.from_numpy(pres[0]).to(torch.bfloat16).view(torch.int16)
    assert any(np.array_equal(a, words.numpy()) for a in held)
    # a float32 prefix in a bf16 engine's snapshot is refused up front
    bad = dict(snap, running=[dict(d, prefix_embeds=np.zeros(
        (1, tcfg.n_prefix_embeds, tcfg.d_model), np.float32))
        for d in snap["running"] + snap["waiting"]], waiting=[])
    with pytest.raises(ValueError, match="prefix_embeds"):
        TEngine.restore(tcfg, model, bad, device="cpu")


def test_serve_cli_serves_the_smoke_config(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "(planes: kv)" in out
    assert "served 3 requests" in out
