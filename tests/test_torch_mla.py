"""The port's MLA on the paged latent plane (``repro_torch/layers/mla.py``)
and the deepseek-v2-lite-16b model against the JAX reference, on the CPU.

Weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the deepseek-v2-lite-16b smoke config (float32: MLA rank 64, nope 32, rope
16, v 32; 4 experts top-2, 1 shared) and are carried over with
``from_jax``; pools, tables and plans are made with numpy from a seed.
Tolerance rtol 1e-4 / atol 1e-5 (``tests/test_torch_model.py``'s TOL);
pools compared at every page but the scratch page, which takes
duplicate-index writes (idle lanes, pad rows, a window's scratch padding)
whose winner neither framework defines and no read sees unmasked.

- ``write_chunk_latent_pages``: one indexed write of every chunk row
  against the reference's per-row window update (``dynamic_slice`` of the
  table, clamped to fit it): mid-page, across pages, Tc below a page, a
  pad row, a window reaching the table's end.
- ``mla_prefill_chunk`` (non-absorbed), ``mla_decode_paged`` (absorbed),
  ``mla_mixed_paged`` (both regions of a packed step): outputs and pools.
- ``serve_step_paged`` with ``impl`` ``"kernel"`` and ``"ref"``, and the
  per-request path ``prefill_chunk_paged`` -> ``decode_step_paged``:
  logits at TOL, greedy tokens exactly, the pools after the path.
- ``paged_layout``, ``from_jax`` (every weight), ``param_count`` at full
  width (computed from the configs, no model built), the port's own
  ``init_params`` keys, shapes and scales.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.layers import mla as jmla
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro.serving.scheduler import bucket_tokens
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.layers import mla as tmla
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime

ARCH = "deepseek-v2-lite-16b"
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


def _real_pages(a):
    return np.delete(np.asarray(a), SCRATCH, axis=0)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])


def _plan(cfg, seed=0, R=4, Tc=16):
    """Rows: decode at 9, decode at 20, a 6-token chunk from 5 (mid-page),
    a pad row on scratch; every real row its own pages."""
    rng = np.random.default_rng(seed)
    C = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    pool = rng.standard_normal((P, PAGE, C)).astype(np.float32)
    bt = np.full((cfg.n_layers, 1, R, PPS_PAD), SCRATCH, np.int32)
    for l in range(cfg.n_layers):
        pages = rng.permutation(np.arange(1, P))[:(R - 1) * PPS]
        bt[l, 0, :R - 1, :PPS] = pages.reshape(R - 1, PPS)
    return dict(pool=pool, bt=bt,
                tokens=rng.integers(0, cfg.vocab_size, (R, Tc)).astype(
                    np.int32),
                x=rng.standard_normal((R, Tc, cfg.d_model)).astype(
                    np.float32),
                q_starts=np.asarray([9, 20, 5, 0], np.int32),
                n_reals=np.asarray([1, 1, 6, 0], np.int32), n_decode=2)


# -- the chunk write ---------------------------------------------------------
WRITE_CASES = {          # (start, Tc) per chunk row; page 8, table of 8
    "mid_page": [(5, 6)],
    "across_pages": [(13, 16)],
    "below_a_page": [(17, 3)],
    "window_at_the_table_end": [(58, 8)],     # dynamic_slice clamps
    "rows_and_a_pad_row": [(3, 16), (24, 16), (0, 16)],
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_chunk_latent_pages_matches_reference(case):
    rows = WRITE_CASES[case]
    rng = np.random.default_rng(len(case))
    C, R = 12, len(rows)
    Tc = max(t for _, t in rows)
    pool = rng.standard_normal((P, PAGE, C)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:R * PPS_PAD].reshape(
        R, PPS_PAD).astype(np.int32)
    if case == "rows_and_a_pad_row":
        bt[-1] = SCRATCH
        bt[0, 4:] = SCRATCH                       # the table's padding
    lat = rng.standard_normal((R, Tc, C)).astype(np.float32)
    starts = np.asarray([s for s, _ in rows], np.int32)
    pps_win = Tc // PAGE + (1 if Tc % PAGE else 0) + 1
    want = jnp.asarray(pool)
    for r in range(R):
        win = jax.lax.dynamic_slice(jnp.asarray(bt[r]),
                                    (int(starts[r]) // PAGE,), (pps_win,))
        want = jmla.write_chunk_latent_pages(
            want, jnp.asarray(lat[r:r + 1]), win, int(starts[r]) % PAGE,
            page_tokens=PAGE)
    got = torch.from_numpy(pool.copy())
    idx = torch.from_numpy(tmla.window_rows(starts, Tc, PAGE, PPS_PAD))
    tmla.write_chunk_latent_pages(got, torch.from_numpy(lat),
                                  torch.from_numpy(bt), idx)
    np.testing.assert_array_equal(_real_pages(got.numpy()),
                                  _real_pages(want))


def test_window_rows_refuse_a_window_wider_than_the_table():
    with pytest.raises(ValueError, match="window"):
        tmla.window_rows([0], 40, PAGE, 4)


# -- the layer functions -----------------------------------------------------
def test_mla_prefill_chunk_matches_reference(models):
    """A 16-token chunk from position 5 (mid-page, across pages): window
    write, then non-absorbed attention over the first PPS pages."""
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=3)
    bt = p["bt"][0, 0, 0]
    x = p["x"][:1]
    jout, jpool = jmla.mla_prefill_chunk(
        _layer0(params), cfg, jnp.asarray(x), jnp.asarray(p["pool"]),
        jnp.asarray(bt), jnp.int32(5), read_pps=PPS)
    tout, tpool = tmla.mla_prefill_chunk(
        model.blocks[0].mix, tcfg, torch.from_numpy(x),
        torch.from_numpy(p["pool"].copy()), torch.from_numpy(bt), 5,
        read_pps=PPS)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_real_pages(tpool.numpy()),
                               _real_pages(jpool), **TOL)


def test_mla_decode_paged_matches_reference(models):
    """Three lanes at 9, 20 and 31 (the last page's last row) and an idle
    lane on scratch: absorbed attention with q_eff in the compute dtype."""
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=4)
    bt = p["bt"][0, 0, :, :PPS]
    pos = np.asarray([9, 20, 31, 0], np.int32)
    x = p["x"][:, :1]
    jout, jpool = jmla.mla_decode_paged(
        _layer0(params), cfg, jnp.asarray(x), jnp.asarray(p["pool"]),
        jnp.asarray(bt), jnp.asarray(pos))
    tout, tpool = tmla.mla_decode_paged(
        model.blocks[0].mix, tcfg, torch.from_numpy(x),
        torch.from_numpy(p["pool"].copy()), torch.from_numpy(bt), pos)
    np.testing.assert_allclose(tout.numpy()[:3], np.asarray(jout)[:3], **TOL)
    np.testing.assert_allclose(_real_pages(tpool.numpy()),
                               _real_pages(jpool), **TOL)


@pytest.mark.parametrize("n_decode", [0, 2, 4])
def test_mla_mixed_paged_matches_reference(models, n_decode):
    """The packed step's MLA: decode lanes only, both regions, chunk rows
    only."""
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=1)
    qs, nr = p["q_starts"].copy(), p["n_reals"].copy()
    if n_decode == 0:
        qs[:2], nr[:2] = (3, 17), (9, 16)
    if n_decode == 4:
        qs[2:], nr[2:] = (31, 0), 1
    Tc = 1 if n_decode == 4 else 16
    x = p["x"][:, :Tc]
    bt = p["bt"][0, 0]
    jout, jpool = jmla.mla_mixed_paged(
        _layer0(params), cfg, jnp.asarray(x), jnp.asarray(p["pool"]),
        jnp.asarray(bt), jnp.asarray(qs), jnp.asarray(nr), n_decode=n_decode,
        read_pps=PPS)
    tout, tpool = tmla.mla_mixed_paged(
        model.blocks[0].mix, tcfg, torch.from_numpy(x),
        torch.from_numpy(p["pool"].copy()), torch.from_numpy(bt), qs, nr,
        n_decode=n_decode, read_pps=PPS)
    np.testing.assert_allclose(tout.numpy()[:3], np.asarray(jout)[:3], **TOL)
    np.testing.assert_allclose(_real_pages(tpool.numpy()),
                               _real_pages(jpool), **TOL)


# -- the model entry points --------------------------------------------------
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_serve_step_paged_matches_reference(models, impl):
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=2)
    jlog, jpools = japi.serve_step_paged(
        params, cfg, jnp.asarray(p["tokens"]),
        {"mla": jnp.asarray(p["pool"])}, {"mla": jnp.asarray(p["bt"])},
        jnp.asarray(p["q_starts"]), jnp.asarray(p["n_reals"]),
        n_decode=p["n_decode"], read_pps=PPS, impl="pallas")
    tlog, tpools = tapi.serve_step_paged(
        model, tcfg, p["tokens"], {"mla": torch.from_numpy(p["pool"].copy())},
        {"mla": p["bt"]}, p["q_starts"], p["n_reals"],
        n_decode=p["n_decode"], read_pps=PPS, impl=impl)
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    np.testing.assert_allclose(_real_pages(tpools["mla"].numpy()),
                               _real_pages(jpools["mla"]), **TOL)
    with pytest.raises(ValueError, match="impl"):
        tapi.serve_step_paged(
            model, tcfg, p["tokens"], tpools, {"mla": p["bt"]},
            p["q_starts"], p["n_reals"], n_decode=2, impl="pallas")


# prompts and their chunk splits: chunks start mid-page (page 8) at 5, 14
# and 13, and the buckets pad each chunk to 8 or 16 rows
PROMPTS = ((19, (5, 9, 5)), (11, (11,)), (26, (13, 13)))


def _runtimes(cfg, tcfg):
    kw = dict(max_seq=64, page_tokens=8, max_running=3)
    return JRuntime(cfg, **kw), TRuntime(tcfg, device="cpu", **kw)


def test_per_request_path_matches_reference(models):
    """Three prompts prefilled chunk by chunk through
    ``prefill_chunk_paged`` into each package's runtime, then 6 steps of
    ``decode_step_paged`` over the three lanes: logits within TOL, greedy
    tokens identical, the latent pools equal off scratch."""
    cfg, params, tcfg, model = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in PROMPTS]
    jkv, tkv = _runtimes(cfg, tcfg)
    pad = jkv.pps + 16 // 8 + 1
    tokens = {"jax": [], "torch": []}
    for rid, ((n, splits), prompt) in enumerate(zip(PROMPTS, prompts)):
        pos = 0
        for c in splits:
            tk = np.zeros((1, bucket_tokens(c)), np.int32)
            tk[0, :c] = prompt[pos:pos + c]
            for kv in (jkv, tkv):
                kv.ensure_capacity(rid, pos + c)
            jlog, jkv.pools = japi.prefill_chunk_paged(
                params, cfg, jnp.asarray(tk), jkv.pools,
                jkv.block_tables_prefill(rid, pad_to=pad), jnp.int32(pos),
                jnp.int32(c - 1), read_pps=jkv.pps, impl="xla")
            tlog, tkv.pools = tapi.prefill_chunk_paged(
                model, tcfg, tk, tkv.pools,
                tkv.block_tables_prefill(rid, pad_to=pad), pos, c - 1,
                read_pps=tkv.pps)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
            pos += c
        tokens["jax"].append([int(np.argmax(np.asarray(jlog)[0]))])
        tokens["torch"].append([int(tlog[0].argmax())])
    lanes = list(range(len(PROMPTS)))
    for step in range(6):
        pos = np.asarray([n + step for n, _ in PROMPTS], np.int32)
        for kv in (jkv, tkv):
            for rid in lanes:
                kv.ensure_capacity(rid, int(pos[rid]) + 1)
        last = {k: np.asarray([t[-1] for t in v], np.int32)
                for k, v in tokens.items()}
        jlog, jkv.pools = japi.decode_step_paged(
            params, cfg, jkv.pools, jkv.block_tables(lanes),
            jnp.asarray(last["jax"]), jnp.asarray(pos), impl="xla")
        tlog, tkv.pools = tapi.decode_step_paged(
            model, tcfg, tkv.pools, tkv.block_tables(lanes), last["torch"],
            pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        for k, lg in (("jax", np.asarray(jlog)), ("torch", tlog.numpy())):
            for rid in lanes:
                tokens[k][rid].append(int(np.argmax(lg[rid])))
    assert tokens["torch"] == tokens["jax"]
    assert all(len(t) == 7 for t in tokens["torch"])
    np.testing.assert_allclose(_real_pages(tkv.pools["mla"].numpy()),
                               _real_pages(jkv.pools["mla"]), **TOL)


def test_paged_layout_matches_reference(models):
    cfg, _, tcfg, _ = models
    for c, tc in ((cfg, tcfg), (get_config(ARCH), t_get_config(ARCH))):
        j, t = jlm.paged_layout(c), tlm.paged_layout(tc)
        assert list(t) == list(j) == ["mla"]
        for key in ("kind", "positions", "dims", "token_bytes", "shareable"):
            assert t["mla"][key] == j["mla"][key], key
    full = tlm.paged_layout(t_get_config(ARCH))["mla"]
    assert full["dims"] == (576,) and full["token_bytes"] == 1152
    assert tlm.supports_paged(tcfg) and tapi.supports_paged(tcfg)
    assert tlm.mixer_kind(tcfg) == "mla" and tlm.ffn_kind(tcfg) == "moe"


def test_param_count_matches_reference_at_full_width():
    for arch in (ARCH, "qwen1.5-0.5b", "rwkv6-3b"):
        assert t_get_config(arch).param_count() == \
            get_config(arch).param_count(), arch
    assert t_get_config(ARCH).param_count() == 16_210_309_120
    assert t_smoke_config(t_get_config(ARCH)).param_count() == \
        smoke_config(get_config(ARCH)).param_count()


def test_from_jax_carries_every_weight(models):
    """Every parameter of the port equals its leaf of the reference tree
    (layer l of the stacked ``blocks.sub0``), and the counts agree."""
    _, params, _, model = models
    tree = jax.tree.map(np.asarray, params)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            leaf = tree["blocks"]["sub0"]
            for key in parts[2:]:
                leaf = leaf[key]
            want = leaf[int(parts[1])]
        else:
            leaf = tree
            for key in parts:
                leaf = leaf[key]
            want = leaf
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=name)


def test_init_params_keys_shapes_and_scales_match_reference(models):
    cfg, params, tcfg, carried = models
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(p.shape)
                      for n, p in carried.named_parameters()}
    m = cfg.mla
    for name, want in (("embed.tok", 0.02),
                       ("embed.head", cfg.d_model ** -0.5),
                       ("blocks.0.mix.wq.w", cfg.d_model ** -0.5),
                       ("blocks.0.mix.wuk.w", m.kv_lora_rank ** -0.5),
                       ("blocks.0.ffn.down",
                        cfg.moe.d_ff_expert ** -0.5)):
        got = dict(model.named_parameters())[name].std().item()
        ref = float(np.std(np.asarray(
            dict(carried.named_parameters())[name].detach())))
        assert abs(got / ref - 1) < 0.1, name
        assert abs(got / (0.88 * want) - 1) < 0.1, name
    for name, p in model.named_parameters():
        if name.endswith(".b") or name.endswith("scale"):
            assert not p.any(), name


def test_training_is_refused(models):
    """What training still refuses: a low-rank MLA query. The MLA / MoE
    training forward itself (``mla_full``, capacity dispatch) equals the
    reference's ``forward``: logits and the summed aux loss."""
    cfg, params, tcfg, model = models
    with pytest.raises(NotImplementedError, match="low-rank"):
        tmla.MLA(tcfg.replace(mla=dataclasses.replace(tcfg.mla,
                                                      q_lora_rank=32)),
                 torch.device("cpu"))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, want_aux = jlm.forward(params, cfg, jnp.asarray(toks))
    got, aux = tlm.forward(model, tcfg, toks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
