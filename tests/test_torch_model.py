"""The port's paged layers and model entry points against the JAX
reference: the fused step's mixed attention and ``serve_step_paged``, and
the per-request chunked prefill and decode (``attention_prefill_chunk``,
``attention_decode_paged``, ``prefill_chunk_paged``, ``decode_step_paged``,
``block_tables_prefill``).

Weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the qwen1.5-0.5b smoke config (float32) and are carried over with
``from_jax``; pools and plans are made with numpy from a seed. The plan packs
two decode lanes, a chunk row starting mid-page and a bucket-pad row; the
reference runs with ``impl="pallas"`` (its kernels in interpret mode on the
CPU). Outputs/logits of every row but the pad row and every pool page but
the scratch page must agree at rtol 1e-4 / atol 1e-5: the pad row and the
scratch page take duplicate-index writes whose winner neither framework
defines, and no later read sees them unmasked. The whole per-request path
(prompts prefilled in mid-page chunks, then batched decode) runs the
reference with ``impl="xla"``, its plain versions, and must give the same
logits at that tolerance and exactly the same greedy tokens.
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
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro.serving.scheduler import bucket_tokens
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.layers import attention as tattn
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime

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


def test_attention_prefill_chunk_matches_reference(models):
    """A 16-token chunk from position 5 (mid-page): window write and chunk
    attention over the first PPS pages."""
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=3)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])
    bt, x = p["bt"][0, 0, 0], p["x"][:1]
    jout, jpool = jattn.attention_prefill_chunk(
        jp, cfg, jnp.asarray(x), jnp.asarray(p["pool"]), jnp.asarray(bt),
        5, read_pps=PPS, impl="pallas")
    tout, tpool = tattn.attention_prefill_chunk(
        model.blocks[0].mix, tcfg, torch.from_numpy(x),
        torch.from_numpy(p["pool"].copy()), torch.from_numpy(bt), 5,
        read_pps=PPS, impl="kernel")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_real_pages(tpool.numpy()),
                               _real_pages(jpool), **TOL)


def test_attention_decode_paged_matches_reference(models):
    """Three lanes at 9, 20 and 31 (the last position of its fourth page)
    append their token and attend over the whole table."""
    cfg, params, tcfg, model = models
    p = _plan(cfg, seed=4)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])
    bt = np.ascontiguousarray(p["bt"][0, 0, :3, :PPS])
    x = p["x"][:3, :1]
    pos = np.asarray([9, 20, 31], np.int32)
    jout, jpool = jattn.attention_decode_paged(
        jp, cfg, jnp.asarray(x), jnp.asarray(p["pool"]), jnp.asarray(bt),
        jnp.asarray(pos), impl="pallas")
    tout, tpool = tattn.attention_decode_paged(
        model.blocks[0].mix, tcfg, torch.from_numpy(x),
        torch.from_numpy(p["pool"].copy()), torch.from_numpy(bt), pos,
        impl="kernel")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_real_pages(tpool.numpy()),
                               _real_pages(jpool), **TOL)


def _runtimes(cfg, tcfg):
    kw = dict(max_seq=64, page_tokens=8, max_running=3)
    return JRuntime(cfg, **kw), TRuntime(tcfg, device="cpu", **kw)


def test_block_tables_prefill_matches_reference(models):
    cfg, _, tcfg, _ = models
    jkv, tkv = _runtimes(cfg, tcfg)
    for kv in (jkv, tkv):
        kv.ensure_capacity(0, 19)
        kv.ensure_capacity(1, 5)
        kv.ensure_capacity(0, 30)
    for rid, pad in ((0, None), (0, 13), (1, 13)):
        j = np.asarray(jkv.block_tables_prefill(rid, pad_to=pad)["kv"])
        t = tkv.block_tables_prefill(rid, pad_to=pad)["kv"]
        assert t.dtype == np.int32 and t.shape == j.shape
        np.testing.assert_array_equal(t, j)


# prompts and their chunk splits: chunks start mid-page (page 8) at 5, 14
# and 13, and the buckets pad each chunk to 8 or 16 rows
PROMPTS = ((19, (5, 9, 5)), (11, (11,)), (26, (13, 13)))


def test_per_request_path_matches_reference(models):
    """Three prompts prefilled chunk by chunk through
    ``prefill_chunk_paged`` into each package's runtime, then 8 steps of
    ``decode_step_paged`` over the three lanes: logits within TOL, greedy
    tokens identical."""
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
    for step in range(8):
        pos = np.asarray([n + step for n, _ in PROMPTS], np.int32)
        for kv in (jkv, tkv):
            for rid in lanes:
                kv.ensure_capacity(rid, int(pos[rid]) + 1)
        logits = {}
        last = {k: np.asarray([t[-1] for t in v], np.int32)
                for k, v in tokens.items()}
        jlog, jkv.pools = japi.decode_step_paged(
            params, cfg, jkv.pools, jkv.block_tables(lanes),
            jnp.asarray(last["jax"]), jnp.asarray(pos), impl="xla")
        tlog, tkv.pools = tapi.decode_step_paged(
            model, tcfg, tkv.pools, tkv.block_tables(lanes), last["torch"],
            pos)
        logits["jax"], logits["torch"] = np.asarray(jlog), tlog.numpy()
        np.testing.assert_allclose(logits["torch"], logits["jax"], **TOL)
        for k in tokens:
            for rid in lanes:
                tokens[k][rid].append(int(np.argmax(logits[k][rid])))
    assert tokens["torch"] == tokens["jax"]
    for name in ("jax", "torch"):
        assert all(len(t) == 9 for t in tokens[name])


def test_per_request_entry_points_reject_out_of_pool_slots(models):
    cfg, _, tcfg, model = models
    p = _plan(cfg)
    pool = {"kv": torch.from_numpy(p["pool"])}
    bt = p["bt"][:, :, 0].copy()
    bt[2, 0, 1] = P
    with pytest.raises(ValueError, match="outside the pool"):
        tlm.prefill_chunk_paged(model, tcfg, p["tokens"][:1], pool,
                                {"kv": bt}, 0, 3, read_pps=PPS)
    with pytest.raises(ValueError, match="outside the pool"):
        tlm.decode_step_paged(model, tcfg, pool, {"kv": p["bt"] - 1},
                              p["tokens"][:, 0], p["q_starts"])


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
