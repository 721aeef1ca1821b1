"""The port's RWKV-6 family against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the rwkv6-3b smoke config (float32) and are carried over with ``from_jax``.

- The WKV recurrence: the port's sequential ``wkv6_ref``, chunked
  ``wkv6_chunked`` and ``ops.wkv6`` (its CPU twin) against the reference's
  Pallas ``wkv6`` in interpret mode and its ``wkv6_ref``, over the sweep of
  ``tests/test_kernels.py::test_wkv6_sweep`` with its tolerances (float32
  rtol 1e-3 / atol 5e-4; bfloat16 rtol 2e-2 / atol 5e-2, the bf16 output
  rounding of a state that grows to ~1e2 under weak decay); chunk
  invariance over C 16/32/64; lengths no chunk divides.
- The layers (time-mix, channel-mix, block) with a per-lane ``n_real``, the
  fused step ``serve_step_paged`` and the per-request path
  ``prefill_chunk_paged`` -> ``decode_step_paged``: outputs, logits and the
  ``wkv``/``shift`` pools at rtol 1e-4 / atol 1e-5 (float32; the two
  frameworks sum in other orders; atol 1e-4 for the pools after a whole
  prompt, whose wkv entries grow to ~10), greedy tokens exactly; the reference
  runs its plain path (``impl="xla"``; RWKV has no other). Scratch pages
  and pad rows are left out: idle lanes and pad rows all write the scratch
  state page, in an order neither framework defines.
- The runtime: fresh state pages are zero on slot reuse, a park/restore
  round trip mid-prefill and mid-decode leaves every logit bit-identical,
  and the block tables of the state planes equal the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core.aqua_tensor import REMOTE as J_REMOTE
from repro.kernels.rwkv6_wkv.kernel import wkv6 as j_wkv6_kernel
from repro.layers import rwkv6 as jrwkv
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro.serving.scheduler import bucket_tokens
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import REMOTE as T_REMOTE
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.layers import rwkv6 as trwkv
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime

ARCH = "rwkv6-3b"
TOL = dict(rtol=1e-4, atol=1e-5)
# the wkv state sums ~1e2 outer products to entries of up to ~10, so its
# absolute float32 error is ~10x a logit's
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
SWEEP = [(2, 64, 3, 32, 0.1), (1, 128, 2, 64, 1.0), (2, 96, 4, 32, 5.0)]
WKV_TOL = {"float32": dict(rtol=1e-3, atol=5e-4),
           "bfloat16": dict(rtol=2e-2, atol=5e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _wkv_inputs(B, T, H, hd, wmax, seed=4):
    """r, k, v, w, u, s0 as numpy float32 (the sweep's distributions)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = -rng.uniform(1e-3, wmax, (B, T, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _both(arrs, dtype):
    """(r, k, v) in ``dtype`` and (w, u, s0) in float32, for each side."""
    jd, td = DTYPES[dtype]
    j = [jnp.asarray(a).astype(jd) for a in arrs[:3]] \
        + [jnp.asarray(a) for a in arrs[3:]]
    t = [torch.from_numpy(a).to(td) for a in arrs[:3]] \
        + [torch.from_numpy(a) for a in arrs[3:]]
    return j, t


@functools.lru_cache(maxsize=None)
def _reference_wkv(case, dtype):
    """The reference's Pallas kernel (interpret mode) on one sweep case,
    computed once per case."""
    j, _ = _both(_wkv_inputs(*case), dtype)
    y, s = j_wkv6_kernel(*j, chunk=32, interpret=True)
    return np.asarray(y, np.float32), np.asarray(s)


PORT_WKV = {"wkv6_ref": wkv_ref.wkv6_ref, "wkv6_chunked": wkv_ref.wkv6_chunked,
            "ops.wkv6": wkv_ops.wkv6}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("fn", list(PORT_WKV))
def test_wkv6_sweep_matches_pallas_kernel(fn, case, dtype):
    _, t = _both(_wkv_inputs(*case), dtype)
    y, s = PORT_WKV[fn](*t)
    assert y.dtype == t[0].dtype and s.dtype == torch.float32
    jy, js = _reference_wkv(case, dtype)
    np.testing.assert_allclose(y.float().numpy(), jy, **WKV_TOL[dtype])
    np.testing.assert_allclose(s.numpy(), js, **WKV_TOL[dtype])


@pytest.mark.parametrize("case", SWEEP[:2], ids=lambda c: "x".join(map(str,
                                                                       c)))
def test_wkv6_scan_matches_reference_scan(case):
    j, t = _both(_wkv_inputs(*case), "float32")
    jy, js = jrwkv.wkv6_ref(*j)
    y, s = wkv_ref.wkv6_ref(*t)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_wkv6_chunk_invariance():
    """The chunked form at C 16/32/64 agrees with itself and with the
    reference scan (the reference's test_wkv6_chunk_invariance)."""
    r, k, v, w, u, _ = _wkv_inputs(1, 128, 2, 32, 2.0, seed=5)
    s0 = np.zeros((1, 2, 32, 32), np.float32)
    j, t = _both((r, k, v, w, u, s0), "float32")
    outs = [wkv_ref.wkv6_chunked(*t, chunk=c)[0].numpy() for c in (16, 32,
                                                                   64)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=5e-4)
    np.testing.assert_allclose(outs[1], np.asarray(jrwkv.wkv6_ref(*j)[0]),
                               atol=5e-4)


@pytest.mark.parametrize("T", [1, 24, 70])
def test_wkv6_lengths_no_chunk_divides(T):
    """T = 1 (a decode lane), 24 (a short bucket) and 70 (past two chunks,
    not a multiple of 32): the CPU twin takes the scan, as the reference's
    dispatch does, and agrees with the reference's chunked form where it
    falls back too."""
    j, t = _both(_wkv_inputs(2, T, 2, 32, 5.0, seed=T), "float32")
    jy, js = jrwkv.wkv6_chunked(*j)
    for fn in (wkv_ops.wkv6, wkv_ref.wkv6_plain, wkv_ref.wkv6_chunked):
        y, s = fn(*t)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   **WKV_TOL["float32"])
        np.testing.assert_allclose(s.numpy(), np.asarray(js),
                                   **WKV_TOL["float32"])
    assert build.launch_counts().get("wkv6", 0) == 0


# ---------------------------------------------------------------------------
# layers, model steps and the runtime
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def test_from_jax_carries_every_rwkv_weight(models):
    """Every parameter of the port equals its leaf of the reference tree
    (layer l of the stacked ``blocks.sub0``), and the counts agree."""
    cfg, params, tcfg, model = models
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


def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    return (rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1,
            rng.standard_normal((B, cfg.d_model)).astype(np.float32),
            rng.standard_normal((B, cfg.d_model)).astype(np.float32))


N_REAL = np.asarray([16, 5, 1, 0], np.int32)    # full, partial, one, pad


def test_init_rwkv_state_matches_reference(models):
    cfg, _, tcfg, _ = models
    want = jrwkv.init_rwkv_state(cfg, 3, jnp.bfloat16)
    got = trwkv.init_rwkv_state(tcfg, 3, torch.bfloat16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_layers_match_reference_with_per_lane_n_real(models):
    cfg, params, tcfg, model = models
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    wkv, tms, cms = _state(cfg, 4, 8)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"])
    blk = model.blocks[0]
    tx = torch.from_numpy(x)
    j_out, j_sh, j_wkv = jrwkv.rwkv_time_mix(
        jp["mix"]["tm"], cfg, jnp.asarray(x), jnp.asarray(tms),
        jnp.asarray(wkv), n_real=jnp.asarray(N_REAL))
    t_out, t_sh, t_wkv = trwkv.rwkv_time_mix(
        blk.mix.tm, tcfg, tx, torch.from_numpy(tms), torch.from_numpy(wkv),
        n_real=N_REAL)
    for got, want in ((t_out, j_out), (t_sh, j_sh), (t_wkv, j_wkv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    j_out, j_sh = jrwkv.rwkv_channel_mix(jp["mix"]["cm"], jnp.asarray(x),
                                         jnp.asarray(cms),
                                         n_real=jnp.asarray(N_REAL))
    t_out, t_sh = trwkv.rwkv_channel_mix(blk.mix.cm, tx,
                                         torch.from_numpy(cms), N_REAL)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_sh.numpy(), np.asarray(j_sh), **TOL)
    for impl in ("kernel", "ref"):
        jx, jst = jrwkv.rwkv_block(
            jp["mix"], cfg, jnp.asarray(x),
            jrwkv.RWKVState(*map(jnp.asarray, (wkv, tms, cms))),
            {"n1": jp["n1"], "n2": jp["n2"]}, n_real=jnp.asarray(N_REAL))
        tx2, tst = trwkv.rwkv_block(
            blk.mix, tcfg, tx,
            trwkv.RWKVState(*map(torch.from_numpy, (wkv, tms, cms))),
            {"n1": blk.n1, "n2": blk.n2}, impl=impl, n_real=N_REAL)
        np.testing.assert_allclose(tx2.numpy(), np.asarray(jx), **TOL)
        for got, want in zip(tst, jst):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# packed step: two decode lanes, a 12-token chunk, a pad row (scratch = 0)
P_STATE = 12


def _mixed_plan(cfg, seed=0):
    rng = np.random.default_rng(seed)
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    L, R, Tc = cfg.n_layers, 4, 16
    pools = {"wkv": rng.standard_normal((P_STATE, H, hd, hd))
             .astype(np.float32) * 0.1,
             "shift": rng.standard_normal((P_STATE, 2, cfg.d_model))
             .astype(np.float32)}
    bt = np.zeros((L, 1, R), np.int32)
    for l in range(L):
        bt[l, 0, :3] = rng.choice(np.arange(1, P_STATE), 3, replace=False)
    return dict(pools=pools, bt={"wkv": bt, "shift": bt.copy()},
                tokens=rng.integers(0, cfg.vocab_size, (R, Tc))
                .astype(np.int32),
                q_starts=np.asarray([9, 20, 4, 0], np.int32),
                n_reals=np.asarray([1, 1, 12, 0], np.int32), n_decode=2)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_serve_step_paged_matches_reference(models, impl):
    cfg, params, tcfg, model = models
    p = _mixed_plan(cfg, seed=2)
    jlog, jpools = japi.serve_step_paged(
        params, cfg, jnp.asarray(p["tokens"]),
        {k: jnp.asarray(v) for k, v in p["pools"].items()},
        {k: jnp.asarray(v) for k, v in p["bt"].items()},
        jnp.asarray(p["q_starts"]), jnp.asarray(p["n_reals"]),
        n_decode=p["n_decode"], impl="xla")
    tlog, tpools = tapi.serve_step_paged(
        model, tcfg, p["tokens"],
        {k: torch.from_numpy(v.copy()) for k, v in p["pools"].items()},
        p["bt"], p["q_starts"], p["n_reals"], n_decode=p["n_decode"],
        impl=impl)
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    for name in ("wkv", "shift"):
        np.testing.assert_allclose(tpools[name].numpy()[1:],
                                   np.asarray(jpools[name])[1:], **TOL)


def _runtimes(cfg, tcfg, **kw):
    kw = {**dict(max_seq=64, page_tokens=8, max_running=3), **kw}
    return JRuntime(cfg, **kw), TRuntime(tcfg, device="cpu", **kw)


def test_block_tables_of_state_planes_match_reference(models):
    cfg, _, tcfg, _ = models
    jkv, tkv = _runtimes(cfg, tcfg)
    for kv in (jkv, tkv):
        kv.ensure_capacity(0, 19)
        kv.ensure_capacity(2, 5)
    for name in ("wkv", "shift"):
        j = np.asarray(jkv.block_tables_prefill(0, pad_to=7)[name])
        t = tkv.block_tables_prefill(0, pad_to=7)[name]
        assert t.shape == j.shape == (cfg.n_layers, 1)
        np.testing.assert_array_equal(t, j)
        j = np.asarray(jkv.block_tables([2, None, 0])[name])
        t = tkv.block_tables([2, None, 0])[name]
        assert t.shape == j.shape == (cfg.n_layers, 1, 3)
        np.testing.assert_array_equal(t, j)
    assert tkv.pages_per_request(40).tolist() == \
        jkv.pages_per_request(40).tolist() == [cfg.n_layers] * 2
    assert tkv.footprint_bytes(40) == jkv.footprint_bytes(40)
    assert not tkv.sharing and tkv.cow_reserve().tolist() == [0, 0]
    assert tlm.paged_layout(tcfg)["wkv"]["shape"] == \
        jlm.paged_layout(cfg)["wkv"]["shape"]


# prompts and their chunk splits: a 70-token chunk at the reference's
# chunked threshold bucket (128 rows), and short buckets
PROMPTS = ((19, (5, 9, 5)), (11, (11,)), (70, (70,)))


def test_per_request_path_matches_reference(models):
    """Three prompts prefilled chunk by chunk through
    ``prefill_chunk_paged`` into each package's runtime, then 6 steps of
    ``decode_step_paged`` over the three lanes: logits and the state pools
    within TOL, greedy tokens identical."""
    cfg, params, tcfg, model = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in PROMPTS]
    jkv, tkv = _runtimes(cfg, tcfg, max_seq=128)
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
                jkv.block_tables_prefill(rid), jnp.int32(pos),
                jnp.int32(c - 1), impl="xla")
            tlog, tkv.pools = tapi.prefill_chunk_paged(
                model, tcfg, tk, tkv.pools, tkv.block_tables_prefill(rid),
                pos, c - 1)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
            pos += c
        tokens["jax"].append([int(np.argmax(np.asarray(jlog)[0]))])
        tokens["torch"].append([int(tlog[0].argmax())])
    lanes = list(range(len(PROMPTS)))
    for step in range(6):
        pos = np.asarray([n + step for n, _ in PROMPTS], np.int32)
        last = {k: np.asarray([t[-1] for t in v], np.int32)
                for k, v in tokens.items()}
        jlog, jkv.pools = japi.decode_step_paged(
            params, cfg, jkv.pools, jkv.block_tables(lanes),
            jnp.asarray(last["jax"]), jnp.asarray(pos), impl="xla")
        tlog, tkv.pools = tapi.decode_step_paged(
            model, tcfg, tkv.pools, tkv.block_tables(lanes), last["torch"],
            pos)
        logits = {"jax": np.asarray(jlog), "torch": tlog.numpy()}
        np.testing.assert_allclose(logits["torch"], logits["jax"], **TOL)
        for k in tokens:
            for rid in lanes:
                tokens[k][rid].append(int(np.argmax(logits[k][rid])))
    assert tokens["torch"] == tokens["jax"]
    for name in ("wkv", "shift"):
        np.testing.assert_allclose(tkv.pools[name].numpy()[1:],
                                   np.asarray(jkv.pools[name])[1:],
                                   **STATE_TOL)


def test_state_pages_zeroed_on_slot_reuse(models):
    """A freed state page's LOCAL slot still holds its last occupant's
    recurrent state; a new request allocating that slot must see the zero
    page (the initial state)."""
    _, _, tcfg, _ = models
    kv = TRuntime(tcfg, max_seq=64, page_tokens=8, max_running=1,
                  device="cpu")
    kv.ensure_capacity(0, 4)
    plane = kv.planes["wkv"]
    slots = [int(plane.aqua.page_table[row[0], 1])
             for row in plane.pages[0]]
    kv.pools["wkv"][torch.as_tensor(slots)] = 7.0     # a decoded state
    kv.release(0)
    kv.ensure_capacity(1, 4)
    new_slots = [int(plane.aqua.page_table[row[0], 1])
                 for row in plane.pages[1]]
    assert sorted(new_slots) == sorted(slots)
    assert float(kv.pools["wkv"][torch.as_tensor(new_slots)].abs().max()) \
        == 0.0


def _roundtrip_logits(tcfg, model, prompt, chunks, park, decode_steps=3):
    """Drive the runtime directly: chunked prefill then decode, parking to
    a REMOTE lease and restoring after every chunk and step when ``park``;
    returns every logits array."""
    kv = TRuntime(tcfg, max_seq=64, page_tokens=8, max_running=2,
                  device="cpu")
    kv.add_remote_lease("d0", 1 << 24)
    logs, pos = [], 0
    for c in chunks:
        kv.ensure_capacity(0, pos + c)
        toks = np.zeros((1, bucket_tokens(c)), np.int32)
        toks[0, :c] = prompt[pos:pos + c]
        lg, kv.pools = tapi.prefill_chunk_paged(
            model, tcfg, toks, kv.pools, kv.block_tables_prefill(0), pos,
            c - 1)
        pos += c
        if park:
            kv.park(0, pos, prefer=T_REMOTE)
            kv.restore(0)
    logs.append(lg.numpy())
    out = int(np.argmax(logs[-1][0]))
    for t in range(decode_steps):
        ctx = len(prompt) + t + 1
        kv.ensure_capacity(0, ctx)
        lg, kv.pools = tapi.decode_step_paged(
            model, tcfg, kv.pools, kv.block_tables([0, None]), [out, 0],
            [ctx - 1, 0])
        logs.append(lg[0].numpy())
        out = int(np.argmax(logs[-1]))
        if park:
            kv.park(0, ctx, prefer=T_REMOTE)
            kv.restore(0)
    return logs, kv.meter


def test_preemption_roundtrip_bit_identical(models):
    """Park mid-prefill AND mid-decode, restore, continue: every logits
    array is bit-identical to an unpreempted run with the same chunk
    schedule (the wkv and shift pages move byte-exact), and each park or
    restore moves the request's whole state, one message per leg."""
    cfg, _, tcfg, model = models
    prompt = list(map(int, np.random.default_rng(1).integers(
        0, cfg.vocab_size, 17)))
    base, _ = _roundtrip_logits(tcfg, model, prompt, [7, 10], False)
    parked, meter = _roundtrip_logits(tcfg, model, prompt, [7, 10], True)
    for a, b in zip(base, parked):
        np.testing.assert_array_equal(a, b)
    hd = cfg.ssm.rwkv_head_dim
    state = cfg.n_layers * (cfg.d_model // hd * hd * hd * 4
                            + 2 * cfg.d_model * 4)
    legs = 2 * (2 + 3)                                # park + restore
    assert meter.messages_fabric == legs
    assert meter.bytes_fabric == legs * state
    assert J_REMOTE == T_REMOTE
