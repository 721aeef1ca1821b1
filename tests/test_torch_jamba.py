"""jamba-v0.1-52b (the hybrid: Mamba and attention, the MoE every second
sub-layer) on the port's paged runtime against the JAX reference, on the
CPU.

Weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the smoke config (8 layers, one full period: sub-layer 4 attention, the
others Mamba; float32) through ``from_jax``. Held against the reference
at rtol 1e-4 / atol 1e-5 (``STATE_TOL`` atol 1e-4 for pools after a whole
prompt): the configuration (``param_count`` at 16 and 32 layers, the
``ModelCost``), the plane layout (order included), the init, the fused
step ``serve_step_paged`` (both ``impl``s) and the per-request path
``prefill_chunk_paged`` -> ``decode_step_paged`` (logits, greedy tokens
exactly, every non-scratch page of the ``ssm``, ``conv`` and ``kv``
pools). The reference runs its plain path (``impl="xla"``).

Held as the port against itself: park/restore round trips bit-identical
to the unparked run, one fabric message per leg across the three planes,
prefix sharing off, the all-or-nothing grow at each plane boundary, state
pages zeroed on slot reuse, a snapshot -> restore round trip, the CLI.
(The reference's own fused == per-request bit-identity does not hold for
this family, so it is no oracle here.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.core.perfmodel import ModelCost as JModelCost
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro.serving.scheduler import bucket_tokens
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import REMOTE as T_REMOTE
from repro_torch.core.faults import InvariantAuditor
from repro_torch.core.perfmodel import ModelCost as TModelCost
from repro_torch.launch import serve as tserve
from repro_torch.layers import attention as tattn
from repro_torch.layers.mamba import Mamba
from repro_torch.layers.moe import MoE
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
PLANES = ("ssm", "conv", "kv")


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


# ---------------------------------------------------------------------------
# configuration, layout, weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers,want", [(16, 26_053_361_664),
                                           (32, 51_569_852_416)])
def test_param_count_matches_reference(n_layers, want):
    cfg = get_config(ARCH).replace(n_layers=n_layers)
    tcfg = t_get_config(ARCH).replace(n_layers=n_layers)
    assert tcfg.param_count() == cfg.param_count() == want
    assert t_get_config(ARCH).n_layers == 32


def test_smoke_config_matches_reference(models):
    cfg, _, tcfg, _ = models
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "param_dtype"):
        assert getattr(tcfg, field) == getattr(cfg, field), field
    assert (tcfg.hybrid.period, tcfg.hybrid.attn_index) == (8, 4)
    assert (tcfg.ssm.mamba_d_state, tcfg.ssm.mamba_dt_rank) == (8, 8)
    assert tcfg.param_count() == cfg.param_count()
    assert [tcfg.is_attention_layer(i) for i in range(16)] == \
        [cfg.is_attention_layer(i) for i in range(16)]


def test_sublayer_kinds_match_reference(models):
    cfg, _, tcfg, model = models
    assert tlm.group_size(tcfg) == jlm.group_size(cfg) == 8
    assert tlm.n_groups(tcfg) == jlm.n_groups(cfg) == 1
    for i in range(8):
        assert tlm.mixer_kind(tcfg, i) == jlm.mixer_kind(cfg, i)
        assert tlm.ffn_kind(tcfg, i) == jlm.ffn_kind(cfg, i)
    assert [k for _, _, k in tlm.sublayers(tcfg)] == \
        ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [j for _, j, _ in tlm.sublayers(tcfg)] == [0, 1, 2, 3, 0, 4, 5, 6]
    for i, blk in enumerate(model.blocks):
        assert isinstance(blk.mix, Mamba) == (i != 4)
        assert isinstance(blk.ffn, MoE) == (i % 2 == 1)


def test_paged_layout_matches_reference(models):
    cfg, _, tcfg, _ = models
    want, got = jlm.paged_layout(cfg), tlm.paged_layout(tcfg)
    assert list(got) == list(want) == list(PLANES)
    for name in PLANES:
        w, g = want[name], got[name]
        assert set(g) == set(w), name
        for key in ("kind", "positions", "shareable"):
            assert g[key] == w[key], (name, key)
        assert str(g["dtype"]).split(".")[-1] == str(w["dtype"])
        if w["kind"] == "state":
            assert tuple(g["shape"]) == tuple(w["shape"])
        else:
            assert tuple(g["dims"]) == tuple(w["dims"])
            assert g["token_bytes"] == w["token_bytes"]


def test_model_cost_matches_reference():
    """KV bytes over the attention layers only, and the active parameters
    (the reference's ``state_bytes`` / ``n_planes`` feed its simulator,
    which the port has not)."""
    for n_layers in (8, 16, 32):
        cfg = get_config(ARCH).replace(n_layers=n_layers)
        tcfg = t_get_config(ARCH).replace(n_layers=n_layers)
        j, t = JModelCost.from_config(cfg), TModelCost.from_config(tcfg)
        assert t.kv_bytes_per_token == j.kv_bytes_per_token \
            == 2 * 8 * 128 * (n_layers // 8) * 2
        assert t.n_params == j.n_params
        assert t.n_layers == j.n_layers == n_layers


def test_from_jax_carries_every_jamba_weight(models):
    """Every parameter of the port equals its leaf of the reference tree:
    layer l is ``blocks.sub{l % 8}`` at group ``l // 8``; the counts
    agree, and A_log and D stay float32."""
    _, params, tcfg, model = models
    tree = jax.tree.map(np.asarray, params)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            g, i = divmod(int(parts[1]), tlm.group_size(tcfg))
            leaf = tree["blocks"][f"sub{i}"]
            for key in parts[2:]:
                leaf = leaf[key]
            want = leaf[g]
        else:
            leaf = tree
            for key in parts:
                leaf = leaf[key]
            want = leaf
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=name)


def test_init_params_keys_shapes_dtypes_and_scales(models):
    """A bf16 model from a torch generator has the reference's keys,
    shapes and dtypes; its random leaves have the reference's scales
    (std within 10%) and its constant ones the reference's values."""
    cfg, _, tcfg, _ = models
    cfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = tcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    raw = japi.init_params(jax.random.PRNGKey(1), cfg)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                        raw)
    dtypes = jax.tree.map(lambda a: str(a.dtype), raw)
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    seen = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            continue
        g, i = divmod(int(parts[1]), 8)
        leaf, dt = tree["blocks"][f"sub{i}"], dtypes["blocks"][f"sub{i}"]
        for key in parts[2:]:
            leaf, dt = leaf[key], dt[key]
        want = leaf[g]
        assert tuple(p.shape) == want.shape, name
        assert str(p.dtype).split(".")[-1] == dt, name
        got = p.detach().float().numpy()
        if want.std() > 0:
            assert abs(got.std() / want.std() - 1) < 0.1, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
        seen += 1
    assert seen == len(jax.tree.leaves(tree["blocks"]))


def test_hybrid_training_is_not_ported(models):
    """The hybrid's training forward (refused before the port trained it):
    Mamba from a zero state, attention, the capacity-dispatch MoE; logits
    and the summed aux loss equal the reference's ``forward``."""
    cfg, params, tcfg, model = models
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, want_aux = jlm.forward(params, cfg, jnp.asarray(toks))
    got, aux = tlm.forward(model, tcfg, toks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))


# ---------------------------------------------------------------------------
# the fused step and the per-request path against the reference
# ---------------------------------------------------------------------------
P_STATE, P_KV, PPS = 24, 24, 6


def _mixed_plan(cfg, seed=0):
    """Two decode lanes (positions 9 and 20), a 12-token chunk from 4, a
    pad row; every table entry of a live row a distinct non-scratch page."""
    rng = np.random.default_rng(seed)
    di = cfg.ssm.mamba_expand * cfg.d_model
    ds, dc = cfg.ssm.mamba_d_state, cfg.ssm.mamba_d_conv
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    R, Tc, page = 4, 16, 8
    pools = {"ssm": rng.standard_normal((P_STATE, di, ds))
             .astype(np.float32) * 0.5,
             "conv": rng.standard_normal((P_STATE, dc - 1, di))
             .astype(np.float32),
             "kv": rng.standard_normal((P_KV, 2, K, page, hd))
             .astype(np.float32)}
    st = np.zeros((1, 7, R), np.int32)
    st[0, :, :3] = rng.choice(np.arange(1, P_STATE), 21,
                              replace=False).reshape(7, 3)
    conv = st.copy()
    conv[0] = np.roll(st[0], 1, axis=0)          # other slots than ssm
    # each live row owns the pages its tokens reach, as the runtime gives
    # them (decode lanes 2 and 3, the chunk row 2); the rest is scratch
    kv = np.zeros((1, 1, R, PPS), np.int32)
    pages = rng.choice(np.arange(1, P_KV), 7, replace=False)
    kv[0, 0, 0, :2], kv[0, 0, 1, :3], kv[0, 0, 2, :2] = (
        pages[:2], pages[2:5], pages[5:])
    return dict(pools=pools, bt={"ssm": st, "conv": conv, "kv": kv},
                tokens=rng.integers(0, cfg.vocab_size, (R, Tc))
                .astype(np.int32),
                q_starts=np.asarray([9, 20, 4, 0], np.int32),
                n_reals=np.asarray([1, 1, 12, 0], np.int32), n_decode=2)


def _written(p, name):
    """The pages of plane ``name`` a live row's table names (pad rows and
    a chunk row's padding past its pages write scratch, in an order
    neither framework defines)."""
    pages = np.unique(p["bt"][name][..., :3, :].reshape(-1)
                      if name == "kv" else p["bt"][name][..., :3])
    return pages[pages != 0]


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_serve_step_paged_matches_reference(models, impl):
    cfg, params, tcfg, model = models
    p = _mixed_plan(cfg, seed=2)
    jlog, jpools = japi.serve_step_paged(
        params, cfg, jnp.asarray(p["tokens"]),
        {k: jnp.asarray(v) for k, v in p["pools"].items()},
        {k: jnp.asarray(v) for k, v in p["bt"].items()},
        jnp.asarray(p["q_starts"]), jnp.asarray(p["n_reals"]),
        n_decode=p["n_decode"], read_pps=PPS, impl="xla")
    tlog, tpools = tapi.serve_step_paged(
        model, tcfg, p["tokens"],
        {k: torch.from_numpy(v.copy()) for k, v in p["pools"].items()},
        p["bt"], p["q_starts"], p["n_reals"], n_decode=p["n_decode"],
        read_pps=PPS, impl=impl)
    assert tuple(tlog.shape) == (4, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy()[:3], np.asarray(jlog)[:3], **TOL)
    for name in PLANES:
        live = _written(p, name)
        np.testing.assert_allclose(tpools[name].numpy()[live],
                                   np.asarray(jpools[name])[live], **TOL)
        untouched = np.setdiff1d(np.arange(1, len(p["pools"][name])), live)
        np.testing.assert_array_equal(tpools[name].numpy()[untouched],
                                      p["pools"][name][untouched])


def test_decode_lanes_take_no_chunk_columns(models):
    """A Mamba decode lane's output is padded with zeros to Tc: its logits
    in a mixed step equal the decode-only step's (the reference's
    ``merge``), so the tail columns carry nothing into the lane."""
    cfg, params, tcfg, model = models
    p = _mixed_plan(cfg, seed=3)
    pools = {k: torch.from_numpy(v.copy()) for k, v in p["pools"].items()}
    mixed, _ = tapi.serve_step_paged(
        model, tcfg, p["tokens"], pools, p["bt"], p["q_starts"],
        p["n_reals"], n_decode=2, read_pps=PPS)
    pools = {k: torch.from_numpy(v.copy()) for k, v in p["pools"].items()}
    bt = {k: v[..., :2, :] if k == "kv" else v[..., :2]
          for k, v in p["bt"].items()}
    alone, _ = tapi.serve_step_paged(
        model, tcfg, p["tokens"][:2, :1], pools, bt, p["q_starts"][:2],
        p["n_reals"][:2], n_decode=2, read_pps=PPS)
    np.testing.assert_allclose(mixed.numpy()[:2], alone.numpy(), **TOL)


def test_chunk_padding_past_the_rows_pages_writes_nothing(models):
    """A chunk row writes its K/V only into the pages its tokens reach:
    the bucket padding past them would land on the table's scratch
    padding, several rows' in no defined order on the card (pad rows read
    that page, and the MoE's per-expert GEMMs carry their values into
    real rows). The scratch K/V page is left as it was, and the same step
    run twice gives the same logits and pools bit for bit."""
    cfg, _, tcfg, model = models
    p = _mixed_plan(cfg, seed=4)
    meta = tattn.step_meta(p["q_starts"], p["n_reals"], 2, 16, "cpu",
                              page=8)
    # decode lanes 1 token; the chunk from 4 with 12 real tokens owns 2
    # pages (positions 0..15): 12 of its 16 columns; the pad row none
    assert meta["n_write"].tolist() == [1, 1, 12, 0]
    runs = []
    for _ in range(2):
        pools = {k: torch.from_numpy(v.copy()) for k, v in p["pools"].items()}
        lg, pools = tapi.serve_step_paged(model, tcfg, p["tokens"], pools,
                                          p["bt"], p["q_starts"],
                                          p["n_reals"], n_decode=2,
                                          read_pps=PPS)
        runs.append((lg, pools))
    np.testing.assert_array_equal(runs[0][1]["kv"][0].numpy(),
                                  p["pools"]["kv"][0])
    assert torch.equal(runs[0][0], runs[1][0])
    for name in PLANES:
        assert torch.equal(runs[0][1][name], runs[1][1][name])


def _runtimes(cfg, tcfg, **kw):
    kw = {**dict(max_seq=64, page_tokens=8, max_running=3), **kw}
    return JRuntime(cfg, **kw), TRuntime(tcfg, device="cpu", **kw)


def test_block_tables_match_reference(models):
    """Each plane spans G groups of n_sub sub-layers: (1, 7) state tables
    for ``ssm``/``conv``, (1, 1, pad) token tables for ``kv``."""
    cfg, _, tcfg, _ = models
    jkv, tkv = _runtimes(cfg, tcfg)
    for kv in (jkv, tkv):
        kv.ensure_capacity(0, 19)
        kv.ensure_capacity(2, 5)
    assert tkv.G == 1
    for name, n_sub in (("ssm", 7), ("conv", 7), ("kv", 1)):
        assert tkv.planes[name].n_sub == jkv.planes[name].n_sub == n_sub
        j = np.asarray(jkv.block_tables_prefill(0, pad_to=7)[name])
        t = tkv.block_tables_prefill(0, pad_to=7)[name]
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)
        j = np.asarray(jkv.block_tables([2, None, 0])[name])
        t = tkv.block_tables([2, None, 0])[name]
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    assert tkv.pages_per_request(40).tolist() == \
        jkv.pages_per_request(40).tolist() == [7, 7, 5]
    assert tkv.footprint_bytes(40) == jkv.footprint_bytes(40)
    assert tkv.cow_reserve().tolist() == jkv.cow_reserve().tolist()


PROMPTS = ((19, (5, 9, 5)), (11, (11,)), (40, (40,)))


def test_per_request_path_matches_reference(models):
    """Three prompts prefilled chunk by chunk through
    ``prefill_chunk_paged`` into each package's runtime, then 6 steps of
    ``decode_step_paged`` over the three lanes: logits within TOL, greedy
    tokens identical, and every non-scratch page of the three pools."""
    cfg, params, tcfg, model = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in PROMPTS]
    jkv, tkv = _runtimes(cfg, tcfg, max_seq=64)
    pad = tkv.pps + 2
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
            for rid, p in enumerate(pos):
                kv.ensure_capacity(rid, int(p) + 1)
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
    for name in PLANES:
        live = np.unique(tkv.block_tables(lanes)[name])
        live = live[live != tkv.planes[name].scratch_slot]
        assert len(live) == (len(PROMPTS) * 7 if name != "kv"
                             else sum(-(-(n + 6) // 8) for n, _ in PROMPTS))
        np.testing.assert_allclose(tkv.pools[name].numpy()[live],
                                   np.asarray(jkv.pools[name])[live],
                                   **STATE_TOL)


# ---------------------------------------------------------------------------
# the runtime, the port against itself
# ---------------------------------------------------------------------------
def _roundtrip_logits(tcfg, model, prompt, chunks, park, decode_steps=3):
    """Chunked prefill then decode on the runtime, parking to a REMOTE
    lease and restoring after every chunk and step when ``park``."""
    kv = TRuntime(tcfg, max_seq=64, page_tokens=8, max_running=2,
                  device="cpu")
    kv.add_remote_lease("d0", 1 << 24)
    pad = kv.pps + 3
    logs, pos = [], 0
    for c in chunks:
        kv.ensure_capacity(0, pos + c)
        toks = np.zeros((1, bucket_tokens(c)), np.int32)
        toks[0, :c] = prompt[pos:pos + c]
        lg, kv.pools = tapi.prefill_chunk_paged(
            model, tcfg, toks, kv.pools, kv.block_tables_prefill(0, pad_to=pad),
            pos, c - 1, read_pps=kv.pps)
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
    return logs, kv


def test_preemption_roundtrip_bit_identical(models):
    """Park mid-prefill AND mid-decode, restore, continue: every logits
    array bit-identical to the unparked run (the ssm, conv and kv pages
    move byte-exact); each leg is ONE fabric message across the three
    planes, moving the 7 state pages of each Mamba plane whole and the
    live K/V rows at their fill."""
    cfg, _, tcfg, model = models
    prompt = list(map(int, np.random.default_rng(1).integers(
        0, cfg.vocab_size, 17)))
    base, _ = _roundtrip_logits(tcfg, model, prompt, [7, 10], False)
    parked, kv = _roundtrip_logits(tcfg, model, prompt, [7, 10], True)
    for a, b in zip(base, parked):
        np.testing.assert_array_equal(a, b)
    contexts = (7, 17, 18, 19, 20)
    state = 7 * (kv.planes["ssm"].aqua.page_bytes
                 + kv.planes["conv"].aqua.page_bytes)
    assert state == 7 * (256 * 8 * 4 + 3 * 256 * 4)
    token_row = kv.planes["kv"].token_bytes
    assert kv.meter.messages_fabric == 2 * len(contexts)
    assert kv.meter.bytes_fabric == sum(2 * (state + c * token_row)
                                        for c in contexts)


def test_park_restore_is_one_message_per_tier_donor(models):
    _, _, tcfg, _ = models
    kv = TRuntime(tcfg, max_seq=64, page_tokens=8, max_running=2,
                  device="cpu")
    kv.add_remote_lease("d0", 1 << 24)
    kv.ensure_capacity(0, 17)
    assert list(kv.planes) == list(PLANES)
    before = kv.meter.messages_fabric
    kv.park(0, 17, prefer=T_REMOTE)
    assert kv.meter.messages_fabric - before == 1
    before = kv.meter.messages_fabric
    kv.restore(0)
    assert kv.meter.messages_fabric - before == 1
    assert kv.meter.bytes_fabric > 0


def test_recurrent_state_family_disables_sharing(models):
    _, _, tcfg, _ = models
    layout = tlm.paged_layout(tcfg)
    assert not all(s.get("shareable", False) for s in layout.values())
    assert layout["kv"]["shareable"]
    kv = TRuntime(tcfg, max_seq=64, page_tokens=8, device="cpu")
    assert not kv.sharing and not kv.caching
    assert kv.adopt_prefix(0, list(range(24))) == 0


@pytest.mark.parametrize("plane_idx", [0, 1, 2])
def test_ensure_capacity_rollback_at_each_plane_boundary(models, plane_idx):
    """Exhaust plane ``plane_idx``'s LOCAL pool (ssm, conv, then kv) so the
    grow fails there: every page an earlier plane took is handed back, and
    the same grow succeeds after the drain."""
    _, _, tcfg, _ = models
    kv = TRuntime(tcfg, max_seq=64, page_tokens=8, max_running=2,
                  host_pages=0, device="cpu")
    planes = list(kv.planes.values())
    victim = planes[plane_idx]
    assert victim.name == PLANES[plane_idx]
    drained = victim.aqua.allocate(victim.aqua.local_free)
    snap = {p.name: p.aqua.tier_counts() for p in planes}
    with pytest.raises(MemoryError):
        kv.ensure_capacity(7, 40)
    assert all(7 not in p.pages for p in planes), "partial rows leaked"
    assert {p.name: p.aqua.tier_counts() for p in planes} == snap
    victim.aqua.free(drained)
    kv.ensure_capacity(7, 40)
    assert InvariantAuditor().check(kv) == []
    kv.release(7)


@pytest.mark.parametrize("plane", ["ssm", "conv"])
def test_state_pages_zeroed_on_slot_reuse(models, plane):
    """A freed Mamba state page's LOCAL slot still holds its last
    occupant's state; a new request allocating that slot sees the zero
    page (the initial state), in each state plane's own dtype."""
    _, _, tcfg, _ = models
    kv = TRuntime(tcfg, max_seq=64, page_tokens=8, max_running=1,
                  device="cpu")
    kv.ensure_capacity(0, 4)
    p = kv.planes[plane]
    slots = [int(p.aqua.page_table[row[0], 1]) for row in p.pages[0]]
    assert len(slots) == 7
    kv.pools[plane][torch.as_tensor(slots)] = 7.0
    kv.release(0)
    kv.ensure_capacity(1, 4)
    new = [int(p.aqua.page_table[row[0], 1]) for row in p.pages[1]]
    assert sorted(new) == sorted(slots)
    assert float(kv.pools[plane][torch.as_tensor(new)].abs().max()) == 0.0


def test_snapshot_restore_round_trip_over_three_planes(models):
    """``snapshot_state`` of a runtime holding a prefilled request (one of
    them parked), restored into a fresh runtime: the second snapshot equals
    the first, payloads included, and decoding on goes on bit for bit."""
    cfg, _, tcfg, model = models
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 13)

    def runtime():
        kv = TRuntime(tcfg, max_seq=64, page_tokens=8, max_running=2,
                      device="cpu")
        kv.add_remote_lease("d0", 1 << 24)
        return kv

    def decode(kv, steps=2):
        out = []
        for t in range(steps):
            kv.restore(0)
            kv.ensure_capacity(0, 14 + t)
            lg, kv.pools = tapi.decode_step_paged(
                model, tcfg, kv.pools, kv.block_tables([0, None]),
                [3 + t, 0], [13 + t, 0])
            out.append(lg[0].numpy())
        return out

    kv = runtime()
    for rid in (0, 1):
        kv.ensure_capacity(rid, 13)
        toks = np.zeros((1, 16), np.int32)
        toks[0, :13] = prompt
        _, kv.pools = tapi.prefill_chunk_paged(
            model, tcfg, toks, kv.pools, kv.block_tables_prefill(rid), 0, 12)
    kv.park(0, 13, prefer=T_REMOTE)
    snap = kv.snapshot_state()
    assert set(snap["planes"]) == set(PLANES)
    fresh = runtime()
    fresh.restore_state(snap)
    again = fresh.snapshot_state()
    for name in PLANES:
        a, b = snap["planes"][name], again["planes"][name]
        assert a["pages"] == b["pages"] and a["dtype"] == b["dtype"]
        np.testing.assert_array_equal(a["data"], b["data"])
    assert InvariantAuditor().check(fresh) == []
    for a, b in zip(decode(kv), decode(fresh)):
        np.testing.assert_array_equal(a, b)


def test_serve_cli_serves_the_smoke_config(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "4", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "(planes: ssm, conv, kv)" in out
    assert "served 4 requests" in out
