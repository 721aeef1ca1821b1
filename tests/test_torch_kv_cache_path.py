"""The port's dense KV-cache path (``init_decode_state``, ``prefill``,
``decode_step``) against the JAX reference, on the CPU.

Every arch of ``test_arch_smoke.py``'s ``ASSIGNED`` but whisper-tiny, plus
aqua-mistral-7b, at its float32 ``smoke_config``, weights from the
reference's ``api.init_params(PRNGKey(1), cfg)`` carried over with
``from_jax``, at the reference test's shapes: B 2, T 24 tokens (a VLM's 8
prefix rows before them), a cache of S 32 slots (16 on a windowed layer),
a prefill of 20 tokens, then 4 decode steps. Each side's run is computed
once per arch (``_runs``).

- Prefill and decode logits against the reference's at rtol 1e-4 / atol
  1e-5 (rwkv6-3b at atol 1e-4, the state tolerance of
  ``test_torch_rwkv.py``: its float32 state sums in another order), and
  against the port's own ``forward`` at the same positions within the
  reference test's 2e-4; every cache leaf against the reference's after
  the prefill and after the last step, at the same tolerances.
- The ring: gemma3's local layers hold ``window`` slots and its global
  layer ``seq`` (the twin of ``test_arch_smoke.py:86``), every sub-layer's
  slots at the full gemma3-12b and aqua-mistral-7b configs (shapes only, on
  the ``meta`` device) against the reference's ``decode_state_specs``;
  ``fill_kv_cache`` below, at and past the slot count (a roll that is not
  a multiple of the slots) bit-exact against the reference; a ring
  decoded until it has wrapped twice against the reference's
  ``attention_decode`` and the port's own full windowed attention.
- Also: ``qk_head_norm``, ``mla_full(return_cache=True)`` and the absorbed
  ``mla_decode``; gemma3-12b's and aqua-mistral-7b's windowed training
  loss and every gradient against ``jax.grad`` (the twin of
  ``test_arch_smoke.py:37``, limits of ``test_torch_training.py``);
  gemma3-12b's config field for field and its 11,765,391,360 parameters;
  ``from_jax`` carrying non-zero qk-norm scales; ``init_decode_state``
  defaulting to CUDA and raising without it.

The tests run with one intra-op thread: many small ops, whose threads
would otherwise spin against the other test workers'.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.layers import attention as jattn
from repro.layers import core as jcore
from repro.layers import mla as jmla
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.layers import attention as tattn
from repro_torch.layers import core as tcore
from repro_torch.layers import mla as tmla
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.training.train_loop import trainable_params

ARCHS = ("internvl2-1b", "rwkv6-3b", "gemma-7b", "qwen1.5-0.5b",
         "minicpm-2b", "gemma3-12b", "deepseek-v2-lite-16b", "dbrx-132b",
         "jamba-v0.1-52b", "aqua-mistral-7b")
B, T, S, TP = 2, 24, 32, 20
TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
FORWARD_ABS = 2e-4          # test_arch_smoke.py's prefill/decode limit
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(arch):
    return STATE_TOL if arch == "rwkv6-3b" else TOL


def _np_cache(cache):
    return {k: [np.asarray(leaf) for leaf in v] for k, v in cache.items()}


def _t_cache(cache):
    return {k: [leaf.numpy().copy() for leaf in v] for k, v in cache.items()}


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """Both packages' prefill and decode on the same weights and inputs,
    and the port's forward over the whole sequence."""
    cfg = smoke_config(get_config(arch))
    tcfg = t_smoke_config(t_get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(1), cfg)
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    P = cfg.n_prefix_embeds
    jex, tex = {}, {}
    if P:
        pre = (0.02 * rng.standard_normal((B, P, cfg.d_model))).astype(
            np.float32)
        jex["prefix_embeds"], tex["prefix_embeds"] = (jnp.asarray(pre),
                                                      torch.from_numpy(pre))
    mod = japi.model_module(cfg)
    prefill = jax.jit(functools.partial(mod.prefill, cfg=cfg))
    decode = jax.jit(functools.partial(mod.decode_step, cfg=cfg))
    jc = japi.init_decode_state(cfg, B, S, jnp.float32)
    lg, jc = prefill(params, tokens=jnp.asarray(toks[:, :TP]), cache=jc,
                     **jex)
    ref = dict(logits=[np.asarray(lg)], prefill_cache=_np_cache(jc))
    model = from_jax(np_params, tcfg, device="cpu")
    tc = tapi.init_decode_state(tcfg, B, S, torch.float32, device="cpu")
    tl, tc = tapi.prefill(model, tcfg, toks[:, :TP], tc, **tex)
    port = dict(logits=[tl.numpy()], prefill_cache=_t_cache(tc))
    for i in range(TP, T):
        pos = np.full((B,), P + i, np.int32)
        lg, jc = decode(params, cache=jc, tokens=jnp.asarray(toks[:, i]),
                        pos=jnp.asarray(pos))
        ref["logits"].append(np.asarray(lg))
        tl, tc = tapi.decode_step(model, tcfg, tc, toks[:, i], pos)
        port["logits"].append(tl.numpy())
    ref["cache"], port["cache"] = _np_cache(jc), _t_cache(tc)
    with torch.no_grad():
        full, _ = tapi.forward(model, tcfg, toks, **tex)
    port["forward"] = full[:, P + TP - 1:].numpy()
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    ref, port = _runs(arch)
    assert len(port["logits"]) == 1 + T - TP
    for got, want in zip(port["logits"], ref["logits"]):
        np.testing.assert_allclose(got, want, **_tol(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_own_forward(arch):
    """The twin of ``test_arch_smoke.py:52`` on the port alone: the
    prefill's last logits and each decode step's equal the training
    forward's at the same positions."""
    _, port = _runs(arch)
    got = np.stack(port["logits"], axis=1)
    assert np.abs(got - port["forward"]).max() < FORWARD_ABS


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaves_match_reference(arch):
    ref, port = _runs(arch)
    for when in ("prefill_cache", "cache"):
        assert sorted(port[when]) == sorted(ref[when])
        for sub, leaves in port[when].items():
            assert len(leaves) == len(ref[when][sub])
            for got, want in zip(leaves, ref[when][sub]):
                assert got.shape == want.shape and got.dtype == want.dtype
                np.testing.assert_allclose(got, want, **_tol(arch),
                                           err_msg=f"{when} {sub}")


def test_ring_cache_smaller():
    """The twin of ``test_arch_smoke.py:86``: gemma3's local layers hold
    only ``window`` slots, its global layer all 1,024."""
    cfg = t_smoke_config(t_get_config("gemma3-12b"))
    st = tapi.init_decode_state(cfg, 2, 1024, torch.float32, device="cpu")
    slot_sizes = {k: v.k.shape[2] for k, v in st.items()}
    assert slot_sizes["sub5"] == 1024
    assert all(v == cfg.sliding_window for k, v in slot_sizes.items()
               if k != "sub5")


@pytest.mark.parametrize("arch,batch,seq,nbytes", [
    ("gemma3-12b", 2, 4096, 1_207_959_552),
    ("aqua-mistral-7b", 1, 8192, 536_870_912)])
def test_full_config_slots_match_reference(arch, batch, seq, nbytes):
    """Every sub-layer's cache shape at the full config against the
    reference's ``decode_state_specs``, and the cache's bytes in bf16 (the
    shapes alone: the port's on the ``meta`` device)."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    want = japi.decode_state_specs(cfg, batch, seq)
    got = tapi.init_decode_state(tcfg, batch, seq, device="meta")
    assert sorted(got) == sorted(want)
    total = 0
    for sub, c in got.items():
        i = int(sub[3:])
        slots = min(cfg.sliding_window, seq) if tlm.layer_window(tcfg, i) \
            else seq
        for leaf, spec in zip(c, want[sub]):
            assert tuple(leaf.shape) == tuple(spec.shape)
            assert leaf.shape[2] == slots
            assert leaf.dtype == torch.bfloat16
            total += leaf.numel() * leaf.element_size()
    assert total == nbytes


@pytest.mark.parametrize("T_fill", [5, 8, 19])
def test_fill_kv_cache_matches_reference(T_fill):
    """Below, at and past a ring of 8 slots ((19 - 8) % 8 = 3): bit-exact,
    and past it slot j holds the position p with p % 8 == j."""
    rng = np.random.default_rng(T_fill)
    k, v = (rng.standard_normal((2, T_fill, 2, 4)).astype(np.float32)
            for _ in range(2))
    window, slots = 16, 8
    zeros = np.zeros((2, slots, 2, 4), np.float32)
    want = jattn.fill_kv_cache(jattn.KVCache(jnp.asarray(zeros),
                                             jnp.asarray(zeros)),
                               jnp.asarray(k), jnp.asarray(v), window)
    got = tattn.fill_kv_cache(tattn.KVCache(torch.zeros(zeros.shape),
                                            torch.zeros(zeros.shape)),
                              torch.from_numpy(k), torch.from_numpy(v),
                              window)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    for j in range(slots):
        held = [p for p in range(T_fill) if p % slots == j]
        if held:
            np.testing.assert_array_equal(got.k.numpy()[:, j],
                                          k[:, max(held)])


def test_attention_decode_ring_wrapped_twice():
    """One windowed attention layer (gemma3's smoke sub0: window 16 in a
    ring of 16 slots, qk-norm): a 5-token prefill, then decode to position
    41, so the ring wraps twice. Each step against the reference's
    ``attention_decode`` (outputs and ring), and the last against the
    port's full windowed attention over all 42 positions."""
    cfg = smoke_config(get_config("gemma3-12b"))
    tcfg = t_smoke_config(t_get_config("gemma3-12b"))
    params = japi.init_params(jax.random.PRNGKey(3), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])
    tp = model.blocks[0].mix
    w = tlm.layer_window(tcfg, 0)
    assert w == cfg.sliding_window == 16
    n = 42
    x = np.random.default_rng(4).standard_normal(
        (2, n, cfg.d_model)).astype(np.float32)
    jc = jattn.make_kv_cache(cfg, 2, 64, w, jnp.float32)
    tc = tattn.make_kv_cache(tcfg, 2, 64, w, torch.float32, "cpu")
    assert tc.k.shape[1] == 16
    j_decode = jax.jit(functools.partial(jattn.attention_decode, cfg=cfg,
                                         window=w))
    with torch.no_grad():
        _, (k, v) = jattn.attention_full(jp, cfg, jnp.asarray(x[:, :5]),
                                         window=w, return_kv=True)
        jc = jattn.fill_kv_cache(jc, k, v, w)
        _, (k, v) = tattn.attention_full(tp, tcfg, torch.from_numpy(x[:, :5]),
                                         window=w, return_kv=True)
        tattn.fill_kv_cache(tc, k, v, w)
        for p in range(5, n):
            pos = np.full((2,), p, np.int32)
            want, jc = j_decode(jp, x=jnp.asarray(x[:, p:p + 1]), cache=jc,
                                pos=jnp.asarray(pos))
            got, tc = tattn.attention_decode(tp, tcfg,
                                             torch.from_numpy(x[:, p:p + 1]),
                                             tc, torch.from_numpy(pos).long(),
                                             window=w)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        full = tattn.attention_full(tp, tcfg, torch.from_numpy(x), window=w)
    np.testing.assert_allclose(got.numpy()[:, 0], full.numpy()[:, -1],
                               rtol=1e-4, atol=2e-5)


def test_qk_head_norm_matches_reference():
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((2, 7, 4, 32))).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    want = jcore.qk_head_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6)
    got = tcore.qk_head_norm(torch.from_numpy(scale), torch.from_numpy(x),
                             1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    assert tcore.qk_head_norm(torch.from_numpy(scale), xb).dtype == \
        torch.bfloat16


def test_mla_full_cache_and_mla_decode_match_reference():
    """deepseek's smoke MLA layer: ``mla_full(return_cache=True)`` over 20
    tokens, ``fill_mla_cache``, then three absorbed ``mla_decode`` steps,
    outputs and caches against the reference."""
    cfg = smoke_config(get_config("deepseek-v2-lite-16b"))
    tcfg = t_smoke_config(t_get_config("deepseek-v2-lite-16b"))
    params = japi.init_params(jax.random.PRNGKey(6), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])
    tp = model.blocks[0].mix
    x = np.random.default_rng(7).standard_normal(
        (2, 23, cfg.d_model)).astype(np.float32)
    j_decode = jax.jit(functools.partial(jmla.mla_decode, cfg=cfg))
    with torch.no_grad():
        jo, (c, r) = jmla.mla_full(jp, cfg, jnp.asarray(x[:, :20]),
                                   return_cache=True)
        to, (tcv, trv) = tmla.mla_full(tp, tcfg, torch.from_numpy(x[:, :20]),
                                       return_cache=True)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(c), **TOL)
        np.testing.assert_allclose(trv.numpy(), np.asarray(r), **TOL)
        jc = jmla.fill_mla_cache(jmla.make_mla_cache(cfg, 2, 32, jnp.float32),
                                 c, r)
        tc = tmla.fill_mla_cache(tmla.make_mla_cache(tcfg, 2, 32,
                                                     torch.float32, "cpu"),
                                 tcv, trv)
        for p in range(20, 23):
            pos = np.asarray([p, p - 3], np.int32)
            want, jc = j_decode(jp, x=jnp.asarray(x[:, p:p + 1]), cache=jc,
                                pos=jnp.asarray(pos))
            got, tc = tmla.mla_decode(tp, tcfg, torch.from_numpy(
                x[:, p:p + 1]), tc, torch.from_numpy(pos).long())
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(tc, jc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_leaf(tree, name, gs):
    """The reference leaf of a port parameter name: ``blocks.<l>.<path>``
    is group l // gs of ``blocks.sub{l % gs}.<path>``."""
    parts = name.split(".")
    node = tree
    if parts[0] == "blocks":
        layer = int(parts[1])
        node = tree["blocks"][f"sub{layer % gs}"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[layer // gs]
    for p in parts:
        node = node[p]
    return np.asarray(node)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("arch", ["gemma3-12b", "aqua-mistral-7b"])
def test_windowed_loss_and_grads_match_reference(arch):
    """The twin of ``test_arch_smoke.py:37`` held against the reference:
    2 x 32 tokens past the smoke window of 16, the loss (1e-5 relative)
    and every parameter's gradient (1e-4 relative norm), qk-norm scales
    included, through the flash op's window (its plain version here)."""
    cfg = smoke_config(get_config(arch))
    tcfg = t_smoke_config(t_get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    loss, grads = jax.value_and_grad(lambda p: japi.loss_fn(
        p, cfg, {"tokens": jnp.asarray(toks)}))(params)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    named = trainable_params(model)
    tloss = tapi.loss_fn(model, tcfg, {"tokens": torch.from_numpy(toks)})
    tgrads = torch.autograd.grad(tloss, list(named.values()))
    want_loss = float(loss)
    assert abs(float(tloss.detach()) - want_loss) <= LOSS_REL * abs(want_loss)
    gs = tlm.group_size(tcfg)
    assert any(name.endswith("q_norm") for name in named) == \
        tcfg.use_qk_norm
    for name, g in zip(named, tgrads):
        want = _jax_leaf(grads, name, gs)
        assert _rel(g.numpy(), want) <= GRAD_REL, (name, _rel(g.numpy(),
                                                              want))


def test_gemma3_config_and_param_count():
    cfg, tcfg = get_config("gemma3-12b"), t_get_config("gemma3-12b")
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(cfg, f.name), f.name
    assert tcfg.param_count() == cfg.param_count() == 11_765_391_360
    assert [tcfg.is_global_attn_layer(i) for i in range(12)] == \
        [cfg.is_global_attn_layer(i) for i in range(12)] == \
        [False] * 5 + [True] + [False] * 5 + [True]
    assert tlm.group_size(tcfg) == 6 and tlm.n_groups(tcfg) == 8
    assert [tlm.mixer_kind(tcfg, i) for i in range(6)] == \
        ["attn_local"] * 5 + ["attn"]
    smoke, tsmoke = smoke_config(cfg), t_smoke_config(tcfg)
    assert (tsmoke.n_layers, tsmoke.sliding_window) == \
        (smoke.n_layers, smoke.sliding_window) == (6, 16)
    model = tlm.init_params(tsmoke, torch.Generator().manual_seed(0), "cpu")
    n = sum(p.numel() for p in model.parameters())
    hd = tsmoke.resolved_head_dim
    # the formula leaves out the final norm and the qk-norm scales
    assert n == tsmoke.param_count() + tsmoke.d_model + 6 * 2 * hd


def test_from_jax_reads_qk_norm():
    """Non-zero qk-norm scales reach the port: the model's ``q_norm`` /
    ``k_norm`` equal the reference tree's, and the forward logits equal
    the reference's."""
    cfg = smoke_config(get_config("gemma3-12b"))
    tcfg = t_smoke_config(t_get_config("gemma3-12b"))
    params = japi.init_params(jax.random.PRNGKey(9), cfg)
    rng = np.random.default_rng(9)
    for i in range(6):
        mix = params["blocks"][f"sub{i}"]["mix"]
        for name in ("q_norm", "k_norm"):
            mix[name] = jnp.asarray(
                0.3 * rng.standard_normal(mix[name].shape), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    model = from_jax(np_params, tcfg, device="cpu")
    for layer, blk in enumerate(model.blocks):
        for name in ("q_norm", "k_norm"):
            np.testing.assert_array_equal(
                getattr(blk.mix, name).numpy(),
                np_params["blocks"][f"sub{layer % 6}"]["mix"][name][
                    layer // 6])
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = japi.model_module(cfg).forward(params, cfg, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = tapi.forward(model, tcfg, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_decode_state_defaults_to_cuda(monkeypatch):
    """No fallback: with no GPU the default device raises; the CPU only
    when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_smoke_config(t_get_config("gemma3-12b"))
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tapi.init_decode_state(cfg, 1, 32)
    st = tapi.init_decode_state(cfg, 1, 32, device="cpu")
    assert st["sub0"].k.device.type == "cpu"
