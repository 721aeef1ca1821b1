"""whisper-tiny, the encoder-decoder family, in the port against the JAX
reference, on the CPU.

The float32 smoke config (2 encoder layers over 32 frames, 4 decoder
layers, d 128), weights from the reference's ``api.init_params(PRNGKey(1),
cfg)`` carried over with ``from_jax``, the same seeded numpy tokens and
frame embeddings through both packages:

- the training forward's logits (both ``impl``s), ``prefill`` of 20 tokens
  then 4 ``decode_step``s (logits, and every cache leaf after the prefill
  and after the last step) against the reference's jitted ones at rtol
  1e-4 / atol 1e-5, the prefill and decode logits against the port's own
  forward within 2e-4; the bidirectional and cross attention
  (``attention_bidir``) against the reference's ``_bidir_attention`` and
  ``_cross_attend`` at Sq = 1, Sq < Sk and Sq > Sk;
- the loss (1e-5 relative) and every parameter's gradient (1e-4 relative
  norm) against ``jax.grad``, with and without remat;
- ``from_jax`` carrying every leaf bit for bit and refusing a wrong shape;
  the 58,714,368 parameters of the full config; ``make_batch``'s
  ``enc_embeds`` bit-equal to the reference's (float32 and bf16); both
  packages' engines, the port's runtime and serve CLI refusing the
  family; ``init_decode_state`` defaulting to CUDA; the train CLI.

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
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.serving.engine import ServingEngine as JEngine
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import make_batch as j_make_batch
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.layers import attention as tattn
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import PagedStateRuntime
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.train_loop import trainable_params

ARCH = "whisper-tiny"
B, T, S, TP = 2, 24, 32, 20
TOL = dict(rtol=1e-4, atol=1e-5)
FORWARD_ABS = 2e-4
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = smoke_config(get_config(ARCH))
    tcfg = t_smoke_config(t_get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(1), cfg)
    np_params = jax.tree.map(np.asarray, params)
    model = from_jax(np_params, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    enc = (0.02 * rng.standard_normal(
        (B, cfg.encdec.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return cfg, tcfg, params, np_params, model, toks, enc


def _np_cache(cache):
    return {k: [np.asarray(leaf) for leaf in v] for k, v in cache.items()}


def _t_cache(cache):
    return {k: [leaf.numpy().copy() for leaf in v] for k, v in cache.items()}


@functools.lru_cache(maxsize=None)
def _runs():
    """Both packages' prefill and decode on the same weights and inputs,
    and the port's forward over the whole sequence."""
    cfg, tcfg, params, _, model, toks, enc = _setup()
    prefill = jax.jit(functools.partial(jencdec.prefill, cfg=cfg))
    decode = jax.jit(functools.partial(jencdec.decode_step, cfg=cfg))
    jc = japi.init_decode_state(cfg, B, S, jnp.float32)
    lg, jc = prefill(params, tokens=jnp.asarray(toks[:, :TP]), cache=jc,
                     enc_embeds=jnp.asarray(enc))
    ref = dict(logits=[np.asarray(lg)], prefill_cache=_np_cache(jc))
    tc = tapi.init_decode_state(tcfg, B, S, torch.float32, device="cpu")
    tl, tc = tapi.prefill(model, tcfg, toks[:, :TP], tc,
                          enc_embeds=torch.from_numpy(enc))
    port = dict(logits=[tl.numpy()], prefill_cache=_t_cache(tc))
    for i in range(TP, T):
        pos = np.full((B,), i, np.int32)
        lg, jc = decode(params, cache=jc, tokens=jnp.asarray(toks[:, i]),
                        pos=jnp.asarray(pos))
        ref["logits"].append(np.asarray(lg))
        tl, tc = tapi.decode_step(model, tcfg, tc, toks[:, i], pos)
        port["logits"].append(tl.numpy())
    ref["cache"], port["cache"] = _np_cache(jc), _t_cache(tc)
    with torch.no_grad():
        full, _ = tapi.forward(model, tcfg, toks,
                               enc_embeds=torch.from_numpy(enc))
    port["forward"] = full[:, TP - 1:].numpy()
    return ref, port


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_forward_logits_match_reference(impl):
    cfg, tcfg, params, _, model, toks, enc = _setup()
    want, _ = jencdec.forward(params, cfg, jnp.asarray(toks),
                              jnp.asarray(enc))
    with torch.no_grad():
        got, aux = tapi.forward(model, tcfg, toks,
                                enc_embeds=torch.from_numpy(enc), impl=impl)
    assert got.shape == (B, T, cfg.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match_reference():
    ref, port = _runs()
    assert len(port["logits"]) == 1 + T - TP
    for got, want in zip(port["logits"], ref["logits"]):
        np.testing.assert_allclose(got, want, **TOL)


def test_prefill_and_decode_equal_own_forward():
    """The twin of ``test_arch_smoke.py:52`` on the port alone."""
    _, port = _runs()
    got = np.stack(port["logits"], axis=1)
    assert np.abs(got - port["forward"]).max() < FORWARD_ABS


def test_cache_leaves_match_reference():
    """Each decoder layer's self K/V (S slots) and cross K/V (the
    encoder's 32 frames) after the prefill and after the last step."""
    ref, port = _runs()
    cfg = _setup()[0]
    hd = cfg.resolved_head_dim
    for when in ("prefill_cache", "cache"):
        assert sorted(port[when]) == sorted(ref[when]) == ["cross", "self"]
        for sub, leaves in port[when].items():
            slots = S if sub == "self" else cfg.encdec.encoder_seq_len
            for got, want in zip(leaves, ref[when][sub]):
                assert got.shape == want.shape == (
                    cfg.n_layers, B, slots, cfg.n_kv_heads, hd)
                assert got.dtype == want.dtype
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"{when} {sub}")


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("Sq", [1, 5, 40])
def test_attention_bidir_matches_reference(Sq, impl):
    """The encoder's self-attention over Sq frames and the cross-attention
    of Sq decoder rows against 32 encoder frames (Sq 1 as at decode, 5
    below, 40 above the key count)."""
    cfg, tcfg, _, np_params, model, _, _ = _setup()
    rng = np.random.default_rng(Sq)
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params)
    want = jencdec._bidir_attention(jp["enc_blocks"]["attn"], cfg,
                                    jnp.asarray(x))
    got = tattn.attention_bidir(model.enc_blocks[0].attn, tcfg,
                                torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cross = jp["dec_blocks"]["cross"]
    ck, cv = jencdec._cross_kv(cross, cfg, jnp.asarray(enc))
    want = jencdec._cross_attend(cross, cfg, jnp.asarray(x), ck, cv)
    blk = model.dec_blocks[0]
    kv = tencdec.cross_kv(blk.cross, tcfg, torch.from_numpy(enc))
    for got_k, want_k in zip(kv, (ck, cv)):
        np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), **TOL)
    got = tattn.attention_bidir(blk.cross, tcfg, torch.from_numpy(x), kv=kv,
                                impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_leaf(tree, name):
    """The reference leaf of a port parameter name: ``enc_blocks.<e>.<path>``
    and ``dec_blocks.<l>.<path>`` are entry e / l of the stacked leaf."""
    parts = name.split(".")
    if parts[0] in ("enc_blocks", "dec_blocks"):
        node = tree[parts[0]]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat):
    """2 x 24 decoder tokens over 32 frames: the loss (1e-5 relative) and
    every parameter's gradient (1e-4 relative norm) against ``jax.grad``
    of the reference's ``loss_fn``; the encoder's included."""
    cfg, tcfg, params, _, _, toks, enc = _setup()
    batch = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}
    loss, grads = jax.value_and_grad(lambda p: japi.loss_fn(
        p, cfg, batch, remat=remat))(params)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    named = trainable_params(model)
    tloss = tapi.loss_fn(model, tcfg, {
        "tokens": torch.from_numpy(toks),
        "enc_embeds": torch.from_numpy(enc)}, remat=remat)
    tgrads = torch.autograd.grad(tloss, list(named.values()))
    want_loss = float(loss)
    assert abs(float(tloss.detach()) - want_loss) <= LOSS_REL * abs(want_loss)
    assert any(n.startswith("enc_blocks.1.attn") for n in named)
    for name, g in zip(named, tgrads):
        rel = _rel(g.numpy(), _jax_leaf(grads, name))
        assert rel <= GRAD_REL, (name, rel)


def test_from_jax_carries_every_leaf_and_refuses_a_wrong_shape():
    cfg, tcfg, _, np_params, model, _, _ = _setup()
    named = dict(model.named_parameters())
    n_leaves = len(jax.tree.leaves(np_params))
    # the stacked leaves unstack into E (encoder) or L (decoder) modules
    E, L = cfg.encdec.n_encoder_layers, cfg.n_layers
    n_enc = len(jax.tree.leaves(np_params["enc_blocks"]))
    n_dec = len(jax.tree.leaves(np_params["dec_blocks"]))
    assert len(named) == n_leaves - n_enc - n_dec + E * n_enc + L * n_dec
    for name, p in named.items():
        np.testing.assert_array_equal(p.numpy(), _jax_leaf(np_params, name),
                                      err_msg=name)
    bad = jax.tree.map(lambda a: a, np_params)
    bad["dec_blocks"]["cross"]["wk"]["w"] = np.zeros(
        (L, cfg.d_model, 8), np.float32)
    with pytest.raises(ValueError, match="dec_blocks.0.cross.wk.w"):
        from_jax(bad, tcfg, device="cpu")


def test_config_and_param_count():
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(cfg, f.name)
        if f.name == "encdec":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert tcfg.param_count() == cfg.param_count() == 58_714_368
    smoke, tsmoke = smoke_config(cfg), t_smoke_config(tcfg)
    assert dataclasses.asdict(tsmoke.encdec) == \
        dataclasses.asdict(smoke.encdec) == dict(
            n_encoder_layers=2, encoder_seq_len=32, max_decoder_len=64)
    assert tsmoke.param_count() == smoke.param_count()
    model = tapi.init_params(tsmoke, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(model, tencdec.EncDec)
    n = sum(p.numel() for p in model.parameters())
    d, f, E = tsmoke.d_model, tsmoke.d_ff, tsmoke.encdec.n_encoder_layers
    # the formula counts three d x d_ff matrices an encoder MLP (gelu has
    # two) and leaves out the encoder's and the decoder's final norms
    assert n == tsmoke.param_count() - E * d * f + 2 * d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_enc_embeds_bit_equal(dtype):
    """Tokens, then the frame embeddings from the same generator, as the
    reference draws them; the full config's 1,500 frames in bf16."""
    cfg = get_config(ARCH).replace(compute_dtype=dtype)
    tcfg = t_get_config(ARCH).replace(compute_dtype=dtype)
    if dtype == "float32":
        cfg, tcfg = smoke_config(cfg), t_smoke_config(tcfg)
    want = j_make_batch(JDataConfig(seed=5, batch=2, seq_len=16), cfg, 3)
    got = make_batch(DataConfig(seed=5, batch=2, seq_len=16), tcfg, 3)
    assert sorted(got) == sorted(want) == ["enc_embeds", "tokens"]
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    e = got["enc_embeds"]
    assert e.shape == (2, cfg.encdec.encoder_seq_len, cfg.d_model)
    assert e.dtype == getattr(torch, dtype)
    w = np.asarray(want["enc_embeds"])
    if dtype == "bfloat16":
        np.testing.assert_array_equal(e.view(torch.int16).numpy(),
                                      w.view(np.int16))
    else:
        np.testing.assert_array_equal(e.numpy(), w)


def test_engines_and_runtime_refuse_whisper():
    """No page plane for the cross K/V: the reference's engine, the
    port's engine, its runtime and its serve CLI raise ``ValueError``;
    ``supports_paged`` is false in both packages."""
    cfg, tcfg, params, _, model, _, _ = _setup()
    assert not japi.supports_paged(cfg) and not tapi.supports_paged(tcfg)
    with pytest.raises(ValueError, match="not paged-servable"):
        JEngine(cfg, params, hw=J_A100, max_running=2, max_seq=64)
    with pytest.raises(ValueError, match="not paged-servable"):
        TEngine(tcfg, model, hw=T_A100, max_running=2, max_seq=64,
                device="cpu")
    with pytest.raises(ValueError, match="not paged-servable"):
        PagedStateRuntime(tcfg, local_pages=8, host_pages=8,
                          max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="not paged-servable"):
        tlm.paged_layout(tcfg)
    with pytest.raises(ValueError, match="not paged-servable"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_init_decode_state_defaults_to_cuda(monkeypatch):
    """No fallback: with no GPU the default device raises; the CPU only
    when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = t_smoke_config(t_get_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tapi.init_decode_state(tcfg, 1, 32)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tapi.init_params(tcfg, torch.Generator().manual_seed(0))
    st = tapi.init_decode_state(tcfg, 1, 32, device="cpu")
    assert st["self"].k.device.type == "cpu"
    assert st["cross"].k.shape == (tcfg.n_layers, 1, 32, tcfg.n_kv_heads,
                                   tcfg.resolved_head_dim)


def test_train_cli_trains_whisper():
    """``--arch whisper-tiny`` trains: its batches carry seeded frame
    embeddings, the loss is finite and falls over 4 steps."""
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--lr", "1e-2"])
    losses = out["losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
