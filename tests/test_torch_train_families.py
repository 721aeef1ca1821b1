"""The port's training of the RWKV-6, MLA/MoE, hybrid and VLM families
against the JAX reference, on the CPU.

The float32 ``smoke_config``s of rwkv6-3b, deepseek-v2-lite-16b,
dbrx-132b, jamba-v0.1-52b and internvl2-1b, weights from the reference's
``api.init_params(PRNGKey(0), cfg)`` carried over with ``from_jax``,
batches from each side's ``make_batch`` at batch 2 x 64 tokens (internvl2:
8 prefix rows + 56 tokens). Each reference gradient is built once per
arch (``_reference``).

- The loss (1e-5 relative) and every parameter's gradient (1e-4 relative
  norm, the dense test's limit in ``test_torch_training.py``) against
  ``jax.grad`` of the reference's ``loss_fn``, through the kernels' ops
  (``impl="kernel"``: the WKV and flash autograd ops, their plain versions
  here) and through the plain forms under autograd (``impl="ref"``).
  rwkv6-3b's limit per parameter is the larger of 1e-4 and twice the
  distance between the reference's own two float32 forms of the same
  gradient (its chunked WKV, which T 64 takes, and its scan): the smoke
  model's r and k gradients cancel through the head norm, so float32
  resolves its first layers' gradients (and the embedding's) only to
  ~4e-4, whichever implementation computes them.
- ``moe_apply(dropless=False)`` at a capacity factor of 0.5, where
  assignments are dropped: the same experts, the same kept set, outputs
  within 1e-6.
- ``make_batch`` with prefix embeddings bit-identical to the reference's,
  in float32 and bfloat16, and its float64 -> compute-dtype rounding on a
  value whose direct rounding would differ.
- ``remat`` (a checkpoint per layer group) equals no remat: loss and
  gradients at 1e-6.
(Three ``train`` steps and the CLI: ``test_torch_train_runs.py``.) The
tests run with one intra-op thread: many small ops, whose threads would
otherwise spin against the other test workers'.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.layers import moe as jmoe
from repro.layers import rwkv6 as jrwkv
from repro.models import api as japi
from repro.models import lm as jlm
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import make_batch as j_make_batch
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.layers import moe as tmoe
from repro_torch.models import api as tapi
from repro_torch.params import from_jax
from repro_torch.training.data import DataConfig, _as_compute, make_batch
from repro_torch.training.train_loop import trainable_params

ARCHS = ("rwkv6-3b", "deepseek-v2-lite-16b", "dbrx-132b", "jamba-v0.1-52b",
         "internvl2-1b")
MOE_ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b", "jamba-v0.1-52b")
DCFG = dict(seed=0, batch=2, seq_len=64)
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's params, loss and gradients on batch 0, once; for
    RWKV-6 also its gradients through the scan in place of the chunked
    form (``alt_grads``), the measure of its own float32 floor."""
    cfg = smoke_config(get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    batch = j_make_batch(JDataConfig(**DCFG), cfg, 0)

    def grads_of():
        return jax.value_and_grad(lambda p: japi.loss_fn(p, cfg, batch))(
            params)
    loss, grads = grads_of()
    out = dict(cfg=cfg, tcfg=t_smoke_config(t_get_config(arch)),
               np_params=jax.tree.map(np.asarray, params), loss=float(loss),
               grads=jax.tree.map(np.asarray, grads), alt_grads=None)
    if cfg.family == "ssm":
        chunked = jrwkv.wkv6_chunked
        jrwkv.wkv6_chunked = lambda r, k, v, w, u, s, *a: jrwkv.wkv6_ref(
            r, k, v, w, u, s)
        try:
            out["alt_grads"] = jax.tree.map(np.asarray, grads_of()[1])
        finally:
            jrwkv.wkv6_chunked = chunked
    return out


def _model(ref):
    return from_jax(ref["np_params"], ref["tcfg"], device="cpu")


def _jax_leaf(tree, name, gs):
    """The reference leaf of a port parameter name: ``blocks.<l>.<path>``
    is group l // gs of ``blocks.sub{l % gs}.<path>``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        layer = int(parts[1])
        node = tree["blocks"][f"sub{layer % gs}"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[layer // gs]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _grads(model, cfg, batch, **kw):
    params = trainable_params(model)
    loss = tapi.loss_fn(model, cfg, batch, **kw)
    return loss.detach(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def _group(cfg):
    return cfg.hybrid.period if cfg.hybrid is not None else 1


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, impl):
    ref = _reference(arch)
    tcfg = ref["tcfg"]
    batch = make_batch(DataConfig(**DCFG), tcfg, 0)
    loss, grads = _grads(_model(ref), tcfg, batch, impl=impl)
    assert abs(float(loss) - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    n_ref = sum(leaf.shape[0] for leaf in jax.tree.leaves(
        ref["grads"]["blocks"])) + sum(
        len(jax.tree.leaves(ref["grads"][k])) for k in ref["grads"]
        if k != "blocks")
    assert len(grads) == n_ref
    for name, g in grads.items():
        want = _jax_leaf(ref["grads"], name, _group(tcfg))
        limit = GRAD_REL
        if ref["alt_grads"] is not None:
            limit = max(limit, 2 * _rel(_jax_leaf(ref["alt_grads"], name, 1),
                                        want))
        assert _rel(g.numpy(), want) <= limit, (name, _rel(g.numpy(), want),
                                                limit)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_drops_match_reference(arch):
    ref = _reference(arch)
    cfg, tcfg = ref["cfg"], ref["tcfg"]
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                capacity_factor=0.5))
    layer = next(i for i in range(_group(cfg))
                 if jlm.ffn_kind(cfg, i) == "moe")
    tree = jax.tree.map(lambda a: a[0],
                        ref["np_params"]["blocks"][f"sub{layer}"]["ffn"])
    model = _model(ref)
    p = model.blocks[layer].ffn
    x = np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_apply(jax.tree.map(jnp.asarray, tree), cfg,
                                    jnp.asarray(x), dropless=False)
    with torch.no_grad():
        got, aux = tmoe.moe_apply(p, tcfg, torch.from_numpy(x),
                                  dropless=False)
        xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
        _, t_idx, _ = tmoe.route(p, tcfg, xt)
    # the reference's slots: its token-major cumsum over the one-hot
    _, j_idx, onehot, _ = jmoe._route(jax.tree.map(jnp.asarray, tree), cfg,
                                      jnp.asarray(xt.numpy()))
    C = jmoe.moe_capacity(cfg, xt.shape[0])
    flat = np.asarray(onehot).reshape(-1, cfg.moe.n_experts)
    j_keep = np.sum((np.cumsum(flat, 0) - flat) * flat, -1) < C
    _, t_keep = tmoe.capacity_slots(t_idx, cfg.moe.n_experts, C)
    assert tmoe.moe_capacity(tcfg, xt.shape[0]) == C
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_keep.numpy(), j_keep)
    assert 0 < (~j_keep).sum() < j_keep.size          # some dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 5])
def test_make_batch_prefix_bit_identical(dtype, step):
    cfg = smoke_config(get_config("internvl2-1b")).replace(
        compute_dtype=dtype)
    tcfg = t_smoke_config(t_get_config("internvl2-1b")).replace(
        compute_dtype=dtype)
    want = j_make_batch(JDataConfig(**DCFG), cfg, step)
    got = make_batch(DataConfig(**DCFG), tcfg, step)
    assert sorted(got) == ["prefix_embeds", "tokens"]
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["tokens"].shape == (2, 64 - cfg.n_prefix_embeds)
    pre = got["prefix_embeds"]
    assert pre.dtype == getattr(torch, dtype)
    bits = {"float32": (torch.int32, np.int32),
            "bfloat16": (torch.int16, np.int16)}[dtype]
    np.testing.assert_array_equal(
        pre.view(bits[0]).numpy(),
        np.asarray(want["prefix_embeds"]).view(bits[1]))


def test_prefix_rounding_follows_jnp():
    """1 + 2^-8 + 2^-30 rounds to 1 through float32 (a tie, to even) but
    up when rounded straight from float64: the port rounds as jnp."""
    x = np.array([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30) * 0.02,
                  0.02])
    got = _as_compute(x, torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, want)
    assert float(_as_compute(x, torch.bfloat16)[0]) == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    ref = _reference(arch)
    tcfg = ref["tcfg"]
    batch = make_batch(DataConfig(**DCFG), tcfg, 0)
    outs = [_grads(_model(ref), tcfg, batch, remat=remat)
            for remat in (False, True)]
    assert abs(float(outs[0][0]) - float(outs[1][0])) <= 1e-6 * abs(
        float(outs[0][0]))
    for name, g in outs[0][1].items():
        assert _rel(outs[1][1][name].numpy(), g.numpy()) <= 1e-6, name

