"""The port's dropless MoE (``repro_torch/layers/moe.py``) against the JAX
reference's ``repro/layers/moe.py``, on the CPU.

Weights come from the reference's ``init_moe`` on the deepseek-v2-lite-16b
smoke config (4 experts, top-2, 1 shared expert of width 128, float32) and
are copied into the port's ``MoE``; token rows are made with numpy from a
seed. The port computes the dropless dispatch grouped by expert, the
reference over an (E, N, d) buffer: the same function.

- ``route``: expert indices exactly, gates and the aux loss at rtol 1e-4 /
  atol 1e-5. ``torch.topk`` and ``jax.lax.top_k`` may order near-ties
  differently; the seeds here were checked to hold no near-tie (the
  smallest gap between the k-th and (k+1)-th router logit is asserted
  above 1e-4), so a tie would fail the check, not pass unseen.
- ``moe_apply`` against the reference's ``moe_apply(dropless=True)``:
  float32 at rtol 1e-4 / atol 1e-5; bfloat16 (weights and tokens rounded
  to bf16 alike) at rtol 2e-2 / atol 2e-2, the bf16 rounding of h before
  the down projection, where the two frameworks' GEMMs sum in other
  orders. Cases: pad rows (one token's row repeated, as a packed step's
  padding gives; an all-zero row would tie every expert), one expert
  taking every token (its router column raised), an expert taking none
  (its column lowered), and shared experts on and off.
- ``dropless=False`` (capacity dispatch, training) at the smoke config's
  capacity factor (no drop): the reference's ``moe_apply(dropless=False)``
  at the float32 limits; drops are held to the reference in
  ``test_torch_train_families.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.layers import moe as jmoe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.layers import moe as tmoe

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
N_TOKENS = 48


def _configs(shared: bool = True):
    cfg = smoke_config(get_config(ARCH))
    tcfg = t_smoke_config(t_get_config(ARCH))
    if not shared:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  n_shared_experts=0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    n_shared_experts=0))
    return cfg, tcfg


def _port_moe(tree, tcfg, dtype=torch.float32):
    """The port's MoE holding the reference tree's weights."""
    m = tmoe.MoE(tcfg, torch.device("cpu"))

    def put(param, value):
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value, np.float32)))
    put(m.router.w, tree["router"]["w"])
    for name in ("up", "down", "gate"):
        put(getattr(m, name), tree[name])
    if m.shared is not None:
        for name in ("up", "down", "gate"):
            put(getattr(m.shared, name).w, tree["shared"][name]["w"])
    return m.to(dtype)


@pytest.fixture(scope="module")
def moe_pair():
    out = {}
    for shared in (True, False):
        cfg, tcfg = _configs(shared)
        tree = jax.tree.map(np.asarray,
                            jmoe.init_moe(jax.random.PRNGKey(3), cfg))
        out[shared] = (cfg, tcfg, tree, _port_moe(tree, tcfg))
    return out


def _tokens(cfg, seed, n=N_TOKENS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n // 2, cfg.d_model)).astype(np.float32)
    return x


def _min_tie_gap(tree, cfg, x):
    """The smallest gap, over the tokens, between the k-th and (k+1)-th
    router logit (the probabilities' log ratio), in float64."""
    logits = (x.reshape(-1, cfg.d_model).astype(np.float64)
              @ tree["router"]["w"].astype(np.float64))
    s = -np.sort(-logits, axis=-1)
    K = cfg.moe.top_k
    return float((s[:, K - 1] - s[:, K]).min())


@pytest.mark.parametrize("seed", [0, 1])
def test_route_matches_reference(moe_pair, seed):
    cfg, tcfg, tree, model = moe_pair[True]
    x = _tokens(cfg, seed).reshape(-1, cfg.d_model)
    assert _min_tie_gap(tree, cfg, x) > 1e-4, "near-tie: choose another seed"
    jg, ji, _, jaux = jmoe._route(tree, cfg, jnp.asarray(x))
    tg, ti, taux = tmoe.route(model, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def _case_inputs(case, cfg, tree):
    """Tokens and (possibly edited) router weights of one case."""
    x = _tokens(cfg, 5)
    tree = jax.tree.map(np.copy, tree)
    if case == "pad_rows":
        # a packed step's padding: one token's row repeated (the normed
        # embedding of the pad token)
        x[0, -6:] = x[1, 3]
        x[1, -8:] = x[1, 3]
    elif case == "one_expert_takes_all":
        tree["router"]["w"][:, 2] = 0.0
        x[..., 0] = np.abs(x[..., 0]) + 1.0
        tree["router"]["w"][0, 2] = 8.0
    elif case == "an_expert_takes_none":
        tree["router"]["w"][:, 1] = 0.0
        x[..., 0] = np.abs(x[..., 0]) + 1.0
        tree["router"]["w"][0, 1] = -50.0
    return x, tree


CASES = ["plain", "pad_rows", "one_expert_takes_all", "an_expert_takes_none"]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_reference_dropless(moe_pair, case, dtype, shared):
    cfg, tcfg, tree, _ = moe_pair[shared]
    x, tree = _case_inputs(case, cfg, tree)
    assert _min_tie_gap(tree, cfg, x) > 1e-4, "near-tie: choose another seed"
    td, jd = {"float32": (torch.float32, jnp.float32),
              "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    tcfg = tcfg.replace(param_dtype=dtype, compute_dtype=dtype)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jd), tree)
    model = _port_moe(tree, tcfg, td)
    xb = jnp.asarray(x, jd)
    jy, jaux = jmoe.moe_apply(jtree, cfg, xb, dropless=True)
    ty, taux = tmoe.moe_apply(model, tcfg,
                              torch.from_numpy(np.array(xb, np.float32))
                              .to(td), dropless=True)
    assert ty.dtype == td and taux.dtype == torch.float32
    _, ji, _, _ = jmoe._route(jtree, cfg, xb.reshape(-1, cfg.d_model))
    counts = np.bincount(np.asarray(ji).reshape(-1),
                         minlength=cfg.moe.n_experts)
    if case == "one_expert_takes_all":
        assert counts[2] == x.shape[0] * x.shape[1]
    if case == "an_expert_takes_none":
        assert counts[1] == 0
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_pad_rows_do_not_change_real_rows(moe_pair):
    """Dropless routing is per token: a row's output is the same whatever
    the other rows of the call hold."""
    cfg, tcfg, tree, model = moe_pair[True]
    x = torch.from_numpy(_tokens(cfg, 7))
    y, _ = tmoe.moe_apply(model, tcfg, x)
    x2 = x.clone()
    x2[:, 10:] = 0.0
    y2, _ = tmoe.moe_apply(model, tcfg, x2)
    torch.testing.assert_close(y2[:, :10], y[:, :10], rtol=1e-6, atol=1e-6)


def test_capacity_dispatch_is_refused(moe_pair):
    """Capacity dispatch (refused before the port trained MoE families)
    against the reference's, output and aux loss."""
    cfg, tcfg, tree, model = moe_pair[True]
    x = _tokens(cfg, 0)
    want, want_aux = jmoe.moe_apply(jax.tree.map(jnp.asarray, tree), cfg,
                                    jnp.asarray(x), dropless=False)
    got, aux = tmoe.moe_apply(model, tcfg, torch.from_numpy(x),
                              dropless=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_expert_weights_keep_the_reference_names_and_scales(moe_pair):
    """The port's own init: the reference's keys and shapes, and its init
    scales (trunc-normal(-2, 2) of std ~0.88 of the scale)."""
    cfg, tcfg, tree, carried = moe_pair[True]
    g = torch.Generator().manual_seed(0)
    model = tmoe.MoE(tcfg, torch.device("cpu"), g)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(p.shape) for n, p in carried.named_parameters()}
    assert got == want
    assert set(got) == {"router.w", "up", "down", "gate", "shared.up.w",
                        "shared.down.w", "shared.gate.w"}
    d, fe = cfg.d_model, cfg.moe.d_ff_expert
    fs = fe * cfg.moe.n_shared_experts
    for name, scale in (("up", d ** -0.5), ("down", fe ** -0.5),
                        ("router.w", d ** -0.5),
                        ("shared.down.w", fs ** -0.5)):
        std = dict(model.named_parameters())[name].std().item()
        assert abs(std / (0.88 * scale) - 1) < 0.1, name
