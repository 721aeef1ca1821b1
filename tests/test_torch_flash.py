"""The port's flash attention plain versions and autograd op against the
JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Forward: the port's ``flash_attention_ref`` against the Pallas
``flash_attention`` in interpret mode and ``repro``'s
``flash_attention_ref``, over ``tests/test_kernels.py``'s five sweep shapes
plus one with ``Sq > Sk`` (rows that see no key), at the reference's
``TOL`` (3e-5 in float32, 3e-2 in bfloat16). Backward: the explicit formula
``flash_attention_bwd_ref`` in float32 against torch autograd through the
plain forward (in float64) and ``jax.grad`` of ``repro``'s reference (in
float32), 1e-5 absolute. The ``autograd.Function`` passes ``gradcheck``
in float64, and ``attention_full`` matches the reference layer for both
``impl``s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.kernels.flash_attention.kernel import flash_attention as pallas_fa
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.layers import attention as jattn
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.layers import attention as tattn
from repro_torch.params import from_jax

TOL = {"float32": 3e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, Sq, Sk, H, K, hd, causal, window): test_kernels.py's sweep, then a
# causal case with Sq > Sk whose first 32 rows see no key
SHAPES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 64, 192, 6, 2, 64, True, 0),
    (1, 128, 128, 2, 2, 128, False, 0),
    (1, 64, 64, 8, 1, 256, True, 0),
    (1, 96, 64, 4, 2, 32, True, 0),
]
IDS = ["gqa", "window", "sq_lt_sk", "bidir", "mqa_hd256", "sq_gt_sk"]


def _inputs(shape, seed=0):
    B, Sq, Sk, H, K, hd, _, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                      (B, Sq, H, hd))]


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      np.asarray(a, np.float32), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_plain_matches_pallas_and_reference(shape, dtype):
    *_, causal, window = shape
    q, k, v, _ = _inputs(shape)
    jq, jk, jv = (jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v))
    pallas = pallas_fa(jq, jk, jv, causal=causal, window=window, block_q=32,
                       block_k=64, interpret=True)
    jref = jax_ref(jq, jk, jv, causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    out = fa_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window)
    assert out.dtype == TDT[dtype] and out.shape == tq.shape
    for want in (pallas, jref):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=0,
                                   atol=TOL[dtype])
    o, lse = fa_ref.flash_attention_fwd_ref(tq, tk, tv, causal=causal,
                                            window=window)
    np.testing.assert_array_equal(_f32(o), _f32(out))
    assert lse.shape == (shape[0], shape[3], shape[1])


def test_rows_that_see_no_key_average_all_values():
    shape = SHAPES[-1]
    q, k, v, _ = _inputs(shape)
    out = fa_ref.flash_attention_ref(*(torch.from_numpy(a)
                                       for a in (q, k, v)))
    n_empty = shape[1] - shape[2]
    G = shape[3] // shape[4]
    mean_v = np.repeat(v.mean(axis=1), G, axis=1)          # (B, H, hd)
    for i in range(n_empty):
        np.testing.assert_allclose(out[:, i].numpy(), mean_v, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_bwd_plain_matches_autograd_and_jax_grad(shape):
    *_, causal, window = shape
    q, k, v, do = _inputs(shape, seed=1)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    # autograd in float64: in float32 its own rounding reaches 1.05e-5 on
    # the MQA case's dV (8 heads of 64 keys summed), the formula's 5.4e-6
    leaves = [t.double().requires_grad_() for t in (tq, tk, tv)]
    o = fa_ref.flash_attention_ref(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(o, leaves, tdo.double())
    o2, lse = fa_ref.flash_attention_fwd_ref(tq, tk, tv, causal=causal,
                                             window=window)
    got = fa_ref.flash_attention_bwd_ref(tq, tk, tv, o2, lse, tdo,
                                         causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal,
                                             window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for g, a, j in zip(got, auto, jgrads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window", [
    (1, 6, 6, 2, 1, 4, True, 0),       # GQA G = 2
    (2, 5, 7, 2, 2, 4, True, 3),       # Sq < Sk, window
    (1, 7, 4, 3, 1, 4, True, 0),       # Sq > Sk: rows that see no key
    (1, 5, 5, 2, 2, 4, False, 2),      # bidirectional window
])
def test_flash_op_gradcheck_float64(B, Sq, Sk, H, K, hd, causal, window):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, dtype=torch.float64,
                           requires_grad=True)
               for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa_ops.flash_attention(a, b, c, causal=causal,
                                               window=window),
        (q, k, v))


def test_flash_op_on_cpu_is_the_plain_pair():
    shape = SHAPES[0]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, seed=2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves)
    o, lse = fa_ref.flash_attention_fwd_ref(q, k, v)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    got = torch.autograd.grad(out, leaves, do)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(hd=48), "head_dim"),
    (dict(kdtype=torch.bfloat16), "share"),
    (dict(K=3), "H % K"),
    (dict(kB=2), "do not match"),
])
def test_flash_kernel_wrapper_rejects_what_it_does_not_take(bad, match):
    hd, K = bad.get("hd", 64), bad.get("K", 2)
    q = torch.zeros((1, 8, 4, hd))
    k = torch.zeros((bad.get("kB", 1), 8, K, hd),
                    dtype=bad.get("kdtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        fa_ops._check("flash_attention", q, k, k.clone())


@pytest.fixture(scope="module")
def smoke_models():
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config("qwen1.5-0.5b"))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_attention_full_matches_reference(smoke_models, impl):
    cfg, params, tcfg, model = smoke_models
    x = np.random.default_rng(3).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], params["blocks"]["sub0"]["mix"])
    want = jattn.attention_full(jp, cfg, jnp.asarray(x), pos_offset=5)
    got = tattn.attention_full(model.blocks[1].mix, tcfg,
                               torch.from_numpy(x), pos_offset=5, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
