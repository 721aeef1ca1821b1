"""The port's Mamba layer against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the jamba-v0.1-52b smoke config (d_model 128, d_inner 256, d_state 8,
d_conv 4, dt_rank 8) and are carried over with ``from_jax``. The layer is
sub-layer 0 of the first group (a Mamba sub-layer).

- ``_causal_conv`` with no ``n_real``, a scalar one (0, a middle row, T)
  and a per-lane vector (T, a middle row, 1, 0): output and conv tail.
- ``_chunked_ssm_scan`` from a non-zero h0 at T 24, 100 (one chunk of T),
  128 (one chunk) and 256 (two chunks of ``MAMBA_CHUNK``): the port's
  log-depth scan against the reference's ``associative_scan``, and against
  a sequential float64 recurrence.
- ``mamba_forward`` with pad rows (scalar and per-lane ``n_real``: the
  carried state equals the state after the last real row) and
  ``mamba_decode``, in float32 and bfloat16.

Float32 at rtol 1e-4 / atol 1e-5 (the two scans multiply in other orders;
results are never compared bit for bit). bfloat16 at rtol / atol 2e-2:
the frameworks round the compute-dtype activations (silu, the conv taps,
the gate) at other points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.layers import mamba as jmamba
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.layers import mamba as tmamba
from repro_torch.params import from_jax

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _models(dtype):
    cfg = smoke_config(get_config(ARCH)).replace(param_dtype=dtype,
                                                 compute_dtype=dtype)
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH)).replace(param_dtype=dtype,
                                                      compute_dtype=dtype)
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])
    return cfg, jp, tcfg, model.blocks[0].mix


@pytest.fixture(scope="module")
def layers():
    return {name: _models(name) for name in DTYPES}


def _np(t):
    return t.float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _inputs(cfg, B, T, seed, width=None):
    rng = np.random.default_rng(seed)
    di, ds, dc, _ = jmamba._dims(cfg)
    x = rng.standard_normal((B, T, width or cfg.d_model)).astype(np.float32)
    ssm = (rng.standard_normal((B, di, ds)) * 0.5).astype(np.float32)
    conv = rng.standard_normal((B, dc - 1, di)).astype(np.float32)
    return x, ssm, conv


def test_init_mamba_state_matches_reference(layers):
    cfg, _, tcfg, _ = layers["float32"]
    want = jmamba.init_mamba_state(cfg, 3, jnp.bfloat16)
    got = tmamba.init_mamba_state(tcfg, 3, torch.bfloat16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert tmamba._dims(tcfg) == jmamba._dims(cfg) == (256, 8, 4, 8)


@pytest.mark.parametrize("n_real", [None, 0, 5, 16, "lanes"])
def test_causal_conv_matches_reference(layers, n_real):
    cfg, jp, tcfg, mix = layers["float32"]
    di = jmamba._dims(cfg)[0]
    x, _, conv = _inputs(cfg, 4, 16, seed=3, width=di)
    nr = np.asarray([16, 5, 1, 0], np.int32) if n_real == "lanes" else n_real
    j_out, j_tail = jmamba._causal_conv(
        jp, jnp.asarray(x), jnp.asarray(conv),
        n_real=None if nr is None else jnp.asarray(nr))
    t_out, t_tail = tmamba._causal_conv(mix, torch.from_numpy(x),
                                        torch.from_numpy(conv), n_real=nr)
    np.testing.assert_allclose(_np(t_out), _jnp(j_out), **TOL)
    np.testing.assert_array_equal(_np(t_tail), _jnp(j_tail))
    if n_real == "lanes":
        # lane 3 (no real row) keeps its previous window
        np.testing.assert_array_equal(_np(t_tail)[3], conv[3])


def _scan_inputs(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    di, ds, _, _ = jmamba._dims(cfg)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, di)) - 3.0)).astype(
        np.float32)
    Bm = rng.standard_normal((B, T, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, T, ds)).astype(np.float32)
    x = rng.standard_normal((B, T, di)).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds))
    h0 = (rng.standard_normal((B, di, ds)) * 0.5).astype(np.float32)
    return dt, Bm, Cm, x, np.ascontiguousarray(A), h0


def _sequential(dt, Bm, Cm, x, A, h0):
    dt, Bm, Cm, x, A, h = (v.astype(np.float64)
                           for v in (dt, Bm, Cm, x, A, h0))
    ys = []
    for t in range(x.shape[1]):
        h = (np.exp(dt[:, t, :, None] * A[None]) * h
             + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
        ys.append(np.einsum("bds,bs->bd", h, Cm[:, t]))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("T", [24, 100, 128, 256])
def test_chunked_ssm_scan_matches_reference(layers, T):
    cfg = layers["float32"][0]
    args = _scan_inputs(cfg, 2, T, seed=T)
    j_y, j_h = jmamba._chunked_ssm_scan(*map(jnp.asarray, args))
    t_y, t_h = tmamba._chunked_ssm_scan(*map(torch.from_numpy, args))
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **TOL)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **TOL)
    s_y, s_h = _sequential(*args)
    np.testing.assert_allclose(t_y.numpy(), s_y, **TOL)
    np.testing.assert_allclose(t_h.numpy(), s_h, **TOL)


def test_ssm_scan_chunk_rule():
    """T a multiple of MAMBA_CHUNK runs chunk by chunk, carrying h; any
    other T is one chunk: the state after 256 steps is the state after
    two 128-step scans."""
    cfg = smoke_config(get_config(ARCH))
    dt, Bm, Cm, x, A, h0 = map(torch.from_numpy, _scan_inputs(cfg, 1, 256, 9))
    y, h = tmamba._chunked_ssm_scan(dt, Bm, Cm, x, A, h0)
    y1, h1 = tmamba._chunked_ssm_scan(dt[:, :128], Bm[:, :128], Cm[:, :128],
                                      x[:, :128], A, h0)
    y2, h2 = tmamba._chunked_ssm_scan(dt[:, 128:], Bm[:, 128:], Cm[:, 128:],
                                      x[:, 128:], A, h1)
    assert torch.equal(y, torch.cat([y1, y2], dim=1)) and torch.equal(h, h2)


@pytest.mark.parametrize("form", ["scalar", "lanes"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_forward_with_pad_rows_matches_reference(layers, dtype, form):
    """A bucket-padded chunk (pad rows past ``n_real``) matches the
    reference, and its carried state (ssm and conv tail) is the state of
    the real rows alone."""
    cfg, jp, tcfg, mix = layers[dtype]
    jdt, tdt = DTYPES[dtype]
    tol = TOL if dtype == "float32" else BF16_TOL
    B = 1 if form == "scalar" else 3
    x, ssm, conv = _inputs(cfg, B, 16, seed=11)
    nr = 11 if form == "scalar" else np.asarray([16, 6, 0], np.int32)
    jst = jmamba.MambaState(jnp.asarray(ssm),
                            jnp.asarray(conv).astype(jdt))
    tst = tmamba.MambaState(torch.from_numpy(ssm),
                            torch.from_numpy(conv).to(tdt))
    j_out, j_new = jmamba.mamba_forward(jp, cfg, jnp.asarray(x).astype(jdt),
                                        jst, n_real=jnp.asarray(nr))
    t_out, t_new = tmamba.mamba_forward(mix, tcfg,
                                        torch.from_numpy(x).to(tdt), tst,
                                        n_real=nr)
    assert t_out.dtype == tdt and t_new.ssm.dtype == torch.float32
    assert t_new.conv.dtype == tdt
    np.testing.assert_allclose(_np(t_out), _jnp(j_out), **tol)
    np.testing.assert_allclose(_np(t_new.ssm), _jnp(j_new.ssm), **tol)
    np.testing.assert_allclose(_np(t_new.conv), _jnp(j_new.conv), **tol)
    # the pad rows leave no trace: other pad contents give the same state
    # bit for bit, and it is the state of the real rows alone
    lanes = np.broadcast_to(np.asarray(nr), (B,))
    x2 = x.copy()
    for b, n in enumerate(lanes):
        x2[b, n:] = np.random.default_rng(b).standard_normal(x2[b, n:].shape)
    _, t_new2 = tmamba.mamba_forward(mix, tcfg, torch.from_numpy(x2).to(tdt),
                                     tst, n_real=nr)
    assert torch.equal(t_new2.ssm, t_new.ssm)
    assert torch.equal(t_new2.conv, t_new.conv)
    for b, n in enumerate(lanes):
        st = tmamba.MambaState(tst.ssm[b:b + 1], tst.conv[b:b + 1])
        if n:
            _, st = tmamba.mamba_forward(
                mix, tcfg, torch.from_numpy(x[b:b + 1, :n]).to(tdt), st)
        np.testing.assert_allclose(_np(t_new.ssm[b]), _np(st.ssm[0]), **tol)
        np.testing.assert_allclose(_np(t_new.conv[b]), _np(st.conv[0]),
                                   **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_decode_matches_reference(layers, dtype):
    cfg, jp, tcfg, mix = layers[dtype]
    jdt, tdt = DTYPES[dtype]
    tol = TOL if dtype == "float32" else BF16_TOL
    x, ssm, conv = _inputs(cfg, 4, 1, seed=13)
    j_out, j_new = jmamba.mamba_decode(
        jp, cfg, jnp.asarray(x).astype(jdt),
        jmamba.MambaState(jnp.asarray(ssm), jnp.asarray(conv).astype(jdt)))
    t_out, t_new = tmamba.mamba_decode(
        mix, tcfg, torch.from_numpy(x).to(tdt),
        tmamba.MambaState(torch.from_numpy(ssm),
                          torch.from_numpy(conv).to(tdt)))
    assert t_out.shape == (4, 1, cfg.d_model) and t_out.dtype == tdt
    np.testing.assert_allclose(_np(t_out), _jnp(j_out), **tol)
    np.testing.assert_allclose(_np(t_new.ssm), _jnp(j_new.ssm), **tol)
    np.testing.assert_allclose(_np(t_new.conv), _jnp(j_new.conv), **tol)


def test_decode_steps_equal_forward(layers):
    """Four decode steps carry the same state as one 4-token forward."""
    cfg, _, tcfg, mix = layers["float32"]
    x, ssm, conv = map(torch.from_numpy, _inputs(cfg, 2, 4, seed=17))
    out, st = tmamba.mamba_forward(mix, tcfg, x,
                                   tmamba.MambaState(ssm, conv))
    step = tmamba.MambaState(ssm, conv)
    outs = []
    for t in range(4):
        o, step = tmamba.mamba_decode(mix, tcfg, x[:, t:t + 1], step)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), out.numpy(),
                               **TOL)
    np.testing.assert_allclose(step.ssm.numpy(), st.ssm.numpy(), **TOL)
    np.testing.assert_allclose(step.conv.numpy(), st.conv.numpy(), **TOL)


def test_mamba_parameters_keep_float32_where_the_reference_does(layers):
    """``A_log`` and ``D`` are float32 in a bf16 model, as the reference
    keeps them; every other weight is in the param dtype."""
    _, jp, _, mix = layers["bfloat16"]
    for name, p in mix.named_parameters():
        leaf = jp
        for key in name.split("."):
            leaf = leaf[key]
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), name
        assert tuple(p.shape) == leaf.shape, name
    assert mix.A_log.dtype == mix.D.dtype == torch.float32
