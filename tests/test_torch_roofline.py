"""The port's roofline count (``repro_torch/analysis/roofline.py``) against
the reference's HLO parser (``repro/analysis/roofline.py``) on the same
functions, against ``torch.utils.flop_counter.FlopCounterMode`` on a
training step, and the hand-written kernels' meta route and ``cost``.

The four cases of ``tests/test_roofline_parser.py``: each function runs on
the ``meta`` device under ``TraceRecorder``, its JAX twin is jitted and its
optimized HLO read by the reference's ``analyze_text``; the FLOP agree
within 1%, and an update of 4 KB into a 16 MB buffer counts under 1e6
bytes. The kernel costs reproduce ``PERF.md``'s kernel-table bounds within
1%: row 9 forward and backward at (4, 2048, 16, 64) causal bf16, row 8 at
(8, 256, 40, 64), row 8b at (4, 2048, 40, 64)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import roofline as jroof
from repro.configs import SHAPES_BY_NAME as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import perfmodel as jperf
from repro_torch.analysis import roofline as roof
from repro_torch.configs import (ALL_SHAPES, get_config, list_archs,
                                 smoke_config)
from repro_torch.core.perfmodel import H100_SXM, TPU_V5E
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_mask
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import api
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import (TrainConfig, make_train_step,
                                             trainable_params)

M = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=M)


def _traced(fn, *args):
    rec = roof.TraceRecorder(arguments=args)
    with rec:
        fn(*args)
    return rec


def _hlo_cost(fn, *specs, donate=()):
    txt = jax.jit(fn, donate_argnums=donate).lower(*specs).compile().as_text()
    return jroof.analyze_text(txt)


def _loop(h, ws):
    for w in ws:
        h = torch.tanh(h @ w)
    return h


@pytest.mark.parametrize("L", [4, 16])
def test_layer_loop_flops_match_reference(L):
    def body(h, w):
        return jnp.tanh(h @ w), None

    def f(h, ws):
        return jax.lax.scan(body, h, ws)[0]

    want = _hlo_cost(f, jax.ShapeDtypeStruct((128, 128), jnp.float32),
                     jax.ShapeDtypeStruct((L, 128, 128), jnp.float32))
    got = _traced(_loop, _meta(128, 128), _meta(L, 128, 128)).cost()
    assert got.flops == pytest.approx(want.flops, rel=0.01)
    assert got.flops == L * 2 * 128 ** 3


def test_dot_flops_match_reference():
    want = _hlo_cost(lambda a, b: a @ b,
                     jax.ShapeDtypeStruct((64, 256), jnp.float32),
                     jax.ShapeDtypeStruct((256, 32), jnp.float32))
    got = _traced(lambda a, b: a @ b, _meta(64, 256), _meta(256, 32)).cost()
    assert got.flops == pytest.approx(want.flops, rel=0.01)
    assert got.flops == 2 * 64 * 256 * 32


@pytest.mark.parametrize("how", ["slice", "index_copy_"])
def test_inplace_update_counts_slice_not_buffer(how):
    def f(buf, upd):
        if how == "slice":
            buf[0:1] = upd
        else:
            buf.index_copy_(0, torch.zeros(1, dtype=torch.long, device=M),
                            upd)
        return buf

    want = _hlo_cost(lambda b, u: jax.lax.dynamic_update_slice(b, u, (0, 0)),
                     jax.ShapeDtypeStruct((4096, 1024), jnp.float32),
                     jax.ShapeDtypeStruct((1, 1024), jnp.float32),
                     donate=(0,))
    got = _traced(f, _meta(4096, 1024), _meta(1, 1024)).cost()
    assert got.flops == pytest.approx(want.flops, rel=0.01)
    assert got.bytes < 1e6
    assert got.bytes >= 2 * 1024 * 4


def test_nested_loop_flops_match_reference():
    def inner(c, x):
        return jnp.tanh(c @ x), None

    def outer(c, xs):
        def ob(c, x):
            return jax.lax.scan(inner, c, x)[0], None
        return jax.lax.scan(ob, c, xs)[0]

    def nested(c, xs):
        for x in xs:
            c = _loop(c, x)
        return c

    want = _hlo_cost(outer, jax.ShapeDtypeStruct((32, 32), jnp.float32),
                     jax.ShapeDtypeStruct((5, 7, 32, 32), jnp.float32))
    got = _traced(nested, _meta(32, 32), _meta(5, 7, 32, 32)).cost()
    assert got.flops == pytest.approx(want.flops, rel=0.01)
    assert got.flops == 5 * 7 * 2 * 32 ** 3


def test_views_are_free_and_records_merge():
    x = _meta(64, 32, 32)
    rec = _traced(lambda x: [x.transpose(1, 2).reshape(64, 1024).t()
                             for _ in range(3)], x)
    # the transposed reshape copies (64 x 1024 float32) once a pass; the
    # views around it count nothing
    assert rec.cost().bytes == 3 * 64 * 1024 * 4
    assert {r["op"]: r["n"] for r in rec.records.values()}[
        "aten.clone.default"] == 3


def test_peak_bytes_follow_live_intermediates():
    x = _meta(256, 1024)
    rec = _traced(lambda x: ((x * 2) * 3) * 4, x)
    # each product lives until the next one is made; x is an argument
    assert rec.peak_bytes == 2 * 256 * 1024 * 4


def test_trace_round_trips_through_a_file(tmp_path):
    rec = _traced(_loop, _meta(128, 128), _meta(4, 128, 128))
    path = str(tmp_path / "t.trace.jsonl.gz")
    rec.write(path)
    got = roof.analyze_file(path)
    want = rec.cost()
    assert (got.flops, got.bytes) == (want.flops, want.bytes)


def test_train_step_flops_equal_flop_counter_mode():
    """A qwen smoke-config train step through the plain twins: the meta
    trace's FLOP equal ``FlopCounterMode``'s on CPU tensors."""
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    ocfg = AdamWConfig(lr=3e-4)
    step = make_train_step(cfg, ocfg, TrainConfig(micro_batches=2,
                                                  impl="ref"))
    specs = api.param_specs(cfg)
    batch = {"tokens": _meta(4, 64, dtype=torch.int32)}
    opt = adamw_init(trainable_params(specs), ocfg)
    traced = _traced(step, specs, opt, batch).cost()

    model = api.instantiate(specs, 0, "cpu")
    cpu_batch = api.instantiate(batch, 1, "cpu")
    cpu_opt = adamw_init(trainable_params(model), ocfg)
    with FlopCounterMode(display=False) as counter:
        step(model, cpu_opt, cpu_batch)
    assert counter.get_total_flops() > 0
    assert traced.flops == counter.get_total_flops()


def test_roofline_arithmetic_equals_reference_on_tpu_constants():
    cost = roof.Cost(3.2e15, 7.5e12, 4.1e11, {"all-reduce": 3})
    jcost = jroof.Cost(cost.flops, cost.bytes, cost.coll_bytes,
                       dict(cost.coll_counts))
    got = roof.roofline_from_cost(cost, model_flops_per_device=1.7e15,
                                  hw=TPU_V5E, n_links=2)
    want = jroof.roofline_from_cost(jcost, model_flops_per_device=1.7e15)
    assert got.__dict__ == want.__dict__
    h100 = roof.roofline_from_cost(cost, model_flops_per_device=1.7e15)
    assert h100.t_compute == cost.flops / H100_SXM.flops_peak
    assert h100.t_memory == cost.bytes / H100_SXM.hbm_bw
    assert h100.t_collective == cost.coll_bytes / H100_SXM.fabric.peak_bw
    both = cost + cost.scale(2)
    assert (both.flops, both.coll_counts) == (3 * cost.flops,
                                              {"all-reduce": 9})


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_reference(arch):
    assert jperf.ModelCost.from_config(j_get_config(arch)).n_params > 0
    for shape in ALL_SHAPES:
        assert roof.model_flops(get_config(arch), shape) == \
            jroof.model_flops(j_get_config(arch), J_SHAPES[shape.name])


def _bound_ms(flops, nbytes):
    return max(flops / H100_SXM.flops_peak, nbytes / H100_SXM.hbm_bw) * 1e3


@pytest.mark.parametrize("cost,want_ms", [
    (fa_ops.cost(4, 2048, 2048, 16, 16, 64), 0.0348),
    (fa_ops.cost(4, 2048, 2048, 16, 16, 64, backward=True), 0.0869),
    (wkv_ops.cost(8, 256, 40, 64), 0.0282),
    (wkv_ops.cost(4, 2048, 40, 64, backward=True), 0.2898),
], ids=["row9_fwd", "row9_bwd", "row8", "row8b"])
def test_kernel_cost_reproduces_the_kernel_table_bound(cost, want_ms):
    assert _bound_ms(*cost) == pytest.approx(want_ms, rel=0.01)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, 0), (64, 64, True, 16), (8, 96, True, 0),
    (96, 40, True, 0), (24, 50, False, 0), (30, 30, False, 7)])
def test_visible_pairs_count_the_mask(Sq, Sk, causal, window):
    assert fa_ops.visible_pairs(Sq, Sk, causal, window) == int(
        attention_mask(Sq, Sk, causal, window, "cpu").sum())


def _kernel_entries(fn, *args):
    rec = _traced(fn, *args)
    return roof.kernel_calls(rec.records.values()), rec


def test_flash_meta_route_shapes_cost_and_no_launch():
    B, S, H, K, hd = 2, 128, 8, 2, 64
    q = _meta(B, S, H, hd, dtype=torch.bfloat16).requires_grad_()
    k = _meta(B, S, K, hd, dtype=torch.bfloat16).requires_grad_()
    v = _meta(B, S, K, hd, dtype=torch.bfloat16).requires_grad_()
    before = dict(build.LAUNCHES)

    def step(q, k, v):
        o = fa_ops.flash_attention(q, k, v, window=32)
        assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
        dq, dk, dv = torch.autograd.grad(o.float().sum(), (q, k, v))
        assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    calls, rec = _kernel_entries(step, q, k, v)
    assert dict(build.LAUNCHES) == before
    assert calls == {"flash_attention": 1, "flash_attention_bwd": 1}
    kern = [r for r in rec.records.values() if "kernel" in r]
    fwd = fa_ops.cost(B, S, S, H, K, hd, window=32)
    bwd = fa_ops.cost(B, S, S, H, K, hd, window=32, backward=True)
    assert sorted((r["flops"], r["bytes"]) for r in kern) == sorted(
        [tuple(map(float, fwd)), tuple(map(float, bwd))])
    o, lse = fa_ops.flash_attention_fwd(q.detach(), k.detach(), v.detach())
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32


def test_wkv_meta_route_shapes_cost_and_no_launch():
    B, T, H, hd = 2, 70, 4, 64
    r, k, v = (_meta(B, T, H, hd, dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    w = _meta(B, T, H, hd).requires_grad_()
    u = _meta(H, hd).requires_grad_()
    s0 = _meta(B, H, hd, hd).requires_grad_()
    before = dict(build.LAUNCHES)

    def step(r, k, v, w, u, s0):
        y, s1 = wkv_ops.wkv6(r, k, v, w, u, s0)
        assert (y.shape, y.dtype) == (r.shape, r.dtype)
        assert (s1.shape, s1.dtype) == (s0.shape, torch.float32)
        gs = torch.autograd.grad(y.float().sum() + s1.sum(),
                                 (r, k, v, w, u, s0))
        assert [(g.shape, g.dtype) for g in gs] == [
            (t.shape, t.dtype) for t in (r, k, v, w, u, s0)]
    calls, rec = _kernel_entries(step, r, k, v, w, u, s0)
    assert dict(build.LAUNCHES) == before
    assert calls == {"wkv6": 1, "wkv6_bwd": 1}
    by_name = {x["kernel"]: x for x in rec.records.values() if "kernel" in x}
    assert (by_name["wkv6"]["flops"], by_name["wkv6"]["bytes"]) == tuple(
        map(float, wkv_ops.cost(B, T, H, hd)))
    assert (by_name["wkv6_bwd"]["flops"], by_name["wkv6_bwd"]["bytes"]) \
        == tuple(map(float, wkv_ops.cost(B, T, H, hd, backward=True)))


def test_wkv_cost_counts_each_chunk():
    """A short last chunk counts its own pairs: T = 70 is chunks of 32,
    32 and 6 tokens."""
    parts = [wkv_ops.cost(1, t, 4, 64) for t in (32, 32, 6)]
    one = wkv_ops.cost(1, 70, 4, 64)
    assert one[0] == pytest.approx(sum(p[0] for p in parts), rel=1e-12)
    assert math.isclose(one[1] - 2 * 4 * 64 * 64 * 4 - 4 * 64 * 4,
                        sum(p[1] - 2 * 4 * 64 * 64 * 4 - 4 * 64 * 4
                            for p in parts))
