"""The partitioned serving step (``repro_torch/distributed/partition.py``,
the sharded layers, ``api.prefill`` / ``api.decode_step`` with
``shard_axes``) against the port's unpartitioned step and the reference.

Spawned gloo workers (``tests/_torch_partition_worker.py``, no jax), four
ranks on meshes (1, 2, 2) and (1, 1, 4), spawned once and together: for smoke
float32 configs whose widths hit the head route (qwen), the sequence route
with windowed rings (gemma3; its global layers' 33 slots, which split
neither way, on the replicated route), q heads that do not divide the model axis
(minicpm, internvl2) and dbrx's expert parallelism under FSDP with capacity
drops, the partitioned prefill and eight greedy decode steps match the
unpartitioned step on the rank's rows (logits and every cache block
within 1e-5 relative, greedy tokens equal), through the specs and routes
asserted here; and so do the families whose caches the rules split as on
pod256: deepseek's MLA (the latent and roped-key columns), jamba (the
Mamba state by d_state, its kv heads not dividing model 4) under FSDP,
rwkv6 (3 heads: the wkv state by key rows, through the key-slice WKV) and
whisper (3 heads: the self cache by slots, the cross cache replicated).
dbrx's expert-parallel ``moe_apply`` matches the reference's
``moe_apply(shard_axes=...)``, and jamba's Mamba layer the reference's
``mamba_forward(shard_axes=...)``, each jitted on the four forced host
devices. The key slices of the plain WKV sum to the whole.
gemma3's sequence route in bf16 stays within the dense-cache bf16 bound
of the unpartitioned step in bf16, a merge-less control beyond it. At
world size 1 the partitioned step is the unpartitioned one bit for bit, and
``shard_axes=None`` is the call without it."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.layers.moe import moe_apply as j_moe_apply
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import Mesh, rank_coordinates
from repro_torch.models import api, lm

sys.path.insert(0, str(Path(__file__).parent))
import _torch_partition_worker as worker  # noqa: E402
import _torch_ranks as spawn  # noqa: E402

MESHES = ((1, 2, 2), (1, 1, 4))
TOL = 1e-5

# the specs of worker.SPEC_NAMES each case takes ('' where it has none)
DENSE_SPECS = ("PartitionSpec('model', None)", "PartitionSpec(None, 'model')",
               "PartitionSpec(None, 'model')", "PartitionSpec('model', None)",
               "", "PartitionSpec(None, 'model')", "", "")
SPECS = {
    "qwen": DENSE_SPECS, "gemma3": DENSE_SPECS, "internvl2": DENSE_SPECS,
    "gemma3_whole": DENSE_SPECS,
    # a vocabulary of 513 does not split: the embedding stays whole
    "minicpm": ("PartitionSpec(None, None)",) + DENSE_SPECS[1:],
    # FSDP: every weight's other dim over data; the router's too
    "dbrx": ("PartitionSpec('model', 'data')",
             "PartitionSpec('data', 'model')",
             "PartitionSpec('data', 'model')",
             "PartitionSpec('model', 'data')",
             "PartitionSpec('model', 'data', None)", "",
             "PartitionSpec('model', 'data')",
             "PartitionSpec('model', 'data', None)"),
    "deepseek": ("PartitionSpec('model', None)",
                 "PartitionSpec(None, 'model')", "",
                 "PartitionSpec('model', None)",
                 "PartitionSpec('model', None, None)", "",
                 "PartitionSpec('model', None)",
                 "PartitionSpec('model', None, None)"),
    "jamba": ("PartitionSpec('model', 'data')", "", "", "", "",
              "PartitionSpec('data', 'model')", "", ""),
    "rwkv6": ("PartitionSpec('model', None)",) + ("",) * 7,
    "whisper": ("PartitionSpec('model', None)",) + ("",) * 7,
}
# worker.FAMILY_SPEC_NAMES' specs: wdkv's and wuk's columns; in_proj's
# columns ([x_in | z]) and A_log's channels under FSDP; u's key dim, wr's
# columns and cm.wv's OUTPUT; the cross-attention's q columns, wo rows
FAMILY_SPECS = {
    "deepseek": ["PartitionSpec(None, 'model')"] * 2,
    "jamba": ["PartitionSpec('data', 'model')",
              "PartitionSpec('model', 'data')"],
    "rwkv6": ["PartitionSpec(None, 'model')"] * 3,
    "whisper": ["PartitionSpec(None, 'model')",
                "PartitionSpec('model', None)"],
}
DP = "('pod', 'data')"


def _p(*entries) -> str:
    return "PartitionSpec(" + ", ".join(entries) + ")"


# the cache leaves' specs (api.tree_leaves order) of the new families:
# deepseek's latents and roped keys by columns; rwkv6's wkv state by key
# rows, its shift states by channels; whisper's cross cache whole, its
# self cache by slots; jamba's Mamba ssm state by d_state and conv state
# by channels, its attention layer (sub4) by kv heads at model 2 and by
# slots at model 4
STATE = _p("None", DP, "None", "'model'")
CACHE_SPECS = {
    "deepseek": [STATE] * 2,
    "rwkv6": [_p("None", DP, "None", "'model'", "None")]
    + [_p("None", DP, "'model'")] * 2,
    "whisper": [_p("None", DP, "None", "None", "None")] * 2
    + [_p("None", DP, "'model'", "None", "None")] * 2,
}
JAMBA_KV = {(1, 2, 2): _p("None", DP, "None", "'model'", "None"),
            (1, 1, 4): _p("None", DP, "'model'", "None", "None")}
# the attention route of each sub-layer's cache at model 2 / model 4
ROUTES = {
    (1, 2, 2): {"qwen": ["heads"], "gemma3": ["seq"] * 6,
                "minicpm": ["seq"], "internvl2": ["seq"], "dbrx": ["heads"],
                "gemma3_whole": ["seq"] * 5 + ["replicated"],
                "deepseek": [], "jamba": ["heads"], "rwkv6": [],
                "whisper": ["replicated", "seq"]},
    (1, 1, 4): {"qwen": ["heads"], "gemma3": ["seq"] * 6,
                "minicpm": ["seq"], "internvl2": ["seq"], "dbrx": ["seq"],
                "gemma3_whole": ["seq"] * 5 + ["replicated"],
                "deepseek": [], "jamba": ["seq"], "rwkv6": [],
                "whisper": ["replicated", "seq"]},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks, spawned once and all at once (meshes (1, 2, 2),
    (1, 1, 4) and (1, 1, 1)); ``runs(dims)`` waits for a mesh's and
    returns each rank's saved arrays, or fails with every rank's return
    code and log tail (``tests/_torch_ranks.py``)."""
    base = tmp_path_factory.mktemp("partition")
    started = {dims: spawn.start(Path(worker.__file__), dims,
                                base / "x".join(map(str, dims)))
               for dims in MESHES + ((1, 1, 1),)}
    try:
        yield lambda dims: started[dims].outputs()
    finally:
        for group in started.values():
            group.close()


@pytest.mark.parametrize("case", list(worker.CASES))
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_partitioned_step_matches_unpartitioned(runs, dims, case):
    ranks = runs(dims)
    for r, out in enumerate(ranks):
        assert [int(c) for c in out["coords"]] == list(
            np.unravel_index(r, dims))
        assert list(out[f"{case}/specs"]) == list(SPECS[case])
        assert list(out[f"{case}/routes"]) == ROUTES[dims][case]
        assert list(out[f"{case}/family_specs"]) == FAMILY_SPECS.get(case,
                                                                     [])
        if case == "jamba":
            want = [STATE] * 8 + [JAMBA_KV[dims]] * 2 + [STATE] * 6
            assert list(out[f"{case}/cache_specs"]) == want
        elif case in CACHE_SPECS:
            assert list(out[f"{case}/cache_specs"]) == CACHE_SPECS[case]
        assert np.all(out[f"{case}/logit_rel"] <= TOL), \
            (r, out[f"{case}/logit_rel"])
        assert np.all(out[f"{case}/cache_rel"] <= TOL), \
            (r, out[f"{case}/cache_rel"])
        np.testing.assert_array_equal(out[f"{case}/tokens"],
                                      out[f"{case}/ref_tokens"])
        assert out[f"{case}/tokens"].shape == (worker.STEPS + 1,
                                               worker.B // dims[1])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_bf16_sequence_route_within_the_dense_cache_bound(runs, dims):
    """gemma3's sequence route in bf16 (its partial outputs cast as
    ``_partial_sdpa`` casts them, then merged) stays within the dense-cache
    phases' bf16 bound of the unpartitioned step in bf16 at every step; a
    rank that normalises over its own slots alone goes beyond it."""
    for r, out in enumerate(runs(dims)):
        assert list(out["gemma3_bf16/routes"]) == ["seq"] * 6, (
            "rank", r, "routes", list(out["gemma3_bf16/routes"]))
        assert np.all(out["gemma3_bf16/row_rel"] <= worker.BF16_TOL), (
            "rank", r, "bf16 per-row logit distance to the unpartitioned "
            "step, step by step", out["gemma3_bf16/row_rel"],
            "bound", worker.BF16_TOL)
        assert out["gemma3_bf16/control_row_rel"][1:].max() \
            > worker.BF16_TOL, (
            "rank", r, "the merge-less control's per-row distance",
            out["gemma3_bf16/control_row_rel"], "must exceed",
            worker.BF16_TOL)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_dbrx_prefill_drops_capacity_as_the_unpartitioned_step(runs, dims):
    """Capacity comes from the rank's token count: a rank drops what the
    unpartitioned step drops on the same rows, and it drops some."""
    for r, out in enumerate(runs(dims)):
        got, want = out["dbrx/drops"]
        assert got == want > 0, ("rank", r, "prefill drops partitioned",
                                 got, "unpartitioned", want)
        assert out["dbrx/moe_drops"] > 0, (
            "rank", r, "expert-parallel moe_apply drops",
            out["dbrx/moe_drops"])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_expert_parallel_moe_matches_reference(runs, dims):
    """The ranks' rows of dbrx's expert-parallel ``moe_apply`` (capacity
    dispatch, FSDP stacks) against the reference's ``shard_map`` path,
    jitted on a mesh of the same shape over the forced host devices."""
    ranks = runs(dims)
    cfg = j_smoke_config(j_get_config("dbrx-132b"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(dims),
                 ("pod", "data", "model"))
    w = ranks[0]
    params = {"router": {"w": jnp.asarray(w["dbrx/w_router"])},
              **{n: jnp.asarray(w[f"dbrx/w_{n}"])
                 for n in ("up", "gate", "down")}}
    x = worker.moe_inputs(worker.case_config("dbrx")).numpy()
    axes = {"dp": ("pod", "data"), "tp": "model", "mesh": mesh}
    want = np.asarray(jax.jit(lambda p, x: j_moe_apply(
        p, cfg, x, dropless=False, shard_axes=axes)[0])(params, x))
    # the rows of each dp shard, from its model-coordinate-0 rank
    got = np.concatenate([out["dbrx/moe_out"] for out in ranks
                          if out["coords"][2] == 0])
    assert got.shape == want.shape, ("rows", got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (
        "moe_apply rows' largest distance to the reference", err, "limit",
        TOL * np.abs(want).max())


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_mamba_layer_matches_reference(runs, dims):
    """The ranks' rows of jamba's partitioned Mamba layer (``mamba_sharded``
    under FSDP from a non-zero state: in_proj's columns gathered, the conv
    on the rank's channels, the scan on its d_state slice, the partial C.h
    all-reduced) against the reference's ``mamba_forward(shard_axes=...)``
    jitted on a mesh of the same shape over the forced host devices."""
    from repro.layers import mamba as j_mamba
    ranks = runs(dims)
    cfg = j_smoke_config(j_get_config("jamba-v0.1-52b"))
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(dims),
                 ("pod", "data", "model"))
    w = ranks[0]
    params = {}
    for key, val in w.items():
        if key.startswith("jamba/w_"):
            *mods, leaf = key[len("jamba/w_"):].split(".")
            node = params
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = jnp.asarray(val)
    x, ssm, conv = (t.numpy() for t in worker.mamba_inputs(
        worker.case_config("jamba")))
    axes = {"dp": ("pod", "data"), "tp": "model", "mesh": mesh}
    with mesh:
        want = np.asarray(jax.jit(lambda p, x, s, c: j_mamba.mamba_forward(
            p, cfg, x, j_mamba.MambaState(s, c), shard_axes=axes)[0])(
                params, x, ssm, conv))
    got = np.concatenate([out["jamba/mamba_out"] for out in ranks
                          if out["coords"][2] == 0])
    assert got.shape == want.shape, ("rows", got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (
        "Mamba rows' largest distance to the reference", err, "limit",
        TOL * np.abs(want).max())


@pytest.mark.parametrize("slices", [2, 4, 16])
def test_key_slices_of_the_plain_wkv_sum_to_the_whole(slices):
    """The rectangular plain WKV (``wkv6_plain``, the key-slice kernel's
    twin) over K / ``slices`` key rows of a 64-wide head: the slices'
    partial y summed is the whole y within 1e-5, their state rows
    concatenated the whole state within 1e-6; through the chunked form (T
    96) and the scan (T 5). ``wkv6`` on the CPU routes a rectangular
    state there too."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_plain
    rng = np.random.default_rng(slices)
    B, H, hd = 2, 3, 64
    kk = hd // slices
    for T in (96, 5):
        r, k, v = (torch.from_numpy(rng.standard_normal(
            (B, T, H, hd)).astype(np.float32)) for _ in range(3))
        w = torch.from_numpy(-rng.uniform(1e-3, 2.0, (B, T, H, hd))
                             .astype(np.float32))
        u = torch.from_numpy(rng.standard_normal((H, hd)).astype(np.float32))
        s0 = torch.from_numpy((rng.standard_normal((B, H, hd, hd)) * 0.1)
                              .astype(np.float32))
        y, s1 = wkv6_plain(r, k, v, w, u, s0)
        parts = []
        for i in range(slices):
            ks = slice(i * kk, (i + 1) * kk)
            args = (r[..., ks].contiguous(), k[..., ks].contiguous(), v,
                    w[..., ks].contiguous(), u[:, ks].contiguous(),
                    s0[:, :, ks].contiguous())
            parts.append(wkv_ops.wkv6(*args))
            assert all(torch.equal(a, b) for a, b in zip(
                parts[-1], wkv6_plain(*args)))
        y_sum = torch.stack([p[0] for p in parts]).sum(0)
        s_cat = torch.cat([p[1] for p in parts], 2)
        assert ((y_sum - y).abs().max() / y.abs().max()) <= 1e-5
        assert ((s_cat - s1).abs().max() / s1.abs().max()) <= 1e-6


def test_key_slice_meta_route_and_refusals():
    """The key-slice wrapper on ``meta`` tensors (the dry run's trace)
    makes one ``meta_call`` entry with ``keyslice_cost``; it refuses a key
    count that is not a power of two below V and a V outside (32, 64).
    Under autograd it is the ``WKV6KeySlice`` op (its backward, the
    rectangular plain backward on the CPU, is held in
    ``tests/test_torch_wkv_keyslice_bwd.py``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    def args(K, V, device="meta", grad=False):
        B, T, H = 2, 7, 3
        bf = dict(dtype=torch.bfloat16, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return (torch.empty((B, T, H, K), **bf),
                torch.empty((B, T, H, K), **bf),
                torch.empty((B, T, H, V), **bf),
                torch.empty((B, T, H, K), **f32),
                torch.zeros((H, K), requires_grad=grad, **f32),
                torch.empty((B, H, K, V), **f32))
    seen = []
    build.META_SINKS.append(seen.append)
    try:
        y, s = wkv_ops.wkv6(*args(4, 64))
    finally:
        build.META_SINKS.remove(seen.append)
    assert y.shape == (2, 7, 3, 64) and s.shape == (2, 3, 4, 64)
    assert [e["kernel"] for e in seen] == ["wkv6_keyslice"]
    flops, nbytes = wkv_ops.keyslice_cost(2, 7, 3, 4, 64)
    assert (seen[0]["flops"], seen[0]["bytes"]) == (flops, nbytes)
    for K, V in ((3, 64), (4, 48), (64, 128)):
        with pytest.raises(ValueError):
            wkv_ops.wkv6_keyslice(*args(K, V))
    cpu = [torch.rand(t.shape, dtype=t.dtype) for t in args(4, 64)]
    cpu[3] = -cpu[3]
    u = cpu[4].requires_grad_()
    y, _ = wkv_ops.wkv6(*cpu)
    assert y.grad_fn.name() == "WKV6KeySliceBackward"
    y.float().sum().backward()
    assert u.grad is not None and u.grad.shape == (3, 4)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_world_size_one_is_bit_identical(runs, case):
    out = runs((1, 1, 1))[0]
    assert out[f"{case}/bit_identical"].all(), out[f"{case}/bit_identical"]


def test_shard_axes_none_is_the_unpartitioned_call():
    cfg = worker.case_config("gemma3")
    model = lm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens, _ = worker.inputs(cfg)
    outs = []
    for kw in ({}, {"shard_axes": None}):
        cache = api.init_decode_state(cfg, worker.B, worker.S, device="cpu")
        a, cache = api.prefill(model, cfg, tokens, cache, **kw)
        b, cache = api.decode_step(model, cfg, cache, a.argmax(-1),
                                   torch.full((worker.B,), worker.T), **kw)
        outs.append([a, b] + api.tree_leaves(cache))
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    assert not any(hasattr(p, "pspec") for p in model.parameters())


def _ctx(dims, rank, device="cpu"):
    coords = dict(zip(partition.AXES, np.unravel_index(rank, dims)))
    return partition.RankContext(
        rank=rank, sizes=dict(zip(partition.AXES, dims)),
        coords={a: int(c) for a, c in coords.items()}, groups={},
        device=torch.device(device))


def test_rank_coordinates_and_context():
    mesh = Mesh(np.full((2, 2, 4), "cpu", dtype=object),
                ("pod", "data", "model"))
    assert rank_coordinates(mesh, 0) == {"pod": 0, "data": 0, "model": 0}
    assert rank_coordinates(mesh, 7) == {"pod": 0, "data": 1, "model": 3}
    assert rank_coordinates(mesh, 13) == {"pod": 1, "data": 1, "model": 1}
    ctx = _ctx((2, 2, 4), 13)
    assert ctx.index(("pod", "data")) == (3, 4)
    assert ctx.index("model") == (1, 4) and ctx.index(None) == (0, 1)
    assert ctx.range("model", 8) == (8, 16) and ctx.model_n == 4


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 4)])
def test_a_rank_holds_exactly_its_specs_shards(dims):
    """Every parameter, cache leaf and batch leaf of rank 5 (mod world) is
    the block its spec names: its bytes sum to ``dryrun._per_device``'s."""
    from repro_torch.launch.dryrun import _per_device
    cfg = worker.case_config("dbrx")
    mesh = Mesh(np.full(dims, "meta", dtype=object), ("pod", "data",
                                                      "model"))
    rules = ShardingRules(mesh, cfg, fsdp=True)
    ctx = _ctx(dims, 5 % int(np.prod(dims)), "meta")
    model = api.param_specs(cfg)
    local = partition.shard_model(model, rules, ctx)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    assert nbytes(local.parameters()) == _per_device(
        dict(model.named_parameters()), rules.params(model), mesh.shape)
    specs = rules.params(model)
    for n, _ in local.named_parameters():
        mod, _, leaf = n.rpartition(".")
        assert partition.pspec(local.get_submodule(mod), leaf) == specs[n]
    cache = api.decode_state_specs(cfg, 8, 32)
    cl = partition.shard_cache(cache, rules, ctx, 8)
    assert nbytes(api.tree_leaves(cl)) == _per_device(
        cache, rules.cache(cache, 8), mesh.shape)
    tok = torch.empty((8, 5), dtype=torch.int32, device="meta")
    assert partition.shard_batch(tok, rules, ctx, 8).shape == (
        8 // (dims[0] * dims[1]), 5)


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 4)])
@pytest.mark.parametrize("case", ["deepseek", "jamba", "rwkv6", "whisper"])
def test_a_rank_of_a_new_family_holds_exactly_its_specs_shards(case, dims):
    """As above for the MLA, hybrid, RWKV-6 and encoder-decoder configs:
    the rank's parameters and cache leaves sum to ``_per_device``'s
    bytes."""
    from repro_torch.launch.dryrun import _per_device
    cfg = worker.case_config(case)
    mesh = Mesh(np.full(dims, "meta", dtype=object), ("pod", "data",
                                                      "model"))
    rules = ShardingRules(mesh, cfg, fsdp=worker.CASES[case][2])
    ctx = _ctx(dims, 5 % int(np.prod(dims)), "meta")
    model = api.param_specs(cfg)
    local = partition.shard_model(model, rules, ctx)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    assert nbytes(local.parameters()) == _per_device(
        dict(model.named_parameters()), rules.params(model), mesh.shape)
    cache = api.decode_state_specs(cfg, 8, 32)
    cl = partition.shard_cache(cache, rules, ctx, 8)
    assert nbytes(api.tree_leaves(cl)) == _per_device(
        cache, rules.cache(cache, 8), mesh.shape)
