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
asserted here. dbrx's expert-parallel ``moe_apply`` matches the reference's
``moe_apply(shard_axes=...)`` jitted on the four forced host devices.
gemma3's sequence route in bf16 stays within the dense-cache bf16 bound
of the unpartitioned step in bf16, a merge-less control beyond it. At
world size 1 the partitioned step is the unpartitioned one bit for bit, and
``shard_axes=None`` is the call without it."""
import dataclasses
import os
import subprocess
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
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import Mesh, rank_coordinates
from repro_torch.models import api, lm

sys.path.insert(0, str(Path(__file__).parent))
import _torch_partition_worker as worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
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
}
# the attention route of each sub-layer's cache at model 2 / model 4
ROUTES = {
    (1, 2, 2): {"qwen": ["heads"], "gemma3": ["seq"] * 6,
                "minicpm": ["seq"], "internvl2": ["seq"], "dbrx": ["heads"],
                "gemma3_whole": ["seq"] * 5 + ["replicated"]},
    (1, 1, 4): {"qwen": ["heads"], "gemma3": ["seq"] * 6,
                "minicpm": ["seq"], "internvl2": ["seq"], "dbrx": ["seq"],
                "gemma3_whole": ["seq"] * 5 + ["replicated"]},
}


def _start(dims, tmp: Path):
    """The worker on every rank of a (pod, data, model) mesh of ``dims``."""
    world = int(np.prod(dims))
    shape = ",".join(map(str, dims))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    tmp.mkdir()
    return tmp, [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), str(r), str(world),
         shape, str(tmp / "store"), str(tmp / f"rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks, spawned once and all at once (meshes (1, 2, 2),
    (1, 1, 4) and (1, 1, 1)); ``runs(dims)`` waits for a mesh's and
    returns each rank's saved arrays."""
    base = tmp_path_factory.mktemp("partition")
    started = {dims: _start(dims, base / "x".join(map(str, dims)))
               for dims in MESHES + ((1, 1, 1),)}
    done = {}

    def get(dims):
        if dims not in done:
            tmp, procs = started[dims]
            logs = [p.communicate(timeout=600)[0] for p in procs]
            assert all(p.returncode == 0 for p in procs), logs
            done[dims] = [dict(np.load(tmp / f"rank{r}.npz"))
                          for r in range(len(procs))]
        return done[dims]
    yield get
    for _, procs in started.values():
        for p in procs:
            p.communicate(timeout=600)


@pytest.mark.parametrize("case", list(worker.CASES))
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_partitioned_step_matches_unpartitioned(runs, dims, case):
    ranks = runs(dims)
    for r, out in enumerate(ranks):
        assert [int(c) for c in out["coords"]] == list(
            np.unravel_index(r, dims))
        assert list(out[f"{case}/specs"]) == list(SPECS[case])
        assert list(out[f"{case}/routes"]) == ROUTES[dims][case]
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
    for out in runs(dims):
        assert list(out["gemma3_bf16/routes"]) == ["seq"] * 6
        assert np.all(out["gemma3_bf16/row_rel"] <= worker.BF16_TOL), \
            out["gemma3_bf16/row_rel"]
        assert out["gemma3_bf16/control_row_rel"][1:].max() \
            > worker.BF16_TOL, out["gemma3_bf16/control_row_rel"]


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_dbrx_prefill_drops_capacity_as_the_unpartitioned_step(runs, dims):
    """Capacity comes from the rank's token count: a rank drops what the
    unpartitioned step drops on the same rows, and it drops some."""
    for out in runs(dims):
        got, want = out["dbrx/drops"]
        assert got == want > 0
        assert out["dbrx/moe_drops"] > 0


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
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


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


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-3b",
                                  "jamba-v0.1-52b", "whisper-tiny"])
def test_other_families_name_what_is_missing(arch):
    cfg = smoke_config(get_config(arch))
    why = partition.unsupported_reason(cfg)
    assert why and "not ported" in why
    with pytest.raises(NotImplementedError, match="not ported"):
        api.prefill(api.param_specs(cfg), cfg, torch.zeros(1, 2), {},
                    shard_axes={"ctx": None})
