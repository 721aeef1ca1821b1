"""The partitioned train step (``TrainConfig.shard_axes``: the
differentiable collectives of ``repro_torch/distributed/partition.py``,
the sharded layers with sequence parallelism, the vocab-parallel
cross-entropy, FSDP, data-parallel gradients, the global clipping norm)
against the reference's ``make_train_step(..., TrainConfig(shard_axes=...))``
jitted on a mesh of the same shape over the four forced host devices.

Spawned gloo workers (``tests/_torch_partition_train_worker.py``, no jax)
on meshes (1, 2, 2) and (1, 1, 4) at world size 4 and (1, 1, 1) at world
size 1, spawned once and together, from weights drawn in the reference's
parameter tree and carried over with ``from_jax``: smoke float32 configs of qwen (the head
route), gemma3 (windowed and global layers; its kv heads split mid-head
over model 4), minicpm and internvl2 (q heads that divide neither model
size; whole vocabularies; internvl2's prefix rows, its stream split along
T over model 2 and replicated over model 4), under FSDP, two
micro-batches of each rank's rows, remat and one AdamW step that clips:
the loss, ``grad_norm`` and every parameter and first moment after the
step within 1e-5 relative. At world size 1 two partitioned steps equal
two unpartitioned ones bit for bit, for those and gemma-7b. Each collective's gradient under a
loss replicated over ``model`` equals autograd of the unsharded function,
so that a factor of the axis' size fails by name."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.distributed.sharding import ShardingRules as JRules
from repro.models import api as japi
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import make_train_step as j_make_train_step
from repro_torch.params import from_jax

sys.path.insert(0, str(Path(__file__).parent))
import _torch_partition_train_worker as worker  # noqa: E402
import _torch_ranks as spawn  # noqa: E402

MESHES = ((1, 2, 2), (1, 1, 4))
TOL = 1e-5
# the layout each case takes on each mesh: attention route, the stream,
# the vocabulary, FSDP (a spec naming data, of size 1 on (1, 1, 4))
LAYOUTS = {
    (1, 2, 2): {"qwen": ["heads", "sp", "vocab split", "fsdp"],
                "gemma3": ["heads", "sp", "vocab split", "fsdp"],
                "minicpm": ["covered", "sp", "whole vocab", "fsdp"],
                "internvl2": ["covered", "sp", "whole vocab", "fsdp"]},
    (1, 1, 4): {"qwen": ["heads", "sp", "vocab split", "fsdp"],
                "gemma3": ["covered", "sp", "vocab split", "fsdp"],
                "minicpm": ["covered", "sp", "whole vocab", "fsdp"],
                "internvl2": ["covered", "replicated", "whole vocab",
                              "fsdp"]},
}


def _jcfg(name):
    arch, over, _ = worker.CASES[name]
    return j_smoke_config(j_get_config(arch)).replace(**over)


def _weights(cfg, seed: int):
    """The reference's parameter tree (``api.param_specs``' shapes and
    dtypes), drawn from numpy: 0.05 x normal, norm and qk-norm scales and
    biases included (none zero), without compiling its initialiser."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s.shape) * 0.05, s.dtype),
        japi.param_specs(cfg))


def _reference_step(name, dims, params):
    """The reference's sharded train step, jitted as its dry run jits it
    (``in_shardings`` from its ``ShardingRules`` under FSDP), on the four
    forced host devices -> (params, opt state, stats)."""
    cfg = _jcfg(name)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(dims),
                 ("pod", "data", "model"))
    rules = JRules(mesh, cfg, fsdp=True)
    ocfg = JAdamWConfig(**worker.OCFG)
    opt = j_adamw_init(params, ocfg)
    batch = {k: jnp.asarray(v.numpy()) for k, v in worker.batch(name).items()}
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "sp": True}
    step = j_make_train_step(cfg, ocfg, JTrainConfig(
        micro_batches=worker.MICRO, remat=True, shard_axes=axes))
    shard = (rules.params(params), rules.opt_state(opt, params))
    fn = jax.jit(step, in_shardings=shard + (rules.batch(batch, worker.B),),
                 out_shardings=shard + (None,))
    with mesh:
        return fn(params, opt, batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights written for the workers, each
    mesh's ranks spawned at once, the reference's steps taken meanwhile;
    ``runs(dims)`` -> (each rank's saved arrays, {case: the reference's
    (params, opt state, stats)})."""
    base = tmp_path_factory.mktemp("partition_train")
    weights = base / "weights"
    weights.mkdir()
    params = {}
    for i, name in enumerate(worker.CASES):
        params[name] = _weights(_jcfg(name), i)
        model = from_jax(jax.tree.map(np.asarray, params[name]),
                         worker.case_config(name), device="cpu")
        np.savez(weights / f"{name}.npz", **{
            n: p.detach().numpy() for n, p in model.named_parameters()})
    started = {dims: spawn.start(Path(worker.__file__), dims,
                                base / "x".join(map(str, dims)),
                                middle=(weights,))
               for dims in MESHES + ((1, 1, 1),)}
    refs = {dims: {name: _reference_step(name, dims, params[name])
                   for name in worker.MESH_CASES} for dims in MESHES}

    def get(dims):
        return started[dims].outputs(), refs.get(dims)
    try:
        yield get
    finally:
        for group in started.values():
            group.close()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_leaf(tree, name: str):
    """The reference leaf of a port parameter: ``blocks.<l>.<path>`` is
    group l // group_size's row of ``blocks.sub<l % group_size>.<path>``."""
    parts = name.split(".")
    if parts[0] != "blocks":
        node = tree
        for p in parts:
            node = node[p]
        return np.asarray(node)
    gs = len(tree["blocks"])
    layer = int(parts[1])
    node = tree["blocks"][f"sub{layer % gs}"]
    for p in parts[2:]:
        node = node[p]
    return np.asarray(node)[layer // gs]


@pytest.mark.parametrize("case", worker.MESH_CASES)
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_partitioned_train_step_matches_reference(runs, dims, case):
    ranks, refs = runs(dims)
    params, opt, stats = refs[case]
    loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
    assert gnorm > worker.OCFG["grad_clip"]          # the step clips
    for r, out in enumerate(ranks):
        assert [int(c) for c in out["coords"]] == list(
            np.unravel_index(r, dims))
        assert list(out[f"{case}/layout"]) == LAYOUTS[dims][case]
        assert int(out[f"{case}/rows"]) == worker.B // dims[1]
        assert abs(float(out[f"{case}/loss"]) - loss) <= TOL * abs(loss)
        assert abs(float(out[f"{case}/grad_norm"]) - gnorm) <= TOL * gnorm
    out = ranks[-1]
    names = [k.split("/", 2)[2] for k in out if k.startswith(f"{case}/param/")]
    assert names
    for n in names:
        assert _rel(out[f"{case}/param/{n}"], _jax_leaf(params, n)) <= TOL, n
        assert _rel(out[f"{case}/mu/{n}"], _jax_leaf(opt.mu, n)) <= TOL, n


@pytest.mark.parametrize("case", list(worker.CASES))
def test_world_size_one_is_bit_identical(runs, case):
    out = runs((1, 1, 1))[0][0]
    assert out[f"{case}/bit_identical"].all(), out[f"{case}/bit_identical"]


@pytest.mark.parametrize("op", ["all_reduce", "enter", "all_gather",
                                "reduce_scatter", "split"])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_collective_gradients_are_the_unsharded_function_s(runs, dims, op):
    for out in runs(dims)[0]:
        assert float(out[f"collective/{op}"]) <= 1e-12, (
            op, float(out[f"collective/{op}"]))
