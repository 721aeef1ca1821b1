"""The partitioned train step of the MoE, MLA and hybrid families
(``TrainConfig.shard_axes``: the expert-parallel ``moe_apply`` backward,
``mla_train_sharded``, ``mamba_train_sharded``, the reference's rows in
each micro-batch) against the reference's ``make_train_step(...,
TrainConfig(shard_axes=...))`` jitted on a mesh of the same shape over the
four forced host devices.

Spawned gloo workers (``tests/_torch_partition_train_worker.py``, suite
``moe``, no jax) on meshes (1, 2, 2) and (1, 1, 4) at world size 4 and
(1, 1, 1) at world size 1, spawned once and together, from weights drawn
in the reference's parameter tree and carried over with ``from_jax``:
smoke float32 dbrx, deepseek and jamba (``MOE_CASES``: the stream split
along T, and replicated where the positions do not divide ``model``), and
dbrx at capacity factor 1.25, under FSDP, two micro-batches, remat and
one AdamW step that clips: ``grad_norm`` and every parameter and first
moment after the step within 1e-5 relative, and the loss where the
reference's is the mean over the dp ranks. The reference reports dp
shard 0's aux term (its expert-parallel ``shard_map`` declares the aux
replicated, ``check=False``) while its gradient is the mean's: the port
reports the mean, and the reference's report is held to shard 0's. At
world size 1 two partitioned steps equal two unpartitioned ones bit for
bit. A rank's micro-batch rows are those the reference's sharding gives
it. The MoE layer's router, expert and input gradients on a rank equal
autograd of the unsharded layer, so that a factor of ``model`` fails by
name."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.distributed.sharding import ShardingRules as JRules
from repro.models import api as japi
from repro.models import lm as jlm
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
CASES = tuple(worker.MOE_CASES)
# the stream's layout on each mesh: split along T where the positions
# divide model, else replicated
SP = {(1, 2, 2): {"dbrx": "sp", "deepseek": "sp", "jamba": "sp",
                  "dbrx_c125": "sp"},
      (1, 1, 4): {"dbrx": "sp", "deepseek": "replicated",
                  "jamba": "replicated", "dbrx_c125": "sp"}}


def _jcfg(name):
    return worker.case_config(name, j_get_config, j_smoke_config)


def _weights(cfg, seed: int):
    """The reference's parameter tree drawn from numpy: 0.05 x normal,
    without compiling its initialiser."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s.shape) * 0.05, s.dtype),
        japi.param_specs(cfg))


def _jmesh(dims):
    return JMesh(np.array(jax.devices()[:4]).reshape(dims),
                 ("pod", "data", "model"))


def _reference_step(name, dims, params):
    """The reference's sharded train step, jitted as its dry run jits it,
    on the four forced host devices -> (params, opt state, stats)."""
    cfg = _jcfg(name)
    mesh = _jmesh(dims)
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


def _reference_shard_losses(name, params, dp: int) -> dict:
    """The reference's unsharded loss and aux on each dp shard's rows of
    each micro-batch (the rows and capacity its expert-parallel step
    gives a shard) -> the mean over shards and micro-batches (the port's
    report) and, with each micro-batch's cross-entropy over all its rows,
    dp shard 0's aux term (the reference's report)."""
    cfg = _jcfg(name)
    tokens = jnp.asarray(worker.batch(name)["tokens"].numpy())
    n, b = worker.MICRO, worker.B // worker.MICRO // dp
    loss = jax.jit(lambda p, t: japi.loss_fn(p, cfg, {"tokens": t}))
    aux = jax.jit(lambda p, t: jlm.forward(p, cfg, t)[1])
    coef = cfg.moe.aux_loss_coef / max(cfg.n_layers // cfg.moe.moe_every, 1)
    losses = np.zeros((n, dp))
    auxes = np.zeros((n, dp))
    for m in range(n):
        for r in range(dp):
            rows = tokens[(m * dp + r) * b:(m * dp + r + 1) * b]
            losses[m, r] = float(loss(params, rows))
            auxes[m, r] = float(aux(params, rows))
    ce = (losses - coef * auxes).mean(axis=1)
    return {"mean": float(losses.mean()),
            "shard0": float((ce + coef * auxes[:, 0]).mean())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights written for the workers, each mesh's ranks
    spawned at once, the reference's steps taken meanwhile; ``runs(dims)``
    -> (each rank's saved arrays, {case: the reference's (params, opt
    state, stats)}, {case: its losses by dp shard})."""
    base = tmp_path_factory.mktemp("partition_train_moe")
    weights = base / "weights"
    weights.mkdir()
    params = {}
    for name in CASES:
        params[name] = _weights(_jcfg(name), list(worker.ALL_CASES).index(
            name))
        model = from_jax(jax.tree.map(np.asarray, params[name]),
                         worker.case_config(name), device="cpu")
        np.savez(weights / f"{name}.npz", **{
            n: p.detach().numpy() for n, p in model.named_parameters()})
    started = {dims: spawn.start(Path(worker.__file__), dims,
                                base / "x".join(map(str, dims)),
                                middle=(weights,), tail=("moe",))
               for dims in MESHES + ((1, 1, 1),)}
    refs = {dims: {name: _reference_step(name, dims, params[name])
                   for name in CASES} for dims in MESHES}
    shards = {name: _reference_shard_losses(name, params[name], 2)
              for name in CASES}

    def get(dims):
        return started[dims].outputs(), refs.get(dims), shards
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


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_partitioned_train_step_matches_reference(runs, dims, case):
    ranks, refs, shards = runs(dims)
    params, opt, stats = refs[case]
    gnorm = float(stats["grad_norm"])
    assert gnorm > worker.OCFG["grad_clip"]          # the step clips
    # the port reports the mean over dp ranks; the reference's report is
    # that where dp is 1
    loss = shards[case]["mean"] if dims[1] > 1 else float(stats["loss"])
    for r, out in enumerate(ranks):
        assert [int(c) for c in out["coords"]] == list(
            np.unravel_index(r, dims))
        assert list(out[f"{case}/layout"])[1] == SP[dims][case]
        assert int(out[f"{case}/rows"]) == worker.B // dims[1]
        assert abs(float(out[f"{case}/loss"]) - loss) <= TOL * abs(loss)
        assert abs(float(out[f"{case}/grad_norm"]) - gnorm) <= TOL * gnorm
    out = ranks[-1]
    names = [k.split("/", 2)[2] for k in out if k.startswith(f"{case}/param/")]
    assert any(".ffn.router." in n for n in names)
    for n in names:
        assert _rel(out[f"{case}/param/{n}"], _jax_leaf(params, n)) <= TOL, n
        assert _rel(out[f"{case}/mu/{n}"], _jax_leaf(opt.mu, n)) <= TOL, n


@pytest.mark.parametrize("case", CASES)
def test_reference_reports_dp_shard_zero_aux(runs, case):
    """The documented divergence: on (1, 2, 2) the reference's reported
    loss is each micro-batch's cross-entropy plus dp shard 0's aux term,
    not the mean over shards that its gradient (and the port's report)
    follows."""
    _, refs, shards = runs((1, 2, 2))
    loss = float(refs[case][2]["loss"])
    assert abs(loss - shards[case]["shard0"]) <= TOL * abs(loss)


@pytest.mark.parametrize("case", CASES)
def test_world_size_one_is_bit_identical(runs, case):
    out = runs((1, 1, 1))[0][0]
    assert out[f"{case}/bit_identical"].all(), out[f"{case}/bit_identical"]


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_micro_batch_rows_are_the_reference_s(runs, dims):
    """Each rank's micro-batch m holds the rows the reference's step
    gives its device: micro-batch m of the global batch (its reshape to
    (n, B / n)) split over the dp axes."""
    ranks = runs(dims)[0]
    mesh = _jmesh(dims)
    dp = JRules(mesh, _jcfg("dbrx"), fsdp=True).dp
    ids = np.arange(worker.B).reshape(worker.MICRO, -1)
    coords = {d: np.argwhere(mesh.devices == d)[0] for d in mesh.devices.flat}
    for m in range(worker.MICRO):
        placed = jax.device_put(jnp.asarray(ids[m]),
                                NamedSharding(mesh, JP(dp)))
        for shard in placed.addressable_shards:
            r = int(np.ravel_multi_index(coords[shard.device], dims))
            assert list(ranks[r]["rows"][m]) == list(np.asarray(shard.data))


@pytest.mark.parametrize("param", ["router.w", "up", "x"])
@pytest.mark.parametrize("layout", ["sp", "replicated"])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_moe_gradients_are_the_unsharded_layer_s(runs, dims, layout, param):
    for out in runs(dims)[0]:
        err = float(out[f"router_grad/{layout}/{param}"])
        assert err <= 1e-5, (layout, param, err)
