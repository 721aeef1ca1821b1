"""The port's distributed training hooks against the reference's:
``compressed_psum`` (``repro_torch/training/compression.py``) on gloo at
world sizes 2 and 4 — spawned workers (``tests/_torch_dist_worker.py``,
which imports no jax) joined through a ``FileStore`` — bit for bit against
the reference's ``compressed_psum`` under ``shard_map_compat`` over the
first 2 / 4 forced host devices, for two rounds of error feedback; and
``reshard_for_mesh`` (``repro_torch/training/elastic.py``) against the
reference's ``addressable_shards`` over the same 4-device meshes."""
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
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.distributed.sharding import ShardingRules as JRules
from repro.distributed.sharding import shard_map_compat
from repro.models import api as japi
from repro.training.compression import compressed_psum as j_compressed_psum
from repro.training.elastic import reshard_for_mesh as j_reshard
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.sharding import P, ShardingRules
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.training.elastic import Shard, reshard_for_mesh

sys.path.insert(0, str(Path(__file__).parent))
import _torch_dist_worker as worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference(world: int):
    """The reference's two rounds over the first ``world`` host devices,
    called as ``tests/test_training.py`` calls it (not under ``jax.jit``:
    jitted, XLA's CPU backend contracts ``x - q * scale`` into one fused
    multiply-add, a rounding away from the reference's order of
    operations, which the port keeps)."""
    mesh = JMesh(np.array(jax.devices()[:world]), ("dp",))
    f = shard_map_compat(
        lambda g, e: (lambda m, ne: (m, ne[None]))(
            *j_compressed_psum(g[0], e[0], "dp")),
        mesh, (JP("dp"), JP("dp")), (JP(), JP("dp")), check=False)
    per_rank = [worker.inputs(r) for r in range(world)]
    errs = [jnp.zeros((world,) + s, jnp.float32) for s in worker.SHAPES]
    out = {}
    for k in range(2):
        for i in range(len(worker.SHAPES)):
            g = jnp.asarray(np.stack([per_rank[r][k][i]
                                      for r in range(world)]))
            mean, errs[i] = f(g, errs[i])
            out[f"mean_{k}_{i}"] = np.asarray(mean)
            out[f"err_{k}_{i}"] = np.asarray(errs[i])
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_reference_bit_for_bit(world, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / f"rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    ref = _reference(world)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for key, want in ref.items():
        for r in range(world):
            if key.startswith("mean"):
                np.testing.assert_array_equal(got[r][key], want,
                                              err_msg=f"{key} rank {r}")
            else:
                np.testing.assert_array_equal(got[r][key], want[r],
                                              err_msg=f"{key} rank {r}")
    # the shared scale: rank 0's large tensor sets it on every rank, so
    # the other ranks' error buffers are coarser than their local scale
    # would leave them
    i = len(worker.SHAPES) - 1
    assert np.abs(got[1][f"err_0_{i}"]).max() > \
        np.abs(worker.inputs(1)[0][i]).max() / 127 / 2


def _port_shards(out):
    return [(s.device, s.index, s.data.numpy()) for s in out]


@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 2, 2), (1, 1, 4)])
def test_reshard_for_mesh_matches_addressable_shards(shape):
    """The smoke qwen's parameters under the sharding rules: each leaf's
    per-entry shards (index slices and data) equal the reference's
    ``addressable_shards`` entry by entry."""
    axes = ("pod", "data", "model")
    jcfg = j_smoke_config(j_get_config("qwen1.5-0.5b"))
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.PRNGKey(0), jcfg))
    jm = jax.make_mesh(shape, axes, devices=jax.devices()[:4])
    jrules = JRules(jm, jcfg)
    tm = tmesh.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(shape),
                    axes)
    trules = ShardingRules(tm, cfg)
    # the unstacked leaves of the port: layer 0 of each stacked leaf
    jtree = {"embed": params["embed"], "final_norm": params["final_norm"],
             "blocks": {"sub0": jax.tree.map(lambda x: x[:1],
                                             params["blocks"]["sub0"])}}
    jout = j_reshard(jtree, jm, jrules.param_spec)
    flat = jax.tree_util.tree_flatten_with_path(jout)[0]
    torch_tree = {}
    for path, arr in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[0] == "blocks":
            name = ".".join(["blocks", "0"] + keys[2:])
            data = np.asarray(arr)[0]
        else:
            name = ".".join(keys)
            data = np.asarray(arr)
        torch_tree[name] = (torch.from_numpy(np.array(data)), arr)
    tout = reshard_for_mesh({n: t for n, (t, _) in torch_tree.items()}, tm,
                            trules.param_spec)
    pos = {d: i for i, d in enumerate(jm.devices.flat)}
    for name, (_, arr) in torch_tree.items():
        shards = tout[name]
        assert len(shards) == 4 and all(isinstance(s, Shard) for s in shards)
        grouped = name.startswith("blocks.")
        for js in arr.addressable_shards:
            ts = shards[pos[js.device]]
            want_idx = js.index[1:] if grouped else js.index
            want = np.asarray(js.data)[0] if grouped else np.asarray(js.data)
            assert ts.index == tuple(want_idx), (name, ts.index, js.index)
            np.testing.assert_array_equal(ts.data.numpy(), want, name)
            assert ts.device == torch.device("cpu")


def test_reshard_for_mesh_one_device_places_every_leaf():
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tm = tmesh.make_debug_mesh(1, devices=["cpu"])
    out = reshard_for_mesh(model, tm, ShardingRules(tm, cfg).param_spec)
    named = dict(model.named_parameters())
    assert set(out) == set(named)
    for n, t in out.items():
        assert isinstance(t, torch.Tensor) and not t.requires_grad
        assert torch.equal(t, named[n].detach())
    nested = reshard_for_mesh({"a": [torch.ones(2)], "b": torch.zeros(3)},
                              tm, lambda p, l: P(None))
    assert torch.equal(nested["a"][0], torch.ones(2))
