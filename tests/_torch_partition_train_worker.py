"""One rank of ``test_torch_partition_train.py``: joins a gloo group
through a ``FileStore``, builds the rank's context on a (pod, data, model)
mesh and, for every case of ``CASES``, takes one step of the partitioned
train step (``make_train_step`` with ``TrainConfig.shard_axes``: FSDP, two
micro-batches of the rank's rows, remat, sequence parallelism, one AdamW
step whose clipping engages) from the weights the test wrote (the
reference's, carried over with ``from_jax``). Saves the loss, the
``grad_norm``, the route and the layouts it took, and every parameter and
first moment after the step gathered whole. At world size 1 it also takes
the unpartitioned step from the same weights and saves whether the two
agree bit for bit; at world size 4 it holds each differentiable collective
against autograd of the unsharded function (``collective_grads``).
Imports only torch, numpy and repro_torch.

    python tests/_torch_partition_train_worker.py RANK WORLD P,D,M STORE \
        WEIGHTS_DIR OUT_NPZ
"""
import copy
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import Mesh, rank_context
from repro_torch.layers.core import vocab_axis
from repro_torch.models import api, lm
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import (TrainConfig, make_train_step,
                                             trainable_params)

B, T = 4, 24
MICRO = 2
# an lr and a clip at which the step clips (the smoke models' gradient
# norms are ~2 to ~6); eps well above the clipped gradients keeps the first
# AdamW step a smooth function of them (at 1e-8 it is sign-like: an
# element whose gradient is near 0 turns float32 summation-order
# differences into differences of up to lr)
OCFG = dict(lr=1e-3, eps=1e-3, grad_clip=0.1)
# name -> (arch, config overrides, text tokens): the head route (qwen at
# both model sizes; gemma3 at model 2), the covered route (gemma3's 2 kv
# heads of 32 over model 4, split mid-head; minicpm's 3 heads,
# internvl2's 6 on 3 kv heads, which divide neither 2 nor 4), gemma3's
# windowed and global layers (one of each: a group of 2), whole
# vocabularies of 513 (minicpm, internvl2) and internvl2's 8 prefix rows
# before 18 tokens: 26 positions, split along T over model 2, replicated
# over model 4; gemma-7b (its embedding scale and GeGLU) at world size 1
CASES = {
    "qwen": ("qwen1.5-0.5b", {}, T),
    "gemma3": ("gemma3-12b", {"n_layers": 2, "global_layer_every": 2}, T),
    "minicpm": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3,
                               "vocab_size": 513}, T),
    "internvl2": ("internvl2-1b", {"n_heads": 6, "n_kv_heads": 3,
                                   "vocab_size": 513}, 18),
    "gemma7b": ("gemma-7b", {}, T),
}
# the cases taken at world size 4 and held against the reference there
MESH_CASES = ("qwen", "gemma3", "minicpm", "internvl2")
SEED = 36


def case_config(name: str):
    arch, over, _ = CASES[name]
    return smoke_config(get_config(arch)).replace(**over)


def batch(name: str) -> dict:
    """The global batch of a case from one seed: tokens, and a VLM's
    prefix rows."""
    cfg = case_config(name)
    rng = np.random.default_rng(SEED + list(CASES).index(name))
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, CASES[name][2])).astype(np.int32))}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = torch.from_numpy((rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32))
    return out


def load_model(name: str, weights_dir: str):
    cfg = case_config(name)
    model = api.param_specs(cfg).to_empty(device="cpu")
    saved = np.load(f"{weights_dir}/{name}.npz")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(saved[n]))
    return cfg, model


def step_of(cfg, axes):
    return make_train_step(cfg, AdamWConfig(**OCFG), TrainConfig(
        micro_batches=MICRO, remat=True, shard_axes=axes))


def run_case(name, mesh, rank, weights_dir, out):
    cfg, model = load_model(name, weights_dir)
    rules = ShardingRules(mesh, cfg, fsdp=True)
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "sp": True,
            "ctx": rank}
    local = partition.shard_model(model, rules, rank, requires_grad=True)
    opt = adamw_init(trainable_params(local), AdamWConfig(**OCFG))
    glob = batch(name)
    mine = partition.shard_batch(glob, rules, rank, B)
    local, opt, stats = step_of(cfg, axes)(local, opt, mine)
    specs = partition.param_specs(local)
    T_all = cfg.n_prefix_embeds + CASES[name][2]
    out[f"{name}/layout"] = np.array([
        "covered" if cfg.n_kv_heads % rank.model_n else "heads",
        "sp" if lm.seq_parallel(T_all, axes) else "replicated",
        "vocab split" if vocab_axis(local.embed) else "whole vocab",
        "fsdp" if any("data" in s for s in specs.values()) else "no fsdp"])
    out[f"{name}/rows"] = np.array(mine["tokens"].shape[0])
    out[f"{name}/loss"] = np.array(float(stats["loss"]))
    out[f"{name}/grad_norm"] = np.array(float(stats["grad_norm"]))
    whole = lambda t, s: rank.gather(t.detach(), s, partition.AXES)  # noqa
    for n, p in local.named_parameters():
        out[f"{name}/param/{n}"] = whole(p, specs[n]).numpy()
        out[f"{name}/mu/{n}"] = whole(opt.mu[n], specs[n]).numpy()


def bit_identity(name, mesh, rank, weights_dir, out):
    """World size 1: two partitioned steps against two unpartitioned ones
    from the same weights, loss, ``grad_norm``, every parameter and both
    moments bit for bit."""
    cfg, model = load_model(name, weights_dir)
    rules = ShardingRules(mesh, cfg, fsdp=True)
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "sp": True,
            "ctx": rank}
    plain = copy.deepcopy(model)
    local = partition.shard_model(model, rules, rank, requires_grad=True)
    ocfg = AdamWConfig(**OCFG)
    o0 = adamw_init(trainable_params(plain), ocfg)
    o1 = adamw_init(trainable_params(local), ocfg)
    s0, s1 = step_of(cfg, None), step_of(cfg, axes)
    same = []
    for _ in range(2):
        plain, o0, a = s0(plain, o0, batch(name))
        local, o1, b = s1(local, o1, batch(name))
        same += [torch.equal(a[k], b[k]) for k in ("loss", "grad_norm")]
    p0, p1 = dict(plain.named_parameters()), dict(local.named_parameters())
    same += [torch.equal(p0[n], p1[n]) for n in p0]
    same += [torch.equal(x[n], y[n]) for x, y in ((o0.mu, o1.mu),
                                                  (o0.nu, o1.nu)) for n in x]
    out[f"{name}/bit_identical"] = np.array(same)


def collective_grads(rank, out):
    """Each collective as the layers use it, under one loss replicated
    over ``model``: the rank's gradient against autograd of the unsharded
    function on the same seeded inputs, relative distance saved by
    name."""
    n, r = rank.model_n, rank.coords["model"]
    rng = np.random.default_rng(SEED)
    X = torch.from_numpy(rng.standard_normal((n, 3, 4 * n)))
    W = torch.from_numpy(rng.standard_normal((n, 3, 4 * n)))
    x1 = torch.from_numpy(rng.standard_normal((3, 4 * n)))

    def grad(f, x):
        x = x.clone().requires_grad_()
        f(x).backward()
        return x.grad

    def shard(t):
        return t.chunk(n, -1)[r]

    def ar(t):
        return rank.all_reduce(t, "model")

    # the unsharded functions: the ranks' partial sums times W[0], and a
    # replicated x into every rank's own work (x * W[r]) summed
    of_sum = grad(lambda X: (X.sum(0) * W[0]).sum(), X)
    of_all = grad(lambda x: (x * W).sum(), x1)
    cases = {
        # partial sums -> their sum used alike on every rank
        "all_reduce": (grad(lambda x: (ar(x) * W[0]).sum(), X[r]),
                       of_sum[r]),
        # a replicated stream into each rank's own work
        "enter": (grad(lambda x: ar((rank.enter(x) * W[r]).sum()), x1),
                  of_all),
        # shards -> the whole, into each rank's own work
        "all_gather": (grad(lambda x: ar(
            (rank.all_gather(x, -1, "model") * W[r]).sum()), shard(x1)),
            shard(of_all)),
        # partial sums -> the rank's shard of the sum
        "reduce_scatter": (grad(lambda x: ar(
            (rank.reduce_scatter(x, -1, "model") * shard(W[0])).sum()),
            X[r]), of_sum[r]),
        # a replicated stream -> the rank's shard, into its own work
        "split": (grad(lambda x: ar(
            (rank.split(x, -1, "model") * shard(W[0])).sum()), x1),
            grad(lambda x: (x * W[0]).sum(), x1)),
    }
    for k, (got, want) in cases.items():
        out[f"collective/{k}"] = np.array(float(
            (got - want).norm() / want.norm()))


def main(rank: int, world: int, shape: str, store_file: str,
         weights_dir: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dims = tuple(int(x) for x in shape.split(","))
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mesh = Mesh(np.full(dims, "cpu", dtype=object), ("pod", "data", "model"))
    ctx = rank_context(mesh, device="cpu")
    out = {"coords": np.array([ctx.coords[a] for a in partition.AXES])}
    for name in CASES:
        if world == 1:
            bit_identity(name, mesh, ctx, weights_dir, out)
        elif name in MESH_CASES:
            run_case(name, mesh, ctx, weights_dir, out)
    if world > 1:
        collective_grads(ctx, out)
    dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5], sys.argv[6])
