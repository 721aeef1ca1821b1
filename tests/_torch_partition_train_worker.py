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
        WEIGHTS_DIR OUT_NPZ [SUITE]

``SUITE`` picks the cases: ``dense`` (the default, ``CASES``), ``moe``
(``MOE_CASES``; at world size 4 also each micro-batch's rows,
``micro_rows``, and the MoE layer's gradients, ``router_grads``, in
place of ``collective_grads``) or ``rnn`` (``RNN_CASES``; on mesh (1, 1,
4) also the controls of ``CONTROLS``, each a rank that drops one
collective, in place of ``collective_grads``).
"""
import copy
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import Mesh, rank_context
from repro_torch.layers import rwkv6 as rwkv
from repro_torch.layers.core import vocab_axis
from repro_torch.layers.moe import moe_apply
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
# the MoE, MLA and hybrid families (``test_torch_partition_train_moe.py``,
# the worker's suite ``moe``), every case at world sizes 4 and 1: dbrx
# (its attention on the head route over model 2, the covered one over
# model 4; 2 experts a rank, then 1) at 24 tokens, split along T on both
# meshes; deepseek (MLA with a shared expert) at 18 and jamba (one
# period: Mamba, attention at index 4, the MoE on odd layers) at 22, split
# along T over model 2 and replicated over model 4; and dbrx at the
# production capacity factor 1.25, whose experts drop assignments
MOE_CASES = {
    "dbrx": ("dbrx-132b", {}, T),
    "deepseek": ("deepseek-v2-lite-16b", {}, 18),
    "jamba": ("jamba-v0.1-52b", {}, 22),
    "dbrx_c125": ("dbrx-132b", {"capacity_factor": 1.25}, T),
}
# RWKV-6 and the encoder-decoder (``test_torch_partition_train_rnn.py``,
# the worker's suite ``rnn``), every case at world sizes 4 and 1: rwkv6 at
# d_model 96 (3 heads of 32: model 2 and 4 split each head's 32 key rows,
# K 16 and K 8, through the key-slice WKV and its backward) at 24 tokens,
# the stream split along T on both meshes; whisper with 3 heads (dividing
# neither 2 nor 4: the covered route) over 33 encoder frames, its stream
# replicated as the reference leaves it
RNN_CASES = {
    "rwkv6": ("rwkv6-3b", {"d_model": 96}, T),
    "whisper": ("whisper-tiny", {"n_heads": 3, "n_kv_heads": 3,
                                 "encoder_seq_len": 33}, T),
}
SUITES = {"dense": (CASES, MESH_CASES), "moe": (MOE_CASES, tuple(MOE_CASES)),
          "rnn": (RNN_CASES, tuple(RNN_CASES))}
ALL_CASES = {**CASES, **MOE_CASES, **RNN_CASES}
SEED = 36


def case_config(name: str, get=get_config, smoke=smoke_config):
    """A case's smoke config (``get`` / ``smoke``: a package's
    ``get_config`` and ``smoke_config``, the port's by default); a
    ``capacity_factor`` override replaces the MoE's."""
    arch, over, _ = ALL_CASES[name]
    over = dict(over)
    cfg = smoke(get(arch))
    if "capacity_factor" in over:
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=over.pop("capacity_factor"))
    if "encoder_seq_len" in over:
        over["encdec"] = dataclasses.replace(
            cfg.encdec, encoder_seq_len=over.pop("encoder_seq_len"))
    return cfg.replace(**over)


def batch(name: str) -> dict:
    """The global batch of a case from one seed: tokens, a VLM's prefix
    rows and an encoder-decoder's frame embeddings."""
    cfg = case_config(name)
    rng = np.random.default_rng(SEED + list(ALL_CASES).index(name))
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, ALL_CASES[name][2])).astype(np.int32))}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = torch.from_numpy((rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.encdec is not None:
        out["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32))
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


def run_case(name, mesh, rank, weights_dir, out, key=None):
    """One partitioned step of case ``name``, saved under ``key`` (the
    name by default)."""
    key = key or name
    cfg, model = load_model(name, weights_dir)
    rules = ShardingRules(mesh, cfg, fsdp=True)
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "sp": True,
            "ctx": rank}
    local = partition.shard_model(model, rules, rank, requires_grad=True)
    opt = adamw_init(trainable_params(local), AdamWConfig(**OCFG))
    glob = batch(name)
    mine = partition.shard_batch(glob, rules, rank, B, MICRO)
    local, opt, stats = step_of(cfg, axes)(local, opt, mine)
    specs = partition.param_specs(local)
    T_all = cfg.n_prefix_embeds + ALL_CASES[name][2]
    out[f"{key}/layout"] = np.array([
        "covered" if cfg.n_kv_heads % rank.model_n else "heads",
        "sp" if cfg.encdec is None and lm.seq_parallel(T_all, axes)
        else "replicated",
        "vocab split" if vocab_axis(local.embed) else "whole vocab",
        "fsdp" if any("data" in s for s in specs.values()) else "no fsdp"])
    if cfg.encdec is None and lm.mixer_kind(cfg, 0) == "rwkv":
        # the key rows of each head's wkv state the rank holds
        state, _ = partition.shard_state(
            rwkv.init_rwkv_state(cfg, 1), rules, rank)
        out[f"{key}/wkv_keys"] = np.array(state.wkv.shape[2])
    out[f"{key}/rows"] = np.array(mine["tokens"].shape[0])
    out[f"{key}/loss"] = np.array(float(stats["loss"]))
    out[f"{key}/grad_norm"] = np.array(float(stats["grad_norm"]))
    whole = lambda t, s: rank.gather(t.detach(), s, partition.AXES)  # noqa
    for n, p in local.named_parameters():
        out[f"{key}/param/{n}"] = whole(p, specs[n]).numpy()
        out[f"{key}/mu/{n}"] = whole(opt.mu[n], specs[n]).numpy()


def _own_cross_kv(p, cfg, enc_out, rank):
    """``encdec._cross_kv_sharded`` without its all-gather: the rank's
    own columns of the cross K/V, zeros elsewhere."""
    from torch.nn import functional as F
    from repro_torch.layers.core import linear_cols
    B, Te, _ = enc_out.shape
    width = cfg.n_kv_heads * cfg.resolved_head_dim
    outs = []
    for lin in (p.wk, p.wv):
        y, lo, hi = linear_cols(lin, enc_out, rank)
        outs.append(F.pad(y, (lo, width - hi)).reshape(
            B, Te, cfg.n_kv_heads, cfg.resolved_head_dim))
    return tuple(outs)


# name -> (case, module, attribute, stand-in): a rank that drops one
# collective, which the test must see fail against the reference: RWKV-6
# without the all-reduce of y's share over the key slices, and an encoder
# rank without its cross-K/V gather
CONTROLS = {
    "rwkv6_no_y_all_reduce": ("rwkv6", "repro_torch.layers.rwkv6", "splits",
                              lambda spec, axis="model": False),
    "whisper_no_cross_kv_gather": ("whisper", "repro_torch.models.encdec",
                                   "_cross_kv_sharded", _own_cross_kv),
}


def run_controls(mesh, rank, weights_dir, out):
    import importlib
    for key, (name, module, attr, stand_in) in CONTROLS.items():
        mod = importlib.import_module(module)
        kept = getattr(mod, attr)
        setattr(mod, attr, stand_in)
        try:
            run_case(name, mesh, rank, weights_dir, out, key)
        finally:
            setattr(mod, attr, kept)


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


def micro_rows(mesh, rank, out):
    """The global rows of each of the rank's micro-batches, as the train
    step cuts them from ``shard_batch``'s rows (a batch of row ids)."""
    cfg = case_config("dbrx")
    rules = ShardingRules(mesh, cfg, fsdp=True)
    ids = torch.arange(B)[:, None].expand(B, 2).contiguous()
    mine = partition.shard_batch({"tokens": ids}, rules, rank, B, MICRO)
    out["rows"] = mine["tokens"][:, 0].reshape(MICRO, -1).numpy()


def router_grads(mesh, rank, weights_dir, out):
    """dbrx's first MoE layer alone, its stream split along T over
    ``model`` and replicated: each rank's loss is its outputs' product
    with a fixed tensor, summed over its positions and ``model``, plus
    half its aux loss; the data-parallel loss their mean over the dp
    ranks. The router's, the up stack's and the input's gradients on a
    rank (reduced over dp as the train step reduces them, gathered whole)
    against autograd of the unsharded layer on each dp rank's rows,
    relative distance saved by name."""
    cfg, model = load_model("dbrx", weights_dir)
    rules = ShardingRules(mesh, cfg, fsdp=True)
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "ctx": rank}
    n, m = rank.model_n, rank.coords["model"]
    dp_i, dp_n = rank.index(rules.dp)
    rng = np.random.default_rng(SEED)
    Bg, Tg = 2 * dp_n, 8 * n
    X = torch.from_numpy(rng.standard_normal((Bg, Tg, cfg.d_model)))
    G = torch.from_numpy(rng.standard_normal((Bg, Tg, cfg.d_model)))
    X, G = X.float(), G.float()
    ffn = model.blocks[0].ffn
    names = ("router.w", "up")
    whole = trainable_params(ffn)
    xw = X.clone().requires_grad_()
    loss = 0.0
    for r in range(dp_n):
        rows = slice(r * 2, (r + 1) * 2)
        y, aux = moe_apply(ffn, cfg, xw[rows], dropless=False)
        loss = loss + ((y * G[rows]).sum() + 0.5 * aux) / dp_n
    want = torch.autograd.grad(loss, [whole[k] for k in names] + [xw])
    local = partition.shard_model(model, rules, rank,
                                  requires_grad=True).blocks[0].ffn
    specs = {k: partition.pspec(local.get_submodule(k.rpartition(".")[0]),
                                k.rpartition(".")[2]) for k in names}
    rows = slice(dp_i * 2, (dp_i + 1) * 2)
    for sp in (True, False):
        pos = slice(m * 8, (m + 1) * 8) if sp else slice(None)
        x = X[rows, pos].clone().requires_grad_()
        y, aux = moe_apply(local, cfg, x, dropless=False, shard_axes=axes,
                           sp=sp)
        part = (y * G[rows, pos]).sum()
        if sp:
            part = rank.all_reduce(part, "model")
        params = dict(local.named_parameters())
        got = torch.autograd.grad(part + 0.5 * aux,
                                  [params[k] for k in names] + [x])
        grads = partition.reduce_gradients(dict(zip(names, got)), specs,
                                           rank, rules.dp)
        layout = "sp" if sp else "replicated"
        for k, w in zip(names, want):
            g = rank.gather(grads[k], specs[k], partition.AXES)
            out[f"router_grad/{layout}/{k}"] = np.array(float(
                (g - w).norm() / w.norm()))
        gx = got[-1] / dp_n
        out[f"router_grad/{layout}/x"] = np.array(float(
            (gx - want[-1][rows, pos]).norm() / want[-1][rows, pos].norm()))


def main(rank: int, world: int, shape: str, store_file: str,
         weights_dir: str, out_path: str, suite: str = "dense") -> None:
    torch.set_num_threads(1)
    cases, mesh_cases = SUITES[suite]
    dims = tuple(int(x) for x in shape.split(","))
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mesh = Mesh(np.full(dims, "cpu", dtype=object), ("pod", "data", "model"))
    ctx = rank_context(mesh, device="cpu")
    out = {"coords": np.array([ctx.coords[a] for a in partition.AXES])}
    for name in cases:
        if world == 1:
            bit_identity(name, mesh, ctx, weights_dir, out)
        elif name in mesh_cases:
            run_case(name, mesh, ctx, weights_dir, out)
    if world > 1 and suite == "dense":
        collective_grads(ctx, out)
    if world > 1 and suite == "moe":
        micro_rows(mesh, ctx, out)
        router_grads(mesh, ctx, weights_dir, out)
    if dims == (1, 1, 4) and suite == "rnn":
        run_controls(mesh, ctx, weights_dir, out)
    dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
