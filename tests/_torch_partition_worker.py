"""One rank of ``test_torch_partition.py``: joins a gloo group through a
``FileStore``, builds the rank's context on a (pod, data, model) mesh, and
for every case of ``CASES`` runs the partitioned ``api.prefill`` and eight
greedy ``api.decode_step``s on the rank's shards beside the port's
unpartitioned step on the same weights and the rank's rows (a
capacity-routed MoE's drops depend on the rows a call holds). Saves the
routes and specs it took, the largest relative logit and cache
differences, both token streams, the MoE's capacity drops, and (dbrx) one
expert-parallel ``moe_apply`` on seeded rows for the reference; then
gemma3's sequence route in bf16 (``bf16_sequence_route``). Imports only
torch, numpy and repro_torch.

    python tests/_torch_partition_worker.py RANK WORLD P,D,M STORE OUT_NPZ
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import Mesh, rank_context
from repro_torch.layers import mamba as mamba_mod
from repro_torch.layers import moe as moe_mod
from repro_torch.models import api, lm

B, T, S, STEPS = 4, 24, 32, 8
# name -> (arch, config overrides, fsdp): widths chosen so that the cases
# hit the head route (qwen), the sequence route with windowed rings
# (gemma3, one kv head), q heads that do not divide the model axis (minicpm
# 3 heads; internvl2 6 heads on 3 kv heads, whose covered heads straddle
# kv heads at model 4; a vocabulary of 513 that does not split), and
# dbrx's expert parallelism under FSDP with capacity drops; then the
# families whose caches the rules split as on pod256: deepseek's latent and
# roped-key columns, jamba's Mamba state by d_state (its 2 kv heads do not
# divide model 4: the sequence route) under FSDP, rwkv6's wkv state by key
# rows (3 heads of 32 divide neither 2 nor 4), whisper's 3 heads (the
# sequence route for the self cache; 33 encoder frames, so the cross
# cache is replicated)
CASES = {
    "qwen": ("qwen1.5-0.5b", {}, False),
    "gemma3": ("gemma3-12b", {"n_kv_heads": 1}, False),
    "minicpm": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3,
                               "vocab_size": 513}, False),
    "internvl2": ("internvl2-1b", {"n_heads": 6, "n_kv_heads": 3}, False),
    "dbrx": ("dbrx-132b", {"moe_capacity_factor": 0.5}, True),
    # 33 slots split neither 2 nor 4 ways: the global layers' caches stay
    # whole on every rank (the replicated route), the rings' 16 split
    "gemma3_whole": ("gemma3-12b", {"n_kv_heads": 1}, False),
    "deepseek": ("deepseek-v2-lite-16b", {}, False),
    "jamba": ("jamba-v0.1-52b", {}, True),
    "rwkv6": ("rwkv6-3b", {"d_model": 96}, False),
    "whisper": ("whisper-tiny", {"n_heads": 3, "n_kv_heads": 3,
                                 "encoder_seq_len": 33}, False),
}
SLOTS = {"gemma3_whole": 33}
SPEC_NAMES = ("embed.tok", "blocks.0.mix.wq.w", "blocks.0.mix.wk.w",
              "blocks.0.mix.wo.w", "blocks.0.ffn.up", "blocks.0.ffn.up.w",
              "blocks.0.ffn.router.w", "blocks.0.ffn.down")
# the weights whose splits the MLA, Mamba, RWKV-6 and cross-attention
# layers work around
FAMILY_SPEC_NAMES = ("blocks.0.mix.wdkv.w", "blocks.0.mix.wuk.w",
                     "blocks.0.mix.in_proj.w", "blocks.0.mix.A_log",
                     "blocks.0.mix.tm.u", "blocks.0.mix.tm.wr.w",
                     "blocks.0.mix.cm.wv.w", "dec_blocks.0.cross.wq.w",
                     "dec_blocks.0.cross.wo.w")
SEED = 34
# the dense-cache phases' per-token bound in bf16 (a row's logit distance
# over its norm), for gemma3's sequence route in bf16
BF16_TOL = 2e-2


def case_config(name: str):
    arch, over, _ = CASES[name]
    cfg = smoke_config(get_config(arch))
    over = dict(over)
    cf = over.pop("moe_capacity_factor", None)
    if cf is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cf)
    te = over.pop("encoder_seq_len", None)
    if te is not None:
        over["encdec"] = dataclasses.replace(cfg.encdec, encoder_seq_len=te)
    return cfg.replace(**over)


def inputs(cfg):
    """The global prompt and the prefill's other inputs of every case
    (a VLM's prefix rows, an encoder-decoder's frame embeddings), from one
    seed."""
    rng = np.random.default_rng(SEED)
    P = cfg.n_prefix_embeds
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T - P)))
    extra = {}
    if P:
        extra["prefix_embeds"] = torch.from_numpy(
            (rng.standard_normal((B, P, cfg.d_model)) * 0.02)
            .astype(np.float32))
    if cfg.encdec is not None:
        extra["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return tokens, extra


def moe_inputs(cfg):
    rng = np.random.default_rng(SEED + 1)
    return torch.from_numpy(rng.standard_normal(
        (B, T, cfg.d_model)).astype(np.float32))


def mamba_inputs(cfg):
    """Rows and a non-zero incoming state for jamba's Mamba layer."""
    rng = np.random.default_rng(SEED + 2)
    di, ds, dc, _ = mamba_mod._dims(cfg)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((B, T, cfg.d_model)),
        rng.standard_normal((B, di, ds)) * 0.5,
        rng.standard_normal((B, dc - 1, di))))


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _leaves(tree):
    return api.tree_leaves(tree)


class DropSpy:
    """Counts the assignments capacity dispatch drops (slot >= C)."""

    def __init__(self):
        self.dropped = 0
        self._orig = moe_mod.capacity_slots

    def __enter__(self):
        def spy(expert_idx, n_experts, C):
            pos, keep = self._orig(expert_idx, n_experts, C)
            self.dropped += int((~keep).sum())
            return pos, keep
        moe_mod.capacity_slots = spy
        return self

    def __exit__(self, *exc):
        moe_mod.capacity_slots = self._orig


def run_case(name, mesh, rank, out):
    cfg = case_config(name)
    fsdp = CASES[name][2]
    torch.manual_seed(0)
    model = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    rules = ShardingRules(mesh, cfg, fsdp=fsdp)
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "ctx": rank}
    tokens, extra = inputs(cfg)
    seq = SLOTS.get(name, S)
    cache = api.init_decode_state(cfg, B, seq, device="cpu")
    specs = rules.params(model)
    out[f"{name}/specs"] = np.array(
        [repr(specs[n]) if n in specs else "" for n in SPEC_NAMES])
    out[f"{name}/family_specs"] = np.array(
        [repr(specs[n]) for n in FAMILY_SPEC_NAMES if n in specs])
    out[f"{name}/routes"] = np.array(
        [partition.attn_route(rules.cache_spec("", c.k, B))
         for _, c in sorted(cache.items()) if hasattr(c, "k")])
    out[f"{name}/cache_specs"] = np.array(
        [repr(rules.cache_spec("", t, B)) for t in api.tree_leaves(cache)])

    # the unpartitioned step on the rank's rows (its dp shard's)
    tok_l = partition.shard_batch(tokens, rules, rank, B)
    extra_l = partition.shard_batch(extra, rules, rank, B)
    rows = tok_l.shape[0]
    ref_cache = api.init_decode_state(cfg, rows, seq, device="cpu")
    with DropSpy() as ref_spy:
        ref, ref_cache = api.prefill(model, cfg, tok_l, ref_cache, **extra_l)
    # the partitioned step on the rank's shards
    model_l = partition.shard_model(model, rules, rank)
    cache_l = partition.shard_cache(cache, rules, rank, B)
    with DropSpy() as spy:
        logits, cache_l = api.prefill(model_l, cfg, tok_l, cache_l,
                                      shard_axes=axes, **extra_l)
    out[f"{name}/drops"] = np.array([spy.dropped, ref_spy.dropped])
    errs = [rel(logits, ref)]
    # decode: both streams greedy from their own logits
    got_tok, want_tok = [logits.argmax(-1)], [ref.argmax(-1)]
    for step in range(STEPS):
        pos = torch.full((rows,), T + step)
        logits, cache_l = api.decode_step(model_l, cfg, cache_l, got_tok[-1],
                                          pos, shard_axes=axes)
        ref, ref_cache = api.decode_step(model, cfg, ref_cache, want_tok[-1],
                                         pos)
        errs.append(rel(logits, ref))
        got_tok.append(logits.argmax(-1))
        want_tok.append(ref.argmax(-1))
    out[f"{name}/logit_rel"] = np.array(errs)
    out[f"{name}/tokens"] = torch.stack(got_tok).numpy()
    out[f"{name}/ref_tokens"] = torch.stack(want_tok).numpy()
    # the cache: the rank's block of the unpartitioned cache of its rows
    # (whose batch, ``rows`` < B, the rules leave whole)
    want_l = partition.shard_cache(ref_cache, rules, rank, B)
    out[f"{name}/cache_rel"] = np.array(
        [rel(a, b) for a, b in zip(_leaves(cache_l), _leaves(want_l))])
    if name == "dbrx":
        x = partition.shard_batch(moe_inputs(cfg), rules, rank, B)
        with DropSpy() as spy:
            y, _ = moe_mod.moe_apply(model_l.blocks[0].ffn, cfg, x,
                                     dropless=False, shard_axes=axes)
        out["dbrx/moe_out"] = y.numpy()
        out["dbrx/moe_drops"] = np.array(spy.dropped)
        if rank.rank == 0:
            f = model.blocks[0].ffn
            for n in ("up", "gate", "down"):
                out[f"dbrx/w_{n}"] = getattr(f, n).numpy()
            out["dbrx/w_router"] = f.router.w.numpy()
    if name == "jamba":
        x, ssm, conv = mamba_inputs(cfg)
        state = partition.shard_cache(
            {"sub0": mamba_mod.MambaState(ssm[None], conv[None])}, rules,
            rank, B)["sub0"]
        y, _ = mamba_mod.mamba_sharded(
            model_l.blocks[0].mix, cfg, partition.shard_batch(x, rules, rank,
                                                              B),
            lm._at(state, 0), lm._view_specs(state), rank)
        out["jamba/mamba_out"] = y.numpy()
        if rank.rank == 0:
            for n, t in model.blocks[0].mix.named_parameters():
                out[f"jamba/w_{n}"] = t.numpy()


def row_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def bf16_sequence_route(mesh, rank, out):
    """gemma3's sequence route (ring slots, ``_partial_sdpa`` and the
    flash-decoding merge) in bf16 against the unpartitioned step in bf16 on
    the rank's rows, both fed the unpartitioned step's greedy tokens: each
    step's per-row logit distance, and a control whose ranks normalise
    their partial outputs over their own slots alone (no merge)."""
    from repro_torch.layers import attention as attn_mod
    cfg = case_config("gemma3").replace(compute_dtype="bfloat16")
    model = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    rules = ShardingRules(mesh, cfg)
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "ctx": rank}
    tokens, _ = inputs(cfg)
    tok_l = partition.shard_batch(tokens, rules, rank, B)
    rows = tok_l.shape[0]
    cache = lm.init_decode_state(cfg, rows, S, device="cpu")
    want, cache = api.prefill(model, cfg, tok_l, cache)
    wants, feed = [want], [want.argmax(-1)]
    for step in range(STEPS):
        want, cache = api.decode_step(model, cfg, cache, feed[-1],
                                      torch.full((rows,), T + step))
        wants.append(want)
        feed.append(want.argmax(-1))
    model_l = partition.shard_model(model, rules, rank)

    def errors():
        c = partition.shard_cache(lm.init_decode_state(cfg, B, S,
                                                       device="cpu"),
                                  rules, rank, B)
        got, c = api.prefill(model_l, cfg, tok_l, c, shard_axes=axes)
        errs = [row_rel(got, wants[0])]
        for step in range(STEPS):
            got, c = api.decode_step(model_l, cfg, c, feed[step],
                                     torch.full((rows,), T + step),
                                     shard_axes=axes)
            assert got.dtype == torch.bfloat16
            errs.append(row_rel(got, wants[step + 1]))
        return errs

    out["gemma3_bf16/routes"] = np.array(
        [partition.attn_route(rules.cache_spec("", c.k, B))
         for _, c in sorted(cache.items())])
    out["gemma3_bf16/row_rel"] = np.array(errors())
    merge = attn_mod._merge_partials
    attn_mod._merge_partials = lambda o, m, l, r, dt: (o / l[..., None]).to(dt)
    try:
        out["gemma3_bf16/control_row_rel"] = np.array(errors())
    finally:
        attn_mod._merge_partials = merge


def bit_identity(name, mesh, rank, out):
    """World size 1: the partitioned step is the unpartitioned one, bit for
    bit (every collective over a group of one is exact)."""
    cfg = case_config(name)
    model = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    rules = ShardingRules(mesh, cfg, fsdp=CASES[name][2])
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "ctx": rank}
    tokens, extra = inputs(cfg)
    seq = SLOTS.get(name, S)
    c0 = api.init_decode_state(cfg, B, seq, device="cpu")
    c1 = partition.shard_cache(api.init_decode_state(cfg, B, seq,
                                                     device="cpu"),
                               rules, rank, B)
    m1 = partition.shard_model(model, rules, rank)
    a, c0 = api.prefill(model, cfg, tokens, c0, **extra)
    b, c1 = api.prefill(m1, cfg, tokens, c1, shard_axes=axes, **extra)
    same = [torch.equal(a, b)]
    nxt = a.argmax(-1)
    for step in range(2):
        pos = torch.full((B,), T + step)
        a, c0 = api.decode_step(model, cfg, c0, nxt, pos)
        b, c1 = api.decode_step(m1, cfg, c1, nxt, pos, shard_axes=axes)
        same.append(torch.equal(a, b))
        nxt = a.argmax(-1)
    same += [torch.equal(x, y) for x, y in zip(_leaves(c0), _leaves(c1))]
    out[f"{name}/bit_identical"] = np.array(same)


def main(rank: int, world: int, shape: str, store_file: str,
         out_path: str) -> None:
    torch.set_num_threads(1)
    dims = tuple(int(x) for x in shape.split(","))
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mesh = Mesh(np.full(dims, "cpu", dtype=object), ("pod", "data", "model"))
    ctx = rank_context(mesh, device="cpu")
    out = {"coords": np.array([ctx.coords[a] for a in partition.AXES])}
    for name in CASES:
        if world == 1:
            bit_identity(name, mesh, ctx, out)
        else:
            run_case(name, mesh, ctx, out)
    if world > 1:
        bf16_sequence_route(mesh, ctx, out)
    dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
