"""Dry run: every (architecture x shape x mesh) cell built without
allocating, with its memory per device, and on one H100 its traced cost
for the roofline pass — the counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh h100 \
        --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_torch

The reference lowers and compiles each cell for 256 / 512 placeholder host
devices and reads XLA's memory and cost analyses. The port has no compiler
and no SPMD partitioner. Its cells are built on the ``meta`` device
(``api.param_specs``, ``api.make_inputs``), and the meshes are placeholders
with ``meta`` entries (``launch/mesh.py:make_placeholder_mesh``):
``pod256`` (16, 16), ``pod512`` (2, 16, 16) and ``h100``, one card
(1, 1, 1). A cell's record holds the reference's keys:

* ``memory``, per device, under ``memory_analysis``'s five names:
  ``argument_size_in_bytes`` / ``output_size_in_bytes``: each leaf's
  bytes over the product of the mesh axes its ``ShardingRules`` spec
  names (outputs: the parameters and optimizer state a train step returns;
  a serving step's cache and its (B, V) logits, sharded as the batch);
  ``alias_size_in_bytes``: what the step updates in place, which the
  reference donates (parameters and optimizer state in training, the
  cache in serving); ``generated_code_size_in_bytes``: 0, since an eager
  step generates no code (the hand-written kernels are one library, built
  once for every cell); ``temp_size_in_bytes``: the meta trace's peak of
  live intermediate bytes (``h100`` only, else null).
* ``cost``: the meta trace's count (``analysis/roofline.py``), with
  ``flops``, ``bytes accessed`` and ``collective bytes``, and the trace
  written beside the record. On ``h100`` the step at the cell's global
  shapes. On the pods, for every serving cell, rank 0's partitioned step
  (``api.prefill`` / ``api.decode_step`` with ``shard_axes``) on its
  shards, traced under a fake process group of the mesh's size
  (``partition.fake_world``): the cost and ``temp_size_in_bytes`` a
  device, its collectives recorded as ``_c10d_functional`` ops. For every
  training cell, rank 0's partitioned train step (``make_train_step``
  with ``TrainConfig.shard_axes``: FSDP, the rank's rows of four
  micro-batches, remat, sequence parallelism where the family takes it),
  forward and backward; RWKV-6's through the key-slice WKV and its
  backward, each a trace entry with its cost.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.roofline import TraceRecorder
from repro_torch.configs import (ALL_SHAPES, SHAPES_BY_NAME, get_config,
                                 shape_applicable)
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import (PLACEHOLDER_MESHES,
                                    make_placeholder_mesh, rank_context)
from repro_torch.models import api
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import (TrainConfig, make_train_step,
                                             trainable_params)

ASSIGNED = [
    "internvl2-1b", "rwkv6-3b", "gemma-7b", "qwen1.5-0.5b", "minicpm-2b",
    "gemma3-12b", "deepseek-v2-lite-16b", "dbrx-132b", "whisper-tiny",
    "jamba-v0.1-52b",
]
MESHES = tuple(PLACEHOLDER_MESHES)
TRACED_MESH = "h100"
# the reference's dry run: grad accumulation over 4 micro-batches bounds
# activation memory
TRAIN_MICRO_BATCHES = 4

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun_torch")


def input_specs(arch: str, shape_name: str):
    """Meta-device stand-ins for every model input of the cell (no
    allocation)."""
    return api.make_inputs(get_config(arch), SHAPES_BY_NAME[shape_name])


def _per_device(tree, specs, sizes) -> int:
    """Bytes a device holds of ``tree`` (tensors in dicts, lists and
    tuples) under ``specs``, a tree of the same structure whose leaves are
    PartitionSpecs: each tensor's bytes over the product of the mesh axes
    its spec names."""
    if isinstance(tree, torch.Tensor):
        shards = 1
        for entry in specs:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    shards *= sizes[axis]
        return tree.numel() * tree.element_size() // shards
    if isinstance(tree, dict):
        return sum(_per_device(tree[k], specs[k], sizes) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_per_device(t, s, sizes) for t, s in zip(tree, specs))
    return 0


def _memory(arguments: int, outputs: int, aliased: int) -> dict:
    """``memory_analysis``'s five keys in its order; the temporaries come
    from the trace."""
    return {"argument_size_in_bytes": arguments,
            "output_size_in_bytes": outputs, "temp_size_in_bytes": None,
            "alias_size_in_bytes": aliased,
            "generated_code_size_in_bytes": 0}


def build_cell(arch: str, shape_name: str, mesh, *, fsdp=True, remat=True,
               overrides=None, batch_override: int = 0):
    """Returns (step, its arguments on the meta device, memory per device)
    for one cell; ``step(*arguments)`` runs it (on concrete arguments from
    ``api.instantiate`` too). On a mesh of more than one device the step is
    rank 0's partitioned step and its arguments rank 0's shards: the caller
    holds a process group of the mesh's size (``partition.fake_world``)."""
    cfg = get_config(arch)
    # Serving: FSDP would re-gather weights every decode step — keep them
    # TP-resident unless they don't fit (dbrx-132b: 264 GB bf16 / 16-way TP
    # = 16.5 GB needs FSDP); decided at the published depth, so that a
    # cell cut in depth keeps its layout
    shape = SHAPES_BY_NAME[shape_name]
    if shape.kind != "train" and cfg.param_count() * 2 / 16 <= 4e9:
        fsdp = False
    if overrides:
        cfg = cfg.replace(**overrides)
    rules = ShardingRules(mesh, cfg, fsdp=fsdp)
    sizes = mesh.shape
    model = api.param_specs(cfg)
    inputs = api.make_inputs(cfg, shape, batch_override)
    B = batch_override or shape.global_batch
    pspecs = rules.params(model)
    param_b = _per_device(dict(model.named_parameters()), pspecs, sizes)

    if shape.kind == "train":
        params = trainable_params(model)
        ocfg = AdamWConfig(lr=3e-4)
        opt = adamw_init(params, ocfg)
        state_b = param_b + _per_device(opt, rules.opt_state(opt, params),
                                        sizes)
        memory = _memory(state_b + _per_device(
            inputs, rules.batch(inputs, B), sizes), state_b, state_b)
        axes = None
        if mesh.devices.size > 1:
            rank = rank_context(mesh, device="meta")
            axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "sp": True,
                    "ctx": rank}
            model = partition.shard_model(model, rules, rank,
                                          requires_grad=True)
            opt = adamw_init(trainable_params(model), ocfg)
            inputs = partition.shard_batch(inputs, rules, rank, B,
                                           TRAIN_MICRO_BATCHES)
        step = make_train_step(cfg, ocfg, TrainConfig(
            micro_batches=TRAIN_MICRO_BATCHES, remat=remat,
            shard_axes=axes))
        return step, (model, opt, inputs), memory

    cache = inputs.pop("cache")
    cache_b = _per_device(cache, rules.cache(cache, B), sizes)
    rest_b = _per_device(inputs, rules.batch(inputs, B), sizes)
    logits = torch.empty((B, cfg.vocab_size), device="meta",
                         dtype=cfg.torch_compute_dtype())
    memory = _memory(param_b + cache_b + rest_b, cache_b + _per_device(
        logits, rules.batch_spec(logits, B), sizes), cache_b)
    axes = {}
    if mesh.devices.size > 1:
        rank = rank_context(mesh, device="meta")
        axes = {"shard_axes": {"dp": rules.dp, "tp": "model", "mesh": mesh,
                               "ctx": rank}}
        model = partition.shard_model(model, rules, rank)
        cache = partition.shard_cache(cache, rules, rank, B)
        inputs = partition.shard_batch(inputs, rules, rank, B)
    if shape.kind == "prefill":
        tokens = inputs.pop("tokens")

        def prefill_fn(model, tokens, cache, extras):
            return api.prefill(model, cfg, tokens, cache, **extras, **axes)
        return prefill_fn, (model, tokens, cache, inputs), memory

    def decode_fn(model, cache, tokens, pos):
        return api.decode_step(model, cfg, cache, tokens, pos, **axes)
    return decode_fn, (model, cache, inputs["tokens"], inputs["pos"]), memory


def trace_cell(fn, args):
    """Run ``fn(*args)`` on meta tensors under a ``TraceRecorder`` whose
    arguments are ``args``; returns the recorder."""
    recorder = TraceRecorder(arguments=args)
    with recorder:
        fn(*args)
    return recorder


def run_cell(arch: str, shape_name: str, *, mesh_name: str, out_dir: str,
             save_trace: bool = True, fsdp=True, remat=True, overrides=None,
             tag: str = "", batch_override: int = 0) -> dict:
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    mesh = make_placeholder_mesh(mesh_name)
    traced = mesh_name == TRACED_MESH or mesh.devices.size > 1
    world = partition.fake_world(mesh.devices.size) \
        if traced and mesh_name != TRACED_MESH else contextlib.nullcontext()
    t0 = time.monotonic()
    try:
        with world:
            fn, args, mem = build_cell(arch, shape_name, mesh, fsdp=fsdp,
                                       remat=remat, overrides=overrides,
                                       batch_override=batch_override)
            t_lower = time.monotonic() - t0
            cost, recorder = None, None
            if traced:
                recorder = trace_cell(fn, args)
                c = recorder.cost()
                cost = {"flops": c.flops, "bytes accessed": c.bytes,
                        "collective bytes": c.coll_bytes}
            del fn, args
        t_trace = time.monotonic() - t0 - t_lower
        if recorder is not None:
            mem["temp_size_in_bytes"] = recorder.peak_bytes
        rec.update(status="ok", lower_s=round(t_lower, 1),
                   compile_s=round(t_trace, 1), memory=mem, cost=cost)
        temp = mem["temp_size_in_bytes"]
        print(f"[dryrun] {mesh_name} {arch} {shape_name} {tag} OK "
              f"build={t_lower:.1f}s trace={t_trace:.1f}s "
              f"args/dev={mem['argument_size_in_bytes']/1e9:.2f}GB "
              + (f"temp/dev={temp/1e9:.2f}GB flops={cost['flops']:.3e}"
                 if cost else "cost=none"))
        if save_trace and recorder is not None:
            os.makedirs(out_dir, exist_ok=True)
            stem = f"{arch}_{shape_name}{('_' + tag) if tag else ''}"
            recorder.write(os.path.join(out_dir, stem + ".trace.jsonl.gz"))
    except (ValueError, TypeError, KeyError, RuntimeError, MemoryError,
            NotImplementedError) as e:
        # what building or tracing a cell raises; a blanket handler would
        # also swallow KeyboardInterrupt/SystemExit
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        print(f"[dryrun] {mesh_name} {arch} {shape_name} FAILED: {e}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="all", choices=[*MESHES, "all"])
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = MESHES if args.mesh == "all" else (args.mesh,)
    for mesh_name in meshes:
        out_dir = os.path.join(args.out, mesh_name)
        os.makedirs(out_dir, exist_ok=True)
        for arch in archs:
            for shape in shapes:
                rec_path = os.path.join(out_dir, f"{arch}_{shape}.json")
                if args.skip_existing and os.path.exists(rec_path):
                    continue
                rec = run_cell(arch, shape, mesh_name=mesh_name,
                               out_dir=out_dir, save_trace=not args.no_trace)
                with open(rec_path, "w") as f:
                    json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
