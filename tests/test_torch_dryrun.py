"""The port's dry run (``repro_torch/launch/dryrun.py``), its production
shapes (``configs/base.py``), meta-device specs (``models/api.py``) and
placeholder meshes against the reference's.

Shapes: the four cells, ``SHAPES_BY_NAME``, ``LONG_CONTEXT_OK``,
``list_archs`` and ``shape_applicable`` equal the reference's. Specs: for
every ``ASSIGNED`` arch at full width, the port's meta model, decode state
and ``make_inputs`` (with and without ``batch_override``) have the
reference's ``jax.eval_shape`` shapes and dtypes, leaf by leaf (a port
layer's parameter is its group's row of the reference's stacked leaf, as
``params.from_jax`` maps it), and no storage. ``instantiate`` draws the
reference's values, at smoke configs. The dry run: records with the
reference's keys and a trace file, the reference's skip reason, and the
pods' bytes per device from the port's sharding specs. The reference's
``launch/dryrun.py`` is never imported: its import forces 512 host
devices on every later JAX test of the worker; its record keys are read
from its source."""
import ast
import dataclasses
import gzip
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.analysis.roofline import read_trace
from repro_torch.configs import (ALL_SHAPES, SHAPES_BY_NAME, ShapeConfig,
                                 get_config, smoke_config)
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.kernels import build
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_placeholder_mesh
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[1]
REF_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
ARCHS = dryrun.ASSIGNED
SHAPE_NAMES = [s.name for s in ALL_SHAPES]


def _jdtype(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def test_shapes_equal_reference():
    assert ALL_SHAPES == tuple(
        ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
        for s in jconfigs.ALL_SHAPES)
    assert list(SHAPES_BY_NAME) == list(jconfigs.SHAPES_BY_NAME)
    assert configs.LONG_CONTEXT_OK == jconfigs.base.LONG_CONTEXT_OK
    assert configs.list_archs() == jconfigs.list_archs()
    assert ARCHS == ["internvl2-1b", "rwkv6-3b", "gemma-7b", "qwen1.5-0.5b",
                     "minicpm-2b", "gemma3-12b", "deepseek-v2-lite-16b",
                     "dbrx-132b", "whisper-tiny", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", configs.list_archs())
def test_shape_applicable_equals_reference(arch):
    for shape in ALL_SHAPES:
        assert configs.shape_applicable(get_config(arch), shape) == \
            jconfigs.shape_applicable(jconfigs.get_config(arch),
                                      jconfigs.SHAPES_BY_NAME[shape.name])


def _ref_param_path(cfg, name: str):
    """The reference leaf of a port parameter, and whether the port holds
    one row of it (``api.reference_leaves``'s mapping)."""
    for path, names in api.reference_leaves(api.param_specs(cfg)).items():
        if name in names:
            return "/".join(path), path[0].endswith("blocks")
    raise KeyError(name)


def _keystr(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                    for k in path)


def _assert_tree_matches(tree, jtree):
    """Same leaves in the same flatten order, of the same shapes and
    dtypes, every port leaf on ``meta``."""
    leaves = api.tree_leaves(tree)
    jleaves = jax.tree.leaves(jtree)
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves):
        assert t.is_meta
        assert tuple(t.shape) == tuple(j.shape)
        assert _jdtype(t.dtype) == str(j.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    cfg = get_config(arch)
    model = api.param_specs(cfg)
    leaves = api.reference_leaves(model)
    named = dict(model.named_parameters())
    jflat = {_keystr(p): l for p, l in jax.tree_util.tree_flatten_with_path(
        japi.param_specs(jconfigs.get_config(arch)))[0]}
    assert {"/".join(p) for p in leaves} == set(jflat)
    for path, names in leaves.items():
        j = jflat["/".join(path)]
        stacked = path[0].endswith("blocks")
        assert j.shape[0] == len(names) if stacked else len(names) == 1
        for name in names:
            t = named[name]
            assert t.is_meta and not t.requires_grad
            assert tuple(t.shape) == (tuple(j.shape[1:]) if stacked
                                      else tuple(j.shape)), name
            assert _jdtype(t.dtype) == str(j.dtype), name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch_override", [0, 2])
def test_make_inputs_match_reference(arch, batch_override):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for name in SHAPE_NAMES:
        got = api.make_inputs(cfg, SHAPES_BY_NAME[name], batch_override)
        want = japi.make_inputs(jcfg, jconfigs.SHAPES_BY_NAME[name],
                                batch_override)
        assert sorted(got) == sorted(want)
        _assert_tree_matches(got, want)
        if "cache" in got:
            B = batch_override or SHAPES_BY_NAME[name].global_batch
            _assert_tree_matches(
                api.decode_state_specs(cfg, B, SHAPES_BY_NAME[name].seq_len),
                japi.decode_state_specs(jcfg, B,
                                        SHAPES_BY_NAME[name].seq_len))


SMALL = {"train": ShapeConfig("t", 24, 2, "train"),
         "prefill": ShapeConfig("p", 24, 2, "prefill"),
         "decode": ShapeConfig("d", 24, 3, "decode")}


@pytest.mark.parametrize("arch", ARCHS)
def test_instantiate_draws_the_reference_values(arch):
    """Smoke config: the model's parameters row for row against the
    reference's stacked leaves, and every input of the three kinds, equal
    to the reference's ``instantiate`` of the same seed."""
    cfg = smoke_config(get_config(arch))
    jcfg = jconfigs.smoke_config(jconfigs.get_config(arch))
    specs = api.param_specs(cfg)
    model = api.instantiate(specs, 3, "cpu")
    assert next(specs.parameters()).is_meta
    jparams = {_keystr(p): np.asarray(l.astype(np.float32)) for p, l in
               jax.tree_util.tree_flatten_with_path(
                   japi.instantiate(japi.param_specs(jcfg), 3))[0]}
    got = dict(model.named_parameters())
    for path, names in api.reference_leaves(model).items():
        j = jparams["/".join(path)]
        for g, name in enumerate(names):
            want = j[g] if path[0].endswith("blocks") else j
            np.testing.assert_array_equal(got[name].float().numpy(), want)
    for kind, shape in SMALL.items():
        ins = api.instantiate(api.make_inputs(cfg, shape), 5, "cpu")
        jins = japi.instantiate(japi.make_inputs(jcfg, shape), 5)
        for t, j in zip(api.tree_leaves(ins), jax.tree.leaves(jins)):
            assert t.device.type == "cpu" and _jdtype(t.dtype) == str(j.dtype)
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(j).astype(np.float32))


def test_placeholder_meshes():
    for name, shape, axes in (("pod256", (16, 16), ("data", "model")),
                              ("pod512", (2, 16, 16), ("pod", "data",
                                                       "model")),
                              ("h100", (1, 1, 1), ("pod", "data", "model"))):
        mesh = make_placeholder_mesh(name)
        assert mesh.shape == dict(zip(axes, shape))
        assert {d.type for d in mesh.devices.flat} == {"meta"}


def _reference_record_keys():
    """The keys of an ``ok`` record of the reference's ``run_cell``, and
    its memory keys, read from its source."""
    fn = next(n for n in ast.walk(ast.parse(REF_DRYRUN.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys, mem = [], []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", "") == "rec":
            keys += [k.value for k in node.value.keys]
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "update" and any(kw.arg == "status" and getattr(
                    kw.value, "value", "") == "ok" for kw in node.keywords):
            keys += [kw.arg for kw in node.keywords]
        if isinstance(node, ast.DictComp) and isinstance(
                node.generators[0].iter, ast.Tuple):
            mem = [e.value for e in node.generators[0].iter.elts]
    return keys, mem


def test_run_cell_decode_record_and_trace(tmp_path):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", mesh_name="h100",
                          out_dir=str(tmp_path))
    keys, mem = _reference_record_keys()
    assert rec["status"] == "ok", rec.get("error")
    assert list(rec) == keys
    assert list(rec["memory"]) == mem
    assert rec["memory"]["generated_code_size_in_bytes"] == 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    trace = tmp_path / "qwen1.5-0.5b_decode_32k.trace.jsonl.gz"
    records = read_trace(str(trace))
    assert records and all("n" in r for r in records)
    with gzip.open(trace, "rt") as f:
        assert json.loads(f.readline())["n"] >= 1
    cfg = get_config("qwen1.5-0.5b")
    cache = api.decode_state_specs(cfg, 128, 32768)
    cache_b = sum(t.numel() * t.element_size()
                  for t in api.tree_leaves(cache))
    assert rec["memory"]["alias_size_in_bytes"] == cache_b
    assert rec["memory"]["output_size_in_bytes"] == cache_b + 128 \
        * cfg.vocab_size * 2


def test_run_cell_smoke_train_and_main(tmp_path):
    arch = "qwen1.5-0.5b"
    full, smoke = get_config(arch), smoke_config(get_config(arch))
    overrides = {f: getattr(smoke, f) for f in full.__dataclass_fields__
                 if getattr(smoke, f) != getattr(full, f)}
    rec = dryrun.run_cell(arch, "train_4k", mesh_name="h100",
                          out_dir=str(tmp_path), overrides=overrides,
                          batch_override=8, tag="smoke")
    assert rec["status"] == "ok", rec.get("error")
    assert (tmp_path / f"{arch}_train_4k_smoke.trace.jsonl.gz").exists()
    model = api.param_specs(smoke)
    params_b = sum(p.numel() * p.element_size() for p in model.parameters())
    # params, and AdamW's two float32 moments (float32 params: no master)
    assert rec["memory"]["alias_size_in_bytes"] == 3 * params_b
    assert rec["memory"]["argument_size_in_bytes"] == 3 * params_b \
        + 8 * 4096 * 4
    dryrun.main(["--arch", arch, "--shape", "long_500k", "--mesh", "h100",
                 "--out", str(tmp_path / "out")])
    saved = json.loads((tmp_path / "out" / "h100"
                        / f"{arch}_long_500k.json").read_text())
    assert saved["status"] == "skipped"


def test_long_context_skip_reason_is_the_reference_s(tmp_path):
    rec = dryrun.run_cell("gemma-7b", "long_500k", mesh_name="pod256",
                          out_dir=str(tmp_path))
    ok, reason = jconfigs.shape_applicable(
        jconfigs.get_config("gemma-7b"), jconfigs.SHAPES_BY_NAME["long_500k"])
    assert not ok
    assert rec == {"arch": "gemma-7b", "shape": "long_500k",
                   "mesh": "pod256", "tag": "", "status": "skipped",
                   "reason": reason}


def _shards(spec, sizes) -> int:
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            n *= sizes[axis] if axis is not None else 1
    return n


@pytest.mark.parametrize("mesh_name", ["pod256", "pod512"])
def test_pod_bytes_per_device_follow_the_specs(mesh_name, tmp_path):
    """qwen1.5-0.5b decode_32k: serving keeps the weights TP-resident (no
    FSDP); each parameter, cache leaf and batch leaf is divided by the
    mesh axes its spec names. The pods carry rank 0's traced cost."""
    arch, shape = "qwen1.5-0.5b", SHAPES_BY_NAME["decode_32k"]
    cfg = get_config(arch)
    mesh = make_placeholder_mesh(mesh_name)
    rules = ShardingRules(mesh, cfg, fsdp=False)
    sizes = mesh.shape
    B = shape.global_batch
    want = 0
    for name, p in api.param_specs(cfg).named_parameters():
        want += p.numel() * p.element_size() // _shards(
            rules.param_spec(name, p), sizes)
    for cache_leaf in api.tree_leaves(api.decode_state_specs(
            cfg, B, shape.seq_len)):
        want += cache_leaf.numel() * cache_leaf.element_size() // _shards(
            rules.cache_spec("", cache_leaf, B), sizes)
    tok = torch.empty((B,), dtype=torch.int32, device="meta")
    want += 2 * B * 4 // _shards(rules.batch_spec(tok, B), sizes)
    rec = dryrun.run_cell(arch, "decode_32k", mesh_name=mesh_name,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_size_in_bytes"] == want
    # rank 0's partitioned step, traced: a cost and temporaries a device
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["collective bytes"] > 0
    assert "cost_reason" not in rec
    assert [p.name for p in tmp_path.iterdir()] == [
        "qwen1.5-0.5b_decode_32k.trace.jsonl.gz"]


# ---------------------------------------------------------------------------
# The pods' per-device cost: rank 0's partitioned step
# ---------------------------------------------------------------------------
IN_SCOPE = tuple(dryrun.ASSIGNED)


def _smoke_overrides(arch):
    full, smoke = get_config(arch), smoke_config(get_config(arch))
    return {f: getattr(smoke, f) for f in full.__dataclass_fields__
            if getattr(smoke, f) != getattr(full, f)}


@pytest.mark.parametrize("arch", IN_SCOPE)
def test_pod_serving_cells_carry_a_cost(arch, tmp_path):
    """Every serving cell of the ten archs on pod256 (at smoke widths, a
    small batch): a cost with collectives, the temporaries a device and
    the trace beside the record."""
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        rec = dryrun.run_cell(arch, shape, mesh_name="pod256",
                              out_dir=str(tmp_path), tag="smoke",
                              overrides=_smoke_overrides(arch),
                              batch_override=16)
        if rec["status"] == "skipped":
            assert shape == "long_500k" and arch not in (
                "gemma3-12b", "rwkv6-3b", "jamba-v0.1-52b")
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert rec["cost"]["flops"] > 0 and rec["cost"]["collective bytes"] > 0
        assert rec["memory"]["temp_size_in_bytes"] > 0
        assert (tmp_path / f"{arch}_{shape}_smoke.trace.jsonl.gz").exists()


@pytest.mark.parametrize("arch,shape", [("rwkv6-3b", "train_4k")])
def test_other_pod_cells_name_what_is_missing(arch, shape, tmp_path):
    """The last cell that named what it missed, rwkv6-3b's train_4k on
    pod512 (at smoke widths, 4 rows a dp rank), now traces rank 0's
    partitioned step: no ``cost_reason``, and its trace holds the key-slice
    WKV forward twice a layer and micro-batch (remat recomputes it) and its
    backward once, each with the key rows a rank holds (smoke head dim 32
    over model 16: 2)."""
    seen = []
    with partition.fake_world(512):
        fn, args, _ = dryrun.build_cell(
            arch, shape, make_placeholder_mesh("pod512"),
            overrides=_train_overrides(arch),
            batch_override=TRAIN_BATCH["pod512"])
        build.META_SINKS.append(seen.append)
        try:
            dryrun.trace_cell(fn, args)
        finally:
            build.META_SINKS.remove(seen.append)
    cfg = get_config(arch).replace(**_train_overrides(arch))
    n = cfg.n_layers * dryrun.TRAIN_MICRO_BATCHES
    kernels = [e["kernel"] for e in seen]
    assert kernels.count("wkv6_keyslice") == 2 * n
    assert kernels.count("wkv6_keyslice_bwd") == n
    assert "wkv6" not in kernels and "wkv6_bwd" not in kernels
    for e in seen:
        assert e["ins"][0][0][-1] == cfg.ssm.rwkv_head_dim // 16
        assert e["flops"] > 0 and e["bytes"] > 0
    rec = dryrun.run_cell(arch, shape, mesh_name="pod512",
                          out_dir=str(tmp_path), tag="smoke",
                          overrides=_train_overrides(arch),
                          batch_override=TRAIN_BATCH["pod512"])
    assert rec["status"] == "ok", rec.get("error")
    assert "cost_reason" not in rec and rec["cost"]["flops"] > 0


# the partitioned train step covers every family
TRAIN_ARCHS = tuple(dryrun.ASSIGNED)
# a small batch a pod's dp ranks split into 4 rows each
TRAIN_BATCH = {"pod256": 64, "pod512": 128}


def _train_overrides(arch):
    """``_smoke_overrides`` with a MoE's 16 experts: expert parallelism in
    training needs them split over the pods' model axis of 16, as the
    reference's ``moe_apply`` asserts."""
    over = _smoke_overrides(arch)
    if "moe" in over:
        over["moe"] = dataclasses.replace(over["moe"], n_experts=16)
    return over


def _train_state_bytes(cfg, mesh, B):
    """A device's bytes of the train cell's arguments per the specs: the
    parameters, AdamW's moments (and master, for bf16 parameters) and the
    batch, each divided by the mesh axes its spec names."""
    rules = ShardingRules(mesh, cfg, fsdp=True)
    sizes = mesh.shape
    want = 0
    for name, p in api.param_specs(cfg).named_parameters():
        n = _shards(rules.param_spec(name, p), sizes)
        state = 8 + (4 if p.dtype != torch.float32 else 0)
        want += (p.numel() * p.element_size() + p.numel() * state) // n
    for leaf in api.tree_leaves(api.make_inputs(
            cfg, SHAPES_BY_NAME["train_4k"], B)):
        want += leaf.numel() * leaf.element_size() // _shards(
            rules.batch_spec(leaf, B), sizes)
    return want


@pytest.mark.parametrize("mesh_name", ["pod256", "pod512"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_pod_train_cells_carry_a_cost(arch, mesh_name, tmp_path):
    """The train_4k cell of each arch whose family the partitioned train
    step covers, on the pods (smoke widths, 4 rows a dp rank, one of each
    of its 4 micro-batches): rank 0's partitioned train step traced, a
    cost with collectives, the temporaries a device, the trace beside the
    record, and the arguments a device as its specs divide them."""
    B = TRAIN_BATCH[mesh_name]
    rec = dryrun.run_cell(arch, "train_4k", mesh_name=mesh_name,
                          out_dir=str(tmp_path), tag="smoke",
                          overrides=_train_overrides(arch),
                          batch_override=B)
    assert rec["status"] == "ok", rec.get("error")
    assert "cost_reason" not in rec
    assert rec["cost"]["flops"] > 0 and rec["cost"]["collective bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert (tmp_path / f"{arch}_train_4k_smoke.trace.jsonl.gz").exists()
    cfg = get_config(arch).replace(**_train_overrides(arch))
    assert rec["memory"]["argument_size_in_bytes"] == _train_state_bytes(
        cfg, make_placeholder_mesh(mesh_name), B)


def _meta_mesh(dims):
    return Mesh(np.full(dims, "meta", dtype=object), ("pod", "data",
                                                      "model"))


def _rank0_trace(arch, shape, dims, B):
    """Rank 0's partitioned step of a smoke cell on a small placeholder
    mesh under a fake group: (recorder, arguments, memory, config)."""
    with partition.fake_world(int(np.prod(dims))):
        fn, args, mem = dryrun.build_cell(
            arch, shape, _meta_mesh(dims), overrides=_smoke_overrides(arch),
            batch_override=B)
        return dryrun.trace_cell(fn, args), args, mem


def _h100_trace(arch, shape, B):
    fn, args, _ = dryrun.build_cell(arch, shape, make_placeholder_mesh(
        "h100"), overrides=_smoke_overrides(arch), batch_override=B)
    return dryrun.trace_cell(fn, args)


@pytest.mark.parametrize("dims", [(1, 2, 2), (1, 1, 4)],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-12b"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_rank_flop_times_world_is_the_h100_flop(dims, arch, shape):
    """qwen (the head route) and gemma3 (the sequence route, one q head a
    rank; in training the covered route at model 4) split every product,
    the train step's backward and vocab-parallel loss included: a rank's
    FLOP times the world size is the one-device trace's, exactly. Its
    argument bytes are ``_per_device``'s memory record."""
    B = 8 if shape == "train_4k" else 4
    rec, args, mem = _rank0_trace(arch, shape, dims, B)
    world = int(np.prod(dims))
    assert rec.cost().flops * world == _h100_trace(arch, shape, B).cost().flops
    held = sum(t.numel() * t.element_size()
               for t in api.tree_leaves([list(args[0].parameters())]
                                        + list(args[1:]))
               if isinstance(t, torch.Tensor))      # AdamW's step is an int
    assert held == mem["argument_size_in_bytes"]


def _design_collectives(cfg, rules, kind: str, route: str) -> dict:
    """The collectives the design makes in one step: the embedding's
    all-reduce and the logits' all-gather (where the vocabulary splits);
    a layer's all-reduce after ``wo`` and after the feed-forward; on the
    sequence route the q/k/v all-gather and, in decode, the merge's;
    under FSDP an all-gather over data of each weight whose spec names it
    (the router's also over model) and of the embedding's."""
    model = api.param_specs(cfg)
    specs = rules.params(model)
    L = cfg.n_layers
    ar, ag = 2 * L, 0
    if specs["embed.tok"][0] == "model":
        ar, ag = ar + 1, ag + 1
    if route == "seq":
        ag += L * (2 if kind == "decode" else 1)
    ag += sum(("data" in s) + ("model" in s and n.endswith("router.w"))
              for n, s in specs.items())
    return {"all_reduce": ar, "all_gather_into_tensor": ag}


@pytest.mark.parametrize("arch,dims,route", [
    ("qwen1.5-0.5b", (1, 2, 2), "heads"), ("gemma3-12b", (1, 1, 4), "seq"),
    ("dbrx-132b", (1, 2, 2), "heads"), ("dbrx-132b", (1, 1, 4), "seq")])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_collectives_per_step_are_the_design_s(arch, dims, route, shape):
    cfg = get_config(arch).replace(**_smoke_overrides(arch))
    rec, args, _ = _rank0_trace(arch, shape, dims, 4)
    cache = args[2] if shape == "prefill_32k" else args[1]
    assert {partition.attn_route(c.k.pspec) for c in cache.values()} == {
        route}
    rules = ShardingRules(_meta_mesh(dims), cfg,
                          fsdp=arch == "dbrx-132b")
    assert rec.cost().coll_counts == _design_collectives(
        cfg, rules, shape.split("_")[0], route)
