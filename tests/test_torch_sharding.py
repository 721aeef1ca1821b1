"""The port's sharding rules (``repro_torch/distributed/sharding.py``) and
debug mesh (``repro_torch/launch/mesh.py``) against the reference's.

For every registered config at full width — the reference's parameter
shapes from ``api.param_specs`` (an ``eval_shape``), the port's modules
built on the ``meta`` device — under the meshes (1,1,1), (1,2,2), (1,4,1)
and (1,1,4) with ``fsdp`` on and off: every port parameter's spec equals
its reference leaf's, less the group entry of a ``blocks`` /
``enc_blocks`` / ``dec_blocks`` leaf (the port unstacks that axis). The
same for the dense decode cache (whose stacked layout the port keeps), for
the optimizer state, and for batch leaves. The reference's meshes span
the first devices of the four forced host devices; the port's are
four-entry CPU meshes."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import list_archs
from repro.distributed.sharding import ShardingRules as JRules
from repro.launch.mesh import make_debug_mesh as j_debug_mesh
from repro.models import api as japi
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as j_adamw_init
from repro_torch.configs import ENCDEC, get_config
from repro_torch.distributed.sharding import P, PartitionSpec, ShardingRules
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api, lm
from repro_torch.training.optimizer import AdamWConfig, adamw_init

ARCHS = list_archs()
SHAPES = ((1, 1, 1), (1, 2, 2), (1, 4, 1), (1, 1, 4))
AXES = ("pod", "data", "model")
BATCH, SEQ = 8, 256


def _meshes():
    for shape in SHAPES:
        n = int(np.prod(shape))
        jm = jax.make_mesh(shape, AXES, devices=jax.devices()[:n])
        tm = tmesh.Mesh(np.array(["cpu"] * n, dtype=object).reshape(shape),
                        AXES)
        yield shape, jm, tm


def _keystr(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                    for k in path)


def _ref_specs(tree_specs):
    """{path: spec tuple} of a tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree_specs, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    return {_keystr(p): tuple(s.spec) for p, s in flat}


def _ref_path(cfg, name: str):
    """The reference leaf of a port parameter, and whether its spec carries
    a group entry: ``blocks.{l}.rest`` is ``blocks/sub{l % gs}/rest``;
    ``enc_blocks.{e}.rest`` is ``enc_blocks/rest`` (and ``dec_blocks``)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        gs = lm.group_size(cfg)
        return "/".join(["blocks", f"sub{int(parts[1]) % gs}"]
                        + parts[2:]), True
    if parts[0] in ("enc_blocks", "dec_blocks"):
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def _port_model(cfg):
    module = api.model_module(cfg)
    cls = module.EncDec if cfg.family == ENCDEC else module.LM
    return cls(cfg, torch.device("meta"))


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (port config, reference param shapes, port meta model)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = j_get_config(arch)
            cache[arch] = (get_config(arch), jcfg, japi.param_specs(jcfg),
                           _port_model(get_config(arch)))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, shapes):
    cfg, jcfg, jshapes, model = shapes(arch)
    named = dict(model.named_parameters())
    jflat = {_keystr(p): l for p, l in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert sum(t.numel() for t in named.values()) == sum(
        int(np.prod(l.shape)) for l in jflat.values())
    for shape, jm, tm in _meshes():
        for fsdp in (True, False):
            want = _ref_specs(JRules(jm, jcfg, fsdp=fsdp).params(jshapes))
            got = ShardingRules(tm, cfg, fsdp=fsdp).params(model)
            assert set(got) == set(named)
            for name, spec in got.items():
                path, grouped = _ref_path(cfg, name)
                ref = want[path][1:] if grouped else want[path]
                assert isinstance(spec, PartitionSpec)
                assert len(spec) == len(named[name].shape), name
                assert tuple(spec) == ref, (shape, fsdp, name, spec, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, shapes):
    """The dense decode cache keeps the reference's stacked layout, so its
    specs equal the reference's as they are."""
    cfg, jcfg, _, _ = shapes(arch)
    jcache = jax.eval_shape(lambda: japi.init_decode_state(jcfg, BATCH, SEQ))
    cache = api.init_decode_state(cfg, BATCH, SEQ, device="meta")
    for shape, jm, tm in _meshes():
        rules = ShardingRules(tm, cfg)
        want = _ref_specs(JRules(jm, jcfg).cache(jcache, BATCH))
        got = {}
        tree = rules.cache(cache, BATCH)

        def walk(t, prefix):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, prefix + (k,))
            elif isinstance(t, PartitionSpec):
                got["/".join(prefix)] = tuple(t)
            else:
                for f, v in zip(t._fields, t):
                    walk(v, prefix + (f,))
        walk(tree, ())
        assert got == want, shape


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_reference(arch, shapes):
    """Moments and master mirror the parameter specs; the step is
    replicated."""
    cfg, jcfg, jshapes, model = shapes(arch)
    named = dict(model.named_parameters())
    tstate = adamw_init(named, AdamWConfig())
    jstate = jax.eval_shape(lambda p: j_adamw_init(p, JAdamWConfig()),
                            jshapes)
    assert (tstate.master is None) == (jstate.master is None)
    for shape, jm, tm in _meshes():
        want = JRules(jm, jcfg).opt_state(jstate, jshapes)
        got = ShardingRules(tm, cfg).opt_state(tstate, model)
        assert tuple(got.step) == tuple(want.step.spec) == ()
        for field in ("mu", "nu", "master"):
            g, w = getattr(got, field), getattr(want, field)
            if w is None:
                assert g is None
                continue
            w = _ref_specs(w)
            assert set(g) == set(named)
            for name, spec in g.items():
                path, grouped = _ref_path(cfg, name)
                ref = w[path][1:] if grouped else w[path]
                assert tuple(spec) == ref, (shape, field, name)


@pytest.mark.parametrize("leaf_shape", [(BATCH, 128), (BATCH,),
                                        (BATCH, 16, 64), (128, BATCH),
                                        (3, BATCH), (6, 128), ()])
def test_batch_specs_match_reference(leaf_shape):
    cfg = get_config("qwen1.5-0.5b")
    jcfg = j_get_config("qwen1.5-0.5b")
    leaf = jax.ShapeDtypeStruct(leaf_shape, np.int32)
    tleaf = torch.empty(leaf_shape, device="meta")
    for shape, jm, tm in _meshes():
        want = tuple(JRules(jm, jcfg).batch_spec(leaf, BATCH))
        assert tuple(ShardingRules(tm, cfg).batch_spec(tleaf, BATCH)) \
            == want, shape
        tree = ShardingRules(tm, cfg).batch({"tokens": tleaf, "x": [tleaf]},
                                            BATCH)
        assert tuple(tree["tokens"]) == tuple(tree["x"][0]) == want


def test_debug_mesh_matches_reference_axes():
    """``make_debug_mesh`` builds (1, n, 1) over (pod, data, model), as the
    reference's; ``dp_axes`` and ``model_axis`` read it alike."""
    from repro.launch.mesh import dp_axes as j_dp_axes
    jm = j_debug_mesh(4)
    tm = tmesh.make_debug_mesh(4, devices=["cpu"] * 4)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape == (1, 4, 1)
    assert dict(zip(tm.axis_names, tm.devices.shape)) == tm.shape
    assert tmesh.dp_axes(tm) == j_dp_axes(jm) == ("pod", "data")
    assert tmesh.model_axis(tm) == "model"
    assert all(d == torch.device("cpu") for d in tm.devices.flat)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="no device"):
            tmesh.make_debug_mesh(4)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_without_its_devices(multi_pod):
    need = 512 if multi_pod else 256
    if torch.cuda.device_count() >= need:
        pytest.skip("the production mesh's devices are present")
    with pytest.raises(ValueError, match=f"needs {need} devices; found "
                                         f"{torch.cuda.device_count()}"):
        tmesh.make_production_mesh(multi_pod=multi_pod)


def test_partition_spec_is_a_tuple_of_entries():
    spec = P(("pod", "data"), None, "model")
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model")
    assert P() == () and len(P(None)) == 1
    assert "PartitionSpec" in repr(spec)
