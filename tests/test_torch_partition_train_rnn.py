"""The partitioned train step of RWKV-6 and the encoder-decoder
(``TrainConfig.shard_axes``: ``rwkv_train_sharded`` over a key slice of
each head's state through the key-slice WKV's backward, and
``encdec.forward`` on a rank's shards) against the reference's
``make_train_step(..., TrainConfig(shard_axes=...))`` jitted on a mesh of
the same shape over the four forced host devices.

Spawned gloo workers (``tests/_torch_partition_train_worker.py``, suite
``rnn``, no jax) on meshes (1, 2, 2) and (1, 1, 4) at world size 4 and
(1, 1, 1) at world size 1, spawned once and together, from weights drawn
in the reference's parameter tree and carried over with ``from_jax``:
smoke float32 rwkv6 at d_model 96 (3 heads of 32 key rows: a rank holds
16 of each head's rows over model 2, 8 over model 4; the stream split
along T) and whisper with 3 heads over 33 encoder frames (the covered
route; the stream replicated), under FSDP, two micro-batches, remat and
one AdamW step that clips: the loss, ``grad_norm`` and every parameter
and first moment after the step within 1e-5 relative. RWKV-6's
gradients at random init are ill-conditioned (float32 roundings of the
shares of y, summed over the key slices, grow through the head norm,
most in ``tm.u``'s gradient): rwkv6's ``grad_norm`` and first moments
are held to twice the reference's own spread on the same inputs and
mesh, the largest distance between two reference steps, one through its
scan WKV (which its dispatch takes at 24 tokens) and one through its
chunked WKV (``_spread``). Measured here: the spread of the moments
1.5e-4 / 2.2e-4 (model 2 / 4) and the port's 2.5e-4 / 2.8e-4, both
``tm.u``'s; of ``grad_norm`` 7.6e-5 / 1.1e-4; every rwkv6 parameter
within 8e-7. At world size 1 two partitioned steps equal two
unpartitioned ones bit for bit. Two controls on mesh (1, 1, 4) fail: a
rank that skips the all-reduce of its share of RWKV-6's y, and an
encoder-decoder rank that drops its cross-K/V all-gather."""
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
from repro.layers import rwkv6 as jrwkv
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
CASES = tuple(worker.RNN_CASES)
SP = {"rwkv6": "sp", "whisper": "replicated"}
# the key rows of each 32-row head a rank holds over model 2 and model 4
WKV_KEYS = {(1, 2, 2): 16, (1, 1, 4): 8}


def _jcfg(name):
    return worker.case_config(name, j_get_config, j_smoke_config)


def _weights(cfg, seed: int):
    """The reference's parameter tree drawn from numpy: 0.05 x normal,
    without compiling its initialiser."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s.shape) * 0.05, s.dtype),
        japi.param_specs(cfg))


def _reference_step(name, dims, params):
    """The reference's sharded train step, jitted as its dry run jits it,
    on the four forced host devices -> (params, opt state, stats)."""
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


def _chunked_step(dims, params):
    """The reference's rwkv6 step with its WKV through ``wkv6_chunked`` in
    place of the scan its dispatch takes at 24 tokens."""
    scan = jrwkv.wkv6_ref
    chunked = jrwkv.wkv6_chunked
    jrwkv.wkv6_ref = lambda r, k, v, w, u, s: chunked(r, k, v, w, u, s,
                                                      chunk=r.shape[1])
    try:
        return _reference_step("rwkv6", dims, params)
    finally:
        jrwkv.wkv6_ref = scan


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_leaf(tree, name: str):
    """The reference leaf of a port parameter: a ``blocks`` /
    ``enc_blocks`` / ``dec_blocks`` leaf ``<stack>.<l>.<path>`` is row
    l // group_size of ``<stack>.sub<l % group_size>.<path>`` (an
    encoder-decoder's stacks hold one layer a group, unnamed)."""
    parts = name.split(".")
    if parts[0] not in ("blocks", "enc_blocks", "dec_blocks"):
        node = tree
        for p in parts:
            node = node[p]
        return np.asarray(node)
    stack = tree[parts[0]]
    layer = int(parts[1])
    if "sub0" in stack:
        gs = len(stack)
        node = stack[f"sub{layer % gs}"]
        layer //= gs
    else:
        node = stack
    for p in parts[2:]:
        node = node[p]
    return np.asarray(node)[layer]


def _spread(a, b, names) -> dict:
    """{"param/<name>" / "mu/<name>": the distance of each parameter and
    first moment (port names ``names``) between two reference steps'
    (params, opt state, stats)}."""
    out = {f"{kind}/{n}": _rel(_jax_leaf(x, n), _jax_leaf(y, n))
           for n in names
           for kind, (x, y) in (("param", (a[0], b[0])),
                                ("mu", (a[1].mu, b[1].mu)))}
    out["grad_norm"] = _rel(b[2]["grad_norm"], a[2]["grad_norm"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights written for the workers, each mesh's ranks
    spawned at once, the reference's steps taken meanwhile (and rwkv6's
    through the chunked WKV); ``runs(dims)`` -> (each rank's saved arrays,
    {case: the reference's (params, opt state, stats)}, rwkv6's spread)."""
    base = tmp_path_factory.mktemp("partition_train_rnn")
    weights = base / "weights"
    weights.mkdir()
    params, names = {}, {}
    for name in CASES:
        params[name] = _weights(_jcfg(name), list(worker.ALL_CASES).index(
            name))
        model = from_jax(jax.tree.map(np.asarray, params[name]),
                         worker.case_config(name), device="cpu")
        names[name] = [n for n, _ in model.named_parameters()]
        np.savez(weights / f"{name}.npz", **{
            n: p.detach().numpy() for n, p in model.named_parameters()})
    started = {dims: spawn.start(Path(worker.__file__), dims,
                                base / "x".join(map(str, dims)),
                                middle=(weights,), tail=("rnn",))
               for dims in MESHES + ((1, 1, 1),)}
    refs = {dims: {name: _reference_step(name, dims, params[name])
                   for name in CASES} for dims in MESHES}
    spreads = {dims: _spread(refs[dims]["rwkv6"],
                             _chunked_step(dims, params["rwkv6"]),
                             names["rwkv6"]) for dims in MESHES}

    def get(dims):
        return started[dims].outputs(), refs.get(dims), spreads.get(dims)
    try:
        yield get
    finally:
        for group in started.values():
            group.close()


def _limit(case, spread, key) -> float:
    """1e-5, or for rwkv6 at least twice the reference's own spread: the
    largest distance its scan and chunked steps put between any two
    parameters (or first moments, or grad norms)."""
    if case != "rwkv6":
        return TOL
    kind = key.split("/")[0]
    return max(TOL, 2 * max(d for k, d in spread.items()
                            if k.split("/")[0] == kind))


def _distances(out, key, params, opt):
    names = [k.split("/", 2)[2] for k in out if k.startswith(f"{key}/param/")]
    return {f"{kind}/{n}": _rel(out[f"{key}/{kind}/{n}"],
                                _jax_leaf(tree, n))
            for n in names
            for kind, tree in (("param", params), ("mu", opt.mu))}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_partitioned_train_step_matches_reference(runs, dims, case):
    ranks, refs, spread = runs(dims)
    params, opt, stats = refs[case]
    gnorm = float(stats["grad_norm"])
    assert gnorm > worker.OCFG["grad_clip"]          # the step clips
    loss = float(stats["loss"])
    for r, out in enumerate(ranks):
        assert [int(c) for c in out["coords"]] == list(
            np.unravel_index(r, dims))
        assert list(out[f"{case}/layout"])[1] == SP[case]
        assert int(out[f"{case}/rows"]) == worker.B // dims[1]
        got = float(out[f"{case}/loss"]), float(out[f"{case}/grad_norm"])
        assert abs(got[0] - loss) <= TOL * abs(loss), (got[0], loss)
        assert abs(got[1] - gnorm) <= _limit(case, spread, "grad_norm") \
            * gnorm, (got[1], gnorm, spread and spread["grad_norm"])
        if case == "rwkv6":
            assert int(out["rwkv6/wkv_keys"]) == WKV_KEYS[dims]
    dist = _distances(ranks[-1], case, params, opt)
    assert any(".cross." in k or ".tm.u" in k for k in dist)
    for k, d in dist.items():
        assert d <= _limit(case, spread, k), (k, d, _limit(case, spread, k))


@pytest.mark.parametrize("case", CASES)
def test_world_size_one_is_bit_identical(runs, case):
    out = runs((1, 1, 1))[0][0]
    assert out[f"{case}/bit_identical"].all(), out[f"{case}/bit_identical"]


@pytest.mark.parametrize("control", list(worker.CONTROLS))
def test_a_rank_that_drops_a_collective_fails(runs, control):
    """A rank that skips the all-reduce of its share of RWKV-6's y, and an
    encoder-decoder rank that drops its cross-K/V all-gather, each leave
    the reference's step beyond the limits the partitioned step holds."""
    ranks, refs, spread = runs((1, 1, 4))
    case = worker.CONTROLS[control][0]
    params, opt, stats = refs[case]
    out = ranks[0]
    loss = float(stats["loss"])
    assert abs(float(out[f"{control}/loss"]) - loss) > 10 * TOL * abs(loss)
    dist = _distances(out, control, params, opt)
    assert max(d / _limit(case, spread, k) for k, d in dist.items()) > 10
