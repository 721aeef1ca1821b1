"""The port's training path against the JAX reference, on the CPU.

The float32 ``smoke_config`` of qwen1.5-0.5b, weights from the reference's
``api.init_params(PRNGKey(0), cfg)`` carried over with ``from_jax`` (so
``from_jax`` serves training as it serves serving), batches from each
side's ``make_batch`` (bit-identical). Limits: the loss to 1e-5 relative;
every gradient to 1e-4 relative norm, through the flash op
(``impl="kernel"``, its plain versions here) and through the plain forward
under autograd (``impl="ref"``); one AdamW update's params and moments to
1e-6; five ``train`` steps' losses to 1e-4 relative; the schedules at ten
steps to 1e-6 relative. Within the port: micro-batches equal the full batch
and remat equals no remat (1e-5, float32 summation order), checkpoints
round-trip bit for bit, and a restart after an injected failure replays an
uninterrupted run's losses exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models import api as japi
from repro.models.losses import shifted_xent as j_xent
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import make_batch as j_make_batch
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import train as j_train
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.launch import train as t_launch
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models.losses import shifted_xent
from repro_torch.params import from_jax
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as topt
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.train_loop import (TrainConfig, make_train_step,
                                             train, trainable_params)

ARCH = "qwen1.5-0.5b"
DCFG = dict(seed=0, batch=2, seq_len=32)


@pytest.fixture(scope="module")
def ref():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    batch = j_make_batch(JDataConfig(**DCFG), cfg, 0)
    loss, grads = jax.value_and_grad(
        lambda p: japi.loss_fn(p, cfg, batch))(params)
    return dict(cfg=cfg, params=params, tcfg=tcfg, loss=float(loss),
                grads=grads, np_params=jax.tree.map(np.asarray, params))


def _model(ref):
    return from_jax(ref["np_params"], ref["tcfg"], device="cpu")


def _jax_leaf(tree, name):
    """The reference leaf of a port parameter name: ``blocks.<l>.<path>``
    is layer l of ``blocks.sub0.<path>``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]["sub0"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _grads(model, cfg, batch, **kw):
    params = trainable_params(model)
    loss = tapi.loss_fn(model, cfg, batch, **kw)
    return loss.detach(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 0, 1),
                                                 (3, 1, 2)])
def test_make_batch_bit_identical(ref, step, shard, n_shards):
    kw = dict(DCFG, batch=4, shard=shard, n_shards=n_shards)
    want = np.asarray(j_make_batch(JDataConfig(**kw), ref["cfg"], step)
                      ["tokens"])
    got = make_batch(DataConfig(**kw), ref["tcfg"], step)["tokens"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_shifted_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    tokens = rng.integers(0, 50, (2, 9)).astype(np.int32)
    want = float(j_xent(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(shifted_xent(torch.from_numpy(logits),
                             torch.from_numpy(tokens)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_loss_and_grads_match_reference(ref, impl):
    model = _model(ref)
    batch = make_batch(DataConfig(**DCFG), ref["tcfg"], 0)
    loss, grads = _grads(model, ref["tcfg"], batch, impl=impl)
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    n_block = len(jax.tree.leaves(ref["grads"]["blocks"]))
    assert len(grads) == (len(jax.tree.leaves(ref["grads"])) - n_block
                          + n_block * ref["cfg"].n_layers)
    for name, g in grads.items():
        assert _rel(g.numpy(), _jax_leaf(ref["grads"], name)) <= 1e-4, name


def test_forward_logits_shape_and_windowed_config_refused(ref):
    """The dense forward's logits and zero aux; a config with sliding-window
    layers (aqua-mistral-7b, window 16 in its smoke config) now builds and
    its forward over 2 x 32 tokens equals the reference's (it is refused
    only by the paged entry points and the engines:
    ``test_torch_aqua_paper.py``). The other families train:
    ``test_torch_train_families.py``."""
    model = _model(ref)
    tokens = make_batch(DataConfig(**DCFG), ref["tcfg"], 0)["tokens"]
    logits, aux = tlm.forward(model, ref["tcfg"], tokens)
    assert logits.shape == (2, 32, ref["tcfg"].vocab_size)
    assert float(aux) == 0.0
    mcfg = smoke_config(get_config("aqua-mistral-7b"))
    tmcfg = t_smoke_config(t_get_config("aqua-mistral-7b"))
    assert tmcfg.sliding_window == 16 and not tlm.supports_paged(tmcfg)
    params = japi.init_params(jax.random.PRNGKey(0), mcfg)
    want, _ = japi.model_module(mcfg).forward(params, mcfg,
                                              jnp.asarray(tokens.numpy()))
    wmodel = from_jax(jax.tree.map(np.asarray, params), tmcfg, device="cpu")
    with torch.no_grad():
        got, aux = tlm.forward(wmodel, tmcfg, tokens)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(ref, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    params = jax.tree.map(lambda a: a.astype(jdt), ref["params"])
    grads = jax.tree.map(lambda a: a.astype(jdt), ref["grads"])
    ocfg_kw = dict(weight_decay=0.1, grad_clip=0.5)
    jsched = jopt.cosine_schedule(1e-2, warmup=2, total=10)
    jo = jopt.AdamWConfig(lr=jsched, **ocfg_kw)
    st = jopt.adamw_init(params, jo)
    st = st._replace(step=jnp.asarray(3, jnp.int32))      # bias correction
    jp, jst, jstats = jopt.adamw_update(grads, st, params, jo)

    model = from_jax(ref["np_params"], ref["tcfg"], device="cpu").to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
    tp = trainable_params(model)
    tg = {n: torch.from_numpy(np.array(_jax_leaf(grads, n), np.float32)
                              ).to(p.dtype) for n, p in tp.items()}
    to = topt.AdamWConfig(lr=topt.cosine_schedule(1e-2, warmup=2, total=10),
                          **ocfg_kw)
    tst = topt.adamw_init(tp, to)._replace(step=3)
    _, tst, tstats = topt.adamw_update(tg, tst, tp, to)
    assert tst.step == 4
    assert abs(float(tstats["grad_norm"]) - float(jstats["grad_norm"])) \
        <= 1e-5 * float(jstats["grad_norm"])
    assert (tst.master is None) == (dtype == "float32")
    for n, p in tp.items():
        np.testing.assert_allclose(tst.mu[n].numpy(), _jax_leaf(jst.mu, n),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tst.nu[n].numpy(), _jax_leaf(jst.nu, n),
                                   rtol=0, atol=1e-6)
        if dtype == "float32":
            np.testing.assert_allclose(p.detach().numpy(), _jax_leaf(jp, n),
                                       rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(tst.master[n].numpy(),
                                       _jax_leaf(jst.master, n), rtol=0,
                                       atol=1e-6)
            assert torch.equal(p.detach(), tst.master[n].to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_match_reference(kind):
    jf = getattr(jopt, f"{kind}_schedule")(1e-3, warmup=10, total=100)
    tf = getattr(topt, f"{kind}_schedule")(1e-3, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 40, 89, 90, 95, 100):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        assert abs(tf(step) - want) <= 1e-6 * max(abs(want), 1e-12), step


def test_train_losses_match_reference(ref):
    cfg, tcfg = ref["cfg"], ref["tcfg"]
    kw = dict(seed=1, batch=2, seq_len=16)
    jlosses = j_train(cfg, JDataConfig(**kw), jopt.AdamWConfig(lr=1e-3),
                      JTrainConfig(steps=5), seed=0)["losses"]
    out = train(tcfg, DataConfig(**kw), topt.AdamWConfig(lr=1e-3),
                TrainConfig(steps=5), model=_model(ref))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-4, atol=0)
    assert len(out["step_times"]) == 5


@pytest.mark.parametrize("variant", ["micro_batches", "remat"])
def test_train_step_variants_equal_plain_step(ref, variant):
    tcfg = ref["tcfg"]
    batch = make_batch(DataConfig(**dict(DCFG, batch=4)), tcfg, 0)
    ocfg = topt.AdamWConfig(lr=1e-3)
    outs = []
    for tc in (TrainConfig(), TrainConfig(**{variant: 4 if variant ==
                                             "micro_batches" else True})):
        model = _model(ref)
        opt = topt.adamw_init(trainable_params(model), ocfg)
        _, _, stats = make_train_step(tcfg, ocfg, tc)(model, opt, batch)
        outs.append((float(stats["loss"]),
                     [p.detach().clone() for p in model.parameters()]))
    assert abs(outs[0][0] - outs[1][0]) < 1e-5
    assert max((a - b).abs().max().item()
               for a, b in zip(outs[0][1], outs[1][1])) < 1e-5


def test_checkpoint_roundtrip_and_atomicity(ref, tmp_path):
    model = _model(ref)
    opt = topt.adamw_init(trainable_params(model), topt.AdamWConfig())
    tree = {"params": model.state_dict(),
            "extra": {"bf16": torch.arange(6, dtype=torch.bfloat16) / 3,
                      "step": 7, "list": [np.arange(3), torch.ones(2)]},
            "opt": {"mu": opt.mu}}
    ckpt.save(tree, str(tmp_path), 7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    back = ckpt.restore(tree, str(tmp_path), 7)
    for name, t in model.state_dict().items():
        assert torch.equal(back["params"][name], t)
    assert back["extra"]["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["extra"]["bf16"], tree["extra"]["bf16"])
    assert int(back["extra"]["step"]) == 7
    assert back["extra"]["list"][0].tolist() == [0, 1, 2]
    # a torn checkpoint (no COMMITTED marker) is invisible to discovery
    (tmp_path / "step_9").mkdir()
    (tmp_path / "step_9" / "manifest.json").write_text("{}")
    assert ckpt.latest_step(str(tmp_path)) == 7
    for s in (10, 11, 12):
        ckpt.save({"x": torch.ones(1)}, str(tmp_path), s)
    ckpt.gc_old(str(tmp_path), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_11",
                                                          "step_12"]


def test_failure_injection_and_restart_resumes_exactly(ref, tmp_path):
    """Train 9 steps with a crash at 7; the restart resumes from the step-6
    checkpoint and gives the uninterrupted run's last losses exactly."""
    tcfg = ref["tcfg"].replace(n_layers=2)
    dcfg = DataConfig(seed=1, batch=2, seq_len=16)
    ocfg = topt.AdamWConfig(lr=1e-3)
    kw = dict(seed=0, device="cpu")
    full = train(tcfg, dcfg, ocfg, TrainConfig(steps=9), **kw)
    tc = TrainConfig(steps=9, ckpt_dir=str(tmp_path / "ck"), ckpt_every=3)
    with pytest.raises(RuntimeError, match="injected node failure"):
        train(tcfg, dcfg, ocfg, tc, fail_at=7, **kw)
    assert ckpt.latest_step(tc.ckpt_dir) == 6
    resumed = train(tcfg, dcfg, ocfg, tc, **kw)
    assert len(resumed["losses"]) == 3
    assert resumed["losses"] == full["losses"][-3:]
    for a, b in zip(full["params"].parameters(),
                    resumed["params"].parameters()):
        assert torch.equal(a, b)


def test_train_cli_cpu_and_default_device(capsys):
    out = t_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 3
    assert "final loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA requested"):
            t_launch.main(["--arch", ARCH, "--smoke", "--steps", "1"])
