"""Training runs of the RWKV-6, MLA/MoE, hybrid and VLM families against
the JAX reference, on the CPU: three ``train`` steps from the reference's
``api.init_params(PRNGKey(0), cfg)`` weights (carried over with
``from_jax``) on each side's seeded batches, losses equal at 1e-4
relative; and ``python -m repro_torch.launch.train --arch <family>
--smoke`` trains. The smoke configs of rwkv6-3b, deepseek-v2-lite-16b,
dbrx-132b, jamba-v0.1-52b and internvl2-1b (internvl2: 8 prefix rows
counted in the sequence). One intra-op thread, as in
``test_torch_train_families.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models import api as japi
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JDataConfig
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import train as j_train
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.launch import train as t_launch
from repro_torch.params import from_jax
from repro_torch.training import optimizer as topt
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import TrainConfig, train

ARCHS = ("rwkv6-3b", "deepseek-v2-lite-16b", "dbrx-132b", "jamba-v0.1-52b",
         "internvl2-1b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cfg = smoke_config(get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    return dict(cfg=cfg, tcfg=t_smoke_config(t_get_config(arch)),
                np_params=jax.tree.map(np.asarray, params))


def _model(ref):
    return from_jax(ref["np_params"], ref["tcfg"], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_losses_match_reference(arch):
    ref = _reference(arch)
    kw = dict(seed=1, batch=2, seq_len=32 if arch != "internvl2-1b" else 40)
    jlosses = j_train(ref["cfg"], JDataConfig(**kw), jopt.AdamWConfig(lr=1e-3),
                      JTrainConfig(steps=3), seed=0)["losses"]
    out = train(ref["tcfg"], DataConfig(**kw), topt.AdamWConfig(lr=1e-3),
                TrainConfig(steps=3), model=_model(ref))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-4, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_takes_the_family(arch, capsys):
    out = t_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "24",
                         "--remat"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "final loss" in capsys.readouterr().out
