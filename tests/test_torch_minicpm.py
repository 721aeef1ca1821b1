"""minicpm-2b (a llama-like dense stack, 36 heads of 64, MHA) on the
port's paged runtime against the JAX reference, on the CPU: the
configuration's parameter count (2,724,878,592), the smoke config's
training-forward logits at rtol 1e-4 / atol 1e-5 (weights from the
reference's ``api.init_params(PRNGKey(0), cfg)`` through ``from_jax``),
one engine run's greedy tokens and meter (exact) and the serve CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config, smoke_config
from repro.core.aqua_tensor import REMOTE as J_REMOTE
from repro.core.perfmodel import A100_NVLINK as J_A100
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import REMOTE as T_REMOTE
from repro_torch.core.perfmodel import A100_NVLINK as T_A100
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.params import from_jax
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "minicpm-2b"
KNOBS = dict(max_running=2, max_seq=64, scheduler="cfs", slice_tokens=3,
             step_tokens=16, kv_page_tokens=8)


def _serve(eng, cfg):
    rng = np.random.default_rng(7)
    reqs = [eng.submit(list(map(int, rng.integers(0, cfg.vocab_size,
                                                  int(rng.integers(5, 30))))),
                       int(rng.integers(3, 7)), arrival=0.01 * i)
            for i in range(5)]
    eng.run(2000)
    meter = eng.pager.meter
    return {"tokens": [list(r.generated) for r in reqs],
            "preemptions": eng.metrics.preemptions,
            "restores": eng.metrics.restores,
            "bytes_fabric": meter.bytes_fabric,
            "messages_fabric": meter.messages_fabric}


def test_param_count_matches_reference():
    tcfg = t_get_config(ARCH)
    assert tcfg.param_count() == get_config(ARCH).param_count() \
        == 2_724_878_592


def test_smoke_logits_and_engine_match_reference():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    want, _ = jlm.forward(params, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = tapi.forward(model, tcfg, torch.from_numpy(toks), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    jeng = JEngine(cfg, params, offload_tier=J_REMOTE, hw=J_A100,
                   paged_impl="xla", **KNOBS)
    jeng.pager.add_remote_lease("donor0", 1 << 22)
    teng = TEngine(tcfg, model, offload_tier=T_REMOTE, hw=T_A100,
                   device="cpu", **KNOBS)
    teng.pager.add_remote_lease("donor0", 1 << 22)
    ref, port = _serve(jeng, cfg), _serve(teng, tcfg)
    assert port == ref
    assert port["preemptions"] > 0 and all(port["tokens"])


def test_serve_cli_serves_the_smoke_config(capsys):
    for arch in (ARCH, "gemma-7b"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "3", "--max-new-tokens", "3"])
        out = capsys.readouterr().out
        assert "(planes: kv)" in out
        assert "served 3 requests" in out
