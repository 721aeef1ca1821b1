"""deepseek-v2-lite-16b on the port's paged runtime, on the CPU: the
reference's deepseek cases of ``test_state_paging.py`` (park mid-prefill
and mid-decode) and ``test_prefix_cache.py`` (a cache hit against a cold
prefill), held as the port against itself — every logit bit-identical —
and beside that the port's logits against the reference's runs of the same
schedule at rtol 1e-4 / atol 1e-5. Also the serve CLI on the smoke
config.

Weights come from the reference's ``api.init_params(PRNGKey(0), cfg)`` on
the smoke config (float32) through ``from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config, smoke_config
from repro.core.aqua_tensor import REMOTE as J_REMOTE
from repro.models import api as japi
from repro.serving.kv_cache import PagedStateRuntime as JRuntime
from repro.serving.scheduler import bucket_tokens
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.aqua_tensor import REMOTE as T_REMOTE
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.params import from_jax
from repro_torch.serving.kv_cache import PagedStateRuntime as TRuntime

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-5)
PAD = 11


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(get_config(ARCH))
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_smoke_config(t_get_config(ARCH))
    model = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


class _Port:
    """One package's runtime and entry points behind one call shape."""

    def __init__(self, tcfg, model, **kw):
        self.kv = TRuntime(tcfg, device="cpu", **kw)
        self.cfg, self.model = tcfg, model

    def prefill(self, rid, toks, pos, last):
        lg, self.kv.pools = tapi.prefill_chunk_paged(
            self.model, self.cfg, toks, self.kv.pools,
            self.kv.block_tables_prefill(rid, pad_to=PAD), pos, last,
            read_pps=self.kv.pps)
        return lg.numpy()

    def decode(self, rid, tok, pos):
        lg, self.kv.pools = tapi.decode_step_paged(
            self.model, self.cfg, self.kv.pools,
            self.kv.block_tables([rid, None]), np.asarray([tok, 0], np.int32),
            np.asarray([pos, 0], np.int32))
        return lg[0].numpy()


class _Ref(_Port):
    def __init__(self, cfg, params, **kw):
        self.kv = JRuntime(cfg, **kw)
        self.cfg, self.params = cfg, params

    def prefill(self, rid, toks, pos, last):
        lg, self.kv.pools = japi.prefill_chunk_paged(
            self.params, self.cfg, jnp.asarray(toks), self.kv.pools,
            self.kv.block_tables_prefill(rid, pad_to=PAD), jnp.int32(pos),
            jnp.int32(last), read_pps=self.kv.pps, impl="xla")
        return np.asarray(lg)

    def decode(self, rid, tok, pos):
        lg, self.kv.pools = japi.decode_step_paged(
            self.params, self.cfg, self.kv.pools,
            self.kv.block_tables([rid, None]),
            jnp.asarray([tok, 0], jnp.int32), jnp.asarray([pos, 0], jnp.int32),
            impl="xla")
        return np.asarray(lg[0])


def _prefill(run, rid, prompt, chunks, start=0, park=None):
    """Chunked prefill straight on the runtime, registering completed
    prefix pages as the engine does; ``park`` parks and restores after
    every chunk. Returns the last chunk's logits."""
    pos = start
    for c in chunks:
        run.kv.ensure_capacity(rid, pos + c)
        run.kv.make_writable(rid, pos, pos + c)
        toks = np.zeros((1, bucket_tokens(c)), np.int32)
        toks[0, :c] = prompt[pos:pos + c]
        lg = run.prefill(rid, toks, pos, c - 1)
        pos += c
        run.kv.register_prefix(rid, pos)
        if park is not None:
            run.kv.park(rid, pos, prefer=park)
            run.kv.restore(rid)
    return lg


def _decode(run, rid, ctx0, first_tok, steps, park=None):
    out, logs = first_tok, []
    for t in range(steps):
        ctx = ctx0 + t + 1
        run.kv.ensure_capacity(rid, ctx)
        run.kv.make_writable(rid, ctx - 1, ctx)
        logs.append(run.decode(rid, out, ctx - 1))
        out = int(np.argmax(logs[-1]))
        if park is not None:
            run.kv.park(rid, ctx, prefer=park)
            run.kv.restore(rid)
    return logs


def _prompt(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return list(map(int, rng.integers(0, cfg.vocab_size, n)))


RT = dict(max_seq=64, page_tokens=8, max_running=2)


def _roundtrip(run, prompt, park):
    if park is not None:
        run.kv.add_remote_lease("d0", 1 << 24)
    lg = _prefill(run, 0, prompt, [7, 10], park=park)
    return [lg] + _decode(run, 0, len(prompt), int(np.argmax(lg[0])), 3,
                          park=park)


def test_preemption_roundtrip_bit_identical(models):
    """Park to a REMOTE lease and restore after every chunk and decode
    step: every logits array bit-identical to the unparked run (the latent
    pages move byte-exact); each park or restore is one fabric message of
    the request's live latent rows; the unparked logits within TOL of the
    reference's run of the same schedule."""
    cfg, params, tcfg, model = models
    prompt = _prompt(cfg, 1, 17)
    base = _roundtrip(_Port(tcfg, model, **RT), prompt, None)
    parked_run = _Port(tcfg, model, **RT)
    parked = _roundtrip(parked_run, prompt, T_REMOTE)
    for a, b in zip(base, parked):
        np.testing.assert_array_equal(a, b)
    ref = _roundtrip(_Ref(cfg, params, **RT), prompt, None)
    for a, b in zip(base, ref):
        np.testing.assert_allclose(a, b, **TOL)
    meter = parked_run.kv.meter
    plane = parked_run.kv.planes["mla"]
    assert plane.aqua.page_shape == (8, 64 + 16)
    assert plane.token_bytes == (64 + 16) * 4
    # each leg meters the request's live latent rows: its context times
    # the layers times a token's bytes (a tail page at its fill)
    contexts = (7, 17, 18, 19, 20)
    assert meter.messages_fabric == 2 * len(contexts)    # park + restore
    assert meter.bytes_fabric == 2 * sum(contexts) * cfg.n_layers \
        * plane.token_bytes
    assert J_REMOTE == T_REMOTE


def test_cache_hit_decode_bit_identical_to_cold_prefill(models):
    """Serving a prompt off revived cached latent pages gives logits
    bit-identical to a cold prefill on a sharing-off runtime (prefill and 3
    decode steps); the cold run's logits within TOL of the reference's."""
    cfg, params, tcfg, model = models
    prefix = _prompt(cfg, 12, 16)
    prompt = prefix + _prompt(cfg, 13, 5)

    def cold(run):
        lg = _prefill(run, 0, prompt, [8, 8, 5])
        return [lg] + _decode(run, 0, len(prompt), int(np.argmax(lg[0])), 3)
    lg0 = cold(_Port(tcfg, model, prefix_sharing=False, **RT))
    for a, b in zip(lg0, cold(_Ref(cfg, params, prefix_sharing=False,
                                   **RT))):
        np.testing.assert_allclose(a, b, **TOL)
    run = _Port(tcfg, model, **RT)
    run.kv.adopt_prefix(0, prefix)
    _prefill(run, 0, prefix, [8, 8])
    run.kv.release(0)
    assert run.kv.cached_pages()["mla"] == 2 * cfg.n_layers
    assert run.kv.adopt_prefix(1, prompt) == 16
    assert run.kv.stats()["cache"]["hits"] == 1
    lg = _prefill(run, 1, prompt, [5], start=16)
    lg1 = [lg] + _decode(run, 1, len(prompt), int(np.argmax(lg[0])), 3)
    for a, b in zip(lg0, lg1):
        np.testing.assert_array_equal(a, b)


def test_serve_cli_serves_the_smoke_config(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "4", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "(planes: mla)" in out
    assert "served 4 requests" in out
