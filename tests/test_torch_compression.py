"""Gradient compression and straggler rebalancing in the port against the
JAX reference, on the CPU: ``compress`` / ``decompress`` /
``compress_tree`` / ``init_error_buffers`` bit for bit in float32 (the
payload, the scale and the error buffer) on the same numpy inputs, from
gradients of every scale down to all zeros and from bf16; the
error-feedback property of ``tests/test_training.py:117`` under
hypothesis on the port; ``RebalancePolicy.update`` and ``bucket_sizes``
equal to the reference's through successive updates, and its straggler
case (``test_training.py:150``). One intra-op thread, as the other port
test files of many small ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.training import compression as jcomp
from repro.training.elastic import RebalancePolicy as JPolicy
from repro_torch.training import compression as tcomp
from repro_torch.training.elastic import RebalancePolicy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return np.asarray(t, np.float32).tobytes()


def _assert_same(jc, je, tc, te):
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    assert tc.q.dtype == torch.int8 and tc.scale.dtype == torch.float32
    assert _bits(tc.scale.numpy()) == _bits(jc.scale)
    assert te.dtype == torch.float32
    assert _bits(te.numpy()) == _bits(je)
    assert _bits(tcomp.decompress(tc).numpy()) == \
        _bits(jcomp.decompress(jc))


@pytest.mark.parametrize("scale", [0.0, 1e-30, 1e-7, 1.0, 3e4])
@pytest.mark.parametrize("shape", [(1,), (7, 33), (4, 8, 64)])
def test_compress_bit_equal_to_reference(shape, scale):
    rng = np.random.default_rng(len(shape) + int(scale > 1))
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    err = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
    for _ in range(3):                  # the error fed back, three rounds
        jc, je = jcomp.compress(jnp.asarray(g), jnp.asarray(err))
        tc, te = tcomp.compress(torch.from_numpy(g), torch.from_numpy(err))
        _assert_same(jc, je, tc, te)
        err = te.numpy()


def test_compress_from_bf16_bit_equal_to_reference():
    """A bf16 gradient widens to float32 before the error is added."""
    g = np.random.default_rng(1).standard_normal((16, 24)).astype(np.float32)
    err = np.zeros((16, 24), np.float32)
    jc, je = jcomp.compress(jnp.asarray(g, jnp.bfloat16), jnp.asarray(err))
    tc, te = tcomp.compress(torch.from_numpy(g).bfloat16(),
                            torch.from_numpy(err))
    _assert_same(jc, je, tc, te)


def test_compress_tree_and_error_buffers_bit_equal_to_reference():
    """A nested tree of gradients, its zero error buffers, then two rounds
    of ``compress_tree`` with the buffers fed back."""
    rng = np.random.default_rng(2)
    shapes = {"embed": {"tok": (32, 16)},
              "blocks": {"wq": (3, 16, 16), "n1": (3, 16)},
              "final_norm": (16,)}

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (rng.standard_normal(node) * rng.uniform(1e-3, 10)).astype(
            np.float32)
    tree = draw(shapes)
    jg = jax.tree.map(jnp.asarray, tree)
    tg = jax.tree.map(torch.from_numpy, tree)
    je, te = jcomp.init_error_buffers(jg), tcomp.init_error_buffers(tg)
    assert jax.tree.structure(te) == jax.tree.structure(tg)
    for leaf, want in zip(jax.tree.leaves(te), jax.tree.leaves(je)):
        assert leaf.dtype == torch.float32 and not leaf.any()
        assert tuple(leaf.shape) == want.shape
    for _ in range(2):
        jc, je = jcomp.compress_tree(jg, je)
        tc, te = tcomp.compress_tree(tg, te)
        assert jax.tree.structure(te) == jax.tree.structure(tg)
        flat_t = jax.tree.leaves(tc, is_leaf=lambda x: isinstance(
            x, tcomp.CompressedGrad))
        flat_j = jax.tree.leaves(jc, is_leaf=lambda x: isinstance(
            x, jcomp.CompressedGrad))
        assert len(flat_t) == len(flat_j) == 4
        for c_t, c_j, e_t, e_j in zip(flat_t, flat_j, jax.tree.leaves(te),
                                      jax.tree.leaves(je)):
            _assert_same(c_j, e_j, c_t, e_t)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 1000))
def test_compression_error_feedback_bounded(seed):
    """The twin of ``test_training.py:117``: the accumulated quantization
    error stays within a scale, and the running sum of decompressed
    gradients tracks the true sum."""
    rng = np.random.default_rng(seed)
    g_true = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    err = torch.zeros(64)
    acc_true = np.zeros(64)
    acc_q = np.zeros(64)
    for t in range(30):
        g = g_true * (0.9 ** t)
        c, err = tcomp.compress(g, err)
        acc_true += g.numpy()
        acc_q += tcomp.decompress(c).numpy()
    scale = float(g_true.abs().max()) / 127.0
    assert float(err.abs().max()) <= scale * 1.01
    np.testing.assert_allclose(acc_q, acc_true, atol=2 * scale)


TIMES = [[1.0, 1.0, 1.0, 3.0], [1.0, 2.0, 1.0, 1.0], [0.5, 0.5, 9.0, 0.5],
         [2.0, 2.0, 2.0, 2.0], [1e-12, 1.0, 4.0, 40.0]]


@pytest.mark.parametrize("global_batch", [4, 7, 64, 1000])
@pytest.mark.parametrize("smoothing", [0.0, 0.5, 0.9])
def test_rebalance_policy_equals_reference(smoothing, global_batch):
    """Five successive observations (the EMA carried between them): the
    shares and the bucket sizes equal the reference's, the sizes summing
    to the global batch."""
    mine, ref = (RebalancePolicy(n_shards=4, smoothing=smoothing),
                 JPolicy(n_shards=4, smoothing=smoothing))
    for t in TIMES:
        got, want = mine.bucket_sizes(global_batch, t), \
            ref.bucket_sizes(global_batch, t)
        assert got == want and sum(got) == global_batch
        np.testing.assert_array_equal(mine._ema, ref._ema)
    probe_m, probe_r = (RebalancePolicy(n_shards=3, min_share=0.5),
                        JPolicy(n_shards=3, min_share=0.5))
    np.testing.assert_array_equal(probe_m.update([1.0, 5.0, 2.0]),
                                  probe_r.update([1.0, 5.0, 2.0]))


def test_rebalance_policy_shrinks_slow_shard():
    """The twin of ``test_training.py:150``."""
    pol = RebalancePolicy(n_shards=4)
    sizes = pol.bucket_sizes(64, [1.0, 1.0, 1.0, 3.0])
    assert sum(sizes) == 64
    assert sizes[3] < min(sizes[:3])
