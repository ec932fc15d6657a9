"""The port's SONIC weight formats held against the JAX package's.

Weights are tie-free normal draws made with numpy: on tied block norms
``jax.lax.top_k`` and ``torch.topk`` may keep different blocks.  Indices and
int8 values must be equal; scales equal or within 1 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sonic_layers as jsl
from repro.models.registry import get_arch as jax_get_arch
from repro_torch.core import sonic_layers as tsl
from repro_torch.convert import params_from_jax

CASES = [((16, 16), 0.0), ((16, 16), 0.5), ((32, 64), 0.25), ((64, 64), 0.5)]


def _w(k=256, n=192, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)


def _assert_scales_close(got: np.ndarray, want: np.ndarray):
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("block,sparsity", CASES)
def test_make_block_sparse_matches_jax(block, sparsity):
    w = _w()
    want = jsl.make_block_sparse(jnp.asarray(w), sparsity, block)
    got = tsl.make_block_sparse(torch.from_numpy(w), sparsity, block)
    assert got.k_blocks == want.k_blocks
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.dense().numpy(), np.asarray(want.dense()))


@pytest.mark.parametrize("block,sparsity", CASES)
def test_quantize_block_sparse_matches_jax(block, sparsity):
    w = _w(seed=1)
    want = jsl.make_block_sparse_int8(jnp.asarray(w), sparsity, block)
    got = tsl.make_block_sparse_int8(torch.from_numpy(w), sparsity, block)
    assert got.values.dtype == torch.int8 and got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    _assert_scales_close(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_allclose(got.dense().numpy(), np.asarray(want.dense()),
                               rtol=1e-6, atol=1e-7)


def test_all_zero_block_gets_scale_one():
    w = _w(128, 128)
    w[:32, :32] = 0.0  # one all-zero block, kept at sparsity 0
    q = tsl.make_block_sparse_int8(torch.from_numpy(w), 0.0, (32, 32))
    r = int(np.where(q.indices[0].numpy() == 0)[0][0])  # N-block 0 reading K-block 0
    assert q.scales[0, r] == 1.0 and (q.values[0, r] == 0).all()
    assert (q.dense()[:32, :32] == 0.0).all()


@pytest.mark.parametrize("dims", [(64, 256), (2048, 5632), (96, 40), (7, 1)])
def test_auto_block_matches_jax(dims):
    assert tsl._auto_block(*dims) == jsl._auto_block(*dims)


def test_block_sparse_int8_matmul_plain_matches_jnp():
    q = jsl.make_block_sparse_int8(jnp.asarray(_w()), 0.5, (32, 64))
    x = np.random.default_rng(2).standard_normal((2, 5, 256)).astype(np.float32)
    want = jsl.block_sparse_int8_matmul_jnp(jnp.asarray(x), q.values, q.scales,
                                            q.indices, q.k_blocks)
    got = tsl.block_sparse_int8_matmul_plain(
        torch.from_numpy(x), *(torch.from_numpy(np.array(a)) for a in
                               (q.values, q.scales, q.indices)), q.k_blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block", [None, (16, 16)])
def test_quantize_serve_params_matches_jax(block):
    """The whole reduced tinyllama tree: every projection (stacked layer
    kernels and the 2-D LM head) rewritten alike; other leaves untouched."""
    arch = jax_get_arch("tinyllama-1.1b", reduced=True)
    raw = arch.init_params(jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(np.array, jsl.quantize_serve_params(raw, 0.5, block))
    got = tsl.quantize_serve_params(
        params_from_jax(jax.tree_util.tree_map(np.array, raw), "cpu"), 0.5, block)
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), got))[0])
    assert len(flat_got) == len(flat_want)
    n_q = 0
    for path, w in flat_want:
        g = flat_got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path[-1].key == "qscales":
            _assert_scales_close(g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        n_q += path[-1].key == "qvalues"
    assert n_q == 8  # q, k, v, o, wi, wg, wo and the LM head
