"""Top-k on tied scores keeps the reference's order: lower index first.

``jax.lax.top_k`` puts the lower index first among equal scores;
``torch.topk`` promises no order, and on the CPU picks other index sets for
the inputs C3 is for: integer-valued activations, and ReLU activations whose
zero columns outnumber what k leaves room for.  The port's ``top_k`` (a
stable descending sort) is held here to the JAX package's choices:
indices equal, values bit for bit, products within 2e-5 (fp32, sums in
another order).  Block pruning of an already pruned weight ties its
all-zero blocks in the same way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import activation_sparsity as jas
from repro.core.sonic_layers import make_block_sparse as jax_make_block_sparse
from repro_torch.core import activation_sparsity as tas
from repro_torch.core.sonic_layers import make_block_sparse

D = 1024


def _acts(kind, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "integer":  # ReLU of small integers: many equal scores
        return np.maximum(rng.integers(-3, 4, (rows, D)), 0).astype(np.float32)
    x = np.maximum(rng.standard_normal((rows, D)), 0).astype(np.float32)
    x[:, rng.random(D) < 0.9] = 0  # 90% zero columns
    return x


def _k(x, kind):
    nnz = int((x != 0).any(axis=0).sum())
    # integer: the boundary falls among equal nonzero scores; 90% zero: k > nnz,
    # so the kept set takes zero columns, which all tie
    return nnz // 2 if kind == "integer" else nnz + D // 8


def test_top_k_breaks_ties_to_the_lower_index():
    s = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 0.0])
    assert tas.top_k(s, 6).tolist() == [1, 2, 4, 3, 0, 5]
    assert tas.top_k(torch.stack([s, s.flip(0)]), 2).tolist() == [[1, 2], [2, 4]]


@pytest.mark.parametrize("kind", ["integer", "relu_90pct_zero"])
def test_topk_compress_on_ties_matches_jax(kind):
    x = _acts(kind)
    k = _k(x, kind)
    want_v, want_i = jas.topk_compress(jnp.asarray(x), k)
    got_v, got_i = tas.topk_compress(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    want_m = np.asarray(jas.topk_activation_mask(jnp.asarray(x), k))
    np.testing.assert_array_equal(tas.topk_activation_mask(torch.from_numpy(x), k).numpy(),
                                  want_m)


@pytest.mark.parametrize("kind", ["integer", "relu_90pct_zero"])
def test_sparse_ffn_matmul_on_ties_matches_jax(kind):
    x = _acts(kind, rows=2, seed=1)
    k = _k(x, kind)
    w = np.random.default_rng(2).standard_normal((D, 48)).astype(np.float32)
    want = np.asarray(jas.sparse_ffn_matmul(jnp.asarray(x), jnp.asarray(w), k))
    got = tas.sparse_ffn_matmul(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sparsity", [0.25, 0.5])
def test_make_block_sparse_on_zero_blocks_matches_jax(sparsity):
    """A weight with most blocks zero (as after C1 pruning): the kept set
    reaches into the zero blocks, which all tie."""
    rng = np.random.default_rng(0)
    k, n, block = 512, 256, (16, 32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    kb, nb = k // block[0], n // block[1]
    zero = rng.random((kb, nb)) < 0.7
    w = w * np.repeat(np.repeat(~zero, block[0], 0), block[1], 1)
    want = jax_make_block_sparse(jnp.asarray(w), sparsity, block)
    got = make_block_sparse(torch.from_numpy(w), sparsity, block)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
