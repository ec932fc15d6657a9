"""The port's C1 sparsification held against the JAX package's.

Weights are normal draws made with numpy and handed to both packages: such
weights (and their block norms) have no ties at the threshold, so the masks
must be equal element for element.  The properties of the reference's own
tests (target hit, largest kept, block structure, fallback, schedule,
exclusions) are held on the port as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as js
from repro_torch.core import sparsity as ts
from repro_torch.utils.tree import tree_param_count


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sparsity", [0.0, 0.1, 0.5, 0.8, 0.95])
@pytest.mark.parametrize("shape", [(64, 96), (7, 33), (3, 32, 48)])
def test_magnitude_mask_matches_jax(shape, sparsity):
    w = _w(shape)
    want = np.asarray(js.magnitude_prune_mask(jnp.asarray(w), sparsity))
    got = ts.magnitude_prune_mask(torch.from_numpy(w), sparsity)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    achieved = 1 - float(got.mean())
    assert abs(achieved - sparsity) < max(0.05, 2.0 / w.size)


@pytest.mark.parametrize("q", [0.05, 0.3, 0.5, 0.77, 0.95])
def test_approx_quantile_matches_jax_and_is_close_to_exact(q):
    x = _w((20000,), seed=int(q * 100))
    got = float(ts.approx_quantile(torch.from_numpy(x), q))
    assert got == float(js.approx_quantile(jnp.asarray(x), q))
    assert abs(got - float(np.quantile(x, q))) < 0.02


@pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.5, 0.9])
@pytest.mark.parametrize("shape,block", [((64, 128), (16, 32)), ((2, 64, 64), (8, 8)),
                                          ((48, 64), (128, 128))])
def test_block_mask_matches_jax(shape, block, sparsity):
    """Including the unstructured fallback for dims the block does not divide."""
    w = _w(shape, seed=1)
    want = np.asarray(js.block_prune_mask(jnp.asarray(w), sparsity, block))
    got = ts.block_prune_mask(torch.from_numpy(w), sparsity, block).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_mask_structure():
    m = ts.block_prune_mask(torch.from_numpy(_w((64, 128))), 0.5, (16, 32)).numpy()
    per_block = m.reshape(4, 16, 4, 32).transpose(0, 2, 1, 3).reshape(16, -1).mean(axis=1)
    assert set(np.round(per_block, 6)) <= {0.0, 1.0}
    assert abs(per_block.mean() - 0.5) <= 0.3


@pytest.mark.parametrize("seed", range(4))
def test_mask_keeps_largest(seed):
    w = _w((32, 32), seed)
    m = ts.magnitude_prune_mask(torch.from_numpy(w), 0.2 + 0.2 * seed).numpy()
    kept, pruned = np.abs(w)[m > 0], np.abs(w)[m == 0]
    assert kept.min() >= pruned.max() - 1e-6


def test_gradual_schedule_matches_jax():
    for t in [0, 10, 33, 50, 99, 100, 500]:
        for args in [(0.8, 0, 100), (0.5, 20, 60, 0.1)]:
            got = ts.gradual_sparsity_schedule(t, *args)
            assert got.dtype == torch.float32
            assert float(got) == float(js.gradual_sparsity_schedule(t, *args))
    vals = [float(ts.gradual_sparsity_schedule(t, 0.8, 0, 100)) for t in range(0, 101, 10)]
    assert vals[0] == pytest.approx(0.0) and vals[-1] == pytest.approx(0.8)
    assert all(a <= b + 1e-6 for a, b in zip(vals, vals[1:]))


def _tree(seed=0):
    return {
        "layers": {"ffn": {"wi": {"kernel": _w((2, 64, 96), seed)}},
                   "attn": {"wq": {"kernel": _w((2, 64, 64), seed + 1)}}},
        "embed": {"embedding": _w((100, 16), seed + 2)},
        "final_norm": {"scale": np.ones((16,), np.float32)},
        "conv": [{"kernel": _w((3, 3, 4, 8), seed + 3), "bias": np.zeros(8, np.float32)}],
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(tree)


@pytest.mark.parametrize("step", [None, 0, 400, 2000])
@pytest.mark.parametrize("block", [(1, 1), (8, 8)])
def test_build_and_apply_masks_match_jax(block, step):
    tree = _tree()
    cfg = dict(target_sparsity=0.7, block=block, per_layer={"attn": 0.5})
    want = js.build_masks({k: v for k, v in _jax(tree).items()}, js.SparsityConfig(**cfg), step)
    got = ts.build_masks(_torch(tree), ts.SparsityConfig(**cfg), step)
    flat_w = [np.asarray(a) for a in _leaves(want)]
    flat_g = [a.numpy() for a in _leaves(got)]
    assert len(flat_w) == len(flat_g) == 6
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, b)
    assert float(got["embed"]["embedding"].mean()) == 1.0
    assert float(got["final_norm"]["scale"].mean()) == 1.0
    sparse = ts.apply_masks(_torch(tree), got)
    np.testing.assert_array_equal(sparse["layers"]["ffn"]["wi"]["kernel"].numpy(),
                                  tree["layers"]["ffn"]["wi"]["kernel"] * flat_w[5])


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v) for v in tree]
    return jnp.asarray(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_sparsity_of_l2_and_param_count_match_jax():
    tree = _tree()
    w = tree["layers"]["ffn"]["wi"]["kernel"] * (np.abs(tree["layers"]["ffn"]["wi"]["kernel"]) > 1)
    assert ts.sparsity_of(torch.from_numpy(w)) == js.sparsity_of(w)
    assert ts.sparsity_of(torch.from_numpy(w), atol=0.5) == js.sparsity_of(w, atol=0.5)
    got = ts.l2_regularization(_torch(tree))
    np.testing.assert_allclose(float(got), float(js.l2_regularization(_jax(tree))), rtol=1e-6)
    from repro.utils.tree import tree_param_count as jax_count
    assert tree_param_count(_torch(tree)) == jax_count(_jax(tree))
    params = {"w": torch.ones((4, 4)), "norm_scale": torch.full((4,), 100.0)}
    assert float(ts.l2_regularization(params)) == pytest.approx(16.0)
