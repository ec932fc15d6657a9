"""The port's weight clustering (C2) held against the JAX package's.

Weights are normal draws made with numpy, handed to both packages.  The two
k-means differ in how they sum a cluster (the reference in fp32 in order,
the port exactly, in fixed point), so codebooks are held within 1e-5
absolute.  Ids must be equal, except for a weight that lies on a decision
boundary to within that tolerance (a near tie: its two nearest centroids
are equally near to within 2e-5, the two centroids' tolerances), which may
go either way; a few such weights turn up among 49,152 weights in 64
clusters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jc
from repro.utils import tree as jtree
from repro_torch.core import clustering as tc
from repro_torch.utils import tree as ttree

CB_TOL = dict(rtol=0, atol=1e-5)


def _assert_ids_match(w, got, want, codebook):
    """Equal ids, but for near ties; returns the number of near ties."""
    got, want = got.numpy().astype(np.int64), np.asarray(want).astype(np.int64)
    diff = got != want
    cb = codebook.numpy()
    gap = np.abs(np.abs(w[diff] - cb[got[diff]]) - np.abs(w[diff] - cb[want[diff]]))
    assert (gap <= 2 * CB_TOL["atol"]).all(), gap.max()
    assert diff.mean() < 1e-3
    return int(diff.sum())


def _w(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("c", [4, 16, 64, 10])
@pytest.mark.parametrize("shape", [(96, 40), (5000,), (64, 64, 3)])
def test_density_based_centroids_match_jax(shape, c):
    w = _w(shape)
    want = np.asarray(jc.density_based_centroids(jnp.asarray(w), c))
    got = tc.density_based_centroids(torch.from_numpy(w), c)
    assert got.dtype == torch.float32 and got.shape == (c,)
    np.testing.assert_allclose(got.numpy(), want, **CB_TOL)


def test_sort_quantile_past_torch_quantile_limit():
    """Past 2**24 elements (where torch.quantile refuses), the sort-based
    quantile is numpy's linear quantile (to fp32 rounding)."""
    n = 2**24 + 5
    a = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    probs = (np.arange(64, dtype=np.float32) + 0.5) / 64
    want = np.quantile(a.astype(np.float64), probs.astype(np.float64))
    got = tc.density_based_centroids(torch.from_numpy(a), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    small = np.sort(a[:1001])
    edges = tc.quantile_sorted(torch.from_numpy(small), torch.tensor([0.0, 1.0, 0.5, 0.3]))
    np.testing.assert_allclose(edges.numpy(), np.quantile(small.astype(np.float64),
                                                          [0.0, 1.0, 0.5, 0.3]), rtol=1e-6)


@pytest.mark.parametrize("c,iters,preserve_zero", [
    (4, 5, True), (16, 10, True), (64, 10, True), (64, 10, False), (8, 3, False),
])
@pytest.mark.parametrize("shape", [(256, 192), (64, 96)])
def test_cluster_weights_match_jax(shape, c, iters, preserve_zero):
    w = _w(shape, seed=2, scale=0.05)
    cfg = dict(num_clusters=c, iters=iters, preserve_zero=preserve_zero)
    jdense, jcw = jc.cluster_weights(jnp.asarray(w), jc.ClusteringConfig(**cfg))
    tdense, tcw = tc.cluster_weights(torch.from_numpy(w), tc.ClusteringConfig(**cfg))
    np.testing.assert_allclose(tcw.codebook.numpy(), np.asarray(jcw.codebook), **CB_TOL)
    assert tcw.indices.dtype == torch.int8 and tcw.indices.shape == shape
    ties = _assert_ids_match(w, tcw.indices, jcw.indices, tcw.codebook)
    same = tcw.indices.numpy() == np.asarray(jcw.indices)
    np.testing.assert_allclose(tdense.numpy()[same], np.asarray(jdense)[same], **CB_TOL)
    assert ties == 0 or c == 64
    if preserve_zero:
        assert (tcw.codebook == 0).sum() == 1
    assert (torch.diff(tcw.codebook) >= 0).all()


def test_sparse_weights_keep_their_zeros():
    w = _w((64, 64))
    w = w * (np.abs(w) > 0.8)
    dense, _ = tc.cluster_weights(torch.from_numpy(w), tc.ClusteringConfig(num_clusters=16))
    assert int((dense == 0).sum()) >= int((w == 0).sum())


@pytest.mark.parametrize("chunk", [7, 1000, 1 << 22])
def test_assignment_does_not_depend_on_chunk_size(monkeypatch, chunk):
    w = torch.from_numpy(_w((300, 70), seed=3))
    cfg = tc.ClusteringConfig(num_clusters=32)
    _, want = tc.cluster_weights(w, cfg)
    monkeypatch.setattr(tc, "ASSIGN_CHUNK", chunk)
    _, got = tc.cluster_weights(w, cfg)
    assert torch.equal(got.codebook, want.codebook) and torch.equal(got.indices, want.indices)


def test_first_minimum_on_ties():
    """A weight halfway between two centroids goes to the first, as
    jnp.argmin and torch.argmin both choose."""
    cents = torch.tensor([-1.0, 0.0, 1.0, 1.0])
    got = tc.assign_clusters(torch.tensor([-0.5, 0.5, 1.0, 2.0]), cents)
    want = np.asarray(jnp.argmin(jnp.abs(jnp.array([-0.5, 0.5, 1.0, 2.0])[:, None]
                                         - jnp.asarray(cents.numpy())[None]), axis=1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [0, 1, 2, 2]


@pytest.mark.parametrize("c,dtype", [(128, torch.int8), (129, torch.int32), (256, torch.int32)])
def test_index_dtype_follows_cluster_count(c, dtype):
    w = _w((32, 64), seed=4)
    _, jcw = jc.cluster_weights(jnp.asarray(w), jc.ClusteringConfig(num_clusters=c, iters=2))
    _, tcw = tc.cluster_weights(torch.from_numpy(w), tc.ClusteringConfig(num_clusters=c, iters=2))
    assert tcw.indices.dtype == dtype
    assert str(np.asarray(jcw.indices).dtype) == str(dtype).removeprefix("torch.")
    np.testing.assert_array_equal(tcw.indices.numpy(), np.asarray(jcw.indices))


def _tree(seed=5):
    return {
        "ffn": {"kernel": _w((32, 32), seed)},
        "norm": {"scale": np.ones((32,), np.float32)},
        "layers": {"attn": {"wq": {"kernel": _w((2, 16, 24), seed + 1)}},
                   "final_norm": {"w": _w((8, 8), seed + 2)}},
        "bias": _w((4,), seed + 3),
    }


def test_cluster_params_matches_jax():
    raw = _tree()
    cfg = dict(num_clusters=8)
    jdense, jpacked = jc.cluster_params(jax.tree_util.tree_map(jnp.asarray, raw),
                                        jc.ClusteringConfig(**cfg))
    tdense, tpacked = tc.cluster_params(jax.tree_util.tree_map(torch.from_numpy, raw),
                                        tc.ClusteringConfig(**cfg))
    assert sorted(tpacked) == sorted(jpacked) == ["ffn/kernel", "layers/attn/wq/kernel"]
    for name, jcw in jpacked.items():
        np.testing.assert_allclose(tpacked[name].codebook.numpy(), np.asarray(jcw.codebook),
                                   **CB_TOL)
        np.testing.assert_array_equal(tpacked[name].indices.numpy(), np.asarray(jcw.indices))
    assert torch.equal(tdense["norm"]["scale"], torch.from_numpy(raw["norm"]["scale"]))
    assert torch.equal(tdense["layers"]["final_norm"]["w"],
                       torch.from_numpy(raw["layers"]["final_norm"]["w"]))
    np.testing.assert_allclose(tdense["ffn"]["kernel"].numpy(), np.asarray(jdense["ffn"]["kernel"]),
                               **CB_TOL)


def test_tree_helpers_match_jax():
    raw = _tree()
    want = [(n, leaf.shape) for n, leaf in jtree.named_leaves(raw)]
    assert [(n, leaf.shape) for n, leaf in ttree.named_leaves(raw)] == want
    got = ttree.tree_map_with_path_names(lambda n, x: n, raw)
    assert got == jtree.tree_map_with_path_names(lambda n, x: n, raw)


def test_packed_roundtrip_error_and_storage():
    w = _w((64, 64), seed=6)
    cfg = dict(num_clusters=16)
    dense, packed = tc.cluster_weights(torch.from_numpy(w), tc.ClusteringConfig(**cfg))
    assert torch.equal(tc.unpack_clustered(packed), dense)
    assert packed.shape == (64, 64)
    assert tc.pack_clustered(torch.from_numpy(w), tc.ClusteringConfig(**cfg)).shape == (64, 64)
    want = jc.clustering_error(jnp.asarray(w), jc.ClusteringConfig(**cfg))
    assert abs(tc.clustering_error(torch.from_numpy(w), tc.ClusteringConfig(**cfg)) - want) < 1e-5
    for c in (2, 16, 64, 100):
        assert tc.ClusteringConfig(num_clusters=c).index_bits == \
            jc.ClusteringConfig(num_clusters=c).index_bits
        assert tc.storage_bits((100, 30), tc.ClusteringConfig(num_clusters=c)) == \
            jc.storage_bits((100, 30), jc.ClusteringConfig(num_clusters=c))
