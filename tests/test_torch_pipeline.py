"""The slice as a whole: the SONIC pipeline of ``examples/quickstart.py``
(C1 prune → C2 cluster → generate → C4/C5 pricing) through the port, held
against the same steps through the JAX package.

Reduced tinyllama, weights initialised by the JAX package and carried
across, fp32 compute on both sides (the two packages round bf16 at other
places, which could flip near-tied logits).  C1 masks must be equal
element for element (normal weights: no block norm ties at the threshold).
C2: the two k-means sum a cluster in other orders (see
``tests/test_torch_clustering.py``), so a weight that lies on a decision
boundary may fall into the other cluster in one Lloyd iteration; that moves
both centroids by about |w − c| / n (n ≥ 71 weights a cluster here) and
later iterations carry it on.  Codebooks are held within 2e-4 (the largest
seen: 9.4e-5, on the unpruned embedding) and ids equal but for weights
equally near both centroids to within twice that.  Greedy tokens must be equal, dense and
clustered.  The photonic pricing of the full model must be equal to the
last bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jcl
from repro.core import sparsity as jsp
from repro.models.registry import get_arch as jax_get_arch
from repro.photonic.baselines import evaluate_all as jax_evaluate_all
from repro.photonic.mapper import lm_workload as jax_lm_workload
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sharding.mesh import MeshPlan
from repro.utils.tree import tree_param_count as jax_tree_param_count
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.clustering import ClusteringConfig, cluster_params, storage_bits
from repro_torch.core.sparsity import SparsityConfig, apply_masks, build_masks, sparsity_of
from repro_torch.models.registry import get_arch
from repro_torch.photonic.baselines import evaluate_all
from repro_torch.photonic.mapper import lm_workload
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.utils.tree import named_leaves, tree_param_count

NEW, MAX_LEN = 12, 64
C1 = dict(target_sparsity=0.5, block=(8, 8))
CB_TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def pipeline():
    """Both packages through C1 and C2, and their greedy tokens."""
    jarch = jax_get_arch("tinyllama-1.1b", reduced=True)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.replace(compute_dtype="float32"))
    raw = jarch.init_params(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.int32)
    j = {"params": raw, "masks": jsp.build_masks(raw, jsp.SparsityConfig(**C1))}
    j["sparse"] = jsp.apply_masks(raw, j["masks"])
    j["clustered"], j["packed"] = jcl.cluster_params(j["sparse"], jcl.ClusteringConfig(64))

    arch = get_arch("tinyllama-1.1b", reduced=True)
    arch = dataclasses.replace(arch, cfg=arch.cfg.replace(compute_dtype="float32"))
    params = params_from_jax(_np(raw), "cpu")
    t = {"params": params, "masks": build_masks(params, SparsityConfig(**C1))}
    t["sparse"] = apply_masks(params, t["masks"])
    t["clustered"], t["packed"] = cluster_params(t["sparse"], ClusteringConfig(num_clusters=64))

    for side, gen in ((j, lambda p: np.asarray(JaxServeEngine(
            jarch, p, MeshPlan(), JaxServeConfig(max_len=MAX_LEN)).generate(
            jnp.asarray(prompts), NEW))),
                      (t, lambda p: ServeEngine(arch, p, ServeConfig(max_len=MAX_LEN),
                                                device="cpu").generate(
            torch.from_numpy(prompts), NEW).numpy())):
        side["dense_out"] = gen(side["params"])
        side["sonic_out"] = gen(side["clustered"])
    return j, t


def test_c1_masks_and_sparse_params_match_jax(pipeline):
    j, t = pipeline
    got, want = list(named_leaves(t["masks"])), dict(named_leaves(_np(j["masks"])))
    assert [name for name, _ in got] == list(want) and len(got) > 5
    for name, m in got:
        np.testing.assert_array_equal(m.numpy(), want[name], err_msg=name)
    wi = t["sparse"]["layers"]["ffn"]["wi"]["kernel"]
    np.testing.assert_array_equal(wi.numpy(), np.asarray(j["sparse"]["layers"]["ffn"]["wi"]["kernel"]))
    assert sparsity_of(wi) == jsp.sparsity_of(j["sparse"]["layers"]["ffn"]["wi"]["kernel"])
    assert abs(sparsity_of(wi) - 0.5) < 0.05


def test_c2_clusters_match_jax(pipeline):
    j, t = pipeline
    assert list(t["packed"]) == list(j["packed"]) and len(t["packed"]) > 5
    sparse = dict(named_leaves(t["sparse"]))
    for name, cw in t["packed"].items():
        jw = j["packed"][name]
        cb = cw.codebook.numpy()
        np.testing.assert_allclose(cb, np.asarray(jw.codebook), rtol=0, atol=CB_TOL)
        got, want = cw.indices.numpy().astype(np.int64), np.asarray(jw.indices).astype(np.int64)
        diff = got != want
        w = sparse[name].numpy()
        gap = np.abs(np.abs(w[diff] - cb[got[diff]]) - np.abs(w[diff] - cb[want[diff]]))
        assert (gap <= 2 * CB_TOL).all() and diff.mean() < 1e-3, name
    name, cw = next(iter(t["packed"].items()))
    bits = storage_bits(tuple(cw.indices.shape), ClusteringConfig(num_clusters=64))
    assert bits == jcl.storage_bits(j["packed"][name].indices.shape, jcl.ClusteringConfig(64))


def test_greedy_tokens_match_jax_dense_and_clustered(pipeline):
    j, t = pipeline
    assert t["dense_out"].shape == (2, NEW)
    np.testing.assert_array_equal(t["dense_out"], j["dense_out"])
    np.testing.assert_array_equal(t["sonic_out"], j["sonic_out"])
    assert tree_param_count(t["params"]) == jax_tree_param_count(j["params"])


def test_full_model_pricing_matches_jax():
    got = evaluate_all(lm_workload(get_config("tinyllama-1.1b"), 0.5, 0.5))
    want = jax_evaluate_all(jax_lm_workload(jax_get_arch("tinyllama-1.1b").cfg, 0.5, 0.5))
    assert {k: (r.fps, r.power_w, r.epb) for k, r in got.items()} == \
        {k: (r.fps, r.power_w, r.epb) for k, r in want.items()}
