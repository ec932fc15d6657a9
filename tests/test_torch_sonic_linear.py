"""The port's execution-mode layer (``sonic_linear_apply`` / ``convert_linear``)
held against the JAX package's, in all eight modes.

The weights are converted once by the JAX package and carried across with
``convert.linear_params_from_jax``, so both sides apply the same numbers
and the comparison does not lean on the two k-means agreeing bit for bit.
With ``use_kernel=True`` the JAX side runs its Pallas kernels in interpret
mode and the port its kernels' plain versions (CPU tensors); with
``use_kernel=False`` both run the reference's fallbacks, in x's type.
Tolerances: fp32 within 2e-5 (only the order of fp32 sums differs); bf16 at
``tests/test_kernels.py``'s bf16 bound (rtol 2e-2, atol 2e-1: the fallbacks
multiply in bf16, and bf16 rounds at other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sonic_layers as jsl
from repro.models.registry import get_arch as jax_get_arch
from repro_torch.convert import linear_params_from_jax
from repro_torch.core import sonic_layers as tsl

MODES = ["dense", "masked", "topk", "clustered", "block_sparse", "sonic",
         "block_sparse_int8", "sonic_int8"]
K, N = 256, 192
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
KW = dict(weight_sparsity=0.5, block=(32, 64), num_clusters=16)


def _configs(mode, use_kernel, **kw):
    jc = jsl.SonicExecutionConfig(mode=mode, use_kernel=use_kernel, **{**KW, **kw})
    return jc, tsl.SonicExecutionConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def converted():
    """{mode: (JAX params, the port's carried-across params)} for one weight."""
    w = np.random.default_rng(0).standard_normal((K, N)).astype(np.float32)
    out = {}
    for mode in MODES:
        jp = jsl.convert_linear(jnp.asarray(w), _configs(mode, False)[0])
        out[mode] = jp, linear_params_from_jax(jax.tree_util.tree_map(np.array, jp), "cpu")
    return w, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_sonic_linear_apply_matches_jax(converted, mode, use_kernel, dtype):
    _, params = converted
    jp, tp = params[mode]
    jc, tc = _configs(mode, use_kernel)
    for shape in [(2, 1, K), (4, 16, K)]:
        x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
        want = jsl.sonic_linear_apply(jp, jnp.asarray(x).astype(JDTYPE[dtype]), jc)
        got = tsl.sonic_linear_apply(tp, torch.from_numpy(x).to(dtype), tc)
        assert got.dtype == dtype and got.shape == (*shape[:-1], N)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   **TOL[dtype])


@pytest.mark.parametrize("mode", ["clustered", "block_sparse", "sonic", "block_sparse_int8"])
def test_convert_linear_matches_jax(converted, mode):
    """The port's own conversion of the same weight gives the reference's
    formats (tie-free data: equal ids, blocks and indices)."""
    w, params = converted
    jp, carried = params[mode]
    got = tsl.convert_linear(torch.from_numpy(w), _configs(mode, False)[1])
    if mode == "clustered":
        np.testing.assert_allclose(got.clustered.codebook.numpy(),
                                   carried.clustered.codebook.numpy(), rtol=0, atol=1e-5)
        assert torch.equal(got.clustered.indices, carried.clustered.indices)
    elif mode == "block_sparse":
        assert torch.equal(got.block_sparse.values, carried.block_sparse.values)
        assert torch.equal(got.block_sparse.indices, carried.block_sparse.indices)
        assert got.block_sparse.dense_shape == (K, N)
    elif mode == "sonic":
        sw, want = got.sonic, carried.sonic
        assert sw.idx_values.dtype == torch.int8 and sw.k_blocks == want.k_blocks
        assert torch.equal(sw.idx_values, want.idx_values)
        assert torch.equal(sw.indices, want.indices)
        np.testing.assert_allclose(sw.codebook.numpy(), want.codebook.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(sw.dense().numpy(), np.asarray(jp.sonic.dense()),
                                   rtol=0, atol=1e-5)
    else:
        assert torch.equal(got.block_sparse_int8.values, carried.block_sparse_int8.values)
        assert torch.equal(got.block_sparse_int8.indices, carried.block_sparse_int8.indices)


def test_unknown_mode_raises(converted):
    with pytest.raises(ValueError, match="unknown mode"):
        tsl.sonic_linear_apply(converted[1]["dense"][1], torch.zeros(2, K),
                               tsl.SonicExecutionConfig(mode="photonic"))


def test_reduced_tinyllama_every_projection_in_sonic_mode():
    """Every projection of reduced tinyllama (2 layers × q, k, v, o, wi, wg,
    wo, and the LM head) converted by each package itself into mode "sonic"
    at (16, 16) blocks, then applied through the kernels (interpret-mode
    Pallas; the port's plain versions) at decode and prefill rows, fp32."""
    arch = jax_get_arch("tinyllama-1.1b", reduced=True)
    raw = jax.tree_util.tree_map(np.array, arch.init_params(jax.random.PRNGKey(0)))
    ws = [layer["kernel"][i] for blk in ("attn", "ffn") for layer in raw["layers"][blk].values()
          for i in range(layer["kernel"].shape[0])]
    ws.append(raw["lm_head"]["kernel"])
    assert len(ws) == 2 * 7 + 1
    jc, tc = _configs("sonic", True, block=(16, 16), num_clusters=64)
    rng = np.random.default_rng(2)
    for w in ws:
        jp = jsl.convert_linear(jnp.asarray(w), jc)
        tp = tsl.convert_linear(torch.from_numpy(w), tc)
        assert torch.equal(tp.sonic.indices, torch.from_numpy(np.array(jp.sonic.indices)))
        for rows in (2, 12):
            x = rng.standard_normal((rows, 1, w.shape[0])).astype(np.float32)
            want = np.asarray(jsl.sonic_linear_apply(jp, jnp.asarray(x), jc))
            got = tsl.sonic_linear_apply(tp, torch.from_numpy(x), tc)
            np.testing.assert_allclose(got.numpy(), want, **TOL[torch.float32])


@pytest.mark.parametrize("mode", ["clustered", "block_sparse", "sonic", "block_sparse_int8",
                                  "sonic_int8"])
def test_kernel_modes_off_the_cpu_launch_or_raise(converted, mode):
    """With ``use_kernel=True`` a tensor that is not on the CPU goes to the
    kernel launch (which raises here, with no card) and never to a plain
    version."""
    jp, _ = converted[1][mode]
    params = linear_params_from_jax(jax.tree_util.tree_map(np.array, jp), "meta")
    _, tc = _configs(mode, True)
    for shape in [(2, 1, K), (4, 16, K)]:
        with pytest.raises(ValueError, match="CUDA"):
            tsl.sonic_linear_apply(params, torch.empty(shape, device="meta"), tc)


@pytest.mark.parametrize("shape,k", [((64,), 16), ((3, 64), 16), ((2, 5, 64), 64), ((4, 64), 100)])
def test_activation_sparsity_matches_jax(shape, k):
    """Mode "topk"'s helpers on tie-free scores: the same shared columns,
    in the same (descending) order, as ``jax.lax.top_k``."""
    from repro.core import activation_sparsity as jas
    from repro_torch.core import activation_sparsity as tas

    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((64, 24)).astype(np.float32)
    want_v, want_i = jas.topk_compress(jnp.asarray(x), k)
    got_v, got_i = tas.topk_compress(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(tas.topk_activation_mask(torch.from_numpy(x), k).numpy(),
                                  np.asarray(jas.topk_activation_mask(jnp.asarray(x), k)))
    np.testing.assert_allclose(tas.sparse_ffn_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                                     k).numpy(),
                               np.asarray(jas.sparse_ffn_matmul(jnp.asarray(x), jnp.asarray(w), k)),
                               **TOL[torch.float32])
