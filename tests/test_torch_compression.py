"""The port's C3 zero-compression dataflow held against the JAX package's.

The paper claims compression "does not impact the output vector calculation
accuracy": the compressed FC and conv products are held to the dense ones
(1e-5 for FC, 1e-4 for conv: fp32 sums over up to 48 and 18 terms in
another order), and the port's functions to the reference's on the same
numpy inputs (im2col bit for bit, the products within 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch.core import compression as tc


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("seed", range(8))
def test_fc_compression_exact(seed):
    rng = np.random.default_rng(seed)
    d_out, d_in = int(rng.integers(2, 33)), int(rng.integers(2, 49))
    w = _normal(rng, (d_out, d_in))
    x = _normal(rng, (d_in,)) * (rng.random(d_in) > rng.uniform(0.0, 0.95))
    c = tc.compress_fc(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(tc.compressed_fc_apply(c).numpy(), w @ x, rtol=1e-5, atol=1e-5)
    assert (c.x_nz != 0).all() and c.idx.dtype == torch.int32
    want = jc.compress_fc(w, x)
    np.testing.assert_array_equal(c.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(c.w_cols.numpy(), np.asarray(want.w_cols))
    np.testing.assert_allclose(tc.compressed_fc_apply(c).numpy(),
                               np.asarray(jc.compressed_fc_apply(want)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", range(6))
def test_static_k_exact_when_k_covers_nnz(seed):
    rng = np.random.default_rng(seed)
    w = _normal(rng, (16, 64))
    x = _normal(rng, (64,)) * (rng.random(64) > rng.uniform(0.2, 0.9))
    nnz = max(int((x != 0).sum()), 1)
    got = tc.compressed_fc_matvec(torch.from_numpy(w), torch.from_numpy(x), nnz).numpy()
    np.testing.assert_allclose(got, w @ x, rtol=1e-5, atol=1e-5)
    for k in (nnz, max(nnz // 2, 1)):  # k < nnz: the same top-k approximation
        want = np.asarray(jc.compressed_fc_matvec(jnp.asarray(w), jnp.asarray(x), k))
        np.testing.assert_allclose(tc.compressed_fc_matvec(torch.from_numpy(w),
                                                           torch.from_numpy(x), k).numpy(),
                                   want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0), (2, 1), (1, 0)])
def test_im2col_and_conv_match_jax(stride, padding):
    rng = np.random.default_rng(0)
    ifm, ker = _normal(rng, (9, 9, 3)), _normal(rng, (3, 3, 3, 5))
    np.testing.assert_array_equal(
        tc.im2col(torch.from_numpy(ifm), 3, 3, stride, padding).numpy(),
        np.asarray(jc.im2col(jnp.asarray(ifm), 3, 3, stride, padding)))
    got = tc.conv2d_via_im2col(torch.from_numpy(ifm), torch.from_numpy(ker), stride, padding)
    want = np.asarray(jc.conv2d_via_im2col(jnp.asarray(ifm), jnp.asarray(ker), stride, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_im2col_matches_lax_conv():
    rng = np.random.default_rng(0)
    ifm, ker = _normal(rng, (9, 9, 3)), _normal(rng, (3, 3, 3, 5))
    ours = tc.conv2d_via_im2col(torch.from_numpy(ifm), torch.from_numpy(ker), stride=1, padding=1)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(ifm)[None], jnp.asarray(ker), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", range(6))
def test_conv_compression_exact(seed):
    rng = np.random.default_rng(seed)
    ifm = _normal(rng, (6, 6, 2))
    ker = _normal(rng, (3, 3, 2, 4))
    ker = ker * (rng.random(ker.shape) > rng.uniform(0.0, 0.9))
    ifm_t, ker_t = torch.from_numpy(ifm), torch.from_numpy(ker)
    ref = tc.conv2d_via_im2col(ifm_t, ker_t, 1, 1)
    c = tc.compress_conv_patches(ifm_t, ker_t, 1, 1)
    np.testing.assert_allclose(tc.compressed_conv_apply(c, 6, 6).numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-4)
    want = jc.compress_conv_patches(ifm, ker, 1, 1)
    np.testing.assert_array_equal(c.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(c.patches.numpy(), np.asarray(want.patches))
    np.testing.assert_array_equal(c.kernel_rows.numpy(), np.asarray(want.kernel_rows))


def test_compression_stays_on_w_device_and_checks_shapes():
    w, x = torch.zeros(3, 5), torch.tensor([0.0, 1.0, 0.0, 2.0, 0.0])
    c = tc.compress_fc(w, x.numpy())
    assert c.idx.tolist() == [1, 3] and c.w_cols.device == w.device
    with pytest.raises(ValueError, match="shape mismatch"):
        tc.compress_fc(w, torch.zeros(4))
    with pytest.raises(ValueError, match="H, W, C"):
        tc.im2col(torch.zeros(4, 4), 3, 3)
