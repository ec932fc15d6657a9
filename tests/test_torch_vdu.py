"""The port's C4 VDU model held against the JAX package's.

``quantize_uniform`` is elementwise and must be bit for bit the reference's;
``photonic_forward`` without noise sums a row of products in another order,
so it is held within 1e-6 (rtol and atol; rows of up to 48 fp32 products
of magnitude ≤ 3).  With noise the two draw other numbers (a torch
Generator in place of a JAX key), so the error is checked by its moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vdu as jv
from repro_torch.core import vdu as tv


def _wx(seed=0, d_out=12, d_in=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d_out, d_in)).astype(np.float32),
            rng.standard_normal(d_in).astype(np.float32))


@pytest.mark.parametrize("bits", [2, 6, 8, 16])
def test_quantize_uniform_matches_jax(bits):
    w, x = _wx()
    for a in (w, x):
        np.testing.assert_array_equal(tv.quantize_uniform(torch.from_numpy(a), bits).numpy(),
                                      np.asarray(jv.quantize_uniform(jnp.asarray(a), bits)))
    got = tv.quantize_uniform(torch.from_numpy(x), 6, x_max=2.0)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jv.quantize_uniform(jnp.asarray(x), 6, x_max=2.0)))


@pytest.mark.parametrize("clusters", [None, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_photonic_forward_without_noise_matches_jax(seed, clusters):
    w, x = _wx(seed)
    cb = None
    if clusters:  # centroids with exact ties between neighbours ruled out
        cb = np.sort(np.random.default_rng(9).standard_normal(clusters)).astype(np.float32)
    want = np.asarray(jv.photonic_forward(jnp.asarray(w), jnp.asarray(x), jv.VDUConfig(),
                                          None if cb is None else jnp.asarray(cb)))
    got = tv.photonic_forward(torch.from_numpy(w), torch.from_numpy(x), tv.VDUConfig(),
                              None if cb is None else torch.from_numpy(cb))
    assert got.shape == want.shape == (12,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_photonic_forward_noise_moments():
    """Multiplicative noise of std s on every product: the output error has
    mean ≈ 0 and std ≈ s·sqrt(Σ products²) per row."""
    w, x = _wx(0, d_out=2000, d_in=48)
    cfg, s = tv.VDUConfig(), 0.05
    w_t, x_t = torch.from_numpy(w), torch.from_numpy(x)
    clean = tv.photonic_forward(w_t, x_t, cfg)
    noisy = tv.photonic_forward(w_t, x_t, cfg, noise_std=s,
                                generator=torch.Generator().manual_seed(0))
    prod = tv.quantize_uniform(w_t, cfg.weight_bits) * tv.quantize_uniform(x_t, cfg.activation_bits)
    z = ((noisy - clean) / (s * prod.square().sum(-1).sqrt())).numpy()
    assert abs(z.mean()) < 0.1 and abs(z.std() - 1.0) < 0.1
    with pytest.raises(ValueError, match="Generator"):
        tv.photonic_forward(w_t, x_t, cfg, noise_std=s)
    # the reference's noise has the same moments
    jn = np.asarray(jv.photonic_forward(jnp.asarray(w), jnp.asarray(x), jv.VDUConfig(),
                                        noise_std=s, key=jax.random.PRNGKey(0)))
    zj = (jn - clean.numpy()) / (s * prod.square().sum(-1).sqrt().numpy())
    assert abs(zj.mean()) < 0.1 and abs(zj.std() - 1.0) < 0.1


def test_decomposition_matches_jax():
    for args in [(512, 147456, 50, 10), (10, 512, 5, 50), (1, 0, 50, 0)]:
        assert tv.decompose_matvec(*args) == jv.decompose_matvec(*args)
    tc, jc = tv.VDUConfig(), jv.VDUConfig()
    for vec_len, n in [(27, 1000), (0, 5), (1152, 9216)]:
        assert tc.conv_passes(vec_len, n) == jc.conv_passes(vec_len, n)
        assert tc.fc_passes(vec_len, n) == jc.fc_passes(vec_len, n)
