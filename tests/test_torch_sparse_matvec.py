"""The port's compressed sparse matvec (C3) held against the JAX package's.

On the CPU the port's kernel wrapper runs its plain version (gather the
rows idx names, contract in fp32); the JAX ops run their Pallas kernel in
interpret mode (``tests/conftest.py`` pins JAX to the CPU).  Inputs are made
with numpy from a seed and handed to both.  fp32 on both sides; only the
order of the fp32 sums differs, so results are held to 2e-5 (the bound
``tests/test_kernels.py`` holds the Pallas kernel to).  The kernel on the
card is held to its plain version in ``tests/test_torch_kernels.py``
(marked ``cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sparse_matvec.ops import sparse_matvec as jax_sparse_matvec
from repro.kernels.sparse_matvec.ops import topk_sparse_matmul as jax_topk_sparse_matmul
from repro.kernels.sparse_matvec.ref import sparse_matvec_ref as jax_sparse_matvec_ref
from repro_torch.kernels import build
from repro_torch.kernels.sparse_matvec import kernel as smv_kernel
from repro_torch.kernels.sparse_matvec import ops
from repro_torch.kernels.sparse_matvec.ref import sparse_matvec_ref

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(b, k, n, knz, seed=0, x_shape=None):
    rng = np.random.default_rng(seed)
    wt = rng.standard_normal((k, n)).astype(np.float32)
    idx = np.sort(rng.permutation(k)[:knz]).astype(np.int32)
    x = rng.standard_normal(x_shape or (b, knz)).astype(np.float32)
    return x, idx, wt


def _both(fn_jax, fn_port, *arrays, **kw):
    want = np.asarray(fn_jax(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_port(*(torch.from_numpy(a) for a in arrays), **kw)
    assert got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("b,k,n,knz", [(1, 256, 512, 64), (4, 512, 1024, 100),
                                       (8, 128, 512, 128), (2, 256, 256, 1)])
def test_sparse_matvec_matches_jax(b, k, n, knz):
    got, want = _both(jax_sparse_matvec, ops.sparse_matvec, *_case(b, k, n, knz))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("b,k,n,knz", [
    (1, 100, 384, 1),  # one row of x, a single surviving activation, off-tile N
    (1, 64, 200, 64),  # every row kept (density 1), N % 128 != 0
    (3, 50, 96, 17),  # nothing a multiple of anything
])
def test_sparse_matvec_edge_shapes_match_jax(b, k, n, knz):
    got, want = _both(jax_sparse_matvec, ops.sparse_matvec, *_case(b, k, n, knz))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("x_shape", [(3, 1, 32), (32,)])
def test_sparse_matvec_decode_and_vector_inputs_match_jax(x_shape):
    """(B, 1, knz) decode activations flatten into kernel rows unpadded; a
    (knz,) vector comes back as (N,)."""
    got, want = _both(jax_sparse_matvec, ops.sparse_matvec,
                      *_case(0, 128, 256, 32, x_shape=x_shape))
    assert got.shape == (*x_shape[:-1], 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_sparse_matvec_ref_matches_jax_ref():
    got, want = _both(jax_sparse_matvec_ref, sparse_matvec_ref, *_case(4, 96, 160, 40))
    np.testing.assert_allclose(got, want, **TOL)


def test_sparse_matvec_keeps_x_dtype_and_plain_is_fp32():
    x, idx, wt = (torch.from_numpy(a) for a in _case(2, 64, 128, 16))
    assert ops.sparse_matvec(x.bfloat16(), idx, wt.bfloat16()).dtype == torch.bfloat16
    assert smv_kernel.sparse_matvec_plain(x.bfloat16(), idx, wt).dtype == torch.float32


def test_sparse_matvec_zero_rows_weights_and_no_rows_give_exact_zeros():
    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    idx = torch.arange(16, dtype=torch.int32)
    assert (ops.sparse_matvec(torch.zeros(2, 16), idx, wt) == 0).all()
    x = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    assert (ops.sparse_matvec(x, idx, torch.zeros(64, 128)) == 0).all()
    y = ops.sparse_matvec(torch.zeros(3, 0), torch.zeros(0, dtype=torch.int32), wt)
    assert y.shape == (3, 128) and (y == 0).all()


def test_topk_sparse_matmul_exact_on_sparse_input():
    """With k = the batch-union count of nonzero columns, the compressed
    product is x @ wt (held to 1e-4, as the reference's own test)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 256)).astype(np.float32) * (rng.random(256) < 0.3)
    wt = rng.standard_normal((256, 512)).astype(np.float32)
    k = int((x != 0).any(axis=0).sum())
    got, want = _both(jax_topk_sparse_matmul, ops.topk_sparse_matmul, x, wt, k=k)
    np.testing.assert_allclose(got, x @ wt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("frac", [0.0, 1.0])
def test_topk_sparse_matmul_density_extremes_match_jax(frac):
    """k = K is the dense product; k = 1 keeps the single largest column."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 96)).astype(np.float32)
    wt = rng.standard_normal((96, 160)).astype(np.float32)
    k = max(int(96 * frac), 1)
    got, want = _both(jax_topk_sparse_matmul, ops.topk_sparse_matmul, x, wt, k=k)
    np.testing.assert_allclose(got, want, **TOL)
    if frac == 1.0:
        np.testing.assert_allclose(got, x @ wt, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lead", [(6,), (2, 1), (2, 3)])
@pytest.mark.parametrize("kind", ["integer", "relu_90pct_zero"])
def test_topk_sparse_matmul_on_ties_matches_jax(lead, kind):
    """Inputs whose column scores tie at the boundary of the kept set (every
    zero column ties with every other): both pick the same columns."""
    rng = np.random.default_rng(3)
    d = 200
    if kind == "integer":
        x = np.maximum(rng.integers(-3, 3, (*lead, d)), 0).astype(np.float32)
    else:
        x = np.maximum(rng.standard_normal((*lead, d)), 0).astype(np.float32)
        x[..., rng.random(d) < 0.9] = 0
    wt = rng.standard_normal((d, 64)).astype(np.float32)
    nnz = int((x.reshape(-1, d) != 0).any(axis=0).sum())
    got, want = _both(jax_topk_sparse_matmul, ops.topk_sparse_matmul, x, wt, k=nnz + 7)
    np.testing.assert_allclose(got, want, **TOL)
    got, want = _both(jax_topk_sparse_matmul, ops.topk_sparse_matmul, x, wt, k=max(nnz - 3, 1))
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_counts_launches_only_off_the_cpu(monkeypatch):
    """A fake launcher records each call, so the wrapper runs its device
    branch and counts; the CPU path counts nothing."""
    calls = []

    def fake(x_nz, idx, wt):
        calls.append(tuple(x_nz.shape))
        return torch.empty((x_nz.shape[0], wt.shape[1]), device=x_nz.device)

    monkeypatch.setattr(build, "launch_sparse_matvec", fake)
    monkeypatch.setattr(smv_kernel.sparse_matvec_kernel, "launches", 0)
    wt = torch.empty((64, 40), device="meta")
    idx = torch.empty((16,), dtype=torch.int32, device="meta")
    for shape in [(16,), (3, 16), (2, 1, 16)]:
        y = ops.sparse_matvec(torch.empty(shape, device="meta"), idx, wt)
        assert y.shape == (*shape[:-1], 40)
    assert calls == [(1, 16), (3, 16), (2, 16)]
    assert smv_kernel.sparse_matvec_kernel.launches == 3
    ops.sparse_matvec(torch.zeros(2, 16), torch.arange(16, dtype=torch.int32),
                      torch.zeros(64, 40))
    assert smv_kernel.sparse_matvec_kernel.launches == 3 and len(calls) == 3


def test_raises_off_the_cpu_without_a_card():
    """A tensor that is not on the CPU launches the kernel or raises: it
    never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        ops.sparse_matvec(torch.empty((2, 16), device="meta"),
                          torch.empty((16,), dtype=torch.int32, device="meta"),
                          torch.empty((64, 40), device="meta"))
