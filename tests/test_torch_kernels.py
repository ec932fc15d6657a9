"""The port's int8 SONIC kernels held against the JAX package's.

On the CPU the port's kernel wrappers run their plain versions (gather,
dequantize, einsum); the JAX ops run their Pallas kernels in interpret mode
(``tests/conftest.py`` pins JAX to the CPU).  Both see the same ``values``,
``scales`` and ``indices`` arrays, made by the JAX converter from numpy
weights.  Tests marked ``cuda`` hold each CUDA kernel against its plain
version on the card, and skip without one.  JAX is imported by a fixture,
so that those run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sonic_layers import make_block_sparse_int8
from repro_torch.kernels import build
from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel
from repro_torch.kernels.block_sparse_matmul import ops as bs_ops
from repro_torch.kernels.block_sparse_matmul.ref import block_sparse_matmul_int8_ref
from repro_torch.kernels.sonic_matmul import kernel as sm_kernel
from repro_torch.kernels.sonic_matmul import ops as sm_ops
from repro_torch.kernels.sonic_matmul.ref import sonic_matvec_int8_ref

# fp32 on both sides; only the order of the fp32 sums differs (the same
# bound tests/test_kernels.py holds the Pallas kernels to)
TOL = dict(rtol=2e-5, atol=2e-5)
K, N = 256, 192
BLOCKS = [(16, 16), (32, 64), (64, 64)]
SPARSITIES = [0.0, 0.25, 0.5]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's converter and int8 kernel ops."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.sonic_layers import make_block_sparse_int8
    from repro.kernels.block_sparse_matmul.ops import block_sparse_matmul_int8
    from repro.kernels.sonic_matmul.ops import sonic_matvec_int8

    return dict(jnp=jnp, make=make_block_sparse_int8, matvec=sonic_matvec_int8,
                matmul=block_sparse_matmul_int8)


def _weights(jx, block, sparsity, seed=0):
    """JAX-converted int8 weight (for the JAX ops) and the same arrays as
    torch tensors (for the port)."""
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
    q = jx["make"](jx["jnp"].asarray(w), sparsity, block)
    arrays = [torch.from_numpy(np.array(a)) for a in (q.values, q.scales, q.indices)]
    return q, arrays


def _port_weights():
    """A (32, 64)-block int8 weight made by the port's own converter."""
    w = np.random.default_rng(0).standard_normal((K, N)).astype(np.float32)
    q = make_block_sparse_int8(torch.from_numpy(w), 0.5, (32, 64))
    return [q.values, q.scales, q.indices]


def _x(m, seed=1):
    return np.random.default_rng(seed).standard_normal((m, K)).astype(np.float32)


@pytest.mark.parametrize("sparsity", SPARSITIES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("m", [1, 3, 7])
def test_sonic_matvec_int8_matches_jax(jx, m, block, sparsity):
    q, arrays = _weights(jx, block, sparsity)
    x = _x(m)
    want = np.asarray(jx["matvec"](jx["jnp"].asarray(x), q))
    got = sm_ops.sonic_matvec_int8(torch.from_numpy(x), *arrays)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sparsity", SPARSITIES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("m", [8, 13, 64])
def test_block_sparse_matmul_int8_matches_jax(jx, m, block, sparsity):
    q, arrays = _weights(jx, block, sparsity)
    x = _x(m)
    want = np.asarray(jx["matmul"](jx["jnp"].asarray(x), q))
    got = bs_ops.block_sparse_matmul_int8(torch.from_numpy(x), *arrays)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m", [1, 7, 8, 13])
def test_plain_versions_match_densified_oracle(m):
    """The gather-einsum plain versions ≡ dequantize-densify-matmul."""
    arrays = _port_weights()
    x = torch.from_numpy(_x(m))
    want = block_sparse_matmul_int8_ref(x, *arrays, K // 32)
    got = sm_ops.sonic_matmul_int8(x, *arrays)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("shape", [(K,), (3, K)])
def test_sonic_matvec_int8_entry_shapes(shape):
    """The decode entry takes one row (K,) or a few (B, K), as the
    reference's does, and keeps x's type."""
    arrays = _port_weights()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    got = sm_ops.sonic_matvec_int8(x, *arrays)
    want = sonic_matvec_int8_ref(x, *arrays, K // 32)
    assert got.shape == want.shape == (*shape[:-1], N)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert sm_ops.sonic_matvec_int8(x.to(torch.bfloat16), *arrays).dtype == torch.bfloat16


@pytest.mark.parametrize("m", [3, 9])
def test_all_zero_weight_gives_exact_zeros(m):
    """All-zero blocks take scale 1.0 and int8 zeros, so the product is
    exactly 0.0, not accumulated rounding noise, through either kernel."""
    q = make_block_sparse_int8(torch.zeros(128, 128), 0.5, (32, 32))
    assert (q.scales == 1.0).all() and (q.values == 0).all()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((m, 128)).astype(np.float32))
    y = sm_ops.sonic_matmul_int8(x, q.values, q.scales, q.indices)
    assert y.shape == (m, 128) and (y == 0.0).all()


def test_decode_threshold_dispatch_counts_launches(monkeypatch):
    """Flattened M < DECODE_M_THRESHOLD goes to the matvec kernel, larger M
    to the matmul kernel.  A fake launcher records each call, so the real
    wrappers run their device branch and count their launches; the CPU
    path counts none."""
    assert sm_ops.DECODE_M_THRESHOLD == 8
    calls = []

    def fake_launch(name, x, values, scales, indices):
        calls.append((name, x.shape[0]))
        return torch.empty((x.shape[0], values.shape[0] * values.shape[3]), device=x.device)

    monkeypatch.setattr(build, "launch_int8", fake_launch)
    monkeypatch.setattr(sm_kernel.sonic_matvec_int8_kernel, "launches", 0)
    monkeypatch.setattr(bs_kernel.block_sparse_matmul_int8_kernel, "launches", 0)
    arrays = _port_weights()
    meta = [a.to("meta") for a in arrays]
    for lead in [(1,), (7,), (2, 3), (8,), (2, 1, 9)]:
        y = sm_ops.sonic_matmul_int8(torch.empty((*lead, K), device="meta"), *meta)
        assert y.shape == (*lead, N)
    assert calls == [("sonic_matvec_int8", 1), ("sonic_matvec_int8", 7),
                     ("sonic_matvec_int8", 6), ("block_sparse_matmul_int8", 8),
                     ("block_sparse_matmul_int8", 18)]
    assert sm_kernel.sonic_matvec_int8_kernel.launches == 3
    assert bs_kernel.block_sparse_matmul_int8_kernel.launches == 2
    sm_ops.sonic_matmul_int8(torch.from_numpy(_x(3)), *arrays)  # CPU: plain
    assert len(calls) == 5 and sm_kernel.sonic_matvec_int8_kernel.launches == 3


def test_non_cpu_tensor_without_card_raises():
    """A tensor that is not on the CPU launches the kernel or raises: it
    never falls back to the plain version."""
    arrays = _port_weights()
    meta = [a.to("meta") for a in arrays]
    for m in (2, 16):
        with pytest.raises(ValueError, match="CUDA"):
            sm_ops.sonic_matmul_int8(torch.empty((m, K), device="meta"), *meta)


def test_library_name_follows_sources_and_build_needs_nvcc(monkeypatch, tmp_path):
    """An edited kernel source gets a new library (never a stale load), and
    without nvcc the build raises rather than running anything else."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.glob("*.cu"):
        (csrc / src.name).write_text(src.read_text())
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    before = build.library_path()
    assert before == build.library_path() and before.parent == tmp_path / "build"
    (csrc / "sonic_matvec_int8.cu").write_text("// edited\n")
    assert build.library_path() != before
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


# ------------------------------------------------------ on the card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_weight(k, n, block, sparsity, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=device)
    q = make_block_sparse_int8(w, sparsity, block)
    return q.values, q.scales, q.indices


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [(1, 1), (2, 8), (16, 16), (32, 64), (128, 128), (128, 4)])
@pytest.mark.parametrize("m", [1, 4, 7, 8, 65, 257])
def test_cuda_kernel_matches_plain(cuda, m, block, dtype):
    k, n = 512, 256
    w = _cuda_weight(k, n, block, 0.5, cuda)
    x = torch.randn((m, k), device=cuda).to(dtype)
    fn = (sm_kernel.sonic_matvec_int8_kernel if m < sm_ops.DECODE_M_THRESHOLD
          else bs_kernel.block_sparse_matmul_int8_kernel)
    plain = (sm_kernel.sonic_matvec_int8_plain if m < sm_ops.DECODE_M_THRESHOLD
             else bs_kernel.block_sparse_matmul_int8_plain)
    got = fn(x, *w)
    torch.cuda.synchronize()
    # fp32 both; the sums run in another order over up to 512 terms
    torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernels_zero_deterministic_and_row_stable(cuda):
    k, n = 1024, 512
    zero = make_block_sparse_int8(torch.zeros((k, n), device=cuda), 0.5, (128, 128))
    x = torch.randn((300, k), device=cuda, dtype=torch.bfloat16)
    for m in (3, 300):
        y = sm_ops.sonic_matmul_int8(x[:m], zero.values, zero.scales, zero.indices)
        assert (y == 0).all()
    w = _cuda_weight(k, n, (128, 128), 0.5, cuda)
    a = bs_kernel.block_sparse_matmul_int8_kernel(x, *w)
    assert torch.equal(a, bs_kernel.block_sparse_matmul_int8_kernel(x, *w))
    # a row's result does not depend on M (no split-K, fixed order)
    assert torch.equal(a[:9], bs_kernel.block_sparse_matmul_int8_kernel(x[:9].contiguous(), *w))
    v = sm_kernel.sonic_matvec_int8_kernel(x[:5].contiguous(), *w)
    assert torch.equal(v, sm_kernel.sonic_matvec_int8_kernel(x[:5].contiguous(), *w))
