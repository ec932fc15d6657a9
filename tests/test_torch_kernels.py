"""The port's six SONIC kernels held against the JAX package's.

On the CPU the port's kernel wrappers run their plain versions (gather,
look up or dequantize, einsum); the JAX ops run their Pallas kernels in
interpret mode (``tests/conftest.py`` pins JAX to the CPU).  Both see the
same weight arrays, made by the JAX converters from numpy weights.  Tests
marked ``cuda`` hold each CUDA kernel against its plain version on the
card, and skip without one.  JAX is imported by fixtures, so that those run
where JAX is not installed:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.convert import linear_params_from_jax
from repro_torch.core.sonic_layers import make_block_sparse_int8
from repro_torch.kernels import build
from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel
from repro_torch.kernels.block_sparse_matmul import ops as bs_ops
from repro_torch.kernels.block_sparse_matmul.ref import block_sparse_matmul_int8_ref
from repro_torch.kernels.clustered_matmul import kernel as cm_kernel
from repro_torch.kernels.clustered_matmul import ops as cm_ops
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


# ------------------------------------- the codebook and fp kernels (CPU)
#
# The four kernels of the execution-mode layer: block_sparse_matmul (fp
# values), sonic_matvec / sonic_matmul (cluster ids + codebook, block
# sparse) and clustered_matmul (dense cluster ids).  Their weights (normal
# draws scaled by K**-0.5, as the models initialise them) are made by the
# JAX converters and carried across; the JAX ops run their Pallas kernels in
# interpret mode.  Shapes and edges follow tests/test_kernels.py, with
# M = 1 and 7, off-tile K and N, and sparsity 0 to 1.0.  fp32 within 2e-5;
# bf16 at tests/test_kernels.py's bf16 bound.

JTOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}


@pytest.fixture(scope="module")
def jk():
    """The JAX package's converters and the ops of its four kernels."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core.clustering import ClusteringConfig, pack_clustered
    from repro.core.sonic_layers import SonicLinearParams, make_block_sparse
    from repro.kernels.block_sparse_matmul.ops import block_sparse_matmul
    from repro.kernels.clustered_matmul.ops import clustered_matmul
    from repro.kernels.sonic_matmul.ops import make_sonic_weight, sonic_matmul, sonic_matvec

    def carry(**weight):
        """One JAX weight carried across by ``convert.linear_params_from_jax``."""
        (field, _), = weight.items()
        params = jax.tree_util.tree_map(np.array, SonicLinearParams(**weight))
        return getattr(linear_params_from_jax(params, "cpu"), field)

    @functools.cache
    def make_sonic(k, n, sp, block, c):
        w = jnp.asarray(_np((k, n), 0) * k**-0.5)
        return make_sonic_weight(w, sparsity=sp, block=block, num_clusters=c)

    return dict(jnp=jnp, carry=carry, make_bs=make_block_sparse, bs=block_sparse_matmul,
                make_sonic=make_sonic, sonic=sonic_matmul, matvec=sonic_matvec,
                pack=lambda w, c: pack_clustered(w, ClusteringConfig(num_clusters=c)),
                clustered=clustered_matmul)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_x(jk, x):
    """x as a JAX array of the same type (bf16 values are exact in fp32)."""
    jnp = jk["jnp"]
    return jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,block,sp", [
    (8, 256, 128, (64, 64), 0.5),
    (16, 512, 256, (128, 128), 0.75),
    (8, 128, 256, (64, 128), 0.0),
    (3, 256, 128, (128, 64), 0.25),
    (1, 192, 320, (64, 64), 0.95),
    (7, 96, 128, (32, 64), 1.0),
])
def test_block_sparse_matmul_matches_jax(jk, m, k, n, block, sp, dtype):
    bw = jk["make_bs"](jk["jnp"].asarray(_np((k, n), 0) * k**-0.5), sp, block)
    x = torch.from_numpy(_np((m, k), 1)).to(dtype)
    want = jk["bs"](_jax_x(jk, x), bw, bm=8)
    got = bs_ops.block_sparse_matmul(x, jk["carry"](block_sparse=bw), bm=8)
    assert got.dtype == dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **JTOL[dtype])


@pytest.mark.parametrize("m", [1, 2, 7, 8, 13])
@pytest.mark.parametrize("sp,c", [(0.5, 64), (0.75, 16), (0.0, 8), (1.0, 16)])
def test_sonic_matmul_matches_jax(jk, sp, c, m):
    """Decode rows (M < 8, the matvec) and tiled rows, fp32."""
    sw = jk["make_sonic"](256, 128, sp, (64, 64), c)
    x = _np((m, 256), m)
    want = np.asarray(jk["sonic"](jk["jnp"].asarray(x), sw, bm=8))
    got = sm_ops.sonic_matmul(torch.from_numpy(x), jk["carry"](sonic=sw), bm=8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k,n,block", [(192, 320, (64, 64)), (96, 128, (32, 64)),
                                       (128, 384, (64, 128))])
@pytest.mark.parametrize("sp", [0.0, 0.95])
def test_sonic_matvec_m1_offblock_shapes_match_jax(jk, k, n, block, sp):
    sw = jk["make_sonic"](k, n, sp, block, 16)
    for shape in [(k,), (3, k)]:
        x = _np(shape, 1)
        want = np.asarray(jk["matvec"](jk["jnp"].asarray(x), sw))
        got = sm_ops.sonic_matvec(torch.from_numpy(x), jk["carry"](sonic=sw))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,c", [(8, 128, 128, 8), (16, 256, 256, 64), (32, 512, 128, 16),
                                     (5, 256, 384, 64), (1, 128, 256, 200), (7, 96, 40, 4)])
def test_clustered_matmul_matches_jax(jk, m, k, n, c, dtype):
    cw = jk["pack"](jk["jnp"].asarray(_np((k, n), 0) * k**-0.5), c)
    port = jk["carry"](clustered=cw)
    ids, codebook = port.indices, port.codebook
    assert ids.dtype == (torch.int8 if c <= 128 else torch.int32)
    x = torch.from_numpy(_np((m, k), 1)).to(dtype)
    want = jk["clustered"](_jax_x(jk, x), cw.indices, cw.codebook, bm=8, bn=128, bk=128)
    got = cm_ops.clustered_matmul(x, ids, codebook, bn=128, bk=128)
    assert got.dtype == dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **JTOL[dtype])


def test_new_plain_versions_match_densified_oracles():
    """The gather-einsum plain versions ≡ look-up-densify-matmul in fp32."""
    from repro_torch.kernels.block_sparse_matmul.ref import block_sparse_matmul_ref
    from repro_torch.kernels.clustered_matmul.ref import clustered_matmul_ref
    from repro_torch.kernels.sonic_matmul.ref import sonic_matmul_ref, sonic_matvec_ref

    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 16, (3, 4, 32, 64), generator=gen, dtype=torch.int8)
    codebook = torch.randn(16, generator=gen)
    indices = torch.tensor([[0, 2, 5, 7], [1, 2, 3, 4], [0, 1, 6, 7]], dtype=torch.int32)
    values = torch.randn(ids.shape, generator=gen)
    dense_ids = torch.randint(0, 16, (K, N), generator=gen, dtype=torch.int8)
    for m in (1, 7, 9):
        x = torch.randn((m, K), generator=gen)
        for fn in (sm_kernel.sonic_matvec_plain, sm_kernel.sonic_matmul_plain):
            np.testing.assert_allclose(fn(x, ids, codebook, indices).numpy(),
                                       sonic_matmul_ref(x, ids, codebook, indices, 8).numpy(),
                                       **TOL)
        np.testing.assert_allclose(bs_kernel.block_sparse_matmul_plain(x, values, indices).numpy(),
                                   block_sparse_matmul_ref(x, values, indices, 8).numpy(), **TOL)
        np.testing.assert_allclose(cm_kernel.clustered_matmul_plain(x, dense_ids, codebook).numpy(),
                                   clustered_matmul_ref(x, dense_ids, codebook).numpy(), **TOL)
    assert sonic_matvec_ref(x[0], ids, codebook, indices, 8).shape == (192,)


def test_new_kernels_zero_rows_and_weights_give_exact_zeros():
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 16, (3, 4, 32, 64), generator=gen, dtype=torch.int8)
    codebook = torch.randn(16, generator=gen)
    indices = torch.tensor([[0, 2, 5, 7]] * 3, dtype=torch.int32)
    sw = sm_ops.SonicWeight(ids, codebook, indices, 8)
    zero_sw = sm_ops.SonicWeight(ids, torch.zeros(16), indices, 8)
    x = torch.randn((2, K), generator=gen)
    assert (sm_ops.sonic_matvec(torch.zeros(2, K), sw) == 0).all()
    assert (sm_ops.sonic_matmul(x, zero_sw) == 0).all()
    assert (sm_ops.sonic_matmul(torch.randn(9, K), zero_sw) == 0).all()
    from repro_torch.core.sonic_layers import BlockSparseWeight

    zero_bs = BlockSparseWeight(torch.zeros(ids.shape), indices, 8)
    assert (bs_ops.block_sparse_matmul(x, zero_bs) == 0).all()
    assert (cm_ops.clustered_matmul(x, torch.zeros((K, N), dtype=torch.int8),
                                    torch.zeros(4)) == 0).all()


def test_new_ops_dispatch_and_count_launches(monkeypatch):
    """sonic_matmul sends flattened M < 8 to the matvec kernel and larger M
    to the tiled kernel; block_sparse_matmul and clustered_matmul send every
    M to their kernel.  Fake launchers record each call, so the wrappers run
    their device branch and count; the CPU path counts nothing."""
    calls = []

    def fake_codebook(name, x, idx_values, codebook, indices):
        calls.append((name, x.shape[0]))
        return torch.empty((x.shape[0], idx_values.shape[0] * idx_values.shape[3]),
                           device=x.device)

    def fake_fp(x, values, indices):
        calls.append(("block_sparse_matmul", x.shape[0]))
        return torch.empty((x.shape[0], values.shape[0] * values.shape[3]), device=x.device)

    def fake_clustered(x, ids, codebook):
        calls.append(("clustered_matmul", x.shape[0]))
        return torch.empty((x.shape[0], ids.shape[1]), device=x.device)

    monkeypatch.setattr(build, "launch_codebook", fake_codebook)
    monkeypatch.setattr(build, "launch_fp", fake_fp)
    monkeypatch.setattr(build, "launch_clustered", fake_clustered)
    for fn in (sm_kernel.sonic_matvec_kernel, sm_kernel.sonic_matmul_kernel,
               bs_kernel.block_sparse_matmul_kernel, cm_kernel.clustered_matmul_kernel):
        monkeypatch.setattr(fn, "launches", 0)
    from repro_torch.core.sonic_layers import BlockSparseWeight

    ids = torch.empty((3, 4, 32, 64), dtype=torch.int8, device="meta")
    indices = torch.empty((3, 4), dtype=torch.int32, device="meta")
    sw = sm_ops.SonicWeight(ids, torch.empty(16, device="meta"), indices, 8)
    bw = BlockSparseWeight(torch.empty(ids.shape, device="meta"), indices, 8)
    for lead in [(1,), (2, 3), (8,), (2, 1, 9)]:
        x = torch.empty((*lead, K), device="meta")
        assert sm_ops.sonic_matmul(x, sw).shape == (*lead, N)
        assert bs_ops.block_sparse_matmul(x, bw).shape == (*lead, N)
        assert cm_ops.clustered_matmul(x, torch.empty((K, 40), dtype=torch.int8, device="meta"),
                                       torch.empty(8, device="meta")).shape == (*lead, 40)
    kinds = [name for name, _ in calls]
    assert kinds[0::3] == ["sonic_matvec", "sonic_matvec", "sonic_matmul", "sonic_matmul"]
    assert set(kinds[1::3]) == {"block_sparse_matmul"} and set(kinds[2::3]) == {"clustered_matmul"}
    assert [m for _, m in calls[0::3]] == [1, 6, 8, 18]
    assert sm_kernel.sonic_matvec_kernel.launches == 2
    assert sm_kernel.sonic_matmul_kernel.launches == 2
    assert bs_kernel.block_sparse_matmul_kernel.launches == 4
    assert cm_kernel.clustered_matmul_kernel.launches == 4
    sm_ops.sonic_matmul(torch.zeros(3, K), sm_ops.SonicWeight(
        torch.zeros((3, 4, 32, 64), dtype=torch.int8), torch.zeros(16),
        torch.zeros((3, 4), dtype=torch.int32), 8))  # CPU: plain, not counted
    assert len(calls) == 12 and sm_kernel.sonic_matvec_kernel.launches == 2


def test_new_kernels_raise_off_the_cpu_without_a_card():
    """A tensor that is not on the CPU launches the kernel or raises: it
    never falls back to the plain version."""
    from repro_torch.core.sonic_layers import BlockSparseWeight

    ids = torch.empty((3, 4, 32, 64), dtype=torch.int8, device="meta")
    indices = torch.empty((3, 4), dtype=torch.int32, device="meta")
    sw = sm_ops.SonicWeight(ids, torch.empty(16, device="meta"), indices, 8)
    for m in (2, 16):
        x = torch.empty((m, K), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            sm_ops.sonic_matmul(x, sw)
        with pytest.raises(ValueError, match="CUDA"):
            bs_ops.block_sparse_matmul(x, BlockSparseWeight(ids.float(), indices, 8))
        with pytest.raises(ValueError, match="CUDA"):
            cm_ops.clustered_matmul(x, torch.empty((K, N), dtype=torch.int8, device="meta"),
                                    torch.empty(8, device="meta"))


def test_ops_keep_the_references_shape_checks():
    with pytest.raises(ValueError, match="tiles"):  # K = 640 is not a multiple of bk = 512
        cm_ops.clustered_matmul(torch.zeros(2, 640), torch.zeros((640, 128), dtype=torch.int8),
                                torch.zeros(4))
    from repro_torch.core.sonic_layers import BlockSparseWeight

    bw = BlockSparseWeight(torch.zeros(3, 4, 32, 64), torch.zeros((3, 4), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="K=128"):
        bs_ops.block_sparse_matmul(torch.zeros(2, 128), bw)


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


def _cuda_codebook_weight(k, n, block, sparsity, device, c=64, seed=0):
    """Kept-block cluster ids (uniform over the codebook) beside an int8
    weight's block structure, and a random codebook."""
    gen = torch.Generator(device=device).manual_seed(seed)
    _, _, indices = _cuda_weight(k, n, block, sparsity, device, seed)
    nb, r = indices.shape
    ids = torch.randint(0, c, (nb, r, *block), generator=gen, device=device).to(torch.int8)
    return ids, torch.randn((c,), generator=gen, device=device), indices


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [(1, 1), (2, 8), (16, 16), (32, 64), (128, 128), (128, 4)])
@pytest.mark.parametrize("m", [1, 4, 7, 8, 65, 257])
def test_cuda_codebook_and_fp_kernels_match_plain(cuda, m, block, dtype):
    """sonic_matvec (M < 8), sonic_matmul (any M) and block_sparse_matmul
    (fp32 and bf16 values, any M) against their plain versions."""
    k, n = 512, 256
    x = torch.randn((m, k), device=cuda).to(dtype)
    ids, codebook, indices = _cuda_codebook_weight(k, n, block, 0.5, cuda)
    cases = [(sm_kernel.sonic_matmul_kernel, sm_kernel.sonic_matmul_plain,
              (ids, codebook, indices))]
    if m < sm_ops.DECODE_M_THRESHOLD:
        cases.append((sm_kernel.sonic_matvec_kernel, sm_kernel.sonic_matvec_plain,
                      (ids, codebook, indices)))
    gen = torch.Generator(device=cuda).manual_seed(1)
    for vdtype in (torch.float32, torch.bfloat16):
        values = torch.randn(ids.shape, generator=gen, device=cuda).to(vdtype)
        cases.append((bs_kernel.block_sparse_matmul_kernel, bs_kernel.block_sparse_matmul_plain,
                      (values, indices)))
    for fn, plain, w in cases:
        got = fn(x, *w)
        torch.cuda.synchronize()
        # fp32 both; the sums run in another order over up to 512 terms
        torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ids_dtype,c", [(torch.int8, 64), (torch.int8, 128), (torch.int32, 1000)])
@pytest.mark.parametrize("k,n", [(512, 256), (96, 40), (1024, 2048), (7, 3)])
@pytest.mark.parametrize("m", [1, 4, 8, 65, 257])
def test_cuda_clustered_matmul_matches_plain(cuda, m, k, n, ids_dtype, c):
    gen = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, c, (k, n), generator=gen, device=cuda).to(ids_dtype)
    codebook = torch.randn((c,), generator=gen, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        got = cm_kernel.clustered_matmul_kernel(x, ids, codebook)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, cm_kernel.clustered_matmul_plain(x, ids, codebook),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_new_kernels_zero_deterministic_and_row_stable(cuda):
    """All-zero weights give exact zeros; two runs agree bit for bit; a row's
    result does not depend on M (no split-K, fixed order)."""
    k, n = 1024, 512
    x = torch.randn((300, k), device=cuda, dtype=torch.bfloat16)
    ids, codebook, indices = _cuda_codebook_weight(k, n, (128, 128), 0.5, cuda)
    values = torch.randn(ids.shape, device=cuda)
    dense_ids = torch.randint(0, 64, (k, n), device=cuda, dtype=torch.int8)
    runs = [
        (sm_kernel.sonic_matmul_kernel, (ids, codebook, indices),
         (ids, torch.zeros_like(codebook), indices)),
        (bs_kernel.block_sparse_matmul_kernel, (values, indices),
         (torch.zeros_like(values), indices)),
        (cm_kernel.clustered_matmul_kernel, (dense_ids, codebook),
         (dense_ids, torch.zeros_like(codebook))),
    ]
    for fn, w, zero in runs:
        a = fn(x, *w)
        assert torch.equal(a, fn(x, *w))
        for m in (1, 9, 40):
            assert torch.equal(a[:m], fn(x[:m].contiguous(), *w))
        assert (fn(x, *zero) == 0).all() and (fn(x[:3].contiguous(), *zero) == 0).all()
    v = sm_kernel.sonic_matvec_kernel(x[:5].contiguous(), ids, codebook, indices)
    assert torch.equal(v, sm_kernel.sonic_matvec_kernel(x[:5].contiguous(), ids, codebook,
                                                        indices))
    assert (sm_kernel.sonic_matvec_kernel(x[:5].contiguous(), ids, torch.zeros_like(codebook),
                                          indices) == 0).all()
