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
from repro_torch.core.sonic_layers import BlockSparseWeightInt8, make_block_sparse_int8
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
    """On the tensor-core route (bf16 x, (32, 64) blocks) flattened M <
    DECODE_M_THRESHOLD goes to the matvec kernel, larger M to the matmul
    kernel; off it (fp32 x) every M goes to the matmul kernel, whose rows
    do not depend on M.  A fake launcher records each call, so the real
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
        y = sm_ops.sonic_matmul_int8(
            torch.empty((*lead, K), device="meta", dtype=torch.bfloat16), *meta)
        assert y.shape == (*lead, N)
    assert calls == [("sonic_matvec_int8_mma", 1), ("sonic_matvec_int8_mma", 7),
                     ("sonic_matvec_int8_mma", 6), ("block_sparse_matmul_int8_mma", 8),
                     ("block_sparse_matmul_int8_mma", 18)]
    assert sm_kernel.sonic_matvec_int8_kernel.launches == 3
    assert bs_kernel.block_sparse_matmul_int8_kernel.launches == 2
    for m in (1, 7):  # fp32 x: the CUDA-core tiled matmul at every M
        sm_ops.sonic_matmul_int8(torch.empty((m, K), device="meta"), *meta)
    assert calls[5:] == [("block_sparse_matmul_int8", 1), ("block_sparse_matmul_int8", 7)]
    assert bs_kernel.block_sparse_matmul_int8_kernel.launches == 4
    sm_ops.sonic_matmul_int8(torch.from_numpy(_x(3)), *arrays)  # CPU: plain
    assert len(calls) == 7 and sm_kernel.sonic_matvec_int8_kernel.launches == 3


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
    """sonic_matmul sends flattened M < 8 of bf16 x (the tensor-core route)
    to the matvec kernel and larger M, and fp32 x at every M, to the tiled
    kernel; block_sparse_matmul and clustered_matmul send every M to their
    kernel.  Fake launchers record each call, so the wrappers run
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
        assert sm_ops.sonic_matmul(x.bfloat16(), sw).shape == (*lead, N)
        assert bs_ops.block_sparse_matmul(x, bw).shape == (*lead, N)
        assert cm_ops.clustered_matmul(x, torch.empty((K, 40), dtype=torch.int8, device="meta"),
                                       torch.empty(8, device="meta")).shape == (*lead, 40)
    kinds = [name for name, _ in calls]
    assert kinds[0::3] == ["sonic_matvec_mma", "sonic_matvec_mma", "sonic_matmul_mma",
                           "sonic_matmul_mma"]
    assert set(kinds[1::3]) == {"block_sparse_matmul"} and set(kinds[2::3]) == {"clustered_matmul"}
    assert [m for _, m in calls[0::3]] == [1, 6, 8, 18]
    assert sm_kernel.sonic_matvec_kernel.launches == 2
    assert sm_kernel.sonic_matmul_kernel.launches == 2
    assert bs_kernel.block_sparse_matmul_kernel.launches == 4
    assert cm_kernel.clustered_matmul_kernel.launches == 4
    sm_ops.sonic_matmul(torch.empty((1, K), device="meta"), sw)  # fp32 x: the tiled kernel
    assert calls[12] == ("sonic_matmul", 1) and sm_kernel.sonic_matmul_kernel.launches == 3
    sm_ops.sonic_matmul(torch.zeros(3, K), sm_ops.SonicWeight(
        torch.zeros((3, 4, 32, 64), dtype=torch.int8), torch.zeros(16),
        torch.zeros((3, 4), dtype=torch.int32), 8))  # CPU: plain, not counted
    assert len(calls) == 13 and sm_kernel.sonic_matvec_kernel.launches == 2


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


# ------------------------------------------- the compressed sparse matvec


def _cuda_sparse_case(b, k, n, knz, xdtype, wdtype, device, seed=0, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    wt = (torch.randn((k, n), generator=gen, device=device) * scale).to(wdtype)
    idx = torch.randperm(k, generator=gen, device=device)[:knz].sort().values.int()
    x = torch.randn((b, knz), generator=gen, device=device).to(xdtype)
    return x, idx, wt


# tinyllama-1.1b's five C3 projection shapes at knz = K / 4, B = 1, 4, 7, and
# STL10's fc0 (147,456 -> 512) at B = 4
SPARSE_MAIN = [(b, k, n, k // 4) for k, n in ((2048, 2048), (2048, 256), (2048, 5632),
                                               (5632, 2048), (2048, 32000)) for b in (1, 4, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,knz", [
    (1, 256, 512, 64), (4, 2048, 2048, 512), (4, 5632, 256, 1408), (7, 2048, 130, 65),
    (256, 96, 96, 7), (3, 50, 1, 17), (8, 128, 200, 128), (5, 64, 96, 1), (2, 64, 40, 0),
    *SPARSE_MAIN, (4, 147456, 512, 36864)])
def test_cuda_sparse_matvec_matches_plain(cuda, b, k, n, knz, xdtype, wdtype):
    """Each launch counted on its route: cp.async where the rows'
    segments start 16-byte aligned, plain loads elsewhere (N = 1, 130).
    STL10's fc0 has its layer's scale (K**-0.5), so that its 36,864-term
    sums stay where 1e-4 measures the order of the sums, not its length."""
    from repro_torch.kernels.sparse_matvec import kernel as smv_kernel

    x, idx, wt = _cuda_sparse_case(b, k, n, knz, xdtype, wdtype, cuda,
                                   scale=k**-0.5 if k == 147456 else 1.0)
    fn = smv_kernel.sparse_matvec_kernel
    fn.routes = dict.fromkeys(build.SMV_ROUTES, 0)
    got = fn(x, idx, wt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, n)
    route = build.ASYNC_COPY if n * wt.element_size() % 16 == 0 else build.CUDA_CORES
    assert fn.routes == {**dict.fromkeys(build.SMV_ROUTES, 0), route: 1}
    # fp32 both; the sums run in another order over up to 36,864 terms
    torch.testing.assert_close(got, smv_kernel.sparse_matvec_plain(x, idx, wt),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_topk_sparse_matmul_back_to_back(cuda):
    """20 whole C3 ops in a row on changing x, no synchronize between them:
    the kernel reads idx and x_nz, which the top-k, sort and gather ahead
    of it in the stream write, only after its grid dependency wait."""
    from repro_torch.core.activation_sparsity import sparse_ffn_matmul
    from repro_torch.kernels.sparse_matvec import kernel as smv_kernel
    from repro_torch.kernels.sparse_matvec import ops as smv_ops

    gen = torch.Generator(device=cuda).manual_seed(2)
    w = torch.randn((2048, 2048), generator=gen, device=cuda) * 2048**-0.5
    xs = [torch.randn((4, 1, 2048), generator=gen, device=cuda) for _ in range(20)]
    torch.cuda.synchronize()
    smv_kernel.sparse_matvec_kernel.launches = 0
    ys = [smv_ops.topk_sparse_matmul(x, w, 512) for x in xs]
    torch.cuda.synchronize()
    assert smv_kernel.sparse_matvec_kernel.launches == 20
    for x, y in zip(xs, ys):
        torch.testing.assert_close(y, sparse_ffn_matmul(x, w, 512), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_sparse_matvec_zero_deterministic_row_stable_and_unaligned(cuda):
    """Exact zeros from a zero weight, zero x or no kept rows; two runs agree
    bit for bit; a row's result does not depend on B (chunks fixed by knz);
    a weight that is not 16-byte aligned takes the CUDA-core route."""
    from repro_torch.kernels.sparse_matvec import kernel as smv_kernel
    from repro_torch.kernels.sparse_matvec import ops as smv_ops

    fn = smv_kernel.sparse_matvec_kernel
    x, idx, wt = _cuda_sparse_case(300, 2048, 1024, 700, torch.bfloat16, torch.bfloat16, cuda)
    assert (fn(x, idx, torch.zeros_like(wt)) == 0).all()
    assert (fn(torch.zeros_like(x), idx, wt) == 0).all()
    none = fn(x[:, :0].contiguous(), idx[:0], wt)
    assert none.shape == (300, 1024) and (none == 0).all()
    a = fn(x, idx, wt)
    assert torch.equal(a, fn(x, idx, wt))
    for m in (1, 3, 4, 9, 40):
        assert torch.equal(a[:m], fn(x[:m].contiguous(), idx, wt))
    flat = torch.empty(wt.numel() + 1, device=cuda, dtype=torch.float32)
    shifted = flat[1:].view(wt.shape)
    shifted.copy_(wt.float())
    assert shifted.data_ptr() % 16
    torch.testing.assert_close(fn(x[:4].contiguous(), idx, shifted), a[:4], rtol=1e-4,
                               atol=1e-4)
    # the whole C3 op is exact on an input with ≤ k nonzero columns
    gen = torch.Generator(device=cuda).manual_seed(1)
    xs = torch.randn((4, 2048), generator=gen, device=cuda)
    xs[:, torch.rand(2048, generator=gen, device=cuda) < 0.8] = 0
    k = int((xs != 0).any(0).sum())
    w = wt.float()[:, :512].contiguous()
    torch.testing.assert_close(smv_ops.topk_sparse_matmul(xs, w, k), xs @ w, rtol=1e-4,
                               atol=1e-4)


# ------------------------- the codebook matmuls' two routes (on the card)
#
# bf16 x takes the tensor-core kernel (csrc/block_mma.cuh) wherever its
# tiles fit, fp32 x and small blocks the CUDA-core tiled kernel; both are
# held to the plain versions at 1e-4 (fp32 both: the tensor-core route
# carries each centroid whole in three bf16 parts, so only the order of the
# fp32 sums differs), and the route counters say which one ran.

MAIN_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]


def _reset_routes(*fns):
    for fn in fns:
        fn.launches = 0
        fn.routes = dict.fromkeys(build.ROUTES, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MAIN_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 8, 65, 257])
def test_cuda_codebook_routes_match_plain_at_main_shapes(cuda, m, k, n):
    """sonic_matmul ((128, 128) blocks, sparsity 0.5, int8 ids, C 64 and
    128) and clustered_matmul (int8 ids with C 64 and 128, int32 ids with
    C 1000) against their plain versions, bf16 x on the tensor cores and
    fp32 x on the CUDA cores; centroids at the models' scale, K**-0.5
    (``test_cuda_tensor_core_route_at_unit_scale`` takes unit centroids)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    _reset_routes(sm_kernel.sonic_matmul_kernel, cm_kernel.clustered_matmul_kernel)
    _, _, indices = _cuda_weight(k, n, (128, 128), 0.5, cuda)
    cases = []
    for c in (64, 128):
        ids = torch.randint(0, c, (*indices.shape, 128, 128), generator=gen, device=cuda)
        cb = torch.randn((c,), generator=gen, device=cuda) * k**-0.5
        cases.append((sm_kernel.sonic_matmul_kernel, sm_kernel.sonic_matmul_plain,
                      (ids.to(torch.int8), cb, indices)))
    for ids_dtype, c in ((torch.int8, 64), (torch.int8, 128), (torch.int32, 1000)):
        ids = torch.randint(0, c, (k, n), generator=gen, device=cuda).to(ids_dtype)
        cb = torch.randn((c,), generator=gen, device=cuda) * k**-0.5
        cases.append((cm_kernel.clustered_matmul_kernel, cm_kernel.clustered_matmul_plain,
                      (ids, cb)))
    for fn, plain, w in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
            got = fn(x, *w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)
    want = {"tensor_cores": 2, "cuda_cores": 2}
    assert sm_kernel.sonic_matmul_kernel.routes == want
    assert cm_kernel.clustered_matmul_kernel.routes == {"tensor_cores": 3, "cuda_cores": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 2048])
@pytest.mark.parametrize("m", [8, 257])
def test_cuda_tensor_core_route_at_unit_scale(cuda, m, k):
    """Unit-scale centroids (outputs up to ~4·sqrt(K)) on the tensor-core
    route, 2048 columns, int8 and int32 ids: within 1e-4 of the plain
    version.  The tensor cores truncate as they add; each 64-row chunk is
    summed in a fresh tile and the chunks in fp32 on the CUDA cores."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    _reset_routes(cm_kernel.clustered_matmul_kernel)
    for ids_dtype, c in ((torch.int8, 128), (torch.int32, 1000)):
        ids = torch.randint(0, c, (k, 2048), generator=gen, device=cuda).to(ids_dtype)
        cb = torch.randn((c,), generator=gen, device=cuda)
        got = cm_kernel.clustered_matmul_kernel(x, ids, cb)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, cm_kernel.clustered_matmul_plain(x, ids, cb),
                                   rtol=1e-4, atol=1e-4)
    assert cm_kernel.clustered_matmul_kernel.routes["tensor_cores"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 2048, 5632])
@pytest.mark.parametrize("m", [8, 257])
def test_cuda_tensor_core_route_against_fp64_at_unit_scale(cuda, m, k):
    """The exact product (fp64) as the witness, unit-scale centroids, 2048
    columns, int8 and int32 ids, K up to tinyllama's 5632: the tensor-core
    route lies within 1e-4 of it, and its rms error is no larger than that
    of the plain version's fp32 GEMM.  (Against the plain version itself
    the two fp32 errors add, and miss 1e-4 on a few outputs at K = 5632.)"""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    _reset_routes(cm_kernel.clustered_matmul_kernel)
    for ids_dtype, c in ((torch.int8, 128), (torch.int32, 1000)):
        ids = torch.randint(0, c, (k, 2048), generator=gen, device=cuda).to(ids_dtype)
        cb = torch.randn((c,), generator=gen, device=cuda)
        exact = x.double() @ cb.double()[ids.long()]
        got = cm_kernel.clustered_matmul_kernel(x, ids, cb).double()
        plain = cm_kernel.clustered_matmul_plain(x, ids, cb).double()
        torch.testing.assert_close(got, exact, rtol=1e-4, atol=1e-4)
        rms = [(y - exact).pow(2).mean().sqrt().item() for y in (got, plain)]
        assert rms[0] <= rms[1], rms
    assert cm_kernel.clustered_matmul_kernel.routes["tensor_cores"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("block,route", [((16, 64), "tensor_cores"), ((32, 64), "tensor_cores"),
                                         ((64, 128), "tensor_cores"), ((16, 16), "cuda_cores"),
                                         ((128, 32), "cuda_cores"), ((8, 128), "cuda_cores")])
@pytest.mark.parametrize("m", [1, 4, 8, 65, 257])
def test_cuda_sonic_matmul_routes_by_block(cuda, m, block, route):
    """Every kept-block size the tensor cores take (bk a multiple of 16, bn
    of 64; chunks of min(bk, 64) K rows) and some they leave to the CUDA
    cores, bf16 x, against the plain version."""
    k, n = 512, 256
    ids, codebook, indices = _cuda_codebook_weight(k, n, block, 0.5, cuda)
    x = torch.randn((m, k), device=cuda, dtype=torch.bfloat16)
    _reset_routes(sm_kernel.sonic_matmul_kernel)
    got = sm_kernel.sonic_matmul_kernel(x, ids, codebook, indices)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sm_kernel.sonic_matmul_plain(x, ids, codebook, indices),
                               rtol=1e-4, atol=1e-4)
    assert sm_kernel.sonic_matmul_kernel.routes[route] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,route", [(1000, 192, "tensor_cores"), (8, 64, "tensor_cores"),
                                       (520, 3200, "tensor_cores"), (1001, 192, "cuda_cores"),
                                       (512, 96, "cuda_cores")])
@pytest.mark.parametrize("m", [1, 4, 8, 65, 257])
def test_cuda_clustered_matmul_routes_at_ragged_k(cuda, m, k, n, route):
    """K not a multiple of the 64-row chunk (the edge arrives as zeros), and
    shapes the tensor cores leave to the CUDA cores, bf16 x."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    ids = torch.randint(0, 128, (k, n), generator=gen, device=cuda).to(torch.int8)
    codebook = torch.randn((128,), generator=gen, device=cuda)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    _reset_routes(cm_kernel.clustered_matmul_kernel)
    got = cm_kernel.clustered_matmul_kernel(x, ids, codebook)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, cm_kernel.clustered_matmul_plain(x, ids, codebook),
                               rtol=1e-4, atol=1e-4)
    assert cm_kernel.clustered_matmul_kernel.routes[route] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 8192])
def test_cuda_tensor_core_route_deterministic_row_stable_and_zero(cuda, n):
    """On the tensor-core route two runs agree bit for bit, a row's result is
    the same at M = 1, 4, 8, 9, 40, 65, 128, 200, 257 and 300 (token tiles
    of 8 to 256, chosen from M and the column tiles), and an all-zero
    codebook gives exact zeros."""
    k = 1024
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((300, k), generator=gen, device=cuda).to(torch.bfloat16)
    ids, codebook, indices = _cuda_codebook_weight(k, n, (128, 128), 0.5, cuda)
    runs = [(sm_kernel.sonic_matmul_kernel, (ids, codebook, indices),
             (ids, torch.zeros_like(codebook), indices))]
    for ids_dtype, c in ((torch.int8, 64), (torch.int32, 1000)):
        dense = torch.randint(0, c, (k, n), generator=gen, device=cuda).to(ids_dtype)
        cb = torch.randn((c,), generator=gen, device=cuda)
        runs.append((cm_kernel.clustered_matmul_kernel, (dense, cb),
                     (dense, torch.zeros_like(cb))))
    for fn, w, zero in runs:
        _reset_routes(fn)
        a = fn(x, *w)
        assert torch.equal(a, fn(x, *w))
        for m in (1, 4, 8, 9, 40, 65, 128, 200, 257):
            assert torch.equal(a[:m], fn(x[:m].contiguous(), *w)), m
        for m in (4, 300):
            assert (fn(x[:m].contiguous(), *zero) == 0).all()
        assert fn.routes == {"tensor_cores": 13, "cuda_cores": 0}


# --------------------- the block-sparse matmuls' two routes (on the card)
#
# block_sparse_matmul_int8 and block_sparse_matmul take the same
# tensor-core kernel (csrc/block_mma.cuh) for bf16 x where the blocks fit
# (bk a multiple of 16, bn of 64), with the Int8Scale policy (one exact bf16
# part, the kept block's scale applied per chunk) or the Plain policy (three
# bf16 parts per fp32 value, one per bf16 value); fp32 x and small blocks
# keep the CUDA-core tiled kernel.  Both held to the plain versions at 1e-4.


def _int8_and_fp(k, n, block, sparsity, device, scale=None, seed=0):
    """An int8 block-sparse weight of normal draws (times ``scale``, default
    K**-0.5), and the fp32 values it dequantizes to."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=device) * (k**-0.5 if scale is None else scale)
    q = make_block_sparse_int8(w, sparsity, block)
    return q, q.values.float() * q.scales[:, :, None, None]


def _block_sparse_cases(q, fp, m):
    """(kernel, plain, weight args) of both block-sparse matmuls: the int8
    one for M ≥ 8 (fewer rows go to the matvec), fp32 and bf16 values."""
    cases = [(bs_kernel.block_sparse_matmul_kernel, bs_kernel.block_sparse_matmul_plain,
              (v, q.indices)) for v in (fp, fp.bfloat16())]
    if m >= sm_ops.DECODE_M_THRESHOLD:
        cases.append((bs_kernel.block_sparse_matmul_int8_kernel,
                      bs_kernel.block_sparse_matmul_int8_plain, (q.values, q.scales, q.indices)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MAIN_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 8, 65, 257])
def test_cuda_block_sparse_routes_match_plain_at_main_shapes(cuda, m, k, n):
    """(128, 128) blocks at sparsity 0.5 as the served model converts them,
    bf16 x on the tensor cores and fp32 x on the CUDA cores, against the
    plain versions within 1e-4."""
    _reset_routes(bs_kernel.block_sparse_matmul_kernel, bs_kernel.block_sparse_matmul_int8_kernel)
    q, fp = _int8_and_fp(k, n, (128, 128), 0.5, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for fn, plain, w in _block_sparse_cases(q, fp, m):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
            got = fn(x, *w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)
    assert bs_kernel.block_sparse_matmul_kernel.routes == {"tensor_cores": 2, "cuda_cores": 2}
    want = {"tensor_cores": 1, "cuda_cores": 1} if m >= 8 else dict.fromkeys(build.ROUTES, 0)
    assert bs_kernel.block_sparse_matmul_int8_kernel.routes == want


@pytest.mark.cuda
@pytest.mark.parametrize("block,route", [((16, 64), "tensor_cores"), ((32, 64), "tensor_cores"),
                                         ((64, 128), "tensor_cores"), ((16, 16), "cuda_cores"),
                                         ((128, 32), "cuda_cores"), ((8, 128), "cuda_cores")])
@pytest.mark.parametrize("m", [1, 4, 8, 65, 257])
def test_cuda_block_sparse_routes_by_block(cuda, m, block, route):
    """Every kept-block size the tensor cores take (chunks of min(bk, 64) K
    rows) and some they leave to the CUDA cores (``serve_quant``'s 16×16
    among them), bf16 x, unit-scale weights, against the plain versions."""
    k, n = 512, 256
    q, fp = _int8_and_fp(k, n, block, 0.5, cuda, scale=1.0)
    x = torch.randn((m, k), device=cuda, dtype=torch.bfloat16)
    fns = (bs_kernel.block_sparse_matmul_kernel, bs_kernel.block_sparse_matmul_int8_kernel)
    _reset_routes(*fns)
    cases = _block_sparse_cases(q, fp, m)
    for fn, plain, w in cases:
        got = fn(x, *w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)
    assert sum(fn.routes[route] for fn in fns) == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("k,block", [(528, (16, 64)), (96, (32, 64)), (1040, (16, 128)),
                                     (160, (32, 128))])
@pytest.mark.parametrize("m", [1, 8, 65, 257])
def test_cuda_block_sparse_tensor_cores_at_the_ragged_k_edge(cuda, m, k, block):
    """K not a multiple of the 64-wide x tile: with bk < 64 and every
    K-block kept, the last block's x tile reaches past K (TMA fills it with
    zeros, and only its first bk columns are used)."""
    q, fp = _int8_and_fp(k, 256, block, 0.0, cuda)
    assert q.indices[0, -1].item() == k // block[0] - 1
    x = torch.randn((m, k), device=cuda, dtype=torch.bfloat16)
    fns = (bs_kernel.block_sparse_matmul_kernel, bs_kernel.block_sparse_matmul_int8_kernel)
    _reset_routes(*fns)
    cases = _block_sparse_cases(q, fp, m)
    for fn, plain, w in cases:
        got = fn(x, *w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)
    assert sum(fn.routes["tensor_cores"] for fn in fns) == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 2048, 5632])
@pytest.mark.parametrize("m", [8, 257])
def test_cuda_block_sparse_tensor_cores_against_fp64_at_unit_scale(cuda, m, k):
    """The exact product (fp64) as the witness, unit-scale weights, (128,
    128) blocks at sparsity 0.5, 2048 columns, K up to tinyllama's 5632:
    the fp32-values route lies within 1e-4 of it at no larger rms error
    than the plain version's fp32 GEMM; the int8 route within 1e-4 of it."""
    q, fp = _int8_and_fp(k, 2048, (128, 128), 0.5, cuda, scale=1.0, seed=4)
    x = torch.randn((m, k), generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(torch.bfloat16)
    fns = (bs_kernel.block_sparse_matmul_kernel, bs_kernel.block_sparse_matmul_int8_kernel)
    _reset_routes(*fns)
    dense = BlockSparseWeightInt8(q.values, q.scales, q.indices, k // 128).dense(torch.float64)
    exact = x.double() @ dense
    got = bs_kernel.block_sparse_matmul_kernel(x, fp, q.indices).double()
    plain = bs_kernel.block_sparse_matmul_plain(x, fp, q.indices).double()
    torch.testing.assert_close(got, exact, rtol=1e-4, atol=1e-4)
    rms = [(y - exact).pow(2).mean().sqrt().item() for y in (got, plain)]
    assert rms[0] <= rms[1], rms
    got8 = bs_kernel.block_sparse_matmul_int8_kernel(x, q.values, q.scales, q.indices)
    torch.testing.assert_close(got8.double(), exact, rtol=1e-4, atol=1e-4)
    assert all(fn.routes == {"tensor_cores": 1, "cuda_cores": 0} for fn in fns)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 8192])
def test_cuda_block_sparse_tensor_cores_deterministic_row_stable_and_zero(cuda, n):
    """On the tensor-core route two runs agree bit for bit, a row's result is
    the same at M = 8, 9, 40, 65, 128, 200, 257 and 300 (and at 1 and 4 for
    the fp values; token tiles of 8 to 256), and all-zero kept blocks or an
    all-zero x give exact zeros."""
    k = 1024
    q, fp = _int8_and_fp(k, n, (128, 128), 0.5, cuda, seed=3)
    x = torch.randn((300, k), generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda).to(torch.bfloat16)
    runs = [(bs_kernel.block_sparse_matmul_int8_kernel, (q.values, q.scales, q.indices),
             (torch.zeros_like(q.values), q.scales, q.indices), (8,))]
    runs += [(bs_kernel.block_sparse_matmul_kernel, (v, q.indices),
              (torch.zeros_like(v), q.indices), (1, 4, 8)) for v in (fp, fp.bfloat16())]
    for fn, w, zero, small in runs:
        _reset_routes(fn)
        a = fn(x, *w)
        assert torch.equal(a, fn(x, *w))
        rows = (*small, 9, 40, 65, 128, 200, 257)
        for m in rows:
            assert torch.equal(a[:m], fn(x[:m].contiguous(), *w)), m
        for m in (small[-1], 300):
            assert (fn(x[:m].contiguous(), *zero) == 0).all()
            assert (fn(torch.zeros_like(x[:m]), *w) == 0).all()
        assert fn.routes == {"tensor_cores": 2 + len(rows) + 4, "cuda_cores": 0}


# ------------------------------- a row's bits across the decode threshold
#
# The public ops send fewer than DECODE_M_THRESHOLD = 8 flattened rows to a
# matvec and more to a matmul.  For bf16 x at blocks the tensor cores take,
# both do the same arithmetic (the same wgmma per 64-row chunk, the chunk
# tiles added in the same order), so a decode row equals the same row of a
# prefill or speculative-verify window bit for bit.


def _decode_pairs(k, n, device, seed=0):
    """The int8 pair and the codebook pair on one (128, 128)-block weight at
    sparsity 0.5: (name, public op, fp32 kernel dispatch) each."""
    q, _ = _int8_and_fp(k, n, (128, 128), 0.5, device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ids = torch.randint(0, 64, q.values.shape, generator=gen, device=device).to(torch.int8)
    cb = torch.randn((64,), generator=gen, device=device) * k**-0.5
    sw = sm_ops.SonicWeight(ids, cb, q.indices, k // 128)
    w8 = (q.values, q.scales, q.indices)
    wc = (ids, cb, q.indices)

    def int8_kernel(x):
        fn = (sm_kernel.sonic_matvec_int8_kernel if x.shape[0] < sm_ops.DECODE_M_THRESHOLD
              else bs_kernel.block_sparse_matmul_int8_kernel)
        return fn(x, *w8)

    def codebook_kernel(x):
        fn = (sm_kernel.sonic_matvec_kernel if x.shape[0] < sm_ops.DECODE_M_THRESHOLD
              else sm_kernel.sonic_matmul_kernel)
        return fn(x, *wc)

    return [("int8", lambda x: sm_ops.sonic_matmul_int8(x, *w8), int8_kernel),
            ("codebook", lambda x: sm_ops.sonic_matmul(x, sw), codebook_kernel)]


DECODE_ROWS = (1, 4, 7)
WINDOWS = (8, 12, 20, 256)  # verify windows B·(k+1), B = 4, k = 1, 2, 4; a prefill


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MAIN_SHAPES)
def test_cuda_decode_rows_equal_window_rows(cuda, k, n):
    """bf16 x, tinyllama-1.1b's five projection shapes: the rows of
    ``sonic_matmul_int8`` / ``sonic_matmul`` at M = 1, 4, 7 (the matvecs)
    equal bit for bit the same rows at M = 8, 12, 20, 256 (the matmuls'
    tensor-core route), in the ops' bf16 outputs and in the kernels' fp32
    outputs.  A failure lists the rows that differ and the largest |Δ|."""
    x = torch.randn((256, k), generator=torch.Generator(device=cuda).manual_seed(7),
                    device=cuda).to(torch.bfloat16)
    bad = []
    for name, op, kernel in _decode_pairs(k, n, cuda):
        for label, fn in (("op bf16", op), ("kernel fp32", kernel)):
            windows = {m: fn(x[:m]) for m in WINDOWS}
            for m in DECODE_ROWS:
                row = fn(x[:m])
                for big, y in windows.items():
                    if not torch.equal(row, y[:m]):
                        d = (row.float() - y[:m].float()).abs()
                        bad.append(f"{name} {label} M={m} vs {big}: "
                                   f"{int((d > 0).any(-1).sum())}/{m} rows differ, "
                                   f"max |Δ| {d.max().item():.3e}")
    assert not bad, "\n".join(bad)


# ------------------------------------- the two matvecs' routes (on the card)
#
# sonic_matvec_int8 and sonic_matvec take the decode kernel of
# csrc/decode_mma.cuh for bf16 x where the blocks fit (bk a multiple of 16,
# bn of 64), and keep the CUDA-core matvec for fp32 x and other blocks.
# Both routes held to the plain versions at 1e-4 (fp32 both; the sums run
# in another order over up to 5632 terms).


def _matvec_cases(k, n, block, device, seed=0):
    """(wrapper, plain, weight args) of both matvecs on one weight's
    kept-block structure: int8 values and scales, int8 ids in [0, 64) and a
    codebook at the models' scale."""
    q, _ = _int8_and_fp(k, n, block, 0.5, device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ids = torch.randint(0, 64, q.values.shape, generator=gen, device=device).to(torch.int8)
    cb = torch.randn((64,), generator=gen, device=device) * k**-0.5
    return [(sm_kernel.sonic_matvec_int8_kernel, sm_kernel.sonic_matvec_int8_plain,
             (q.values, q.scales, q.indices)),
            (sm_kernel.sonic_matvec_kernel, sm_kernel.sonic_matvec_plain, (ids, cb, q.indices))]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MAIN_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7])
def test_cuda_matvec_routes_match_plain_at_main_shapes(cuda, m, k, n):
    """(128, 128) blocks at sparsity 0.5: bf16 x on the decode kernel, fp32 x
    on the CUDA cores, each against the plain version within 1e-4."""
    fns = (sm_kernel.sonic_matvec_int8_kernel, sm_kernel.sonic_matvec_kernel)
    _reset_routes(*fns)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for fn, plain, w in _matvec_cases(k, n, (128, 128), cuda):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
            got = fn(x, *w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)
    assert all(fn.routes == {"tensor_cores": 1, "cuda_cores": 1} for fn in fns)


@pytest.mark.cuda
@pytest.mark.parametrize("k,block", [(512, (1, 1)), (512, (2, 8)), (512, (16, 16)),
                                     (512, (32, 64)), (512, (128, 128)), (512, (128, 4)),
                                     (512, (16, 64)), (512, (64, 128)), (528, (16, 64)),
                                     (96, (32, 64)), (1040, (16, 128)), (160, (32, 128))])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7])
def test_cuda_matvec_routes_by_block(cuda, m, k, block):
    """Small and ragged blocks (those of ``test_cuda_kernel_matches_plain``)
    and K past the last 64-wide x tile with bk < 64 (every K-block kept, so
    the last chunk's x tile reaches past K), bf16 x, unit-scale weights:
    the route ``mma_route`` names, within 1e-4 of the plain version."""
    q, _ = _int8_and_fp(k, 256, block, 0.0 if k != 512 else 0.5, cuda, scale=1.0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ids = torch.randint(0, 64, q.values.shape, generator=gen, device=cuda).to(torch.int8)
    cases = [(sm_kernel.sonic_matvec_int8_kernel, sm_kernel.sonic_matvec_int8_plain,
              (q.values, q.scales, q.indices)),
             (sm_kernel.sonic_matvec_kernel, sm_kernel.sonic_matvec_plain,
              (ids, torch.randn((64,), generator=gen, device=cuda), q.indices))]
    route = build.mma_route(*block, torch.bfloat16)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    _reset_routes(*(fn for fn, _, _ in cases))
    for fn, plain, w in cases:
        got = fn(x, *w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(x, *w), rtol=1e-4, atol=1e-4)
        assert fn.routes[route] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1024, 512), (5632, 2048), (2048, 32000)])
def test_cuda_decode_kernel_deterministic_zero_split_and_row_stable(cuda, k, n):
    """On the decode kernel two runs agree bit for bit, a row's result is the
    same at M = 1 … 7 and at every split of the tile's chunks over 1, 2, 4 or
    8 blocks, and an all-zero weight or x gives exact zeros."""
    x = torch.randn((7, k), generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(torch.bfloat16)
    cases = _matvec_cases(k, n, (128, 128), cuda, seed=5)
    (_, _, (values, scales, indices)), (_, _, (ids, cb, _)) = cases
    zeros = [(torch.zeros_like(values), scales, indices), (ids, torch.zeros_like(cb), indices)]
    launch = [lambda xx, s: build.launch_int8("sonic_matvec_int8_mma", xx, values, scales,
                                              indices, split=s),
              lambda xx, s: build.launch_codebook("sonic_matvec_mma", xx, ids, cb, indices,
                                                  split=s)]
    for (fn, _, w), zero, direct in zip(cases, zeros, launch):
        _reset_routes(fn)
        a = fn(x, *w)
        assert torch.equal(a, fn(x, *w))
        for m in range(1, 7):
            assert torch.equal(a[:m], fn(x[:m].contiguous(), *w)), m
        for split in (1, 2, 4, 8):
            assert torch.equal(a, direct(x, split)), split
        assert (fn(x, *zero) == 0).all() and (fn(torch.zeros_like(x), *w) == 0).all()
        assert fn.routes == {"tensor_cores": 10, "cuda_cores": 0}
