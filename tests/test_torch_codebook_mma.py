"""The tensor-core route of the two codebook matmuls, checked on the CPU.

``clustered_matmul`` and ``sonic_matmul`` take bf16 x on the card through
``csrc/block_mma.cuh``: each fp32 centroid is split into bf16 parts
(``split_codebook_bf16``) and each part multiplies the bf16 x on the tensor
cores, summed in fp32.  The CUDA kernel runs only on the card (tests marked
``cuda`` in ``tests/test_torch_kernels.py``); here the split itself, a plain
emulation of the kernel's arithmetic on numpy-seeded inputs against the
port's plain versions and the JAX package's references
(``src/repro/kernels/*/ref.py``), why three parts and not one or two, and the
routing rule with its counters.  Run on its own with
``PYTHONPATH=src python -m pytest -q tests/test_torch_codebook_mma.py``.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_sparse_matmul.kernel import block_sparse_matmul_plain
from repro_torch.kernels.clustered_matmul import kernel as cm_kernel
from repro_torch.kernels.sonic_matmul import kernel as sm_kernel
from repro_torch.kernels.sonic_matmul.kernel import split_codebook_bf16

TOL = dict(rtol=1e-4, atol=1e-4)  # what chip_smoke.py and the card tests hold the kernels to
CHUNK = 64  # K rows the kernel sums per fresh tensor-core tile


@pytest.fixture(scope="module")
def jref():
    """The JAX package's jnp oracles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.clustered_matmul.ref import clustered_matmul_ref
    from repro.kernels.sonic_matmul.ref import sonic_matmul_ref

    return dict(jnp=jnp, clustered=clustered_matmul_ref, sonic=sonic_matmul_ref)


def _codebook(c, scale, seed=0):
    return (np.random.default_rng(seed).standard_normal(c) * scale).astype(np.float32)


def _x_bf16(m, k, seed=1):
    """Normal draws rounded to bf16, carried as fp32 (the kernel's x is
    bf16; the fp32 references then see the very same values)."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float()


def _emulate_clustered(x, ids, codebook, parts):
    """The tensor-core route's arithmetic with the first ``parts`` bf16 parts
    of each centroid (the kernel takes all three): per 64-row chunk of K,
    the parts' products summed in fp32, the chunks then added in order."""
    ps = [p.float() for p in split_codebook_bf16(codebook)[:parts]]
    xb = x.bfloat16().float()
    y = torch.zeros((x.shape[0], ids.shape[1]))
    for k0 in range(0, x.shape[1], CHUNK):
        w = ids[k0:k0 + CHUNK].long()
        y = y + sum(xb[:, k0:k0 + CHUNK] @ p[w] for p in ps)
    return y


def _emulate_sonic(x, idx_values, codebook, indices, parts):
    ps = split_codebook_bf16(codebook)[:parts]
    return sum(block_sparse_matmul_plain(x.bfloat16(), p.float()[idx_values.long()], indices)
               for p in ps)


def _sonic_weight(k, n, block, c, sparsity=0.5, seed=2):
    """Block-sparse cluster ids: R = (1 − sparsity)·K/bk kept K-blocks per
    N-block, ascending, ids uniform over the codebook."""
    rng = np.random.default_rng(seed)
    bk, bn = block
    kb, nb = k // bk, n // bn
    r = max(1, round((1 - sparsity) * kb))
    indices = np.stack([np.sort(rng.permutation(kb)[:r]) for _ in range(nb)]).astype(np.int32)
    ids = rng.integers(0, c, (nb, r, bk, bn)).astype(np.int8)
    return ids, indices, kb


# ---------------------------------------------------------------- the split


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("c", [64, 128, 1000])
def test_split_codebook_bf16_carries_each_centroid(c, scale):
    """hi = bf16(c); hi + mid within 2⁻¹⁶ relative of every centroid; hi +
    mid + lo the centroid itself; bf16 parts; zeros split into zeros."""
    cb = torch.from_numpy(_codebook(c, scale))
    hi, mid, lo = split_codebook_bf16(cb)
    assert all(p.dtype == torch.bfloat16 and p.shape == cb.shape for p in (hi, mid, lo))
    assert torch.equal(hi, cb.bfloat16())
    two = hi.double() + mid.double()
    assert ((two - cb.double()).abs() <= 2.0**-16 * cb.double().abs()).all()
    assert torch.equal(two + lo.double(), cb.double())
    zeros = split_codebook_bf16(torch.zeros(c))
    assert all((p == 0).all() for p in zeros)


# ------------------------------------------ the kernel's arithmetic, emulated


@pytest.mark.parametrize("ids_dtype,c", [(torch.int8, 64), (torch.int8, 128), (torch.int32, 1000)])
@pytest.mark.parametrize("k", [2048, 5632])
def test_emulated_clustered_route_matches_plain_and_jax(jref, k, ids_dtype, c):
    """Three parts, chunked fp32 sums: within 1e-4 of the plain version and
    of the JAX reference at tinyllama's depths (K 2048 and 5632), centroids
    at the model's scale (K**-0.5) and at unit scale."""
    n = 24
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, c, (k, n))).to(ids_dtype)
    x = _x_bf16(8, k)
    for scale in (k**-0.5, 1.0):
        cb = torch.from_numpy(_codebook(c, scale))
        got = _emulate_clustered(x, ids, cb, 3)
        torch.testing.assert_close(got, cm_kernel.clustered_matmul_plain(x, ids, cb), **TOL)
        jnp = jref["jnp"]
        want = np.asarray(jref["clustered"](jnp.asarray(x.numpy()), jnp.asarray(ids.numpy()),
                                            jnp.asarray(cb.numpy())))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("k", [2048, 5632])
def test_emulated_sonic_route_matches_plain_and_jax(jref, k, c):
    """The same for the block-sparse kernel: (128, 128) blocks at sparsity
    0.5, as the layer path converts tinyllama-1.1b."""
    ids, indices, kb = _sonic_weight(k, 256, (128, 128), c)
    cb = _codebook(c, k**-0.5)
    x = _x_bf16(8, k)
    args = [torch.from_numpy(a) for a in (ids, cb, indices)]
    got = _emulate_sonic(x, *args, 3)
    torch.testing.assert_close(got, sm_kernel.sonic_matmul_plain(x, *args), **TOL)
    jnp = jref["jnp"]
    want = np.asarray(jref["sonic"](jnp.asarray(x.numpy()), jnp.asarray(ids), jnp.asarray(cb),
                                    jnp.asarray(indices), kb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k", [2048, 5632])
def test_one_bf16_rounding_of_the_centroids_fails_the_bound(k):
    """Why the parts exist: one bf16 rounding (about 2⁻⁹ relative per
    weight) misses 1e-4 at tinyllama's depths and the model's scale."""
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (k, 24))).to(torch.int8)
    cb = torch.from_numpy(_codebook(64, k**-0.5))
    x = _x_bf16(8, k)
    plain = cm_kernel.clustered_matmul_plain(x, ids, cb)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(_emulate_clustered(x, ids, cb, 1), plain, **TOL)
    torch.testing.assert_close(_emulate_clustered(x, ids, cb, 3), plain, **TOL)


def test_two_parts_fail_where_three_hold():
    """Two parts (about 2⁻¹⁷ relative) miss 1e-4 with unit-scale centroids at
    K = 1024, the card tests' case (outputs up to ~100, while the bound near
    zero is 1e-4); three parts carry the centroid whole."""
    k, n = 1024, 256
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 1000, (k, n))).to(torch.int32)
    cb = torch.from_numpy(_codebook(1000, 1.0))
    x = _x_bf16(16, k)
    plain = cm_kernel.clustered_matmul_plain(x, ids, cb)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(_emulate_clustered(x, ids, cb, 2), plain, **TOL)
    torch.testing.assert_close(_emulate_clustered(x, ids, cb, 3), plain, **TOL)


def test_all_zero_codebook_emulates_exact_zeros():
    ids, indices, _ = _sonic_weight(512, 128, (64, 64), 16)
    x = _x_bf16(4, 512)
    args = [torch.from_numpy(ids), torch.zeros(16), torch.from_numpy(indices)]
    assert (_emulate_sonic(x, *args, 3) == 0).all()
    dense = torch.zeros((512, 64), dtype=torch.int8)
    assert (_emulate_clustered(x, dense, torch.zeros(16), 3) == 0).all()


# ------------------------------------------------------- routing and counts


@pytest.mark.parametrize("bk,bn,dtype,dense,route", [
    (128, 128, torch.bfloat16, False, "tensor_cores"),
    (16, 64, torch.bfloat16, False, "tensor_cores"),
    (32, 64, torch.bfloat16, False, "tensor_cores"),
    (128, 128, torch.float32, False, "cuda_cores"),
    (16, 16, torch.bfloat16, False, "cuda_cores"),
    (8, 128, torch.bfloat16, False, "cuda_cores"),
    (128, 32, torch.bfloat16, False, "cuda_cores"),
    (2048, 32000, torch.bfloat16, True, "tensor_cores"),
    (1000, 192, torch.bfloat16, True, "tensor_cores"),
    (5632, 2048, torch.float32, True, "cuda_cores"),
    (1001, 192, torch.bfloat16, True, "cuda_cores"),
    (96, 40, torch.bfloat16, True, "cuda_cores"),
    (7, 3, torch.bfloat16, True, "cuda_cores"),
])
def test_codebook_route_follows_block_and_dtype(bk, bn, dtype, dense, route):
    assert build.mma_route(bk, bn, dtype, dense=dense) == route


def test_codebook_route_never_sees_m():
    assert list(inspect.signature(build.mma_route).parameters) == [
        "bk", "bn", "x_dtype", "dense"]


def test_wrappers_count_each_route(monkeypatch):
    """A CUDA-side call (meta tensors, fake launchers) goes to the entry point
    of its route and is counted there, for every M; CPU calls count
    nothing."""
    calls = []

    def fake_codebook(name, x, idx_values, codebook, indices):
        calls.append(name)
        return torch.empty((x.shape[0], idx_values.shape[0] * idx_values.shape[3]),
                           device=x.device)

    def fake_clustered(x, ids, codebook, name="clustered_matmul"):
        calls.append(name)
        return torch.empty((x.shape[0], ids.shape[1]), device=x.device)

    monkeypatch.setattr(build, "launch_codebook", fake_codebook)
    monkeypatch.setattr(build, "launch_clustered", fake_clustered)
    for fn in (sm_kernel.sonic_matmul_kernel, cm_kernel.clustered_matmul_kernel):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "routes", dict.fromkeys(build.ROUTES, 0))
    indices = torch.empty((2, 4), dtype=torch.int32, device="meta")
    codebook = torch.empty(64, device="meta")
    for m in (1, 4, 8, 257):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty((m, 1024), device="meta", dtype=dtype)
            for block in ((128, 128), (16, 16)):
                ids = torch.empty((2, 4, *block), dtype=torch.int8, device="meta")
                sm_kernel.sonic_matmul_kernel(x, ids, codebook, indices)
            for n in (2048, 40):
                ids = torch.empty((1024, n), dtype=torch.int8, device="meta")
                cm_kernel.clustered_matmul_kernel(x, ids, codebook)
    assert calls[:4] == ["sonic_matmul_mma", "sonic_matmul", "clustered_matmul_mma",
                         "clustered_matmul"]
    assert calls[4:8] == ["sonic_matmul", "sonic_matmul", "clustered_matmul",
                          "clustered_matmul"]
    assert calls == calls[:8] * 4
    want = {"tensor_cores": 4, "cuda_cores": 12}
    assert sm_kernel.sonic_matmul_kernel.routes == want
    assert cm_kernel.clustered_matmul_kernel.routes == want
    assert sm_kernel.sonic_matmul_kernel.launches == 16
    assert cm_kernel.clustered_matmul_kernel.launches == 16
    x = torch.zeros((4, 1024), dtype=torch.bfloat16)  # CPU: plain, not counted
    cm_kernel.clustered_matmul_kernel(x, torch.zeros((1024, 64), dtype=torch.int8),
                                      torch.zeros(8))
    assert cm_kernel.clustered_matmul_kernel.routes == want and len(calls) == 32
