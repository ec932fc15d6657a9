"""The tensor-core route of the two block-sparse matmuls, checked on the CPU.

``block_sparse_matmul_int8`` and ``block_sparse_matmul`` take bf16 x on the
card through ``csrc/block_mma.cuh``, the kernel of the codebook matmuls
with another weight policy: an int8 value is exact in one bf16 part, and
each 64-row chunk's tile is added times its kept block's scale (s·(x @ w)
per chunk, where the reference takes x @ (w·s)); an fp32 value is split
into three bf16 parts (``split_codebook_bf16``'s arithmetic), a bf16 value
is one part.  The CUDA kernel runs only on the card (tests marked ``cuda``
in ``tests/test_torch_kernels.py``); here a plain emulation of each
policy's arithmetic on numpy-seeded inputs against the port's plain
versions and the JAX package's references
(``src/repro/kernels/block_sparse_matmul/ref.py``), why one part holds an
int8 value and three an fp32 one, and the routing rule with its counters.
Run on its own with
``PYTHONPATH=src python -m pytest -q tests/test_torch_block_mma.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel
from repro_torch.kernels.sonic_matmul.kernel import split_codebook_bf16

TOL = dict(rtol=1e-4, atol=1e-4)  # what chip_smoke.py and the card tests hold the kernels to
CHUNK = 64  # K rows the kernel sums per fresh tensor-core tile (min(bk, 64))


@pytest.fixture(scope="module")
def jref():
    """The JAX package's jnp oracles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.block_sparse_matmul.ref import (
        block_sparse_matmul_int8_ref,
        block_sparse_matmul_ref,
    )

    return dict(jnp=jnp, fp=block_sparse_matmul_ref, int8=block_sparse_matmul_int8_ref)


def _x_bf16(m, k, seed=1):
    """Normal draws rounded to bf16, carried as fp32 (the kernel's x is
    bf16; the fp32 references then see the very same values)."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float()


def _indices(k, n, block, sparsity, rng):
    """(Nb, R) ascending kept K-block ids, R = (1 − sparsity)·K/bk."""
    bk, bn = block
    kb = k // bk
    r = max(1, round((1 - sparsity) * kb))
    return np.stack([np.sort(rng.permutation(kb)[:r]) for _ in range(n // bn)]).astype(np.int32)


def _int8_weight(k, n, block, sparsity=0.5, seed=2):
    """Normal draws at the models' scale (K**-0.5), quantized per kept block
    as the converters do: scale = max|w| / 127, values = round(w / scale)."""
    rng = np.random.default_rng(seed)
    indices = _indices(k, n, block, sparsity, rng)
    w = rng.standard_normal((*indices.shape, *block)).astype(np.float32) * k**-0.5
    scales = (np.abs(w).max(axis=(2, 3)) / 127).astype(np.float32)
    values = np.round(w / scales[:, :, None, None]).astype(np.int8)
    return values, scales, indices


def _fp_weight(k, n, block, scale, sparsity=0.5, seed=2):
    rng = np.random.default_rng(seed)
    indices = _indices(k, n, block, sparsity, rng)
    values = rng.standard_normal((*indices.shape, *block)).astype(np.float32) * scale
    return values, indices


def _emulate(x, parts, indices, scales=None):
    """The tensor-core route's arithmetic: per kept block in ascending order
    and per chunk of min(bk, 64) rows in it, bf16 x times each bf16 part
    (carried as fp32) summed into a fresh fp32 tile, which is then added to
    the output in order, times the block's scale where there is one."""
    nb, r, bk, bn = parts[0].shape
    chunk = min(bk, CHUNK)
    xb = x.bfloat16().float()
    y = torch.zeros((x.shape[0], nb, bn))
    for rr in range(r):
        for k0 in range(0, bk, chunk):
            cols = indices[:, rr].long()[:, None] * bk + k0 + torch.arange(chunk)  # (Nb, chunk)
            tile = sum(torch.einsum("mnk,nkj->mnj", xb[:, cols], p[:, rr, k0:k0 + chunk].float())
                       for p in parts)
            y = y + (tile if scales is None else scales[None, :, rr, None] * tile)
    return y.reshape(x.shape[0], nb * bn)


def _emulate_int8(x, values, scales, indices):
    return _emulate(x, [values.bfloat16()], indices, scales)


def _emulate_fp(x, values, indices, parts=3):
    if values.dtype == torch.bfloat16:
        return _emulate(x, [values], indices)
    return _emulate(x, split_codebook_bf16(values)[:parts], indices)


# ------------------------------------------------------------- the parts


def test_every_int8_value_is_exact_in_bf16():
    """|v| ≤ 128 needs 8 significant bits, which bf16 has: one part holds
    an int8 value whole, so the int8 route issues one product per weight."""
    v = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(v.bfloat16().float(), v.float())
    assert torch.equal(v.bfloat16().to(torch.int8), v)


def test_one_and_two_parts_of_fp32_values_fail_where_three_hold():
    """Why three parts: unit-scale fp32 values, all K-blocks kept at K =
    1024 (outputs up to ~100, while the bound near zero is 1e-4).  One bf16
    rounding (~2⁻⁹ relative) and two parts (~2⁻¹⁷) miss 1e-4; three carry
    each value whole."""
    k, n = 1024, 256
    values, indices = (torch.from_numpy(a) for a in _fp_weight(k, n, (128, 128), 1.0, 0.0))
    x = _x_bf16(16, k)
    plain = bs_kernel.block_sparse_matmul_plain(x, values, indices)
    for parts in (1, 2):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(_emulate_fp(x, values, indices, parts), plain, **TOL)
    torch.testing.assert_close(_emulate_fp(x, values, indices, 3), plain, **TOL)


# ------------------------------------------ the kernel's arithmetic, emulated


@pytest.mark.parametrize("block", [(128, 128), (16, 64)])
@pytest.mark.parametrize("k", [2048, 5632])
def test_emulated_int8_route_matches_plain_and_jax(jref, k, block):
    """One exact bf16 part per int8 value, per-chunk tiles scaled as they
    are added: within 1e-4 of the plain version and of the JAX reference at
    tinyllama's depths, sparsity 0.5, (128, 128) blocks as the served model
    converts them (and (16, 64), whose chunks are 16 rows)."""
    values, scales, indices = _int8_weight(k, 256, block)
    x = _x_bf16(8, k)
    args = [torch.from_numpy(a) for a in (values, scales, indices)]
    got = _emulate_int8(x, *args)
    torch.testing.assert_close(got, bs_kernel.block_sparse_matmul_int8_plain(x, *args), **TOL)
    jnp = jref["jnp"]
    want = np.asarray(jref["int8"](jnp.asarray(x.numpy()), jnp.asarray(values),
                                   jnp.asarray(scales), jnp.asarray(indices), k // block[0]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2048, 5632])
def test_emulated_fp_route_matches_plain_and_jax(jref, k, vdtype):
    """Three bf16 parts per fp32 value (one per bf16 value), per-chunk
    tiles: within 1e-4 of the plain version and of the JAX reference at
    K 2048 and 5632, (128, 128) blocks, sparsity 0.5, values at the models'
    scale (K**-0.5) and at unit scale."""
    x = _x_bf16(8, k)
    for scale in (k**-0.5, 1.0):
        values, indices = _fp_weight(k, 256, (128, 128), scale)
        v, ix = torch.from_numpy(values).to(vdtype), torch.from_numpy(indices)
        got = _emulate_fp(x, v, ix)
        torch.testing.assert_close(got, bs_kernel.block_sparse_matmul_plain(x, v, ix), **TOL)
        jnp = jref["jnp"]
        want = np.asarray(jref["fp"](jnp.asarray(x.numpy()), jnp.asarray(v.float().numpy()),
                                     jnp.asarray(indices), k // 128))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_all_zero_blocks_and_zero_x_emulate_exact_zeros():
    values, scales, indices = (torch.from_numpy(a) for a in _int8_weight(512, 128, (64, 64)))
    x = _x_bf16(4, 512)
    assert (_emulate_int8(x, torch.zeros_like(values), scales, indices) == 0).all()
    assert (_emulate_int8(torch.zeros_like(x), values, scales, indices) == 0).all()
    fp = values.float() * scales[:, :, None, None]
    assert (_emulate_fp(x, torch.zeros_like(fp), indices) == 0).all()
    assert (_emulate_fp(torch.zeros_like(x), fp, indices) == 0).all()


# ------------------------------------------------------- routing and counts


@pytest.mark.parametrize("bk,bn,dtype,route", [
    (128, 128, torch.bfloat16, "tensor_cores"),
    (64, 128, torch.bfloat16, "tensor_cores"),
    (32, 64, torch.bfloat16, "tensor_cores"),
    (16, 64, torch.bfloat16, "tensor_cores"),
    (16, 128, torch.bfloat16, "tensor_cores"),
    (128, 128, torch.float32, "cuda_cores"),
    (16, 64, torch.float32, "cuda_cores"),
    (16, 16, torch.bfloat16, "cuda_cores"),  # serve_quant's blocks
    (128, 32, torch.bfloat16, "cuda_cores"),
    (8, 128, torch.bfloat16, "cuda_cores"),
    (1, 1, torch.bfloat16, "cuda_cores"),
])
def test_mma_route_takes_block_sparse_launches(bk, bn, dtype, route):
    """The block-sparse kernels' rule, the same as ``sonic_matmul``'s: bf16
    x, bk a multiple of 16, bn of 64.  It never sees M
    (``test_codebook_route_never_sees_m``), and the wrappers route every M
    alike (``test_block_sparse_wrappers_count_each_route``)."""
    assert build.mma_route(bk, bn, dtype) == route


def test_block_sparse_wrappers_count_each_route(monkeypatch):
    """A CUDA-side call (meta tensors, fake launchers) goes to the entry point
    of its route and is counted there, for every M; CPU calls count
    nothing."""
    calls = []

    def fake_int8(name, x, values, scales, indices):
        calls.append(name)
        return torch.empty((x.shape[0], values.shape[0] * values.shape[3]), device=x.device)

    def fake_fp(x, values, indices, name="block_sparse_matmul"):
        calls.append(name)
        return torch.empty((x.shape[0], values.shape[0] * values.shape[3]), device=x.device)

    monkeypatch.setattr(build, "launch_int8", fake_int8)
    monkeypatch.setattr(build, "launch_fp", fake_fp)
    int8_fn, fp_fn = bs_kernel.block_sparse_matmul_int8_kernel, bs_kernel.block_sparse_matmul_kernel
    for fn in (int8_fn, fp_fn):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "routes", dict.fromkeys(build.ROUTES, 0))
    indices = torch.empty((2, 4), dtype=torch.int32, device="meta")
    scales = torch.empty((2, 4), device="meta")
    for m in (1, 4, 8, 257):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty((m, 1024), device="meta", dtype=dtype)
            for block in ((128, 128), (16, 16)):
                values = torch.empty((2, 4, *block), dtype=torch.int8, device="meta")
                int8_fn(x, values, scales, indices)
                for vdtype in (torch.float32, torch.bfloat16):
                    fp_fn(x, values.to(vdtype), indices)
    step = ["block_sparse_matmul_int8_mma", "block_sparse_matmul_mma", "block_sparse_matmul_mma",
            "block_sparse_matmul_int8", "block_sparse_matmul", "block_sparse_matmul"]
    assert calls[:6] == step
    assert calls[6:12] == ["block_sparse_matmul_int8", "block_sparse_matmul",
                           "block_sparse_matmul"] * 2
    assert calls == calls[:12] * 4
    assert int8_fn.routes == {"tensor_cores": 4, "cuda_cores": 12} and int8_fn.launches == 16
    assert fp_fn.routes == {"tensor_cores": 8, "cuda_cores": 24} and fp_fn.launches == 32
    x = torch.zeros((8, 256), dtype=torch.bfloat16)  # CPU: plain, not counted
    values, scales, indices = (torch.from_numpy(a) for a in _int8_weight(256, 128, (128, 128)))
    int8_fn(x, values, scales, indices)
    fp_fn(x, values.float(), indices)
    assert int8_fn.launches == 16 and fp_fn.launches == 32 and len(calls) == 48
