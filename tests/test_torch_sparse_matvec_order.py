"""The C3 kernel's order of sums, checked on the CPU.

``sparse_matvec`` runs on the card in one launch per projection
(``csrc/sparse_matvec.cu``): the kept rows in chunks of 32, a column tile's
chunks dealt in balanced contiguous ranges to the ``split`` blocks of a
cluster (``build.sparse_matvec_plan``), 4 consumer warps per block, warp w
taking rows 8w .. 8w + 7 of each chunk into a running fp32 sum (fmaf, rows
ascending), and the 4 · split warp sums of each output added in (block,
warp) order.  The CUDA kernel runs only on the card; here, on numpy-seeded
inputs:

* an emulation of that partition and order matches the port's plain
  version and ``ref.py``, the JAX package's reference
  (``repro.kernels.sparse_matvec.ref.sparse_matvec_ref``) and its
  ``ops.sparse_matvec`` (the Pallas kernel in interpret mode) within 1e-5;
* its rows are equal bit for bit at B = 1, 3, 4, 9, 40 and inside B = 300;
* every split covers each chunk once, including knz = 0, 1, 7 and an
  STL10-sized knz;
* the plan and route rules take no B, and the wrapper counts its routes.

Tests marked ``cuda`` hold the kernel on the card to the emulation bit for
bit (each fp32 operation is modelled: products exact in fp64, each fmaf and
add rounded once to fp32):
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_sparse_matvec_order.py``.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.sparse_matvec import kernel as smv_kernel
from repro_torch.kernels.sparse_matvec import ops
from repro_torch.kernels.sparse_matvec.ref import sparse_matvec_ref

TOL = dict(rtol=1e-5, atol=1e-5)
SMS = 132  # an H100's SMs
SPLITS = (1, 2, 4, 8)
# tinyllama-1.1b's C3 projections at knz = K / 4, and STL10's fc0: (knz, N)
# and the (tile, split) sparse_matvec_plan gives them on 132 SMs
PLANS = [((512, 2048), (128, 8)),    # q, o
         ((512, 256), (32, 8)),      # k, v
         ((512, 5632), (256, 8)),    # wi, wg
         ((1408, 2048), (128, 8)),   # ffn wo
         ((512, 32000), (256, 2)),   # LM head
         ((36864, 512), (32, 8))]    # STL10 fc0 at K / 4


@pytest.fixture(scope="module")
def jref():
    """The JAX package's reference and op."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.sparse_matvec.ops import sparse_matvec as jax_op
    from repro.kernels.sparse_matvec.ref import sparse_matvec_ref as jax_ref

    return dict(jnp=jnp, op=jax_op, ref=jax_ref)


def _case(b, k, n, knz, seed=0, bf16=True):
    """x (b, knz) and Wt (k, n) as fp32 tensors (rounded to bf16 when
    ``bf16``), ascending distinct idx (knz,) int32."""
    rng = np.random.default_rng(seed)
    wt = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * k**-0.5)
    x = torch.from_numpy(rng.standard_normal((b, knz)).astype(np.float32))
    if bf16:
        wt, x = wt.bfloat16().float(), x.bfloat16().float()
    idx = torch.from_numpy(np.sort(rng.permutation(k)[:knz]).astype(np.int32))
    return x, idx, wt


def _ranges(n_chunks, split):
    """Each block's chunks, as the kernel deals them: block q from
    q·n / split (floor), balanced and contiguous."""
    return [range(q * n_chunks // split, (q + 1) * n_chunks // split) for q in range(split)]


def _emulate(x, idx, wt, split):
    """The kernel's sums, each fp32 operation modelled: per (block, warp)
    a running fmaf over the warp's rows (8w .. 8w + 7 of each of the block's
    chunks, ascending), then the warp sums added in (block, warp) order.
    The tile and the row group choose only which block computes an output,
    not its chain, so all columns and rows go at once.  fp64 holds each
    product exactly (at most 48 significant bits); one rounding to fp32
    follows each add."""
    knz = x.shape[1]
    rows = wt.double()[idx.long()]  # (knz, N)
    xd = x.double()
    n_chunks = -(-knz // build.SMV_CHUNK)
    out = None
    for blk in _ranges(n_chunks, split):
        for w in range(build.SMV_WARPS):
            acc = torch.zeros((x.shape[0], wt.shape[1]), dtype=torch.float32, device=x.device)
            per = build.SMV_CHUNK // build.SMV_WARPS
            for c in blk:
                for r in range(c * build.SMV_CHUNK + w * per, c * build.SMV_CHUNK + (w + 1) * per):
                    if r < knz:
                        acc = (xd[:, r:r + 1] * rows[r] + acc.double()).float()
            out = acc if out is None else (out.double() + acc.double()).float()
    return out


def _plan_split(knz, n, sms=SMS):
    return build.sparse_matvec_plan(knz, n, sms)[1]


# ------------------------------------------------------ the emulated kernel


@pytest.mark.parametrize("b,k,n,knz", [(4, 2048, 2048, 512), (1, 256, 512, 64),
                                       (7, 512, 130, 100), (3, 50, 1, 17), (5, 64, 96, 1),
                                       (4, 1024, 256, 300), (2, 96, 40, 96)])
@pytest.mark.parametrize("bf16", [True, False])
def test_emulation_matches_plain_and_references(jref, b, k, n, knz, bf16):
    x, idx, wt = _case(b, k, n, knz, bf16=bf16)
    got = _emulate(x, idx, wt, _plan_split(knz, n))
    torch.testing.assert_close(got, smv_kernel.sparse_matvec_plain(x, idx, wt), **TOL)
    torch.testing.assert_close(got, sparse_matvec_ref(x, idx, wt), **TOL)
    jnp = jref["jnp"]
    want = np.asarray(jref["ref"](jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()),
                                  jnp.asarray(wt.numpy())))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,k,n,knz", [(4, 512, 512, 100), (1, 256, 96, 33), (3, 128, 1024, 64)])
def test_emulation_matches_jax_op(jref, b, k, n, knz):
    """Against the Pallas kernel itself, run in interpret mode."""
    x, idx, wt = _case(b, k, n, knz)
    got = _emulate(x, idx, wt, _plan_split(knz, n))
    jnp = jref["jnp"]
    want = np.asarray(jref["op"](jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()),
                                 jnp.asarray(wt.numpy())))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("split", SPLITS)
def test_emulated_rows_equal_across_b(split):
    """A row's bits do not depend on how many rows ride with it."""
    x, idx, wt = _case(300, 1024, 256, 300)
    whole = _emulate(x, idx, wt, split)
    for b in (1, 3, 4, 9, 40):
        assert torch.equal(_emulate(x[:b], idx, wt, split), whole[:b]), b


def test_emulation_zero_weight_or_x_gives_exact_zeros():
    x, idx, wt = _case(4, 512, 256, 130)
    for split in SPLITS:
        assert (_emulate(x, idx, torch.zeros_like(wt), split) == 0).all()
        assert (_emulate(torch.zeros_like(x), idx, wt, split) == 0).all()


# --------------------------------------------------- the split and the plan


@pytest.mark.parametrize("knz", [0, 1, 7, 31, 32, 33, 512, 1408, 36864, 147456])
@pytest.mark.parametrize("split", SPLITS)
def test_every_split_covers_each_chunk_once(knz, split):
    """The blocks' ranges are contiguous, ascending and disjoint and cover
    every chunk once; each block keeps at least one chunk where the split
    does not exceed the chunks (which the plan and the kernel require)."""
    n_chunks = -(-knz // build.SMV_CHUNK)
    ranges = _ranges(n_chunks, split)
    assert [c for rng in ranges for c in rng] == list(range(n_chunks))
    sizes = [len(rng) for rng in ranges]
    assert max(sizes) == -(-n_chunks // split)
    if split <= n_chunks:
        assert min(sizes) >= 1
    rows = [r for rng in ranges for c in rng
            for r in range(c * build.SMV_CHUNK, min((c + 1) * build.SMV_CHUNK, knz))]
    assert rows == list(range(knz))


@pytest.mark.parametrize("shape,plan", PLANS)
def test_plan_at_the_main_shapes(shape, plan):
    assert build.sparse_matvec_plan(*shape, SMS) == plan


@pytest.mark.parametrize("knz", [0, 1, 7, 40, 64, 512, 1408, 36864, 147456])
@pytest.mark.parametrize("n", [1, 96, 130, 256, 2048, 5632, 32000])
@pytest.mark.parametrize("sms", [8, 132])
def test_plan_fits_the_kernel_and_fills_the_card(knz, n, sms):
    """A tile the kernel takes; a split that is a power of two up to 8 and
    leaves every block two chunks (or is 1); a grid within two blocks per SM
    once split, reaching half the SMs unless the tile is the narrowest, and
    past one block per SM wherever the split stopped short of 8 with chunks
    to spare."""
    tile, split = build.sparse_matvec_plan(knz, n, sms)
    n_chunks = -(-knz // build.SMV_CHUNK)
    assert tile in build.SMV_TILES and split in SPLITS
    assert split == 1 or n_chunks >= 2 * split
    blocks = -(-n // tile) * split
    if split > 1:
        assert blocks <= 2 * sms
    if tile != build.SMV_TILES[-1]:
        assert 2 * blocks >= sms
    if split < build.SMV_MAX_SPLIT and n_chunks >= 4 * split:
        assert blocks > sms


def test_plan_and_route_rules_take_no_b():
    """The split and tile are chosen from (knz, N, SMs), the route from the
    weight alone: B is not an input of either."""
    assert list(inspect.signature(build.sparse_matvec_plan).parameters) == ["knz", "n", "sms"]
    assert list(inspect.signature(build.sparse_matvec_route).parameters) == ["wt"]


@pytest.mark.parametrize("n,dtype,offset,route", [
    (2048, torch.bfloat16, 0, "async_copy"), (256, torch.bfloat16, 0, "async_copy"),
    (96, torch.bfloat16, 0, "async_copy"), (512, torch.float32, 0, "async_copy"),
    (130, torch.bfloat16, 0, "cuda_cores"), (1, torch.float32, 0, "cuda_cores"),
    (40, torch.bfloat16, 0, "async_copy"), (36, torch.bfloat16, 0, "cuda_cores"),
    (200, torch.bfloat16, 0, "async_copy"), (130, torch.float32, 0, "cuda_cores"),
    (1024, torch.float32, 1, "cuda_cores"), (1024, torch.bfloat16, 8, "async_copy"),
])
def test_route_rule(n, dtype, offset, route):
    """cp.async where every kept row's segment starts 16-byte aligned,
    plain loads elsewhere."""
    flat = torch.zeros(4 * n + offset, dtype=dtype)
    wt = flat[offset:].view(4, n)
    assert build.sparse_matvec_route(wt) == route


def test_wrapper_counts_each_route(monkeypatch):
    """A CUDA-side call (meta tensors, a fake launcher) counts its launch
    and its route; CPU calls count nothing."""
    calls = []

    def fake(x_nz, idx, wt):
        calls.append(build.sparse_matvec_route(wt))
        return torch.empty((x_nz.shape[0], wt.shape[1]), device=x_nz.device)

    fn = smv_kernel.sparse_matvec_kernel
    monkeypatch.setattr(build, "launch_sparse_matvec", fake)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "routes", dict.fromkeys(build.SMV_ROUTES, 0))
    idx = torch.empty((16,), dtype=torch.int32, device="meta")
    for b in (1, 4, 9):
        for n in (256, 130):
            ops.sparse_matvec(torch.empty((b, 16), device="meta"), idx,
                              torch.empty((64, n), device="meta", dtype=torch.bfloat16))
    assert fn.launches == 6 and fn.routes == {"async_copy": 3, "cuda_cores": 3}
    assert calls == ["async_copy", "cuda_cores"] * 3
    x, idx, wt = _case(2, 64, 40, 16)
    ops.sparse_matvec(x, idx, wt)
    assert fn.launches == 6 and len(calls) == 6


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n,knz,xdtype,wdtype,offset", [
    (4, 2048, 2048, 512, torch.bfloat16, torch.bfloat16, 0),
    (4, 2048, 256, 512, torch.bfloat16, torch.bfloat16, 0),
    (4, 2048, 5632, 512, torch.bfloat16, torch.bfloat16, 0),
    (4, 5632, 2048, 1408, torch.bfloat16, torch.bfloat16, 0),
    (4, 2048, 32000, 512, torch.bfloat16, torch.bfloat16, 0),
    (1, 2048, 2048, 512, torch.float32, torch.bfloat16, 0),
    (7, 2048, 130, 700, torch.bfloat16, torch.bfloat16, 0),    # plain loads: N odd
    (9, 1024, 1024, 300, torch.float32, torch.bfloat16, 1),    # plain loads: misaligned
    (300, 512, 96, 77, torch.bfloat16, torch.bfloat16, 0),
    (4, 20000, 256, 12000, torch.bfloat16, torch.float32, 0),  # 47 chunks a block
])
def test_cuda_kernel_equals_emulation_bit_for_bit(cuda, b, k, n, knz, xdtype, wdtype, offset):
    """The kernel on both routes gives the emulated chain's bits."""
    x, idx, wt = (t.to(cuda) for t in _case(b, k, n, knz))
    flat = torch.zeros(wt.numel() + offset, device=cuda, dtype=wdtype)
    w = flat[offset:].view(k, n)
    w.copy_(wt)
    xk = x.to(xdtype)
    got = smv_kernel.sparse_matvec_kernel(xk, idx, w)
    want = _emulate(xk.float(), idx, w.float(), build.sparse_matvec_plan(
        knz, n, build.sm_count(cuda.index or 0))[1])
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
