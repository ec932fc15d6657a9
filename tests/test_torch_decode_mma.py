"""The decode matvecs' tensor-core route, checked on the CPU.

``sonic_matvec_int8`` and ``sonic_matvec`` take bf16 x on the card through
``csrc/decode_mma.cuh``: the arithmetic of the matmuls' tensor-core route
(one fresh fp32 tile per chunk of min(bk, 64) kept rows, one bf16 part per
int8 value or three per centroid, the tiles added into the output in
ascending chunk order, times the kept block's scale for int8), with a
64-column tile's chunks dealt to a cluster of ``build.decode_split`` thread
blocks whose tiles are combined in that one order.  The CUDA kernel runs
only on the card (tests marked ``cuda`` in ``tests/test_torch_kernels.py``);
here, on numpy-seeded inputs:

* an emulation of the decode kernel's chunk partition and ordered combine at
  M ≤ 7 gives bit for bit the emulated matmul route's rows inside windows of
  M = 8, 12, 20 and 256, at every split, for both weight policies;
* the same emulations match the port's plain versions and the JAX package's
  references (``src/repro/kernels/sonic_matmul/ref.py``) within 1e-4;
* every split of a tile's chunks covers each chunk once, and each of the
  tile's fragment slots has one combining block;
* the routing rule and the split rule, and the wrappers' ``.routes``
  counters, none of which looks at M.

Run on its own with
``PYTHONPATH=src python -m pytest -q tests/test_torch_decode_mma.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.sonic_matmul import kernel as sm_kernel
from repro_torch.kernels.sonic_matmul.kernel import split_codebook_bf16

TOL = dict(rtol=1e-4, atol=1e-4)  # what chip_smoke.py and the card tests hold the kernels to
SPLITS = (1, 2, 4, 8)
WINDOWS = (8, 12, 20, 256)  # verify windows B·(k+1), B = 4, k = 1, 2, 4; a prefill
DECODE_ROWS = (1, 4, 7)
BLOCKS = [(128, 128), (32, 64), (16, 128)]  # chunks of 64, 32 and 16 rows


@pytest.fixture(scope="module")
def jref():
    """The JAX package's jnp oracles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.sonic_matmul.ref import sonic_matvec_int8_ref, sonic_matvec_ref

    return dict(jnp=jnp, int8=sonic_matvec_int8_ref, codebook=sonic_matvec_ref)


def _x_bf16(m, k, seed=1):
    """Normal draws rounded to bf16, carried as fp32."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float()


def _weights(k, n, block, sparsity=0.5, seed=2):
    """An int8 weight quantized per kept block as the converters do (scale =
    max|w| / 127), and int8 cluster ids in [0, 64) with a 64-centroid
    codebook on the same kept blocks, all at the models' scale (K**-0.5)."""
    rng = np.random.default_rng(seed)
    bk, bn = block
    kb = k // bk
    r = max(1, round((1 - sparsity) * kb))
    indices = np.stack([np.sort(rng.permutation(kb)[:r]) for _ in range(n // bn)])
    w = rng.standard_normal((*indices.shape, *block)).astype(np.float32) * k**-0.5
    scales = (np.abs(w).max(axis=(2, 3)) / 127).astype(np.float32)
    values = np.round(w / scales[:, :, None, None]).astype(np.int8)
    ids = rng.integers(0, 64, values.shape).astype(np.int8)
    codebook = (rng.standard_normal(64) * k**-0.5).astype(np.float32)
    return {name: torch.from_numpy(a) for name, a in
            dict(values=values, scales=scales, indices=indices.astype(np.int32), ids=ids,
                 codebook=codebook).items()}


def _parts(w, policy):
    """The bf16 parts (carried as fp64) of each kept weight, in the order the
    kernels issue them (lo, then mid, then hi), and the per-block scales."""
    if policy == "int8":
        return [w["values"].double()], w["scales"]
    parts = split_codebook_bf16(w["codebook"])
    return [p.double()[w["ids"].long()] for p in reversed(parts)], None


def _chunk_tiles(x, parts, indices):
    """Each chunk's fresh fp32 tile (M, Nb, bn), in the kernels' (kept block,
    then chunk) order: bf16 x times every part, summed exactly (fp64: each
    product has at most 24 significant bits) and rounded once to fp32.  A
    row's tile does not depend on the other rows."""
    nb, r, bk, bn = parts[0].shape
    chunk = min(bk, build.MMA_CHUNK)
    xd = x.double()
    tiles = []
    for rr in range(r):
        for k0 in range(0, bk, chunk):
            cols = indices[:, rr].long()[:, None] * bk + k0 + torch.arange(chunk)  # (Nb, chunk)
            xs = xd[:, cols]  # (M, Nb, chunk)
            tile = sum((xs[..., None] * p[None, :, rr, k0:k0 + chunk]).sum(2) for p in parts)
            tiles.append(tile.float())
    return tiles


def _add(out, tile, s):
    """The kernels' add of one tile into the output: fmaf(s, tile, out), one
    rounding (the product is exact in fp64), or out + tile."""
    if s is None:
        return out + tile
    return (s.double()[None, :, None] * tile.double() + out.double()).float()


def _chunk_scales(scales, per_block):
    return None if scales is None else scales.repeat_interleave(per_block, dim=1)


def _emulate_matmul(x, parts, indices, scales):
    """The matmul route (mma_kernel): one block walks a tile's chunks in
    order, adding each tile as it finishes."""
    tiles = _chunk_tiles(x, parts, indices)
    per_block = len(tiles) // indices.shape[1]
    sc = _chunk_scales(scales, per_block)
    out = torch.zeros_like(tiles[0])
    for c, tile in enumerate(tiles):
        out = _add(out, tile, None if sc is None else sc[:, c])
    return out.reshape(x.shape[0], -1)


def _ranges(n_chunks, split):
    """The chunks of each block of a cluster as decode_kernel deals them:
    balanced contiguous ranges, block q from q·n / split (floor)."""
    return [range(q * n_chunks // split, (q + 1) * n_chunks // split) for q in range(split)]


def _emulate_decode(x, parts, indices, scales, split):
    """The decode kernel at M ≤ 7: tokens padded to 8 with zero rows, each
    block's chunk tiles computed in its own range and sent to the combining
    block's rows by chunk; each of the tile's 512 fragment slots combined by
    one block, ascending over the chunks.  Split 1 adds in registers, in
    the same order."""
    m = x.shape[0]
    assert m <= 7
    xp = torch.cat([x, torch.zeros((8 - m, x.shape[1]))])
    tiles = _chunk_tiles(xp, parts, indices)
    per_block = len(tiles) // indices.shape[1]
    sc = _chunk_scales(scales, per_block)
    received = {}
    for rng in _ranges(len(tiles), split):  # each block's own chunks
        for c in rng:
            received[c] = tiles[c]
    out = torch.zeros_like(tiles[0])
    for c in sorted(received):  # the combining block's walk over its rows
        out = _add(out, received[c], None if sc is None else sc[:, c])
    return out.reshape(8, -1)[:m]


def _plain(policy, x, w):
    if policy == "int8":
        return sm_kernel.sonic_matvec_int8_plain(x, w["values"], w["scales"], w["indices"])
    return sm_kernel.sonic_matvec_plain(x, w["ids"], w["codebook"], w["indices"])


# ------------------------------------------- a row's bits across the threshold


@pytest.mark.parametrize("policy", ["int8", "codebook"])
@pytest.mark.parametrize("block", BLOCKS)
def test_emulated_decode_rows_equal_matmul_window_rows(policy, block):
    """At every split, a row at M = 1, 4, 7 through the emulated decode
    kernel equals bit for bit the same row of the emulated matmul route at
    M = 8, 12, 20 and 256."""
    k, n = 512, 256
    w = _weights(k, n, block)
    parts, scales = _parts(w, policy)
    x = _x_bf16(max(WINDOWS), k)
    windows = {big: _emulate_matmul(x[:big], parts, w["indices"], scales) for big in WINDOWS}
    for m in DECODE_ROWS:
        for split in SPLITS:
            row = _emulate_decode(x[:m], parts, w["indices"], scales, split)
            for big, y in windows.items():
                assert torch.equal(row, y[:m]), (m, split, big)


@pytest.mark.parametrize("policy", ["int8", "codebook"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("k", [1024, 2048])
def test_emulated_decode_matches_plain_and_jax(jref, policy, block, k):
    """The emulated decode kernel at M = 1 … 7 within 1e-4 of the port's
    plain version and of the JAX package's reference
    (``sonic_matvec_int8_ref`` / ``sonic_matvec_ref``)."""
    n = 256
    w = _weights(k, n, block)
    parts, scales = _parts(w, policy)
    x = _x_bf16(7, k)
    entry = "sonic_matvec_int8_mma" if policy == "int8" else "sonic_matvec_mma"
    split = build.decode_split(*build.decode_chunks(w["values"]), sms=132,
                               blocks_per_sm=build.DECODE_BLOCKS_PER_SM[entry])
    jnp = jref["jnp"]
    for m in range(1, 8):
        got = _emulate_decode(x[:m], parts, w["indices"], scales, split)
        torch.testing.assert_close(got, _plain(policy, x[:m], w), **TOL)
        args = ((w["values"], w["scales"]) if policy == "int8" else (w["ids"], w["codebook"]))
        want = np.asarray(jref[policy](jnp.asarray(x[:m].numpy()),
                                       *(jnp.asarray(a.numpy()) for a in args),
                                       jnp.asarray(w["indices"].numpy()), k // block[0]))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("policy", ["int8", "codebook"])
def test_emulated_decode_zero_weights_or_x_give_exact_zeros(policy):
    w = _weights(512, 128, (64, 64))
    zero = dict(w, values=torch.zeros_like(w["values"]), codebook=torch.zeros_like(w["codebook"]))
    x = _x_bf16(4, 512)
    for split in SPLITS:
        parts, scales = _parts(zero, policy)
        assert (_emulate_decode(x, parts, w["indices"], scales, split) == 0).all()
        parts, scales = _parts(w, policy)
        assert (_emulate_decode(torch.zeros_like(x), parts, w["indices"], scales, split) == 0).all()


# ------------------------------------------------ the split and its partition


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 7, 8, 16, 44, 100, 512])
@pytest.mark.parametrize("split", SPLITS)
def test_every_split_covers_each_chunk_once(n_chunks, split):
    """The blocks' ranges are contiguous, ascending and disjoint, cover
    every chunk once, each at least one (split ≤ chunks) and at most
    ceil(chunks / split), and the tile's 512 fragment slots are shared out
    512 / split to each block, each slot to one."""
    ranges = _ranges(n_chunks, split)
    covered = [c for rng in ranges for c in rng]
    assert covered == list(range(n_chunks))
    sizes = [len(rng) for rng in ranges]
    assert max(sizes) == -(-n_chunks // split)
    if split <= n_chunks:
        assert min(sizes) >= 1
    share = build.DECODE_SLOTS // split
    owners = [f // share for f in range(build.DECODE_SLOTS)]
    assert sorted(set(owners)) == list(range(split))
    assert all(owners.count(q) == share for q in range(split))


# tinyllama-1.1b's projections at (128, 128) blocks, sparsity 0.5: (chunks
# per 64-column tile, tiles), and the split on 132 SMs for the int8 kernel
# (4 blocks per SM) and the codebook kernel (2): the fastest split of each
# at each shape on an H100 (PERF.md, tools/decode_mma_clocks.py)
TINYLLAMA_SPLITS = [((16, 32), 8, 4),    # q, o: 2048 -> 2048
                    ((16, 4), 8, 8),     # k, v: 2048 -> 256
                    ((16, 88), 4, 2),    # wi, wg: 2048 -> 5632
                    ((44, 32), 8, 4),    # ffn wo: 5632 -> 2048
                    ((16, 500), 1, 1)]   # LM head: 2048 -> 32000


@pytest.mark.parametrize("shape,int8,codebook", TINYLLAMA_SPLITS)
def test_decode_split_at_tinyllama_shapes(shape, int8, codebook):
    per_sm = build.DECODE_BLOCKS_PER_SM
    assert build.decode_split(*shape, 132, per_sm["sonic_matvec_int8_mma"]) == int8
    assert build.decode_split(*shape, 132, per_sm["sonic_matvec_mma"]) == codebook


@pytest.mark.parametrize("n_chunks", [1, 2, 8, 16, 44, 100, 512, 640])
@pytest.mark.parametrize("tiles", [1, 4, 32, 88, 500])
@pytest.mark.parametrize("per_sm", [2, 4])
def test_decode_split_fits_and_never_grows_with_tiles(n_chunks, tiles, per_sm):
    """The split is a power of two up to 8; within 64 chunks and the
    received bytes per block wherever the shape allows it; never larger for
    more tiles (it reads no M: the rule's only inputs are the weight's
    shape and the card)."""
    split = build.decode_split(n_chunks, tiles, 132, per_sm)
    assert split in SPLITS and split <= max(n_chunks, 1)
    fits = (-(-n_chunks // 8) <= build.DECODE_MAX_LOCAL
            and build.decode_recv(n_chunks, 8) <= build.DECODE_MAX_RECV)
    if fits:
        assert -(-n_chunks // split) <= build.DECODE_MAX_LOCAL
        assert build.decode_recv(n_chunks, split) <= build.DECODE_MAX_RECV
    assert build.decode_split(n_chunks, 2 * tiles, 132, per_sm) <= split


def test_decode_checks_raise_before_a_launch():
    """What the decode kernel does not take raises in the wrapper: more than
    7 rows, fp32 x, blocks off the tensor-core route, a split that is not a
    power of two up to 8, more chunks per tile than 8 blocks hold."""
    values = torch.empty((2, 4, 128, 128), dtype=torch.int8, device="meta")
    x = torch.empty((4, 512), dtype=torch.bfloat16, device="meta")
    name = "sonic_matvec_int8_mma"
    assert build._check_decode(name, x, values, 2) == (2,)
    assert build._check_decode("sonic_matvec_int8", x, values, None) == ()
    for bad_x, bad_values, split in [
            (torch.empty((8, 512), dtype=torch.bfloat16, device="meta"), values, 1),
            (x.float(), values, 1),
            (x, torch.empty((2, 4, 128, 32), dtype=torch.int8, device="meta"), 1),
            (x, values, 3), (x, values, 16),
            (x, torch.empty((2, 1, 64, 128), dtype=torch.int8, device="meta"), 2),
            (torch.empty((4, 65536), dtype=torch.bfloat16, device="meta"),
             torch.empty((2, 512, 128, 128), dtype=torch.int8, device="meta"), 8)]:
        with pytest.raises(ValueError):
            build._check_decode(name, bad_x, bad_values, split)


# ------------------------------------------------------- routing and counts


@pytest.mark.parametrize("bk,bn,dtype,route", [
    (128, 128, torch.bfloat16, "tensor_cores"),
    (64, 128, torch.bfloat16, "tensor_cores"),
    (32, 64, torch.bfloat16, "tensor_cores"),
    (16, 64, torch.bfloat16, "tensor_cores"),
    (128, 128, torch.float32, "cuda_cores"),
    (16, 16, torch.bfloat16, "cuda_cores"),
    (128, 32, torch.bfloat16, "cuda_cores"),
    (8, 128, torch.bfloat16, "cuda_cores"),
])
def test_matvec_route_rule(bk, bn, dtype, route):
    """The matvecs route as the matmuls do: bf16 x with bk a multiple of 16
    and bn of 64 on the tensor cores, the rest on the CUDA cores."""
    assert build.mma_route(bk, bn, dtype) == route


def test_matvec_wrappers_count_each_route_at_every_m(monkeypatch):
    """A CUDA-side call (meta tensors, fake launchers) of either matvec goes
    to the entry point of its route and is counted there, the same at M = 1
    … 7; CPU calls count nothing."""
    calls = []

    def fake(name, x, values, *rest):
        calls.append(name)
        return torch.empty((x.shape[0], values.shape[0] * values.shape[3]), device=x.device)

    monkeypatch.setattr(build, "launch_int8", fake)
    monkeypatch.setattr(build, "launch_codebook", fake)
    fns = (sm_kernel.sonic_matvec_int8_kernel, sm_kernel.sonic_matvec_kernel)
    for fn in fns:
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "routes", dict.fromkeys(build.ROUTES, 0))
    indices = torch.empty((2, 4), dtype=torch.int32, device="meta")
    per_block = torch.empty((2, 4), device="meta")
    codebook = torch.empty((64,), device="meta")
    for m in range(1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty((m, 1024), device="meta", dtype=dtype)
            for block in ((128, 128), (16, 16)):
                values = torch.empty((2, 4, *block), dtype=torch.int8, device="meta")
                fns[0](x, values, per_block, indices)
                fns[1](x, values, codebook, indices)
    step = ["sonic_matvec_int8_mma", "sonic_matvec_mma", "sonic_matvec_int8", "sonic_matvec"]
    assert calls[:4] == step
    assert calls[4:8] == ["sonic_matvec_int8", "sonic_matvec"] * 2
    assert calls == calls[:8] * 7
    for fn in fns:
        assert fn.routes == {"tensor_cores": 7, "cuda_cores": 21} and fn.launches == 28
    w = _weights(256, 128, (128, 128))  # CPU: plain, not counted
    x = _x_bf16(3, 256)
    fns[0](x, w["values"], w["scales"], w["indices"])
    fns[1](x, w["ids"], w["codebook"], w["indices"])
    assert all(fn.launches == 28 for fn in fns) and len(calls) == 56
