"""Decode-style attention's hand kernel (``csrc/decode_attention.cu``).

On the CPU: ``layers.decode_attention`` is its plain version bit for bit
and launches nothing; the wrapper's checks, which read shapes, types and
strides alone, raise on meta tensors it does not take and give a meta
output of the right shape otherwise; the launch plan's split is one
constant, whatever B, C and S_max.

Marked ``cuda`` (skipped without a card): the kernel against the plain
version at the benchmark cells' decode shapes (internlm2-1.8b: B 32,
S_max 1536, KH 8, G 2; mistral-nemo-12b: B 4, S_max 4096, KH 8, G 4; both
Dh 128) and at head_dim 16, 64 and 112, C 1, 2, 5 and 16, positions 0, a
split boundary ± 1 and S_max − 1 mixed across slots, bf16 and fp32; and bit
for bit that a row does not change with C, B or S_max, and that strided
views of a cache give the contiguous copy's bits.  On the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_decode_attention.py``.
"""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.models import layers as L

SPLIT = build.DA_SPLIT
# The benchmark cells' decode attention: (B, S_max, KH, G, Dh)
CELLS = {"internlm2": (32, 1536, 8, 2, 128), "nemo": (4, 4096, 8, 4, 128)}
# Other heads the registry serves: zamba2's shared block (Dh 112, G 1),
# tinyllama (Dh 64, G 8), reduced configs (Dh 16), qwen2-vl (G 6)
HEADS = {"dh16": (3, 300, 2, 2, 16), "dh64": (3, 300, 4, 8, 64), "dh112": (3, 300, 2, 1, 112),
         "g6": (2, 260, 2, 6, 128)}
WINDOWS = (1, 2, 5, 16)
# bf16 caches: the kernel rounds once, from fp32 scores, softmax and p·v;
# the reference is the plain version on the fp32-widened operands, rounded
# once to bf16 too: the two round fp32 values that differ in the order of
# their sums, so a result may sit one bf16 ulp (at most 2**-7 of it) apart
BF16_TOL = dict(rtol=2**-7, atol=1e-5)
# fp32: the same fp32 sums in another order over up to 4096 positions
FP32_TOL = dict(rtol=2e-5, atol=2e-5)


def _cache(b, s_max, kh, dh, dtype, device, seed=0, stacked=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = ((stacked,) if stacked else ()) + (b, s_max, kh, dh)
    k = torch.randn(shape, generator=gen).to(dtype).to(device)
    v = torch.randn(shape, generator=gen).to(dtype).to(device)
    return k, v


def _q(b, c, h, dh, dtype, device, seed=1):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((b, c, h, dh), generator=gen).to(dtype).to(device)


def _positions(b, s_max, c, device, seed=2):
    """Slot positions mixing 0, each side of a split boundary, S_max − C
    (so the window's last row is S_max − 1) and seeded draws."""
    edges = [0, s_max - c, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT - 1]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    draws = torch.randint(0, s_max - c + 1, (b,), generator=gen)
    pos = [min(edges[i], s_max - c) if i < len(edges) else int(draws[i]) for i in range(b)]
    return torch.tensor(pos, dtype=torch.long, device=device)


# ------------------------------------------------------------------- CPU


def test_cpu_route_is_the_plain_function_and_launches_nothing():
    b, s_max, kh, g, dh = 3, 40, 2, 2, 16
    k, v = _cache(b, s_max, kh, dh, torch.float32, "cpu")
    before = da_kernel.decode_attention_kernel.launches
    for c in (1, 3):
        q = _q(b, c, kh * g, dh, torch.float32, "cpu")
        pos = torch.tensor([0, 7, s_max - c])
        for rows in (0, 2, 16):
            got = L.decode_attention(q, k, v, pos, rows)
            want = L.decode_attention_plain(q, k, v, pos, rows)
            assert got.dtype == torch.float32 and torch.equal(got, want)
    assert da_kernel.decode_attention_kernel.launches == before


def _meta(dtype=torch.bfloat16, kv_dtype=torch.bfloat16, dh=128, pos_dtype=torch.long):
    q = torch.empty((4, 2, 8, dh), dtype=dtype, device="meta")
    k = torch.empty((4, 64, 2, dh), dtype=kv_dtype, device="meta")
    return q, k, torch.empty_like(k), torch.empty((4,), dtype=pos_dtype, device="meta")


@pytest.mark.parametrize("case,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(kv_dtype=torch.float16), TypeError),
    (dict(kv_dtype=torch.int8), TypeError),
    (dict(pos_dtype=torch.float32), TypeError),
    (dict(dh=12), ValueError),
    (dict(dh=264), ValueError),
])
def test_wrapper_checks_raise_on_meta(case, error):
    before = da_kernel.decode_attention_kernel.launches
    with pytest.raises(error):
        da_kernel.decode_attention_kernel(*_meta(**case))
    with pytest.raises(error):
        L.decode_attention(*_meta(**case))
    assert da_kernel.decode_attention_kernel.launches == before


def test_wrapper_checks_strides_and_shapes_on_meta():
    q, k, v, pos = _meta()
    bad = {
        "q's Dh not contiguous": (q.transpose(-1, -2), k, v, pos),
        "k's Dh not contiguous": (q, k.transpose(-1, -2), v, pos),
        "v's rows not 16-byte steps": (q, k, torch.empty(
            (4, 64, 2, 132), dtype=v.dtype, device="meta")[..., :128], pos),
        "KH not dividing H": (q[:, :, :7], k, v, pos),
        "k and v of other shapes": (q, k, v[:, :32], pos),
        "pos not (B,)": (q, k, v, pos[:3]),
        "pos not contiguous": (q, k, v, torch.empty((8,), dtype=torch.long,
                                                    device="meta")[::2]),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError):
            da_kernel.decode_attention_kernel(*args)
            pytest.fail(what)


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.float32),
                                              (torch.float32, torch.bfloat16)])
def test_meta_output_shape_and_type(q_dtype, kv_dtype):
    """As the plain version: the output takes the cache's type (p is cast to
    v's type before p·v), strided views are taken as they lie."""
    q, k, v, pos = _meta(q_dtype, kv_dtype)
    stacked = torch.empty((3, 4, 64, 2, 128), dtype=kv_dtype, device="meta")
    for kk, vv in ((k, v), (stacked[1], stacked[2]),
                   (torch.empty((4, 2, 64, 128), dtype=kv_dtype, device="meta").transpose(1, 2),
                    v)):
        out = da_kernel.decode_attention_kernel(q, kk, vv, pos)
        assert out.shape == q.shape and out.dtype == kv_dtype and out.device.type == "meta"


@pytest.mark.parametrize("cell", [*CELLS, *HEADS])
def test_split_is_one_constant(cell):
    """The plan's split, the one thing a row's sums follow besides its own
    position, is the same at every B, C and S_max; the grid and the
    workspace follow them."""
    b, s_max, kh, g, dh = {**CELLS, **HEADS}[cell]
    plans = [build.decode_attention_plan(bb, c, kh * g, kh, dh, ss)
             for bb in (1, b) for c in WINDOWS for ss in (1, s_max, 4 * s_max + 3)]
    assert {p["split"] for p in plans} == {SPLIT}
    for (bb, c, ss), p in zip([(bb, c, ss) for bb in (1, b) for c in WINDOWS
                               for ss in (1, s_max, 4 * s_max + 3)], plans):
        rows = c * g
        assert p["rows_per_block"] >= min(rows, build.DA_MAX_ROWS)
        assert p["rows_per_block"] <= build.DA_MAX_ROWS
        assert p["grid"] == (kh, -(-ss // SPLIT), bb * -(-rows // p["rows_per_block"]))
        assert p["part_floats"] == bb * kh * p["grid"][1] * rows * dh


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _reference(q, k, v, pos):
    """The plain version on fp32-widened operands, in the cache's type."""
    return L.decode_attention_plain(q.float(), k.float(), v.float(), pos).to(v.dtype)


def _check(cuda, shape, c, q_dtype, kv_dtype):
    b, s_max, kh, g, dh = shape
    k, v = _cache(b, s_max, kh, dh, kv_dtype, cuda)
    q = _q(b, c, kh * g, dh, q_dtype, cuda)
    pos = _positions(b, s_max, c, cuda)
    before = da_kernel.decode_attention_kernel.launches
    got = L.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert da_kernel.decode_attention_kernel.launches == before + 1
    assert got.shape == q.shape and got.dtype == kv_dtype
    tol = FP32_TOL if kv_dtype == torch.float32 and q_dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), _reference(q, k, v, pos).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("c", WINDOWS)
@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.float32),
                                              (torch.float32, torch.bfloat16)],
                         ids=["bf16", "fp32", "fp32_over_bf16"])
def test_cuda_kernel_matches_plain_at_the_cells(cuda, cell, c, q_dtype, kv_dtype):
    _check(cuda, CELLS[cell], c, q_dtype, kv_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c", WINDOWS)
@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_kernel_matches_plain_at_other_heads(cuda, head, c, dtype):
    _check(cuda, HEADS[head], c, dtype, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_rows_do_not_depend_on_c_b_or_s_max(cuda, cell, dtype):
    """Bit for bit: a verify window's row i ≡ the decode step at pos + i
    (C = 1), in windows of 2, 5 and 16; a slot alone ≡ the slot in the
    batch; the cache cut to fewer positions (still past every row's own)
    ≡ the whole S_max."""
    b, s_max, kh, g, dh = CELLS[cell]
    k, v = _cache(b, s_max, kh, dh, dtype, cuda)
    q = _q(b, 16, kh * g, dh, dtype, cuda)
    pos = _positions(b, s_max, 16, cuda)
    for c in (2, 5, 16):
        window = L.decode_attention(q[:, :c], k, v, pos)
        for i in range(c):
            step = L.decode_attention(q[:, i:i + 1].contiguous(), k, v, pos + i)
            assert torch.equal(step[:, 0], window[:, i]), (c, i)
    full = L.decode_attention(q, k, v, pos)
    for s in range(b):
        alone = L.decode_attention(q[s:s + 1], k[s:s + 1], v[s:s + 1], pos[s:s + 1])
        assert torch.equal(alone[0], full[s]), s
    pos = pos.clamp(max=s_max // 2)
    full = L.decode_attention(q, k, v, pos)
    cut = int(pos.max()) + 16 + SPLIT // 2  # past every row, not at a split edge
    short = L.decode_attention(q, k[:, :cut].contiguous(), v[:, :cut].contiguous(), pos)
    assert torch.equal(short, full)
    longer = torch.cat([k, torch.randn_like(k[:, :SPLIT + 3])], 1)
    vlonger = torch.cat([v, torch.randn_like(v[:, :SPLIT + 3])], 1)
    assert torch.equal(L.decode_attention(q, longer, vlonger, pos), full)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_strided_views_give_the_contiguous_bits(cuda, dtype):
    """A layer of a stacked (L, B, S_max, KH, Dh) cache, and a cache laid
    out (B, KH, S_max, Dh) and viewed as (B, S_max, KH, Dh), read in place:
    the bits of their contiguous copies, and no copy made."""
    b, s_max, kh, g, dh = 5, 700, 4, 2, 64
    ks, vs = _cache(b, s_max, kh, dh, dtype, cuda, stacked=3)
    q = _q(b, 5, kh * g, dh, dtype, cuda)
    pos = _positions(b, s_max, 5, cuda)
    layer = L.decode_attention(q, ks[1], vs[1], pos)
    assert torch.equal(layer, L.decode_attention(q, ks[1].clone(), vs[1].clone(), pos))
    kt, vt = ks[0].transpose(1, 2).contiguous(), vs[0].transpose(1, 2).contiguous()
    got = L.decode_attention(q, kt.transpose(1, 2), vt.transpose(1, 2), pos)
    assert torch.equal(got, L.decode_attention(q, ks[0], vs[0], pos))
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # q strided too
    assert torch.equal(L.decode_attention(qt, ks[1], vs[1], pos), layer)


@pytest.mark.cuda
def test_cuda_int32_positions_and_repeat(cuda):
    b, s_max, kh, g, dh = CELLS["nemo"]
    k, v = _cache(b, s_max, kh, dh, torch.bfloat16, cuda)
    q = _q(b, 5, kh * g, dh, torch.bfloat16, cuda)
    pos = _positions(b, s_max, 5, cuda)
    a = L.decode_attention(q, k, v, pos)
    assert torch.equal(a, L.decode_attention(q, k, v, pos.int()))
    assert torch.equal(a, L.decode_attention(q, k, v, pos))
