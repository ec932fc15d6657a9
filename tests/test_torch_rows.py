"""Rows whose bits do not depend on how many rows come with them
(``utils/rows.py``), past the dense path's 64-row floor.  No JAX: the test
marked ``cuda`` runs on the card's machine with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_rows.py``
and skips without a card.

On the CPU: ``in_row_chunks`` hands its function chunks of exactly the
asked row count (the last padded with zero rows), so a row at any M is
computed as it is in a chunk of that many rows; a stub matmul records the
shapes it is given.  On the card: ``layers.dense_apply`` gives one row the
same bits at M = 4, 64, 68, 80 and 192 (cuBLAS picks its kernel by M past
64; mistral-nemo-12b's 5120×1024 and 14336×5120 differed there before the
chunks).

Meshed serving keeps the contract: on a one-rank (1, 1) mesh
``dense_apply`` on DTensors gives the plain path's bits (exact; the CPU
test on a ``gloo`` group, the card's on ``nccl``).
"""
import pytest
import torch

from repro_torch.models import layers
from repro_torch.utils.rows import DENSE_CUDA_ROWS, at_least_rows, in_row_chunks


class _Recorder:
    """x @ w, recording the shape of every x it is given."""

    def __init__(self, w: torch.Tensor):
        self.w, self.shapes = w, []

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.shapes.append(tuple(x.shape))
        return x @ self.w


@pytest.mark.parametrize("m", [1, 4, 63, 64, 65, 68, 80, 128, 192, 257])
def test_chunks_are_products_of_exactly_the_floor(m):
    g = torch.Generator().manual_seed(m)
    w = torch.randn((48, 24), generator=g)
    x = torch.randn((m, 48), generator=g)
    rec = _Recorder(w)
    got = in_row_chunks(rec, x, DENSE_CUDA_ROWS)
    n_chunks = -(-m // DENSE_CUDA_ROWS)
    assert rec.shapes == [(DENSE_CUDA_ROWS, 48)] * n_chunks
    assert got.shape == (m, 24)
    # each row is the row of a 64-row product: the chunk it falls in,
    # zero-padded where it is the last
    for i in range(n_chunks):
        rows = x[i * DENSE_CUDA_ROWS:(i + 1) * DENSE_CUDA_ROWS]
        want = at_least_rows(lambda xx: xx @ w, rows, DENSE_CUDA_ROWS)
        assert torch.equal(got[i * DENSE_CUDA_ROWS:(i + 1) * DENSE_CUDA_ROWS], want)


def test_chunks_keep_trailing_axes_and_the_cpu_path_is_unchanged():
    """A chunked function may return more than one column axis; on the CPU
    ``dense_apply`` still pads to ``CPU_ROWS`` only (one call at any M)."""
    x = torch.arange(70 * 3, dtype=torch.float32).reshape(70, 3)
    got = in_row_chunks(lambda xx: xx[:, :, None].expand(-1, -1, 2) * 2, x, 64)
    assert torch.equal(got, x[:, :, None].expand(-1, -1, 2) * 2)
    calls = []
    w = torch.randn(3, 5)
    orig = layers.fixed_rows

    def spy(fn, xx):
        calls.append(tuple(xx.shape))
        return orig(fn, xx)

    layers.fixed_rows = spy
    try:
        layers.dense_apply({"kernel": w}, x[None])
    finally:
        layers.fixed_rows = orig
    assert calls == [(70, 3)]


@pytest.mark.cuda
def test_cuda_dense_row_does_not_depend_on_m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for k, n in ((5120, 1024), (14336, 5120), (2048, 5632)):
        w = (torch.randn((k, n), generator=g, device=dev) * k**-0.5).bfloat16()
        x = torch.randn((192, k), generator=g, device=dev).bfloat16()
        want = layers.dense_apply({"kernel": w}, x[:4])
        for m in (64, 68, 80, 192):
            assert torch.equal(layers.dense_apply({"kernel": w}, x[:m])[:4], want), (k, n, m)


def _one_rank_projection_bits(device: str, backend: str, dtype, m_rows) -> dict:
    """On a one-rank (1, 1) mesh under ``torch.inference_mode``: the entries
    of ``dense_apply`` on DTensors (x batch-split, w split as FSDP and TP
    split it) that differ from the plain path's on the same x, at
    tinyllama-1.1b's (2048 → 5632), for x of each of ``m_rows`` rows."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    g = torch.Generator().manual_seed(0)
    x = torch.randn((max(m_rows), 1, 2048), generator=g).to(device, dtype)
    w = (torch.randn((2048, 5632), generator=g) * 2048**-0.5).to(device, dtype)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
        wd = distribute_tensor(w, mesh, [Shard(0), Shard(1)])
        out = {}
        with torch.inference_mode():
            for m in m_rows:
                xd = distribute_tensor(x[:m], mesh, [Shard(0), Replicate()])
                got = layers.dense_apply({"kernel": wd}, xd).full_tensor()
                out[m] = int((got != layers.dense_apply({"kernel": w}, x[:m])).sum())
        return out
    finally:
        dist.destroy_process_group()


def test_meshed_projection_has_the_plain_bits_on_one_rank():
    """Exact, fp32 and bf16 on the CPU, where the plain path pads one row to
    two (a lone row takes another route through ``x @ W`` there)."""
    for dtype in (torch.float32, torch.bfloat16):
        assert _one_rank_projection_bits("cpu", "gloo", dtype, (1, 4)) == {1: 0, 4: 0}


@pytest.mark.cuda
def test_cuda_meshed_projection_has_the_plain_bits_on_one_rank():
    """Exact, bf16 on the card, where the plain path runs 64-row chunks
    (cuBLAS picks its kernel by M).  Run on the card's machine with
    the command of the module doc; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    assert _one_rank_projection_bits("cuda", "nccl", torch.bfloat16, (1, 4, 68)) == {
        1: 0, 4: 0, 68: 0}
