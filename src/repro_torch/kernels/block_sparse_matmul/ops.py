"""Public wrappers for the block-sparse matmul kernels."""
from __future__ import annotations

import torch

from repro_torch.core.sonic_layers import BlockSparseWeight
from repro_torch.kernels.block_sparse_matmul import kernel


def block_sparse_matmul(
    x: torch.Tensor,  # (..., K)
    w: BlockSparseWeight,
    *,
    bm: int = 256,
) -> torch.Tensor:
    """fp block-sparse x @ W → (..., N) in x.dtype, every M through one
    kernel (its route by the block shape and x's type).  ``bm`` is the
    reference's M tile, kept for its signature: the kernel picks its own
    tiles and masks the ragged M edge, and no row's result depends on the
    tiling, so ``bm`` does not change the result."""
    del bm
    lead = x.shape[:-1]
    k = x.shape[-1]
    kb_expect = w.k_blocks * w.values.shape[2]
    if k != kb_expect:
        raise ValueError(f"x has K={k}, the weight {kb_expect}")
    y = kernel.block_sparse_matmul_kernel(x.reshape(-1, k).contiguous(), w.values, w.indices)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def block_sparse_matmul_int8(
    x: torch.Tensor,  # (..., K)
    values: torch.Tensor,  # (Nb, R, bk, bn) int8
    scales: torch.Tensor,  # (Nb, R) fp32
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """Int8-weight block-sparse x @ W → (..., N) in x.dtype.  The kernel
    masks the ragged M edge itself, so x is never padded to a tile."""
    lead = x.shape[:-1]
    y = kernel.block_sparse_matmul_int8_kernel(
        x.reshape(-1, x.shape[-1]).contiguous(), values, scales, indices)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)
