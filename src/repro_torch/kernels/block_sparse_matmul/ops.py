"""Public wrapper for the int8 block-sparse matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.block_sparse_matmul import kernel


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
