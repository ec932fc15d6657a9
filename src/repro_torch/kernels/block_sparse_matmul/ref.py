"""Densify-then-matmul oracle for the int8 block-sparse matmul."""
from __future__ import annotations

import torch

from repro_torch.core.sonic_layers import BlockSparseWeightInt8


def block_sparse_matmul_int8_ref(
    x: torch.Tensor,  # (M, K)
    values: torch.Tensor,  # (Nb, R, bk, bn) int8 kept blocks
    scales: torch.Tensor,  # (Nb, R) fp32 per-block dequant scales
    indices: torch.Tensor,  # (Nb, R) int32 K-block ids
    k_blocks: int,
) -> torch.Tensor:
    """fp32 oracle: dequantize, densify, matmul.  Returns x.dtype."""
    w = BlockSparseWeightInt8(values, scales, indices, k_blocks).dense(torch.float32)
    return (x.float() @ w).to(x.dtype)
