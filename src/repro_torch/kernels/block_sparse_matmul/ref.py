"""Densify-then-matmul oracles for the block-sparse matmuls."""
from __future__ import annotations

import torch

from repro_torch.core.sonic_layers import _densify


def block_sparse_matmul_ref(
    x: torch.Tensor,  # (M, K)
    values: torch.Tensor,  # (Nb, R, bk, bn) kept blocks
    indices: torch.Tensor,  # (Nb, R) int32 K-block ids
    k_blocks: int,
) -> torch.Tensor:
    """y = x @ dense(W_bs) with fp32 accumulation (densify-then-matmul);
    returns x.dtype."""
    w = _densify(values.float(), indices, k_blocks)
    return (x.float() @ w).to(x.dtype)


def block_sparse_matmul_int8_ref(
    x: torch.Tensor,  # (M, K)
    values: torch.Tensor,  # (Nb, R, bk, bn) int8 kept blocks
    scales: torch.Tensor,  # (Nb, R) fp32 per-block dequant scales
    indices: torch.Tensor,  # (Nb, R) int32 K-block ids
    k_blocks: int,
) -> torch.Tensor:
    """fp32 oracle for the int8 kernel: dequantize, densify, matmul."""
    deq = values.float() * scales[:, :, None, None]
    return block_sparse_matmul_ref(x, deq, indices, k_blocks)
