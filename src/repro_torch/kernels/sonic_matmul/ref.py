"""Densify-then-matmul oracles for the SONIC matmuls (codebook and int8)."""
from __future__ import annotations

import torch

from repro_torch.kernels.block_sparse_matmul.ref import (
    block_sparse_matmul_int8_ref,
    block_sparse_matmul_ref,
)


def sonic_matmul_ref(
    x: torch.Tensor,  # (M, K)
    idx_values: torch.Tensor,  # (Nb, R, bk, bn) int8 cluster ids of kept blocks
    codebook: torch.Tensor,  # (C,) fp32
    indices: torch.Tensor,  # (Nb, R) int32 K-block ids
    k_blocks: int,
) -> torch.Tensor:
    """fp32 oracle: look up, densify, matmul in fp32; returns x.dtype."""
    return block_sparse_matmul_ref(x, codebook[idx_values.long()], indices, k_blocks)


def sonic_matvec_ref(
    x: torch.Tensor,  # (K,) or (B, K) decode activations
    idx_values: torch.Tensor,
    codebook: torch.Tensor,
    indices: torch.Tensor,
    k_blocks: int,
) -> torch.Tensor:
    """Oracle for the decode-shaped matvec — same math, decode shapes."""
    x2 = x[None] if x.dim() == 1 else x
    y = sonic_matmul_ref(x2, idx_values, codebook, indices, k_blocks)
    return y[0] if x.dim() == 1 else y


def sonic_matvec_int8_ref(
    x: torch.Tensor,  # (K,) or (B, K) decode activations
    values: torch.Tensor,
    scales: torch.Tensor,
    indices: torch.Tensor,
    k_blocks: int,
) -> torch.Tensor:
    """Oracle for the decode-shaped int8 matvec — same math, decode shapes."""
    x2 = x[None] if x.dim() == 1 else x
    y = block_sparse_matmul_int8_ref(x2, values, scales, indices, k_blocks)
    return y[0] if x.dim() == 1 else y
