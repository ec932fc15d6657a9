"""Densify-then-matmul oracle for the decode-shaped int8 matvec."""
from __future__ import annotations

import torch

from repro_torch.kernels.block_sparse_matmul.ref import block_sparse_matmul_int8_ref


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
