"""Densify-then-matmul oracle for the clustered matmul."""
from __future__ import annotations

import torch


def clustered_matmul_ref(
    x: torch.Tensor,  # (M, K)
    indices: torch.Tensor,  # (K, N) int8/int32 cluster ids
    codebook: torch.Tensor,  # (C,) fp32 centroids
) -> torch.Tensor:
    """y = x @ codebook[indices] with the weight cast to x.dtype, fp32
    accumulation, y in x.dtype."""
    w = codebook[indices.long()].to(x.dtype)
    return (x.float() @ w.float()).to(x.dtype)
