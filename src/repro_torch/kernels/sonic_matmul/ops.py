"""Public wrappers for the int8 SONIC matmul: shape dispatch between the
decode-shaped matvec kernel and the tiled block-sparse matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel
from repro_torch.kernels.sonic_matmul import kernel

# Flattened row counts below this (the reference's 8) take the decode-shaped
# matvec kernel, which is instantiated for 1..MAX_ROWS rows; larger ones the
# tiled matmul kernel.
DECODE_M_THRESHOLD = kernel.MAX_ROWS + 1


def sonic_matmul_int8(
    x: torch.Tensor,  # (..., K)
    values: torch.Tensor,  # (Nb, R, bk, bn) int8
    scales: torch.Tensor,  # (Nb, R) fp32
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """Int8-weight x (..., K) @ W → (..., N) in x.dtype, shape-dispatched:
    flattened M < ``DECODE_M_THRESHOLD`` takes the matvec kernel, larger M
    the tiled block-sparse matmul kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] < DECODE_M_THRESHOLD:
        y = kernel.sonic_matvec_int8_kernel(x2, values, scales, indices)
    else:
        y = bs_kernel.block_sparse_matmul_int8_kernel(x2, values, scales, indices)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def sonic_matvec_int8(
    x: torch.Tensor,  # (K,) or (B, K), B < DECODE_M_THRESHOLD
    values: torch.Tensor,
    scales: torch.Tensor,
    indices: torch.Tensor,
) -> torch.Tensor:
    """Decode-shaped entry point: x (K,) or (B, K) → (N,) / (B, N) in
    x.dtype, always through the matvec kernel."""
    x2 = x[None] if x.dim() == 1 else x
    y = kernel.sonic_matvec_int8_kernel(x2.contiguous(), values, scales, indices)
    y = y.to(x.dtype)
    return y[0] if x.dim() == 1 else y
