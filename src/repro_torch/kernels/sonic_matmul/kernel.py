"""Int8 block-sparse matvec for decode rows (M < 8): Hopper kernel + plain version.

Replaces the TPU kernel ``sonic_matvec_int8_pallas``
(``src/repro/kernels/sonic_matmul/kernel.py:93``).  The CUDA source is
``src/repro_torch/csrc/sonic_matvec_int8.cu``; its note gives the bound on an
H100 (bytes: the kept int8 weights plus scales over 3.35 TB/s, since each
weight byte feeds at most 7 multiply-adds) and the design: one thread block
per (N-block, 32-column slice), the x rows of each kept block staged in
shared memory, the int8 rows streamed once with coalesced 4-byte loads, fp32
accumulation, and a fixed-order shared-memory reduction with no atomics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_sparse_matmul.kernel import (
    block_sparse_matmul_int8_plain,
)

# Rows the CUDA kernel is instantiated for: the decode rows below
# ``ops.DECODE_M_THRESHOLD``.
MAX_ROWS = 7


def sonic_matvec_int8_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32, M ≤ 7
    values: torch.Tensor,  # (Nb, R, bk, bn) int8
    scales: torch.Tensor,  # (Nb, R) fp32
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same gather-dequantize-
    contract as the prefill kernel's plain version (only the launch shape of
    the CUDA kernels differs).  Returns y (M, Nb·bn) fp32."""
    return block_sparse_matmul_int8_plain(x, values, scales, indices)


def sonic_matvec_int8_kernel(
    x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ the int8 block-sparse weight, M ≤ 7.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``sonic_matvec_int8_kernel.launches``) or
    raises."""
    if x.device.type == "cpu":
        return sonic_matvec_int8_plain(x, values, scales, indices)
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"sonic_matvec_int8: x must be (M ≤ {MAX_ROWS}, K), "
                         f"got {tuple(x.shape)}")
    y = build.launch_int8("sonic_matvec_int8", x, values, scales, indices)
    sonic_matvec_int8_kernel.launches += 1
    return y


sonic_matvec_int8_kernel.launches = 0
