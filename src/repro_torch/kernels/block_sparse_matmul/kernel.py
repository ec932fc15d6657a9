"""Int8 block-sparse matmul for prefill rows (M ≥ 8): Hopper kernel + plain version.

Replaces the TPU kernel ``block_sparse_matmul_int8_pallas``
(``src/repro/kernels/block_sparse_matmul/kernel.py:91``).  The CUDA source is
``src/repro_torch/csrc/block_sparse_matmul_int8.cu``; its note gives the
bound on an H100 (the larger of kept bytes over 3.35 TB/s and 2·M·R·bk·Nb·bn
operations over the 989 TFLOP/s bf16 tensor-core peak) and the design: one
thread block per (N-block, 64-row tile of x), kept blocks walked in
ascending order through shared memory, fp32 register tiles, the ragged M
edge masked in the kernel, no split-K.
"""
from __future__ import annotations

import torch

from repro_torch.core.sonic_layers import block_sparse_int8_matmul_plain
from repro_torch.kernels import build


def block_sparse_matmul_int8_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32
    values: torch.Tensor,  # (Nb, R, bk, bn) int8
    scales: torch.Tensor,  # (Nb, R) fp32
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the kept K-blocks of x,
    dequantize, contract in fp32.  Returns y (M, Nb·bn) fp32."""
    k_blocks = x.shape[-1] // values.shape[2]
    return block_sparse_int8_matmul_plain(x.float(), values, scales, indices, k_blocks)


def block_sparse_matmul_int8_kernel(
    x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ the int8 block-sparse weight.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``block_sparse_matmul_int8_kernel.launches``)
    or raises."""
    if x.device.type == "cpu":
        return block_sparse_matmul_int8_plain(x, values, scales, indices)
    y = build.launch_int8("block_sparse_matmul_int8", x, values, scales, indices)
    block_sparse_matmul_int8_kernel.launches += 1
    return y


block_sparse_matmul_int8_kernel.launches = 0
