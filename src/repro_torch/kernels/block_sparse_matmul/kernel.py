"""Block-sparse matmuls for prefill rows: Hopper kernels + plain versions.

``block_sparse_matmul_int8_kernel`` replaces the TPU kernel
``block_sparse_matmul_int8_pallas``
(``src/repro/kernels/block_sparse_matmul/kernel.py:91``), CUDA source
``src/repro_torch/csrc/block_sparse_matmul_int8.cu``: int8 kept blocks
dequantized against one fp32 scale each.  ``block_sparse_matmul_kernel``
replaces ``block_sparse_matmul_pallas`` (``kernel.py:40``), CUDA source
``src/repro_torch/csrc/block_sparse_matmul.cu``: fp32 or bf16 kept blocks.

Both are the tiled kernel of ``csrc/block_sparse_kernels.cuh``: one thread
block per (column tile, 32-row tile of x), kept blocks walked in ascending
order through shared memory, fp32 register tiles, the ragged M edge masked
in the kernel, no split-K.  Their sources give the bound on an H100: the
larger of the bytes over 3.35 TB/s and 2·M·kept weights over the 989
TFLOP/s bf16 tensor-core peak.
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


def block_sparse_matmul_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32
    values: torch.Tensor,  # (Nb, R, bk, bn) fp32 / bf16
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the kept K-blocks of x
    and contract them with the kept blocks, both in fp32.  Returns y
    (M, Nb·bn) fp32."""
    nb, _, bk, bn = values.shape
    m = x.shape[0]
    xg = x.float().reshape(m, -1, bk)[:, indices.long()]  # (M, Nb, R, bk)
    return torch.einsum("mnrk,nrkj->mnj", xg, values.float()).reshape(m, nb * bn)


def block_sparse_matmul_kernel(
    x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ the fp block-sparse weight, any M.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``block_sparse_matmul_kernel.launches``) or
    raises."""
    if x.device.type == "cpu":
        return block_sparse_matmul_plain(x, values, indices)
    y = build.launch_fp(x, values, indices)
    block_sparse_matmul_kernel.launches += 1
    return y


block_sparse_matmul_kernel.launches = 0
