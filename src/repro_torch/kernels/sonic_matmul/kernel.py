"""SONIC block-sparse matvecs and matmul: Hopper kernels + plain versions.

* ``sonic_matvec_int8_kernel`` replaces the TPU kernel
  ``sonic_matvec_int8_pallas`` (``src/repro/kernels/sonic_matmul/kernel.py:93``),
  CUDA source ``src/repro_torch/csrc/sonic_matvec_int8.cu``: decode rows,
  int8 kept blocks × one fp32 scale each.
* ``sonic_matvec_kernel`` replaces ``sonic_matvec_pallas`` (``kernel.py:37``),
  CUDA source ``src/repro_torch/csrc/sonic_matvec.cu``: decode rows, kept
  blocks of int8 cluster ids looked up in a (C ≤ 128,) fp32 codebook.
* ``sonic_matmul_kernel`` replaces ``sonic_matmul_pallas`` (``kernel.py:142``),
  CUDA source ``src/repro_torch/csrc/sonic_matmul.cu``: the same codebook
  weights for M ≥ 8 rows.

The matvecs are bound by bytes on an H100 (each weight byte feeds at most 7
multiply-adds): one thread block per (N-block, 32-column slice), the x rows
of each kept block staged in shared memory, the int8 rows streamed once
with coalesced 4-byte loads, fp32 accumulation, and a fixed-order
shared-memory reduction with no atomics.  The matmul is the tiled kernel of
``csrc/block_sparse_kernels.cuh``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_sparse_matmul.kernel import (
    block_sparse_matmul_int8_plain,
    block_sparse_matmul_plain,
)

# Rows the CUDA matvecs are instantiated for: the decode rows below
# ``ops.DECODE_M_THRESHOLD``.
MAX_ROWS = 7


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"{name}: x must be (M ≤ {MAX_ROWS}, K), got {tuple(x.shape)}")


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
    _check_rows("sonic_matvec_int8", x)
    y = build.launch_int8("sonic_matvec_int8", x, values, scales, indices)
    sonic_matvec_int8_kernel.launches += 1
    return y


sonic_matvec_int8_kernel.launches = 0


def sonic_matmul_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32
    idx_values: torch.Tensor,  # (Nb, R, bk, bn) int8 cluster ids
    codebook: torch.Tensor,  # (C,) fp32
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """The codebook kernels' function in plain PyTorch: look each kept id up
    in the codebook, gather the kept K-blocks of x, contract in fp32.  Returns
    y (M, Nb·bn) fp32."""
    return block_sparse_matmul_plain(x, codebook.float()[idx_values.long()], indices)


def sonic_matvec_plain(
    x: torch.Tensor, idx_values: torch.Tensor, codebook: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """The decode kernel's function: the matmul's plain version (only the
    launch shape of the CUDA kernels differs)."""
    return sonic_matmul_plain(x, idx_values, codebook, indices)


def sonic_matvec_kernel(
    x: torch.Tensor, idx_values: torch.Tensor, codebook: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ codebook[idx_values] (kept blocks),
    M ≤ 7.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``sonic_matvec_kernel.launches``) or raises."""
    if x.device.type == "cpu":
        return sonic_matvec_plain(x, idx_values, codebook, indices)
    _check_rows("sonic_matvec", x)
    y = build.launch_codebook("sonic_matvec", x, idx_values, codebook, indices)
    sonic_matvec_kernel.launches += 1
    return y


sonic_matvec_kernel.launches = 0


def sonic_matmul_kernel(
    x: torch.Tensor, idx_values: torch.Tensor, codebook: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ codebook[idx_values] (kept blocks),
    any M.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``sonic_matmul_kernel.launches``) or raises."""
    if x.device.type == "cpu":
        return sonic_matmul_plain(x, idx_values, codebook, indices)
    y = build.launch_codebook("sonic_matmul", x, idx_values, codebook, indices)
    sonic_matmul_kernel.launches += 1
    return y


sonic_matmul_kernel.launches = 0
