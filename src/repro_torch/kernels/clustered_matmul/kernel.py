"""Clustered-weight matmul: Hopper kernel + plain version.

Replaces the TPU kernel ``clustered_matmul_pallas``
(``src/repro/kernels/clustered_matmul/kernel.py:39``).  The CUDA source is
``src/repro_torch/csrc/clustered_matmul.cu``; its note gives the bound on an
H100 (every weight is read, one byte per int8 id: bytes at a few rows,
operations at a 256-row prefill) and the design: the dense case of the
tiled kernel in ``csrc/block_sparse_kernels.cuh``, the codebook staged in
shared memory, K walked in order, the M edge masked in the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def clustered_matmul_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32
    ids: torch.Tensor,  # (K, N) int8 / int32
    codebook: torch.Tensor,  # (C,) fp32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: look each id up in the
    codebook and contract in fp32.  Returns y (M, N) fp32."""
    return x.float() @ codebook.float()[ids.long()]


def clustered_matmul_kernel(
    x: torch.Tensor, ids: torch.Tensor, codebook: torch.Tensor
) -> torch.Tensor:
    """y (M, N) fp32 = x (M, K) @ codebook[ids].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``clustered_matmul_kernel.launches``) or
    raises."""
    if x.device.type == "cpu":
        return clustered_matmul_plain(x, ids, codebook)
    y = build.launch_clustered(x, ids, codebook)
    clustered_matmul_kernel.launches += 1
    return y


clustered_matmul_kernel.launches = 0
