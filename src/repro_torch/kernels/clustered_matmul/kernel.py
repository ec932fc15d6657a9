"""Clustered-weight matmul: Hopper kernel + plain version.

Replaces the TPU kernel ``clustered_matmul_pallas``
(``src/repro/kernels/clustered_matmul/kernel.py:39``).  The CUDA source is
``src/repro_torch/csrc/clustered_matmul.cu``; its note gives the bound on an
H100 (every weight is read, one byte per int8 id: bytes at a few rows,
operations at a 256-row prefill) and the two routes, chosen by
``build.mma_route`` from the shape and x's type (never from M) and
counted in ``clustered_matmul_kernel.routes``:

* ``"tensor_cores"`` (bf16 x, N a multiple of 64, K of 8):
  ``csrc/block_mma.cuh``, 64 weight columns per thread block against up
  to 256 tokens, K in 64-row chunks TMA-loaded into a ring of stages, the
  codebook split into three bf16 parts and three ``wgmma`` per k16 step into
  a fresh fp32 tile per chunk, the chunks summed on the CUDA cores (see
  ``sonic_matmul.kernel.split_codebook_bf16``); its floor at a 256-row
  prefill of tinyllama-1.1b is the three products' tensor-core time, ~1.6
  ms a step on an H100 (one product: ~0.55 ms, the operations bound);
* ``"cuda_cores"`` (fp32 x, other shapes): the dense case of the tiled
  kernel in ``csrc/block_sparse_kernels.cuh``, fp32 FMAs.

Neither splits K, and the M edge is masked in the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.utils.rows import plain_rows


def clustered_matmul_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32
    ids: torch.Tensor,  # (K, N) int8 / int32
    codebook: torch.Tensor,  # (C,) fp32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: look each id up in the
    codebook and contract in fp32.  Returns y (M, N) fp32; a row's bits do
    not depend on M (``utils.rows``)."""
    w = codebook.float()[ids.long()]
    return plain_rows(lambda xx: xx.float() @ w, x)


def clustered_matmul_kernel(
    x: torch.Tensor, ids: torch.Tensor, codebook: torch.Tensor
) -> torch.Tensor:
    """y (M, N) fp32 = x (M, K) @ codebook[ids].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of ``build.mma_route``'s route (counted in
    ``clustered_matmul_kernel.launches`` and ``.routes[route]``) or
    raises."""
    if x.device.type == "cpu":
        return clustered_matmul_plain(x, ids, codebook)
    route = build.mma_route(*ids.shape, x.dtype, dense=True)
    if route == build.TENSOR_CORES:
        y = build.launch_clustered(x, ids, codebook, "clustered_matmul_mma")
    else:
        y = build.launch_clustered(x, ids, codebook)
    clustered_matmul_kernel.launches += 1
    clustered_matmul_kernel.routes[route] += 1
    return y


clustered_matmul_kernel.launches = 0
clustered_matmul_kernel.routes = dict.fromkeys(build.ROUTES, 0)
