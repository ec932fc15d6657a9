"""Block-sparse matmuls for prefill rows: Hopper kernels + plain versions.

``block_sparse_matmul_int8_kernel`` replaces the TPU kernel
``block_sparse_matmul_int8_pallas``
(``src/repro/kernels/block_sparse_matmul/kernel.py:91``), CUDA source
``src/repro_torch/csrc/block_sparse_matmul_int8.cu``: int8 kept blocks
dequantized against one fp32 scale each.  ``block_sparse_matmul_kernel``
replaces ``block_sparse_matmul_pallas`` (``kernel.py:40``), CUDA source
``src/repro_torch/csrc/block_sparse_matmul.cu``: fp32 or bf16 kept blocks.

Both have two routes, chosen by ``build.mma_route`` from the block shape
and x's type (never from M) and counted per route in each wrapper's
``.routes``:

* ``"tensor_cores"`` (bf16 x, bk a multiple of 16, bn of 64):
  ``csrc/block_mma.cuh``, the kernel of the two codebook matmuls with
  another weight policy.  64 weight columns per thread block against a
  tile of up to 256 tokens, each kept block's values and x slice
  TMA-loaded into a ring of shared-memory stages by a producer warp, one
  fresh fp32 tile per 64-row chunk summed on the CUDA cores.  An int8 value
  is exact in one bf16 part (one ``wgmma`` per k16 step), and each chunk's
  tile is added times its kept block's scale (s·(x @ w) per chunk, where
  the reference takes x @ (w·s)); an fp32 value is split into three bf16
  parts as ``split_codebook_bf16`` splits a centroid (three ``wgmma``), a
  bf16 value is one part.
* ``"cuda_cores"`` (fp32 x, smaller blocks such as ``serve_quant``'s 16×16):
  the tiled kernel of ``csrc/block_sparse_kernels.cuh``, one thread block
  per (column tile, 32-row tile of x), kept blocks walked in ascending
  order through shared memory, fp32 FMAs.

Neither splits K, and the ragged M edge is masked in the kernel.  The
sources give the bound on an H100: the larger of the bytes over 3.35 TB/s
and 2·M·kept weights over the 989 TFLOP/s bf16 tensor-core peak.
"""
from __future__ import annotations

import torch

from repro_torch.core.sonic_layers import block_sparse_int8_matmul_plain
from repro_torch.kernels import build
from repro_torch.utils.rows import plain_rows


def block_sparse_matmul_int8_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32
    values: torch.Tensor,  # (Nb, R, bk, bn) int8
    scales: torch.Tensor,  # (Nb, R) fp32
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the kept K-blocks of x,
    dequantize, contract in fp32.  Returns y (M, Nb·bn) fp32; a row's bits
    do not depend on M (``utils.rows``)."""
    k_blocks = x.shape[-1] // values.shape[2]
    return plain_rows(lambda xx: block_sparse_int8_matmul_plain(
        xx.float(), values, scales, indices, k_blocks), x)


def block_sparse_matmul_int8_kernel(
    x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ the int8 block-sparse weight.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of ``build.mma_route``'s route (counted in
    ``block_sparse_matmul_int8_kernel.launches`` and ``.routes[route]``) or
    raises."""
    if x.device.type == "cpu":
        return block_sparse_matmul_int8_plain(x, values, scales, indices)
    route = build.mma_route(values.shape[-2], values.shape[-1], x.dtype)
    name = ("block_sparse_matmul_int8_mma" if route == build.TENSOR_CORES
            else "block_sparse_matmul_int8")
    y = build.launch_int8(name, x, values, scales, indices)
    block_sparse_matmul_int8_kernel.launches += 1
    block_sparse_matmul_int8_kernel.routes[route] += 1
    return y


block_sparse_matmul_int8_kernel.launches = 0
block_sparse_matmul_int8_kernel.routes = dict.fromkeys(build.ROUTES, 0)


def block_sparse_matmul_plain(
    x: torch.Tensor,  # (M, K) bf16 / fp32
    values: torch.Tensor,  # (Nb, R, bk, bn) fp32 / bf16
    indices: torch.Tensor,  # (Nb, R) int32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the kept K-blocks of x
    and contract them with the kept blocks, both in fp32.  Returns y
    (M, Nb·bn) fp32; a row's bits do not depend on M (``utils.rows``)."""
    nb, _, bk, bn = values.shape

    def product(xx: torch.Tensor) -> torch.Tensor:
        m = xx.shape[0]
        xg = xx.float().reshape(m, -1, bk)[:, indices.long()]  # (M, Nb, R, bk)
        return torch.einsum("mnrk,nrkj->mnj", xg, values.float()).reshape(m, nb * bn)

    return plain_rows(product, x)


def block_sparse_matmul_kernel(
    x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ the fp block-sparse weight, any M.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of ``build.mma_route``'s route (counted in
    ``block_sparse_matmul_kernel.launches`` and ``.routes[route]``) or
    raises."""
    if x.device.type == "cpu":
        return block_sparse_matmul_plain(x, values, indices)
    route = build.mma_route(values.shape[-2], values.shape[-1], x.dtype)
    if route == build.TENSOR_CORES:
        y = build.launch_fp(x, values, indices, "block_sparse_matmul_mma")
    else:
        y = build.launch_fp(x, values, indices)
    block_sparse_matmul_kernel.launches += 1
    block_sparse_matmul_kernel.routes[route] += 1
    return y


block_sparse_matmul_kernel.launches = 0
block_sparse_matmul_kernel.routes = dict.fromkeys(build.ROUTES, 0)
