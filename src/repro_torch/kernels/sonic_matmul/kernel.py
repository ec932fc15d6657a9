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
  weights for M ≥ 8 rows (any M on the card).

The matvecs are bound by bytes on an H100 (each weight byte feeds at most 7
multiply-adds).  Each has two routes, chosen by ``build.mma_route`` from the
block shape and x's type (never from M) and counted per route in its
wrapper's ``.routes``:

* ``"tensor_cores"`` (bf16 x, bk a multiple of 16, bn of 64):
  ``csrc/decode_mma.cuh`` (entry points ``sonic_matvec_int8_mma``,
  ``sonic_matvec_mma``).  The arithmetic of the matmuls' tensor-core route
  (one fresh ``wgmma`` tile per 64-row chunk, the tiles added in ascending
  order), so a decode row has the bits of the same row in a prefill or
  verify window of ``block_sparse_matmul_int8`` / ``sonic_matmul``; the
  chunks of a 64-column tile are spread over a cluster of
  ``build.decode_split`` thread blocks and combined in order through
  distributed shared memory.
* ``"cuda_cores"`` (fp32 x, smaller blocks): one thread block per (N-block,
  32-column slice), the x rows of each kept block staged in shared memory,
  the int8 rows streamed once with coalesced 4-byte loads, fp32
  accumulation, and a fixed-order shared-memory reduction with no atomics.

The matmul has the same two routes, counted in
``sonic_matmul_kernel.routes``:

* ``"tensor_cores"`` (bf16 x, bk a multiple of 16, bn of 64):
  ``csrc/block_mma.cuh``.  64 weight columns per thread block against a
  tile of up to 256 tokens (yᵀ = Wᵀ xᵀ, so 4 rows pad to 8), each kept
  block's ids and x slice TMA-loaded into a ring of shared-memory stages by
  a producer warp, each centroid split into three bf16 parts
  (``split_codebook_bf16``) so that three ``wgmma`` per k16 step carry the
  fp32 centroid whole into a fresh fp32 tile per 64-row chunk, the chunks
  summed on the CUDA cores.  Its floor at a 256-row
  prefill of tinyllama-1.1b is the three products' tensor-core time, ~0.8
  ms a step on an H100 (the bytes bound is ~0.35 ms).
* ``"cuda_cores"`` (fp32 x, smaller blocks): the tiled kernel of
  ``csrc/block_sparse_kernels.cuh``, fp32 FMAs.
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
    of ``build.mma_route``'s route (counted in
    ``sonic_matvec_int8_kernel.launches`` and ``.routes[route]``) or
    raises."""
    if x.device.type == "cpu":
        return sonic_matvec_int8_plain(x, values, scales, indices)
    _check_rows("sonic_matvec_int8", x)
    route = build.mma_route(values.shape[-2], values.shape[-1], x.dtype)
    name = "sonic_matvec_int8_mma" if route == build.TENSOR_CORES else "sonic_matvec_int8"
    y = build.launch_int8(name, x, values, scales, indices)
    sonic_matvec_int8_kernel.launches += 1
    sonic_matvec_int8_kernel.routes[route] += 1
    return y


sonic_matvec_int8_kernel.launches = 0
sonic_matvec_int8_kernel.routes = dict.fromkeys(build.ROUTES, 0)


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


def split_codebook_bf16(
    codebook: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split fp32 centroids into three bf16 tensors that sum back to them:
    hi = bf16(c), mid = bf16(c − hi), lo = bf16(c − hi − mid), each
    difference exact in fp32.  hi + mid carries a centroid to within 2⁻¹⁶
    relative, hi + mid + lo carries it whole; an all-zero codebook splits
    into zeros.  The tensor-core kernels do the same arithmetic as each
    thread block stages the codebook, and take the three parts (bf16 x is
    exact, so x·lo + x·mid + x·hi summed in fp32 is an fp32 product)."""
    c = codebook.float()
    hi = c.bfloat16()
    mid = (c - hi.float()).bfloat16()
    lo = (c - hi.float() - mid.float()).bfloat16()
    return hi, mid, lo


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
    of ``build.mma_route``'s route (counted in ``sonic_matvec_kernel.launches``
    and ``.routes[route]``) or raises."""
    if x.device.type == "cpu":
        return sonic_matvec_plain(x, idx_values, codebook, indices)
    _check_rows("sonic_matvec", x)
    route = build.mma_route(idx_values.shape[-2], idx_values.shape[-1], x.dtype)
    name = "sonic_matvec_mma" if route == build.TENSOR_CORES else "sonic_matvec"
    y = build.launch_codebook(name, x, idx_values, codebook, indices)
    sonic_matvec_kernel.launches += 1
    sonic_matvec_kernel.routes[route] += 1
    return y


sonic_matvec_kernel.launches = 0
sonic_matvec_kernel.routes = dict.fromkeys(build.ROUTES, 0)


def sonic_matmul_kernel(
    x: torch.Tensor, idx_values: torch.Tensor, codebook: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """y (M, Nb·bn) fp32 = x (M, K) @ codebook[idx_values] (kept blocks),
    any M.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of ``build.mma_route``'s route (counted in
    ``sonic_matmul_kernel.launches`` and ``.routes[route]``) or raises."""
    if x.device.type == "cpu":
        return sonic_matmul_plain(x, idx_values, codebook, indices)
    route = build.mma_route(idx_values.shape[-2], idx_values.shape[-1], x.dtype)
    name = "sonic_matmul_mma" if route == build.TENSOR_CORES else "sonic_matmul"
    y = build.launch_codebook(name, x, idx_values, codebook, indices)
    sonic_matmul_kernel.launches += 1
    sonic_matmul_kernel.routes[route] += 1
    return y


sonic_matmul_kernel.launches = 0
sonic_matmul_kernel.routes = dict.fromkeys(build.ROUTES, 0)
