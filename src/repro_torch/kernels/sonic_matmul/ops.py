"""Public wrappers + weight converter for the SONIC matmuls: shape dispatch
between the decode-shaped matvec kernels and the tiled matmul kernels, for
the codebook format (``SonicWeight``) and the int8 format."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.clustering import ClusteringConfig, assign_clusters, cluster_weights
from repro_torch.core.sonic_layers import _densify, make_block_sparse
from repro_torch.kernels.block_sparse_matmul import kernel as bs_kernel
from repro_torch.kernels.sonic_matmul import kernel

# Flattened row counts below this (the reference's 8) take the decode-shaped
# matvec kernels, which are instantiated for 1..MAX_ROWS rows; larger ones
# the tiled matmul kernels.
DECODE_M_THRESHOLD = kernel.MAX_ROWS + 1


@dataclasses.dataclass
class SonicWeight:
    """Block-sparse + clustered weight: the full serving-format tensor."""

    idx_values: torch.Tensor  # (Nb, R, bk, bn) int8 cluster ids
    codebook: torch.Tensor  # (C,) fp32
    indices: torch.Tensor  # (Nb, R) int32 K-block ids
    k_blocks: int

    @property
    def dense_shape(self) -> tuple[int, int]:
        nb, _, bk, bn = self.idx_values.shape
        return self.k_blocks * bk, nb * bn

    def dense(self, dtype=torch.float32) -> torch.Tensor:
        values = self.codebook[self.idx_values.long()]
        return _densify(values, self.indices, self.k_blocks).to(dtype)


def make_sonic_weight(
    w: torch.Tensor,  # (K, N) trained dense weight
    sparsity: float = 0.75,
    block: tuple[int, int] = (128, 128),
    num_clusters: int = 64,
) -> SonicWeight:
    """Dense → SONIC serving format: cluster first (C2, preserve_zero), then
    balanced block-prune the clustered weight (C1), storing each kept value
    as its nearest codebook entry's id (the argmin, first on ties, taken in
    chunks as the clustering's assignment is)."""
    clustered, cw = cluster_weights(w, ClusteringConfig(num_clusters=num_clusters))
    bs = make_block_sparse(clustered, sparsity, block)
    ids = assign_clusters(bs.values.float().reshape(-1), cw.codebook)
    return SonicWeight(
        idx_values=ids.to(torch.int8).reshape(bs.values.shape),
        codebook=cw.codebook,
        indices=bs.indices,
        k_blocks=bs.k_blocks,
    )


def sonic_matmul(x: torch.Tensor, w: SonicWeight, *, bm: int = 256) -> torch.Tensor:
    """x (..., K) @ SONIC weight → (..., N) in x.dtype.

    Shape-dispatched: flattened M < ``DECODE_M_THRESHOLD`` takes the matvec
    kernel, larger M the tiled matmul kernel.  ``bm`` is the reference's M
    tile, kept for its signature: the kernel picks its own tiles and masks
    the ragged M edge, and no row's result depends on the tiling, so ``bm``
    does not change the result."""
    del bm
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    fn = (kernel.sonic_matvec_kernel if x2.shape[0] < DECODE_M_THRESHOLD
          else kernel.sonic_matmul_kernel)
    y = fn(x2, w.idx_values, w.codebook, w.indices)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def sonic_matvec(x: torch.Tensor, w: SonicWeight) -> torch.Tensor:
    """Decode-shaped entry point: x (K,) or (B, K) → (N,) / (B, N) in
    x.dtype, always through the matvec kernel (B ≤ 7 on the card)."""
    x2 = x[None] if x.dim() == 1 else x
    y = kernel.sonic_matvec_kernel(x2.contiguous(), w.idx_values, w.codebook, w.indices)
    y = y.to(x.dtype)
    return y[0] if x.dim() == 1 else y


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
