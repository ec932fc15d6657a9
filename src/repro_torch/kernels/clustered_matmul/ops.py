"""Public wrapper for the clustered-matmul kernel.

Takes any (..., K) activation against (K, N) int8 or int32 cluster ids and
a (C,) codebook (the ``ClusteredWeight`` storage of
``repro_torch.core.clustering``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.clustered_matmul import kernel


def clustered_matmul(
    x: torch.Tensor,
    indices: torch.Tensor,
    codebook: torch.Tensor,
    *,
    bm: int = 256,
    bn: int = 256,
    bk: int = 512,
) -> torch.Tensor:
    """x (..., K) @ codebook[indices] → (..., N) in x.dtype.

    K and N must be multiples of the reference's tiles (``min(bk, K)``,
    ``min(bn, N)``), as its Pallas kernel requires.  The CUDA kernel picks
    its own tiles and masks the M edge, so ``bm`` does not change the
    result and x is never padded."""
    del bm
    lead = x.shape[:-1]
    k = x.shape[-1]
    k2, n = indices.shape
    if k != k2 or k % min(bk, k) or n % min(bn, n):
        raise ValueError(f"x (..., {k}) and ids {tuple(indices.shape)} do not fit tiles "
                         f"bk={bk}, bn={bn}")
    y = kernel.clustered_matmul_kernel(x.reshape(-1, k).contiguous(), indices.contiguous(),
                                       codebook.float().contiguous())
    return y.reshape(*lead, n).to(x.dtype)
