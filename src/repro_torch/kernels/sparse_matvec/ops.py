"""Public wrappers: the compressed matvec, and the whole top-k
compress-then-multiply op (SONIC §III.C in one call)."""
from __future__ import annotations

import math

import torch

from repro_torch.core.activation_sparsity import column_scores, top_k
from repro_torch.kernels.sparse_matvec import kernel


def sparse_matvec(
    x_nz: torch.Tensor,  # (..., knz): (knz,), (B, knz), or decode (B, 1, knz)
    idx: torch.Tensor,  # (knz,) int
    wt: torch.Tensor,  # (K, N)
) -> torch.Tensor:
    """Leading dims are flattened into the kernel's row axis, so
    decode-shaped (B, 1, knz) activations run unpadded, one kernel row per
    sequence; y is in x_nz's type.  Any N: the kernel masks the ragged
    edge, so the reference's column tile ``bn`` has no counterpart."""
    squeeze = x_nz.dim() == 1
    lead = x_nz.shape[:-1]
    x2 = x_nz.reshape(math.prod(lead), x_nz.shape[-1]).contiguous()
    y = kernel.sparse_matvec_kernel(x2, idx.to(torch.int32).contiguous(), wt.contiguous())
    y = y.to(x_nz.dtype)
    return y[0] if squeeze else y.reshape(*lead, wt.shape[1])


def topk_sparse_matmul(
    x: torch.Tensor,  # (..., K) activations (possibly sparse)
    wt: torch.Tensor,  # (K, N)
    k: int,
) -> torch.Tensor:
    """Shared top-k compression (batch-union magnitude, ties to the lower
    index) and the compressed product.  Equals x @ wt exactly when x has
    ≤ k nonzero columns."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    idx = top_k(column_scores(x2), min(k, x2.shape[1]))
    idx = idx.sort().values  # ascending → quasi-sequential row stripes
    x_nz = x2.index_select(1, idx)
    return sparse_matvec(x_nz, idx, wt).reshape(*lead, wt.shape[1])
