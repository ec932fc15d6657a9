"""Gather-then-matmul oracle for the compressed (gathered-row) sparse matvec."""
from __future__ import annotations

import torch


def sparse_matvec_ref(
    x_nz: torch.Tensor,  # (B, knz) compressed activations
    idx: torch.Tensor,  # (knz,) int32 kept input positions (shared across B)
    wt: torch.Tensor,  # (K, N) weight, row-major in the input dim
) -> torch.Tensor:
    """y[B, N] = Σ_c x_nz[:, c] · wt[idx[c], :] (SONIC Fig. 1(b)), fp32
    accumulation, y in x_nz.dtype."""
    rows = wt.index_select(0, idx.long())  # (knz, N)
    return (x_nz.float() @ rows.float()).to(x_nz.dtype)
