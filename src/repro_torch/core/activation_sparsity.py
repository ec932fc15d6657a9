"""Static-k contextual activation sparsity (the C3 adaptation, mode "topk").

The port of ``repro.core.activation_sparsity``: the executable path fixes the
kept count k per layer and keeps the k largest-magnitude activations.
Batched inputs share one mask (scores are |x| summed over the leading
axes), so a batch gathers the same weight rows.  Plain torch ops: this path
has no kernel.  Ties keep ``jax.lax.top_k``'s order, lower index first
(``top_k``), so the kept set is the reference's even where scores tie, as
they do for every zero column of a ReLU activation.
"""
from __future__ import annotations

import torch


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last dim, in descending
    score order and, among equal scores, lower index first (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def column_scores(x: torch.Tensor) -> torch.Tensor:
    """(d,) fp32 |x| summed over every leading axis of x (..., d)."""
    return x.float().abs().reshape(-1, x.shape[-1]).sum(dim=0)


def _shared_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (k,) of the k largest |x| columns, scores summed over the
    leading axes, in descending score order."""
    return top_k(column_scores(x), min(k, x.shape[-1]))


def topk_activation_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """{0,1} mask keeping the k largest-|x| positions of the last axis, shared
    across the leading axes; x's type and shape."""
    mask = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
    mask[_shared_topk(x, k)] = 1
    return mask.expand(x.shape)


def topk_compress(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the shared top-k columns: x (..., d) → values
    (..., k) gathered at the shared indices, indices (k,) int32."""
    idx = _shared_topk(x, k)
    return x[..., idx], idx.to(torch.int32)


def sparse_ffn_matmul(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Compressed x @ w keeping k input columns (shared across the batch).

    x (..., d_in), w (d_in, d_out).  Equals x @ w exactly when x has ≤ k
    nonzero columns; otherwise it is the top-k approximation."""
    idx = _shared_topk(x, k)
    return x[..., idx] @ w[idx]
