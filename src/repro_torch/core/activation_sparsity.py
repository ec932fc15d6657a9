"""Static-k contextual activation sparsity (the C3 adaptation, mode "topk").

The port of ``repro.core.activation_sparsity``: the executable path fixes the
kept count k per layer and keeps the k largest-magnitude activations.
Batched inputs share one mask (scores are |x| summed over the leading
axes), so a batch gathers the same weight rows.  Plain torch ops: this path
has no kernel.  ``torch.topk`` does not promise ``jax.lax.top_k``'s order on
tied scores (lower index first), so the two agree on tie-free scores.
"""
from __future__ import annotations

import torch


def _shared_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (k,) of the k largest |x| columns, scores summed over the
    leading axes, in descending score order."""
    d = x.shape[-1]
    scores = x.float().abs().reshape(-1, d).sum(dim=0)
    return torch.topk(scores, min(k, d)).indices


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
