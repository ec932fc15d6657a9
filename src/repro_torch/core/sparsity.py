"""C1: model sparsification (paper §III.A).

The port of ``repro.core.sparsity``.  SONIC adapts the layer-wise,
sparsity-aware training of Zhu & Gupta ("To prune, or not to prune",
arXiv:1710.01878): every layer picked for sparsification carries a binary
mask of the weight's shape; weights are ranked by absolute value and the
smallest are masked to zero until the layer's target sparsity is reached.
Sparsity ramps over training on the same paper's cubic schedule, and an L2
term keeps the surviving weights small.

Two structural variants come from the same machinery:

* ``magnitude_prune_mask``: unstructured, exactly the paper's method (the
  photonic model gates one VCSEL per scalar).
* ``block_prune_mask``: block-structured; the unit of gating is one
  (bm × bn) tile, the structure the block-sparse kernels skip.

Thresholds are computed as the reference computes them: a two-pass
2048-bin histogram quantile for the unstructured mask, a sorted linear
quantile in fp32 for block norms, so the masks are the reference's on
weights without ties at the threshold.  Parameter trees are nested dicts
(and lists) of tensors; masks come back in the same nesting.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor

from repro_torch.utils.tree import named_leaves, tree_map_with_path_names


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-model sparsification plan.

    Attributes:
      target_sparsity: final fraction of zeros per sparsified layer, in [0, 1).
      per_layer: optional {layer-name-substring: sparsity} overrides (the
        paper prunes layer-wise "to avoid overly sparsifying sensitive
        layers").
      block: (bm, bn) block shape for the structured variant; (1, 1) means
        unstructured.
      ramp_start_step / ramp_end_step: the cubic schedule's endpoints.
      exclude: name substrings never pruned (norms, biases, embeddings by
        default, as §III.A warns against pruning embeddings).
    """

    target_sparsity: float = 0.8
    per_layer: Mapping[str, float] | None = None
    block: tuple[int, int] = (1, 1)
    ramp_start_step: int = 0
    ramp_end_step: int = 1000
    exclude: Sequence[str] = (
        "embed", "norm", "scale", "bias", "lm_head", "codebook",
        "router", "conv_w", "conv_b", "decay_lora", "mu", "ln_x",
    )

    def layer_target(self, name: str) -> float:
        for pat in self.exclude:
            if pat in name:
                return 0.0
        if self.per_layer:
            for pat, level in self.per_layer.items():
                if pat in name:
                    return float(level)
        return float(self.target_sparsity)


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def gradual_sparsity_schedule(
    step: torch.Tensor | int,
    final_sparsity: float,
    start_step: int,
    end_step: int,
    initial_sparsity: float = 0.0,
) -> torch.Tensor:
    """Cubic ramp s_t = s_f + (s_i − s_f)(1 − (t − t0)/(t1 − t0))³ (Zhu &
    Gupta eq. (1)), clamped outside [start_step, end_step]; fp32 0-dim."""
    step = _f32(step)
    span = max(end_step - start_step, 1)
    frac = torch.clamp((step - start_step) / span, 0.0, 1.0)
    return final_sparsity + (initial_sparsity - final_sparsity) * (1.0 - frac) ** 3


def approx_quantile(x: torch.Tensor, q: torch.Tensor | float, bins: int = 2048) -> torch.Tensor:
    """Two-pass histogram quantile of a flattened tensor: O(n), sort-free.

    Pass 1 brackets the quantile in one of ``bins`` uniform bins, pass 2
    re-bins inside the bracket (error ≈ range / bins²).  As in the
    reference, counts are fp32 and the bin is the first whose cumulative
    count reaches q·n (a left ``searchsorted``).  A value's bin is clamped
    before it is truncated to an integer, which is the same bin for every
    value in range and keeps far-out values in the edge bins."""
    x = x.reshape(-1).float()
    n = x.numel()
    q = torch.clamp(_f32(q, x.device), 0.0, 1.0)
    target = q * torch.tensor(float(n), dtype=torch.float32, device=x.device)
    ones = torch.ones_like(x)

    def bracket(lo, hi):
        width = torch.clamp(hi - lo, min=1e-30)
        idx = torch.clamp((x - lo) / width * bins, 0, bins - 1).to(torch.int64)
        hist = torch.zeros((bins,), dtype=torch.float32, device=x.device).index_add_(0, idx, ones)
        cdf = torch.cumsum(hist, 0)
        b = torch.clamp(torch.searchsorted(cdf, target.reshape(1)), 0, bins - 1)[0]
        return lo + b * width / bins, lo + (b + 1) * width / bins

    l1, h1 = bracket(x.min(), x.max())
    l2, h2 = bracket(l1, h1)
    return 0.5 * (l2 + h2)


def magnitude_prune_mask(w: torch.Tensor, sparsity: torch.Tensor | float) -> torch.Tensor:
    """Unstructured magnitude mask: zero the smallest-|w| fraction.

    The §III.A rule with the sort replaced by the histogram-quantile
    threshold.  Returns a {0, 1} mask of w's shape and type."""
    mag = w.abs().float()
    sparsity = torch.clamp(_f32(sparsity, w.device), 0.0, 1.0 - 1e-7)
    keep = (mag > approx_quantile(mag, sparsity)) | (sparsity <= 0.0)
    return keep.to(w.dtype)


def _quantile_last(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(a, q, axis=-1, keepdims=True)`` (linear), in fp32 as
    the reference computes it: position q·(n − 1), the two neighbours
    weighted 1 − w and w."""
    a = torch.sort(a, dim=-1).values
    n = a.shape[-1]
    pos = q * torch.tensor(float(n - 1), dtype=torch.float32, device=a.device)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hi_w = pos - lo
    # index_select with a 1-element index: the position stays on the device
    # (indexing with a 0-dim tensor would read it back as a Python int)
    lo_v = a.index_select(-1, lo.long().clamp(0, n - 1).reshape(1))
    hi_v = a.index_select(-1, hi.long().clamp(0, n - 1).reshape(1))
    return lo_v * (1 - hi_w) + hi_v * hi_w


def block_prune_mask(
    w: torch.Tensor, sparsity: torch.Tensor | float, block: tuple[int, int]
) -> torch.Tensor:
    """Block-structured magnitude mask on the trailing two dims.

    Blocks are ranked by their L1 norm and the lowest-norm fraction is
    zeroed; leading dims (stacked layers, experts) are pruned independently.
    Dims that the block does not divide fall back to the unstructured rule,
    as in the reference."""
    bm, bn = block
    if bm == 1 and bn == 1:
        return magnitude_prune_mask(w, sparsity)
    *lead, m, n = w.shape
    if m % bm or n % bn:
        return magnitude_prune_mask(w, sparsity)
    gm, gn = m // bm, n // bn
    norms = w.float().abs().reshape(*lead, gm, bm, gn, bn).sum(dim=(-3, -1))
    flat = norms.reshape(*lead, gm * gn)
    sparsity = torch.clamp(_f32(sparsity, w.device), 0.0, 1.0 - 1e-7)
    keep = (flat > _quantile_last(flat, sparsity)) | (sparsity <= 0.0)
    keep = keep.reshape(*lead, gm, 1, gn, 1).expand(*lead, gm, bm, gn, bn)
    return keep.reshape(w.shape).to(w.dtype)


def _gathered_slices(fn, w):
    """fn over a DTensor leaf's logical value, one leading slice at a time
    for a stack of ≥ 3 dims (its slices are pruned independently): each
    slice gathered whole on every device, its mask kept in the slice's
    layout (each device keeps a copy of its own block, no further
    exchange)."""
    from repro_torch.sharding.mesh import distribute_copy

    def one(t):
        return distribute_copy(fn(t.full_tensor()), t.device_mesh, t.placements)

    if w.dim() < 3:
        return one(w)
    return torch.stack([one(w[i]) for i in range(w.shape[0])]).redistribute(
        w.device_mesh, w.placements)


def build_masks(params: Any, config: SparsityConfig,
                step: torch.Tensor | int | None = None) -> Any:
    """A mask tree matching ``params``.

    Only rank ≥ 2 leaves whose layer target is > 0 get a non-trivial mask;
    every other leaf gets all ones (kept, so both trees have one nesting).
    With ``step``, each layer's target is scaled by the gradual schedule,
    as sparsity-aware training uses it.  A sharded (DTensor) leaf is pruned
    on its logical value (``_gathered_slices``)."""

    def one(name: str, w: torch.Tensor) -> torch.Tensor:
        target = config.layer_target(name)
        if w.dim() < 2 or target <= 0.0:
            return torch.ones_like(w)
        if step is not None:
            target = gradual_sparsity_schedule(step, target, config.ramp_start_step,
                                               config.ramp_end_step)
        if isinstance(w, DTensor):
            return _gathered_slices(lambda t: block_prune_mask(t, target, config.block), w)
        return block_prune_mask(w, target, config.block)

    return tree_map_with_path_names(one, params)


def apply_masks(params: Any, masks: Any) -> Any:
    """Elementwise params · masks (the forward-graph masking of §III.A)."""
    if isinstance(params, dict):
        return {k: apply_masks(v, masks[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(apply_masks(p, m) for p, m in zip(params, masks))
    return params * masks


def sparsity_of(x: torch.Tensor, atol: float = 0.0) -> float:
    """Fraction of zeros in x (or of |x| ≤ atol)."""
    x = torch.as_tensor(x)
    zero = x.abs() <= atol if atol > 0 else x == 0
    return zero.sum().item() / max(x.numel(), 1)


class _SumOfSquares(torch.autograd.Function):
    """Σ w² in fp32, its gradient 2·g·w computed in w's own layout (and
    type: the bits of autograd's ``w.float().square().sum()``, as doubling
    is exact).  On a DTensor whose dim is split over two mesh axes (d_model
    over ("pod", "data")), autograd's own backward of that expression makes
    DTensor lay the broadcast gradient out over one of them only: a copy of
    the leaf gathered over the other (26 GB a device for grok-1's stacked
    expert ``wo``)."""

    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        return w.float().square().sum()

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return (w.float() * (2 * g)).to(w.dtype)


def l2_regularization(params: Any,
                      exclude: Sequence[str] = ("norm", "bias", "scale")) -> torch.Tensor:
    """The L2 term the paper adds "to encourage smaller weight values"
    (§III.A): Σ w² over every leaf not excluded, fp32, in leaf order."""
    total = None
    for name, w in named_leaves(params):
        if not any(pat in name for pat in exclude):
            term = _SumOfSquares.apply(w)
            total = term if total is None else total + term
    return torch.zeros((), dtype=torch.float32) if total is None else total
